"""The port's CP2 dense pair loss (plain versions) against the JAX package.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against these plain versions there).  Here the algebra it implements is
checked on the CPU: the factorized forward (per key column
``lse_y = logsumexp_x q_x.k_y/T`` and ``s_y``) and the analytic backward
from the saved ``lse``, against ``dense_pair_loss_reference`` of
``cp2_tpu/ops/pallas/dense_loss.py`` and its ``jax.grad``.

The kernel forms its products from float32 operands as 3×TF32 on the
tensor cores; ``tf32x3_einsum`` emulates that arithmetic, and the tests
below hold the emulated forward and backward against JAX at the same
tolerances, and pin one TF32 pass as outside them.

Tolerances (those of ``tests/test_pallas_dense_loss.py``): forward rtol
2e-5, gradients rtol 1e-4 / atol 1e-6, all float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp2_tpu.ops.pallas.dense_loss import (
    dense_pair_loss_reference as jax_dense_pair_loss_reference,
)
from cp2_tpu_torch.ops import dense_loss as port

SHAPES = [(2, 196, 32), (1, 100, 8), (1, 640, 16)]  # flagship S², ragged, multi-tile
TEMPS = [1.0, 0.5]


def _inputs(n, s2, c, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(n, s2, c).astype(np.float32)
    k = r.randn(n, s2, c).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    a = (r.rand(n, s2) > 0.5).astype(np.float32)
    b = (r.rand(n, s2) > 0.5).astype(np.float32)
    a[:, 0] = 1.0  # never fully empty
    b[:, 0] = 1.0
    return q, k, a, b


def _jax_value_and_grads(q, k, a, b, temp):
    loss, grads = jax.value_and_grad(
        lambda q, k: jax_dense_pair_loss_reference(q, k, a, b, temp), argnums=(0, 1)
    )(jnp.asarray(q), jnp.asarray(k))
    return np.asarray(loss), [np.asarray(g) for g in grads]


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("temp", TEMPS)
def test_forward_matches_jax(shape, temp):
    q, k, a, b = _inputs(*shape, seed=shape[1])
    ref, _ = _jax_value_and_grads(q, k, a, b, temp)
    plain = port.dense_pair_loss_reference(*_t(q, k, a, b), temp)
    factorized, lse = port.dense_pair_loss_factorized(*_t(q, k, a, b), temp)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=2e-5)
    np.testing.assert_allclose(factorized.numpy(), ref, rtol=2e-5)
    # lse is the logsumexp over QUERIES of each key column
    logits = np.einsum("nxc,nyc->nxy", q, k).astype(np.float64) / temp
    want = np.log(np.exp(logits).sum(axis=1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("temp", TEMPS)
def test_analytic_backward_matches_jax_grad(shape, temp):
    q, k, a, b = _inputs(*shape, seed=shape[1] + 1)
    _, (dq_ref, dk_ref) = _jax_value_and_grads(q, k, a, b, temp)
    tq, tk, ta, tb = _t(q, k, a, b)
    _, lse = port.dense_pair_loss_factorized(tq, tk, ta, tb, temp)
    dq, dk = port.dense_pair_loss_backward(tq, tk, ta, tb, lse, temp)
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), dk_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("temp", TEMPS)
def test_entry_on_cpu_takes_plain_version(temp):
    """CPU tensors take the plain formula, gradients through autograd."""
    q, k, a, b = _inputs(2, 196, 32, seed=11)
    ref, (dq_ref, dk_ref) = _jax_value_and_grads(q, k, a, b, temp)
    tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    before = dict(port.LAUNCHES)
    loss = port.dense_pair_loss(tq, tk, *_t(a, b), temp)
    loss.backward()
    assert port.LAUNCHES == before  # no kernel on the CPU
    np.testing.assert_allclose(loss.detach().numpy(), ref, rtol=2e-5)
    np.testing.assert_allclose(tq.grad.numpy(), dq_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tk.grad.numpy(), dk_ref, rtol=1e-4, atol=1e-6)


def test_backward_scales_with_upstream_gradient():
    q, k, a, b = _t(*_inputs(1, 100, 8, seed=3))
    _, lse = port.dense_pair_loss_factorized(q, k, a, b, 0.5)
    dq1, dk1 = port.dense_pair_loss_backward(q, k, a, b, lse, 0.5)
    dq3, dk3 = port.dense_pair_loss_backward(q, k, a, b, lse, 0.5, grad=3.0)
    torch.testing.assert_close(dq3, 3.0 * dq1)
    torch.testing.assert_close(dk3, 3.0 * dk1)


def test_ragged_qk_rejected():
    q, k, a, b = _t(*_inputs(1, 128, 8))
    with pytest.raises(ValueError, match="mismatch"):
        port.dense_pair_loss(q, k[:, :100], a, b, 1.0)


TF32_SHAPES = SHAPES + [(2, 196, 128)]  # + the step's channel width
TF32_TEMPS = [1.0, 0.2]  # 0.2: the CP2 step's dense temperature


def test_tf32_split_is_exact():
    x = torch.from_numpy(np.random.RandomState(5).randn(4096).astype(np.float32))
    big, small = port.tf32_split(x)
    assert torch.equal(big + small, x)
    assert not (big.view(torch.int32) & 0x1FFF).any()  # TF32: 10 mantissa bits
    assert (small.abs() <= x.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("temp", TF32_TEMPS)
def test_tf32x3_forward_matches_jax(shape, temp):
    """The kernel's forward arithmetic (3×TF32 products) is float32-accurate."""
    q, k, a, b = _inputs(*shape, seed=shape[1] + shape[2])
    ref, _ = _jax_value_and_grads(q, k, a, b, temp)
    loss, _ = port.dense_pair_loss_factorized(*_t(q, k, a, b), temp,
                                              einsum=port.tf32x3_einsum)
    np.testing.assert_allclose(loss.numpy(), ref, rtol=2e-5)


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("temp", TF32_TEMPS)
def test_tf32x3_backward_matches_jax_grad(shape, temp):
    """The kernel's backward arithmetic: lse, logits, dq and dk all from
    3×TF32 products."""
    q, k, a, b = _inputs(*shape, seed=shape[1] + shape[2] + 1)
    _, (dq_ref, dk_ref) = _jax_value_and_grads(q, k, a, b, temp)
    tq, tk, ta, tb = _t(q, k, a, b)
    _, lse = port.dense_pair_loss_factorized(tq, tk, ta, tb, temp,
                                             einsum=port.tf32x3_einsum)
    dq, dk = port.dense_pair_loss_backward(tq, tk, ta, tb, lse, temp,
                                           einsum=port.tf32x3_einsum)
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), dk_ref, rtol=1e-4, atol=1e-6)


def test_one_tf32_pass_is_outside_the_gradient_tolerance():
    """Why the kernel takes three products: one TF32 pass (the big parts
    alone) puts dq more than 1e-4 of its largest element from JAX."""
    def one_pass(spec, x, y):
        return torch.einsum(spec, port.tf32_split(x)[0], port.tf32_split(y)[0])

    q, k, a, b = _inputs(2, 196, 128, seed=7)
    _, (dq_ref, _) = _jax_value_and_grads(q, k, a, b, 0.2)
    tq, tk, ta, tb = _t(q, k, a, b)
    errors = {}
    for name, einsum in (("one pass", one_pass), ("3xTF32", port.tf32x3_einsum)):
        _, lse = port.dense_pair_loss_factorized(tq, tk, ta, tb, 0.2, einsum=einsum)
        dq, _ = port.dense_pair_loss_backward(tq, tk, ta, tb, lse, 0.2, einsum=einsum)
        errors[name] = np.abs(dq.numpy() - dq_ref).max() / np.abs(dq_ref).max()
    assert errors["one pass"] > 1e-4, errors
    assert errors["3xTF32"] < 1e-5, errors
