"""The port's ViT backbone against the JAX package's, on the CPU.

The cases of ``tests/test_vit.py`` (``TINY``: 32² native size, patch 8,
width 24, 3 layers, 3 heads, ``out_indices`` (0, 2)), each also held
against the flax module's output on the same numpy weights, carried by the
bridge.  flax's LayerNorm computes its variance in one pass (E[x²] − E[x]²)
by default; the tests switch it to two passes, as the BatchNorm tests do,
so both sides compute the same statistic.

Tolerances: outputs at rtol 1e-5 with an absolute floor of 1e-5 of the
largest output (float32 through three pre-norm blocks; the two sides
order the attention and GELU arithmetic differently), gradients at 1e-4 of
each parameter's largest gradient (a backward through softmax and two
LayerNorms per block loses about one more digit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_port_common import assert_close, fill_variables, to_plain_dict
from cp2_tpu.models.vit import VisionTransformer as JaxViT
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import BACKBONES, VisionTransformer

TINY = dict(img_size=32, patch_size=8, embed_dims=24, num_layers=3,
            num_heads=3, out_indices=(0, 2))
RTOL = 1e-5
GRAD_TOL = 1e-4


class TwoPassLayerNorm(nn.LayerNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "LayerNorm", TwoPassLayerNorm)
        yield


def _pair(seed=0, **over):
    cfg = {**TINY, **over}
    jmodel = JaxViT(**cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3)), train=False))
    params, _ = fill_variables(shapes, np.random.RandomState(seed))
    port = VisionTransformer(**cfg).eval()
    load_flax_into(port, params)
    return jmodel, params, port


def _images(n, h, w, seed=1):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def _run_both(jmodel, params, port, x):
    ref = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ref, ours


@pytest.mark.parametrize("hw,grid", [((32, 32), (4, 4)), ((64, 48), (8, 6)), ((16, 24), (2, 3))],
                         ids=["native", "grid-grows", "grid-shrinks"])
def test_forward_matches_jax(hw, grid):
    """Native size, and sizes whose position grid grows (64x48) and
    shrinks (16x24, the antialiased resize) from the native 4x4."""
    jmodel, params, port = _pair()
    ref, ours = _run_both(jmodel, params, port, _images(2, *hw))
    assert isinstance(ours, tuple) and len(ours) == 2  # out_indices (0, 2)
    for r, o in zip(ref, ours):
        assert o.shape == (2, 24) + grid  # NCHW
        assert_close(o.permute(0, 2, 3, 1).numpy(), np.asarray(r), RTOL)
    assert not np.allclose(ours[0].numpy(), ours[1].numpy())
    assert port.pos_embed.shape == (1, 4 * 4 + 1, 24)


def test_without_cls_token_matches_jax():
    jmodel, params, port = _pair(with_cls_token=False)
    assert "cls_token" not in params and not hasattr(port, "cls_token")
    assert port.pos_embed.shape == (1, 16, 24)
    ref, ours = _run_both(jmodel, params, port, _images(2, 32, 32))
    for r, o in zip(ref, ours):
        assert_close(o.permute(0, 2, 3, 1).numpy(), np.asarray(r), RTOL)


def test_out_indices_and_final_norm_match_jax():
    """Only the last layer takes the final norm; flax builds the norm only
    when the last layer is an output, and so does the port."""
    jmodel, params, port = _pair(out_indices=(1,))
    assert "final_norm" not in params and port.final_norm is None
    ref, ours = _run_both(jmodel, params, port, _images(1, 32, 32))
    assert len(ours) == 1
    assert_close(ours[0].permute(0, 2, 3, 1).numpy(), np.asarray(ref[0]), RTOL)


def test_registry_build_matches_jax():
    port = BACKBONES.build(dict(type="VisionTransformer", **TINY))
    assert isinstance(port, VisionTransformer)
    jmodel, params, _ = _pair()
    load_flax_into(port.eval(), params)
    ref, ours = _run_both(jmodel, params, port, _images(2, 32, 32))
    assert ours[-1].shape == (2, 24, 4, 4)
    assert_close(ours[-1].permute(0, 2, 3, 1).numpy(), np.asarray(ref[-1]), RTOL)


def test_gradients_match_jax_through_resize():
    """At a non-native size (48²: the grid grows 4→6) the gradient reaches
    ``pos_embed``, the cls token and every block, and equals
    ``jax.grad``'s, parameter by parameter."""
    jmodel, params, port = _pair()
    x = _images(2, 48, 48, seed=0)

    def loss_fn(p):
        outs = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return sum(jnp.sum(o ** 2) for o in outs)

    ref = to_plain_dict(jax.grad(loss_fn)(params))
    outs = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum(o.pow(2).sum() for o in outs).backward()
    grads, _ = state_dict_to_flax({n: p.grad for n, p in port.named_parameters()})
    assert np.abs(grads["pos_embed"]).max() > 0
    assert np.abs(grads["cls_token"]).max() > 0
    for i in range(3):
        assert np.abs(grads[f"block_{i}"]["attn"]["query"]["kernel"]).max() > 0

    scale = max(np.abs(v).max() for _, v in _leaves(ref))

    def walk(ours, want, path=""):
        assert set(ours) == set(want), path
        for k, v in want.items():
            where = f"{path}/{k}"
            if isinstance(v, dict):
                walk(ours[k], v, where)
            elif where.endswith("key/bias"):
                # a key bias adds the same q·b to every logit of a query's
                # row, which the softmax cancels: its exact gradient is 0,
                # and both sides hold rounding noise
                assert np.abs(ours[k]).max() <= GRAD_TOL * scale, where
                assert np.abs(v).max() <= GRAD_TOL * scale, where
            else:
                assert_close(ours[k], v, GRAD_TOL, where)

    walk(grads, ref)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def test_bridge_round_trip_carries_every_leaf():
    _, params, port = _pair()
    back, stats = state_dict_to_flax(port.state_dict())
    assert stats == {}

    def walk(a, b, path=""):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].shape == b[k].shape, f"{path}/{k}"
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")

    walk(back, params)
    attn = port.block_0.attn
    assert attn.query.weight.shape == (3, 8, 24)   # (heads, head_dim, embed)
    assert attn.out.weight.shape == (24, 3, 8)     # (embed, heads, head_dim)
