"""CP2 dense pair loss: the hand-written CUDA kernel and its plain versions.

Replaces the Pallas TPU kernel pair of ``cp2_tpu/ops/pallas/dense_loss.py``
(``_fwd_kernel`` :77 / ``pallas_call`` :177 and ``_bwd_kernel`` :107 /
``pallas_call`` :222) with ``csrc/dense_loss.cu``; the design and the
algebra are in that file's header.  In short: the per-key-column softmax
over queries is flash attention with the roles swapped — a block owns
(sample, key tile) and streams query chunks, so no (S², S²) tensor is ever
formed and S² has no upper bound; the forward is one launch that saves
``lse`` (N, S²), and the backward is two deterministic passes (dk over key
tiles, dq over query tiles).

The products run on the H100's tensor cores (``wgmma``), with tiles
brought in by TMA: bfloat16 operands as one bf16 product, float32
operands as 3×TF32 — each operand split as ``tf32_split`` does, and
big·big + big·small + small·big summed in float32 — which keeps float32's
accuracy (one TF32 pass is ten times outside the gradient tolerance).
``tf32x3_einsum`` is that arithmetic in plain PyTorch, for the CPU tests.

``dense_pair_loss`` launches the kernels for CUDA tensors (and raises if
they cannot build or launch) and takes their plain versions only for CPU
tensors: the factorized forward and the analytic backward from the saved
``lse``, the algebra the kernels implement.  Both routes are one pair of
``torch.library`` custom ops, so a FLOP counter counts the loss by its
formula, whichever route runs.  ``LAUNCHES`` counts kernel launches, one
per forward and one per backward call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from cp2_tpu_torch.ops import cuda_build

LAUNCHES = {"dense_pair_loss_fwd": 0, "dense_pair_loss_bwd": 0}
_WIDTHS = (32, 64, 128, 256)  # channel widths the kernel is compiled for


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tf32_split(x: torch.Tensor):
    """(big, small) with ``x = big + small`` exactly, float32.

    ``big`` is ``x`` with its low 13 mantissa bits cleared: the TF32 value
    the tensor cores read of a float32, the kernel's big part of each
    operand.
    """
    x = x.float().contiguous()
    big = (x.view(torch.int32) & -8192).view(torch.float32)  # 0xFFFFE000
    return big, x - big


def tf32x3_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, a, b)`` as the kernel forms it from float32
    operands: big·big + big·small + small·big, each part read as TF32."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    a_small, b_small = tf32_split(a_small)[0], tf32_split(b_small)[0]
    return (torch.einsum(spec, a_big, b_small) + torch.einsum(spec, a_small, b_big)
            + torch.einsum(spec, a_big, b_big))


def dense_pair_loss_reference(q, k, mask_a, mask_b, temperature: float):
    """The einsum / log_softmax(axis=1) formula (``dense_loss.py:60-74``)."""
    logits = torch.einsum("nxc,nyc->nxy", q, k) / temperature
    labels = torch.einsum("nx,ny->nxy", mask_a, mask_b)
    log_sm = F.log_softmax(logits, dim=1)
    n = q.shape[0]
    num = ((-log_sm).reshape(n, -1) * labels.reshape(n, -1)).sum(dim=1)
    den = labels.reshape(n, -1).sum(dim=1).clamp_min(1e-12)
    return (num / den).mean()


def dense_pair_loss_factorized(q, k, mask_a, mask_b, temperature: float,
                               einsum=torch.einsum):
    """The algebra the kernel's forward implements; returns (loss, lse).

    loss = mean_n Σ_y b_y (A·lse_y − s_y) / max(A·B, 1e-12) with
    lse_y = logsumexp_x(q_x·k_y / T), s_y = Σ_x a_x q_x·k_y / T.
    ``einsum`` forms the similarities (``tf32x3_einsum``: the kernel's
    arithmetic).
    """
    logits = einsum("nxc,nyc->nxy", q, k) * (1.0 / temperature)
    lse = torch.logsumexp(logits, dim=1)  # (N, S²): softmax over queries
    s = torch.einsum("nx,nxy->ny", mask_a, logits)
    a_sum, b_sum = mask_a.sum(dim=1), mask_b.sum(dim=1)
    total = (mask_b * (a_sum[:, None] * lse - s)).sum(dim=1)
    return (total / (a_sum * b_sum).clamp_min(1e-12)).mean(), lse


def dense_pair_loss_backward(q, k, mask_a, mask_b, lse, temperature: float,
                             grad=1.0, einsum=torch.einsum):
    """The kernel's analytic backward from the saved ``lse``: (dq, dk).

    d sim[x,y] = g·b_y·(A·exp(q_x·k_y/T − lse_y) − a_x) / (T·N·max(A·B, 1e-12));
    ``einsum`` forms all three products.
    """
    n = q.shape[0]
    inv_t = 1.0 / temperature
    logits = einsum("nxc,nyc->nxy", q, k) * inv_t
    p = torch.exp(logits - lse[:, None, :])
    a_sum, b_sum = mask_a.sum(dim=1), mask_b.sum(dim=1)
    scale = grad * inv_t / (n * (a_sum * b_sum).clamp_min(1e-12))
    d = scale[:, None, None] * mask_b[:, None, :] * (
        a_sum[:, None, None] * p - mask_a[:, :, None])
    return einsum("nxy,nyc->nxc", d, k), einsum("nxy,nxc->nyc", d, q)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("dense_loss")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cp2_dense_loss_fwd.argtypes = [ptr] * 4 + [i32] * 4 + [f32] + [ptr] * 5
        lib.cp2_dense_loss_fwd.restype = i32
        lib.cp2_dense_loss_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [f32] + [ptr] * 3
        lib.cp2_dense_loss_bwd.restype = i32
        lib.cp2_dense_loss_tile.argtypes = []
        lib.cp2_dense_loss_tile.restype = i32
        lib.cp2_cuda_error_string.argtypes = [i32]
        lib.cp2_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """The forward's counter: one int32 on the device, at 0 when the
    forward starts; each forward's last block leaves it at 0 again.

    The forward's blocks take tickets from it to find the last one, so two
    forwards that may run at the same time must not share it.  An eager
    stream runs its forwards one after another, so each stream keeps one,
    zeroed once.  A forward captured in a CUDA graph gets a counter of its
    own, made inside the capture, so that its zeroing is part of the graph:
    a replay, on whatever stream, shares no counter with eager forwards.
    """
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((), dtype=torch.int32, device=device)
    key = (device.index, stream.cuda_stream)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = torch.zeros((), dtype=torch.int32, device=device)
        _tickets[key] = ticket
    return ticket


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cp2_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed to launch: {msg} (cudaError {err})")


def _check_operands(q16, k16, a, b, *extra) -> None:
    """What the C entry points assume of the pointers they are given."""
    n, s2, width = q16.shape
    if q16.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {q16.device.type}")
    if (q16.dtype not in (torch.float32, torch.bfloat16) or k16.dtype != q16.dtype
            or k16.shape != q16.shape or width not in _WIDTHS):
        raise ValueError(f"q, k must be (N, S2, C in {_WIDTHS}) float32 or bfloat16 "
                         f"of one type; got {q16.dtype} {tuple(q16.shape)}, "
                         f"{k16.dtype} {tuple(k16.shape)}")
    for t in (q16, k16, a, b, *extra):
        if t.device != q16.device or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one device")
    if q16.data_ptr() % 16 or k16.data_ptr() % 16:  # read as 16-byte vectors
        raise ValueError("q and k must be 16-byte aligned")
    for t in (a, b, *extra):
        if t.dtype != torch.float32:
            raise ValueError(f"masks, lse and grad must be float32, got {t.dtype}")
    if a.shape != (n, s2) or b.shape != (n, s2):
        raise ValueError(f"masks must be (N, S2) = {(n, s2)}")


def _operand(x: torch.Tensor, dtype: torch.dtype, width: int) -> torch.Tensor:
    """Contiguous, 16-byte aligned, channel axis zero-padded to ``width``."""
    x = x.detach().to(dtype)
    if x.shape[-1] != width:
        x = F.pad(x, (0, width - x.shape[-1]))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def prepare_operands(q, k, mask_a, mask_b, compute_dtype=torch.float32):
    """The kernel's operands: q, k in ``compute_dtype`` with the channel
    axis zero-padded to a width it is compiled for, float32 masks."""
    c = q.shape[-1]
    width = next((w for w in _WIDTHS if w >= c), None)
    if width is None:
        raise ValueError(f"channel width {c} exceeds the kernel's {_WIDTHS[-1]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return (_operand(q, compute_dtype, width), _operand(k, compute_dtype, width),
            mask_a.detach().float().contiguous(), mask_b.detach().float().contiguous())


def fwd_kernel(q16, k16, a, b, temperature: float):
    """Launch the forward on prepared operands: (loss, lse (N, S²))."""
    _check_operands(q16, k16, a, b)
    n, s2, width = q16.shape
    lib = _library()
    tiles = -(-s2 // lib.cp2_dense_loss_tile())
    lse = torch.empty((n, s2), dtype=torch.float32, device=q16.device)
    partial = torch.empty((n, tiles), dtype=torch.float32, device=q16.device)
    loss = torch.empty((), dtype=torch.float32, device=q16.device)
    with torch.cuda.device(q16.device):
        stream = torch.cuda.current_stream(q16.device)
        ticket = _ticket(q16.device, stream)  # held until the launch is enqueued
        err = lib.cp2_dense_loss_fwd(
            q16.data_ptr(), k16.data_ptr(), a.data_ptr(), b.data_ptr(),
            n, s2, width, int(q16.dtype == torch.bfloat16), 1.0 / temperature,
            lse.data_ptr(), partial.data_ptr(), loss.data_ptr(),
            ticket.data_ptr(), stream.cuda_stream,
        )
    _check(lib, err, "dense_pair_loss forward")
    LAUNCHES["dense_pair_loss_fwd"] += 1
    return loss, lse


def bwd_kernel(q16, k16, a, b, lse, grad, temperature: float, *,
               need_dq: bool = True, need_dk: bool = True):
    """Launch the backward on prepared operands: (dq, dk), float32 at the
    padded width, ``None`` where not needed.  ``grad`` is the upstream
    gradient of the loss, a one-element float32 CUDA tensor."""
    _check_operands(q16, k16, a, b, lse, grad)
    if lse.shape != q16.shape[:2] or grad.numel() != 1:
        raise ValueError("lse must be (N, S2) and grad one element")
    n, s2, width = q16.shape
    lib = _library()
    dq = torch.empty_like(q16, dtype=torch.float32) if need_dq else None
    dk = torch.empty_like(q16, dtype=torch.float32) if need_dk else None
    with torch.cuda.device(q16.device):
        err = lib.cp2_dense_loss_bwd(
            q16.data_ptr(), k16.data_ptr(), a.data_ptr(), b.data_ptr(),
            lse.data_ptr(), grad.data_ptr(), n, s2, width,
            int(q16.dtype == torch.bfloat16), 1.0 / temperature,
            None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(),
            torch.cuda.current_stream(q16.device).cuda_stream,
        )
    _check(lib, err, "dense_pair_loss backward")
    LAUNCHES["dense_pair_loss_bwd"] += 1
    return dq, dk


# ---------------------------------------------------------------------------
# the entry: one pair of custom ops on every device
# ---------------------------------------------------------------------------
#
# Forward and backward are ``torch.library`` custom ops with a kernel for
# each device: on CUDA tensors the hand-written kernels above, on CPU
# tensors their plain versions (``dense_pair_loss_factorized`` and
# ``dense_pair_loss_backward``), and on the meta device shapes alone.  A
# FLOP counter (``utils/flops.py``) sees each call as one op whatever the
# device, and counts it by the formulas registered below, so a count does
# not depend on the route.

@torch.library.custom_op("cp2_torch::dense_pair_loss", mutates_args=())
def _loss_op(q: torch.Tensor, k: torch.Tensor, mask_a: torch.Tensor, mask_b: torch.Tensor,
             temperature: float, bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse (N, S²)) of q, k (N, S², C) and masks (N, S²)."""
    raise ValueError(f"dense_pair_loss runs on cuda or cpu, not {q.device.type}")


@_loss_op.register_kernel("cuda")
def _(q, k, mask_a, mask_b, temperature, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    return fwd_kernel(*prepare_operands(q, k, mask_a, mask_b, dtype), temperature)


@_loss_op.register_kernel("cpu")
def _(q, k, mask_a, mask_b, temperature, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    return dense_pair_loss_factorized(q.to(dtype).float(), k.to(dtype).float(),
                                      mask_a.float(), mask_b.float(), temperature)


@_loss_op.register_fake
def _(q, k, mask_a, mask_b, temperature, bf16):
    return (q.new_empty((), dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("cp2_torch::dense_pair_loss_backward", mutates_args=())
def _backward_op(q: torch.Tensor, k: torch.Tensor, mask_a: torch.Tensor,
                 mask_b: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor,
                 temperature: float, bf16: bool, need_dq: bool,
                 need_dk: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, dk) in the dtypes of q and k; an empty tensor where not needed."""
    raise ValueError(f"dense_pair_loss runs on cuda or cpu, not {q.device.type}")


@_backward_op.register_kernel("cuda")
def _(q, k, mask_a, mask_b, lse, grad, temperature, bf16, need_dq, need_dk):
    dtype = torch.bfloat16 if bf16 else torch.float32
    dq, dk = bwd_kernel(*prepare_operands(q, k, mask_a, mask_b, dtype), lse,
                        grad.detach().float().reshape(()).contiguous(), temperature,
                        need_dq=need_dq, need_dk=need_dk)
    c = q.shape[-1]
    return (q.new_empty(0) if dq is None else dq[..., :c].to(q.dtype),
            k.new_empty(0) if dk is None else dk[..., :c].to(k.dtype))


@_backward_op.register_kernel("cpu")
def _(q, k, mask_a, mask_b, lse, grad, temperature, bf16, need_dq, need_dk):
    dtype = torch.bfloat16 if bf16 else torch.float32
    dq, dk = dense_pair_loss_backward(q.to(dtype).float(), k.to(dtype).float(),
                                      mask_a.float(), mask_b.float(), lse, temperature,
                                      grad=grad.reshape(()))
    return (dq.to(q.dtype) if need_dq else q.new_empty(0),
            dk.to(k.dtype) if need_dk else k.new_empty(0))


@_backward_op.register_fake
def _(q, k, mask_a, mask_b, lse, grad, temperature, bf16, need_dq, need_dk):
    return (torch.empty_like(q) if need_dq else q.new_empty(0),
            torch.empty_like(k) if need_dk else k.new_empty(0))


def _setup_context(ctx, inputs, output):
    q, k, mask_a, mask_b, temperature, bf16 = inputs
    ctx.save_for_backward(q, k, mask_a, mask_b, output[1])
    ctx.temperature, ctx.bf16 = temperature, bf16
    ctx.mark_non_differentiable(output[1])


def _backward(ctx, grad, _grad_lse):
    need_dq, need_dk = ctx.needs_input_grad[:2]
    dq, dk = _backward_op(*ctx.saved_tensors, grad, ctx.temperature, ctx.bf16,
                          need_dq, need_dk)
    return (dq if need_dq else None, dk if need_dk else None, None, None, None, None)


_loss_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.cp2_torch.dense_pair_loss)
def _loss_flops(q_shape, *args, out_shape=None, **kwargs) -> int:
    """The similarities, 2·N·S²·S²·C; the elementwise work is not counted."""
    n, s2, c = q_shape
    return 2 * n * s2 * s2 * c


@register_flop_formula(torch.ops.cp2_torch.dense_pair_loss_backward)
def _backward_flops(q_shape, k_shape, mask_a, mask_b, lse, grad, temperature, bf16,
                    need_dq, need_dk, out_shape=None, **kwargs) -> int:
    """One product of the forward's size for each gradient asked for; the
    kernel's recomputation of the similarities is not model work and is not
    counted (XLA's count of the JAX step, an einsum, has none)."""
    n, s2, c = q_shape
    return 2 * n * s2 * s2 * c * (int(need_dq) + int(need_dk))


def dense_pair_loss(q: torch.Tensor, k: torch.Tensor, mask_a: torch.Tensor,
                    mask_b: torch.Tensor, temperature: float = 1.0, *,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CP2 dense loss, mean over samples; q, k (N, S², C), masks (N, S²).

    Equal to ``dense_pair_loss_reference`` (the CP2 loss with unit
    correspondence weights and no negative reshaping).  The similarities
    are formed from ``compute_dtype`` operands with float32 accumulation.
    Gradients flow to ``q`` and ``k``.  CUDA tensors launch the kernels;
    CPU tensors take their plain versions; meta tensors give shapes alone.
    """
    if q.shape != k.shape:
        # CP2 always pairs same-grid views; reject silently-wrong ragged inputs
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if q.dim() != 3 or mask_a.shape != q.shape[:2] or mask_b.shape != q.shape[:2]:
        raise ValueError(
            f"expected q, k (N, S2, C) and masks (N, S2); got {tuple(q.shape)}, "
            f"{tuple(mask_a.shape)}, {tuple(mask_b.shape)}"
        )
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return _loss_op(q, k, mask_a, mask_b, float(temperature),
                    compute_dtype == torch.bfloat16)[0]
