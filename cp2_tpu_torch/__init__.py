"""cp2_tpu_torch — the PyTorch/CUDA port of ``cp2_tpu`` for NVIDIA Hopper.

The JAX package ``cp2_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find, and imports nothing of
it (nor jax, flax or optax).  Public functions keep the JAX layouts (NHWC
images, ``(N, h, w, C)`` dense features, ``(N, S², C)`` dense-loss inputs);
inside, modules are plain ``nn.Module``s in NCHW.

Ported so far (slice 1): the CP2 pretrain step — dilated ResNet + ASPP
contrast head, EMA key encoder, negative queue, SGD — with the dense pair
loss on a hand-written CUDA kernel (``ops/dense_loss.py``,
``csrc/dense_loss.cu``).  Entry points default to ``device="cuda"``; the
CPU runs only where the caller asks for it, as the tests do.
"""

__version__ = "0.1.0"
