"""Vision Transformer backbone (mmseg-compatible surface), NCHW out.

Port of ``cp2_tpu/models/vit.py`` (the reference's registered-but-optional
ViT, ``mmseg_/models/backbones/vit.py:207-472``): patch embedding, learned
position embeddings resized bilinearly for other input sizes (:371-431),
pre-norm encoder blocks, and the selected layers' tokens as feature maps
with the cls token dropped.  What the flax modules fix and this module
reproduces:

* ``nn.LayerNorm``: epsilon 1e-6, computed in float32, cast back.
* ``nn.gelu`` is the tanh approximation.
* ``nn.MultiHeadDotProductAttention``: the query divided by
  ``sqrt(head_dim)``; ``query`` / ``key`` / ``value`` kernels of shape
  (embed, heads, head_dim) and an ``out`` kernel (heads, head_dim, embed),
  each with a bias.  The torch weights keep the head axes:
  (heads, head_dim, embed) for the projections and (embed, heads,
  head_dim) for ``out`` (the bridge transposes).  Each layer's attention is
  one batched matmul, a float32 softmax and a second batched matmul; with
  ``drop_rate`` the attention weights take one dropout mask shared over
  batch and heads, flax's ``broadcast_dropout``.
* ``jax.image.resize(..., "bilinear")`` of the position grid is
  antialiased when the grid shrinks: ``ops/resize.py::resize_bilinear``.
* The patch conv pads 'SAME', as flax's ``nn.Conv`` does.

Dropout masks are drawn from the ``generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cp2_tpu_torch.models.heads import dropout
from cp2_tpu_torch.models.layers import linear
from cp2_tpu_torch.models.registry import BACKBONES
from cp2_tpu_torch.models.utils import trunc_normal_init
from cp2_tpu_torch.ops.resize import resize_bilinear

LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, float32 compute."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class _HeadProjection(nn.Module):
    """flax ``DenseGeneral`` to (heads, head_dim): weight (H, D, E), bias (H, D)."""

    def __init__(self, embed: int, heads: int, head_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(heads, head_dim, embed))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))
        nn.init.normal_(self.weight, std=embed ** -0.5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, d, e = self.weight.shape
        y = F.linear(x.to(dtype), self.weight.reshape(h * d, e).to(dtype),
                     self.bias.reshape(h * d).to(dtype))
        return y.reshape(*x.shape[:-1], h, d)


class _OutProjection(nn.Module):
    """flax ``DenseGeneral`` from (heads, head_dim): weight (E, H, D), bias (E,)."""

    def __init__(self, embed: int, heads: int, head_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(embed))
        nn.init.normal_(self.weight, std=embed ** -0.5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        e, h, d = self.weight.shape
        return F.linear(x.reshape(*x.shape[:-2], h * d).to(dtype),
                        self.weight.reshape(e, h * d).to(dtype), self.bias.to(dtype))


class MultiHeadAttention(nn.Module):
    """Self-attention with flax ``MultiHeadDotProductAttention``'s layout."""

    def __init__(self, embed: int, num_heads: int, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed % num_heads:
            raise ValueError(f"embed {embed} not divisible by {num_heads} heads")
        head_dim = embed // num_heads
        self.query = _HeadProjection(embed, num_heads, head_dim)
        self.key = _HeadProjection(embed, num_heads, head_dim)
        self.value = _HeadProjection(embed, num_heads, head_dim)
        self.out = _OutProjection(embed, num_heads, head_dim)
        self.head_dim = head_dim
        self.drop_rate = drop_rate
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        # (N, L, H, D) → (N, H, L, D)
        q = self.query(x, self.dtype).transpose(1, 2)
        k = self.key(x, self.dtype).transpose(1, 2)
        v = self.value(x, self.dtype).transpose(1, 2)
        q = q / torch.tensor(self.head_dim, dtype=q.dtype).sqrt()
        logits = q @ k.transpose(-1, -2)
        attn = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        if self.training and self.drop_rate > 0:
            if generator is None:
                raise ValueError("train-mode attention dropout needs a generator")
            keep_prob = 1.0 - self.drop_rate
            keep = torch.rand((1, 1) + attn.shape[-2:], generator=generator,
                              device=attn.device) < keep_prob
            attn = attn * (keep.to(attn.dtype) / keep_prob)
        ctx = (attn @ v).transpose(1, 2)  # (N, L, H, D)
        return self.out(ctx, self.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, embed: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(embed)
        self.attn = MultiHeadAttention(embed, num_heads, drop_rate, dtype)
        self.norm2 = LayerNorm(embed)
        self.fc1 = nn.Linear(embed, int(embed * mlp_ratio))
        self.fc2 = nn.Linear(int(embed * mlp_ratio), embed)
        self.drop_rate = drop_rate
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).to(self.dtype), generator)
        y = linear(self.fc1, self.norm2(x).to(self.dtype), self.dtype)
        y = linear(self.fc2, F.gelu(y, approximate="tanh"), self.dtype)
        return x + dropout(y, self.drop_rate, self.training, generator)


def _same_pad(x: torch.Tensor, patch: int) -> torch.Tensor:
    """'SAME' padding of a stride-``patch`` conv with a ``patch`` kernel."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-size // patch) - 1) * patch + patch - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


@BACKBONES.register
class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 3,
                 embed_dims: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_indices: Sequence[int] = (11,),
                 drop_rate: float = 0.0, with_cls_token: bool = True,
                 final_norm: bool = True, norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        del norm_cfg, init_cfg  # LayerNorm throughout; checkpoints load via the bridge
        self.patch_size = patch_size
        self.embed_dims = embed_dims
        self.base_grid = img_size // patch_size
        self.out_indices = tuple(out_indices)
        self.with_cls_token = with_cls_token
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(in_channels, embed_dims, patch_size, stride=patch_size)
        pos_len = self.base_grid ** 2 + (1 if with_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.empty(1, pos_len, embed_dims))
        trunc_normal_init(0.02)(self.pos_embed)
        if with_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        for i in range(num_layers):
            setattr(self, f"block_{i}", TransformerBlock(embed_dims, num_heads, mlp_ratio,
                                                         drop_rate, dtype))
        self.num_layers = num_layers
        # flax creates the final norm only where it is used
        if final_norm and num_layers - 1 in self.out_indices:
            self.final_norm = LayerNorm(embed_dims)
        else:
            self.final_norm = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        n = x.shape[0]
        e = self.embed_dims
        x = _same_pad(x.to(self.dtype), self.patch_size)
        x = F.conv2d(x, self.patch_embed.weight.to(self.dtype),
                     self.patch_embed.bias.to(self.dtype), self.patch_embed.stride)
        gh, gw = x.shape[2], x.shape[3]
        tokens = x.flatten(2).transpose(1, 2)  # (N, gh·gw, E), row-major as flax
        if self.with_cls_token:
            cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        else:
            cls_pos, grid_pos = None, self.pos_embed
        if (gh, gw) != (self.base_grid, self.base_grid):
            grid = grid_pos.reshape(1, self.base_grid, self.base_grid, e)
            grid_pos = resize_bilinear(grid, (gh, gw)).reshape(1, gh * gw, e)
        tokens = tokens + grid_pos.to(self.dtype)
        if self.with_cls_token:
            cls_tok = (self.cls_token + cls_pos).expand(n, 1, e).to(self.dtype)
            tokens = torch.cat([cls_tok, tokens], dim=1)
        tokens = dropout(tokens, self.drop_rate, self.training, generator)

        outs = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens, generator)
            if i in self.out_indices:
                y = tokens
                if i == self.num_layers - 1 and self.final_norm is not None:
                    y = self.final_norm(y)
                grid = y[:, 1:] if self.with_cls_token else y
                outs.append(grid.reshape(n, gh, gw, e).permute(0, 3, 1, 2)
                            .to(self.dtype).contiguous())
        return tuple(outs)
