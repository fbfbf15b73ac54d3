"""The SSL encoder module: segmentor + variant-specific projection heads.

Port of ``cp2_tpu/ssl/model.py``.  The flax module is one definition with
two parameter trees (query and EMA key); here the train state holds two
instances of this module, each with its own BatchNorm buffers.

Only the ``dense`` path on the DEEPLABV3 backbone is ported (the CP2
path); the U-Net backbones and the MoCo/BYOL/DenseCL heads raise
``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cp2_tpu_torch.models.encoder_decoder import EncoderDecoder
from cp2_tpu_torch.models.layers import init_flax_like_
from cp2_tpu_torch.types import BackboneType, PretrainType


def output_stride_of(model_cfg: dict) -> int:
    """Static output stride from a segmentor config (stem /4 × stage strides)."""
    strides = model_cfg["backbone"].get("strides", (1, 2, 2, 2))
    return 4 * int(math.prod(strides))


class SSLEncoder(nn.Module):
    def __init__(self, model_cfg: dict, pretrain_type: PretrainType = PretrainType.CP2,
                 backbone_type: BackboneType = BackboneType.DEEPLABV3,
                 dim: int = 128, unet_truncated_dec_blocks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del unet_truncated_dec_blocks
        if backbone_type != BackboneType.DEEPLABV3:
            raise NotImplementedError(f"{backbone_type} is not ported yet")
        if pretrain_type not in (PretrainType.CP2, PretrainType.PROPOSED):
            raise NotImplementedError(
                f"{pretrain_type}: only the dense (CP2) path is ported yet"
            )
        head = model_cfg.get("decode_head", {})
        contrast_dim = head.get("contrast_dim", 128)
        if head.get("contrast", False) and contrast_dim != dim:
            raise ValueError(
                f"decode_head.contrast_dim={contrast_dim} must equal the "
                f"SSL embedding dim={dim} (queue width)"
            )
        cfg = dict(model_cfg)
        cfg.pop("type", None)
        cfg.pop("dtype", None)
        self.encoder = EncoderDecoder(**cfg, dtype=dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.dense(img)

    def dense(self, img: torch.Tensor) -> torch.Tensor:
        """Dense embeddings: NHWC image (N,H,W,3) → (N,h,w,C).

        Train or eval BatchNorm follows ``self.training``, as the flax
        module's ``train`` flag does.
        """
        out = self.encoder(img.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)

    def init_weights(self, generator: torch.Generator) -> "SSLEncoder":
        """Random weights with flax's default distributions (see
        ``init_flax_like_``)."""
        return init_flax_like_(self, generator)
