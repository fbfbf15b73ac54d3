"""The SSL encoder module: segmentor + variant-specific projection heads.

Port of ``cp2_tpu/ssl/model.py``.  The flax module is one definition with
two parameter trees (query and EMA key); here the train state holds two
instances of this module, each with its own BatchNorm buffers.

Forward modes, each taking an NHWC image batch like the flax methods:

* ``dense``          — the segmentor's contrast head (CP2/PROPOSED), or the
                       U-Net variant's projector; (N, h, w, C) NHWC;
* ``backbone_feats`` — the last backbone stage, NHWC;
* ``global_embed``   — the flattened last stage through the projector
                       (MoCo/BYOL), (N, dim);
* ``predict``        — the predictor MLP on a global embedding;
* ``densecl_embed``  — (the DenseCLNeck's six projections, the last stage
                       NHWC) for DenseCL/PROPOSED_V2.

Every parameter the flax ``init_all`` creates exists here under the same
path, the unused ones too (MoCo's predictor, the segmentor's
``conv_seg``): the JAX step decays and moves them, so the port carries
them (``train_step`` gives them zero gradients).

flax sizes the projector's first layer at its first call; here it is
sized from ``img_hw``, the training image size, which MoCo and BYOL need
(at 224² with a ResNet-50 its input is 7·7·2048 = 100352 wide).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from cp2_tpu_torch.models.encoder_decoder import EncoderDecoder
from cp2_tpu_torch.models.layers import MLP, init_flax_like_
from cp2_tpu_torch.models.necks import DenseCLNeck, GlobalProjector
from cp2_tpu_torch.models.unet import UNetEncoderOnly, UNetTruncated
from cp2_tpu_torch.types import BackboneType, PretrainType

PROJ_HIDDEN = 2048  # the projector/predictor/neck hidden width (model.py:82-99)


def output_stride_of(model_cfg: dict) -> int:
    """Static output stride from a segmentor config (stem /4 × stage strides)."""
    strides = model_cfg["backbone"].get("strides", (1, 2, 2, 2))
    return 4 * int(math.prod(strides))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """A contiguous NCHW copy of an NHWC batch, made explicitly, as
    ``seg_forward`` does: cuDNN picks its kernels by the input's strides,
    and a channels-last view sends the dilated ASPP convs to a direct
    kernel several times slower, so the network's speed must not rest on
    the strides the batch happens to have."""
    return img.permute(0, 3, 1, 2).contiguous()


class SSLEncoder(nn.Module):
    def __init__(self, model_cfg: Optional[dict],
                 pretrain_type: PretrainType = PretrainType.CP2,
                 backbone_type: BackboneType = BackboneType.DEEPLABV3,
                 dim: int = 128, unet_truncated_dec_blocks: int = 2,
                 dtype: torch.dtype = torch.float32,
                 img_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.backbone_type = backbone_type
        if backbone_type == BackboneType.DEEPLABV3:
            head = model_cfg.get("decode_head", {})
            contrast_dim = head.get("contrast_dim", 128)
            if head.get("contrast", False) and contrast_dim != dim:
                # the dense queue is (K, dim); a mismatched projector width
                # would only surface later as an opaque einsum shape error
                raise ValueError(
                    f"decode_head.contrast_dim={contrast_dim} must equal the "
                    f"SSL embedding dim={dim} (queue width)"
                )
            cfg = dict(model_cfg)
            cfg.pop("type", None)
            cfg.pop("dtype", None)
            self.encoder = EncoderDecoder(**cfg, dtype=dtype)
        elif backbone_type == BackboneType.UNET_ENCODER_ONLY:
            self.encoder = UNetEncoderOnly(projector_dim=dim, dtype=dtype)
        elif backbone_type == BackboneType.UNET_TRUNCATED:
            self.encoder = UNetTruncated(projector_dim=dim,
                                         num_decoder_blocks=unet_truncated_dec_blocks,
                                         dtype=dtype)
        else:
            raise NotImplementedError(f"{backbone_type = }")

        global_family = pretrain_type in (PretrainType.MOCO, PretrainType.BYOL)
        dense_family = pretrain_type in (PretrainType.DENSECL, PretrainType.PROPOSED_V2)
        if (global_family or dense_family) and backbone_type != BackboneType.DEEPLABV3:
            # parity: the reference's MoCo/BYOL/DenseCL forwards assume the
            # segmentor's ResNet (builder.py:1015-1016)
            raise NotImplementedError(f"{pretrain_type.name} requires DEEPLABV3")
        if global_family:
            if img_hw is None:
                raise ValueError(f"{pretrain_type.name}: img_hw sizes the projector")
            backbone = self.encoder.backbone
            h, w = backbone.feature_hw(img_hw)
            use_bn = pretrain_type == PretrainType.BYOL
            self.projector = GlobalProjector(h * w * backbone.stage_channels[-1],
                                             hidden=PROJ_HIDDEN, out=dim, use_bn=use_bn,
                                             dtype=dtype)
            self.predictor = MLP(dim, PROJ_HIDDEN, dim, use_bn=use_bn, dtype=dtype)
        if dense_family:
            self.neck = DenseCLNeck(self.encoder.backbone.stage_channels[-1], PROJ_HIDDEN,
                                    dim, dtype=dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.dense(img)

    def dense(self, img: torch.Tensor) -> torch.Tensor:
        """Dense embeddings: NHWC image (N,H,W,3) → (N,h,w,C).

        Train or eval BatchNorm follows ``self.training``, as the flax
        module's ``train`` flag does.
        """
        return _nhwc(self.encoder(_nchw(img)))

    def _last_stage(self, img: torch.Tensor) -> torch.Tensor:
        if self.backbone_type != BackboneType.DEEPLABV3:
            raise NotImplementedError("backbone features require DEEPLABV3")
        return self.encoder.extract_feat(_nchw(img))[-1]

    def backbone_feats(self, img: torch.Tensor) -> torch.Tensor:
        return _nhwc(self._last_stage(img))

    def global_embed(self, img: torch.Tensor) -> torch.Tensor:
        return self.projector(self._last_stage(img))

    def predict(self, z: torch.Tensor) -> torch.Tensor:
        return self.predictor(z)

    def densecl_embed(self, img: torch.Tensor):
        feats = self._last_stage(img)
        return self.neck(feats), _nhwc(feats)

    def init_weights(self, generator: torch.Generator) -> "SSLEncoder":
        """Random weights with flax's default distributions (see
        ``init_flax_like_``)."""
        return init_flax_like_(self, generator)
