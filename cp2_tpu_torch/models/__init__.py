"""Model zoo: registries, backbones, heads, segmentors (ported so far)."""

from cp2_tpu_torch.models.registry import (
    BACKBONES,
    HEADS,
    LOSSES,
    NECKS,
    SEGMENTORS,
    build_backbone,
    build_head,
    build_loss,
    build_neck,
    build_segmentor,
)
from cp2_tpu_torch.models.resnet import ResNet
from cp2_tpu_torch.models.heads import ASPPHead
from cp2_tpu_torch.models.encoder_decoder import EncoderDecoder

__all__ = [
    "BACKBONES",
    "HEADS",
    "LOSSES",
    "NECKS",
    "SEGMENTORS",
    "build_backbone",
    "build_head",
    "build_loss",
    "build_neck",
    "build_segmentor",
    "ResNet",
    "ASPPHead",
    "EncoderDecoder",
]
