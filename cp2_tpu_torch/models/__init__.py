"""Model zoo: registries, backbones, necks, heads, segmentors (ported so far)."""

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
from cp2_tpu_torch.models.heads import ASPPHead, FCNHead
from cp2_tpu_torch.models.necks import DenseCLNeck, GlobalProjector
from cp2_tpu_torch.models.unet import UNetEncoderOnly, UNetTruncated
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
    "FCNHead",
    "DenseCLNeck",
    "GlobalProjector",
    "UNetEncoderOnly",
    "UNetTruncated",
    "EncoderDecoder",
]
