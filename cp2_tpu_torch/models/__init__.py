"""Model zoo: registries, backbones, heads, necks, segmentors."""

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
from cp2_tpu_torch.models.resnet import ResNet, frozen_param_labels
from cp2_tpu_torch.models.heads import ASPPHead, FCNHead
from cp2_tpu_torch.models.necks import DenseCLNeck, GlobalProjector
from cp2_tpu_torch.models.unet import UNetEncoderOnly, UNetTruncated
from cp2_tpu_torch.models.encoder_decoder import EncoderDecoder
from cp2_tpu_torch.models.vit import VisionTransformer

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
    "frozen_param_labels",
    "ASPPHead",
    "FCNHead",
    "DenseCLNeck",
    "GlobalProjector",
    "UNetEncoderOnly",
    "UNetTruncated",
    "EncoderDecoder",
    "VisionTransformer",
]
