"""Shared enums: pretrain variants, mapping/negative types, dataset layouts.

A copy of ``cp2_tpu/types.py``: the port imports nothing of the JAX package.

Mirrors the reference's public enum surface so configs/CLIs are drop-in:
* ``PretrainType`` — reference ``networks/segment_network.py:14-38``
  (20 variants incl. the downloaded-ImageNet-checkpoint loaders).
* ``BackboneType`` / ``MappingType`` / ``NegativeType`` — reference
  ``builder.py:30-48,140-147``.
* ``DatasetType`` / ``DataSplitType`` — reference
  ``datasets/pretrain_dataset.py:20-29``, ``datasets/finetune_dataset.py:23-35``.
* ``CutPastePatchType`` / ``MirrorVariant`` — reference
  ``datasets/pretrain_dataset.py:181-189``.
"""

from enum import Enum


class PretrainType(Enum):
    RANDOM = 0
    NONE = 1
    CP2 = 2
    MIRROR = 3
    BYOL = 4
    MOCO = 5
    PROPOSED = 6
    PIXPRO = 7
    DENSECL_IMGNET = 8
    DINO_IMGNET = 9
    BARLOWTWINS_IMGNET = 10
    VICEREGL_IMGNET = 11
    MOCO_IMGNET = 12
    PIXPRO_IMGNET = 13
    BYOL_IMGNET = 14
    CP2_IMGNET = 15
    MOSREP_IMGNET = 16
    CLOVE_IMGNET = 17
    DENSECL = 18
    PROPOSED_V2 = 19


class BackboneType(Enum):
    DEEPLABV3 = 0
    UNET_ENCODER_ONLY = 1
    UNET_TRUNCATED = 2


class MappingType(Enum):
    CP2 = 0
    PIXEL_ID = 1
    REGION_ID = 2
    PIXEL_REGION_ID = 3


class NegativeType(Enum):
    NONE = 0
    FIXED = 1
    AVERAGE = 2
    MEDIAN = 3
    HARD = 4


class DatasetType(Enum):
    CSV = 0
    CLASSIFICATION = 1
    FILENAME = 2


class DataSplitType(Enum):
    RANDOM = 0
    CSV = 1
    FILENAME = 2


class CutPastePatchType(Enum):
    NONE = 0
    REGULAR = 1
    SCAR = 2


class MirrorVariant(Enum):
    NONE = 0
    OUTPUT = 1


class Stage(Enum):
    TRAIN = 0
    VAL = 1
    TEST = 2
    PSEUDOTEST = 3
