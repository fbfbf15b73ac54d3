"""SSL hyper-parameters + the per-variant validation web.

Encodes the flag-combination asserts the reference enforces inside
``MODEL.__init__`` (builder.py:322-363,431-462) and the post-parse
overrides in ``main.py:142-163`` as explicit config validation.
A copy of ``cp2_tpu/ssl/hparams.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from cp2_tpu_torch.types import BackboneType, MappingType, NegativeType, PretrainType

DEFAULT_QUEUE_SIZE = 65536


@dataclass(frozen=True)
class SSLHyperParams:
    dim: int = 128
    queue_len: int = DEFAULT_QUEUE_SIZE
    momentum: float = 0.999
    instance_logits_temp: float = 0.2
    dense_logits_temp: float = 1.0
    lmbd_cp2_dense_loss: float = 0.2
    lmbd_pixel_corr_weight: float = 1.0
    lmbd_region_corr_weight: float = 1.0
    lmbd_not_corr_weight: float = 1.0
    lmbd_coordinate: float = 0.0
    negative_scale: float = 2.0
    include_background: bool = False
    use_predictor: bool = False
    use_avgpool_global: bool = False
    use_symmetrical_loss: bool = False
    pixel_ids_stride: int = 1
    unet_truncated_dec_blocks: int = 2
    pretrain_type: PretrainType = PretrainType.CP2
    backbone_type: BackboneType = BackboneType.DEEPLABV3
    mapping_type: MappingType = MappingType.CP2
    negative_type: NegativeType = NegativeType.NONE

    def with_variant_overrides(self) -> "SSLHyperParams":
        """Variant-forced values, applied at the CLI layer
        (reference main.py:148-156)."""
        hp = self
        if hp.pretrain_type == PretrainType.DENSECL:
            hp = replace(
                hp,
                dense_logits_temp=0.2,
                instance_logits_temp=0.2,
                use_predictor=False,
                lmbd_cp2_dense_loss=0.5,
            )
        return hp

    def validated(self) -> "SSLHyperParams":
        """Assert the flag-combination web (reference builder.py:322-462)."""
        hp = self
        if hp.pretrain_type in (PretrainType.DENSECL, PretrainType.PROPOSED_V2):
            if hp.pixel_ids_stride != 1:
                raise ValueError(
                    f"{hp.pretrain_type.name} requires pixel_ids_stride == 1"
                )

        # correlation-weight web (builder.py:329-344)
        if not (0.0 <= hp.lmbd_coordinate <= 1.0):
            raise ValueError(f"lmbd_coordinate must be in [0,1], got {hp.lmbd_coordinate}")
        mt = hp.mapping_type
        if mt == MappingType.CP2:
            if not (
                hp.lmbd_pixel_corr_weight == 1
                and hp.lmbd_region_corr_weight == 1
                and hp.lmbd_not_corr_weight == 1
            ):
                raise ValueError("MappingType.CP2 requires all corr weights == 1")
        elif mt == MappingType.PIXEL_ID:
            if not (hp.lmbd_region_corr_weight == 1 and hp.lmbd_pixel_corr_weight > 1):
                raise ValueError(
                    "PIXEL_ID requires region weight == 1 and pixel weight > 1"
                )
        elif mt == MappingType.REGION_ID:
            if not (hp.lmbd_pixel_corr_weight == 1 and hp.lmbd_region_corr_weight > 1):
                raise ValueError(
                    "REGION_ID requires pixel weight == 1 and region weight > 1"
                )

        # backbone/variant compatibility (builder.py:360-363)
        if hp.backbone_type != BackboneType.DEEPLABV3:
            if hp.pretrain_type != PretrainType.CP2:
                raise ValueError(
                    f"{hp.backbone_type} only supports PretrainType.CP2, "
                    f"got {hp.pretrain_type}"
                )

        # CP2 constraints (builder.py:431-433)
        if hp.pretrain_type == PretrainType.CP2:
            if hp.negative_type != NegativeType.NONE:
                raise ValueError("CP2 requires NegativeType.NONE")
            if hp.mapping_type != MappingType.CP2:
                raise ValueError("CP2 requires MappingType.CP2")

        # DenseCL family bundles (builder.py:435-462)
        if hp.pretrain_type in (PretrainType.DENSECL, PretrainType.PROPOSED_V2):
            for name, expected in (
                ("momentum", 0.999),
                ("lmbd_cp2_dense_loss", 0.5),
                ("instance_logits_temp", 0.2),
                ("dense_logits_temp", 0.2),
            ):
                if getattr(hp, name) != expected:
                    raise ValueError(f"{hp.pretrain_type.name} requires {name}=={expected}")
            if hp.pretrain_type == PretrainType.DENSECL:
                if (
                    hp.use_predictor
                    or hp.use_avgpool_global
                    or hp.use_symmetrical_loss
                    or hp.lmbd_coordinate != 0
                ):
                    raise ValueError(
                        "DENSECL forbids predictor/avgpool-global/symmetrical/coordinate"
                    )
        return hp

    @classmethod
    def for_variant(
        cls, pretrain_type: PretrainType, dataset_size: int | None = None,
        cap_queue: bool = False, **overrides,
    ) -> "SSLHyperParams":
        """Variant defaults matching the reference driver (main.py:390-433)."""
        dense_family = pretrain_type in (
            PretrainType.CP2,
            PretrainType.PROPOSED,
            PretrainType.DENSECL,
            PretrainType.PROPOSED_V2,
        )
        defaults = dict(
            pretrain_type=pretrain_type,
            momentum=0.999 if dense_family else 0.996,
            dim=128 if dense_family else 256,
        )
        if pretrain_type == PretrainType.DENSECL:
            defaults.update(
                dense_logits_temp=0.2, instance_logits_temp=0.2, lmbd_cp2_dense_loss=0.5
            )
        if pretrain_type == PretrainType.PROPOSED_V2:
            defaults.update(
                dense_logits_temp=0.2, instance_logits_temp=0.2, lmbd_cp2_dense_loss=0.5
            )
        if cap_queue and dataset_size is not None:
            defaults["queue_len"] = min(dataset_size, DEFAULT_QUEUE_SIZE)
        defaults.update(overrides)
        return cls(**defaults).with_variant_overrides().validated()
