"""The PretrainType checkpoint-conversion matrix, on state dicts.

Port of ``cp2_tpu/checkpoint/convert.py`` (the reference's state-dict
surgery, networks/segment_network.py:63-162).  The JAX package grafts flax
trees; here the same rules graft torch state dicts, whose keys are the flax
paths joined by dots (the bridge's naming):

* the port's own pretrain checkpoints (CP2 / MOCO / BYOL / PROPOSED /
  DENSECL / PROPOSED_V2): ``state.pt``'s ``model``, the ``SSLEncoder``
  state dict, whose segmentor keys begin ``encoder.``; the prefix is
  stripped, ``conv_seg`` is dropped (its class count differs, reference
  :91), ``--use_backbone_only`` keeps ``backbone.`` alone (:84-92), and a
  ``meta.json`` ``pretrain_type`` tag that differs raises (:81-83);
* MIRROR checkpoints are segmentor state dicts already (:95-101);
* the ``*_IMGNET`` / MoCo / PixPro loaders read torch-format ResNet state
  dicts (torchvision layout, or ``module.encoder_q.`` /
  ``module.encoder.`` prefixes) through ``torchvision_resnet_to_state_dict``.

The port reads no orbax checkpoint (that would import JAX): weights cross
from the JAX package only through ``checkpoint/bridge.py``.

Each graft returns a report with the JAX one's five lists: ``loaded``,
``skipped_missing_in_target``, ``shape_mismatch``, ``missing_in_source``,
``dropped``; names are state-dict keys.  As in the JAX package, the
ResNet loaders report the parameters only (their running statistics are
loaded all the same).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cp2_tpu_torch.types import PretrainType

OWN_PRETRAIN_TYPES = (
    PretrainType.CP2,
    PretrainType.MOCO,
    PretrainType.BYOL,
    PretrainType.PROPOSED,
    PretrainType.DENSECL,
    PretrainType.PROPOSED_V2,
)

IMGNET_BACKBONE_TYPES = (
    PretrainType.BYOL_IMGNET,
    PretrainType.CP2_IMGNET,
    PretrainType.VICEREGL_IMGNET,
    PretrainType.BARLOWTWINS_IMGNET,
    PretrainType.DINO_IMGNET,
    PretrainType.DENSECL_IMGNET,
)

MOCO_PREFIX_TYPES = (PretrainType.MOSREP_IMGNET, PretrainType.MOCO_IMGNET)
PIXPRO_TYPES = (
    PretrainType.PIXPRO,
    PretrainType.PIXPRO_IMGNET,
    PretrainType.CLOVE_IMGNET,
)

REPORT_KEYS = ("loaded", "skipped_missing_in_target", "shape_mismatch",
               "missing_in_source", "dropped")
_STAT_SUFFIXES = (".running_mean", ".running_var")

Report = Dict[str, List[str]]


def graft_state_dict(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor], *,
                     drop_substrings: Tuple[str, ...] = ()
                     ) -> Tuple[Dict[str, torch.Tensor], Report]:
    """Copy ``source`` entries onto the same keys of ``target``, shape-checked,
    each cast to the target's dtype and device.  Returns (merged, report)."""
    report: Report = {k: [] for k in REPORT_KEYS}
    merged = dict(target)
    for name, value in source.items():
        if any(s in name for s in drop_substrings):
            report["dropped"].append(name)
            continue
        if name not in target:
            report["skipped_missing_in_target"].append(name)
            continue
        tgt = target[name]
        value = torch.as_tensor(value)
        if tuple(tgt.shape) != tuple(value.shape):
            report["shape_mismatch"].append(name)
            continue
        merged[name] = value.to(dtype=tgt.dtype, device=tgt.device)
        report["loaded"].append(name)
    report["missing_in_source"] = [k for k in target if k not in source]
    return merged, report


def _prefixed(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _params_only(report: Report) -> Report:
    return {k: [n for n in v if not n.endswith(_STAT_SUFFIXES)] for k, v in report.items()}


def load_pretrained_into_segmentor(
    target: Dict[str, torch.Tensor],
    checkpoint_state: Dict[str, torch.Tensor],
    checkpoint_meta: Dict,
    pretrain_type: PretrainType,
    *,
    use_backbone_only: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Report]:
    """Apply the PretrainType loading matrix to a finetune segmentor.

    ``target``: the fresh segmentor's state dict.  ``checkpoint_state``: the
    saved state dict (the port's pretrain ``model``, a segmentor's, or a
    torch-format ResNet's).  Returns the merged state dict and the report.
    """
    if pretrain_type in (PretrainType.RANDOM, PretrainType.NONE):
        # RANDOM keeps the init; NONE is the ImageNet init, left to the caller
        return target, {"loaded": [], "dropped": []}

    if pretrain_type in OWN_PRETRAIN_TYPES:
        tagged = checkpoint_meta.get("pretrain_type")
        if tagged is not None and tagged != pretrain_type.name:
            raise ValueError(
                f"checkpoint pretrain_type {tagged!r} != requested {pretrain_type.name!r}")
        source = _prefixed(checkpoint_state, "encoder.")
        if use_backbone_only:
            source = {k: v for k, v in source.items() if k.startswith("backbone.")}
        return graft_state_dict(target, source, drop_substrings=("conv_seg",))

    if pretrain_type == PretrainType.MIRROR:
        return graft_state_dict(target, checkpoint_state, drop_substrings=("conv_seg",))

    if pretrain_type in IMGNET_BACKBONE_TYPES + MOCO_PREFIX_TYPES + PIXPRO_TYPES:
        prefix = None
        if pretrain_type in MOCO_PREFIX_TYPES:
            prefix = "module.encoder_q."
        elif pretrain_type in PIXPRO_TYPES:
            prefix = "module.encoder."
        source = torchvision_resnet_to_state_dict(checkpoint_state, strip_prefix=prefix)
        merged, report = graft_state_dict(_prefixed(target, "backbone."), source)
        out = dict(target)
        out.update({f"backbone.{k}": v for k, v in merged.items()})
        return out, _params_only(report)

    raise NotImplementedError(f"{pretrain_type = }")


def read_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``(state_dict, meta)`` of a torch-format file (downloaded baselines,
    torchvision weights): a ``state_dict`` or ``model`` entry is unwrapped,
    the file's scalar fields become the meta, and only tensors are kept.

    The reference's baseline files may hold pickled objects beside the
    tensors, so they load as the reference loads them (``weights_only``
    off): read only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta: Dict = {}
    if isinstance(ckpt, dict):
        meta = {k: v for k, v in ckpt.items() if isinstance(v, (str, int, float))}
        for key in ("state_dict", "model"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}, meta


def graft_imagenet_backbone(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                            prefix: str = "encoder.backbone.") -> Report:
    """Load a torchvision-layout ResNet into ``model``'s backbone (its keys
    under ``prefix``) in place; returns the parameters' report."""
    target = model.state_dict()
    merged, report = graft_state_dict(_prefixed(target, prefix),
                                      torchvision_resnet_to_state_dict(state_dict))
    with torch.no_grad():
        for k, v in merged.items():
            target[prefix + k].copy_(v)
    return _params_only(report)


def torchvision_resnet_to_state_dict(state_dict: Dict[str, torch.Tensor], *,
                                     strip_prefix: Optional[str] = None
                                     ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet state dict in the port's ResNet naming
    (``conv1.conv``, ``conv1.norm``, ``layer{s}_{b}.conv{1,2}.conv``,
    ``.conv3``, ``.norm3``, ``.downsample.{conv,norm}``), keys relative to
    the backbone.  Conv weights keep their OIHW layout; keys outside the
    ResNet (``fc.``, projector heads, queues) are left out.  The reference's
    own ``backbone.`` / ``module.`` prefixes are tolerated."""
    out: Dict[str, torch.Tensor] = {}
    bn_leaves = ("weight", "bias", "running_mean", "running_var")

    def put_bn(path: str, leaf: str, value) -> None:
        if leaf in bn_leaves:
            out[f"{path}.{leaf}"] = value

    for raw_key, value in state_dict.items():
        key = raw_key
        if strip_prefix:
            if strip_prefix not in key:
                continue
            key = key.replace(strip_prefix, "", 1)
        for pfx in ("backbone.", "module."):
            if key.startswith(pfx):
                key = key[len(pfx):]
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "conv1" and leaf == "weight":
            out["conv1.conv.weight"] = value
        elif parts[0] == "bn1":
            put_bn("conv1.norm", leaf, value)
        elif parts[0].startswith("layer") and len(parts) >= 3:
            base = f"layer{parts[0][len('layer'):]}_{parts[1]}"
            mod = parts[2]
            if mod in ("conv1", "conv2") and leaf == "weight":
                out[f"{base}.{mod}.conv.weight"] = value
            elif mod == "conv3" and leaf == "weight":
                out[f"{base}.conv3.weight"] = value
            elif mod in ("bn1", "bn2"):
                put_bn(f"{base}.conv{mod[-1]}.norm", leaf, value)
            elif mod == "bn3":
                put_bn(f"{base}.norm3", leaf, value)
            elif mod == "downsample":
                if parts[3] == "0" and leaf == "weight":
                    out[f"{base}.downsample.conv.weight"] = value
                elif parts[3] == "1":
                    put_bn(f"{base}.downsample.norm", leaf, value)
        # else: fc., projector, queue keys are intentionally ignored
    return out
