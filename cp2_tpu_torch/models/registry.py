"""Model registry and config-dict builders.

Port of ``cp2_tpu/models/registry.py``: string-keyed registries for
backbones / necks / heads / segmentors and ``build_*`` functions that
construct a model from a python config dict (``dict(type='ResNet', ...)``).
Construction returns an initialised ``nn.Module``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """Minimal string→class registry with decorator registration."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, cls=None, *, name: str | None = None):
        def _register(c):
            key = name or c.__name__
            if key in self._entries and self._entries[key] is not c:
                raise KeyError(f"{key} already registered in {self.name}")
            self._entries[key] = c
            return c

        return _register(cls) if cls is not None else _register

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def build(self, cfg: Dict[str, Any], **extra):
        """Instantiate ``cfg['type']`` with the remaining keys as kwargs."""
        if cfg is None:
            return None
        cfg = dict(cfg)
        cls = self.get(cfg.pop("type"))
        cfg.update(extra)
        return cls(**cfg)


BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
LOSSES = Registry("loss")
SEGMENTORS = Registry("segmentor")


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_segmentor(cfg, train_cfg=None, test_cfg=None):
    """Build a segmentor from a model config dict.

    Accepts either the full config namespace (with a ``model`` key) or the
    model dict itself, mirroring ``build_segmentor(cfg.model, ...)`` usage
    in the reference (``builder.py:366-371``).
    """
    if hasattr(cfg, "model"):
        cfg = cfg.model
    if isinstance(cfg, dict) and "model" in cfg and "type" not in cfg:
        cfg = cfg["model"]
    cfg = dict(cfg)
    cfg.pop("pretrained", None)
    if train_cfg is not None:
        cfg["train_cfg"] = train_cfg
    if test_cfg is not None:
        cfg["test_cfg"] = test_cfg
    return SEGMENTORS.build(cfg)
