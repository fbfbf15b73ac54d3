"""Python-dict config system (mmengine.Config.fromfile equivalent).

A copy of ``cp2_tpu/config.py``: the port imports nothing of the JAX package.

The reference layers argparse flags over python-file model configs loaded
with ``Config.fromfile`` (``main.py:338``, ``finetune.py:196``).  This is a
dependency-free re-implementation: a config file is any python file whose
module-level names become config entries, with attribute-style access and
nested dict wrapping.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj


class Config(ConfigDict):
    """Top-level config namespace."""

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(os.path.expanduser(path))
        spec = importlib.util.spec_from_file_location("_cp2_tpu_torch_config", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        entries: Dict[str, Any] = {
            k: v
            for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v) and not hasattr(v, "__package__")
        }
        cfg = cls(ConfigDict.wrap(entries))
        cfg["_filename"] = path
        return cfg

    def get(self, key, default=None):
        return dict.get(self, key, default)
