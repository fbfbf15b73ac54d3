"""flax ⇄ torch weight bridge for the ported modules.

Flax trees arrive as nested dicts of numpy arrays (``params`` and
``batch_stats``, as ``jax.device_get`` returns them); no JAX is imported
here.  Module names in the port match the flax tree, so each leaf maps
by a rename plus a transpose:

* conv kernel ``(kh, kw, in, out)`` HWIO → ``weight`` OIHW; a dense
  ``kernel`` ``(in, out)`` → ``weight`` ``(out, in)``;
* ``bias`` → ``bias``;
* BatchNorm and LayerNorm ``scale`` → ``weight``; ``batch_stats`` ``mean``
  / ``var`` → ``running_mean`` / ``running_var``;
* the ViT's attention kernels keep their head axes: ``query`` / ``key`` /
  ``value`` (embed, heads, head_dim) → ``weight`` (heads, head_dim,
  embed), ``out`` (heads, head_dim, embed) → ``weight`` (embed, heads,
  head_dim); their biases as they are;
* ``pos_embed``, ``cls_token`` and ``Encoding``'s ``codewords`` keep their
  names and shapes, and so does ``Encoding``'s ``scale``, told from a
  norm's by its ``codewords`` sibling.

Module names carry over, the segmentor's neck included (``neck_mod``).

``state_dict_to_flax`` is the inverse; a leaf that maps to nothing raises,
so a round trip proves every leaf was carried.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_KEPT_LEAVES = ("pos_embed", "cls_token", "codewords")  # same name both sides
_OUT_PROJECTION = "out"  # the attention module whose kernel ends in embed


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _insert(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise KeyError(f"duplicate flax leaf {'/'.join(path)}")
    tree[path[-1]] = value


def _kernel_to_torch(kernel: np.ndarray, module: str) -> np.ndarray:
    if kernel.ndim == 4:
        return kernel.transpose(3, 2, 0, 1)  # HWIO → OIHW
    if kernel.ndim == 3:
        if module == _OUT_PROJECTION:
            return kernel.transpose(2, 0, 1)  # (H, D, E) → (E, H, D)
        return kernel.transpose(1, 2, 0)  # (E, H, D) → (H, D, E)
    if kernel.ndim == 2:
        return kernel.T  # (in, out) → (out, in)
    raise ValueError(f"unexpected kernel rank {kernel.ndim}")


def _weight_to_flax(weight: np.ndarray, module: str) -> Tuple[str, np.ndarray]:
    if weight.ndim == 4:
        return "kernel", weight.transpose(2, 3, 1, 0)  # OIHW → HWIO
    if weight.ndim == 3:
        if module == _OUT_PROJECTION:
            return "kernel", weight.transpose(1, 2, 0)  # (E, H, D) → (H, D, E)
        return "kernel", weight.transpose(2, 0, 1)  # (H, D, E) → (E, H, D)
    if weight.ndim == 2:
        return "kernel", weight.T
    if weight.ndim == 1:
        return "scale", weight
    raise ValueError(f"unexpected weight rank {weight.ndim}")


def flax_to_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any] | None = None
                       ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) → a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    flat = list(_flatten(params))
    # Encoding modules: their ``scale`` is not a norm's
    encodings = {path[:-1] for path, _ in flat if path[-1] == "codewords"}

    def put(path, leaf_map, value):
        leaf = path[-1]
        value = np.asarray(value)
        if leaf in _KEPT_LEAVES or (leaf == "scale" and path[:-1] in encodings):
            name = leaf
        elif leaf in leaf_map:
            name = leaf_map[leaf]
        else:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        if leaf == "kernel":
            value = _kernel_to_torch(value, path[-2] if len(path) > 1 else "")
        key = ".".join(path[:-1] + (name,))
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value))

    for path, value in flat:
        put(path, _PARAM_LEAVES, value)
    for path, value in _flatten(batch_stats or {}):
        put(path, _STAT_LEAVES, value)
    return out


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A torch ``state_dict`` → flax ``(params, batch_stats)`` of numpy."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    stat_names = {v: k for k, v in _STAT_LEAVES.items()}
    for key, tensor in state_dict.items():
        path = tuple(key.split("."))
        # a copy: on the CPU .numpy() shares the live tensor's memory
        value = tensor.detach().cpu().numpy().copy()
        leaf = path[-1]
        if leaf == "weight":
            name, value = _weight_to_flax(value, path[-2] if len(path) > 1 else "")
            _insert(params, path[:-1] + (name,), np.ascontiguousarray(value))
        elif leaf in _KEPT_LEAVES or leaf == "scale":
            _insert(params, path, value)
        elif leaf == "bias":
            _insert(params, path, value)
        elif leaf in stat_names:
            _insert(batch_stats, path[:-1] + (stat_names[leaf],), value)
        else:
            raise KeyError(f"unmapped torch leaf {key}")
    return params, batch_stats


def load_flax_into(module: torch.nn.Module, params, batch_stats=None) -> None:
    """Load flax weights into ``module``; every key must match both ways."""
    module.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)


def load_pretrain_state_from_flax(state, tree: Dict[str, Any]) -> None:
    """Carry a flax ``PretrainState`` (as numpy) into the port's state.

    ``tree`` holds ``params``, ``batch_stats``, ``ema_params``,
    ``ema_batch_stats``, ``queue``, ``queue_ptr``, ``queue2``,
    ``queue2_ptr`` and ``step`` — the fields of
    ``cp2_tpu.ssl.state.PretrainState`` but the optimizer state: its
    momentum is not carried, both sides start it at zero.  Every variant's
    tree carries by the same rename (MoCo/BYOL's ``projector.mlp`` and
    ``predictor``, their BatchNorm ``batch_stats``, DenseCL's ``neck``,
    the U-Net's ``decoder_{i}``).
    """
    load_flax_into(state.model, tree["params"], tree["batch_stats"])
    load_flax_into(state.ema_model, tree["ema_params"], tree["ema_batch_stats"])
    with torch.no_grad():
        state.queue.copy_(torch.from_numpy(np.asarray(tree["queue"])))
        state.queue2.copy_(torch.from_numpy(np.asarray(tree["queue2"])))
    state.queue_ptr = int(tree["queue_ptr"])
    state.queue2_ptr = int(tree["queue2_ptr"])
    state.step = int(tree["step"])


def pretrain_state_to_flax(state) -> Dict[str, Any]:
    """The inverse of ``load_pretrain_state_from_flax`` (numpy leaves)."""
    params, batch_stats = state_dict_to_flax(state.model.state_dict())
    ema_params, ema_batch_stats = state_dict_to_flax(state.ema_model.state_dict())
    return {
        "params": params,
        "batch_stats": batch_stats,
        "ema_params": ema_params,
        "ema_batch_stats": ema_batch_stats,
        "queue": state.queue.detach().cpu().numpy().copy(),
        "queue_ptr": np.int32(state.queue_ptr),
        "queue2": state.queue2.detach().cpu().numpy().copy(),
        "queue2_ptr": np.int32(state.queue2_ptr),
        "step": np.int32(state.step),
    }
