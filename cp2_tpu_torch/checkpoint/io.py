"""Checkpoint persistence of the train states, with ``torch.save``.

Port of ``cp2_tpu/checkpoint/io.py`` (orbax there), same layout and
semantics: ``<dir>/<step>/`` holds the state file ``state.pt`` and a
``meta.json`` carrying the tags the reference embeds (``pretrain_type``,
``backbone_type``, ``epoch``, the finetune's monitored metric), and
``<dir>/latest`` names the newest step.  A pretrain state is saved as the
query model, the EMA model, the optimizer, both queues with their
pointers, and the step; a finetune ``SegTrainState`` as the model, the
optimizer and the step.

The state file is written to a temporary name and renamed, so an
interrupted save never appears at the final path.  With ``async_save``
the state is first copied to the CPU, then written on a thread while
training goes on; :func:`wait_for_checkpoints` waits for every such write.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

META_NAME = "meta.json"
STATE_NAME = "state.pt"

_pending: List[threading.Thread] = []
_errors: List[BaseException] = []


def _to_cpu(obj):
    """A copy of a nest of tensors on the CPU, the rest as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _is_pretrain(state) -> bool:
    return hasattr(state, "ema_model")


def state_payload(state) -> Dict[str, Any]:
    """The saved fields of a ``PretrainState`` or a ``SegTrainState``, on
    the CPU."""
    if not _is_pretrain(state):
        return _to_cpu({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
        })
    return _to_cpu({
        "model": state.model.state_dict(),
        "ema_model": state.ema_model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "queue": state.queue,
        "queue_ptr": int(state.queue_ptr),
        "queue2": state.queue2,
        "queue2_ptr": int(state.queue2_ptr),
        "step": int(state.step),
    })


def _write(payload: Dict[str, Any], path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_async(payload: Dict[str, Any], path: str) -> None:
    try:
        _write(payload, path)
    except BaseException as e:  # noqa: BLE001 — re-raised by wait_for_checkpoints
        _errors.append(e)


def wait_for_checkpoints() -> None:
    """Block until every pending async save has been written; re-raise the
    first error one of them met."""
    while _pending:
        _pending.pop().join()
    if _errors:
        err = _errors[0]
        _errors.clear()
        raise err


def checkpoint_path(directory: str, step: int) -> str:
    """The directory ``save_checkpoint(directory, step, ...)`` writes."""
    return os.path.join(os.path.abspath(os.path.expanduser(directory)), str(step))


def save_checkpoint(
    directory: str,
    step: int,
    state,
    meta: Optional[Dict[str, Any]] = None,
    *,
    keep_latest_link: bool = True,
    async_save: bool = False,
) -> str:
    """Save ``state`` under ``directory/step`` with ``meta``; returns the
    checkpoint directory.  With ``async_save`` the call returns once the
    state is copied to the CPU; call :func:`wait_for_checkpoints` before
    reading it back or exiting."""
    directory = os.path.abspath(os.path.expanduser(directory))
    path = checkpoint_path(directory, step)
    os.makedirs(path, exist_ok=True)
    payload = state_payload(state)
    target = os.path.join(path, STATE_NAME)
    if async_save:
        t = threading.Thread(target=_write_async, args=(payload, target),
                             name=f"checkpoint-{step}")
        t.start()
        _pending.append(t)
    else:
        _write(payload, target)
    with open(os.path.join(path, META_NAME), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if keep_latest_link:
        link = os.path.join(directory, "latest")
        tmp = link + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, link)
    return path


def gc_checkpoints(
    directory: str,
    keep_last: int,
    *,
    keep_every: int = 0,
    protect: Optional[List[int]] = None,
) -> List[int]:
    """Delete old step checkpoints, keeping the newest ``keep_last``.

    ``keep_every`` > 0 also keeps every step divisible by it; ``protect``
    pins explicit steps.  ``keep_last`` <= 0 keeps everything (the
    reference never deletes checkpoints).  Returns the deleted steps.
    """
    if keep_last <= 0:
        return []
    directory = os.path.abspath(os.path.expanduser(directory))
    if not os.path.isdir(directory):
        return []
    steps = sorted(int(d) for d in os.listdir(directory) if d.isdigit())
    keep = set(steps[-keep_last:])
    keep.update(s for s in steps if keep_every > 0 and s % keep_every == 0)
    keep.update(protect or [])
    deleted = []
    for s in steps:
        if s in keep:
            continue
        shutil.rmtree(os.path.join(directory, str(s)), ignore_errors=True)
        deleted.append(s)
    return deleted


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE_NAME))


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete checkpoint under ``directory``, or None."""
    directory = os.path.abspath(os.path.expanduser(directory))
    link = os.path.join(directory, "latest")
    if os.path.exists(link):
        with open(link) as f:
            path = os.path.join(directory, f.read().strip())
        # an async save cut short leaves the link ahead of the newest
        # complete checkpoint; fall through to the scan then
        if is_checkpoint(path):
            return path
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        (int(d) for d in os.listdir(directory)
         if d.isdigit() and is_checkpoint(os.path.join(directory, d))),
        reverse=True,
    )
    return os.path.join(directory, str(steps[0])) if steps else None


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into ``state`` (on the state's device); returns
    ``(state, meta)``."""
    path = os.path.abspath(os.path.expanduser(path))
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_NAME), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if _is_pretrain(state):
        state.ema_model.load_state_dict(payload["ema_model"])
        with torch.no_grad():
            state.queue.copy_(payload["queue"])
            state.queue2.copy_(payload["queue2"])
        state.queue_ptr = int(payload["queue_ptr"])
        state.queue2_ptr = int(payload["queue2_ptr"])
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, META_NAME)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
