"""Device-side input prefetch: overlap the host-to-device copy of batch
i+1 with step i.

``DevicePrefetcher`` is a copy of ``cp2_tpu/data/prefetch.py``: it runs
``put(item)`` for the items of an iterator on a background thread, into a
bounded queue, so host decode (loader workers), the copy and device compute
pipeline freely.  ``HostToDevice`` is the ``put`` the pretrain CLI gives
it: it pins the uint8 frames and copies them with ``non_blocking=True`` on
a copy stream of its own.

The copy finishes on that stream, not on the one the step runs on, so a
staged batch is read through ``StagedBatch.wait()``: it makes the current
stream wait for the copy's event, and records the tensors on the current
stream so the allocator does not hand their memory to the next copy while
the step still reads them.  Skipping either gives silently wrong batches,
not an error.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = "done"
_ITEM = "item"
_ERROR = "error"


class DevicePrefetcher:
    """Iterate ``put(item)`` for items of ``iterator``, computed ahead.

    ``put`` runs on the background thread: give it the host-to-device
    work.  Order is preserved.  Exceptions from the iterator or ``put``
    re-raise at the consumer's ``__next__``.  ``close()`` (also called on
    exhaustion and by ``__exit__``) stops the thread promptly even
    mid-``put``.
    """

    def __init__(
        self,
        iterator: Iterable[Any],
        put: Callable[[Any], Any] = lambda x: x,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterator), put), daemon=True,
            name="device-prefetch",
        )
        self._thread.start()

    def _offer(self, msg) -> bool:
        """Blocking put that aborts when the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator[Any], put) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                if not self._offer((_ITEM, put(item))):
                    return
            self._offer((_DONE, None))
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._offer((_ERROR, e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        msg, payload = self._q.get()
        if msg == _ITEM:
            return payload
        if msg == _DONE:
            self.close()
            raise StopIteration
        self.close()
        raise payload

    def close(self) -> None:
        """Stop the worker and drop queued batches (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StagedBatch:
    """Device tensors whose copy may still be in flight on a copy stream."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 ready: Optional[torch.cuda.Event] = None, device=None):
        self._tensors = tensors
        self._ready = ready
        self._device = device

    def wait(self) -> Dict[str, torch.Tensor]:
        """The tensors, safe to read on the current stream."""
        if self._ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._ready)
            for t in self._tensors.values():
                t.record_stream(stream)
        return self._tensors


class HostToDevice:
    """``put`` for ``DevicePrefetcher``: a dict of numpy arrays → a
    ``StagedBatch`` on ``device``.

    On a CUDA device each array is pinned and copied with
    ``non_blocking=True`` on this object's copy stream, and an event marks
    the end of the copies; on the CPU the arrays are wrapped as they are.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, arrays: Dict[str, np.ndarray]) -> StagedBatch:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if self._stream is None:
            return StagedBatch({k: t.to(self.device) for k, t in host.items()})
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return StagedBatch(out, ready, self.device)
