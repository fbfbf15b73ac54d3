"""What every task's runner shares: set-up is the first epoch, the window
runs whole steps epoch after epoch until its time has passed, and the
program's side of the check comes from what the first steps captured."""

from __future__ import annotations

import time

from bmk import checks


class Loop:
    """A runner defines ``run_epoch(epoch, stop_at) -> bool`` (False when it
    stopped at ``stop_at``), ``batch``, ``steps``, ``feed`` and
    ``capture``."""

    def setup(self):
        self.run_epoch(0)
        self.epoch = 1

    def window(self, seconds: float) -> int:
        """Steps completed from now for ``seconds``; epochs go on where
        set-up left them, and ``epoch_s`` keeps each whole epoch's time."""
        start, stop_at = self.steps, time.perf_counter() + seconds
        self.epoch_s, t = [], time.perf_counter()
        while self.run_epoch(self.epoch, stop_at):
            self.epoch += 1
            self.epoch_s.append(time.perf_counter() - t)
            t = time.perf_counter()
        return self.steps - start

    def images(self, steps: int) -> int:
        return steps * self.batch

    def program_side(self) -> dict:
        cap = self.capture
        out = checks.side(cap["loss"], cap["grad0"], cap["params"], cap["p0"],
                          ema=cap.get("ema"))
        if self.feed.kind == "files":
            out["loader"] = self.loader_diff
        return out
