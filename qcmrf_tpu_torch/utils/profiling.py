"""Wall-clock counters (the part of :mod:`qcmrf_tpu.utils.profiling` that
``run`` uses). Work queued on a CUDA device is waited for with
``torch.cuda.synchronize`` before the clock is read."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Counter:
    """Accumulates work items and elapsed time; reports rates."""

    items: float = 0.0
    bytes: float = 0.0
    seconds: float = 0.0

    def add(self, items: float = 0.0, nbytes: float = 0.0,
            seconds: float = 0.0) -> None:
        self.items += items
        self.bytes += nbytes
        self.seconds += seconds

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    @property
    def gb_per_sec(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "items": self.items,
            "seconds": round(self.seconds, 6),
            "items_per_sec": round(self.items_per_sec, 1),
            "gb_per_sec": round(self.gb_per_sec, 3),
        }


@contextlib.contextmanager
def stopwatch(counter: Counter, items: float = 0.0, nbytes: float = 0.0,
              device: Optional[torch.device] = None):
    """Time a block into a counter; on a CUDA ``device`` the clock stops
    only after the device has finished the block's work."""
    t0 = time.perf_counter()
    yield
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    counter.add(items=items, nbytes=nbytes,
                seconds=time.perf_counter() - t0)
