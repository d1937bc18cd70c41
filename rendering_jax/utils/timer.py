"""Phase wall-clock timers — the analogue of the reference's RAII
Timer (`include/timer.h:8-40`).

The reference prints per-phase milliseconds on destructor. Here a phase
timer calls `jax.block_until_ready` on outputs before stopping so device
time is actually captured, and prints through a module logger gated by
`enable_output` (the reference's `options::enableOutput`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any


class Timer:
    def __init__(self, name: str = "Unnamed timer:", enable_output: bool = True):
        self.name = name
        self.enable_output = enable_output
        self.start = time.perf_counter()
        self.elapsed_ms: float | None = None
        self._running = True

    def stop(self, sync: Any = None) -> float:
        if not self._running:
            return self.elapsed_ms or 0.0
        if sync is not None:
            import jax

            jax.block_until_ready(sync)
        self._running = False
        self.elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.enable_output:
            print(f"{self.name:<18}{self.elapsed_ms:.0f} ms")
        return self.elapsed_ms


@contextlib.contextmanager
def phase_timer(name: str, enable_output: bool = True, result: dict | None = None):
    t = Timer(name, enable_output)
    box: dict = {}
    try:
        yield box
    finally:
        ms = t.stop(sync=box.get("sync"))
        if result is not None:
            result[name] = ms
