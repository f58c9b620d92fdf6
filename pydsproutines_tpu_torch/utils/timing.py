"""Device timing on CUDA events (reference timingRoutines Timer).

PyTorch returns before the card finishes, so a host clock measures the
enqueue. Here every lap is a CUDA event recorded on the current stream, and
reading a lap synchronises on its event. Both need a CUDA device: there is
no host-clock fallback.
"""

from __future__ import annotations

import statistics

import torch


class Timer:
    """Event laps on the current CUDA stream: ``start()``, then
    ``evt(label)`` per lap and ``end()`` for the total."""

    def __init__(self):
        self._t0: torch.cuda.Event | None = None
        self._laps: list[tuple[str, torch.cuda.Event]] = []

    @staticmethod
    def _record() -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self) -> "Timer":
        self._t0 = self._record()
        self._laps = []
        return self

    def evt(self, label: str = "") -> float:
        """Record a lap. Returns milliseconds since the previous lap (or
        start)."""
        prev = self._laps[-1][1] if self._laps else self._t0
        e = self._record()
        self._laps.append((label, e))
        e.synchronize()
        return prev.elapsed_time(e)

    def end(self) -> float:
        """Total milliseconds since start()."""
        e = self._record()
        e.synchronize()
        return self._t0.elapsed_time(e)


def median_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` calls, each timed
    by a pair of CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = Timer().start()
        fn()
        times.append(t.end())
    return statistics.median(times)
