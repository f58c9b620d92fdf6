"""Device timing on CUDA events (reference timingRoutines Timer) and
structured profiler tracing.

PyTorch returns before the card finishes, so a host clock measures the
enqueue. Here every lap is a CUDA event recorded on the current stream, and
reading a lap synchronises on its event. Both need a CUDA device: there is
no host-clock fallback. ``Timer`` returns seconds, as the JAX package's
``Timer`` does; ``median_ms`` returns milliseconds.

``trace`` / ``annotate`` are the counterparts of the JAX package's
``jax.profiler`` wrappers, over ``torch.profiler``: a Chrome trace of the
host and the card, and named host spans inside it.
"""

from __future__ import annotations

import contextlib
import os
import statistics

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a CPU + CUDA profiler trace of the block and write it as a
    Chrome trace (``trace.json``) into ``logdir``.

    Usage::

        with trace("/tmp/tr"):
            out = fast_xcorr(...)
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span that shows up on the host timeline inside a ``trace``
    capture (``with annotate("xcorr-chunk"): ...``)."""
    return torch.profiler.record_function(name)


class Timer:
    """Event laps on the current CUDA stream: ``start()``, then
    ``evt(label)`` per lap and ``end()`` for the total, in seconds."""

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

    def evt(self, label: str = "", block_on=None) -> float:
        """Record a lap. Returns seconds since the previous lap (or start).

        ``block_on`` is accepted for the JAX signature: the event is
        recorded on the stream after the work, and reading it waits for
        that work, so there is nothing more to wait for."""
        prev = self._laps[-1][1] if self._laps else self._t0
        e = self._record()
        self._laps.append((label, e))
        e.synchronize()
        return prev.elapsed_time(e) / 1e3

    def end(self, block_on=None) -> float:
        """Total seconds since start() (``block_on`` as in ``evt``)."""
        e = self._record()
        e.synchronize()
        return self._t0.elapsed_time(e) / 1e3

    def rpt(self):
        """Print each lap's seconds and the total, as the JAX Timer does."""
        prev = self._t0
        for label, e in self._laps:
            print(f"{label}: {prev.elapsed_time(e) / 1e3:.6f}s")
            prev = e
        if self._laps:
            total = self._t0.elapsed_time(self._laps[-1][1]) / 1e3
            print(f"Total: {total:.6f}s")


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
        times.append(t.end() * 1e3)
    return statistics.median(times)
