#!/usr/bin/env python3
"""The transform phase's kernels alone: WOLA's plane-I/O instance (#1)
against its complex instance and the interleave -> kernel -> split route,
and where ``FourStepFFT.call_peak``'s time goes.

    env PYTHONPATH=. python scripts/exp_transform.py [--reps N] [--label L]

Runs on the checkout that ``PYTHONPATH`` names, so one call can time a
parent tree (which has only the complex instance) and a change in turns
(parent, change, change, parent), each in its own process. At
chip_smoke.py's WOLA shapes (131,072 rows x 64 channels with 2048 taps;
65,536 x 128 with 1024; 32,768 x 256 with 2048) it times, with CUDA events
around one call (median of ``--reps`` after a warm-up) and by the
profiler's device time of the WOLA kernel: the complex instance
(``wola_fused``), and where the tree has them the plane instance
(``wola_fused_planes``) and the complex instance on planes interleaved
before and split after (all its kernels' device time). Where the tree has
``FourStepFFT.call_peak``, at 16 x 2^20 and 1 x 10^7 it prints the
profiler's device time by kernel of ``call_peak``, of its leading stages
alone and of the library call ``torch.fft.fft -> |.|^2 -> max``. One JSON
line a part, with the card's name and power limit; where the process built
the kernels, ptxas's registers and spills of each WOLA instance first.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import scipy.signal as sps
import torch

WOLA_SHAPES = ((64, 2048, 131072), (128, 1024, 65536), (256, 2048, 32768))
PEAK_SHAPES = ((16, 1 << 20), (1, 10_000_000))


def events_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of one call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernels(fn, reps: int) -> dict[str, tuple[float, int]]:
    """Device milliseconds a call and launches a call of each kernel fn
    runs, by the profiler over ``reps`` calls (device events only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            out[e.key[:80]] = (us / 1e3 / reps, e.count // reps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def device_ms(fn, reps: int, match: str = "") -> float:
    return sum(t for k, (t, _) in device_kernels(fn, reps).items()
               if match in k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_transform: CUDA is not available", file=sys.stderr)
        return 1
    from pydsproutines_tpu_torch.ops import fft as tfft
    from pydsproutines_tpu_torch.ops.hopper import _build
    from pydsproutines_tpu_torch.ops.hopper import wola_fused as wf
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    samples = max(n * rows for n, _, rows in WOLA_SHAPES)
    re_all, im_all = (torch.from_numpy(rng.standard_normal(
        samples, dtype=np.float32)).to(dev) for _ in range(2))
    _build.library()
    log = _build.build_info.log.splitlines()
    for i, line in enumerate(log[:-2]):
        if "Compiling entry" in line and "wola_fold_fft" in line:
            print("PTXAS", line.split("'")[1], "|", log[i + 1].strip(), "|",
                  log[i + 2].strip())
    for n, taps, rows in WOLA_SHAPES:
        h = torch.from_numpy(sps.firwin(taps, 1.0 / n).astype(
            np.float32)).to(dev)
        re, im = re_all[: rows * n], im_all[: rows * n]
        x = torch.complex(re, im)
        rec = {"label": args.label, "shape": f"{rows}x{n} ch, {taps} taps",
               "complex_ms": events_ms(lambda: wf.wola_fused(h, x, n),
                                       args.reps),
               "complex_device_ms": device_ms(
                   lambda: wf.wola_fused(h, x, n), args.reps,
                   "wola_fold_fft")}
        if hasattr(wf, "wola_fused_planes"):
            def split():
                o = wf.wola_fused(h, torch.complex(re, im), n)
                return o.real.contiguous(), o.imag.contiguous()
            planes = (lambda: wf.wola_fused_planes(h, re, im, n))
            rec.update(
                planes_ms=events_ms(planes, args.reps),
                planes_device_ms=device_ms(planes, args.reps,
                                           "wola_fold_fft"),
                interleave_split_ms=events_ms(split, args.reps),
                interleave_split_device_ms=device_ms(split, args.reps))
        print("WOLA", json.dumps({**rec, "card": card}), flush=True)
    if not hasattr(tfft, "FourStepFFT"):
        return 0
    for b, n in PEAK_SHAPES:
        x = torch.complex(torch.randn(b, n, device=dev),
                          torch.randn(b, n, device=dev))
        plan = tfft.get_fft_plan(n)
        calls = {"call_peak": lambda: plan.call_peak(x),
                 "leading_stages": lambda: plan._leading_stages(x),
                 "library": lambda: torch.fft.fft(x).abs().square().max(
                     dim=-1)}
        for name, fn in calls.items():
            print("PEAK", json.dumps({
                "label": args.label, "shape": f"{b} x {n}",
                "factors": plan.factors, "call": name,
                "ms": events_ms(fn, args.reps),
                "device": device_kernels(fn, args.reps), "card": card}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
