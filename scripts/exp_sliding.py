#!/usr/bin/env python3
"""The sliding matched-filter kernel (#7) alone, its first version (the
direct product) against its overlap-save route, at chip_smoke.py's size.

    env PYTHONPATH=. python scripts/exp_sliding.py [--reps N] [--rounds R]
        [--nffts 2048,8192]

Builds the kernels and prints ptxas's registers and spills of the sliding
kernels. Then on chip_smoke.py's stationary scene (4,194,304 samples, 4
templates of 1024, template 2 planted at 1,234,567) and on its burst-edge
scene (the same length, -40 dB noise, a 20,000-sample unit-power burst
holding the template, a run of zeros) it times, with CUDA events, the
direct route (the first version of the kernel, kept whole in
csrc/sliding.cu) and the overlap-save route in alternating rounds (direct,
overlap-save, overlap-save, direct), each call held to the twin (QF^2
max|d|), with the overlap-save route's count of segments sent to the
direct product; then each launch's device time by kernel (the template
spectra and the segments, ``torch.profiler``). ``--nffts`` also times the
overlap-save route with other segment lengths on the stationary scene, in
alternating rounds with the plan's. Each line carries the card's name and
power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from exp_caf_smem import kernel_times
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.sliding import (
    _sliding_cuda, sliding_multiply_normalised, sliding_plain, sliding_plan)
from pydsproutines_tpu_torch.utils.timing import median_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--nffts", default="",
                    help="comma-separated segment lengths to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_sliding: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    _build.library()
    lines = _build.build_info.log.splitlines()
    for i, line in enumerate(lines):
        if ("sliding" in line or "template_spectra" in line) \
                and "Compiling" in line:
            print("ptxas:", line.split("'")[1][-48:], "|",
                  " | ".join(x.strip() for x in lines[i + 2: i + 4]))
    dev = torch.device("cuda", 0)
    scenes = {"stationary": cs.sliding_scene(),
              "burst-edge": cs.sliding_burst_scene()}
    plan = sliding_plan(cs.N_SL, cs.T_SL, cs.L_SL)
    print(f"plan: nfft {plan['nfft']}, {plan['valid']} shifts a segment, "
          f"{plan['segments']} segments, overlap-save {plan['ols_flop']:.4g} "
          f"vs direct {plan['direct_flop']:.4g} f32 operations")
    for name, (x, tm) in scenes.items():
        xs, ts = torch.from_numpy(x).to(dev), torch.from_numpy(tm).to(dev)
        ref = sliding_plain(xs, ts)
        for rnd in range(args.rounds):
            for route in ("direct", "ols", "ols", "direct"):
                got = _sliding_cuda(xs, ts, route)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                flagged = int(sliding_multiply_normalised.flagged)
                ms = median_ms(lambda r=route: _sliding_cuda(xs, ts, r),
                               reps=args.reps)
                print(f"{name} round {rnd} {route}: {ms:.4f} ms, QF^2 "
                      f"max|d| vs twin {err:.3e}"
                      + (f", {flagged} segments re-checked"
                         if route == "ols" else "") + f" {tag}")
        for row in kernel_times(lambda: _sliding_cuda(xs, ts, "ols")):
            print(f"  {name} profile: {row[0][:60]}: {row[1]:.4f} ms x "
                  f"{row[2]}")
        if name != "stationary" or not args.nffts:
            continue
        sizes = [plan["nfft"], *map(int, args.nffts.split(","))]
        for rnd in range(args.rounds):
            for nfft in sizes + sizes[::-1]:
                got = _sliding_cuda(xs, ts, "ols", nfft)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ms = median_ms(lambda f=nfft: _sliding_cuda(xs, ts, "ols", f),
                               reps=args.reps)
                print(f"{name} round {rnd} ols nfft={nfft}: {ms:.4f} ms, "
                      f"QF^2 max|d| vs twin {err:.3e} {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
