#!/usr/bin/env python3
"""The upfirdn kernel (#5) alone: its first version against the
register-window polyphase FIR, at the JAX bench's resampling chain.

    env PYTHONPATH=. python scripts/exp_upfirdn.py [--reps N] [--rounds R]

Builds the kernels and prints ptxas's registers and spills of the upfirdn
kernels. Then on chip_smoke.py's chain (2 planes x 4,194,304 float32
samples, 730 combined taps, up 5, down 4) it times, with CUDA events, the
first version (kept whole in csrc/upfirdn.cu) and the current kernel in
alternating rounds (first, current, current, first), on the two separate
planes of the chain and on the two planes of one complex64 tensor (read in
place at element stride 2: the current kernel reads them as float2), each
call held to the plain twin (max|d| / max|ref|); then the twin and cuDNN's
``conv_transpose1d`` (TF32 off, as chip_smoke.py times it) once. Each line
carries the card's name and power limit, and each time comes twice: the
call's (CUDA events around one call, the wrapper's host work included) and
the kernel's device time (the profiler). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from pydsproutines_tpu_torch.ops.filters import combined_taps
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.upfirdn import (
    _upfirdn_cuda, get_upfirdn_size, plan_text, upfirdn_plan,
    upfirdn_planes_plain)
from pydsproutines_tpu_torch.utils.timing import median_ms


def device_ms(fn, match: str, reps: int = 5) -> float:
    """Device milliseconds a call of fn spends in kernels whose name holds
    ``match``, by the profiler over ``reps`` calls (the host's part of the
    call, which CUDA events around one call include, left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if match in e.key:
            total += us
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_upfirdn: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    _build.library()
    lines = _build.build_info.log.splitlines()
    for i, line in enumerate(lines):
        if "upfirdn" in line and "Compiling" in line:
            print("ptxas:", line.split("'")[1][-56:], "|",
                  " | ".join(x.strip() for x in lines[i + 2: i + 4]))
    dev = torch.device("cuda", 0)
    frng = np.random.default_rng(1)
    x_ri = frng.standard_normal((2, cs.N_FIR), dtype=np.float32)
    h_fir = frng.standard_normal(cs.FIR_TAPS).astype(np.float32)
    h_rs = frng.standard_normal(cs.RS_TAPS).astype(np.float32)
    h = torch.from_numpy(combined_taps(h_fir, h_rs, cs.UP).astype(
        np.float32)).to(dev)
    up, down, T = cs.UP, cs.DOWN, h.shape[0]
    n_out = get_upfirdn_size(cs.N_FIR, T, up, down)
    separate = tuple(torch.from_numpy(p).to(dev) for p in x_ri)
    xc = torch.complex(*separate)
    layouts = {"separate planes": separate, "complex64 pair": (xc.real,
                                                                xc.imag)}
    ref = upfirdn_planes_plain(separate, h, up, down, n_out)
    ref = torch.stack(ref)
    medians = {}
    for name, planes in layouts.items():
        print(f"{name}: {plan_text(upfirdn_plan(T, up, down, 4, 2))}")
        runs = {"first": lambda p=planes: _upfirdn_cuda(
                    p, h, up, down, n_out, None, kernel="v1"),
                "current": lambda p=planes: _upfirdn_cuda(
                    p, h, up, down, n_out, None)}
        times = {k: [] for k in runs}
        for rnd in range(args.rounds):
            for k in ("first", "current", "current", "first"):
                got = torch.stack(runs[k]())
                torch.cuda.synchronize()
                err = float((got - ref).abs().max() / ref.abs().max())
                if err >= cs.UPFIRDN_RTOL:
                    raise RuntimeError(f"{k} ({name}): rel err {err:.3e}")
                ms = median_ms(runs[k], reps=args.reps)
                dev_ms = device_ms(runs[k], "upfirdn")
                times[k].append(dev_ms)
                print(f"{name} round {rnd} {k}: {ms:.4f} ms a call, device "
                      f"{dev_ms:.4f} ms, rel err {err:.3e} {tag}")
        medians[name] = {k: float(np.median(v)) for k, v in times.items()}
    plain_ms = median_ms(lambda: upfirdn_planes_plain(separate, h, up, down,
                                                      n_out), reps=3)
    lib_ms = median_ms(cs.upfirdn_library_call(separate, h, up, down, n_out),
                       reps=5)
    print(f"twin {plain_ms:.4f} ms, cuDNN conv_transpose1d {lib_ms:.4f} ms "
          f"{tag}")
    print("device medians:", medians)
    return 0


if __name__ == "__main__":
    sys.exit(main())
