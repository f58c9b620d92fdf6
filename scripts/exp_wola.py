#!/usr/bin/env python3
"""The WOLA channelizer kernel (#1/#1b) alone: its first version (a direct
IDFT sum) against the register fold + shared-memory FFT, at chip_smoke.py's
shapes.

    env PYTHONPATH=. python scripts/exp_wola.py [--reps N] [--rounds R]
        [--variants 1,3]

Builds the kernels and prints ptxas's registers and spills of the WOLA
kernels. Then at 131,072 rows x 64 channels with 2048 taps (the receiver's
and the detection chain's geometry) and at the JAX ``_kernel_direct``
shapes (65,536 x 128 with 1024 taps, 32,768 x 256 with 2048 taps) it times,
with CUDA events, the first version (kept whole in csrc/wola_fused.cu) and
the current kernel in alternating rounds (first, current, current, first),
each call held to the plain twin (max|d| / max|ref|), each timed twice:
the call's CUDA events (the wrapper's host work included) and the kernel's
device time (the profiler); then the twin once.
``--variants`` builds csrc/wola_fused.cu alone with WOLA_MIN_BLOCKS (the
blocks an SM its registers are cut for) set to each value and times those
builds in alternating rounds. Each line carries the card's name and power
limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import scipy.signal as sps
import torch

import chip_smoke as cs
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.wola_fused import (
    _tables, _wola_fused_cuda, plan_text, wola_direct_cuda, wola_plain,
    wola_plan)
from exp_upfirdn import device_ms
from pydsproutines_tpu_torch.utils.timing import median_ms

SHAPES = ((cs.NCH, cs.TAPS, cs.ROWS), *cs.WOLA_DIRECT)


def build_variant(blocks: int):
    """csrc/wola_fused.cu alone, built with WOLA_MIN_BLOCKS = ``blocks`` into
    the build directory: (its pdsp_wola_fused, ptxas lines)."""
    out = _build.BUILD_DIR / f"wola_B{blocks}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          f"-DWOLA_MIN_BLOCKS={blocks}", "-o", str(out),
                          str(_build.CSRC / "wola_fused.cu")],
                         check=True, capture_output=True, text=True,
                         timeout=600)
    fn = ctypes.CDLL(str(out)).pdsp_wola_fused
    fn.argtypes, fn.restype = _build._SIGNATURES["pdsp_wola_fused"]
    log = (res.stdout + res.stderr).splitlines()
    regs = [f"{log[i].split(chr(39))[1][-28:]}: {log[i + 2].strip()}"
            for i, ln in enumerate(log[:-2]) if "Compiling entry" in ln]
    return fn, regs


def run_variant(fn, h, x, n):
    """One launch of a variant build, as _wola_fused_cuda launches."""
    rows, nb = x.shape[-1] // n, h.shape[-1] // n
    plan = wola_plan(n, nb)
    out = torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    wl, rev, rad = _tables(n, x.device)
    rc = fn(x.data_ptr(), h.data_ptr(), wl.data_ptr(), rev.data_ptr(),
            out.data_ptr(), rows, n, nb, ctypes.addressof(rad),
            len(plan["radices"]), plan["kb"], plan["rc"],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "wola variant launch")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default="",
                    help="comma-separated WOLA_MIN_BLOCKS builds to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_wola: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    _build.library()
    lines = _build.build_info.log.splitlines()
    for i, line in enumerate(lines):
        if "wola" in line and "Compiling" in line:
            print("ptxas:", line.split("'")[1][-48:], "|",
                  " | ".join(x.strip() for x in lines[i + 2: i + 4]))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2024)
    variants = {}
    for name in filter(None, args.variants.split(",")):
        variants[name] = build_variant(int(name))
        print(f"build B{name}: {' | '.join(variants[name][1])}")
    medians = {}
    for n, taps, rows in SHAPES:
        h = torch.from_numpy(sps.firwin(taps, 1.0 / n).astype(
            np.float32)).to(dev)
        x = torch.from_numpy((rng.standard_normal(rows * n)
                              + 1j * rng.standard_normal(rows * n)).astype(
            np.complex64)).to(dev)
        ref = wola_plain(h, x, n, n)
        plan = wola_plan(n, taps // n)
        b = cs.wola_bound(rows, n, taps)
        print(f"{rows}x{n}, {taps} taps: {plan_text(plan)}; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        runs = {"first": lambda: wola_direct_cuda(h, x, n),
                "current": lambda: _wola_fused_cuda(h, x, n)}
        times = {k: [] for k in runs}
        for rnd in range(args.rounds):
            for name in ("first", "current", "current", "first"):
                got = runs[name]()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max() / ref.abs().max())
                if err >= cs.WOLA_RTOL:
                    raise RuntimeError(f"{name} N={n}: rel err {err:.3e}")
                ms = median_ms(runs[name], reps=args.reps)
                dev_ms = device_ms(runs[name], "wola")
                times[name].append(dev_ms)
                print(f"{rows}x{n} round {rnd} {name}: {ms:.4f} ms a call, "
                      f"device {dev_ms:.4f} ms, rel err {err:.3e} {tag}")
        plain_ms = median_ms(lambda: wola_plain(h, x, n, n), reps=3)
        medians[n] = {k: float(np.median(v)) for k, v in times.items()}
        print(f"{rows}x{n} twin {plain_ms:.4f} ms; device medians {medians[n]} "
              f"{tag}")
        for rnd in range(args.rounds if variants else 0):
            for name in [*variants, *reversed(variants)]:
                fn = variants[name][0]
                got = run_variant(fn, h, x, n)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max() / ref.abs().max())
                ms = device_ms(lambda f=fn: run_variant(f, h, x, n), "wola")
                print(f"{rows}x{n} round {rnd} build B{name}: device "
                      f"{ms:.4f} ms, "
                      f"rel err {err:.3e} {tag}")
        del x, ref
    print("device medians:", medians)
    return 0


if __name__ == "__main__":
    sys.exit(main())
