#!/usr/bin/env python3
"""The median-filter kernel (#6) alone, its first version against its tile
route, at the JAX bench's size.

    env PYTHONPATH=. python scripts/exp_medfilt.py [--reps N]
        [--widths 4,8,16,32] [--rounds R]

Builds the kernels and prints ptxas's registers and spills of the medfilt
kernels. Then on chip_smoke.py's signal (4,194,304 float32 noise powers,
k = 129) it times, with CUDA events, the kernel's radix route (c = 0: the
first version of the kernel, the MSB-first radix select per output, kept
whole in csrc/medfilt.cu) and its tile route at each tile width, in
alternating rounds (radix, tile widths..., tile widths reversed, radix),
each call checked bit-equal to the twin; then the twin (unfold +
torch.median) once. Each line carries the card's name and power limit and
the route's key compares an output (ops/hopper/medfilt.medfilt_plan).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.medfilt import (medfilt_plain,
                                                        medfilt_plan)
from pydsproutines_tpu_torch.utils.timing import median_ms


def run_width(lib, x, out, k, c):
    rc = lib.pdsp_medfilt_f32(x.data_ptr(), out.data_ptr(), x.shape[0], k, c,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"medfilt c={c}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--widths", default="4,8,16,32",
                    help="comma-separated tile widths to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_medfilt: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    lib = _build.library()
    lines = _build.build_info.log.splitlines()
    for i, line in enumerate(lines):
        if "medfilt" in line and "Compiling" in line and "If" in line:
            print("ptxas:", line.split("'")[1][-40:], "|",
                  " | ".join(x.strip() for x in lines[i + 2: i + 4]))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2024)
    z = rng.standard_normal(cs.N_MED) + 1j * rng.standard_normal(cs.N_MED)
    x = torch.from_numpy((np.abs(z) ** 2).astype(np.float32)).to(dev)
    k = cs.MED_K
    ref = medfilt_plain(x, k)
    out = torch.empty_like(x)
    widths = [int(w) for w in args.widths.split(",")]
    order = [0, *widths, *reversed(widths), 0]
    times = {c: [] for c in order}
    for rnd in range(args.rounds):
        for c in order:
            run_width(lib, x, out, k, c)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"c={c}: not bit-equal to the twin")
            ms = median_ms(lambda c=c: run_width(lib, x, out, k, c),
                           reps=args.reps)
            times[c].append(ms)
            plan = medfilt_plan(k, 4, c)
            name = "radix (first version)" if c == 0 else f"tile C={c}"
            print(f"round {rnd} {name}: {ms:.4f} ms, "
                  f"{plan['compares']:.0f} compares an output, bit-equal "
                  f"{tag}")
    plain_ms = median_ms(lambda: medfilt_plain(x, k), reps=3)
    print(f"twin (unfold + torch.median) {plain_ms:.4f} ms {tag}")
    print("medians:", {("radix" if c == 0 else f"C={c}"):
                       float(np.median(v)) for c, v in times.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
