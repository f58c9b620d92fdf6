#!/usr/bin/env python3
"""The group CAF kernel (#8) alone at the JAX bench's group-xcorr cell.

    env PYTHONPATH=. python scripts/exp_group_caf.py [--reps N]
        [--variants 16x3,32x2]

Builds the kernels, prints ptxas's registers and spills of the kernel,
then on the cell of ``chip_smoke.group_scene`` (8 groups of 4096 every
16,384, 128 CZT bins, 1024 shifts, a copy planted at shift 517, bin 70)
times the kernel over the plan's pre-split tone bank, its twin and
``torch.matmul`` over the gathered windows (full f32) with CUDA events,
and prints the largest kernel-vs-twin difference over the whole grid on the
QF^2 scale (chip_smoke.py's GROUP_QF2_ATOL gate), on the uniform sweep and
on a sorted list of 128 of its shifts, each line tagged with the card's name
and power limit. ``--variants`` also builds ``csrc/group_caf.cu`` alone
with other stage depths and ring depths (``DEPTHxSTAGES``, the
GROUP_CAF_BK / GROUP_CAF_STAGES macros) into the build directory and times
them against each other in alternating rounds, each with its QF^2 error.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.group_caf import (SCRATCH_SLABS,
                                                          _group_caf_cuda,
                                                          group_caf,
                                                          group_caf_plain,
                                                          tf32_planes)
from pydsproutines_tpu_torch.ops.xcorr import power_prefix
from pydsproutines_tpu_torch.utils.dtypes import full_f32
from pydsproutines_tpu_torch.utils.timing import median_ms


def build_variant(depth: int, stages: int):
    """``csrc/group_caf.cu`` alone, built with this stage and ring depth
    into the build directory; its ``pdsp_group_caf``."""
    out = _build.BUILD_DIR / f"group_caf_{depth}x{stages}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-DGROUP_CAF_BK={depth}", f"-DGROUP_CAF_STAGES={stages}",
                    "-o", str(out), str(_build.CSRC / "group_caf.cu")],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(out)).pdsp_group_caf
    fn.argtypes, fn.restype = _build._SIGNATURES["pdsp_group_caf"]
    return fn


def time_variants(specs, gx, rx, reps, tag):
    """Each DEPTHxSTAGES build on the sweep, in alternating rounds."""
    tfold, starts, k = gx._tfold, gx._starts_t, gx.plan.k
    g, m = starts.shape[0], tfold.shape[0] // starts.shape[0]
    dev = rx.device
    offs = torch.arange(cs.G_SHIFTS, device=dev)
    ref = group_caf_plain(rx, offs, starts, tfold, k)
    pw = power_prefix(rx)
    norm = gx.ystack_norm_sq * sum(pw[offs + s + cs.G_LEN] - pw[offs + s]
                                   for s in gx.starts.tolist())
    part = torch.empty(SCRATCH_SLABS * cs.G_SHIFTS * k, dtype=torch.complex64,
                       device=dev)
    out = torch.empty((cs.G_SHIFTS, k), dtype=torch.float32, device=dev)
    splits = ctypes.c_int(0)
    runs = []
    for spec in specs:
        depth, stages = (int(x) for x in spec.split("x"))
        planes = tf32_planes(tfold, depth)
        fn = build_variant(depth, stages)

        def run(fn=fn, planes=planes):
            rc = fn(rx.data_ptr(), rx.shape[0], offs.data_ptr(), cs.G_SHIFTS,
                    starts.data_ptr(), g, m, planes.data_ptr(), k,
                    planes.shape[1] * 64, part.data_ptr(), part.numel(),
                    out.data_ptr(), ctypes.addressof(splits),
                    torch.cuda.current_stream().cuda_stream)
            _build.check(rc, f"group_caf variant {spec}")
        runs.append((spec, run))
    for rnd in range(3):
        for spec, run in runs:
            run()
            torch.cuda.synchronize()
            err = float(((out - ref).double() / norm[:, None]).abs().max())
            ms = median_ms(run, reps=reps)
            print(f"round {rnd} depth x stages {spec}: {ms:.4f} ms, QF^2 "
                  f"max|d| {err:.3e}, {splits.value} slabs {tag}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--variants", default="",
                    help="comma-separated DEPTHxSTAGES builds to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_group_caf: CUDA is not available", file=sys.stderr)
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
        if "group_caf_wg" in line and "Compiling" in line:
            print("ptxas:", " | ".join(x.strip()
                                       for x in lines[i + 2: i + 4]))
    dev = torch.device("cuda", 0)
    gx, _, rx = cs.group_scene(np.random.default_rng(2024), dev)
    tfold, starts, k, planes = gx._tfold, gx._starts_t, gx.plan.k, gx._tf32
    pw = power_prefix(rx)
    listed = np.sort(np.append(np.random.default_rng(7).choice(
        np.setdiff1d(np.arange(cs.G_SHIFTS), [cs.G_STAR]), cs.G_LIST - 1,
        replace=False), cs.G_STAR))
    for name, offs in (("sweep", torch.arange(cs.G_SHIFTS, device=dev)),
                       ("list", torch.from_numpy(listed).to(dev))):
        got = group_caf(rx, offs, starts, tfold, k, planes)
        ref = group_caf_plain(rx, offs, starts, tfold, k)
        norm = gx.ystack_norm_sq * sum(pw[offs + s + cs.G_LEN] - pw[offs + s]
                                       for s in gx.starts.tolist())
        err = float(((got - ref).double() / norm[:, None]).abs().max())
        peak = np.unravel_index(int(torch.argmax(got)), got.shape)
        print(f"{name}: QF^2 max|d| {err:.3e} (gate {cs.GROUP_QF2_ATOL}), "
              f"peak at shift {int(offs[peak[0]])} bin {peak[1]}, "
              f"{group_caf.splits} slabs")
    offs = torch.arange(cs.G_SHIFTS, device=dev)
    g_ms = median_ms(lambda: _group_caf_cuda(rx, offs, starts, tfold, k,
                                             planes), reps=args.reps)
    p_ms = median_ms(lambda: group_caf_plain(rx, offs, starts, tfold, k),
                     reps=args.reps)
    xg = rx[offs[:, None] + (starts[:, None] + torch.arange(
        cs.G_LEN, device=dev)).reshape(1, -1)]
    with full_f32():
        lib_ms = median_ms(lambda: torch.matmul(xg, tfold), reps=args.reps)
    flop = 8.0 * cs.G_SHIFTS * cs.G_GROUPS * cs.G_LEN * k
    print(f"group CAF kernel {g_ms:.4f} ms ({flop / g_ms / 1e9:.1f} "
          f"f32-equivalent TFLOP/s, {3 * flop / g_ms / 1e9:.1f} TF32 TFLOP/s),"
          f" twin {p_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms {tag}")
    if args.variants:
        time_variants(args.variants.split(","), gx, rx, args.reps, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
