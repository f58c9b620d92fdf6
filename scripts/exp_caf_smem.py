"""Time the CAF peak kernels #2 and #3 (shared-memory FFT) against their
torch.fft twins on one GPU, at the chip smoke test's sweeps.

    env PYTHONPATH=<checkout> python scripts/exp_caf_smem.py [--reps 3]

Builds the kernels of the checkout on PYTHONPATH, prints each CAF kernel's
registers, spills and shared memory from ``-Xptxas -v``, then the median
CUDA-event time of ``caf_peak`` at n = 1,000,000 x 128 and 1024 x 256 and of
``caf3_peak`` at n = 10,000,000 x 128 shifts, each beside its twin, with the
card's name and power limit; with ``--profile`` also each call's device time
by kernel (``torch.profiler``). Two checkouts timed in one call on one card
compare like with like.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch


def ptxas_summary(log: str) -> list[str]:
    """One line per CAF kernel entry: name, registers, spills, smem."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search(r"(col_pass|row_peak)", name) and (
                "spill" in line or "registers" in line):
            kind = re.search(r"(col_pass|row_peak)I?N?\S*?(Windows|Scratch)",
                             name)
            src = "caf3" if "fused_caf3" in name else "xcorr"
            tag = f"{src}:{kind.group(1)}<{kind.group(2)}>" if kind else name
            out.append(f"{tag}: {line.strip()}")
    return out


def kernel_times(fn):
    """(kernel name, device ms, launches) of one call of fn, by the
    profiler, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="also print each call's device time by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from pydsproutines_tpu_torch.ops.hopper import _build
    from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import (
        caf3_peak, caf3_peak_plain)
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (
        caf_peak, caf_peak_plain)
    from pydsproutines_tpu_torch.utils.timing import median_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _build.library()
    for line in ptxas_summary(_build.build_info.log):
        print("ptxas", line)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    res = {"card": card, "path": str(_build.build_info.path)}
    for name, n, shifts in (("caf_peak", 1_000_000, 128),
                            ("caf_peak", 1024, 256),
                            ("caf3_peak", 10_000_000, 128)):
        rx = torch.from_numpy((rng.standard_normal(n + shifts)
                               + 1j * rng.standard_normal(n + shifts)
                               ).astype(np.complex64)).to(dev)
        cc = torch.from_numpy((rng.standard_normal(n)
                               + 1j * rng.standard_normal(n)
                               ).astype(np.complex64)).to(dev)
        if name == "caf_peak":
            kern = lambda: caf_peak(rx, cc, 0, 1, shifts)          # noqa
            twin = lambda: caf_peak_plain(rx, cc, 0, 1, shifts)    # noqa
        else:
            offs = torch.arange(shifts, device=dev)
            kern = lambda: caf3_peak(rx, cc, offs)                 # noqa
            twin = lambda: caf3_peak_plain(rx, cc, offs)           # noqa
        km, kb = kern()
        pm, pb = twin()
        torch.cuda.synchronize()
        err = float(((km - pm).abs() / pm).max())
        key = f"{name} n={n} x {shifts}"
        res[key] = {"ms": median_ms(kern, reps=args.reps),
                    "plain_ms": median_ms(twin, reps=args.reps),
                    "rel_err": err,
                    "bins_equal": float((kb == pb).double().mean())}
        print(key, json.dumps(res[key]), f"[{card}]", flush=True)
        if args.profile:
            for kname, ms, count in kernel_times(kern):
                print(f"  {ms:9.4f} ms {count:4d}x {kname[:90]}")
        del rx, cc
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
