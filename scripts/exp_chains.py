"""Time the receiver step and the burst-detection chain of one checkout on
one GPU, at the chip smoke test's scenes, for parent-vs-change pairs.

    env PYTHONPATH=<checkout> python scripts/exp_chains.py [--reps 21]

Imports ``chip_smoke`` and the port from the checkout on PYTHONPATH (so one
copy of this script times any commit whose ``chip_smoke.py`` has
``wideband_scene``, ``burst_scene`` and ``detection_chain``), builds the
same receiver (64 ch, 2048 taps, 1024-sample template, 256 shifts) and
three-burst scene at 8,388,608 samples, and prints one JSON line: the
median CUDA-event time of ``WidebandReceiver.step`` and of the detection
chain over ``--reps`` calls each, with their quartiles and the card's name
and power limit. Run checkouts alternately in one call (parent, change,
change, parent, ...) to compare them.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def event_times(fn, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` calls of fn, by CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from pydsproutines_tpu_torch.models import WidebandReceiver
    from pydsproutines_tpu_torch.ops.wola import Channeliser

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    n_wide = cs.ROWS * cs.NCH
    rcv = WidebandReceiver(num_channels=cs.NCH, num_taps=cs.TAPS,
                           template_len=cs.N_RX, num_shifts=cs.SHIFTS_RX,
                           osr=4, demod_syms=128, m=4, device=dev)
    tri, xri = cs.wideband_scene(rcv, n_wide, seed=7)
    chan = Channeliser(num_taps=cs.TAPS, num_channels=cs.NCH, device=dev)
    tmpl, rx = cs.burst_scene(n_wide, cs.N_RX, seed=11, device=dev)
    res = {"card": card}
    for name, fn in (("receiver_step", lambda: rcv.step(tri, xri)),
                     ("detection_chain",
                      lambda: cs.detection_chain(chan, tmpl, rx))):
        t = event_times(fn, args.reps)
        q1, med, q3 = np.percentile(t, [25, 50, 75])
        res[name] = {"median_ms": float(med), "q1_ms": float(q1),
                     "q3_ms": float(q3)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
