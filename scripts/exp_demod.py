"""Where the demodulation layer's time goes on one GPU.

    env PYTHONPATH=. python scripts/exp_demod.py [--reps 11]

For each of the JAX bench's demod and Viterbi cells, on the scenes of
``chip_smoke.demod_layer`` (the burst-batched QPSK chain at 256 x 4096;
``viterbi_path_acs_batch`` on CP2FSK and CPM k_syms = 2 at 64 x 512; the
"branch" survivors one burst a call; the general and bursty scans at 128
symbols), prints the median CUDA-event time of one call over ``--reps``
calls with its quartiles, and from ``torch.profiler`` over three calls the
device time of the work the call puts on the card (kernels, copies, sets)
and how many such operations it launches: their ratio to the call time is
the share of the call the card is busy. One JSON line, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
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


def device_work(fn, calls: int = 3) -> tuple[float | None, float]:
    """(device milliseconds a call, device operations a call) of fn, from
    the profiler's CUDA events; (None, 0) where it records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        return None, 0.0
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / calls
    return busy, len(ops) / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from pydsproutines_tpu_torch.ops import (BurstyViterbiDemodulator,
                                             DemodulatorBatchQPSK,
                                             ViterbiDemodulator,
                                             viterbi_path_acs_batch)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    calls = {}

    x, lengths, amble, _, _ = cs.qpsk_batch_scene(seed=31)
    xd, ld = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    dmq = DemodulatorBatchQPSK(device=dev)
    calls["qpsk_demod_batch_256x4096"] = lambda: dmq.demod_batch(
        xd, cs.DM_OSR, amble, 0, cs.DM_SEARCH, cs.DM_OUT, lengths=ld)

    alphabet = np.array([1.0, -1.0], np.complex64)
    pret = np.array([[0, 1], [0, 1]], np.int32)
    start = np.array([True, True])
    for cell, pulse, omega in (
            ("cp2fsk_viterbi_path_64x512", np.ones(cs.VT_UP), 0.0),
            ("cpm_viterbi_k2_path_64x512", np.full(2 * cs.VT_UP, 0.5), 0.05)):
        ys, _ = cs.trellis_scene(41, pulse, omega, 0.3)
        yd = torch.from_numpy(ys).to(dev)
        targs = (alphabet, pret, pulse[None].astype(np.complex64),
                 np.array([omega], np.float32), start)
        kw = dict(up=cs.VT_UP, pulselen=pulse.size,
                  k_syms=pulse.size // cs.VT_UP, pathlen=cs.VT_NSYMS,
                  pret_static=pret, start_static=start)
        calls[cell] = (lambda yd=yd, targs=targs, kw=kw:
                       viterbi_path_acs_batch(yd, *targs, **kw))
        if omega == 0.0:
            vd = ViterbiDemodulator(alphabet, pret, targs[2], targs[3],
                                    cs.VT_UP, np.array([0, 1]), "branch",
                                    device=dev)
            y0 = yd[0]
            calls["branch_tables_one_burst_of_512"] = (
                lambda: vd.run(y0, cs.VT_NSYMS))

    up, pathlen = 4, 128
    y = torch.from_numpy((np.random.default_rng(43).standard_normal(
        pathlen * up + 2 * up) + 0j).astype(np.complex64)).to(dev)
    cpm = np.exp(1j * np.arange(4) * np.pi / 2).astype(np.complex64)
    pre4 = np.array([[(p - 1) % 4, (p + 1) % 4] for p in range(4)], np.int32)
    pulse4 = np.full((1, 2 * up), 0.5, np.complex64)
    gen = ViterbiDemodulator(cpm, pre4, pulse4, [0.05], up, device=dev)
    bursty = BurstyViterbiDemodulator(alphabet, pret, pulse4, [0.0], up, 20,
                                      4, device=dev)
    calls["general_scan_128"] = lambda: gen.run(y, pathlen)
    calls["bursty_scan_128"] = lambda: bursty.run(y, pathlen)

    out = {}
    for name, fn in calls.items():
        t = event_times(fn, args.reps)
        q = statistics.quantiles(t, n=4)
        busy, nops = device_work(fn)
        med = statistics.median(t)
        out[name] = {"call_ms": med, "q1_ms": q[0], "q3_ms": q[2],
                     "device_ms": busy, "device_ops": nops,
                     "busy_share": None if busy is None else busy / med}
        dev_txt = ("not measured (no CUDA events)" if busy is None else
                   f"device {busy:.4f} ms in {nops:.0f} operations, busy "
                   f"{busy / med:.1%}")
        print(f"{name}: call {med:.4f} ms (q1 {q[0]:.4f}, q3 {q[2]:.4f}); "
              f"{dev_txt} [{card}]")
    print(json.dumps({"demod_layer": out, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
