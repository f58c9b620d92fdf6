"""Where the geolocation path's time goes on one GPU.

    env PYTHONPATH=. python scripts/exp_pipeline.py [--reps 5]

On the scene of ``chip_smoke.geolocation`` (four 2^20-sample captures, a
16,384-sample burst), prints for the checkpointed CAF pipeline of one pair
(15 blocks of 65,536 shifts, a fresh database each call) the median
CUDA-event time of a call with its quartiles, the per-block seconds its
``MetricsSink`` records, and the parts of one block: ``fast_xcorr`` over
the block (CUDA events), the copy of its results to the host and the
sqlite insert and commit (host clock); and, from ``torch.profiler``, the
device time and operations of a pipeline call, of the fine stage of the
three pairs and of the 2048 x 2048 TDFD grid, with each one's busy share.
One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from exp_demod import device_work, event_times


def host_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from pydsproutines_tpu_torch.estimation import TDFDGridLocalizer
    from pydsproutines_tpu_torch.io import XcorrDB
    from pydsproutines_tpu_torch.models import CheckpointedXcorrPipeline
    from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr
    from pydsproutines_tpu_torch.utils.metrics import MetricsSink, read_metrics

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    sc = cs.geo_scene(dev, 41)
    caps, tmpl = sc["caps"], sc["template"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = iter(range(10**6))

        def pipeline(k, metrics=None):
            db = XcorrDB(os.path.join(tmp, f"run{next(runs)}.db"))
            pipe = CheckpointedXcorrPipeline(db, f"pair0{k}", tmpl, cs.GEO_FS,
                                             cs.GEO_FC, cs.GEO_BLOCK,
                                             cs.GEO_BATCH, metrics=metrics,
                                             device=dev)
            pipe.run(caps[k])
            db.close()
            return pipe

        t = event_times(lambda: pipeline(1), args.reps)
        q = statistics.quantiles(t, n=4)
        busy, nops = device_work(lambda: pipeline(1), calls=1)
        path = os.path.join(tmp, "m.jsonl")
        with MetricsSink(path) as sink:
            pipeline(1, sink)
        blocks = [r["value"] * 1e3 for r in read_metrics(path)
                  if r["name"] == "xcorr.block_seconds"]
        out["pipeline_one_pair"] = {
            "call_ms": statistics.median(t), "q1_ms": q[0], "q3_ms": q[2],
            "device_ms": busy, "device_ops": nops,
            "busy_share": (None if busy is None
                           else busy / statistics.median(t)),
            "block_ms_median": statistics.median(blocks),
            "block_ms_min": min(blocks), "block_ms_max": max(blocks)}

        # the parts of one block
        s0 = 6 * cs.GEO_BLOCK
        shifts = np.arange(s0, s0 + cs.GEO_BLOCK)
        xc = event_times(lambda: fast_xcorr(tmpl, caps[1], True,
                                            shifts=shifts,
                                            batch_size=cs.GEO_BATCH),
                         args.reps)
        qf2, bins = fast_xcorr(tmpl, caps[1], True, shifts=shifts,
                               batch_size=cs.GEO_BATCH)
        torch.cuda.synchronize()
        copy = host_ms(lambda: (qf2.cpu().numpy(), bins.cpu().numpy()),
                       args.reps)
        qn, bn = qf2.cpu().numpy(), bins.cpu().numpy()
        db = XcorrDB(os.path.join(tmp, "insert.db"))
        db.create_xcorr_results_table("t", cs.GEO_FC, int(cs.GEO_FS), "rx",
                                      "template", XcorrDB.TYPE_1D)
        ins = host_ms(lambda: db.insert_1d_result(
            "t", dict(tidx=next(runs)), qn, bn), args.reps)
        db.close()
        out["one_block"] = {"fast_xcorr_ms": statistics.median(xc),
                            "copy_to_host_ms": statistics.median(copy),
                            "sqlite_insert_commit_ms": statistics.median(ins)}

    # each pair's coarse peak from the scene's truth
    n = cs.GEO_BURST
    peaks = []
    for k in (1, 2, 3):
        td, fd = cs.geo_truth(sc, k)
        peaks.append((int(cs.GEO_T0 + td * cs.GEO_FS), 0.0,
                      int(round(fd / (cs.GEO_FS / n))) % n))

    def fine():
        return [cs.geo_fine(tmpl, caps[k], s, b)
                for k, (s, _, b) in zip((1, 2, 3), peaks)]

    t = event_times(fine, args.reps)
    busy, nops = device_work(fine, calls=1)
    out["fine_three_pairs"] = {"call_ms": statistics.median(t),
                               "device_ms": busy, "device_ops": nops}
    m = cs.geo_measurements(sc, peaks, fine())
    xr = np.linspace(-cs.GEO_HALF, cs.GEO_HALF, cs.GEO_GRID)
    loc = TDFDGridLocalizer.from_xy_meshgrid(xr, xr, 0.0, device=dev)

    def grid():
        return cs.geo_run_grid(loc, m)

    t = event_times(grid, args.reps)
    busy, nops = device_work(grid, calls=1)
    out["tdfd_grid_2048"] = {"call_ms": statistics.median(t),
                             "device_ms": busy, "device_ops": nops}
    for name, r in out.items():
        print(name, json.dumps(r), f"[{card}]")
    print(json.dumps({"geolocation_parts": out, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
