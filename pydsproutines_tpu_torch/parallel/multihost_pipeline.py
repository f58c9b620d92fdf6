"""Multi-host capture processing walkthrough (the counterpart of
``examples/multihost_pipeline.py``).

Run the SAME program on every process, one a card, e.g. with torchrun:

    torchrun --nproc-per-node 4 -m \\
        pydsproutines_tpu_torch.parallel.multihost_pipeline [capture.bin]

or as one process (it works unchanged; ``--device cpu`` runs it on the CPU
over gloo). Per process: seek-read only this process's time range of the
capture, assemble the global DTensor, run the time-sharded FIR (halos
cross processes) and the shift-sharded CAF peak (only scalars on the
wire), then checkpoint a block job to XcorrDB so a preempted process
resumes at the first missing block, with heartbeats a supervisor can read.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch.distributed as dist
from scipy import signal as sps

from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB
from pydsproutines_tpu_torch.models.pipeline import CheckpointedXcorrPipeline
from pydsproutines_tpu_torch.parallel import sharded_caf_peak, sharded_lfilter
from pydsproutines_tpu_torch.parallel.multihost import (Heartbeat, flat_mesh,
                                                        init_distributed,
                                                        read_local_capture,
                                                        run_elastic,
                                                        shard_local_blocks)

TOTAL = 1 << 16          # capture samples
TEMPLATE = 512           # the template's length, planted at shift 0


def main(argv=None) -> dict:
    """Run the walkthrough; returns what this process printed, as a dict."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("capture", nargs="?", help="interleaved-int16 capture "
                   f"of {TOTAL} samples (default: a synthesized one)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    multi = init_distributed(device_type=args.device)  # no-op as one process
    mesh = flat_mesh("dsp", args.device)
    nproc, pid = dist.get_world_size(), dist.get_rank()
    print(f"[{pid}] processes={nproc} (multi={multi})")

    with tempfile.TemporaryDirectory() as tmp:
        # --- input: per-process seek-based read of one int16 capture
        path = args.capture
        if path is None:    # a demo capture (every process writes the same)
            rng = np.random.default_rng(0)
            path = str(Path(tmp) / "capture.bin")
            rng.integers(-2000, 2000, 2 * TOTAL, dtype=np.int16).tofile(path)
        local = read_local_capture(path, TOTAL, nproc, pid)
        gx = shard_local_blocks(local, mesh, "dsp")

        # --- time-sharded FIR over the global DTensor (halos cross ranks)
        y = sharded_lfilter(sps.firwin(129, 0.25).astype(np.float32), gx,
                            mesh, "dsp")

        # --- shift-sharded CAF peak (the same scalars back on every rank):
        # every process holds the same template, planted at shift 0
        rng = np.random.default_rng(1)
        template = (rng.standard_normal(TEMPLATE) + 1j
                    * rng.standard_normal(TEMPLATE)).astype(np.complex64)
        noise = 0.01 * (rng.standard_normal(4096)
                        + 1j * rng.standard_normal(4096))
        rx_full = np.concatenate([template, noise.astype(np.complex64)])
        per = 256
        shifts = shard_local_blocks(
            np.arange(pid * per, (pid + 1) * per, dtype=np.int64), mesh,
            "dsp")
        peak, sbest, fbest = sharded_caf_peak(template, rx_full, shifts,
                                              mesh, "dsp")
        print(f"[{pid}] CAF peak QF2={peak:.3f} at shift {sbest} bin {fbest}"
              f" (expect 0)")

        # --- checkpointed, heartbeat-monitored block job (a local DB)
        db = XcorrDB(str(Path(tmp) / f"xc_{pid}.db"))
        pipe = CheckpointedXcorrPipeline(db, "xc", template, fs=1e6,
                                         block_shifts=512,
                                         device=gx.to_local().device)
        hb = Heartbeat(Path(tmp) / "hb", pid, interval=0.0)
        nblocks = run_elastic(pipe, rx_full, heartbeat=hb)
        stale = hb.stale_processes(timeout=60.0, expected=nproc)
        print(f"[{pid}] checkpointed {nblocks} blocks; stale={stale}")
        db.close()
    return {"processes": nproc, "filtered": tuple(y.shape), "peak": peak,
            "shift": sbest, "bin": fbest, "blocks": nblocks, "stale": stale}


if __name__ == "__main__":
    main()
