"""Checkpointed block-processing pipeline runner.

PyTorch counterpart of the JAX package's ``models/pipeline.py``. The
reference checkpoints at the results level: XcorrDB rows are keyed by
unique scan parameters, so reprocessing is skippable. This runner composes
those semantics into a restartable long-capture job:

  * the capture is processed in blocks of ``block_shifts`` consecutive
    shifts through the port's ``fast_xcorr`` (a uniform sweep: on a CUDA
    complex64 capture the Hopper CAF kernel, route ``"fused-hopper"``),
  * each block's result is written to an XcorrDB table keyed by the block's
    first shift, committed per block,
  * on restart, completed blocks are read from the DB and skipped.

As in the JAX package, only whole blocks run: the shifts past the last full
block (``num_blocks``) are not searched.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB
from pydsproutines_tpu_torch.ops.xcorr import (_checked_shifts,
                                               _fast_xcorr_impl)
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import to_tensor


class CheckpointedXcorrPipeline:
    """Process a long capture against a template in resumable blocks.

    Each block covers ``block_shifts`` consecutive shifts; results are
    persisted as type-1 rows (per-shift QF^2 + peak freq bin) in ``table``
    of ``db``. Re-running with the same parameters resumes after the last
    completed block. The template lives on ``device`` (the card unless it
    names another) and each capture is moved there. ``xcorr_path`` and
    ``xcorr_path_reason`` name the route the last block computed took, as
    ``fast_xcorr``'s core dispatched it (None before any).
    """

    def __init__(self, db: XcorrDB, table: str, template, fs: float,
                 fc: float = 0.0, block_shifts: int = 1024,
                 batch_size: int = 128, metrics=None, device=None):
        self.device = resolve_device(device)
        self.db = db
        self.table = table
        self.template = to_tensor(template, self.device)
        self.fs = fs
        self.block_shifts = int(block_shifts)
        self.batch_size = int(batch_size)
        self.metrics = metrics  # utils.metrics.MetricsSink or None
        self.xcorr_path = self.xcorr_path_reason = None
        db.create_xcorr_results_table(
            table, fc, int(fs), "rx", "template", XcorrDB.TYPE_1D,
            desc=b"checkpointed block xcorr")

    # ------------------------------------------------------------------
    def _base(self, block_idx: int) -> dict:
        n = int(self.template.shape[-1])
        return dict(
            time_sec=0, tidx=block_idx * self.block_shifts, cutoutlen=n,
            td_scan_start=float(block_idx * self.block_shifts),
            td_scan_numsteps=self.block_shifts, td_scan_step=1.0,
            fd_scan_start=0.0, fd_scan_numsteps=0, fd_scan_step=0.0,
            rfd_scan_start=0.0, rfd_scan_numsteps=0, rfd_scan_step=0.0)

    def completed_blocks(self) -> set[int]:
        rows = self.db.select_results(self.table)
        # tidx is the 2nd base column
        return {int(r[1]) // self.block_shifts for r in rows}

    def num_blocks(self, rx_len: int) -> int:
        n = int(self.template.shape[-1])
        total_shifts = rx_len - n + 1
        return max(0, total_shifts // self.block_shifts)

    # ------------------------------------------------------------------
    def run(self, rx, progress: bool = False) -> int:
        """Process every missing block of ``rx``; returns the number of
        blocks computed this call (0 if already complete)."""
        rx = to_tensor(rx, self.device)
        nblocks = self.num_blocks(int(rx.shape[-1]))
        done = self.completed_blocks()
        computed = 0
        for bi in range(nblocks):
            if bi in done:
                continue
            t0 = time.perf_counter()
            s0 = bi * self.block_shifts
            # host shifts: fast_xcorr's check sees their uniform step, so
            # the block routes to the uniform-sweep kernel
            shifts, step, batch = _checked_shifts(
                self.template, rx, np.arange(s0, s0 + self.block_shifts),
                None, self.batch_size)
            (qf2, freqs), route = _fast_xcorr_impl(
                self.template, rx, shifts, n=int(self.template.shape[-1]),
                batch_size=batch, step=step)
            self.xcorr_path, self.xcorr_path_reason = route
            qf2_np, freqs_np = qf2.cpu().numpy(), freqs.cpu().numpy()
            self.db.insert_1d_result(self.table, self._base(bi),
                                     qf2_np, freqs_np)
            computed += 1
            peak = float(np.max(qf2_np)) if qf2_np.size else 0.0
            if self.metrics is not None:
                # the copies to numpy above waited for the card, so the wall
                # clock covers the whole block
                self.metrics.emit("xcorr.block_seconds",
                                  time.perf_counter() - t0, unit="s",
                                  block=bi, nblocks=nblocks, peak_qf2=peak)
            if progress:
                print(f"block {bi + 1}/{nblocks} done "
                      f"(peak QF2 {peak:.3f})")
        if self.metrics is not None and computed:
            self.metrics.emit("xcorr.blocks_completed",
                              len(self.completed_blocks()), nblocks=nblocks)
        return computed

    def peak(self):
        """Global (shift, qf2, freq bin) across all completed blocks."""
        best = (None, -1.0, None)
        for row in self.db.select_results(self.table):
            base_tidx = int(row[1])
            qf2, fi = XcorrDB.regenerate_1d(row[-3], row[-2])
            k = int(np.argmax(qf2))
            if qf2[k] > best[1]:
                best = (base_tidx + k, float(qf2[k]), int(fi[k]))
        return best
