"""Shift-sharded cross-correlation / CAF search (the counterpart of
``pydsproutines_tpu/parallel/xcorr.py``).

The shift axis is embarrassingly parallel: every rank holds the cutout and
rx whole, takes its contiguous block of the shift list and runs the
single-device ``fast_xcorr`` core on it. The sweep's uniform step is found
on the host over the WHOLE list, as the JAX ``_split`` does, and passed to
every rank, so a block of a uniform sweep takes the CAF kernel (#2,
"fused-hopper") and a block of a listed sweep stays listed (#4's
"peak-kernel-hopper" route at two-pass n). ``sharded_caf_peak`` reduces
with only each rank's (QF^2, shift, bin) scalars on the wire.

``sharded_fast_xcorr.route`` and ``sharded_caf_peak.route`` hold the
(path, reason) that this rank's last call dispatched (``_fast_xcorr_impl``
returns it; the router is not asked again).
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.ops.xcorr import _fast_xcorr_impl, _uniform_step
from pydsproutines_tpu_torch.parallel._exchange import (gather_scalars,
                                                        replicated, sharded,
                                                        shift_block)


def _split(cutout, rx, shifts, mesh, axis, batch_size):
    """(cutout, rx) on the mesh's device, this rank's shift block as a
    tensor there, the whole list's uniform step (None for a listed sweep)
    and the chunk size capped at the block."""
    cutout = replicated(cutout, mesh, "cutout")
    rx = replicated(rx, mesh, "rx")
    whole, mine = shift_block(shifts, mesh, axis)
    n = cutout.shape[-1]
    if mine.size and (mine.min() < 0 or mine.max() + n > rx.shape[-1]):
        raise ValueError(f"shifts [{mine.min()}, {mine.max()}] + cutout "
                         f"length {n} exceed rx length {rx.shape[-1]}")
    return (cutout, rx, torch.from_numpy(mine).to(rx.device),
            _uniform_step(whole), int(min(batch_size, mine.size)))


def sharded_fast_xcorr(cutout, rx, shifts, mesh, axis: str = "dsp",
                       freqsearch: bool = True, abs_result: bool = True,
                       batch_size: int = 128):
    """fast_xcorr with the shift axis split over ``mesh[axis]``; every rank
    calls it with the same arguments.

    ``shifts`` (the whole list, or a DTensor sharded ``Shard(0)`` on
    ``mesh[axis]``) must divide evenly over the mesh axis. Returns the
    outputs of fast_xcorr (QF^2 [+ freq bins]) as DTensors, ``Shard(0)`` on
    ``mesh[axis]``.
    """
    cutout, rx, mine, step, bs = _split(cutout, rx, shifts, mesh, axis,
                                        batch_size)
    out, sharded_fast_xcorr.route = _fast_xcorr_impl(
        cutout, rx, mine, n=cutout.shape[-1], batch_size=bs, step=step,
        freqsearch=bool(freqsearch), abs_result=bool(abs_result))
    if freqsearch:
        return tuple(sharded(o, mesh, axis) for o in out)
    return sharded(out, mesh, axis)


def sharded_caf_peak(cutout, rx, shifts, mesh, axis: str = "dsp",
                     batch_size: int = 128) -> tuple[float, int, int]:
    """Global CAF peak with minimal traffic: each rank reduces its own shift
    block to (best QF^2, best shift, best freq bin) and only those scalars
    cross ranks (an all-gather, then the largest peak, the lowest rank on
    ties).

    Returns (qf2_peak, best_shift, best_freq_bin) as Python scalars, the
    same on every rank.
    """
    cutout, rx, mine, step, bs = _split(cutout, rx, shifts, mesh, axis,
                                        batch_size)
    (qf2, freqs), sharded_caf_peak.route = _fast_xcorr_impl(
        cutout, rx, mine, n=cutout.shape[-1], batch_size=bs, step=step)
    i = torch.argmax(qf2)
    return gather_scalars(qf2[i], mine[i], freqs[i],
                          mesh[axis].get_group())


sharded_fast_xcorr.route = sharded_caf_peak.route = None
