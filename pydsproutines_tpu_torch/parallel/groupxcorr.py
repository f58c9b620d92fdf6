"""Shift-sharded group cross-correlation (the counterpart of
``pydsproutines_tpu/parallel/groupxcorr.py``).

Shifts are embarrassingly parallel: rx and the plan are replicated (every
rank builds the same plan from the same numpy parameters, e.g. with
``GroupXcorrCZT.from_numpy_params``), each rank runs the plan's ``xcorr``
on its contiguous shift block (on the card a CZT plan with a tone bank
launches the group CAF kernel, #8; ``GroupXcorrFFT`` is plain torch), and
the (shifts, k) CAF comes back sharded over shifts, or reduced to one peak
triple with only scalars crossing ranks.
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.parallel._exchange import (gather_scalars,
                                                        replicated, sharded,
                                                        shift_block)


def _local_caf(plan, rx, shifts, mesh, axis, batch_size):
    """(the plan's (block, k) CAF over this rank's shift block, the
    block)."""
    rx = replicated(rx, mesh, "rx")
    _, mine = shift_block(shifts, mesh, axis)
    out = plan.xcorr(rx, mine, batch_size=int(min(batch_size, mine.size)))
    return (out[0] if isinstance(out, tuple) else out), mine


def sharded_group_xcorr_czt(plan, rx, shifts, mesh, axis: str = "dsp",
                            batch_size: int = 32):
    """GroupXcorrCZT.xcorr with the shift axis split over ``mesh[axis]``;
    every rank calls it with the same arguments and an equal plan.

    Returns (caf, czt_freq): the (shifts, k) QF^2 grid as a DTensor,
    ``Shard(0)`` on ``mesh[axis]``, and the plan's CZT frequencies."""
    caf, _ = _local_caf(plan, rx, shifts, mesh, axis, batch_size)
    return sharded(caf, mesh, axis), plan.czt_freq


def sharded_group_xcorr_fft(plan, rx, shifts, mesh, axis: str = "dsp",
                            batch_size: int = 32):
    """GroupXcorrFFT.xcorr with the shift axis split over ``mesh[axis]``;
    returns the (shifts, fftlen) QF^2 CAF as a DTensor, ``Shard(0)`` on
    ``mesh[axis]``."""
    caf, _ = _local_caf(plan, rx, shifts, mesh, axis, batch_size)
    return sharded(caf, mesh, axis)


def sharded_group_xcorr_peak(plan, rx, shifts, mesh, axis: str = "dsp",
                             batch_size: int = 32) -> tuple[float, int, int]:
    """Global (peak QF^2, best shift, best freq bin) of a GroupXcorrCZT/FFT
    scan with only each rank's scalars crossing ranks; the same Python
    scalars on every rank (the lowest rank's on ties)."""
    caf, mine = _local_caf(plan, rx, shifts, mesh, axis, batch_size)
    flat = caf.reshape(-1)
    i = torch.argmax(flat)               # on the device: no wait here
    k = caf.shape[-1]
    return gather_scalars(flat[i], torch.from_numpy(mine).to(caf.device)[
        i // k], i % k, mesh[axis].get_group())
