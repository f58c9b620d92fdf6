"""Time-sharded FIR filtering with halo exchange (the counterpart of
``pydsproutines_tpu/parallel/filters.py``).

The distributed form of the streaming delay-line filter
(``ops.filters.stream_lfilter_step``): a capture is split into contiguous
time blocks over one mesh dimension; each rank receives the last
``len(taps)`` samples of its left neighbour's block (the overlap-save
halo; rank 0 gets zeros), filters its block, and the blocks of the output
make up the single-device filter's output. On the card the step runs the
upfirdn kernel (#5) at up = down = 1.
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.ops.filters import stream_lfilter_step
from pydsproutines_tpu_torch.parallel._exchange import (halo_from_left,
                                                        local_block,
                                                        replicated, sharded)
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for


def sharded_lfilter(taps, x, mesh, axis: str = "dsp"):
    """FIR-filter ``x`` (length divisible by the mesh axis size) with the
    time axis split over ``mesh[axis]``; every rank calls it with the same
    arguments. ``x`` is the whole capture or a DTensor sharded ``Shard(0)``
    on ``mesh[axis]``. Returns a DTensor of len(x), ``Shard(0)`` on
    ``mesh[axis]``, equal to ``ops.filters.lfilter_fir(taps, x)``. The taps
    are taken in x's type (real taps in its real type), as the JAX
    ``taps.astype(x.dtype)``.
    """
    ndev = mesh[axis].size()
    if x.shape[-1] % ndev != 0:
        raise ValueError("len(x) must divide evenly over the mesh axis")
    xl = local_block(x, mesh, axis)
    taps = replicated(taps, mesh, "taps")
    taps = taps.to(xl.dtype if taps.is_complex()
                   else real_dtype_for(xl.dtype))
    t = taps.shape[-1]
    if xl.shape[-1] < t:
        raise ValueError("per-device block must be >= filter length")
    halo = halo_from_left(xl[-t:], mesh[axis].get_group())
    y, _ = stream_lfilter_step(taps, xl, halo)
    return sharded(y, mesh, axis)
