"""Time-sharded WOLA channelizer with halo exchange (the counterpart of
``pydsproutines_tpu/parallel/wola.py``).

The distributed form of the streaming Channeliser: a capture is split into
contiguous time blocks over one mesh dimension; each rank receives a
filter-length halo from its left neighbour, channelises halo + block, and
drops the ``jump = len(f_tap) // dec`` warm-up rows, so the rows of every
rank make up the single-device ``wola`` of the whole capture (the N == 2*Dec
odd-row flip kept global through ``row_offset``). At N == Dec each rank's
call is one launch of the WOLA kernel (#1) on the card.

``sharded_multichannel_wola`` splits a stack of independent captures by
channel instead: no halo, nothing crosses ranks.

``sharded_wola.route`` and ``sharded_multichannel_wola.route`` hold the
(path, reason) that this rank's last call dispatched
(``ops.wola._wola_impl``).
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.ops.wola import _wola_impl
from pydsproutines_tpu_torch.parallel._exchange import (halo_from_left,
                                                        local_block,
                                                        replicated, sharded)


def sharded_wola(f_tap, x, dec: int, n: int, mesh, axis: str = "dsp"):
    """WOLA channelize with the time axis split over ``mesh[axis]``; every
    rank calls it with the same arguments.

    ``x`` is the whole capture or a DTensor sharded ``Shard(0)`` on
    ``mesh[axis]``. Requires len(x) divisible by (mesh axis size * dec) and
    a block per rank of at least len(f_tap) samples. Returns a DTensor of
    (len(x)//dec, n) rows, ``Shard(0)`` on ``mesh[axis]``, equal to
    ``ops.wola.wola(f_tap, x, dec, n)``.
    """
    sub = mesh[axis]
    ndev = sub.size()
    total = x.shape[-1]
    if total % (ndev * dec) != 0:
        raise ValueError("len(x) must divide evenly over mesh axis * dec")
    block = total // ndev
    f_tap = replicated(f_tap, mesh, "f_tap")
    L = f_tap.shape[-1]
    if block < L:
        raise ValueError("per-device block must be >= filter length")
    jump = L // dec
    xl = local_block(x, mesh, axis)
    halo = halo_from_left(xl[-L:], sub.get_group())
    # local row r of wola(halo + block) is global row rank*rows - jump + r
    row_offset = sub.get_local_rank() * (block // dec) - jump
    ch, sharded_wola.route = _wola_impl(f_tap, torch.cat([halo, xl]), dec, n,
                                        row_offset)
    return sharded(ch[jump:], mesh, axis)


def sharded_multichannel_wola(f_tap, x, dec: int, n: int, mesh,
                              axis: str = "dsp"):
    """Channelize a (channels, len) stack of independent captures with the
    CHANNEL axis split over ``mesh[axis]``; nothing crosses ranks.

    ``x`` is the whole stack or a DTensor sharded ``Shard(0)`` on
    ``mesh[axis]``. Returns a DTensor of (channels, len//dec, n), ``Shard(0)``
    on ``mesh[axis]``, equal to ``ops.wola.wola`` of each row. Combine with
    time sharding on a 2-D mesh: channels on one axis (this function), time
    blocks on the other (``sharded_wola``)."""
    if x.ndim != 2:
        raise ValueError("x must be (channels, len)")
    if x.shape[0] % mesh[axis].size() != 0:
        raise ValueError("channel count must divide evenly over the mesh axis")
    f_tap = replicated(f_tap, mesh, "f_tap")
    rows = []
    for row in local_block(x, mesh, axis):
        ch, sharded_multichannel_wola.route = _wola_impl(f_tap, row, dec, n)
        rows.append(ch)
    return sharded(torch.stack(rows), mesh, axis)


sharded_wola.route = sharded_multichannel_wola.route = None
