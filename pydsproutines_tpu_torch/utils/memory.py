"""Byte budget of the CAF searches' per-chunk working memory.

Every CAF route processes its shifts in chunks. A chunk's working set grows
with n x shifts (windows, spectra, kernel scratch), so a count of shifts
alone does not bound it: 128 shifts of a 10M-sample window are ~10 GB per
complex64 buffer. Each route states its bytes per (shift, sample) and takes
its chunk from :func:`chunk_shifts`; a smaller chunk changes no result.
"""

from __future__ import annotations

# ~1 GiB per chunk: large enough that every route keeps the card busy at
# n = 1M (128 shifts of kernel scratch), small enough for an 80 GB card to
# hold rx, the template and a chunk at n = 10M.
WORK_BUDGET_BYTES = 1 << 30


def chunk_shifts(n: int, batch: int, bytes_per_sample: int,
                 budget: int = WORK_BUDGET_BYTES) -> int:
    """Shifts per chunk: at most ``batch``, and at most as many as keep
    ``n * bytes_per_sample`` bytes per shift within ``budget``; never
    fewer than one."""
    if n < 1 or batch < 1 or bytes_per_sample < 1:
        raise ValueError(f"bad chunk request n={n}, batch={batch}, "
                         f"bytes_per_sample={bytes_per_sample}")
    return max(1, min(batch, budget // (n * bytes_per_sample)))
