"""Matrix profile: normalized sliding-window self-similarity over all
diagonals.

PyTorch counterpart of ``pydsproutines_tpu/ops/matrixprofile.py``
(reference matrixProfileRoutines.py: MatrixProfile :23, _computeDiagonal
:165, _chainify :96). For diagonal d and window W:

    kdiag_d[i] = | sum_{j<W} x[i+j] * conj(x[i+j+d]) |^2
                 / energy[i] / energy[i+d]

Diagonals are computed in batches of ``batch_size`` rows of a padded
(D, N-W+1) matrix, row d-1 holding diagonal d with exact zeros past its
valid length. Every window sum is a causal FIR by W ones through
``ops.filters._conv_causal``, one call over a whole batch: the upfirdn
kernel (#5) on the card, its plain twin on the CPU. Prefix sums in float32
would cancel catastrophically over long inputs, and the FIR sums each
window's W terms afresh, so it keeps the JAX package's ``jnp.convolve``
accuracy without float64 arithmetic on the card. Chain extraction (runs
over a threshold along each diagonal) is a copy of the host ``_chainify``.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.filters import _conv_causal
from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for


def _window_sums(ones: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_{j<W} x[..., i+j] for i in [0, n-W]: ``jnp.convolve(x, ones,
    "valid")`` as the tail of one causal FIR call."""
    return _conv_causal(ones, x)[..., ones.shape[-1] - 1:]


def matrix_profile(x, window: int, num_diags: int, batch_size: int = 64,
                   device=None) -> torch.Tensor:
    """Normalized matrix profile diagonals 1..num_diags as a padded
    (num_diags, N-W+1) matrix; row d-1 holds diagonal d with entries past its
    valid length (N-W+1-d) zeroed. A tensor stays on its device; an array
    goes to ``device`` (the card when None)."""
    x = place(x, device)
    n = x.shape[-1]
    nout = n - window + 1
    rdt = real_dtype_for(x.dtype)
    ones = torch.ones(window, dtype=rdt, device=x.device)

    power = x.real * x.real + x.imag * x.imag
    norms_sq = _window_sums(ones, power)                    # (nout,)
    xpad = torch.cat([x, x.new_zeros(num_diags + 1)])
    npad = torch.cat([norms_sq, norms_sq.new_ones(num_diags + 1)])
    cols = torch.arange(n, device=x.device)
    out = torch.empty((num_diags, nout), dtype=rdt, device=x.device)
    for d0 in range(1, num_diags + 1, batch_size):
        d = torch.arange(d0, min(d0 + batch_size, num_diags + 1),
                         device=x.device)
        shifted = xpad[d[:, None] + cols]                    # (b, n)
        kdiag = _window_sums(ones, x * shifted.conj())       # (b, nout)
        mag = kdiag.real * kdiag.real + kdiag.imag * kdiag.imag
        e2 = npad[d[:, None] + cols[:nout]]
        vals = mag / norms_sq / e2
        valid = cols[:nout] < (nout - d[:, None])
        out[d0 - 1: d0 - 1 + d.shape[0]] = torch.where(valid, vals, 0)
    return out


class MatrixProfile:
    """Matrix profile with optional chain extraction (reference MatrixProfile,
    matrixProfileRoutines.py:23)."""

    def __init__(self, window_length: int, output_chains: bool = False,
                 min_threshold: float | None = None,
                 min_chain_length: int = 0):
        self._window = int(window_length)
        self._output_chains = output_chains
        if output_chains and min_threshold is None:
            raise ValueError("min_threshold cannot be None if output_chains")
        self._min_threshold = min_threshold
        self._min_chain_length = int(min_chain_length)

    def compute(self, x, num_diags: int | None = None, device=None):
        """Returns the padded diagonal matrix, or the chain list when
        ``output_chains`` (list of (diagIdx, start, end) like the
        reference). A tensor stays on its device; an array goes to
        ``device`` (the card when None)."""
        x = place(x, device)
        n = x.shape[-1]
        if num_diags is None:
            num_diags = n - self._window
        mp = matrix_profile(x, self._window, int(num_diags))
        if not self._output_chains:
            return mp
        return self._chains_from_matrix(mp)

    def _chains_from_matrix(self, mp: torch.Tensor):
        """The reference's per-diagonal thresholding: the entries over the
        threshold are found on the matrix's device and only their (row,
        column) pairs come to the host, in row-major order."""
        nout = mp.shape[-1]
        d = torch.arange(1, mp.shape[0] + 1, device=mp.device)
        valid = torch.arange(nout, device=mp.device) < (nout - d[:, None])
        hits = torch.nonzero(valid & (mp > self._min_threshold)).cpu().numpy()
        chains = []
        rows, first = np.unique(hits[:, 0], return_index=True)
        for row, lo, hi in zip(rows, first, np.append(first[1:], len(hits))):
            idx = hits[lo:hi, 1]
            starts, ends, lengths = self._chainify(idx, self._min_chain_length)
            for s, l in zip(starts, lengths):
                chains.append((int(row) + 1, int(idx[s]), int(idx[s] + l)))
        return chains

    @staticmethod
    def _chainify(idx_arr: np.ndarray, min_chain_length: int = 0):
        """Contiguous-run extraction over an index array (reference _chainify,
        matrixProfileRoutines.py:96)."""
        d = np.diff(idx_arr)
        ii = np.argwhere(d > 1).reshape(-1) + 1
        starts = np.hstack((0, ii))
        ends = np.hstack((ii, idx_arr.size))
        lengths = ends - starts
        sel = np.argwhere(lengths > min_chain_length).reshape(-1)
        return starts[sel], ends[sel], lengths[sel]
