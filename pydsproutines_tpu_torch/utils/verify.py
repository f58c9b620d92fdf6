"""Verification helpers (reference verifyRoutines.py:12), a copy of the JAX
package's numpy-only ``utils/verify``.

``compare_values`` returns (max absolute diff, max fractional diff) between two
arrays, the reference's cross-tier parity metric. Works on numpy arrays and on
tensors on any device (copied to the host first).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def compare_values(a, b, verbose: bool = False):
    """Max raw and fractional difference between two arrays.

    Fractional difference is |a-b| / |b| computed where |b| > 0.
    """
    a = _host(a)
    b = _host(b)
    diff = np.abs(a - b)
    mag = np.abs(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(mag > 0, diff / mag, 0.0)
    max_diff = float(np.max(diff)) if diff.size else 0.0
    max_frac = float(np.max(frac)) if frac.size else 0.0
    if verbose:
        print(f"Max abs diff: {max_diff:.6g}, max frac diff: {max_frac:.6g}")
    return max_diff, max_frac
