"""PSK demodulation stages of the receiver (reference demodulationRoutines:
getEyeOpening, lockPhase, mapSyms).

PyTorch counterpart of ``pydsproutines_tpu/ops/demod.py:53-104``. The phase
lock uses the closed-form 2x2 symmetric eigen-decomposition in place of an
SVD, as the JAX package and the reference's own CUDA kernel do.
"""

from __future__ import annotations

import numpy as np
import torch

# Constellations: monotonically increasing angle index (reference pskdicts).
_SQ2 = np.sqrt(2.0) / 2.0
PSK_CONSTS = {
    2: np.array([1.0, -1.0], dtype=np.complex128),
    4: np.array([1.0, 1.0j, -1.0, -1.0j], dtype=np.complex128),
    8: np.array([1.0, _SQ2 * (1 + 1j), 1.0j, _SQ2 * (-1 + 1j),
                 -1.0, _SQ2 * (-1 - 1j), -1.0j, _SQ2 * (1 - 1j)],
                dtype=np.complex128),
}


def get_eye_opening(x: torch.Tensor, osr: int):
    """Best sampling phase by maximum mean |x| over OSR phases. Returns
    (resampled syms, phase index, metric)."""
    x_rs = x.reshape(-1, osr)
    metric = torch.mean(torch.abs(x_rs), dim=0)
    i = torch.argmax(metric)
    return x_rs[:, i], i, metric


def _sym_eig2(a, b, c):
    """Eigen-decomposition of [[a, b], [b, c]]: returns (lam_max, lam_min,
    angle of principal eigenvector)."""
    tr = a + c
    half_diff = (a - c) / 2
    root = torch.sqrt(half_diff * half_diff + b * b)
    theta = 0.5 * torch.atan2(2 * b, a - c)
    return tr / 2 + root, tr / 2 - root, theta


def lock_phase(reim: torch.Tensor, m: int):
    """Blind phase lock: raise to the m/2 power (fold to BPSK), form the 2x2
    real self-product, take the principal eigenvector angle. Returns
    (corrected, svd_metric, angle)."""
    powerup = m // 2
    reimp = reim
    for _ in range(powerup - 1):             # integer power by repeated product
        reimp = reimp * reim
    re, im = reimp.real, reimp.imag
    lam_max, lam_min, theta = _sym_eig2(torch.sum(re * re), torch.sum(re * im),
                                        torch.sum(im * im))
    corrected = reim * torch.polar(torch.ones_like(theta), -theta / powerup)
    return corrected, lam_min / lam_max, theta


def map_syms(reimc: torch.Tensor, m: int) -> torch.Tensor:
    """Map phase-locked samples to symbol indices 0..m-1 by max dot product
    with the constellation vectors. Returns uint8."""
    const = torch.as_tensor(PSK_CONSTS[m], device=reimc.device).to(reimc.dtype)
    metric = (reimc.real[:, None] * const.real[None, :]
              + reimc.imag[:, None] * const.imag[None, :])
    return torch.argmax(metric, dim=-1).to(torch.uint8)
