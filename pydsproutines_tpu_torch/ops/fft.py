"""DFT plans and the f32 tables of the Hopper CAF kernels.

The JAX package's ``FourStepFFT`` exists because XLA's TPU FFT was slow; it
is not ported as a transform. The plain twins use ``torch.fft``. What the
kernels need is the plan's factors and their tables, built here on the host
from float64 phases reduced mod their period before the exponential (the
pattern of ``pydsproutines_tpu/ops/fft.py`` and ``ops/pallas/fused_caf3.py``),
stored complex64.

Two-factor split n = n1*n2 (kernels #2 and #4), t = t1*n2 + t2,
k = k1 + n1*k2:

    W1[k1, t1] = exp(-2*pi*i*k1*t1/n1)      (n1, n1)
    TW[k1, t2] = exp(-2*pi*i*k1*t2/n)       (n1, n2)
    W2[t2, k2] = exp(-2*pi*i*t2*k2/n2)      (n2, n2)

so that X[k1 + n1*k2] = sum_t2 W2[t2, k2] TW[k1, t2] sum_t1 W1[k1, t1]
x[t1*n2 + t2].

Three-factor split n = f0*f1*f2 (kernel #3), see ``caf3_tables``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def best_two_factor(n: int, max_factor: int = 8192) -> tuple[int, int] | None:
    """Factor n = n1*n2 with n1 <= n2, n1 as close to sqrt(n) as possible.
    Returns None if no factorization fits under max_factor (e.g. primes)."""
    for n1 in range(int(math.isqrt(n)), 1, -1):
        if n % n1 == 0:
            n2 = n // n1
            if n1 <= max_factor and n2 <= max_factor:
                return n1, n2
            return None
    return None


def factorize_for_mxu(n: int, max_factor: int = 1024,
                      min_factor: int = 16) -> list[int] | None:
    """Stage sizes of a multi-stage matmul DFT (the JAX package's
    ``factorize_for_mxu``): about ceil(log_512 n) stages of size ~n^(1/k),
    picking the divisor closest to the target at each step. None when n has
    a prime factor > max_factor."""
    if n < 2:
        return None
    k = max(1, math.ceil(math.log(n) / math.log(512)))
    factors: list[int] = []
    rem = n
    while rem > max_factor:
        stages_left = max(2, k - len(factors))
        target = rem ** (1.0 / stages_left)
        best = None
        for d in range(2, max_factor + 1):
            if rem % d == 0 and d >= min_factor:
                if best is None or abs(d - target) < abs(best - target):
                    best = d
        if best is None:
            for d in range(2, max_factor + 1):
                if rem % d == 0:
                    best = d
                    break
            if best is None:
                return None
        factors.append(best)
        rem //= best
    factors.append(rem)
    return factors


def fft_factors(n: int, max_factor: int = 8192) -> list[int] | None:
    """The stage factors the JAX package's ``FourStepFFT(n)`` chooses: two
    balanced factors while n1 + n2 <= 3000, else the multi-stage split when
    it is cheaper; a single stage [n] for 128 <= n < 4096; None when no plan
    is viable (e.g. a large prime)."""
    two = best_two_factor(n, max_factor)
    if two is not None and sum(two) <= 3000:
        factors = list(two)
    else:
        multi = factorize_for_mxu(n, max_factor=1024)
        if multi is not None and (two is None or sum(multi) < sum(two)):
            factors = multi
        else:
            factors = list(two) if two is not None else None
    if factors is not None and n >= 4096 and len(factors) >= 2:
        return factors
    if 128 <= n < 4096:
        return [n]
    return None


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_macs(f0: int, f1: int, f2: int) -> int:
    """Complex MACs of the three-stage kernel per shift with its 64 x 64
    output tiles and depth-16 steps padded (csrc/cgemm.cuh)."""
    return (_pad(f0, 64) * _pad(f0, 16) * f1 * f2
            + f0 * _pad(f1, 64) * _pad(f1, 16) * _pad(f2, 64)
            + f0 * _pad(f1, 64) * _pad(f2, 16) * _pad(f2, 64))


@functools.lru_cache(maxsize=64)
def find_triple(n: int, lo: int = 16,
                hi: int = 1024) -> tuple[int, int, int] | None:
    """Factor n = f0*f1*f2 with every factor in [lo, hi], minimising
    f0 + f1 + f2 (the per-sample MAC count), then the kernel's tile-padded
    MAC count. The JAX package's finder also requires f2 % 128 == 0, a TPU
    lane rule that a Hopper tile does not have, so e.g. 5^10 = 125*125*625
    has a triple here and none there. None when no triple exists."""
    best, best_key = None, None
    for f0 in range(lo, min(hi, n) + 1):
        if n % f0:
            continue
        rest = n // f0
        for f1 in range(lo, min(hi, rest) + 1):
            if rest % f1:
                continue
            f2 = rest // f1
            if not lo <= f2 <= hi:
                continue
            key = (f0 + f1 + f2, _tile_macs(f0, f1, f2), (f0, f1, f2))
            if best_key is None or key < best_key:
                best, best_key = (f0, f1, f2), key
    return best


def _phase_exp(a: np.ndarray, b: np.ndarray, period: int) -> np.ndarray:
    """exp(-2*pi*i*(a x b mod period)/period) as complex64, phases in
    float64 reduced mod the period before the exponential."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.exp(-2j * np.pi * np.mod(np.outer(a, b), period)
                  / period).astype(np.complex64)


def dft_matrix(n: int) -> np.ndarray:
    """(n, n) complex64 forward DFT matrix exp(-2*pi*i*j*k/n)."""
    k = np.arange(n)
    return _phase_exp(k, k, n)


def twiddle(n1: int, n2: int) -> np.ndarray:
    """(n1, n2) complex64 four-step twiddle exp(-2*pi*i*k1*t2/(n1*n2))."""
    return _phase_exp(np.arange(n1), np.arange(n2), n1 * n2)


def stage_tables(factors) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-stage DFT matrices and twiddles of a multi-stage plan (the JAX
    ``FourStepFFT.stage_w`` / ``stage_tw``): at stage s, with the remaining
    transform length m = prod(factors[s:]) split as n1 x rest,
    TW_s[k1, j] = exp(-2*pi*i*k1*j/m), j < rest."""
    stage_w, stage_tw = [], []
    m = int(np.prod(factors))
    for n1 in factors[:-1]:
        rest = m // n1
        stage_w.append(dft_matrix(n1))
        stage_tw.append(_phase_exp(np.arange(n1), np.arange(rest), m))
        m = rest
    stage_w.append(dft_matrix(factors[-1]))
    return stage_w, stage_tw


def peak_consts(factors) -> tuple[np.ndarray, np.ndarray]:
    """(TW (K1, J), W2 (J, K2)) of the last-stage peak kernel for a plan
    whose last two factors are K1 and J = K2 (the JAX
    ``FourStepFFT._peak_consts``)."""
    k1, j = factors[-2], factors[-1]
    return twiddle(k1, j), dft_matrix(j)


def caf3_tables(f0: int, f1: int, f2: int) -> dict[str, np.ndarray]:
    """Tables of the three-stage split n = f0*f1*f2 (t = n0*f1*f2 + n1*f2 +
    n2, k = k0 + f0*k1 + f0*f1*k2):

        w0 (f0, f0), w1 (f1, f1), w2 (f2, f2)   the stage DFT matrices
        a1[k0, n1] = exp(-2*pi*i*k0*n1/(f0*f1))  stage-1 twiddle, n1 digit
        a2[k0, n2] = exp(-2*pi*i*k0*n2/n)        stage-1 twiddle, n2 digit
        tw2[k1, n2] = exp(-2*pi*i*k1*n2/(f1*f2)) stage-2 twiddle

    so that X[k] = sum_n2 w2[n2,k2] tw2[k1,n2] sum_n1 w1[k1,n1] a1[k0,n1]
    a2[k0,n2] sum_n0 w0[k0,n0] x[n0, n1, n2] (``fused_caf3.py:38-43``)."""
    n = f0 * f1 * f2
    k0, k1 = np.arange(f0), np.arange(f1)
    return {"w0": dft_matrix(f0), "w1": dft_matrix(f1), "w2": dft_matrix(f2),
            "a1": _phase_exp(k0, np.arange(f1), f0 * f1),
            "a2": _phase_exp(k0, np.arange(f2), n),
            "tw2": _phase_exp(k1, np.arange(f2), f1 * f2)}


def true_bins(rowarg: torch.Tensor, factors) -> torch.Tensor:
    """True bin of each row winner. rowarg (..., R) holds the last digit
    k_{L-1} of each of the R = f0*...*f_{L-2} rows of a transform, row r
    holding the digits (k0, ..., k_{L-2}) in row-major order; the bin is
    k0 + f0*(k1 + f1*(... + f_{L-2}*k_{L-1}))."""
    rem = torch.arange(rowarg.shape[-1], device=rowarg.device)
    bins = rowarg.long()
    for f in reversed(factors[:-1]):
        bins = rem % f + f * bins
        rem = rem // f
    return bins


def peak_winner(rowmax: torch.Tensor, rowarg: torch.Tensor, factors):
    """(peak, true bin) per transform from the per-row winners (..., R) of
    the last-stage peak kernel (the JAX ``_peak_winner``, ``ops/fft.py:122``).
    Ties go to the lowest true bin, as torch.argmax on the natural-order
    spectrum does; the JAX version takes the first row in permuted order."""
    bins = true_bins(rowarg, factors)
    peak = rowmax.max(dim=-1).values
    cand = torch.where(rowmax == peak[..., None], bins,
                       torch.iinfo(torch.int64).max)
    return peak, cand.min(dim=-1).values
