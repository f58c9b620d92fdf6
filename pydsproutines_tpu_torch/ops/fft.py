"""Two-factor DFT split and the f32 tables of the Hopper CAF kernel.

The JAX package's ``FourStepFFT`` exists because XLA's TPU FFT was slow; it
is not ported. The plain twins use ``torch.fft``. What the CAF kernel needs
is the split n = n1*n2 and three tables, built here on the host from
float64 phases reduced mod n before the exponential (the pattern of
``pydsproutines_tpu/ops/pallas/fused_xcorr.FusedXcorrPlan``), stored
complex64:

    W1[k1, t1] = exp(-2*pi*i*k1*t1/n1)      (n1, n1)
    TW[k1, t2] = exp(-2*pi*i*k1*t2/n)       (n1, n2)
    W2[t2, k2] = exp(-2*pi*i*t2*k2/n2)      (n2, n2)

so that X[k1 + n1*k2] = sum_t2 W2[t2, k2] TW[k1, t2] sum_t1 W1[k1, t1]
x[t1*n2 + t2].
"""

from __future__ import annotations

import math

import numpy as np


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


def dft_matrix(n: int) -> np.ndarray:
    """(n, n) complex64 forward DFT matrix exp(-2*pi*i*j*k/n)."""
    k = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * np.mod(np.outer(k, k), n) / n).astype(
        np.complex64)


def twiddle(n1: int, n2: int) -> np.ndarray:
    """(n1, n2) complex64 four-step twiddle exp(-2*pi*i*k1*t2/(n1*n2))."""
    k1 = np.arange(n1, dtype=np.float64)
    t2 = np.arange(n2, dtype=np.float64)
    n = n1 * n2
    return np.exp(-2j * np.pi * np.mod(np.outer(k1, t2), n) / n).astype(
        np.complex64)
