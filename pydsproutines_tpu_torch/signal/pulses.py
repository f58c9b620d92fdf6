"""Pulse shapes for CPFSK (reference filterCreationRoutines.py:
makeSRC4 :13, makeSRC4_clipped :32, makeScaledSRC4 :53).

SRC4 is a square-root-raised-cosine-like pulse over 4 symbol periods. These run
at plan time on the host (numpy) — they produce small static tap arrays.

A copy of the JAX package's ``pydsproutines_tpu/signal/pulses.py``, which is
numpy only: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np


def make_src4(t: np.ndarray, tb: float) -> np.ndarray:
    """SRC4 pulse g(t) = sinc(X)/(1-X^2), X = 2t/Tb - 4, with the removable
    singularity at |X| = 1 filled with 0.5."""
    t = np.asarray(t, dtype=np.float64)
    x = 2.0 * t / tb - 4.0
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.sinc(x) / (1.0 - x * x)
    g = np.where(np.isfinite(g), g, 0.5)
    return g


def make_src4_clipped(t: np.ndarray, tb: float, k: float = 1.0) -> np.ndarray:
    """SRC4 clipped to the middle 2 symbols (X = 2t/Tb - 2), zero outside
    [0, 2*Tb]."""
    t = np.asarray(t, dtype=np.float64)
    x = 2.0 * t / tb - 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        g = k * np.sinc(x) / (1.0 - x * x)
    g = np.where(np.isfinite(g), g, k * 0.5)
    g = np.where((t < 0) | (t > 2 * tb), 0.0, g)
    return g


def make_scaled_src4(up: int, a: float = 0.5) -> np.ndarray:
    """SRC4 at ``up`` samples/symbol, scaled so sum(g) ~= a (default 0.5) for
    use as a CPFSK phase pulse at a normalized sampling rate."""
    from scipy import integrate

    t = np.arange(4 * up) / up
    qa, _ = integrate.quad(make_src4, 0, 4, args=(1.0,))
    return make_src4(t, 1.0) / (qa / a) / up
