"""The WOLA kernel's schedule (TPU kernels #1/#1b, ``csrc/wola_fused.cu``)
emulated in torch by ``wola_staged``: the register fold's column runs and
tap chunks, then ``ops/fft.fft_staged`` over the kernel's own line plan and
tables, against the JAX ``wola`` and the JAX Pallas kernels in interpret
mode, and against the contract's definition in float64.

The same numpy inputs, made from a seed, go to both sides. Tolerance: both
compute in f32/complex64 with other summation orders and another DFT
(JAX: banded fold + DFT-matrix IDFT; here: column FIR + mixed-radix FFT over
f32 tables), so max|d| / max|ref| < 1e-5, the twins' bound
(``tests/test_torch_wola.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops.wola import wola as jax_wola
from pydsproutines_tpu_torch.ops.hopper.wola_fused import (MAX_KB, MAX_SMEM,
                                                           RUN, THREADS,
                                                           fold_sources,
                                                           wola_plan,
                                                           wola_staged)

RTOL = 1e-5


def _inputs(seed, n, nb, rows, tail=None):
    """Taps and a complex64 signal of ``rows`` rows plus ``tail`` samples
    (default n // 2: a ragged end that the channelizer ignores)."""
    tail = n // 2 if tail is None else tail
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(n * nb).astype(np.float32)
    x = (rng.standard_normal(rows * n + tail)
         + 1j * rng.standard_normal(rows * n + tail)).astype(np.complex64)
    return h, x


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("n", [1, 8, 12, 60, 64, 128, 256])
@pytest.mark.parametrize("nb", [1, 2, 8, 32])
def test_wola_staged_matches_jax(n, nb):
    """N with the radices 2/3/4/5/8 (12 = 4x3, 60 = 4x3x5) and N = 1, B from
    1 to 32; rows that leave the last chunk ragged (the chunk is 8 *
    max(1, 256 // N) rows) and a tail of samples past the last row."""
    rows = wola_plan(n, nb)["rc"] + 5 if n >= 64 else 101
    h, x = _inputs(n * 100 + nb, n, nb, rows)
    ref = np.asarray(jax_wola(jnp.asarray(h), jnp.asarray(x), n, n))
    got = wola_staged(torch.from_numpy(h), torch.from_numpy(x), n).numpy()
    assert got.shape == ref.shape == (rows, n)
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("n,nb,rows", [(7, 3, 40), (33, 5, 70), (64, 33, 90)])
def test_wola_staged_generic_radix_and_tap_chunks(n, nb, rows):
    """A generic prime radix (7, 3 x 11) and B past one chunk of MAX_KB taps
    (33 = 32 + 1, the second chunk mostly zero taps)."""
    h, x = _inputs(n + nb, n, nb, rows)
    ref = np.asarray(jax_wola(jnp.asarray(h), jnp.asarray(x), n, n))
    got = wola_staged(torch.from_numpy(h), torch.from_numpy(x), n).numpy()
    assert _rel(got, ref) < RTOL


def test_wola_staged_matches_definition_float64():
    """The contract written out: out[r, k] = sum_a e^{+2 pi i a k / N} sum_b
    x[rN - bN - a] h[bN + a], x zero before 0, in float64 by loops. Fails if
    the fold's index map (column 0 of the same row for a == 0, column N - a
    one row back for a >= 1) is broken."""
    n, nb, rows = 8, 3, 37
    h, x = _inputs(5, n, nb, rows, tail=0)
    ref = np.zeros((rows, n), np.complex128)
    a = np.arange(n)
    for r in range(rows):
        d = np.zeros(n, np.complex128)
        for b in range(nb):
            idx = r * n - b * n - a
            ok = idx >= 0
            d[ok] += x[idx[ok]] * h[b * n + a[ok]]
        ref[r] = np.exp(2j * np.pi * np.outer(np.arange(n), a) / n) @ d
    got = wola_staged(torch.from_numpy(h), torch.from_numpy(x), n).numpy()
    assert _rel(got, ref) < RTOL


def test_wola_fold_sources():
    col, shift = fold_sources(8)
    assert col.tolist() == [0, 7, 6, 5, 4, 3, 2, 1]
    assert shift.tolist() == [0, 1, 1, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("n,nb,rows", [(64, 32, 300), (128, 8, 200),
                                       (256, 8, 90)])
def test_wola_staged_matches_pallas_kernel_interpret(n, nb, rows):
    """The TPU kernels themselves in interpret mode: ``_kernel`` (N = 64,
    pair-row layout) and ``_kernel_direct`` (N = 128, 256)."""
    from pydsproutines_tpu.ops.pallas.wola_fused import wola_fused as pallas

    h, x = _inputs(n + rows, n, nb, rows, tail=0)
    ref = np.asarray(pallas(jnp.asarray(h), jnp.asarray(x), n, n,
                            interpret=True))
    got = wola_staged(torch.from_numpy(h), torch.from_numpy(x), n).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("n,nb,kb,chunks,rc,radices", [
    (64, 32, 32, 1, 32, (8, 8)), (128, 8, 8, 1, 16, (8, 8, 2)),
    (256, 8, 8, 1, 8, (8, 8, 4)), (1, 8, 8, 1, 2048, ()),
    (12, 3, 4, 1, 168, (4, 3)), (64, 33, 32, 2, 32, (8, 8)),
    (1000, 2, 2, 1, 8, (8, 5, 5, 5)),
])
def test_wola_plan(n, nb, kb, chunks, rc, radices):
    plan = wola_plan(n, nb)
    assert (plan["kb"], plan["tap_chunks"], plan["rc"], plan["radices"]) == (
        kb, chunks, rc, radices)
    assert plan["route"] == "fold-fft" and plan["kb"] <= MAX_KB
    assert plan["rc"] % RUN == 0 and n * plan["rc"] // RUN <= max(THREADS, n)
    # at least two blocks an SM by shared memory and threads at N <= 256
    if n <= 256:
        assert 2 * plan["smem"] <= MAX_SMEM and 2 * THREADS <= 2048


def test_wola_plan_refuses_what_does_not_fit():
    assert wola_plan(3600, 1)["smem"] <= MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        wola_plan(8192, 1)
    with pytest.raises(ValueError):
        wola_plan(64, 0)
