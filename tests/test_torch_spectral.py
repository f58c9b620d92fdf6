"""Parity of the port's spectral transforms with the JAX package.

The same numpy inputs go through the JAX function (CPU, x64 on) and the
port (CPU tensors, ``device="cpu"``). Tolerances are those of
``tests/test_spectral.py`` against its own oracles: 1e-9 relative at
complex128, 1e-4 at complex64 (the CZT's f32 chirps), 1e-8 absolute for the
padded FFT and 1e-9 for the burst FFT. The CZT is run on both of its
paths: the tone bank (m*k <= 4,000,000) and Bluestein (m*k above it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import spectral as js
from pydsproutines_tpu_torch.ops import spectral as ts


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _np_czt(x, f1, f2, bw, fs):
    k = int((f2 - f1) / bw + 1)
    freqs = f1 + np.arange(k) * bw
    n = np.arange(x.shape[-1])
    return x @ np.exp(-2j * np.pi * np.outer(n, freqs) / fs)


# (m, f1, f2, bin width, fs, tone bank?): m*k either side of 4,000,000
@pytest.mark.parametrize("m,f1,f2,bw,fs,tones", [
    (400, -100.0, 100.0, 2.5, 1000.0, True),
    (4096, -64.0, 63.0, 1.0, 4096.0, True),          # 524,288 tone entries
    (20000, -1200.0, 1199.0, 1.0, 20000.0, False),   # 48,000,000: Bluestein
])
def test_czt_matches_jax_complex128(rng, m, f1, f2, bw, fs, tones):
    x = _cplx(rng, (2, m))
    jplan = js.CZT(m, f1, f2, bw, fs, dtype=jnp.complex128)
    tplan = ts.CZT(m, f1, f2, bw, fs, dtype=torch.complex128, device="cpu")
    assert (tplan.tones is not None) == tones == (jplan.tones is not None)
    assert tplan.k == jplan.k and tplan.nfft == jplan.nfft
    np.testing.assert_array_equal(tplan.freqs(), jplan.freqs())
    got = tplan(torch.from_numpy(x)).numpy()
    ref = np.asarray(jplan(jnp.asarray(x)))
    truth = _np_czt(x, f1, f2, bw, fs)
    scale = np.abs(truth).max()
    assert np.abs(got - ref).max() / scale < 1e-9
    assert np.abs(got - truth).max() / scale < 1e-9


# a plan known by its bin count (as a JAX plan's f1, bin_width, k are
# carried across): the same bins and constants as the plan built from f2
@pytest.mark.parametrize("m,f1,bw,k,fs", [
    (400, -100.0, 2.5, 81, 1000.0),          # tone bank
    (20000, -1200.0, 1.0, 2400, 20000.0),    # Bluestein
])
def test_czt_plan_from_its_bin_count(rng, m, f1, bw, k, fs):
    x = _cplx(rng, (2, m))
    by_k = ts.CZT(m, f1, None, bw, fs, dtype=torch.complex128, device="cpu",
                  k=k)
    by_f2 = ts.CZT(m, f1, f1 + (k - 1) * bw, bw, fs, dtype=torch.complex128,
                   device="cpu")
    assert by_k.k == by_f2.k == k and by_k.nfft == by_f2.nfft
    np.testing.assert_array_equal(by_k.freqs(), by_f2.freqs())
    got = by_k(torch.from_numpy(x)).numpy()
    truth = _np_czt(x, f1, f1 + (k - 1) * bw, bw, fs)
    assert np.abs(got - truth).max() / np.abs(truth).max() < 1e-9


@pytest.mark.parametrize("m,f2", [(1000, 500.0), (20000, 2500.0)])
def test_czt_complex64_matches_jax(rng, m, f2):
    x = _cplx(rng, m, np.complex64)
    fs = 10000.0 if m == 1000 else 20000.0
    got = ts.czt(torch.from_numpy(x), 0.0, f2, 5.0 if m == 1000 else 0.5, fs)
    ref = np.asarray(js.czt(jnp.asarray(x), 0.0, f2,
                            5.0 if m == 1000 else 0.5, fs))
    truth = _np_czt(x.astype(np.complex128), 0.0, f2,
                    5.0 if m == 1000 else 0.5, fs)
    assert got.dtype == torch.complex64
    scale = np.abs(truth).max()
    assert np.abs(got.numpy() - truth).max() / scale < 1e-4
    assert np.abs(got.numpy() - ref).max() / scale < 1e-4


def test_czt_plan_refuses_another_device(rng):
    plan = ts.CZT(16, -1.0, 1.0, 0.5, 8.0, device="cpu")
    with pytest.raises(ValueError, match="plan on"):
        plan(torch.zeros(16, dtype=torch.complex64, device="meta"))


def test_dft_matches_jax(rng):
    n = 64
    x = _cplx(rng, n)
    freqs = np.arange(n) / n * 3.0 + 0.013
    got = ts.dft(torch.from_numpy(x), torch.from_numpy(freqs), 3.0).numpy()
    ref = np.asarray(js.dft(jnp.asarray(x), jnp.asarray(freqs), 3.0))
    assert np.abs(got - ref).max() < 1e-9
    fft = ts.dft(torch.from_numpy(x), torch.arange(n) / n, 1.0).numpy()
    assert np.abs(fft - np.fft.fft(x)).max() < 1e-9


def test_tone_spectrum_matches_jax():
    freqs = np.linspace(123.456 - 5, 123.456 + 5, 21)
    freqs[10] = 123.456                       # the removable singularity
    got = ts.tone_spectrum(123.456, torch.from_numpy(freqs), 1000.0, 512,
                           phi=0.7, amplitude=2.0).numpy()
    ref = np.asarray(js.tone_spectrum(123.456, jnp.asarray(freqs), 1000.0,
                                      512, phi=0.7, amplitude=2.0))
    assert np.abs(got - ref).max() < 1e-9 * np.abs(ref).max()
    assert abs(got[10] - 2.0 * 512 * np.exp(0.7j)) < 1e-9


@pytest.mark.parametrize("reorder", [False, True])
def test_integer_multiple_fft_matches_jax(rng, reorder):
    n, mult = 100, 7
    x = _cplx(rng, n)
    got = ts.IntegerMultipleFFT(mult, n, dtype=torch.complex128,
                                device="cpu").fft(torch.from_numpy(x),
                                                  reorder=reorder).numpy()
    ref = np.asarray(js.IntegerMultipleFFT(mult, n, dtype=jnp.complex128)
                     .fft(jnp.asarray(x), reorder=reorder))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-8
    if reorder:
        assert np.abs(got - np.fft.fft(x, n=n * mult)).max() < 1e-8


def test_burst_fft_matches_jax(rng):
    x = _cplx(rng, 100)
    got = ts.burst_fft(torch.from_numpy(x), 32).numpy()
    ref = np.asarray(js.burst_fft(jnp.asarray(x), 32))
    assert np.abs(got - ref).max() < 1e-9


def test_chirp_phase_matches_jax():
    kk2 = np.arange(-50.0, 70.0) ** 2 / 2
    np.testing.assert_array_equal(ts._chirp_phase_exp(0.37, kk2),
                                  js._chirp_phase_exp(0.37, kk2))
