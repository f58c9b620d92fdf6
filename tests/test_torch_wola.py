"""Parity of the PyTorch WOLA channelizer with the JAX package.

The same numpy inputs go through the JAX function (CPU) and the port (CPU
tensors, so the Hopper kernel's plain twin). Tolerance: both sides compute
in f32/complex64 with different summation orders (JAX: banded matmul fold +
DFT-matrix IDFT; port: column FIR fold + torch.fft), so max|d| / max|ref| <
1e-5, the bound the JAX package's own fused-kernel test uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from pydsproutines_tpu.ops.wola import Channeliser as JaxChanneliser
from pydsproutines_tpu.ops.wola import wola as jax_wola
from pydsproutines_tpu_torch.ops.hopper.wola_fused import wola_fused
from pydsproutines_tpu_torch.ops.wola import Channeliser, select_wola_path, wola

RTOL = 1e-5


def _cplx(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("dec,n,taps,rows,row_offset", [
    (64, 64, 512, 300, 0),        # N == Dec: the kernel's route
    (16, 16, 128, 200, 0),
    (32, 64, 512, 300, 0),        # N == 2*Dec: odd-row flip
    (4, 8, 32, 101, 3),           # flip parity keyed on a global offset
])
def test_wola_matches_jax(rng, dec, n, taps, rows, row_offset):
    h = sps.firwin(taps, 1.0 / dec).astype(np.float32)
    x = _cplx(rng, rows * dec + dec // 2)          # ragged tail is ignored
    ref = np.asarray(jax_wola(jnp.asarray(h), jnp.asarray(x), dec, n,
                              row_offset=row_offset))
    got = wola(torch.from_numpy(h), torch.from_numpy(x), dec, n,
               row_offset=row_offset).numpy()
    assert got.shape == ref.shape == (rows, n)
    assert _rel(got, ref) < RTOL


def test_wola_twin_matches_pallas_kernel_interpret(rng):
    """The kernel's plain twin against the TPU kernel itself, run in
    interpret mode at its real geometry (64 ch, 2048 taps, B = 32)."""
    from pydsproutines_tpu.ops.pallas.wola_fused import wola_fused as pallas

    nch, rows = 64, 300
    h = rng.standard_normal(2048).astype(np.float32)
    x = _cplx(rng, nch * rows)
    ref = np.asarray(pallas(jnp.asarray(h), jnp.asarray(x), nch, nch,
                            interpret=True))
    got = wola_fused(torch.from_numpy(h), torch.from_numpy(x), nch).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("dec,n", [(8, 8), (4, 8)])
def test_channeliser_streaming_matches_jax(rng, dec, n):
    """Block-wise channelise() equals the JAX Channeliser block by block and
    the port's own single call on the whole signal."""
    taps = 4 * n
    x = _cplx(rng, 96 * dec * 3)
    blocks = np.split(x, [96 * dec, 96 * dec * 2])
    jc = JaxChanneliser(num_taps=taps, num_channels=n, dec=dec)
    tc = Channeliser(num_taps=taps, num_channels=n, dec=dec, device="cpu")
    seq = []
    for blk in blocks:
        ref = np.asarray(jc.channelise(jnp.asarray(blk)))
        got = tc.channelise(torch.from_numpy(blk)).numpy()
        assert got.shape == ref.shape
        assert _rel(got, ref) < RTOL
        seq.append(got)
    whole = Channeliser(num_taps=taps, num_channels=n, dec=dec,
                        device="cpu").channelise(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(np.vstack(seq) - whole)) < 1e-5


def test_channeliser_freqs_match_jax():
    jc = JaxChanneliser(num_taps=32, num_channels=8, dec=8)
    tc = Channeliser(num_taps=32, num_channels=8, dec=8, device="cpu")
    np.testing.assert_allclose(tc.channel_freqs(8000.0).numpy(),
                               np.asarray(jc.channel_freqs(8000.0)))
    assert tc.channel_fs(8000.0) == jc.channel_fs(8000.0)


def test_wola_route_decision():
    assert select_wola_path(64, 64, "cuda")[0] == "fused-hopper"
    assert select_wola_path(64, 64, "cpu")[0] == "plain"
    assert select_wola_path(64, 32, "cuda")[0] == "plain"


def test_wola_rejects_bad_geometry():
    h = torch.ones(24)
    x = torch.zeros(64, dtype=torch.complex64)
    with pytest.raises(ValueError):
        wola(h, x, 8, 24)                    # N not Dec or 2*Dec
    with pytest.raises(ValueError):
        wola(h, x, 16, 16)                   # taps not a multiple of N


@pytest.mark.parametrize("dec,n,taps,rows", [
    (32, 64, 512, 300),           # N == 2*Dec: complex taps stay complex
    (4, 8, 32, 101),
    (64, 64, 512, 300),           # N == Dec: their real part, as JAX takes
    (16, 16, 128, 200),
])
def test_wola_complex_taps_match_jax(rng, dec, n, taps, rows):
    """Complex taps (a lowpass shifted by a quarter of a channel) through
    ``ops.wola.wola`` and the JAX ``wola`` on the CPU, within RTOL; no
    complex-to-real cast warning on the port's side."""
    import warnings

    h = (sps.firwin(taps, 1.0 / dec)
         * np.exp(0.5j * np.pi * np.arange(taps) / dec)).astype(np.complex64)
    x = _cplx(rng, rows * dec)
    ref = np.asarray(jax_wola(jnp.asarray(h), jnp.asarray(x), dec, n))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = wola(torch.from_numpy(h), torch.from_numpy(x), dec, n).numpy()
    assert got.shape == ref.shape == (rows, n)
    assert _rel(got, ref) < RTOL
    if n == dec:                  # the imaginary part is dropped
        real = wola(torch.from_numpy(h.real.copy()), torch.from_numpy(x),
                    dec, n).numpy()
        np.testing.assert_array_equal(got, real)
    else:                         # and kept: real taps give another answer
        real = wola(torch.from_numpy(h.real.copy()), torch.from_numpy(x),
                    dec, n).numpy()
        assert _rel(real, ref) > 1e-2
