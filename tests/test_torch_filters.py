"""The port's ops/filters against the JAX package's, and the plain twins of
the upfirdn (#5) and median-filter (#6) kernels against the Pallas kernels
in interpret mode.

The same numpy inputs, made from a seed, go to both. Tolerances are the JAX
tests' own (tests/test_filters.py): 1e-9 at float64; the polyphase grid's
atol 1e-5 / rtol 1e-4; f32 kernels atol 2e-4*sqrt(T) / rtol 1e-4 against
float64 scipy (:181); the fused chain's atol 1e-3 / rtol 1e-4 and its flat
planes' 1e-6 of scale; medfilt bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import pydsproutines_tpu.ops.filters as JF
import pydsproutines_tpu_torch.ops.filters as TF
from pydsproutines_tpu.ops.pallas.medfilt import medfilt_pallas
from pydsproutines_tpu.ops.pallas.upfirdn import (_upfirdn_pallas_planes2,
                                                  upfirdn_geometry,
                                                  upfirdn_pallas_viable)
from pydsproutines_tpu.utils.fftlen import next_fast_len as j_next_fast_len
from pydsproutines_tpu_torch.ops.hopper import medfilt as hm
from pydsproutines_tpu_torch.ops.hopper.upfirdn import upfirdn_planes_plain
from pydsproutines_tpu_torch.utils.fftlen import next_fast_len


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cplx(rng, n, dtype=np.complex128):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


GRID = [(up, down, T, n) for up in (1, 2, 3, 5, 8) for down in (1, 2, 3, 5, 7)
        for T in (1, 4, 15, 101) for n in (1, 17, 256)]


@pytest.mark.parametrize("up,down,T,n", GRID)
def test_upfirdn_polyphase_grid_matches_jax_and_scipy(up, down, T, n):
    """The JAX grid (tests/test_filters.py:125): down > up, taps shorter
    than up, n = 1, coprime and non-coprime factor pairs."""
    rng = np.random.default_rng(up * 100000 + down * 1000 + T * 10 + n)
    x = rng.standard_normal(n)
    h = rng.standard_normal(T)
    got = TF.upfirdn(_t(h), _t(x), up, down).numpy()
    ref = sps.upfirdn(h, x, up, down)
    jax_ref = np.asarray(JF.upfirdn(jnp.asarray(h), jnp.asarray(x), up, down))
    assert got.shape == ref.shape == jax_ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, jax_ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("up,down", [(1, 1), (3, 2), (2, 3), (5, 4), (1, 7)])
def test_upfirdn_complex128_matches_jax(rng, up, down):
    taps = sps.firwin(48, 0.2)
    x = _cplx(rng, 301)
    got = TF.upfirdn(_t(taps), _t(x), up, down).numpy()
    ref = sps.upfirdn(taps, x, up, down)
    assert got.dtype == np.complex128
    assert TF.get_upfirdn_size(301, 48, up, down) == \
        JF.get_upfirdn_size(301, 48, up, down) == len(ref)
    assert np.max(np.abs(got - ref)) < 1e-9
    jax_ref = np.asarray(JF.upfirdn(jnp.asarray(taps), jnp.asarray(x), up,
                                    down))
    assert np.max(np.abs(got - jax_ref)) < 1e-9


def test_upfirdn_batched_rows(rng):
    taps = sps.firwin(16, 0.3)
    x = rng.standard_normal((3, 100)) + 1j * rng.standard_normal((3, 100))
    got = TF.upfirdn(_t(taps), _t(x), 2, 3).numpy()
    jax_ref = np.asarray(JF.upfirdn(jnp.asarray(taps), jnp.asarray(x), 2, 3))
    assert got.shape == jax_ref.shape
    for i in range(3):
        assert np.max(np.abs(got[i] - sps.upfirdn(taps, x[i], 2, 3))) < 1e-9
    assert np.max(np.abs(got - jax_ref)) < 1e-9


def test_upfirdn_complex_taps_and_signal(rng):
    x = _cplx(rng, 200, np.complex64)
    h = rng.standard_normal(31).astype(np.float32)
    hc = _cplx(rng, 31, np.complex64)
    for taps, sig, up, down in ((h, x, 4, 3), (hc, x, 3, 5),
                                (hc, x.real.copy(), 3, 5)):
        got = TF.upfirdn(_t(taps), _t(sig), up, down).numpy()
        jax_ref = np.asarray(JF.upfirdn(jnp.asarray(taps), jnp.asarray(sig),
                                        up, down))
        assert got.dtype == jax_ref.dtype
        np.testing.assert_allclose(got, sps.upfirdn(taps, sig, up, down),
                                   atol=1e-4)
        np.testing.assert_allclose(got, jax_ref, atol=1e-4)


def test_fir_upfirdn_matches_jax_and_full_conv(rng):
    n, t1, t2, up, down = 4096, 64, 33, 5, 4
    x = _cplx(rng, n, np.complex64)
    h1 = rng.standard_normal(t1).astype(np.float32)
    h2 = rng.standard_normal(t2).astype(np.float32)
    got = TF.fir_upfirdn(_t(h1), _t(h2), _t(x), up, down).numpy()
    jax_ref = np.asarray(JF.fir_upfirdn(jnp.asarray(h1), jnp.asarray(h2),
                                        jnp.asarray(x), up, down))
    assert got.shape == jax_ref.shape and got.dtype == jax_ref.dtype
    np.testing.assert_allclose(got, jax_ref, atol=1e-3, rtol=1e-4)
    y64 = np.convolve(h1.astype(np.float64), x.astype(np.complex128))
    z64 = sps.upfirdn(h2.astype(np.float64), y64, up, down)
    np.testing.assert_allclose(got, z64[:len(got)], atol=1e-3, rtol=1e-4)
    # complex taps compose the two ops, as in the JAX package
    hc = _cplx(rng, 9, np.complex64)
    got_c = TF.fir_upfirdn(_t(hc), _t(h2), _t(x[:512]), 3, 2).numpy()
    ref_c = np.asarray(JF.fir_upfirdn(jnp.asarray(hc), jnp.asarray(h2),
                                      jnp.asarray(x[:512]), 3, 2))
    np.testing.assert_allclose(got_c, ref_c, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("up,down", [(5, 4), (3, 7), (1, 1)])
def test_fir_upfirdn_planes_flat_matches_jax(rng, up, down):
    n = 4096
    x = _cplx(rng, n, np.complex64)
    h1 = rng.standard_normal(32).astype(np.float32)
    h2 = rng.standard_normal(19).astype(np.float32)
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    o_re, o_im = TF.fir_upfirdn_planes_flat(h1, h2, _t(re), _t(im), up, down)
    j_re, j_im = JF.fir_upfirdn_planes_flat(
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(re), jnp.asarray(im),
        up, down)
    got = o_re.numpy() + 1j * o_im.numpy()
    ref = np.asarray(j_re) + 1j * np.asarray(j_im)
    assert o_re.dtype == torch.float32 and got.shape == ref.shape
    scale = max(1.0, np.abs(ref).max())
    assert np.max(np.abs(got - ref)) / scale < 1e-6
    # the host tap combination is float64 and cached per tap tuple; each
    # caller gets its own copy, so writing to one leaves the cache intact
    hits = TF._combine.cache_info().hits
    a = TF.combined_taps(h1, h2, up)
    b = TF.combined_taps(h1, h2, up)
    assert a.dtype == np.float64 and TF._combine.cache_info().hits > hits
    assert b is not a and np.array_equal(a, b)
    b[:] = 0
    hu = np.zeros(32 * up - (up - 1))
    hu[::up] = h1
    np.testing.assert_array_equal(TF.combined_taps(h1, h2, up),
                                  np.convolve(hu, h2.astype(np.float64)))


def test_upfirdn_twin_matches_pallas_kernel_pad_free(rng):
    """Kernel #5's contract at the smallest viable geometry with the pad-free
    condition (ops/pallas/upfirdn.py:384) true: n % (128*S) == 0, >= 2
    steps, enough body rows."""
    up, down, T = 1, 4, 257
    _, S, cols, R = upfirdn_geometry(up, down)
    n = R * 264
    n_out = JF.get_upfirdn_size(n, T, up, down)
    nsteps = -(-(-(-n_out // cols)) // 128)
    assert upfirdn_pallas_viable(n_out, T, up, down)
    assert n % R == 0 and nsteps >= 2 and n // R >= (nsteps - 1) * 128 + 8
    _hold_against_pallas(rng, n, T, up, down, n_out)


def test_upfirdn_twin_matches_pallas_kernel_padded(rng):
    """The same contract with the pad-free condition false (n % R != 0):
    the padded ``_kernel``."""
    up, down, T = 1, 4, 257
    R = upfirdn_geometry(up, down)[3]
    n = R * 264 + 1
    n_out = JF.get_upfirdn_size(n, T, up, down)
    assert upfirdn_pallas_viable(n_out, T, up, down) and n % R != 0
    _hold_against_pallas(rng, n, T, up, down, n_out)


def _hold_against_pallas(rng, n, T, up, down, n_out):
    x = _cplx(rng, n, np.complex64)
    h = rng.standard_normal(T).astype(np.float32)
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    pal = np.asarray(_upfirdn_pallas_planes2(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(h), up, down, n_out,
        interpret=True))
    got = upfirdn_planes_plain((_t(re), _t(im)), _t(h), up, down, n_out)
    got = np.stack([g.numpy() for g in got])
    assert got.shape == pal.shape == (2, n_out)
    ref = sps.upfirdn(h.astype(np.float64), x.astype(np.complex128), up,
                      down)[:n_out]
    for a in (got, pal):
        np.testing.assert_allclose(a[0] + 1j * a[1], ref,
                                   atol=2e-4 * np.sqrt(T), rtol=1e-4)
    np.testing.assert_allclose(got, pal, atol=2e-4 * np.sqrt(T), rtol=1e-4)


def test_lfilter_fir_direct_and_fft_match_jax(rng):
    taps = sps.firwin(31, 0.25)
    x = _cplx(rng, 500)
    for method, tol in (("direct", 1e-9), ("fft", 1e-7)):
        got = TF.lfilter_fir(_t(taps), _t(x), method=method).numpy()
        ref = sps.lfilter(taps, 1.0, x)
        jax_ref = np.asarray(JF.lfilter_fir(jnp.asarray(taps), jnp.asarray(x),
                                            method=method))
        assert got.dtype == jax_ref.dtype
        assert np.max(np.abs(got - ref)) < tol, method
        assert np.max(np.abs(got - jax_ref)) < tol, method
    taps = sps.firwin(129, 0.1)
    x = _cplx(rng, 2000)
    got = TF.lfilter_fir(_t(taps), _t(x), method="fft").numpy()
    assert np.max(np.abs(got - sps.lfilter(taps, 1.0, x))) < 1e-7
    xr = rng.standard_normal(300)
    got = TF.lfilter_fir(_t(taps), _t(xr), method="fft").numpy()
    assert got.dtype == np.float64
    assert np.max(np.abs(got - sps.lfilter(taps, 1.0, xr))) < 1e-7


def test_stream_filter_block_continuity(rng):
    taps = sps.firwin(64, 0.2)
    x = _cplx(rng, 1024)
    sf = TF.StreamFilter(_t(taps), dtype=torch.complex128, device="cpu")
    ours = np.concatenate([sf.lfilter(_t(x[i: i + 256])).numpy()
                           for i in range(0, 1024, 256)])
    assert np.max(np.abs(ours - sps.lfilter(taps, 1.0, x))) < 1e-9


def test_stream_filter_continues_a_jax_stream(rng):
    """A stream started in JAX continues in the port with the same output:
    from_numpy_params carries the taps and the delay line across."""
    taps = sps.firwin(64, 0.2)
    x = _cplx(rng, 1024)
    jsf = JF.StreamFilter(jnp.asarray(taps), dtype=jnp.complex128)
    jax_out = [np.asarray(jsf.lfilter(jnp.asarray(x[i: i + 256])))
               for i in range(0, 512, 256)]
    tsf = TF.StreamFilter.from_numpy_params(
        {"taps": np.asarray(jsf.taps), "delay": np.asarray(jsf.delay)},
        device="cpu")
    assert tsf.dtype == torch.complex128
    port_out = [tsf.lfilter(_t(x[i: i + 256])).numpy()
                for i in range(512, 1024, 256)]
    jax_rest = [np.asarray(jsf.lfilter(jnp.asarray(x[i: i + 256])))
                for i in range(512, 1024, 256)]
    ours = np.concatenate(jax_out + port_out)
    assert np.max(np.abs(ours - sps.lfilter(taps, 1.0, x))) < 1e-9
    assert np.max(np.abs(np.concatenate(port_out)
                         - np.concatenate(jax_rest))) < 1e-9
    np.testing.assert_array_equal(tsf.delay.numpy(), np.asarray(jsf.delay))


def test_stream_upfirdn_continuity(rng):
    taps = sps.firwin(32, 0.25)
    up, down, mem = 2, 4, 64
    x = _cplx(rng, 1024)
    su = TF.StreamUpfirdn(_t(taps), up, down, memory=mem,
                          dtype=torch.complex128, device="cpu")
    blocks = [su.resample(_t(x[i: i + 256])).numpy()
              for i in range(0, 1024, 256)]
    full = sps.upfirdn(taps, np.concatenate([np.zeros(mem), x[:256]]), up,
                       down)
    skip = mem * up // down
    assert np.allclose(blocks[0], full[skip: skip + 256 * up // down])
    full2 = sps.upfirdn(taps, np.concatenate([x[256 - mem: 256], x[256:512]]),
                        up, down)
    assert np.allclose(blocks[1], full2[skip: skip + 256 * up // down])
    jsu = JF.StreamUpfirdn(jnp.asarray(taps), up, down, memory=mem,
                           dtype=jnp.complex128)
    jblocks = [np.asarray(jsu.resample(jnp.asarray(x[i: i + 256])))
               for i in range(0, 1024, 256)]
    assert np.max(np.abs(np.concatenate(blocks)
                         - np.concatenate(jblocks))) < 1e-9


def test_stream_upfirdn_continues_a_jax_stream(rng):
    taps = sps.firwin(32, 0.25)
    up, down, mem = 3, 2, 40
    x = _cplx(rng, 900)
    jsu = JF.StreamUpfirdn(jnp.asarray(taps), up, down, memory=mem,
                           dtype=jnp.complex128)
    for i in range(0, 300, 150):
        jsu.resample(jnp.asarray(x[i: i + 150]))
    tsu = TF.StreamUpfirdn.from_numpy_params(
        {"taps": np.asarray(jsu.taps), "up": up, "down": down, "memory": mem,
         "delay": np.asarray(jsu.delay)}, device="cpu")
    for i in range(300, 900, 150):
        a = tsu.resample(_t(x[i: i + 150])).numpy()
        b = np.asarray(jsu.resample(jnp.asarray(x[i: i + 150])))
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 1e-9


def test_moving_average_matches_jax_and_lfilter(rng):
    L = 8
    x = rng.standard_normal(100).astype(np.float32)
    got = TF.moving_average(_t(x), L).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - sps.lfilter(np.ones(L) / L, 1.0, x))) < 1e-5
    jax_ref = np.asarray(JF.moving_average(jnp.asarray(x), L))
    assert np.max(np.abs(got - jax_ref)) < 1e-5
    x2 = rng.standard_normal((4, 64)).astype(np.float32)
    got2 = TF.multi_moving_average(_t(x2), L, sum_instead=True).numpy()
    jax2 = np.asarray(JF.multi_moving_average(jnp.asarray(x2), L,
                                              sum_instead=True))
    for i in range(4):
        ref2 = sps.lfilter(np.ones(L), 1.0, x2[i])
        assert np.max(np.abs(got2[i] - ref2)) < 1e-5
    assert np.max(np.abs(got2 - jax2)) < 1e-5


def test_complex_moving_sum_matches_jax(rng):
    L = 5
    x = _cplx(rng, 50, np.complex64)
    got = TF.complex_moving_sum(_t(x), L).numpy()
    ref = np.array([np.abs(np.sum(x[i: i + L])) ** 2
                    for i in range(50 - L + 1)])
    assert got.shape == (46,) and got.dtype == np.float32
    assert np.max(np.abs(got - ref)) < 1e-3
    jax_ref = np.asarray(JF.complex_moving_sum(jnp.asarray(x), L))
    assert np.max(np.abs(got - jax_ref)) < 1e-3
    got_avg = TF.complex_moving_sum(_t(x), L, sum_instead=False).numpy()
    jax_avg = np.asarray(JF.complex_moving_sum(jnp.asarray(x), L,
                                               sum_instead=False))
    assert np.max(np.abs(got_avg - jax_avg)) < 1e-3


@pytest.mark.parametrize("k", [3, 5, 9])
def test_medfilt_matches_jax_and_scipy(rng, k):
    x = rng.standard_normal(200)
    got = TF.medfilt(_t(x), k).numpy()
    np.testing.assert_array_equal(got, sps.medfilt(x, k))
    np.testing.assert_array_equal(got, np.asarray(JF.medfilt(jnp.asarray(x),
                                                             k)))
    x32 = x.astype(np.float32)
    got32 = TF.medfilt(_t(x32), k).numpy()
    assert got32.dtype == np.float32
    np.testing.assert_array_equal(got32, sps.medfilt(x32, k))


def test_medfilt_chunked_path_matches_one_shot(rng, monkeypatch):
    """Force the twin's chunked path (long-capture memory bound) and pin it
    to scipy and to the JAX package's chunked path."""
    x = rng.standard_normal(40_000).astype(np.float32)
    one_shot = TF.medfilt(_t(x), 11).numpy()
    monkeypatch.setattr(hm, "_MEDFILT_ELEMS", 1 << 16)
    monkeypatch.setattr(JF, "_MEDFILT_ELEMS", 1 << 16)
    got = TF.medfilt(_t(x), 11).numpy()
    np.testing.assert_array_equal(got, sps.medfilt(x, 11))
    np.testing.assert_array_equal(got, one_shot)
    np.testing.assert_array_equal(
        got, np.asarray(JF.medfilt.__wrapped__(jnp.asarray(x), 11)))


@pytest.mark.parametrize("n,k", [(700, 31), (5000, 129)])
def test_medfilt_twin_matches_pallas_kernel(rng, n, k):
    """Kernel #6's contract: the twin bit-matches the radix-select Pallas
    kernel (interpret mode) and scipy."""
    x = rng.standard_normal(n).astype(np.float32)
    pal = np.asarray(medfilt_pallas(jnp.asarray(x), k, interpret=True))
    got = hm.medfilt_plain(_t(x), k).numpy()
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, sps.medfilt(x, k))


def test_medfilt_rejects_even_and_keeps_integers(rng):
    with pytest.raises(ValueError, match="odd"):
        TF.medfilt(torch.zeros(10), 4)
    xi = rng.integers(-50, 50, 300)
    got = TF.medfilt(_t(xi), 7).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(JF.medfilt(jnp.asarray(xi),
                                                             7)))


def test_resample_factor_wizard_and_fast_len():
    assert TF.resample_factor_wizard(48000, 44100) == (147, 160)
    assert TF.resample_factor_wizard(100, 200) == (2, 1)
    for n in (1, 2, 97, 1000, 4099, 10007):
        assert next_fast_len(n) == j_next_fast_len(n)
