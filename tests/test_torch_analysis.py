"""The port's analysis operators and ``utils`` additions against the JAX
package, on the same numpy inputs made from a seed.

Tolerances, with their reasons:
- MUSIC / CAPON / ESPRIT host estimators, ``music_xcorr``, ``estimate_baud``,
  ``compare_values``, the fftlen helpers, ``_chainify``: copies of numpy
  code, so equal (``assert_array_equal`` or ``==``).
- ``cancel_signal_at_idx``, ``multichannel_minmax_scale``, the masked rows,
  ``matrix_profile`` at complex128: the same arithmetic in float64, summed
  in another order: 1e-12 relative (the JAX matrix-profile test holds JAX to
  numpy at atol 1e-9); at complex64 rtol 1e-6 (tests/test_analysis_ops.py's
  masked and min-max bounds).
- ``cm_peak_scan`` / ``PSKOrderDetector``: peak indices equal; peaks at
  complex64 within rtol 1e-5 (f32 FFTs of 4096 points in another order).
- ``music_xcorr_device`` vs the JAX device path and vs the port's own host
  SVD oracle: the inverse grids within rtol 1e-3, atol 1e-6 * max (the JAX
  eig test, tests/test_analysis_ops.py:268-306), peak location equal; vs
  the host ``music_xcorr``: rtol 2e-2, atol 1e-3 * max (the JAX
  device-vs-host test).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import pydsproutines_tpu.ops.cancellation as jcan
import pydsproutines_tpu.ops.cyclostationary as jcyc
import pydsproutines_tpu.ops.masked as jmask
import pydsproutines_tpu.ops.matrixprofile as jmp
import pydsproutines_tpu.ops.minmax as jmm
import pydsproutines_tpu.ops.music as jmusic
import pydsproutines_tpu.utils as jutils
from pydsproutines_tpu_torch import utils
from pydsproutines_tpu_torch.ops import cancellation, cyclostationary, \
    masked, matrixprofile, minmax, music
from pydsproutines_tpu_torch.utils.device import place

timing = sys.modules["pydsproutines_tpu_torch.utils.timing"]


def _cplx(rng, *shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _psk(rng, n, m):
    return np.exp(2j * np.pi * rng.integers(0, m, n) / m)


# -- utils --------------------------------------------------------------------

def test_utils_exports_every_jax_name():
    assert set(jutils.__all__) <= set(utils.__all__)
    assert utils.COMPLEX_DTYPE == torch.complex64


@pytest.mark.parametrize("n", [1, 2, 11, 97, 100, 360, 1023, 1024, 1_000_003])
def test_fftlen_helpers_equal_jax(n):
    assert utils.prime_factors(n) == jutils.prime_factors(n)
    assert utils.next_fast_len(n) == jutils.next_fast_len(n)
    assert utils.prev_fast_len(n) == jutils.prev_fast_len(n)


def test_compare_values_equals_jax(rng):
    a, b = rng.standard_normal(64), rng.standard_normal(64)
    b[3] = 0.0
    assert utils.compare_values(a, b) == jutils.compare_values(a, b)
    assert utils.compare_values(torch.from_numpy(a),
                                torch.from_numpy(b)) == \
        jutils.compare_values(a, b)
    assert utils.compare_values([1.0, 2.0], [1.0, 2.5]) == (0.5, 0.2)


class _FakeEvent:
    """A CUDA event on a fake clock: record() reads the next time in ms."""
    clock = iter(())

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = next(_FakeEvent.clock)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_timer_returns_seconds_and_reports(monkeypatch, capsys):
    """evt/end return seconds read from the CUDA events (which count ms),
    as the JAX Timer does; rpt prints each lap and the total."""
    monkeypatch.setattr(timing.torch.cuda, "Event", _FakeEvent)
    _FakeEvent.clock = iter([0.0, 250.0, 1250.0, 1500.0])
    t = timing.Timer().start()
    assert t.evt("a") == pytest.approx(0.25)
    assert t.evt("b", block_on=object()) == pytest.approx(1.0)
    assert t.end(block_on=None) == pytest.approx(1.5)
    t.rpt()
    assert capsys.readouterr().out.splitlines() == [
        "a: 0.250000s", "b: 1.000000s", "Total: 1.250000s"]


def test_median_ms_stays_in_milliseconds(monkeypatch):
    monkeypatch.setattr(timing.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(timing.torch.cuda, "synchronize", lambda: None)
    _FakeEvent.clock = iter([0.0, 3.0, 10.0, 14.0, 20.0, 22.0])
    assert timing.median_ms(lambda: None, reps=3, warmup=0) == \
        pytest.approx(3.0)


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "tr")):
        with utils.annotate("analysis-span"):
            torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "analysis-span" in text


# -- cancellation ---------------------------------------------------------------

@pytest.mark.parametrize("idx", [50, 0, 200, 250, 10_000])
def test_cancel_signal_at_idx_matches_jax(rng, idx):
    """Equal to JAX at every start, a late one clamped to len(rx) - len(sig)
    as ``dynamic_slice`` clamps it; rx itself is left as it was."""
    sig = _psk(rng, 100, 4)
    rx = 0.1 * _cplx(rng, 300)
    rx[50:150] += 2.0 * np.exp(0.7j) * sig
    rx_t = torch.from_numpy(rx.copy())
    got, amp = cancellation.cancel_signal_at_idx(sig, rx_t, idx)
    ref, ref_amp = jcan.cancel_signal_at_idx(jnp.asarray(sig),
                                             jnp.asarray(rx), idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(complex(amp), complex(ref_amp), rtol=1e-12)
    assert torch.equal(rx_t, torch.from_numpy(rx))
    if idx == 50:
        assert abs(complex(amp) - 2.0 * np.exp(0.7j)) < 0.05
        assert (np.linalg.norm(got.numpy()[50:150])
                < 0.2 * np.linalg.norm(rx[50:150]))


# -- masked rows and min-max scaling -------------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_masked_rows_match_jax(rng, dtype):
    x, y, y0, y1 = (_cplx(rng, 12, 16, dtype=dtype) for _ in range(4))
    mask = np.array([1, 0, 2, 1, 1, 0, 0, 1, 2, 0, 1, 1], np.int32)
    tol = dict(rtol=1e-6 if dtype == np.complex64 else 1e-12)
    t = [torch.from_numpy(a) for a in (mask, x, y, y0, y1)]
    for value in (1, 2):
        np.testing.assert_allclose(
            masked.multiply_only_masked_rows(t[0], t[1], t[2], value).numpy(),
            np.asarray(jmask.multiply_only_masked_rows(mask, x, y, value)),
            **tol)
    np.testing.assert_allclose(
        masked.multiply_rows_based_on_mask(t[0], t[1], t[3], t[4]).numpy(),
        np.asarray(jmask.multiply_rows_based_on_mask(mask, x, y0, y1)), **tol)


@pytest.mark.parametrize("capacity", [None, 3, 6, 8])
def test_gathered_rows_keep_row_order_among_ties(rng, capacity):
    """Every selected row ties in the sort key (and so does every other
    row): a stable argsort keeps the selected rows in row order, as JAX's
    does; the count is exact int32 and rows past it are 0."""
    n = 64
    x = _cplx(rng, n, 8, dtype=np.complex64)
    y = _cplx(rng, n, 8, dtype=np.complex64)
    mask = np.zeros(n, np.int32)
    mask[[3, 5, 6, 17, 40, 41]] = 1
    mask[[7, 50]] = 2
    rows, count = masked.multiply_masked_rows_gathered(
        torch.from_numpy(mask), torch.from_numpy(x), torch.from_numpy(y),
        capacity)
    jrows, jcount = jmask.multiply_masked_rows_gathered(
        jnp.asarray(mask), jnp.asarray(x), jnp.asarray(y), capacity=capacity)
    assert count.dtype == torch.int32 and int(count) == int(jcount) == 6
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6)
    sel = [3, 5, 6, 17, 40, 41][:capacity]
    np.testing.assert_allclose(rows.numpy()[:len(sel)], x[sel] * y[sel],
                               rtol=1e-6)
    assert not rows.numpy()[len(sel):].any()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("preserve_phase", [False, True])
def test_minmax_scale_matches_jax(rng, dtype, preserve_phase):
    """Both modes, with a constant-amplitude channel (zero span: divided by
    1) and a zero sample (phase 0)."""
    ch = _cplx(rng, 5, 100, dtype=dtype)
    ch[2] = 0.5 * 1j ** rng.integers(0, 4, 100)      # |x| exactly 0.5
    ch[3, 17] = 0
    got = minmax.multichannel_minmax_scale(torch.from_numpy(ch),
                                           preserve_phase)
    ref = np.asarray(jmm.multichannel_minmax_scale(jnp.asarray(ch),
                                                   preserve_phase))
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert got.numpy()[3, 17] == 0


# -- cyclostationary -----------------------------------------------------------

@pytest.fixture(scope="module")
def psk_rows():
    rng = np.random.default_rng(11)
    rows = [_psk(rng, 4096, m) for m in (2, 4, 8)]
    noise = 0.05 * _cplx(rng, 3, 4096)
    return (np.stack(rows) + noise).astype(np.complex64)


def test_cm_peak_scan_matches_jax(psk_rows):
    mi, pk = cyclostationary.cm_peak_scan(torch.from_numpy(psk_rows), 3)
    jmi, jpk = jcyc.cm_peak_scan(jnp.asarray(psk_rows), 3)
    assert mi.dtype == torch.int64
    np.testing.assert_array_equal(mi.numpy(), np.asarray(jmi))
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=1e-5)


@pytest.mark.parametrize("max_m,rows,want", [(4, [0, 1], [2, 4]),
                                             (8, [1, 2], [4, 8]),
                                             (8, [0], [4])])
def test_psk_order_detector_matches_jax(psk_rows, max_m, rows, want):
    """The planted orders, with the reference's overwrite quirk (pure BPSK
    under max_m = 8 reads as 4), equal to JAX's."""
    x = psk_rows[rows]
    det = cyclostationary.PSKOrderDetector(max_m)
    jdet = jcyc.PSKOrderDetector(max_m)
    order = det.estimate_order(torch.from_numpy(x))
    np.testing.assert_array_equal(order, jdet.estimate_order(jnp.asarray(x)))
    np.testing.assert_array_equal(order, want)
    assert order.dtype == np.uint8
    np.testing.assert_allclose(det.ratios, jdet.ratios, rtol=1e-4)
    with pytest.raises(ValueError):
        cyclostationary.PSKOrderDetector(2)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_estimate_offset_via_cm_matches_jax(rng, dtype):
    n, f_true = 8192, 0.012
    x = (_psk(rng, n, 4) * np.exp(2j * np.pi * f_true * np.arange(n))
         + 0.05 * _cplx(rng, n)).astype(dtype)
    got = cyclostationary.estimate_offset_via_cm(torch.from_numpy(x), 1.0, 4)
    ref = jcyc.estimate_offset_via_cm(jnp.asarray(x), 1.0, 4)
    assert float(got) == float(ref)
    assert abs(float(got) - f_true) < 1e-3


def test_estimate_offset_via_cm_flat_argmax_on_rows(rng):
    """A 2-D input: the argmax runs over every element (jnp.argmax with no
    axis) and indexes the frequency axis clamped, as the JAX gather does."""
    n = 256
    x = _cplx(rng, 3, n, dtype=np.complex64)
    x[2] += 4 * np.exp(2j * np.pi * 0.1 * np.arange(n))
    got = cyclostationary.estimate_offset_via_cm(torch.from_numpy(x), 1.0, 2)
    ref = jcyc.estimate_offset_via_cm(jnp.asarray(x), 1.0, 2)
    assert float(got) == float(ref)


def test_integer_pow_matches_repeated_products(rng):
    x = torch.from_numpy(_cplx(rng, 64))
    for order in (1, 2, 3, 4, 5, 8):
        want = x.clone()
        for _ in range(order - 1):
            want = want * x
        torch.testing.assert_close(cyclostationary._integer_pow(x, order),
                                   want, rtol=1e-13, atol=0)


def test_estimate_baud_equals_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 512)
    up = 8
    pulse = np.sin(np.pi * np.arange(up) / up)
    x = np.zeros(512 * up)
    x[::up] = bits * 2.0 - 1.0
    x = np.convolve(x, pulse)[: 512 * up].astype(complex)
    got = cyclostationary.estimate_baud(torch.from_numpy(x), 1.0)
    ref = jcyc.estimate_baud(x, 1.0)
    assert got[:3] == ref[:3]
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])
    assert abs(got[0] - 1.0 / up) * up < 0.05


# -- matrix profile --------------------------------------------------------------

def _np_matrix_profile(x, window, num_diags):
    """tests/test_analysis_ops.py's numpy reference, padded as the port's."""
    power = np.abs(x) ** 2
    norms = np.convolve(power, np.ones(window), mode="valid")
    out = np.zeros((num_diags, norms.size))
    for d in range(1, num_diags + 1):
        kdiag = np.convolve(x[:-d] * x[d:].conj(), np.ones(window), "valid")
        out[d - 1, :kdiag.size] = np.abs(kdiag) ** 2 / norms[:-d] / norms[d:]
    return out


@pytest.mark.parametrize("n,window,num_diags", [
    (128, 8, 20),             # the JAX test's case
    (128, 8, 120),            # every diagonal: two batches, late diagonals
    (200, 16, 150),
])
def test_matrix_profile_matches_jax(rng, n, window, num_diags):
    """The padded matrix equal to JAX's and to numpy at complex128; entries
    past each diagonal's valid length exactly 0."""
    x = _cplx(rng, n)
    got = matrixprofile.matrix_profile(torch.from_numpy(x), window,
                                       num_diags).numpy()
    ref = np.asarray(jmp.matrix_profile(jnp.asarray(x), window, num_diags))
    assert got.shape == ref.shape == (num_diags, n - window + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, _np_matrix_profile(x, window, num_diags),
                               rtol=0, atol=1e-9)
    nout = n - window + 1
    for d in range(1, num_diags + 1):
        assert not got[d - 1, nout - d:].any()


def test_matrix_profile_complex64_matches_jax(rng):
    x = _cplx(rng, 300, dtype=np.complex64)
    got = matrixprofile.matrix_profile(torch.from_numpy(x), 32, 100).numpy()
    ref = np.asarray(jmp.matrix_profile(jnp.asarray(x), 32, 100))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_matrix_profile_chains_match_jax():
    """A repeated motif: the chains equal JAX's, the repeat at diagonal 100,
    offset 10 among them (tests/test_analysis_ops.py's scene)."""
    rng = np.random.default_rng(1)
    s = _psk(np.random.default_rng(7), 32, 4)
    x = 0.05 * _cplx(rng, 256)
    x[10:42] += s
    x[110:142] += s
    kw = dict(window_length=32, output_chains=True, min_threshold=0.5)
    got = matrixprofile.MatrixProfile(**kw).compute(torch.from_numpy(x))
    ref = jmp.MatrixProfile(**kw).compute(jnp.asarray(x))
    assert got == ref
    assert any(d == 100 and start <= 10 < end for d, start, end in got)
    kw["min_chain_length"] = 3
    assert (matrixprofile.MatrixProfile(**kw).compute(torch.from_numpy(x))
            == jmp.MatrixProfile(**kw).compute(jnp.asarray(x)))
    with pytest.raises(ValueError):
        matrixprofile.MatrixProfile(8, output_chains=True)


def test_chainify_equals_jax():
    idx = np.array([1, 2, 3, 7, 8, 10, 11, 12, 13, 20])
    for m in (0, 1, 2):
        for a, b in zip(matrixprofile.MatrixProfile._chainify(idx, m),
                        jmp.MatrixProfile._chainify(idx, m)):
            np.testing.assert_array_equal(a, b)


# -- MUSIC ----------------------------------------------------------------------

def _two_tone(n=2000, f1=0.1, f2=0.13, snr=1e3):
    rng = np.random.default_rng(5)
    t = np.arange(n)
    return (np.exp(2j * np.pi * f1 * t) + np.exp(2j * np.pi * f2 * t)
            + np.sqrt(1 / snr) * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n)))


def test_music_host_estimators_equal_jax():
    """The copied numpy estimators give JAX's results exactly."""
    x = _two_tone()
    fl = np.arange(0.05, 0.2, 1e-3)
    for jump in (None, 1, 3):
        np.testing.assert_array_equal(music.snapshot_matrix(x, 16, jump),
                                      jmusic.snapshot_matrix(x, 16, jump))
    for kw in (dict(fwd_bwd=True), dict(avg_to_toeplitz=True),
               dict(use_autocorr=True), dict(snapshot_jump=1)):
        np.testing.assert_array_equal(music.covariance(x, 16, **kw),
                                      jmusic.covariance(x, 16, **kw))
    for a, b in zip(music.music_alg(x, fl, 32, [1, 2], snapshot_jump=1,
                                    use_signal_as_numerator=True),
                    jmusic.music_alg(x, fl, 32, [1, 2], snapshot_jump=1,
                                     use_signal_as_numerator=True)):
        np.testing.assert_array_equal(a, b)
    m, jm = music.MUSIC(32, snapshot_jump=1), jmusic.MUSIC(32, snapshot_jump=1)
    noise = _two_tone(snr=1e-6)
    m.est_prewhitening_matrix(noise)
    jm.est_prewhitening_matrix(noise)
    for a, b in zip(m.run(x, fl, 2, prewhiten=True),
                    jm.run(x, fl, 2, prewhiten=True)):
        np.testing.assert_array_equal(a, b)
    f = m.run(x, fl, 2)[0]
    assert [a.tolist() for a in music.MUSIC.pick_peaks(f, 2)] == \
        [a.tolist() for a in jmusic.MUSIC.pick_peaks(f, 2)]
    for a, b in zip(music.CAPON(24, snapshot_jump=1).run(x, fl),
                    jmusic.CAPON(24, snapshot_jump=1).run(x, fl)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(music.ESPRIT(16, snapshot_jump=1).run(x, 2, 1.0),
                    jmusic.ESPRIT(16, snapshot_jump=1).run(x, 2, 1.0)):
        np.testing.assert_array_equal(a, b)


def _music_scene(rng, two=True):
    """tests/test_analysis_ops.py's device-MUSIC scene: a 100 Hz tone as the
    cutout, received at shift 8 with one (or two) Dopplers."""
    fs, dsr, n = 1e4, 4, 512 + 16
    t = np.arange(n) / fs
    cutout = np.exp(2j * np.pi * 100.0 * t).astype(np.complex64)
    rx = np.zeros(n + 32, dtype=np.complex64)
    dop = np.exp(2j * np.pi * 300.0 * t)
    if two:
        dop = dop + 0.5 * np.exp(2j * np.pi * 360.0 * t)
    rx[8: 8 + n] = cutout * dop
    rx += 0.01 * _cplx(rng, n + 32, dtype=np.complex64)
    ftap = sps.firwin(32, 0.8 / dsr).astype(np.float32)
    return cutout, rx, ftap, fs, dsr


def _close_inverse(a, b):
    np.testing.assert_allclose(1.0 / a, 1.0 / b, rtol=1e-3,
                               atol=1e-6 * np.max(1.0 / b))
    assert (np.unravel_index(np.argmax(a), a.shape)
            == np.unravel_index(np.argmax(b), b.shape))


@pytest.mark.parametrize("plist", [[1], [1, 2]])
def test_music_xcorr_device_matches_jax_and_its_oracle(rng, plist):
    cutout, rx, ftap, fs, dsr = _music_scene(rng)
    f_search = np.linspace(200.0, 400.0, 21)
    kw = dict(musicrows=32, shifts=np.arange(6, 11))
    got = music.music_xcorr_device(cutout, torch.from_numpy(rx), f_search,
                                   ftap, fs, dsr, plist, **kw)
    ref = jmusic.music_xcorr_device(cutout, rx, f_search, ftap, fs, dsr,
                                    plist, **kw)
    host = music.music_xcorr_device(cutout, torch.from_numpy(rx), f_search,
                                    ftap, fs, dsr, plist,
                                    eig_on_device=False, **kw)
    assert set(got) == set(plist)
    for p in plist:
        assert got[p].shape == (5, 21)
        _close_inverse(got[p], ref[p])
        _close_inverse(got[p], host[p])


def test_music_xcorr_device_matches_host_music_xcorr(rng):
    cutout, rx, ftap, fs, dsr = _music_scene(rng, two=False)
    f_search = np.linspace(200.0, 400.0, 21)
    kw = dict(musicrows=32, shifts=np.arange(6, 11))
    got = music.music_xcorr_device(cutout, torch.from_numpy(rx), f_search,
                                   ftap, fs, dsr, [1], **kw)
    host = music.music_xcorr(cutout, rx, f_search, ftap, fs, dsr, [1], **kw)
    jhost = jmusic.music_xcorr(cutout, rx, f_search, ftap, fs, dsr, [1], **kw)
    np.testing.assert_array_equal(host[1], jhost[1])
    np.testing.assert_allclose(got[1], host[1], rtol=2e-2,
                               atol=1e-3 * np.max(np.abs(host[1])))
    i, j = np.unravel_index(np.argmax(got[1]), got[1].shape)
    assert kw["shifts"][i] == 8 and abs(f_search[j] - 300.0) <= 10.0
    f_plain = music.music_xcorr_device(
        cutout, torch.from_numpy(rx), f_search, ftap, fs, dsr, [1],
        use_signal_as_numerator=False, **kw)
    jf_plain = jmusic.music_xcorr_device(
        cutout, rx, f_search, ftap, fs, dsr, [1],
        use_signal_as_numerator=False, **kw)
    _close_inverse(f_plain[1], jf_plain[1])


def test_music_xcorr_device_refuses_uneven_phases(rng):
    cutout, rx, ftap, fs, dsr = _music_scene(rng)
    with pytest.raises(ValueError, match="multiple of dsr"):
        music.music_xcorr_device(cutout[:-1], torch.from_numpy(rx),
                                 [300.0], ftap, fs, dsr, [1], musicrows=32,
                                 shifts=[8])


# -- device placement ------------------------------------------------------------

def _entry_points(device=None):
    """Every new entry point, given numpy inputs."""
    x = np.ones(64, np.complex64)
    m = np.ones((4, 64), np.complex64)
    mask = np.array([1, 0, 1, 0])
    ftap = np.ones(4, np.float32)
    return {
        "cancel_signal_at_idx": lambda: cancellation.cancel_signal_at_idx(
            x[:8], x, 3, device=device),
        "multichannel_minmax_scale":
            lambda: minmax.multichannel_minmax_scale(m, device=device),
        "multiply_only_masked_rows": lambda: masked.multiply_only_masked_rows(
            mask, m, m, device=device),
        "multiply_rows_based_on_mask":
            lambda: masked.multiply_rows_based_on_mask(mask, m, m, m,
                                                       device=device),
        "multiply_masked_rows_gathered":
            lambda: masked.multiply_masked_rows_gathered(mask, m, m,
                                                         device=device),
        "cm_peak_scan": lambda: cyclostationary.cm_peak_scan(m, 2,
                                                             device=device),
        "PSKOrderDetector.estimate_order":
            lambda: cyclostationary.PSKOrderDetector(4).estimate_order(
                m, device=device),
        "estimate_offset_via_cm":
            lambda: cyclostationary.estimate_offset_via_cm(x, 1.0, 4,
                                                           device=device),
        "matrix_profile": lambda: matrixprofile.matrix_profile(
            x, 8, 4, device=device),
        "MatrixProfile.compute": lambda: matrixprofile.MatrixProfile(
            8).compute(x, 4, device=device),
        "music_xcorr_device": lambda: music.music_xcorr_device(
            x, np.ones(70, np.complex64), [0.0], ftap, 1.0, 2, [1],
            musicrows=8, shifts=[0, 1], device=device),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Given numpy inputs and no device each entry point targets the card:
    without CUDA it raises (never a silent CPU run); with device="cpu" it
    runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
    _entry_points("cpu")[name]()


def test_tensor_inputs_stay_on_their_device(rng):
    x = torch.from_numpy(_cplx(rng, 4, 64, dtype=np.complex64))
    assert minmax.multichannel_minmax_scale(x).device == x.device
    assert place(x) is x


# -- the capture-to-analysis path (chip_smoke.analysis) at a small size --------

def test_capture_to_analysis_path_matches_jax(tmp_path):
    """``chip_smoke.analysis``'s path on the CPU at a small size (16 ch,
    256 taps, a 256-symbol template, 4 files of 4096 samples), the same
    files and arrays through both packages: the frames equal; the streamed
    channels within 1e-5 of max (the WOLA bound); min-max within 1e-6; the
    CAF peak's shift and bin equal, QF^2 within rtol 1e-4; the cancellation
    amplitude within rtol 1e-5; MUSIC by chip_smoke's rule (inverse grids
    at the JAX eig test's tolerance wherever the grid is at least 1e-3 of
    its row's maximum, the grid within 1e-3 of that maximum); PSK orders,
    the CM offset and the matrix-profile chains equal."""
    import chip_smoke as cs
    import pydsproutines_tpu.io as jio
    import pydsproutines_tpu.ops.xcorr as jx
    from pydsproutines_tpu.ops.wola import Channeliser as JaxChanneliser
    from pydsproutines_tpu_torch import io
    from pydsproutines_tpu_torch.ops import Channeliser, fast_xcorr

    nch, taps, tl, nsh, files, samps = 16, 256, 256, 64, 4, 4096
    syms, rx, _ = cs.scene_burst(nch, taps, tl, nsh, files * samps, seed=7)
    raw, _ = cs.int16_capture(rx, files, cs.AN_INT16_PEAK)
    paths = [str(tmp_path / f"{1000 + i}.bin") for i in range(files)]
    for part, path in zip(raw, paths):
        part.tofile(path)
    chan, jchan = Channeliser(taps, nch, device="cpu"), JaxChanneliser(taps,
                                                                       nch)
    got, ref = [], []
    with io.StreamingCaptureLoader(paths, samps) as ldr, \
            jio.StreamingCaptureLoader(paths, samps) as jldr:
        for (_, f), (_, g) in zip(ldr, jldr):
            np.testing.assert_array_equal(f, g)
            got.append(chan.channelise(torch.from_numpy(f)))
            ref.append(np.asarray(jchan.channelise(g)))
    chans, jchans = torch.cat(got), np.concatenate(ref)
    assert np.abs(chans.numpy() - jchans).max() / np.abs(jchans).max() < 1e-5

    ch = chans.T.contiguous()
    for mode in (False, True):
        np.testing.assert_allclose(
            minmax.multichannel_minmax_scale(ch, mode).numpy(),
            np.asarray(jmm.multichannel_minmax_scale(jnp.asarray(jchans.T),
                                                     mode)), rtol=0,
            atol=1e-6)
    best = int(torch.argmax((ch.abs() ** 2).mean(-1)))
    assert best == cs.AN_CHANNEL
    x, jxv = ch[best].contiguous(), jnp.asarray(jchans[:, best])
    tmpl = syms.astype(np.complex64)
    q, b = fast_xcorr(torch.from_numpy(tmpl), x, True,
                      shifts=torch.arange(nsh))
    jq, jb = jx._fast_xcorr_impl(
        jnp.asarray(tmpl), jxv, jnp.arange(nsh), n=tl, freqsearch=True,
        output_caf=False, abs_result=True, batch_size=64, step=1,
        interpret=False)
    pk = int(torch.argmax(q))
    assert pk == int(np.argmax(np.asarray(jq))) and int(b[pk]) == int(
        np.asarray(jb)[pk]) == 0
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-4)

    _, amp = cancellation.cancel_signal_at_idx(tmpl, x, pk)
    _, jamp = jcan.cancel_signal_at_idx(jnp.asarray(tmpl), jxv, pk)
    assert abs(complex(amp) - complex(jamp)) / abs(complex(jamp)) < 1e-5

    kw = dict(musicrows=32, shifts=np.arange(pk - 16, pk + 16))
    f_search = np.linspace(-2, 2, 41) / tl
    ftap = sps.firwin(32, 0.8 / 4)
    grids = music.music_xcorr_device(tmpl, x, f_search, ftap, 1.0, 4,
                                     [1, 2], **kw)
    jgrids = jmusic.music_xcorr_device(tmpl, np.asarray(jxv), f_search,
                                       ftap, 1.0, 4, [1, 2], **kw)
    for p in (1, 2):
        a, r = grids[p], jgrids[p]
        rowmax = r.max(axis=1, keepdims=True)
        held = r >= cs.AN_MU_NOTCH * rowmax
        ok = np.abs(1 / a - 1 / r) <= 1e-3 / r + 1e-6 * np.max(1 / r)
        assert ok[held].all() and held.mean() > 0.75     # most of the grid
        assert (np.abs(a - r) / rowmax).max() < cs.AN_MU_NOTCH
        assert np.argmax(a) == np.argmax(r)

    for m, (rows, want) in cs.psk_order_scene(51, 16, 4096,
                                              cs.AN_PSK_SIGMA).items():
        order = cyclostationary.PSKOrderDetector(m).estimate_order(
            torch.from_numpy(rows))
        np.testing.assert_array_equal(order, want)
        np.testing.assert_array_equal(
            order, jcyc.PSKOrderDetector(m).estimate_order(jnp.asarray(rows)))
    cm = cs.cm_scene(52, 1 << 14, cs.AN_CM_F0, cs.AN_PSK_SIGMA)
    assert float(cyclostationary.estimate_offset_via_cm(
        torch.from_numpy(cm), 1.0, 4)) == float(
        jcyc.estimate_offset_via_cm(jnp.asarray(cm), 1.0, 4))
    mx = cs.motif_scene(54, 512, 32, 40, 300)
    kw = dict(window_length=32, output_chains=True, min_threshold=0.5)
    chains = matrixprofile.MatrixProfile(**kw).compute(torch.from_numpy(mx))
    assert chains == jmp.MatrixProfile(**kw).compute(jnp.asarray(mx))
    assert any(d == 300 and s <= 40 < e for d, s, e in chains)
    np.testing.assert_allclose(
        matrixprofile.matrix_profile(torch.from_numpy(mx), 32, 64)[63, :417]
        .numpy(), cs.mp_reference(mx, 32, 64), rtol=0, atol=cs.AN_MP_ATOL)
