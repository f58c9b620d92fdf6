"""Parity of the PyTorch frequency-scanning peak search with the JAX package.

The same numpy inputs (complex64) go through the JAX function (CPU) and the
port (CPU tensors: the CAF kernel's plain twin, torch.fft). Tolerances:
argmax shift and the planted peak's bin exact; QF^2 rtol 1e-4. Both sides
are f32-grade here: the JAX "permuted" XLA route runs its DFT matmuls in f32
on the CPU and re-verifies the winner in f32, the Pallas kernel is run in
its "f32" mode, and the port is f32 throughout; 1e-4 covers their different
summation orders and the port's float64 window energies against JAX's f32
prefix sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import xcorr as jx
from pydsproutines_tpu_torch.ops import xcorr as tx
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import caf_peak
from pydsproutines_tpu_torch.utils.memory import WORK_BUDGET_BYTES, chunk_shifts

QF2_RTOL = 1e-4


def _scene(rng, n, rxlen, plant_at, f_bin):
    cut = (rng.standard_normal(n)
           + 1j * rng.standard_normal(n)).astype(np.complex64)
    rx = (0.3 * (rng.standard_normal(rxlen)
                 + 1j * rng.standard_normal(rxlen))).astype(np.complex64)
    tone = np.exp(2j * np.pi * f_bin * np.arange(n) / n)
    rx[plant_at: plant_at + n] += (cut * tone).astype(np.complex64)
    return cut, rx


@pytest.mark.parametrize("n,step,nshifts", [
    (1024, 1, 40),        # the receiver's template length
    (1024, 3, 24),
    (4096, 1, 24),
    (4096, 3, 16),
])
def test_fast_xcorr_matches_jax(rng, n, step, nshifts):
    plant = 5 * step
    cut, rx = _scene(rng, n, n + step * nshifts + 64, plant, f_bin=37)
    shifts = np.arange(nshifts) * step
    # the "permuted" XLA route: interpret=False on the CPU platform
    jq, jb = jx._fast_xcorr_impl(
        jnp.asarray(cut), jnp.asarray(rx), jnp.asarray(shifts), n=n,
        freqsearch=True, output_caf=False, abs_result=True, batch_size=8,
        step=step, interpret=False)
    jq, jb = np.asarray(jq), np.asarray(jb)
    tq, tb = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx),
                           freqsearch=True, shifts=shifts, batch_size=8)
    tq, tb = tq.numpy(), tb.numpy()
    assert tq.dtype == np.float32 and tb.dtype == np.int64
    i_star = int(np.argmax(jq))
    assert i_star == int(np.argmax(tq)) == 5
    assert int(jb[i_star]) == int(tb[i_star]) == 37
    np.testing.assert_allclose(tq, jq, rtol=QF2_RTOL)


def test_caf_twin_matches_pallas_kernel_interpret(rng):
    """The CAF kernel's plain twin against the TPU kernel itself in interpret
    mode ("f32" mode: every bin, not only the peak, is reference grade)."""
    from pydsproutines_tpu.ops.pallas.fused_xcorr import fused_freq_scan_xcorr

    n, batch, step, nshifts = 4096, 8, 1, 24
    cut, rx = _scene(rng, n, n + 300, plant_at=2, f_bin=901)
    jq, jb = fused_freq_scan_xcorr(jnp.asarray(cut), jnp.asarray(rx), 0,
                                   nshifts, batch=batch, step=step,
                                   mode="f32", interpret=True)
    jq, jb = np.asarray(jq), np.asarray(jb)
    cc = torch.from_numpy(np.conj(cut))
    maxv, bins = caf_peak(torch.from_numpy(rx), cc, 0, step, nshifts, batch)
    rxn = np.array([np.sum(np.abs(rx[s: s + n].astype(np.complex128)) ** 2)
                    for s in range(nshifts)])
    tq = maxv.numpy() / np.sum(np.abs(cut) ** 2) / rxn
    np.testing.assert_array_equal(bins.numpy(), jb.astype(np.int64))
    assert int(np.argmax(tq)) == int(np.argmax(jq)) == 2
    assert int(bins[2]) == 901
    np.testing.assert_allclose(tq, jq, rtol=QF2_RTOL)


def test_caf_peak_checks_its_sweep():
    rx = torch.zeros(100, dtype=torch.complex64)
    cc = torch.ones(64, dtype=torch.complex64)
    with pytest.raises(ValueError):
        caf_peak(rx, cc, 30, 1, 8)           # last window runs past rx
    with pytest.raises(ValueError):
        caf_peak(rx, cc, 0, 0, 8)            # step must be positive


@pytest.mark.parametrize("shifts,step", [
    ([3], 1), ([0, 2, 4, 6], 2), ([0, 1, 3], None), ([5, 4, 3], None),
    (np.arange(0, 30, 3), 3),
])
def test_uniform_step_matches_jax(shifts, step):
    assert tx._uniform_step(shifts) == jx._uniform_step(np.asarray(shifts)) \
        == step
    assert tx._uniform_step(torch.tensor(shifts)) == step


@pytest.mark.parametrize("step", [None, 2])
def test_gather_shift_slices_matches_jax(rng, step):
    rx = (rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(
        np.complex64)
    shifts = np.arange(5, 45, 2)
    ref = np.asarray(jx.gather_shift_slices(jnp.asarray(rx),
                                            jnp.asarray(shifts), 32, step))
    got = tx.gather_shift_slices(torch.from_numpy(rx),
                                 torch.from_numpy(shifts), 32, step)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_argmax_and_max_last_matches_jax(rng):
    m = rng.standard_normal((6, 300)).astype(np.float32)
    ji, jm = jx.argmax_and_max_last(jnp.asarray(m))
    ti, tm = tx.argmax_and_max_last(torch.from_numpy(m))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("shape", [(256,), (4, 64)])
def test_calc_qf2_and_eff_snr_match_jax(rng, shape):
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    y = x + 0.5 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ref = np.asarray(jx.calc_qf2(jnp.asarray(x), jnp.asarray(y)))
    got = tx.calc_qf2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(tx.convert_qf2_to_eff_snr(got),
                               np.asarray(jx.convert_qf2_to_eff_snr(ref)),
                               rtol=1e-12)


def test_fast_xcorr_rejects_bad_input():
    cut = torch.ones(64, dtype=torch.complex64)
    rx = torch.ones(100, dtype=torch.complex64)
    with pytest.raises(ValueError):
        tx.fast_xcorr(torch.ones(200, dtype=torch.complex64), rx)
    with pytest.raises(ValueError):
        tx.fast_xcorr(cut, rx, shifts=[0, 40])
    # freqsearch=False is the "dot" mode, as in the JAX package
    ref = np.asarray(jx.fast_xcorr(jnp.asarray(cut.numpy()),
                                   jnp.asarray(rx.numpy()), freqsearch=False))
    np.testing.assert_allclose(tx.fast_xcorr(cut, rx, freqsearch=False)
                               .numpy(), ref, rtol=QF2_RTOL)


def test_fast_xcorr_signature_matches_jax():
    import inspect
    ours = inspect.signature(tx.fast_xcorr).parameters
    theirs = inspect.signature(jx.fast_xcorr).parameters
    assert list(ours) == list(theirs)
    assert [p.default for p in ours.values()] == \
        [p.default for p in theirs.values()]


def test_fast_xcorr_shift_list_matches_jax(rng):
    """A non-uniform shift list (the "peak-kernel-hopper" route on a card)
    against the JAX XLA route at n = 4096."""
    n = 4096
    shifts = np.array([0, 2, 3, 7, 11, 30, 31, 64, 65, 90])
    cut, rx = _scene(rng, n, n + 100, 30, f_bin=1234)
    jq, jb = jx._fast_xcorr_impl(
        jnp.asarray(cut), jnp.asarray(rx), jnp.asarray(shifts), n=n,
        freqsearch=True, output_caf=False, abs_result=True, batch_size=4,
        step=None, interpret=False)
    jq, jb = np.asarray(jq), np.asarray(jb)
    tq, tb = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), True,
                           shifts=shifts, batch_size=4)
    assert int(np.argmax(tq.numpy())) == int(np.argmax(jq)) == 5
    assert int(tb[5]) == int(jb[5]) == 1234
    np.testing.assert_allclose(tq.numpy(), jq, rtol=QF2_RTOL)


# (freqsearch, output_caf, abs_result): the modes the JAX package runs with
# no Pallas kernel. Complex results are normalized to |.| <= 1; they and
# the CAF's near-zero bins are held with atol 1e-6 besides rtol 1e-4.
@pytest.mark.parametrize("freqsearch,output_caf,abs_result", [
    (False, False, True), (False, False, False),
    (True, True, True), (True, True, False), (True, False, False),
])
def test_fast_xcorr_modes_match_jax(rng, freqsearch, output_caf, abs_result):
    n = 4096
    # rx reaches 64 samples past the last window: the JAX chunked route pads
    # its last chunk with the continued progression and slices one covering
    # window, which would clamp at the end of a shorter capture
    cut, rx = _scene(rng, n, n + 40 + 64, 9, f_bin=77)
    shifts = np.arange(0, 40, 3)
    ref = jx.fast_xcorr(jnp.asarray(cut), jnp.asarray(rx), freqsearch,
                        output_caf, jnp.asarray(shifts), abs_result,
                        batch_size=4)
    got = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx),
                        freqsearch, output_caf, shifts, abs_result,
                        batch_size=4)
    if freqsearch and not output_caf:          # (complex peak, bin)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert int(got[1][3]) == 77
        got, ref = got[0], ref[0]
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=QF2_RTOL, atol=1e-6)
    if freqsearch:                             # the tone-shifted plant
        peak = np.abs(got).reshape(len(shifts), -1).max(-1)
        assert int(np.argmax(peak)) == 3


def test_chunk_shifts_at_10M():
    """The byte budget (1 GiB) at the 10M sweep: kernel #3's two complex64
    scratch buffers, kernel #2's one, the plain route's 32 B per sample."""
    n = 10_000_000
    assert chunk_shifts(n, 128, 16) == 6           # 960 MB of scratch
    assert chunk_shifts(n, 128, 8) == 13
    assert chunk_shifts(n, 128, tx.PLAIN_BYTES_PER_SAMPLE) == 3
    assert chunk_shifts(n, 2, 8) == 2              # batch still caps it
    assert chunk_shifts(2**31, 128, 32) == 1       # never below one shift
    assert chunk_shifts(1_000_000, 128, 8) == 128  # the 1M sweep: one chunk
    for bps in (8, 16, 32):
        m = chunk_shifts(n, 128, bps)
        assert m * n * bps <= WORK_BUDGET_BYTES < (m + 1) * n * bps
    with pytest.raises(ValueError):
        chunk_shifts(0, 128, 8)


def test_chunking_leaves_results_unchanged(rng, monkeypatch):
    """One shift per chunk gives the same answers as the default chunks."""
    n = 4096
    cut, rx = _scene(rng, n, n + 64, 5, f_bin=37)
    args = (torch.from_numpy(cut), torch.from_numpy(rx), True)
    ref = tx.fast_xcorr(*args, shifts=np.arange(0, 60, 2))
    monkeypatch.setattr(tx, "chunk_shifts", lambda n, batch, bps: 1)
    got = tx.fast_xcorr(*args, shifts=np.arange(0, 60, 2))
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6)


def test_fast_xcorr_exact_when_the_last_chunk_is_short(rng):
    """14 shifts of step 3 in chunks of 4, rx ending 3 samples after the
    last window: the JAX chunked route pads the last chunk to 4 shifts and
    its covering slice clamps, shifting that chunk's windows (bins of shifts
    36 and 39 wrong against numpy). The port reads each window where it is."""
    n = 4096
    cut, rx = _scene(rng, n, n + 40, 39, f_bin=99)
    shifts = np.arange(0, 40, 3)
    q, b = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), True,
                         shifts=shifts, batch_size=4)
    cc = np.conj(cut).astype(np.complex128)
    spec = np.abs(np.fft.fft(np.stack([rx[s: s + n] for s in shifts]) * cc)
                  ) ** 2
    rxn = np.array([np.sum(np.abs(rx[s: s + n].astype(np.complex128)) ** 2)
                    for s in shifts])
    np.testing.assert_array_equal(b.numpy(), spec.argmax(-1))
    np.testing.assert_allclose(q.numpy(), spec.max(-1) / np.sum(
        np.abs(cc) ** 2) / rxn, rtol=QF2_RTOL)
    assert int(np.argmax(q.numpy())) == 13 and int(b[13]) == 99


# --- the TDOA refinement chain: czt_xcorr -> fine_freq_time_search --------
# complex128 against the JAX functions: 1e-9 (the same float64 algebra in
# another order); the planted shift, frequency and delay exact.

def _tone_scene(rng, n_cut, n_rx, start, fshift, noise=0.01):
    cut = np.exp(0.5j * np.pi * rng.integers(0, 4, n_cut))
    rx = noise * (rng.standard_normal(n_rx) + 1j * rng.standard_normal(n_rx))
    rx[start: start + n_cut] += cut * np.exp(2j * np.pi * fshift
                                             * np.arange(n_cut))
    return cut, rx


@pytest.mark.parametrize("output_caf", [False, True])
def test_czt_xcorr_matches_jax(rng, output_caf):
    cut, rx = _tone_scene(rng, 256, 1024, 300, 0.0213)
    shifts = np.arange(295, 306)
    args = (0.0, 0.05, 1.0, 1e-3, output_caf)
    ref = jx.czt_xcorr(jnp.asarray(cut), jnp.asarray(rx), *args,
                       shifts=jnp.asarray(shifts), batch_size=4)
    got = tx.czt_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), *args,
                       shifts=shifts, batch_size=4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-12)
    g0, r0 = got[0].numpy(), np.asarray(ref[0])
    assert g0.shape == r0.shape and g0.dtype == r0.dtype
    assert np.abs(g0 - r0).max() < 1e-9
    mag = np.abs(g0) if not output_caf else g0.max(-1)
    assert shifts[int(np.argmax(mag))] == 300
    if not output_caf:
        assert abs(float(got[1][5]) - 0.0213) < 1e-3


def test_czt_xcorr_complex64_default_shifts(rng):
    cut, rx = _tone_scene(rng, 128, 400, 200, 0.01)
    cut, rx = cut.astype(np.complex64), rx.astype(np.complex64)
    ref = jx.czt_xcorr(jnp.asarray(cut), jnp.asarray(rx), -0.02, 0.02, 1.0,
                       1e-3, True)
    got = tx.czt_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), -0.02,
                       0.02, 1.0, 1e-3, True)
    assert got[0].shape == (273, 41) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    si, fi = np.unravel_index(int(torch.argmax(got[0])), got[0].shape)
    assert si == 200 and abs(float(got[1][fi]) - 0.01) < 1e-3
    with pytest.raises(ValueError, match="longer than rx"):
        tx.czt_xcorr(torch.from_numpy(rx), torch.from_numpy(cut), 0, 1, 1.0)


def _delayed(x, tau):
    f = np.fft.fftfreq(x.size)
    return np.fft.ifft(np.fft.fft(x) * np.exp(-2j * np.pi * f * tau))


@pytest.mark.parametrize("fine_res,f_true,tau", [
    ([], 0.0, 0.31),                       # sub-sample delay only
    ([1e-4, 1e-5], 0.00123, 0.0),          # fine frequency, two passes
    ([2e-4], 0.0007, 0.42),                # both
])
def test_fine_freq_time_search_matches_jax(rng, fine_res, f_true, tau):
    n = 2048
    x = np.exp(0.5j * np.pi * rng.integers(0, 4, n))
    y = _delayed(x, tau) * np.exp(2j * np.pi * f_true * np.arange(n))
    td = np.arange(-1.0, 1.0, 0.01)
    args = (fine_res, 0.0, 0.005 if fine_res else 0.0, 1.0)
    jf, jt, jc = jx.fine_freq_time_search(jnp.asarray(x), jnp.asarray(y),
                                          *args, jnp.asarray(td))
    tf, tt, tc = tx.fine_freq_time_search(torch.from_numpy(x),
                                          torch.from_numpy(y), *args, td)
    assert float(tt) == float(jt) and abs(float(tt) - tau) < 0.01 + 1e-9
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-9
    if fine_res:
        assert float(tf) == pytest.approx(float(jf), abs=1e-12)
        assert abs(float(tf) - f_true) < fine_res[-1] * 2
    else:
        assert tf is None and jf is None


def test_gen_xcorr_matches_jax(rng):
    n = 1024
    x = np.exp(0.5j * np.pi * rng.integers(0, 4, n))
    y = _delayed(x, -0.27)
    td = np.arange(-0.5, 0.5, 0.01)
    jg_ = jx.GenXcorr(jnp.asarray(td), 1.0, n, dtype=jnp.complex128)
    tg_ = tx.GenXcorr(td, 1.0, n, dtype=torch.complex128, device="cpu")
    np.testing.assert_allclose(tg_.steeringvec.numpy(),
                               np.asarray(jg_.steeringvec), atol=1e-12)
    for bounds in (None, (-0.3, 0.3)):
        jg_.set_td_scan_freq_bounds(bounds)
        tg_.set_td_scan_freq_bounds(bounds)
        jt, jc = jg_.xcorr(jnp.asarray(x), jnp.asarray(y))
        tt, tc = tg_.xcorr(torch.from_numpy(x), torch.from_numpy(y))
        assert float(tt) == float(jt) and abs(float(tt) + 0.27) < 0.01
        assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-9


def test_conversions_and_bounds_match_jax():
    for f in ("convert_qf2_to_snr", "convert_eff_snr_to_qf2"):
        for v in (0.25, 0.5, 0.9):
            assert getattr(tx, f)(v) == pytest.approx(
                float(getattr(jx, f)(v)), rel=1e-15)
    assert tx.expected_eff_snr(10.0, np.inf, 2) == pytest.approx(10.0)
    assert tx.expected_eff_snr(3.0, 5.0) == jx.expected_eff_snr(3.0, 5.0)
    assert tx.sigma_dto(1e3, 2e3, 1e-2, 10.0) == jx.sigma_dto(1e3, 2e3,
                                                               1e-2, 10.0)
    assert tx.sigma_dfo(2e3, 1e-2, 10.0) == jx.sigma_dfo(2e3, 1e-2, 10.0)
    np.testing.assert_array_equal(tx.theoretical_multi_peak([0, 100],
                                                            [10, 130]),
                                  jx.theoretical_multi_peak([0, 100],
                                                            [10, 130]))
    for a, b in zip(tx.theoretical_multi_peak([0], [10], 1.0,
                                              np.array([1.0])),
                    jx.theoretical_multi_peak([0], [10], 1.0,
                                              np.array([1.0]))):
        np.testing.assert_array_equal(a, b)
    i, j = tx.argmax2d(torch.arange(12).reshape(3, 4))
    assert (int(i), int(j)) == (2, 3)
    assert tx.compute_fast_xcorr_complexity(1024, 4) == \
        jx.compute_fast_xcorr_complexity(1024, 4)
    assert tx.compute_group_xcorr_czt_complexity(3, 128, 100, k=2) == \
        jx.compute_group_xcorr_czt_complexity(3, 128, 100, k=2)
