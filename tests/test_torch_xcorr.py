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
