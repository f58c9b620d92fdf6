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
    with pytest.raises(NotImplementedError):
        tx.fast_xcorr(cut, rx, freqsearch=False)
