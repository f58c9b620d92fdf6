"""Parity of the port's three-stage CAF peak search (TPU kernel #3) on the CPU.

The same seeded numpy inputs (complex64) go through the JAX kernel in
interpret mode, through numpy's float64 FFT, and through the port's CPU
versions: the torch.fft twin ``caf3_peak_plain`` (what ``caf3_peak`` runs
for CPU tensors) and ``caf3_staged``, the kernel's three-stage algebra over
the very tables the kernel reads. Tolerances: bins exact (no exact ties in
these seeded spectra); peak |X|^2 rtol 1e-5 (two f32 DFTs with different
splits and summation orders, measured ~3e-7); QF^2 rtol 1e-4 where window
energies enter (the port's float64 prefix sum against a per-window sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops.pallas import fused_caf3 as jcaf3
from pydsproutines_tpu_torch.ops import fft as tfft
from pydsproutines_tpu_torch.ops import xcorr as tx
from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import (caf3_peak,
                                                           caf3_peak_plain,
                                                           caf3_staged)

PEAK_RTOL = 1e-5
QF2_RTOL = 1e-4


def truth(cut, rx, shifts):
    """numpy float64 truth (benchmarks/hw_parity.py:11): QF^2, bin and the
    raw peak |X|^2 per shift."""
    cc = np.conj(cut.astype(np.complex128))
    cns = np.sum(np.abs(cc) ** 2)
    qf2, bins, peak = [], [], []
    for s in shifts:
        w = rx[s: s + len(cut)].astype(np.complex128)
        spec = np.abs(np.fft.fft(w * cc)) ** 2
        bins.append(int(np.argmax(spec)))
        peak.append(spec[bins[-1]])
        qf2.append(peak[-1] / cns / np.sum(np.abs(w) ** 2))
    return np.array(qf2), np.array(bins), np.array(peak)


def _scene(rng, n, offsets, i_star, f_bin, tail=0):
    cut = (rng.standard_normal(n)
           + 1j * rng.standard_normal(n)).astype(np.complex64)
    rxlen = int(offsets[-1]) + n + tail
    rx = (0.5 * (rng.standard_normal(rxlen)
                 + 1j * rng.standard_normal(rxlen))).astype(np.complex64)
    s = int(offsets[i_star])
    rx[s: s + n] += (cut * np.exp(2j * np.pi * f_bin * np.arange(n) / n)
                     ).astype(np.complex64)
    return cut, rx


def _port(fn, cut, rx, offsets, *args):
    pk, bins = fn(torch.from_numpy(rx), torch.from_numpy(np.conj(cut)),
                  torch.as_tensor(offsets, dtype=torch.int64), *args)
    return pk.numpy(), bins.numpy()


def test_caf3_twins_match_pallas_kernel_interpret(rng):
    """The TPU kernel itself (f32 mode, interpret) at n = 32768 = 16*16*128,
    4 shifts of step 1, against both CPU versions of the port (whose own
    triple is 32*32*32)."""
    n, nb = 32768, 4
    cut, rx = _scene(rng, n, np.arange(nb), 2, 901)
    plan = jcaf3.get_caf3_plan(n, "f32")
    assert (plan.f0, plan.f1, plan.f2) == (16, 16, 128)
    rxp = np.pad(rx, (0, plan.f2 + 8))
    cc = np.conj(cut)
    jpk, jbin = jcaf3.caf3_sweep(
        jnp.asarray(rxp.real), jnp.asarray(rxp.imag), jnp.asarray(cc.real),
        jnp.asarray(cc.imag), jnp.int32(0), nb, 1, plan, interpret=True)
    jpk, jbin = np.asarray(jpk), np.asarray(jbin).astype(np.int64)
    assert tfft.find_triple(n) == (32, 32, 32)
    for fn in (caf3_peak_plain, caf3_staged):
        pk, bins = _port(fn, cut, rx, np.arange(nb))
        assert bins.dtype == np.int64 and pk.dtype == np.float32
        np.testing.assert_array_equal(bins, jbin)
        np.testing.assert_allclose(pk, jpk, rtol=PEAK_RTOL)
    assert int(np.argmax(jpk)) == 2 and int(jbin[2]) == 901


@pytest.mark.parametrize("n,triple,offsets", [
    (13056, None, [0, 1, 2, 3, 4]),                 # 17 x 24 x 32
    (15625, None, [0, 3, 6, 9, 12, 15]),            # 25^3, odd step
    (17280, (20, 24, 36), [2, 5, 11, 12, 40]),      # a shift list
    (32768, (16, 16, 128), [1, 2, 3]),              # the TPU's own triple
])
def test_caf3_staged_matches_numpy(rng, n, triple, offsets):
    """The three-stage algebra over the kernel's tables, at triples whose
    f2 is not a multiple of 128, against numpy's FFT."""
    i_star = len(offsets) // 2
    cut, rx = _scene(rng, n, offsets, i_star, n // 3, tail=3)
    _, tbin, tpeak = truth(cut, rx, offsets)
    pk, bins = _port(caf3_staged, cut, rx, offsets, triple)
    np.testing.assert_array_equal(bins, tbin)
    np.testing.assert_allclose(pk, tpeak, rtol=PEAK_RTOL)
    assert int(np.argmax(pk)) == i_star and bins[i_star] == n // 3


def test_caf3_end_of_capture_geometry(rng):
    """shifts[0] > 0 with rx ending exactly at the last window, where the JAX
    "fused3" route pads without shifts[0] and clamps its slice on the TPU
    (ROADMAP Queue 3 item 1): the port's CPU versions read no sample past
    the last window and match numpy truth."""
    n = 32768
    offsets = np.arange(8) * 3 + 1000
    cut, rx = _scene(rng, n, offsets, 5, 4242)
    assert rx.shape[0] == offsets[-1] + n
    tq, tbin, tpeak = truth(cut, rx, offsets)
    for fn in (caf3_peak, caf3_staged):
        pk, bins = _port(fn, cut, rx, offsets)
        np.testing.assert_array_equal(bins, tbin)
        np.testing.assert_allclose(pk, tpeak, rtol=PEAK_RTOL)
    q, b = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), True,
                         shifts=offsets)
    np.testing.assert_array_equal(b.numpy(), tbin)
    np.testing.assert_allclose(q.numpy(), tq, rtol=QF2_RTOL)
    assert int(np.argmax(q.numpy())) == 5 and int(b[5]) == 4242


def test_fast_xcorr_end_of_capture_at_fused3_size(rng):
    """The same geometry at n = 2^21, the size the JAX package routes to
    "fused3": fast_xcorr on CPU tensors (the plain route) against numpy."""
    n = 1 << 21
    offsets = np.arange(4) * 5 + 7
    cut, rx = _scene(rng, n, offsets, 2, 123456)
    tq, tbin, _ = truth(cut, rx, offsets)
    q, b = tx.fast_xcorr(torch.from_numpy(cut), torch.from_numpy(rx), True,
                         shifts=offsets)
    assert b[2] == tbin[2] == 123456
    np.testing.assert_allclose(q.numpy(), tq, rtol=QF2_RTOL)


@pytest.mark.parametrize("n,ours,theirs", [
    (10_000_000, (200, 200, 250), (125, 125, 640)),
    (5 ** 10, (625, 125, 125), None),     # no f2 % 128 == 0 triple on a TPU
    (1 << 21, (128, 128, 128), (128, 128, 128)),
    (10_000_019, None, None),             # prime
])
def test_find_triple_drops_the_lane_rule(n, ours, theirs):
    assert tfft.find_triple(n) == ours
    assert jcaf3.find_triple(n) == theirs
    if ours is not None:
        assert np.prod(ours) == n and all(16 <= f <= 1024 for f in ours)
    if ours is not None and theirs is not None:
        assert sum(ours) <= sum(theirs)


def test_caf3_tables_match_jax_plan():
    """The port's tables for the JAX plan's triple equal the plan's planes
    (both from float64 phases reduced mod their period)."""
    plan = jcaf3.get_caf3_plan(32768, "f32")
    f0, f1, f2 = plan.f0, plan.f1, plan.f2
    t = tfft.caf3_tables(f0, f1, f2)

    def planes(re, im, shape):
        return np.asarray(re).reshape(shape) + 1j * np.asarray(im).reshape(
            shape)

    np.testing.assert_allclose(t["w0"], planes(plan.w1r, plan.w1i, (f0, f0)),
                               atol=1e-7)
    np.testing.assert_allclose(t["w1"], planes(plan.w2r, plan.w2i, (f1, f1)),
                               atol=1e-7)
    np.testing.assert_allclose(t["w2"], planes(plan.w3r, plan.w3i, (f2, f2)),
                               atol=1e-7)
    np.testing.assert_allclose(t["a1"], planes(plan.a1r, plan.a1i, (f0, f1)),
                               atol=1e-7)
    np.testing.assert_allclose(t["a2"], planes(plan.a2r, plan.a2i, (f0, f2)),
                               atol=1e-7)
    np.testing.assert_allclose(t["tw2"], planes(plan.tw2r, plan.tw2i,
                                                (f1, f2)), atol=1e-7)


def test_caf3_peak_checks_its_sweep():
    rx = torch.zeros(100, dtype=torch.complex64)
    cc = torch.ones(64, dtype=torch.complex64)
    with pytest.raises(ValueError):
        caf3_peak(rx, cc, torch.tensor([0, 37]))       # last window past rx
    with pytest.raises(ValueError):
        caf3_peak(rx, cc, torch.tensor([0, 3], dtype=torch.int32))
    with pytest.raises(ValueError):
        caf3_peak(rx, cc, torch.tensor([], dtype=torch.int64))
    before = caf3_peak.launches
    caf3_peak(rx, cc, torch.tensor([0, 36]))           # ends exactly at rx
    assert caf3_peak.launches == before                # CPU: the plain twin
