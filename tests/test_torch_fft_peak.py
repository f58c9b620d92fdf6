"""Parity of the port's last-stage DFT peak (TPU kernel #4) and DFT plans on
the CPU.

The same seeded numpy inputs (complex64) go through the JAX kernel
``stage2_caf_peak`` and ``FourStepFFT.call_peak`` in "f32" interpret mode
and through the port's CPU versions (``stage2_peak`` runs its plain twin
``stage2_peak_plain`` for CPU tensors; ``ops/fft.stage2_staged`` and
``peak_sweep_staged`` run the Hopper kernel's schedule: the twiddle on
load, the shared-memory row FFT over its f32 tables, the column pass
stored without its twiddle). Tolerances: bins exact (planted peaks or
seeded spectra without exact ties); peak |X|^2 rtol 5e-6, the JAX f32
mode's own tolerance against numpy (``tests/test_fft_peak.py``); plan
factors exact; tables within 1e-7 (the same float64 phases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import fft as jfft
from pydsproutines_tpu.ops.pallas.fft_peak import stage2_caf_peak
from pydsproutines_tpu_torch.ops import fft as tfft
from pydsproutines_tpu_torch.ops.hopper.fft_peak import (
    leading_stages_plain, peak_sweep, stage2_peak, stage2_peak_plain,
    sweep_plan, window_columns, window_columns_plain)
from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import caf3_peak_plain

PEAK_RTOL = 5e-6


def _rows(rng, b, n, bins=None):
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    for r, k in enumerate(bins or []):
        x[r] += (40.0 * np.exp(2j * np.pi * k * np.arange(n) / n)).astype(
            np.complex64)
    return x


def _port_peak(x, factors):
    f1 = leading_stages_plain(torch.from_numpy(x), list(factors))
    tw = torch.from_numpy(tfft.peak_consts(factors)[0])
    pk, bins = stage2_peak(f1, tw, factors)
    return f1, pk.numpy(), bins.numpy()


def test_stage2_peak_matches_pallas_kernel_interpret(rng):
    """The TPU kernel on the same (B=3, K1=64, J=64) stage-1 output."""
    x = _rows(rng, 3, 4096)
    f1, pk, bins = _port_peak(x, (64, 64))
    tw, w2 = tfft.peak_consts((64, 64))
    jpk, jbin = stage2_caf_peak(jnp.asarray(f1.numpy()), tw, w2.T, 64,
                                mode="f32", interpret=True)
    np.testing.assert_array_equal(bins, np.asarray(jbin))
    np.testing.assert_allclose(pk, np.asarray(jpk), rtol=PEAK_RTOL)
    ref = np.abs(np.fft.fft(x.astype(np.complex128))) ** 2
    np.testing.assert_array_equal(bins, ref.argmax(-1))


@pytest.mark.parametrize("n,factors", [
    (12800, None),                   # the JAX plan: 100 x 128
    (8192, [32, 16, 16]),
    (4096, [8, 8, 8, 8]),
])
def test_stage2_peak_matches_jax_call_peak(n, factors):
    """``FourStepFFT.call_peak`` (leading stages + the kernel + the row
    winner) against the port's plain leading stages + ``stage2_peak`` +
    ``peak_winner``, with planted peaks."""
    plan = (jfft.get_fft_plan(n) if factors is None
            else jfft.FourStepFFT(n, factors=factors))
    factors = factors or tfft.fft_factors(n)
    assert plan.factors == factors
    x = _rows(np.random.default_rng(13), 3, n, [5, n // 2 + 3, n - 17])
    jpk, jbin = plan.call_peak(jnp.asarray(x), mode="f32", interpret=True)
    _, pk, bins = _port_peak(x, factors)
    np.testing.assert_array_equal(bins, np.asarray(jbin))
    assert bins.tolist() == [5, n // 2 + 3, n - 17]
    np.testing.assert_allclose(pk, np.asarray(jpk), rtol=PEAK_RTOL)


@pytest.mark.parametrize("n", [100, 1024, 4096, 4099, 12800, 65536, 2**20,
                               1_000_000, 10_000_000, 5**10])
def test_fft_factors_match_jax_plan(n):
    plan = jfft.FourStepFFT(n) if n < 2**21 else None
    if plan is not None:
        assert tfft.fft_factors(n) == (plan.factors if plan.viable else None)
    assert tfft.factorize_for_mxu(n) == jfft.factorize_for_mxu(n)
    assert tfft.best_two_factor(n) == jfft.best_two_factor(n)


@pytest.mark.parametrize("factors", [[100, 128], [32, 16, 16]])
def test_stage_tables_match_jax(factors):
    plan = jfft.FourStepFFT(int(np.prod(factors)), factors=factors)
    w, tw = tfft.stage_tables(factors)
    # the same float64 phases; the two exponentials differ by ~1e-16
    for a, b in zip(w + tw + list(tfft.peak_consts(factors)),
                    plan.stage_w + plan.stage_tw + list(plan._peak_consts())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_peak_winner_matches_jax(rng):
    factors = [8, 8, 8, 8]
    rows = 8 * 8 * 8
    pmax = rng.random((5, rows)).astype(np.float32)
    inner = rng.integers(0, 8, (5, rows)).astype(np.int32)
    # the JAX kernel hands _peak_winner one winner per leading (k0, k1) row,
    # its bin k2 + 8*k3 already rebuilt; the port's rows are (k0, k1, k2)
    p3 = pmax.reshape(5, 64, 8)
    k2 = p3.argmax(-1)
    lead_max = p3.max(-1)
    lead_bin = k2 + 8 * np.take_along_axis(inner.reshape(5, 64, 8),
                                           k2[..., None], -1)[..., 0]
    jpk, jbin = jfft._peak_winner(jnp.asarray(lead_max.reshape(-1)),
                                  jnp.asarray(lead_bin.reshape(-1)), 8 * 8,
                                  factors, (5,))
    pk, bins = tfft.peak_winner(torch.from_numpy(pmax),
                                torch.from_numpy(inner), factors)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbin))


def _tie():
    """(f1, tw) of K1 = 4, J = 8 whose spectra are exactly 8 at row 1's k2 =
    2 (true bin 9: i^t, the radix butterflies multiply by +-1 and +-i
    only) and at row 3's k2 = 0 (true bin 3: all ones), zero elsewhere."""
    f1 = torch.zeros((1, 4, 8), dtype=torch.complex64)
    f1[0, 1] = torch.from_numpy((1j ** np.arange(8)).astype(np.complex64))
    f1[0, 3] = 1.0
    return f1, torch.ones((4, 8), dtype=torch.complex64)


def test_stage2_ties_go_to_the_lowest_bin():
    """Equal magnitudes at true bins 9 (row 1) and 3 (row 3): the port's
    twin and the kernel's schedule return 3, as torch.argmax over the
    natural-order spectrum would; the TPU kernel returns the first row's
    (9)."""
    f1, tw = _tie()
    for pk, bins in (stage2_peak(f1, tw), tfft.stage2_staged(f1, tw)):
        assert float(pk[0]) == 64.0 and int(bins[0]) == 3
    jbin = stage2_caf_peak(jnp.asarray(f1.numpy()), tw.numpy(),
                           tfft.dft_matrix(8), 4, mode="f32",
                           interpret=True)[1]
    assert int(jbin[0]) == 9


def test_stage2_peak_checks_shapes():
    f1 = torch.zeros((2, 4, 8), dtype=torch.complex64)
    tw = torch.ones((4, 8), dtype=torch.complex64)
    with pytest.raises(ValueError):
        stage2_peak(f1, tw[:, :4])
    with pytest.raises(ValueError):          # factors must end in (K1, J)
        stage2_peak(f1, tw, (4, 4))
    with pytest.raises(ValueError):          # 8 rows are not 12-row transforms
        stage2_peak(f1, tw, (3, 4, 8))
    with pytest.raises(ValueError):          # no longer takes a w2
        stage2_peak(f1, tw, torch.eye(8, dtype=torch.complex64))


def test_window_columns_twin_matches_numpy(rng):
    """Stage 1 of the list route: the n1-point DFT down the columns of
    each window viewed as (n1, n2), no twiddle (the column pass's
    unmodulated store), at the route's plan for n = 512 (16 x 32)."""
    plan = sweep_plan(512)
    n1, n2 = plan["factors"]
    assert (n1, n2) == (16, 32)
    rx = (rng.standard_normal(900) + 1j * rng.standard_normal(900)).astype(
        np.complex64)
    cc = (rng.standard_normal(n1 * n2)
          + 1j * rng.standard_normal(n1 * n2)).astype(np.complex64)
    offs = np.array([0, 7, 8, 300, 388])
    w1 = tfft.dft_matrix(n1)
    got = window_columns(torch.from_numpy(rx), torch.from_numpy(cc),
                         torch.from_numpy(offs))
    ref = np.stack([w1.astype(np.complex128)
                    @ (rx[s: s + n1 * n2] * cc).reshape(n1, n2)
                    for s in offs])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    plain = window_columns_plain(torch.from_numpy(rx), torch.from_numpy(cc),
                                 torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("n,batch", [(4096, 128), (12800, 3)])
def test_peak_sweep_matches_numpy(rng, n, batch):
    """The "peak-kernel-hopper" route's algebra on the CPU (stage 1 over the
    offset list, then stage2_peak), chunked, against numpy's FFT."""
    offsets = np.array([0, 2, 3, 7, 30, 31, 64])
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    rx = (0.5 * (rng.standard_normal(offsets[-1] + n)
                 + 1j * rng.standard_normal(offsets[-1] + n))).astype(
        np.complex64)
    rx[7: 7 + n] += (cut * np.exp(2j * np.pi * 333 * np.arange(n) / n)
                     ).astype(np.complex64)
    pk, bins = peak_sweep(torch.from_numpy(rx),
                          torch.from_numpy(np.conj(cut)),
                          torch.from_numpy(offsets), batch)
    cc = np.conj(cut).astype(np.complex128)
    spec = np.abs(np.fft.fft(np.stack([rx[s: s + n] for s in offsets]) * cc)
                  ) ** 2
    np.testing.assert_array_equal(bins.numpy(), spec.argmax(-1))
    np.testing.assert_allclose(pk.numpy(), spec.max(-1), rtol=PEAK_RTOL)
    assert int(bins[3]) == 333


@pytest.mark.parametrize("factors", [(64, 64), (100, 128), (1000, 1000)])
def test_stage2_staged_matches_pallas_kernel_interpret(rng, factors):
    """The Hopper kernel's schedule (twiddle on load, shared-memory row FFT
    over its tables, row peaks, reduction) against the TPU kernel in "f32"
    interpret mode and float64 numpy, with planted peaks: bins exact."""
    n = int(np.prod(factors))
    nrows = 3 if n < 10**6 else 1
    bins = [5, n // 2 + 3, n - 17][:nrows]
    x = _rows(rng, nrows, n, bins)
    f1 = leading_stages_plain(torch.from_numpy(x), list(factors))
    tw, w2 = tfft.peak_consts(factors)
    pk, got = tfft.stage2_staged(f1, torch.from_numpy(tw))
    assert pk.dtype == torch.float32 and got.tolist() == bins
    ref = np.abs(np.fft.fft(x.astype(np.complex128))) ** 2
    np.testing.assert_array_equal(got.numpy(), ref.argmax(-1))
    np.testing.assert_allclose(pk.numpy(), ref.max(-1), rtol=PEAK_RTOL)
    if n < 10**6:                # the interpreted TPU kernel at small n
        jpk, jbin = stage2_caf_peak(jnp.asarray(f1.numpy()), tw, w2.T,
                                    factors[0], mode="f32", interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbin))
        np.testing.assert_allclose(pk.numpy(), np.asarray(jpk),
                                   rtol=PEAK_RTOL)


@pytest.mark.parametrize("factors", [(32, 16, 16), (8, 8, 8, 8)])
def test_stage2_staged_folds_deeper_plans(rng, factors):
    """A deeper plan's leading rows folded into the batch: the schedule's
    true bins against ``FourStepFFT.call_peak`` (f32, interpret) and the
    twin."""
    n = int(np.prod(factors))
    x = _rows(rng, 3, n, [7, n // 3 + 1, n - 2])
    f1 = leading_stages_plain(torch.from_numpy(x), list(factors))
    tw = torch.from_numpy(tfft.peak_consts(factors)[0])
    pk, bins = tfft.stage2_staged(f1, tw, factors)
    ppk, pbins = stage2_peak_plain(f1, tw, factors)
    jpk, jbin = jfft.FourStepFFT(n, factors=list(factors)).call_peak(
        jnp.asarray(x), mode="f32", interpret=True)
    assert bins.tolist() == pbins.tolist() == np.asarray(jbin).tolist() \
        == [7, n // 3 + 1, n - 2]
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=PEAK_RTOL)
    np.testing.assert_allclose(pk.numpy(), ppk.numpy(), rtol=PEAK_RTOL)


@pytest.mark.parametrize("n,offsets", [
    (65536, [0, 5, 6, 11, 40, 77]),        # 256 x 256
    (12800, [1, 2, 9]),                    # 100 x 128
    (4096, [0, 3, 4]),                     # fits one block: split 64 x 64
])
def test_peak_sweep_staged_matches_caf3_plain(rng, n, offsets):
    """The list route's schedule (column pass stored without its twiddle,
    then the kernel's twiddle-on-load row pass) against the shift-list
    twin ``caf3_peak_plain`` (torch.fft) on a listed sweep: bins exact,
    peaks within PEAK_RTOL; the route's CPU call agrees too."""
    i_star = len(offsets) // 2
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    rx = (0.5 * (rng.standard_normal(offsets[-1] + n)
                 + 1j * rng.standard_normal(offsets[-1] + n))).astype(
        np.complex64)
    s = offsets[i_star]
    rx[s: s + n] += (cut * np.exp(2j * np.pi * (n // 3) * np.arange(n) / n)
                     ).astype(np.complex64)
    args = (torch.from_numpy(rx), torch.from_numpy(np.conj(cut)),
            torch.tensor(offsets))
    pk, bins = tfft.peak_sweep_staged(*args)
    ppk, pbins = caf3_peak_plain(*args)
    np.testing.assert_array_equal(bins.numpy(), pbins.numpy())
    np.testing.assert_allclose(pk.numpy(), ppk.numpy(), rtol=PEAK_RTOL)
    assert int(torch.argmax(pk)) == i_star and int(bins[i_star]) == n // 3
    rpk, rbins = peak_sweep(*args)
    np.testing.assert_array_equal(rbins.numpy(), bins.numpy())
    np.testing.assert_allclose(rpk.numpy(), pk.numpy(), rtol=PEAK_RTOL)
