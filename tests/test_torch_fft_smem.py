"""The shared-memory FFT of the CAF kernels #2 and #3 on the CPU.

``ops/fft.fft_staged`` and ``caf_staged`` run the kernels' pass schedule
(``csrc/fft_smem.cuh``: Stockham radix stages, column passes with the
four-step twiddle, row passes with each row's peak, the reduction) in torch
over the very f32 tables the kernels read. They are held against float64
``numpy.fft`` and against the JAX package's Pallas CAF kernel itself
(``fused_freq_scan_xcorr``, "f32" mode, interpret). Tolerances: a line FFT
within rtol 1e-5 of numpy, elementwise with an absolute floor of 1e-5 x the
largest output (f32 tables, one rounding per stage: ~2e-7 measured, 3e-6
for the generic radix 4099); peak |X|^2 rtol 1e-5 against numpy; QF^2 rtol
1e-4 against the Pallas kernel (tests/test_torch_xcorr.py's bound); peak
shifts and bins exact. ``caf_plan`` is held to the shared-memory limits the
kernels check (``read_plan``) at every size the two routes take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu_torch.ops import fft as tfft
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (CafLaunch,
                                                            caf_peak)

FFT_RTOL = 1e-5
PEAK_RTOL = 1e-5
QF2_RTOL = 1e-4
# an H100 block's shared memory (227 KB)
SMEM_BYTES = 232448


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("length", [8, 1000, 1024, 3125, 3200, 8192,
                                    7 * 11 * 13, 2 * 4099])
def test_fft_staged_matches_numpy(rng, length):
    x = _cplx(rng, 3, length)
    got = tfft.fft_staged(torch.from_numpy(x)).numpy()
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, rtol=FFT_RTOL,
                               atol=FFT_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("length,radices", [
    (8192, (8, 8, 8, 8, 2)), (1000, (8, 5, 5, 5)), (3200, (8, 8, 2, 5, 5)),
    (1024, (8, 8, 8, 2)), (12, (4, 3)), (1001, (7, 11, 13)),
    (8198, (2, 4099)), (16, (8, 2)), (32, (8, 4)),
])
def test_radix_plan(length, radices):
    assert tfft.radix_plan(length) == radices
    assert int(np.prod(radices)) == length


def _smem(plan, i):
    """Shared-memory bytes of pass i's block (csrc/fft_smem.cuh
    smem_bytes): lines of stride L | 1, doubled for a generic radix."""
    length, lines = plan["factors"][i], plan["lines"][i]
    generic = any(r not in tfft.FAST_RADICES for r in plan["radices"][i])
    return lines * (length | 1) * 8 * (2 if generic else 1)


@pytest.mark.parametrize("n,factors", [
    (1024, (1024,)), (4096, (4096,)), (65536, (256, 256)),
    (1_000_000, (1000, 1000)), (2**21, (1024, 2048)), (5**9, (625, 3125)),
    (5**10, (3125, 3125)), (10_000_000, (1250, 8000)), (3**13, (729, 2187)),
    (2 * 4099, (2, 4099)), (97 * 101 * 103, (97, 101, 103)),
])
def test_caf_plan_fits_shared_memory(n, factors):
    plan = tfft.caf_plan(n)
    assert plan["factors"] == factors
    assert int(np.prod(plan["factors"])) == n
    for i, f in enumerate(plan["factors"]):
        assert f <= tfft.SMEM_LINE_MAX
        assert 1 <= plan["lines"][i]
        assert plan["lines"][i] * f <= tfft.SMEM_LINE_MAX
        assert int(np.prod(plan["radices"][i])) == f
        assert _smem(plan, i) <= SMEM_BYTES
    # the fewest passes: one when the window fits a block, two when any
    # two-factor split fits, three only otherwise
    two = [d for d in range(2, tfft.SMEM_LINE_MAX + 1)
           if n % d == 0 and n // d <= tfft.SMEM_LINE_MAX]
    want = 1 if n <= tfft.SMEM_LINE_MAX else (2 if two else 3)
    assert len(plan["factors"]) == want


def test_caf_plan_refuses_what_no_block_holds():
    assert tfft.caf_plan(1) is None
    assert tfft.caf_plan(10_000_019) is None          # a prime > 8192
    assert tfft.caf_plan(3 * 8209) is None            # a prime factor > 8192


def test_plan_ints_layout():
    """The int array the C entry points read (csrc/fft_smem.cuh
    read_plan)."""
    plan = tfft.caf_plan(10_000_000)
    ints = tfft.plan_ints(plan)
    per = 2 + tfft.MAX_RADICES
    assert len(ints) == 7 + 3 * per
    assert ints[:7] == [2, 1250, 8000, 0, 6, 1, 0]
    for i, f in enumerate((1250, 8000)):
        q = ints[7 + i * per: 7 + (i + 1) * per]
        assert q[0] == f and q[1] == len(tfft.radix_plan(f))
        assert tuple(q[2: 2 + q[1]]) == tfft.radix_plan(f)
    launch = CafLaunch(65536, torch.device("cpu"))
    assert [t is None for t in launch.tables] == [False, False, True, False,
                                                  True, False, False, True]
    assert launch.tables[3].shape == (256, 256)
    assert launch.scratch_bytes(13) == 13 * 65536 * 8
    assert CafLaunch(1024, torch.device("cpu")).scratch_bytes(13) == 0


@pytest.mark.parametrize("length", [1000, 8192, 1001])
def test_line_table_matches_float64(length):
    """The line table: W_L^m for m < L, then each stage's twiddles W_L^(k *
    jr * L/(Ns*R)) in rows k = 1..R-1 of Ns entries; each entry one f32
    rounding of the float64 exponential."""
    radices = tfft.radix_plan(length)
    table = tfft.line_table(length).astype(np.complex128)
    phases, ns = [np.arange(length)], 1
    for r in radices:
        for k in range(1, r):
            phases.append(k * np.arange(ns) * (length // (ns * r)))
        ns *= r
    phases = np.concatenate(phases)
    assert table.shape == phases.shape
    assert np.abs(table - np.exp(-2j * np.pi * phases / length)).max() < 1e-7


def _scene(rng, n, nshifts, plant_at, f_bin):
    cut = _cplx(rng, n)
    rx = (0.5 * _cplx(rng, n + nshifts + 8)).astype(np.complex64)
    rx[plant_at: plant_at + n] += (cut * np.exp(
        2j * np.pi * f_bin * np.arange(n) / n)).astype(np.complex64)
    return cut, rx


def _truth(cut, rx, shifts):
    n = cut.shape[0]
    w = np.stack([rx[s: s + n] for s in shifts]).astype(np.complex128)
    spec = np.abs(np.fft.fft(w * np.conj(cut))) ** 2
    return spec.max(-1), spec.argmax(-1)


# (n, emax): the kernels' own plan, and smaller blocks that force the same
# schedule into two and three passes at a test's size
PLANS = [(4096, tfft.SMEM_LINE_MAX), (4096, 1024), (4096, 32)]


@pytest.fixture(scope="module")
def pallas_4096():
    """The TPU kernel itself ("f32" mode, interpret) at n = 4096 over 6
    shifts of a scene planted at shift 2, bin 901."""
    from pydsproutines_tpu.ops.pallas.fused_xcorr import fused_freq_scan_xcorr
    rng = np.random.default_rng(4096)
    cut, rx = _scene(rng, 4096, 6, 2, 901)
    jq, jb = fused_freq_scan_xcorr(jnp.asarray(cut), jnp.asarray(rx), 0, 6,
                                   batch=8, step=1, mode="f32",
                                   interpret=True)
    return cut, rx, np.asarray(jq), np.asarray(jb).astype(np.int64)


@pytest.mark.parametrize("n,emax", PLANS)
def test_caf_staged_matches_pallas_kernel_interpret(pallas_4096, n, emax):
    cut, rx, jq, jb = pallas_4096
    plan = tfft.caf_plan(n, emax)
    assert len(plan["factors"]) == {8192: 1, 1024: 2, 32: 3}[emax]
    shifts = torch.arange(6)
    pk, bins = tfft.caf_staged(torch.from_numpy(rx),
                               torch.from_numpy(np.conj(cut)), shifts, plan)
    assert pk.dtype == torch.float32 and bins.dtype == torch.int64
    rxn = np.array([np.sum(np.abs(rx[s: s + n].astype(np.complex128)) ** 2)
                    for s in range(6)])
    q = pk.numpy() / np.sum(np.abs(cut.astype(np.complex128)) ** 2) / rxn
    np.testing.assert_array_equal(bins.numpy(), jb)
    assert int(np.argmax(q)) == int(np.argmax(jq)) == 2
    assert int(bins[2]) == 901
    np.testing.assert_allclose(q, jq, rtol=QF2_RTOL)


@pytest.mark.parametrize("n,emax,offsets", [
    (19683, tfft.SMEM_LINE_MAX, [0, 3, 5, 9]),   # 81 x 243: radix 3 only
    (15625, tfft.SMEM_LINE_MAX, [1, 2, 4]),      # 5^6 = 25 x 625
    (17280, 64, [0, 1, 7]),                      # three passes, radices 2-8
    (7 * 11 * 13 * 4, tfft.SMEM_LINE_MAX, [0, 2]),   # one pass, generic
    (2 * 4099, tfft.SMEM_LINE_MAX, [0, 5]),      # generic radix 4099 rows
])
def test_caf_staged_matches_numpy(rng, n, emax, offsets):
    cut, rx = _scene(rng, n, offsets[-1] + 1, offsets[1], n // 3)
    plan = tfft.caf_plan(n, emax)
    pk, bins = tfft.caf_staged(torch.from_numpy(rx),
                               torch.from_numpy(np.conj(cut)),
                               torch.tensor(offsets), plan)
    tpk, tbin = _truth(cut, rx, offsets)
    np.testing.assert_array_equal(bins.numpy(), tbin)
    np.testing.assert_allclose(pk.numpy(), tpk, rtol=PEAK_RTOL)
    assert int(bins[1]) == n // 3


@pytest.mark.parametrize("n,emax", PLANS + [(65536, tfft.SMEM_LINE_MAX)])
@pytest.mark.parametrize("window", ["zero", "impulse"])
def test_caf_ties_go_to_bin_0(n, emax, window):
    """A window whose spectrum is flat: all zeros, or an impulse at its
    first sample (every |X[k]|^2 exactly 1: each stage multiplies it by
    W^0 = 1 and adds zeros). Every bin ties; the lowest, 0, wins in the
    staged schedule, and for the zero window in caf_peak's twin on CPU
    tensors too (pocketfft leaves an impulse's spectrum flat only to f32
    rounding, so it picks another bin there)."""
    rx = torch.zeros(n + 3, dtype=torch.complex64)
    if window == "impulse":
        rx[0] = 1.0
    cc = torch.ones(n, dtype=torch.complex64)
    pk, bins = tfft.caf_staged(rx, cc, torch.tensor([0]),
                               tfft.caf_plan(n, emax))
    assert float(pk[0]) == (1.0 if window == "impulse" else 0.0)
    assert int(bins[0]) == 0
    if window == "zero":
        tm, tb = caf_peak(rx, cc, 0, 1, 1)
        assert int(tb[0]) == 0 and float(tm[0]) == 0.0
