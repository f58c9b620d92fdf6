"""The Hopper kernels against their plain twins on the card (marker ``gpu``;
skipped where there is no CUDA device). Run on a GPU machine with

    python -m pytest tests/test_torch_hopper.py -q -m gpu --noconftest

(``--noconftest`` leaves out tests/conftest.py, which imports JAX; these
tests need only the port.)

Tolerances are chip_smoke.py's: WOLA max|d|/max|ref| < 1e-5; CAF per-shift
peak |X|^2 rtol 1e-4 with the planted shift and bin exact (at a noise-only
shift the top two bins can lie within f32 rounding, so only the planted
shift's bin is held exact); upfirdn max|d|/max|ref| < 1e-5 against the twin
and ``upfirdn_staged`` (its schedule in torch) in float32 (f32 FMA chains of up to a few hundred taps against a full-f32
matrix product), 1e-9 absolute in float64, and
``tests/test_filters.py``'s scipy bound; medfilt bit-equal (``torch.equal``);
group CAF |C|^2 per-shift peak rtol 1e-4 and the grid within 1e-4 of its
max (the kernel's 3xTF32 products, f32 sums of G*m of them in another
order), the planted shift and bin exact, and against
``group_caf_staged``, its own arithmetic in torch, within 2e-5 of each
row's maximum (the tensor cores' accumulation in another order); the
last-stage peak kernel within 1e-5 of ``stage2_staged``; sliding QF^2
max|d| < 1e-5 on its 0..1 scale (f32 window energies summed in the kernel
vs the twin's float64 window sums), and the overlap-save route within 1e-6
of ``sliding_staged``, its schedule in torch over the same tables (f32
rounding in another order); medfilt routes bit-equal to ``medfilt_staged``.
The WOLA kernel is also held within 1e-5 of ``wola_staged``, its schedule
in torch, and its plane-I/O instance bit-equal to its complex instance (one
fold and FFT); ``FourStepFFT.call_peak`` (torch.fft leading stages, then
kernel #4) is held to the twin's bins and within 1e-4 of its peaks. The plain twins' matrix products run in full f32 (TF32 off).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from pydsproutines_tpu_torch.ops.fft import (FourStepFFT, get_fft_plan,
                                             peak_consts, stage2_staged)
from pydsproutines_tpu_torch.ops.hopper.fft_peak import (
    leading_stages_plain, peak_sweep, stage2_peak, stage2_peak_plain,
    window_columns, window_columns_plain)
from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import (caf3_peak,
                                                           caf3_peak_plain)
from pydsproutines_tpu_torch.ops.detection import (BurstDetector,
                                                   energy_detection)
from pydsproutines_tpu_torch.ops.filters import (fir_upfirdn_planes_flat,
                                                 lfilter_fir, medfilt, upfirdn)
from pydsproutines_tpu_torch.ops.groupxcorr import (GroupXcorrCZT,
                                                    select_group_caf_path)
from pydsproutines_tpu_torch.ops.hopper.group_caf import (group_caf,
                                                          group_caf_plain,
                                                          group_caf_staged,
                                                          tf32_planes)
from pydsproutines_tpu_torch.ops.hopper.sliding import (
    sliding_multiply_normalised, sliding_multiply_normalised_reference,
    sliding_plain)
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (caf_peak,
                                                            caf_peak_plain)
from pydsproutines_tpu_torch.ops.hopper.medfilt import (medfilt_kernel,
                                                        medfilt_plain)
from pydsproutines_tpu_torch.ops.filters import select_upfirdn_path
from pydsproutines_tpu_torch.ops.hopper.upfirdn import (get_upfirdn_size,
                                                        upfirdn_plan,
                                                        upfirdn_planes,
                                                        upfirdn_planes_plain,
                                                        upfirdn_staged)
from pydsproutines_tpu_torch.ops.hopper.wola_fused import (wola_fused,
                                                           wola_fused_planes,
                                                           wola_plain,
                                                           wola_plan,
                                                           wola_staged)
from pydsproutines_tpu_torch.ops.wola import (_wola_planes_impl,
                                              select_wola_path,
                                              wola_planes_flat)
from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,taps,rows", [
    (64, 2048, 1000), (64, 512, 777), (128, 1024, 300), (256, 2048, 129),
    (16, 128, 50), (64, 64, 10),         # B = 1
])
def test_wola_kernel_matches_twin(cuda, n, taps, rows):
    rng = np.random.default_rng(n + taps + rows)
    h = torch.from_numpy(rng.standard_normal(taps).astype(np.float32)).to(cuda)
    x = torch.from_numpy((rng.standard_normal(rows * n + 3)
                          + 1j * rng.standard_normal(rows * n + 3))
                         .astype(np.complex64)).to(cuda)
    before = wola_fused.launches
    got = wola_fused(h, x, n)
    ref = wola_plain(h, x, n, n)
    torch.cuda.synchronize()
    assert wola_fused.launches == before + 1
    assert got.shape == (rows, n)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("n,nb,rows", [
    (1, 8, 700), (8, 2, 333), (12, 8, 250), (60, 2, 101), (64, 32, 1001),
    (64, 1, 77), (128, 8, 129), (256, 8, 40), (256, 8, 32768), (7, 3, 90),
    (64, 33, 500), (1024, 2, 20),
])
def test_wola_kernel_routes_and_geometries(cuda, n, nb, rows):
    """N with prime factors (12, 60, a generic 7), N = 1, B from 1 to 33,
    rows that leave a ragged last chunk, N = 256 at 2048 taps at its real
    length: the kernel against the twin and against ``wola_staged``, one
    launch, the route named by the router."""
    rng = np.random.default_rng(n * 100 + nb + rows)
    h = torch.from_numpy(rng.standard_normal(n * nb).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal(rows * n + n // 2)
                          + 1j * rng.standard_normal(rows * n + n // 2))
                         .astype(np.complex64))
    before = wola_fused.launches
    got = wola_fused(h.to(cuda), x.to(cuda), n)
    torch.cuda.synchronize()
    assert wola_fused.launches == before + 1
    assert got.shape == (rows, n)
    ref = wola_plain(h, x, n, n)
    assert float((got.cpu() - ref).abs().max() / ref.abs().max()) < 1e-5
    if rows <= 2000:
        staged = wola_staged(h, x, n)
        assert float((got.cpu() - staged).abs().max()
                     / staged.abs().max()) < 1e-5
    path, reason = select_wola_path(n, n, cuda, n * nb)
    assert path == "fused-hopper" and wola_plan(n, nb)["route"] == "fold-fft"
    assert "register fold" in reason and "shared-memory FFT" in reason


@pytest.mark.parametrize("n,taps,rows,tail", [
    (64, 2048, 1001, 0), (64, 512, 777, 13), (128, 1024, 300, 5),
    (256, 2048, 129, 0), (12, 96, 250, 7), (1, 8, 700, 0),
])
def test_wola_plane_instance_equals_the_complex_instance(cuda, n, taps, rows,
                                                         tail):
    """The plane-I/O instance against the complex instance on the same
    samples (bit-equal: one fold and FFT) and against its plain version
    (1e-5), through ``wola_planes_flat`` with a length that is not a
    multiple of N; one launch each, the plane route."""
    rng = np.random.default_rng(n + taps + rows)
    h = torch.from_numpy(rng.standard_normal(taps).astype(np.float32)).to(cuda)
    re, im = (torch.from_numpy(rng.standard_normal(rows * n + tail)
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    before = (wola_fused_planes.launches, wola_fused.launches)
    p_re, p_im = wola_fused_planes(h, re, im, n)
    c = wola_fused(h, torch.complex(re, im), n)
    (f_re, f_im), route = _wola_planes_impl(h, re, im, n)
    ref = wola_plain(h, torch.complex(re, im), n, n)
    torch.cuda.synchronize()
    assert (wola_fused_planes.launches, wola_fused.launches) == (
        before[0] + 2, before[1] + 1)
    assert route[0] == "fused-planes-hopper"
    assert p_re.shape == (rows, n) and p_re.dtype == torch.float32
    assert torch.equal(p_re, c.real) and torch.equal(p_im, c.imag)
    assert torch.equal(f_re, p_re) and torch.equal(f_im, p_im)
    flat = wola_planes_flat(h, re, im, n)
    assert flat[0].shape == (rows * n,) and torch.equal(flat[0],
                                                         p_re.reshape(-1))
    got = torch.complex(p_re, p_im)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_wola_plane_instance_refuses_what_it_does_not_take(cuda):
    h = torch.ones(128, device=cuda)
    re = torch.zeros(64 * 8, device=cuda)
    before = wola_fused_planes.launches
    with pytest.raises(ValueError, match="float32"):
        wola_fused_planes(h, re.double(), re.double(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        wola_fused_planes(h, re[::2], re[::2], 32)
    with pytest.raises(ValueError, match="taps on"):
        wola_fused_planes(h.cpu(), re, re, 64)
    assert wola_fused_planes.launches == before


@pytest.mark.parametrize("batch,n", [(16, 2**20), (1, 10_000_000),
                                     (3, 40960)])
def test_call_peak_launches_kernel_4_and_matches_its_twin(cuda, batch, n):
    """``FourStepFFT.call_peak`` (torch.fft leading stages, then kernel #4)
    against the twin ``leading_stages_plain`` + ``stage2_peak_plain`` at
    the plans [1024, 1024], [200, 200, 250] (J = 250 rows, 40,000 rows a
    transform) and [40, 32, 32]: bins equal to the planted tones, peaks
    within 1e-4; one launch a call."""
    plan = get_fft_plan(n) if n != 40960 else FourStepFFT(n, factors=[40, 32,
                                                                       32])
    rng = np.random.default_rng(batch)
    bins = (np.arange(batch) * 7919 + 123) % n
    x = torch.from_numpy((0.5 * (rng.standard_normal((batch, n))
                                 + 1j * rng.standard_normal((batch, n))))
                         .astype(np.complex64)).to(cuda)
    t = torch.arange(n, device=cuda, dtype=torch.float64)
    for r, k in enumerate(bins.tolist()):
        x[r] += torch.exp(2j * np.pi * k * t / n).to(torch.complex64)
    before = stage2_peak.launches
    km, kb = plan.call_peak(x)
    torch.cuda.synchronize()
    assert stage2_peak.launches == before + 1
    f1 = leading_stages_plain(x, plan.factors)
    tw = torch.from_numpy(peak_consts(plan.factors)[0]).to(cuda)
    pm, pb = stage2_peak_plain(f1, tw, plan.factors)
    assert kb.tolist() == pb.tolist() == bins.tolist()
    assert float(((km - pm).abs() / pm).max()) < 1e-4
    km2, kb2 = plan.call_peak_planes(x.real.contiguous(),
                                     x.imag.contiguous(), mode="f32")
    assert torch.equal(km2, km) and torch.equal(kb2, kb)


def test_call_peak_refuses_a_plan_kernel_4_does_not_take(cuda):
    before = stage2_peak.launches
    with pytest.raises(ValueError, match="no plan of kernel #4"):
        FourStepFFT(2048).call_peak(torch.zeros(2048, dtype=torch.complex64,
                                                device=cuda))
    assert stage2_peak.launches == before


@pytest.mark.parametrize("n,step,nshifts,batch", [
    (1024, 1, 256, 128), (4096, 3, 40, 16), (1000, 1, 33, 8),
    (65536, 2, 12, 12),
    (8192, 1, 20, 8), (512, 1, 301, 128),    # one pass, 1 and 4 per block
    (3**13, 2, 6, 6), (1_000_000, 1, 8, 8),  # radices 3; 8 and 5
    (2 * 4099, 1, 10, 10),                   # a generic radix (4099)
])
def test_caf_kernel_matches_twin(cuda, n, step, nshifts, batch):
    rng = np.random.default_rng(n + step)
    cut = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    rxlen = (nshifts - 1) * step + n + 5
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    s_star, f_star = 3 * step, n // 3
    rx[s_star: s_star + n] += cut * np.exp(2j * np.pi * f_star
                                           * np.arange(n) / n)
    cc = torch.from_numpy(np.conj(cut).astype(np.complex64)).to(cuda)
    rxt = torch.from_numpy(rx.astype(np.complex64)).to(cuda)
    km, kb = caf_peak(rxt, cc, 0, step, nshifts, batch)
    pm, pb = caf_peak_plain(rxt, cc, 0, step, nshifts, batch)
    torch.cuda.synchronize()
    assert float(((km - pm).abs() / pm).max()) < 1e-4
    assert int(torch.argmax(km)) == int(torch.argmax(pm)) == 3
    assert int(kb[3]) == int(pb[3]) == f_star


@pytest.mark.parametrize("n", [1024, 65536, 97 * 101 * 103])
def test_caf_peak_ties_go_to_the_lowest_bin(cuda, n):
    """Flat spectra. A zero rx: every bin of every shift ties, and both
    versions return bin 0. An impulse at the first sample of the first
    window: every |X[k]|^2 is exactly 1 in the kernels' arithmetic (each
    stage multiplies it by W^0 = 1 and adds zeros), so bin 0 wins; the
    twin's library FFT is flat only to f32 rounding there, so it is not
    compared."""
    rx = torch.zeros(n + 4, dtype=torch.complex64, device=cuda)
    cc = torch.ones(n, dtype=torch.complex64, device=cuda)
    km, kb = caf_peak(rx, cc, 0, 1, 5)
    pm, pb = caf_peak_plain(rx, cc, 0, 1, 5)
    torch.cuda.synchronize()
    assert kb.tolist() == pb.tolist() == [0] * 5
    assert km.tolist() == pm.tolist() == [0.0] * 5
    rx[0] = 1.0
    for km, kb in (caf_peak(rx, cc, 0, 1, 1),
                   caf3_peak(rx, cc, torch.zeros(1, dtype=torch.int64,
                                                 device=cuda))):
        assert float(km[0]) == 1.0 and int(kb[0]) == 0


def _planted(rng, n, rxlen, s_star, f_star):
    cut = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    rx[s_star: s_star + n] += cut * np.exp(2j * np.pi * f_star
                                           * np.arange(n) / n)
    return (torch.from_numpy(np.conj(cut).astype(np.complex64)),
            torch.from_numpy(rx.astype(np.complex64)))


def _hold(km, kb, pm, pb, i_star, f_star):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(km).all())
    assert float(((km - pm).abs() / pm).max()) < 1e-4
    assert int(torch.argmax(km)) == int(torch.argmax(pm)) == i_star
    assert int(kb[i_star]) == int(pb[i_star]) == f_star


@pytest.mark.parametrize("n,offsets,rx_tail", [
    (2**21, list(range(0, 12)), 5),                  # 128 x 128 x 128
    (5**9, list(range(0, 27, 3)), 2),                # 125^3, odd step
    (5**10, list(range(1000, 1004)), 0),             # shifts[0] > 0, rx ends
    (2**21, [0, 3, 4, 9, 40, 41], 0),                # at the last window;
    (10_000_000, [0, 7, 9], 0),                      # a shift list; 10M
    (3**13, [0, 2, 5, 6], 1),                        # 729 x 2187
    (8192, [3, 4, 9], 0),                            # one pass
    (2 * 4099, [0, 1, 4], 0),                        # generic radix 4099
    (97 * 101 * 103, [0, 5, 6], 0),                  # three passes
])
def test_caf3_kernel_matches_twin(cuda, n, offsets, rx_tail):
    rng = np.random.default_rng(n % 1000 + len(offsets))
    i_star, f_star = len(offsets) // 2, n // 7
    rxlen = offsets[-1] + n + rx_tail
    cc, rx = _planted(rng, n, rxlen, offsets[i_star], f_star)
    cc, rx = cc.to(cuda), rx.to(cuda)
    offs = torch.tensor(offsets, device=cuda)
    before = caf3_peak.launches
    km, kb = caf3_peak(rx, cc, offs, 128)
    pm, pb = caf3_peak_plain(rx, cc, offs, 128)
    assert caf3_peak.launches > before
    _hold(km, kb, pm, pb, i_star, f_star)


@pytest.mark.parametrize("factors", [(100, 128), (64, 64), (1000, 1000),
                                     (32, 16, 16), (8, 8, 8, 8), (2, 4099),
                                     (16, 8000)])
def test_stage2_peak_kernel_matches_twin(cuda, factors):
    n = int(np.prod(factors))
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    bins = [5, n // 2 + 3, n - 17, n // 3]
    for r, k in enumerate(bins):
        x[r] += 40.0 * np.exp(2j * np.pi * k * np.arange(n) / n)
    f1 = leading_stages_plain(torch.from_numpy(x).to(cuda), list(factors))
    tw = torch.from_numpy(peak_consts(factors)[0]).to(cuda)
    before = stage2_peak.launches
    km, kb = stage2_peak(f1, tw, factors)
    pm, pb = stage2_peak_plain(f1, tw, factors)
    sm, sb = stage2_staged(f1, tw, factors)
    torch.cuda.synchronize()
    assert stage2_peak.launches == before + 1
    assert float(((km - pm).abs() / pm).max()) < 1e-4
    assert float(((km - sm).abs() / sm).max()) < 1e-5
    assert kb.tolist() == pb.tolist() == sb.tolist() == bins


def test_stage2_peak_ties_go_to_the_lowest_bin(cuda):
    """Spectra exactly 8 at true bins 1 + 4*2 = 9 (row 1: i^t) and
    3 + 4*0 = 3 (row 3: all ones), K1 = 4, J = 8: both versions return
    bin 3, though bin 9's row comes first."""
    k1, j = 4, 8
    f1 = torch.zeros((1, k1, j), dtype=torch.complex64)
    f1[0, 1] = torch.from_numpy((1j ** np.arange(j)).astype(np.complex64))
    f1[0, 3] = 1.0
    tw = torch.ones((k1, j), dtype=torch.complex64)
    got = stage2_peak(f1.to(cuda), tw.to(cuda))
    ref = stage2_peak_plain(f1, tw)
    assert float(got[0][0]) == 64.0
    assert int(got[1][0]) == int(ref[1][0]) == 3


@pytest.mark.parametrize("n", [4096, 1_000_000])
def test_peak_sweep_matches_twin(cuda, n):
    rng = np.random.default_rng(n + 1)
    offsets = np.sort(rng.choice(3 * 16, 16, replace=False))
    cc, rx = _planted(rng, n, int(offsets[-1]) + n, int(offsets[9]), n // 5)
    cc, rx = cc.to(cuda), rx.to(cuda)
    offs = torch.from_numpy(offsets).to(cuda)
    s1 = window_columns(rx, cc, offs)
    s1p = window_columns_plain(rx, cc, offs)
    torch.cuda.synchronize()
    assert float((s1 - s1p).abs().max() / s1p.abs().max()) < 1e-5
    before = (stage2_peak.launches, window_columns.launches)
    km, kb = peak_sweep(rx, cc, offs, 128)
    pm, pb = caf3_peak_plain(rx, cc, offs, 128)
    assert stage2_peak.launches > before[0]
    assert window_columns.launches > before[1]
    _hold(km, kb, pm, pb, 9, n // 5)


@pytest.mark.parametrize("n,shifts,route", [
    (2**21, list(range(8)), "fused3-hopper"),
    (65536, [0, 2, 3, 7, 30, 31], "peak-kernel-hopper"),
    (4096, [0, 2, 3, 7, 30, 31], "fused3-hopper"),   # one block: one pass
])
def test_fast_xcorr_routes_launch_and_match_cpu(cuda, n, shifts, route):
    rng = np.random.default_rng(n + len(shifts))
    cc, rx = _planted(rng, n, shifts[-1] + n, shifts[3], 77)
    cut = cc.conj().resolve_conj()
    counter = caf3_peak if route == "fused3-hopper" else stage2_peak
    before = counter.launches
    gq, gb = fast_xcorr(cut.to(cuda), rx.to(cuda), True, shifts=shifts)
    torch.cuda.synchronize()
    assert counter.launches > before
    cq, cb = fast_xcorr(cut, rx, True, shifts=shifts)
    np.testing.assert_allclose(gq.cpu().numpy(), cq.numpy(), rtol=1e-4)
    assert int(torch.argmax(gq)) == int(torch.argmax(cq)) == 3
    assert int(gb[3]) == int(cb[3]) == 77


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("up,down,taps", [
    (5, 4, 95), (5, 4, 730), (3, 2, 41), (1, 4, 257), (2, 3, 16),
])
def test_upfirdn_kernel_matches_twin(cuda, up, down, taps):
    """The JAX kernel test's geometries (tests/test_filters.py:165), both
    planes of a complex64 input read in place in one launch."""
    rng = np.random.default_rng(up * 1000 + taps)
    cols = 128 * (up // np.gcd(up, down))
    n = int(np.ceil(2 * 128 * cols * down / up)) + 777
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    h = rng.standard_normal(taps).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    ht = torch.from_numpy(h).to(cuda)
    before = upfirdn_planes.launches
    got = upfirdn(ht, xt, up, down)
    assert upfirdn_planes.launches == before + 1
    ref = upfirdn_planes_plain((xt.real, xt.imag), ht, up, down)
    torch.cuda.synchronize()
    assert got.shape == (get_upfirdn_size(n, taps, up, down),)
    assert _rel(torch.view_as_real(got), torch.stack(ref, -1)) < 1e-5
    truth = sps.upfirdn(h.astype(np.float64), x.astype(np.complex128), up,
                        down)
    np.testing.assert_allclose(got.cpu().numpy(), truth,
                               atol=2e-4 * np.sqrt(taps), rtol=1e-4)


@pytest.mark.parametrize("up,down,taps,n,n_out,layout", [
    (1, 1, 33, 5000, None, "complex"), (1, 4, 257, 9000, None, "complex"),
    (5, 4, 730, 20_000, None, "complex"), (4, 5, 95, 7777, None, "separate"),
    (3, 1, 2, 3001, None, "complex"),        # taps < up
    (7, 3, 130, 4000, 9000, "complex"),      # n_out past the full length
    (5, 4, 730, 20_000, 12_345, "separate"),  # n_out override, cut
    (2, 3, 16, 1, None, "complex"), (8, 7, 5, 300, None, "stride2"),
    (1, 1, 30_000, 3000, None, "complex"),   # unstaged: taps past the budget
])
def test_upfirdn_kernel_routes_and_edges(cuda, up, down, taps, n, n_out,
                                         layout):
    """The register-window routes at the phase ratios, both edges, the
    n_out override, two planes as float2 (the parts of a complex64 tensor,
    read as one; separate planes; strided planes) and the unstaged route: against the twin, against
    ``upfirdn_staged`` (the same schedule in torch) and against float64
    scipy, with one launch and the plan's route."""
    rng = np.random.default_rng(up * 1000 + down * 10 + taps + n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    h = rng.standard_normal(taps).astype(np.float32)
    ht = torch.from_numpy(h).to(cuda)
    if layout == "complex":
        xt = torch.from_numpy(x).to(cuda)
        planes = (xt.real, xt.imag)
    elif layout == "separate":
        planes = tuple(torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
                       for p in (x.real, x.imag))
    else:                                     # every other sample of a plane
        wide = torch.from_numpy(np.stack([x.real, x.imag], -1).reshape(
            -1)).to(cuda).repeat_interleave(2)
        planes = (wide[0::4], wide[2::4])
    full = get_upfirdn_size(n, taps, up, down)
    n_out = full if n_out is None else n_out
    before = upfirdn_planes.launches
    got = upfirdn_planes(planes, ht, up, down, n_out)
    torch.cuda.synchronize()
    assert upfirdn_planes.launches == before + 1
    got = torch.stack(got).cpu()
    assert got.shape == (2, n_out)
    cpu = tuple(p.cpu() for p in planes)
    ref = torch.stack(upfirdn_planes_plain(cpu, torch.from_numpy(h), up, down,
                                           n_out))
    assert _rel(got, ref) < 1e-5
    plan = upfirdn_plan(taps, up, down, 4, 2)      # two planes: float2
    staged = torch.stack(upfirdn_staged(cpu, torch.from_numpy(h), up, down,
                                        n_out, 2))
    assert _rel(got, staged) < 1e-5
    truth = np.zeros(n_out, np.complex128)
    s = sps.upfirdn(h.astype(np.float64), x.astype(np.complex128), up, down)
    truth[: min(n_out, full)] = s[:n_out]
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), truth,
                               atol=2e-4 * np.sqrt(taps), rtol=1e-4)
    assert plan["route"] == ("window-staged" if plan["staged"] else
                             "window-unstaged") + "-float2"
    assert plan["staged"] == (taps < 30_000)
    reason = select_upfirdn_path(n, taps, up, down, torch.complex64, cuda)[1]
    assert plan["route"] in reason


def test_upfirdn_kernel_grid_float64(cuda):
    """The JAX polyphase grid (tests/test_filters.py:125): down > up, taps
    shorter than up, n = 1, up == down == 1, all in float64."""
    rng = np.random.default_rng(125)
    for up in (1, 2, 3, 5, 8):
        for down in (1, 2, 3, 5, 7):
            for T in (1, 4, 15, 101):
                for n in (1, 17, 256):
                    x = rng.standard_normal(n)
                    h = rng.standard_normal(T)
                    got = upfirdn(torch.from_numpy(h).to(cuda),
                                  torch.from_numpy(x).to(cuda), up, down)
                    ref = sps.upfirdn(h, x, up, down)
                    assert got.shape == ref.shape, (up, down, T, n)
                    np.testing.assert_allclose(got.cpu().numpy(), ref,
                                               atol=1e-9,
                                               err_msg=str((up, down, T, n)))


@pytest.mark.parametrize("rows,n,up,down,taps,dtype", [
    (3, 1000, 2, 3, 16, torch.float32),
    (70_000, 5, 5, 4, 7, torch.float32),        # more rows than grid y
    (4, 4096, 5, 4, 730, torch.float64),
    (2, 1000, 1, 1, 30_000, torch.float32),     # taps past shared memory
    (2, 50_000, 1, 20_000, 9, torch.float32),   # span past shared memory
])
def test_upfirdn_kernel_rows_and_variants(cuda, rows, n, up, down, taps,
                                          dtype):
    rng = np.random.default_rng(rows + n + taps)
    x = torch.from_numpy(rng.standard_normal((rows, n))).to(cuda, dtype)
    h = torch.from_numpy(rng.standard_normal(taps) / taps).to(cuda, dtype)
    (got,) = upfirdn_planes((x,), h, up, down)
    (ref,) = upfirdn_planes_plain((x,), h, up, down)
    torch.cuda.synchronize()
    assert got.shape == (rows, get_upfirdn_size(n, taps, up, down))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(got, ref) < tol


def test_upfirdn_complex_taps_and_planes_flat(cuda):
    rng = np.random.default_rng(31)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    hc = (rng.standard_normal(31) + 1j * rng.standard_normal(31)
          ).astype(np.complex64)
    before = upfirdn_planes.launches
    got = upfirdn(torch.from_numpy(hc).to(cuda), torch.from_numpy(x).to(cuda),
                  3, 5)
    assert upfirdn_planes.launches == before + 2      # real and imag taps
    np.testing.assert_allclose(got.cpu().numpy(), sps.upfirdn(hc, x, 3, 5),
                               atol=1e-4)
    h1 = rng.standard_normal(128).astype(np.float32)
    h2 = rng.standard_normal(95).astype(np.float32)
    re, im = (torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
              for p in (x.real, x.imag))
    o_re, o_im = fir_upfirdn_planes_flat(h1, h2, re, im, 5, 4)
    c_re, c_im = fir_upfirdn_planes_flat(h1, h2, re.cpu(), im.cpu(), 5, 4)
    assert _rel(torch.stack([o_re, o_im]).cpu(), torch.stack([c_re, c_im])) \
        < 1e-5


@pytest.mark.parametrize("n,k,dtype", [
    (1000, 1, torch.float32), (1000, 3, torch.float32),
    (4_194_304 // 64, 129, torch.float32), (5000, 1023, torch.float32),
    (100, 129, torch.float32),                 # n < k
    (777, 31, torch.float32),                  # partial last tile
    (3000, 129, torch.float64), (600, 1023, torch.float64),
    (3000, 60_001, torch.float32),             # keys past shared memory
    (5000, 129, torch.float16), (777, 31, torch.bfloat16),  # as float32
])
def test_medfilt_kernel_matches_twin(cuda, n, k, dtype):
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, dtype)
    before = medfilt_kernel.launches
    got = medfilt_kernel(x, k)
    assert medfilt_kernel.launches == before + 1
    ref = medfilt_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert got.dtype == dtype
    if n * k <= 1 << 24:
        x64 = x.cpu().to(torch.float64).numpy()
        assert np.array_equal(got.cpu().to(torch.float64).numpy(),
                              sps.medfilt(x64, k))


@pytest.mark.parametrize("n,k,dtype", [
    (1001, 129, torch.float32),                # n % C != 0
    (1003, 9, torch.float32), (1003, 7, torch.float32),   # k = C +- 1
    (999, 1, torch.float32), (999, 1, torch.float64),
    (4097, 1023, torch.float64),               # 1008 core keys, 32 a lane
    (3001, 1039, torch.float32),               # 1024 core keys: the most
    (3000, 20_001, torch.float32),             # radix, staged
    (3000, 60_001, torch.float32),             # radix, unstaged
])
def test_medfilt_kernel_routes_and_tile_edges(cuda, n, k, dtype):
    """Each route of select_medfilt_path and the tile's edges, against the
    twin, the CPU emulation of the kernel's schedule and scipy."""
    from pydsproutines_tpu_torch.ops.filters import select_medfilt_path
    from pydsproutines_tpu_torch.ops.hopper.medfilt import (medfilt_plan,
                                                            medfilt_staged)
    rng = np.random.default_rng(n * k)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, dtype)
    x[::5] = 0.0
    plan = medfilt_plan(k, x.element_size())
    path, reason = select_medfilt_path(1, dtype, cuda, k)
    assert path == "medfilt-hopper" and (
        f"C={plan['c']}" in reason if plan["route"] == "tile"
        else plan["route"] in reason)
    got = medfilt_kernel(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got, medfilt_plain(x, k))
    if n * k <= 1 << 23:
        assert torch.equal(got.cpu(), medfilt_staged(x.cpu(), k))
        assert np.array_equal(got.cpu().numpy(),
                              sps.medfilt(x.cpu().numpy(), k))


@pytest.mark.parametrize("c", [0, 2, 4, 8, 16, 32])
def test_medfilt_kernel_tile_widths(cuda, c):
    """Every tile width the kernel is built for (and the radix route, c = 0)
    gives the twin's result at the detection chain's window."""
    from pydsproutines_tpu_torch.ops.hopper import _build
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal(70_001).astype(np.float32)).to(
        cuda)
    out = torch.empty_like(x)
    rc = _build.library().pdsp_medfilt_f32(
        x.data_ptr(), out.data_ptr(), x.shape[0], 129, c,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"medfilt c={c}")
    torch.cuda.synchronize()
    assert torch.equal(out, medfilt_plain(x, 129))


def test_medfilt_routes_on_the_card(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(2000).astype(np.float32)).to(cuda)
    before = medfilt_kernel.launches
    got = medfilt(x.abs() ** 2, 65)
    assert medfilt_kernel.launches == before + 1
    assert torch.equal(got, medfilt_plain(x.abs() ** 2, 65))
    xh = x.to(torch.float16)
    assert torch.equal(medfilt(xh, 65), medfilt_plain(xh, 65))
    assert medfilt_kernel.launches == before + 2
    x2 = x.reshape(4, 500)
    assert torch.equal(medfilt(x2, 5), medfilt_plain(x2, 5))  # plain route
    xi = (x * 100).to(torch.int64)
    assert torch.equal(medfilt(xi, 5), medfilt_plain(xi, 5))
    assert medfilt_kernel.launches == before + 2


def test_detection_on_the_card_matches_cpu(cuda):
    """Edges, thresholds and histogram decisions on CUDA tensors equal the
    same calls on CPU tensors (the kernel and the twin are bit-equal)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000)
         ).astype(np.complex64)
    x[3000:5000] *= 6.0
    x[12_000:12_900] *= 6.0
    got, ref = BurstDetector(65), BurstDetector(65)
    assert torch.equal(got.medfilt(torch.from_numpy(x).to(cuda)).cpu(),
                       ref.medfilt(torch.from_numpy(x)))
    levels = np.arange(0.0, 60.0, 2.0)
    thr = got.auto_detect_threshold(levels)
    assert thr is not None and thr == ref.auto_detect_threshold(levels)
    for a, b in zip(got.detect_via_threshold(thr, 8, 500),
                    ref.detect_via_threshold(thr, 8, 500)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(got.detect_single_emitter(capacity=8),
                    ref.detect_single_emitter(capacity=8)):
        assert torch.equal(a.cpu(), b)
    amp = torch.from_numpy(np.abs(x) ** 2)
    e_gpu = energy_detection(amp.to(cuda), 33, noise_indices=np.arange(2000))
    e_cpu = energy_detection(amp, 33, noise_indices=np.arange(2000))
    torch.testing.assert_close(e_gpu[0].cpu(), e_cpu[0], rtol=1e-6, atol=0)
    for a, b in zip(e_gpu[3], e_cpu[3]):
        assert torch.equal(a.cpu(), b)


def test_lfilter_direct_runs_the_upfirdn_kernel_in_full_f32(cuda):
    """The FIR takes kernel #5 at up = down = 1, not a TF32 convolution."""
    rng = np.random.default_rng(24)
    taps = sps.firwin(129, 0.1).astype(np.float32)
    x = (rng.standard_normal(50_000) + 1j * rng.standard_normal(50_000)
         ).astype(np.complex64)
    before = upfirdn_planes.launches
    got = lfilter_fir(torch.from_numpy(taps).to(cuda),
                      torch.from_numpy(x).to(cuda))
    assert upfirdn_planes.launches == before + 1
    ref = sps.lfilter(taps.astype(np.float64), 1.0, x.astype(np.complex128))
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("g,m,k,lengths,offsets", [
    (1, 4096, 128, None, list(range(64))),
    (3, 1000, 100, [1000, 700, 513], list(range(0, 90, 3))),   # ragged
    (8, 512, 37, None, [0, 1, 5, 9, 40, 41, 77, 200, 201, 399]),  # a list
    (8, 4096, 128, None, list(range(1024))),    # the bench geometry
    (3, 256, 64, None, [-300, -5, 0, 2, 100]),  # windows before rx: zeros
])
def test_group_caf_kernel_matches_twin(cuda, g, m, k, lengths, offsets):
    rng = np.random.default_rng(g * m + k)
    lengths = np.full(g, m) if lengths is None else np.array(lengths)
    starts = np.arange(g) * (m + 37)
    rxlen = offsets[-1] + int(starts[-1] + lengths[-1])
    tf = (rng.standard_normal((g * m, k))
          + 1j * rng.standard_normal((g * m, k))).astype(np.complex64)
    for i, ln in enumerate(lengths):
        tf[i * m + ln: (i + 1) * m] = 0          # short groups' padding
    rx = (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen)
          ).astype(np.complex64)
    i_star, f_star = len(offsets) // 2, k // 3
    for i, (s, ln) in enumerate(zip(starts, lengths)):   # C peaks there
        o = offsets[i_star] + s
        rx[o: o + ln] += 3 * np.conj(tf[i * m: i * m + ln, f_star])
    args = [torch.from_numpy(a).to(cuda) for a in (rx, np.array(offsets),
                                                   starts, tf)]
    before = group_caf.launches
    got = group_caf(*args, k)
    assert group_caf.launches > before
    ref = group_caf_plain(*args, k)
    torch.cuda.synchronize()
    assert got.shape == (len(offsets), k) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    gmax, rmax = got.max(1).values, ref.max(1).values
    assert float(((gmax - rmax).abs() / rmax).max()) < 1e-4
    assert float((got - ref).abs().max() / ref.max()) < 1e-4
    # every bin of every shift, on its own row's scale: a fault that leaves
    # each row's maximum alone (bins moved within a tile) shows here
    assert float(((got - ref).abs() / rmax[:, None]).max()) < 1e-4
    assert group_caf.splits >= 1
    assert int(torch.argmax(gmax)) == int(torch.argmax(rmax)) == i_star
    assert int(torch.argmax(got[i_star])) == f_star


@pytest.mark.parametrize("g,m,k,offsets", [
    (3, 256, 64, [-300, -5, 0, 2, 100]),
    (2, 1000, 37, list(range(0, 300, 7))),
])
def test_group_caf_kernel_matches_staged(cuda, g, m, k, offsets):
    """The kernel against its own arithmetic in torch (3xTF32 splits, exact
    products, f32 sums in another order and the tensor cores' own
    accumulation within each 32-deep stage): within 2e-5 of each row's
    maximum (~1.1e-6 against the twin on an H100), over presplit planes
    and over a tfold it splits itself, bit-equal between the two."""
    rng = np.random.default_rng(g + m + k)
    starts = np.arange(g) * (m + 11)
    rxlen = offsets[-1] + int(starts[-1]) + m
    tf = (rng.standard_normal((g * m, k))
          + 1j * rng.standard_normal((g * m, k))).astype(np.complex64)
    rx = (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen)
          ).astype(np.complex64)
    rx_d, offs, st, tf_d = (torch.from_numpy(a).to(cuda) for a in (
        rx, np.array(offsets), starts, tf))
    planes = tf32_planes(tf_d)
    got = group_caf(rx_d, offs, st, tf_d, k, planes)
    again = group_caf(rx_d, offs, st, tf_d, k)
    ref = group_caf_staged(rx_d, offs, st, planes, m, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    rmax = ref.max(1).values
    assert float(((got - ref).abs() / rmax[:, None]).max()) < 2e-5


def test_group_xcorr_czt_routes_to_the_kernel(cuda):
    """GroupXcorrCZT.xcorr on the card (built with no device, the
    default): "group-caf-hopper", a launch, and the same QF^2 grid as the
    call on CPU tensors (rtol 1e-4 of the max)."""
    rng = np.random.default_rng(77)
    starts, lengths = np.arange(4) * 300, np.full(4, 256)
    span = int(starts[-1] + 256)
    y = (rng.standard_normal(span) + 1j * rng.standard_normal(span)
         ).astype(np.complex64)
    rx = 0.1 * (rng.standard_normal(span + 200)
                + 1j * rng.standard_normal(span + 200))
    rx[50: 50 + span] += y * np.exp(2j * np.pi * 7 / 512 * np.arange(span))
    rx = rx.astype(np.complex64)
    grid = (-8 / 512, 8 / 512, 1 / 512, 1.0)
    gpu = GroupXcorrCZT(y, starts, lengths, *grid)
    cpu = GroupXcorrCZT(y, starts, lengths, *grid, device="cpu")
    assert gpu.device == cuda
    assert select_group_caf_path(4, 256, gpu.plan.k, torch.complex64, cuda,
                                 True)[0] == "group-caf-hopper"
    before = group_caf.launches
    got, freqs = gpu.xcorr(torch.from_numpy(rx).to(cuda))
    assert group_caf.launches == before + 1
    ref, _ = cpu.xcorr(torch.from_numpy(rx))
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                               atol=1e-4 * float(ref.max()))
    si, fi = np.unravel_index(int(torch.argmax(got)), got.shape)
    assert si == 50 and abs(freqs[fi] - 7 / 512) < 1e-12
    plain, _ = gpu.xcorr(torch.from_numpy(rx).to(cuda), fused=False)
    assert group_caf.launches == before + 1
    np.testing.assert_allclose(plain.cpu().numpy(), ref.numpy(),
                               atol=1e-4 * float(ref.max()))


@pytest.mark.parametrize("n,t,length", [
    (100_000, 1, 1), (100_000, 1, 48), (60_000, 8, 2048), (50_000, 4, 1024),
    (30_000, 11, 300),               # more than 8 templates: two launches
    (2047, 2, 2047),                 # one shift
])
def test_sliding_kernel_matches_twin(cuda, n, t, length):
    rng = np.random.default_rng(n + t + length)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    tm = (rng.standard_normal((t, length))
          + 1j * rng.standard_normal((t, length))).astype(np.complex64)
    t_star, s_star = t - 1, (n - length) // 2
    x[s_star: s_star + length] += 4 * tm[t_star]
    if n > 1000 + 2 * length:
        x[1000: 1000 + length + 5] = 0
    xt, tt = torch.from_numpy(x).to(cuda), torch.from_numpy(tm).to(cuda)
    before = sliding_multiply_normalised.launches
    got = sliding_multiply_normalised(xt, tt)
    assert sliding_multiply_normalised.launches == before + 1
    ref = sliding_plain(xt, tt)
    torch.cuda.synchronize()
    assert got.shape == (t, n - length + 1) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) < 1e-5
    if length > 1:
        ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
        assert (ti, si) == (t_star, s_star)
    if n > 1000 + 2 * length:                  # a window of zeros gives 0
        assert float(got[:, 1000: 1006].abs().max()) == 0.0
    if n * t * length <= 1 << 25:
        truth = sliding_multiply_normalised_reference(x, tm)
        fin = np.isfinite(truth)
        assert np.abs(got.cpu().numpy()[fin] - truth[fin]).max() < 1e-5


def _sliding_check(got, ref, truth=None):
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) < 1e-5
    if truth is not None:
        fin = np.isfinite(truth)
        assert np.abs(got.cpu().numpy()[fin] - truth[fin]).max() < 1e-5


@pytest.mark.parametrize("n,t,length,route", [
    (100_000, 1, 1, "direct"), (100_000, 3, 48, "ols"),
    (60_000, 2, 2048, "ols"), (30_000, 11, 300, "ols"),   # 11 in one launch
    (2047, 2, 2047, "direct"), (2047, 2, 2047, "ols"),    # one shift
    (50_000, 4, 1024, "ols"), (50_000, 4, 1024, "direct"),
])
def test_sliding_kernel_routes(cuda, n, t, length, route):
    """Both routes against the twin, numpy, and (overlap-save) the CPU
    emulation of its schedule; a window of zeros gives 0."""
    from pydsproutines_tpu_torch.ops.hopper.sliding import (_sliding_cuda,
                                                            sliding_staged)
    rng = np.random.default_rng(n + t + length)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    tm = (rng.standard_normal((t, length))
          + 1j * rng.standard_normal((t, length))).astype(np.complex64)
    t_star, s_star = t - 1, (n - length) // 2
    x[s_star: s_star + length] += 4 * tm[t_star]
    if n > 1000 + 2 * length:
        x[1000: 1000 + length + 5] = 0
    xt, tt = torch.from_numpy(x).to(cuda), torch.from_numpy(tm).to(cuda)
    before = sliding_multiply_normalised.launches
    got = _sliding_cuda(xt, tt, route)
    assert sliding_multiply_normalised.launches == before + 1
    ref = sliding_plain(xt, tt)
    torch.cuda.synchronize()
    _sliding_check(got, ref, sliding_multiply_normalised_reference(x, tm)
                   if n * t * length <= 1 << 25 else None)
    if length > 1:
        ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
        assert (ti, si) == (t_star, s_star)
    if n > 1000 + 2 * length:
        assert float(got[:, 1000: 1006].abs().max()) == 0.0
    if route == "ols":
        emu, flagged, _ = sliding_staged(torch.from_numpy(x),
                                         torch.from_numpy(tm))
        assert int(sliding_multiply_normalised.flagged) == len(flagged)
        assert float((got.cpu() - emu).abs().max()) < 1e-6


def test_sliding_kernel_burst_edge_scene(cuda):
    """-40 dB noise around a 20,000-sample burst holding the planted
    template, and a run of zeros: the segments at the burst's edges go to
    the kernel route's masked direct launch, and the result holds the twin's
    and numpy's 1e-5."""
    from chip_smoke import burst_edge_scene
    from pydsproutines_tpu_torch.ops.hopper.sliding import (
        select_sliding_path, sliding_staged)
    x, tm = burst_edge_scene(3, 200_000, 4, 1024, 2, 70_000, 9000, 150_000,
                             6000)
    assert select_sliding_path(200_000, 4, 1024, torch.complex64,
                               cuda)[0] == "sliding-ols-hopper"
    xt, tt = torch.from_numpy(x).to(cuda), torch.from_numpy(tm).to(cuda)
    got = sliding_multiply_normalised(xt, tt)
    flagged = int(sliding_multiply_normalised.flagged)
    _, emu_flagged, _ = sliding_staged(torch.from_numpy(x),
                                       torch.from_numpy(tm))
    assert flagged >= 1 and emu_flagged          # the re-check ran
    _sliding_check(got, sliding_plain(xt, tt),
                   sliding_multiply_normalised_reference(x, tm))
    ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
    assert (ti, si) == (2, 79_000)
    assert float(got[:, 150_000: 155_000 - 1023].abs().max()) == 0.0
