"""Parity of the port's transform API (``ops/fft``: ``FourStepFFT``,
``get_fft_plan``, ``fft``, ``ifft``) and WOLA's quadrature-plane entry
points (``ops/wola``: ``wola_planes``, ``wola_planes_flat``) with the JAX
package on the CPU.

The same seeded numpy inputs go through the JAX functions (CPU; the Pallas
kernels #1 and #4 in interpret mode) and the port (CPU tensors, so each
kernel's plain twin). Tolerances:

- plans: ``factors``, ``viable`` and ``permutation`` exact;
- transforms: max|d| < 1e-5 * max|X| at complex64 (f32 FFTs in another
  order; the JAX CPU stages are full-f32 einsums), < 1e-11 * max|X| at
  complex128 (x64 as tests/conftest.py sets it);
- peaks: bins exact (planted tones, no ties); |X|^2 within rtol 5e-6 of
  the JAX "f32" mode and of float64 numpy (the JAX f32 mode's own
  tolerance, ``tests/test_fft_peak.py``); the port computes in f32 in
  every mode, so its "bf16" meets the same bound;
- WOLA planes: max|d| < 1e-6 * max|ref| against JAX (f32 sums of at most
  16 taps and a 128-point DFT in another order), bit-equal between the
  flat and the 2-D outputs, and 1e-5 against the Pallas plane kernel in
  interpret mode (the bound of tests/test_wola.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from pydsproutines_tpu.ops import fft as jfft
from pydsproutines_tpu.ops.wola import wola_planes as jax_wola_planes
from pydsproutines_tpu.ops.wola import (
    wola_planes_flat as jax_wola_planes_flat)
from pydsproutines_tpu_torch.ops import fft as tfft
from pydsproutines_tpu_torch.ops.hopper.fft_peak import stage2_peak
from pydsproutines_tpu_torch.ops.wola import (_wola_planes_impl,
                                              select_wola_path, wola_planes,
                                              wola_planes_flat)

PEAK_RTOL = 5e-6


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _toned(rng, n, bins):
    """One row a bin: unit complex noise plus a tone at that bin."""
    x = _cplx(rng, (len(bins), n))
    t = np.arange(n)
    for r, k in enumerate(bins):
        x[r] += np.exp(2j * np.pi * k * t / n).astype(np.complex64)
    return x


@pytest.mark.parametrize("n", [256, 1024, 2048, 4096, 12800, 2**20,
                               10_000_000, 2**24, 4099, 1_000_003])
def test_plan_matches_jax(n):
    """Factors, viability and the permuted order of the JAX plan: the
    two-factor rule (2^20), the multi-stage rule (10^7, 2^24), the small-n
    single stage (256-2048), primes not viable."""
    jplan, plan = jfft.FourStepFFT(n), tfft.FourStepFFT(n)
    assert (plan.n, plan.viable, plan.factors) == (jplan.n, jplan.viable,
                                                   jplan.factors)
    if plan.viable:
        assert plan.permutation.dtype == np.int32
        np.testing.assert_array_equal(plan.permutation, jplan.permutation)
    else:
        with pytest.raises(ValueError, match="not viable"):
            plan.permutation
    expected = {2**20: [1024, 1024], 10_000_000: [200, 200, 250],
                2**24: [256, 256, 256], 2048: [2048], 4099: None}
    if n in expected:
        assert plan.factors == expected[n]


@pytest.mark.parametrize("factors", [[64, 64], [16, 16, 16], [8, 8, 8, 8],
                                     [40, 32, 32]])
def test_plan_with_given_factors_matches_jax(factors):
    n = int(np.prod(factors))
    jplan = jfft.FourStepFFT(n, factors=factors)
    plan = tfft.FourStepFFT(n, factors=factors)
    assert (plan.viable, plan.factors) == (jplan.viable, jplan.factors)
    np.testing.assert_array_equal(plan.permutation, jplan.permutation)
    assert plan.peak_viable() == jplan.peak_viable("f32")


@pytest.mark.parametrize("dtype,expect", [
    (torch.complex64, torch.complex64), (np.complex128, torch.complex128),
    ("complex64", torch.complex64), (np.dtype("complex128"),
                                     torch.complex128)])
def test_plan_dtype_takes_torch_numpy_and_strings(dtype, expect):
    assert tfft.FourStepFFT(4096, dtype=dtype).dtype == expect
    plan = tfft.get_fft_plan(4096, "complex128")
    assert plan is tfft.get_fft_plan(4096, "complex128")
    assert plan.dtype == torch.complex128 and plan.factors == [64, 64]


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.max(np.abs(got - ref)) < tol * np.max(np.abs(ref))


@pytest.mark.parametrize("n", [100, 2048, 4096, 12800])
@pytest.mark.parametrize("dtype,tol", [(np.complex64, 1e-5),
                                       (np.complex128, 1e-11)])
def test_transforms_match_jax(rng, n, dtype, tol):
    """``fft``, ``ifft``, a plan's ``__call__`` and ``call_permuted``
    along the last axis, at the non-viable (100), single-stage (2048) and
    two-factor sizes."""
    x = _cplx(rng, (3, n), dtype)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    plan = tfft.get_fft_plan(n, np.dtype(dtype).name)
    jplan = jfft.get_fft_plan(n, np.dtype(dtype).name)
    _close(tfft.fft(tx).numpy(), jfft.fft(jx), tol)
    _close(tfft.ifft(tx).numpy(), jfft.ifft(jx), tol)
    _close(plan(tx).numpy(), jplan(jx), tol)
    _close(plan.call_permuted(tx).numpy(), jplan.call_permuted(jx), tol)


@pytest.mark.parametrize("dtype,tol", [(np.complex64, 1e-5),
                                       (np.complex128, 1e-11)])
def test_transforms_along_another_axis_match_jax(rng, dtype, tol):
    x = _cplx(rng, (4096, 2, 3), dtype)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for axis in (0, 1, -3):
        _close(tfft.fft(tx, axis).numpy(), jfft.fft(jx, axis), tol)
        _close(tfft.ifft(tx, axis).numpy(), jfft.ifft(jx, axis), tol)
    back = tfft.ifft(tfft.fft(tx, 0), 0).numpy()
    assert np.max(np.abs(back - x)) < tol * np.max(np.abs(x))


def test_call_permuted_is_the_natural_spectrum_gathered(rng):
    plan = tfft.FourStepFFT(12800, factors=[40, 32, 10])
    x = torch.from_numpy(_cplx(rng, (2, 12800)))
    natural = plan(x)
    perm = torch.from_numpy(plan.permutation).long()
    assert torch.equal(plan.call_permuted(x), natural[:, perm])
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.shape[0])
    assert torch.equal(plan.call_permuted(x)[:, inverse], natural)


PEAK_PLANS = [(4096, None), (8192, [32, 16, 16]), (4096, [8, 8, 8, 8]),
              (40960, [40, 32, 32])]


@pytest.mark.parametrize("n,factors", PEAK_PLANS)
def test_call_peak_matches_jax_interpret(n, factors):
    """``call_peak`` and ``call_peak_planes`` against the JAX plan's, the
    Pallas kernel #4 in interpret mode, at the plans of
    tests/test_fft_peak.py: bins exact, peaks within PEAK_RTOL of JAX's
    "f32" mode and of float64 numpy; the port's "bf16" equal to its "f32"."""
    jplan = (jfft.get_fft_plan(n) if factors is None
             else jfft.FourStepFFT(n, factors=factors))
    plan = (tfft.get_fft_plan(n) if factors is None
            else tfft.FourStepFFT(n, factors=factors))
    assert plan.factors == jplan.factors and plan.peak_viable()
    bins = [5, n // 2 + 3, n - 17]
    x = _toned(np.random.default_rng(n), n, bins)
    ref = np.abs(np.fft.fft(x.astype(np.complex128))) ** 2
    jpk, jbin = jplan.call_peak(jnp.asarray(x), mode="f32", interpret=True)
    jppk, jpbin = jplan.call_peak_planes(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), mode="f32",
        interpret=True)
    xt = torch.from_numpy(x)
    before = stage2_peak.launches
    for mode in ("bf16", "f32"):
        pk, pb = plan.call_peak(xt, mode=mode)
        ppk, ppb = plan.call_peak_planes(xt.real.contiguous(),
                                         xt.imag.contiguous(), mode=mode)
        assert pk.dtype == torch.float32 and pb.tolist() == bins
        assert torch.equal(pk, ppk) and torch.equal(pb, ppb)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jbin))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jpbin))
        for other in (np.asarray(jpk), np.asarray(jppk), ref.max(-1)):
            np.testing.assert_allclose(pk.numpy(), other, rtol=PEAK_RTOL)
    assert stage2_peak.launches == before        # CPU: the plain twin


def test_call_peak_keeps_the_leading_shape():
    plan = tfft.FourStepFFT(4096, factors=[8, 8, 8, 8])
    x = torch.from_numpy(_toned(np.random.default_rng(3), 4096,
                                [1, 2, 3, 4, 5, 6])).reshape(2, 3, 4096)
    pk, pb = plan.call_peak(x)
    assert pk.shape == pb.shape == (2, 3)
    assert pb.reshape(-1).tolist() == [1, 2, 3, 4, 5, 6]
    pk, pb = plan.call_peak(x[0, 0])
    assert pk.shape == pb.shape == () and int(pb) == 1


def test_peak_modes_and_refusals_match_jax():
    jplan, plan = jfft.get_fft_plan(4096), tfft.get_fft_plan(4096)
    x = np.zeros(4096, np.float32)
    with pytest.raises(ValueError, match="bf16/f32 only"):
        jplan.call_peak_planes(jnp.asarray(x), jnp.asarray(x), mode="bf16x3")
    with pytest.raises(ValueError, match="bf16/f32 only"):
        plan.call_peak_planes(torch.from_numpy(x), torch.from_numpy(x),
                              mode="bf16x3")
    with pytest.raises(ValueError, match="mode"):
        plan.call_peak(torch.zeros(4096, dtype=torch.complex64), mode="int8")
    # single-stage and non-viable plans have no last stage to fuse
    for n in (2048, 4099):
        assert not tfft.FourStepFFT(n).peak_viable()
        assert not jfft.FourStepFFT(n).peak_viable()
        with pytest.raises(ValueError, match="no plan of kernel #4"):
            tfft.FourStepFFT(n).call_peak(torch.zeros(n, dtype=torch.complex64))
    # a last factor past the shared-memory row (8192) is refused
    assert not tfft.FourStepFFT(2 * 8209, factors=[2, 8209]).peak_viable()
    assert tfft.FourStepFFT(2**20).peak_viable()
    assert tfft.FourStepFFT(10_000_000).peak_viable()


def test_call_peak_of_a_big_plan_runs_on_cpu_tensors():
    """The 10^7-point plan [200, 200, 250]: its (rows, K1, J) = (200, 200,
    250) stage-2 input, a bin past 2^23 exact against float64 numpy."""
    n, k = 10_000_000, 9_876_543
    plan = tfft.get_fft_plan(n)
    tone = np.exp(2j * np.pi * k * np.arange(n) / n)
    x = (0.1 * _cplx(np.random.default_rng(5), n) + tone).astype(np.complex64)
    f1 = plan._leading_stages(torch.from_numpy(x)[None])
    assert f1.shape == (200, 200, 250)
    pk, pb = plan.call_peak(torch.from_numpy(x))
    assert int(pb) == k
    ref = float(np.abs(np.vdot(tone, x.astype(np.complex128))) ** 2)
    assert abs(float(pk) - ref) < PEAK_RTOL * ref


WOLA_CASES = [(64, 64, 512, 0), (16, 16, 128, 0), (128, 128, 1024, 0),
              (32, 64, 512, 1)]


@pytest.mark.parametrize("dec,n,taps,row_offset", WOLA_CASES)
@pytest.mark.parametrize("tail", [0, 5])
def test_wola_planes_match_jax(rng, dec, n, taps, row_offset, tail):
    """Both plane entry points against JAX's at N == Dec and N == 2*Dec
    (the odd-row flip from a global row offset), with a length that is
    not a multiple of dec: cut to rows*n samples."""
    rows = 150
    h = sps.firwin(taps, 1.0 / dec).astype(np.float32)
    re = rng.standard_normal(rows * dec + tail).astype(np.float32)
    im = rng.standard_normal(rows * dec + tail).astype(np.float32)
    jargs = (jnp.asarray(h), jnp.asarray(re), jnp.asarray(im), dec, n)
    targs = (torch.from_numpy(h), torch.from_numpy(re), torch.from_numpy(im),
             dec, n)
    ref = jax_wola_planes(*jargs, row_offset=row_offset)
    ref_flat = jax_wola_planes_flat(*jargs, row_offset=row_offset)
    got = wola_planes(*targs, row_offset=row_offset)
    flat = wola_planes_flat(*targs, row_offset=row_offset)
    scale = max(np.max(np.abs(np.asarray(r))) for r in ref)
    for g, f, r, rf in zip(got, flat, ref, ref_flat):
        assert g.dtype == f.dtype == torch.float32
        assert g.shape == (rows, n) and f.shape == (rows * n,)
        assert np.max(np.abs(g.numpy() - np.asarray(r))) < 1e-6 * scale
        assert np.max(np.abs(f.numpy() - np.asarray(rf))) < 1e-6 * scale
        assert f.numpy().tobytes() == g.numpy().tobytes()
    _, route = _wola_planes_impl(*targs, row_offset=row_offset)
    assert route[0] == "plain"


def test_wola_planes_twin_is_the_complex_twin_split(rng):
    """On CPU tensors the planes are ``wola`` of the interleaved samples,
    split: bit-equal, as the kernel's two instances are on the card."""
    from pydsproutines_tpu_torch.ops.wola import wola
    h = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    re, im = (torch.from_numpy(rng.standard_normal(64 * 40 + 3)
                               .astype(np.float32)) for _ in range(2))
    ref = wola(h, torch.complex(re, im), 64)
    o_re, o_im = wola_planes(h, re, im, 64)
    assert torch.equal(o_re, ref.real) and torch.equal(o_im, ref.imag)
    assert o_re.is_contiguous() and o_im.is_contiguous()


def test_wola_planes_twin_matches_pallas_plane_kernel_interpret(rng):
    """The port's plane twin at N == Dec against the TPU plane kernel
    itself, ``wola_fused_planes_flat`` in interpret mode (64 ch, 1024 taps:
    B = 16, the kernel's pair-row geometry)."""
    from pydsproutines_tpu.ops.pallas.wola_fused import (
        wola_fused_planes_flat)
    nch, rows = 64, 300
    h = rng.standard_normal(1024).astype(np.float32)
    re = rng.standard_normal(nch * rows).astype(np.float32)
    im = rng.standard_normal(nch * rows).astype(np.float32)
    ref = wola_fused_planes_flat(jnp.asarray(h), jnp.asarray(re),
                                 jnp.asarray(im), nch, nch, interpret=True)
    got = wola_planes_flat(torch.from_numpy(h), torch.from_numpy(re),
                                 torch.from_numpy(im), nch)
    scale = max(np.max(np.abs(np.asarray(r))) for r in ref)
    for g, r in zip(got, ref):
        assert np.max(np.abs(g.numpy() - np.asarray(r))) < 1e-5 * scale


def test_wola_planes_route_names_the_plane_instance():
    path, reason = select_wola_path(64, 64, "cuda", 2048, planes=True)
    assert path == "fused-planes-hopper"
    assert "plane I/O instance" in reason and "register fold" in reason
    assert select_wola_path(64, 64, "cpu", planes=True)[0] == "plain"
    assert select_wola_path(128, 64, "cuda", planes=True)[0] == "plain"


def test_chip_smoke_transform_phase_on_cpu():
    """``chip_smoke.transform`` on the CPU at a small size (WOLA planes of
    19,200 samples at N = 64 and 128, 1024 taps; the transforms on 3 x
    4096; call_peak at 3 x 4096 and on a three-stage plan, 1 x 2^21 =
    [128, 128, 128]): its gates pass with the plain twins and no launch,
    and its scenes through the JAX package give the port's numbers (WOLA
    planes 1e-6 of max, fft 1e-5 of max|X|, call_peak's bins exact and
    peaks within PEAK_RTOL of the Pallas kernel #4 in interpret mode)."""
    import chip_smoke as cs
    from pydsproutines_tpu_torch.ops.hopper import (fft_peak, fused_caf3,
                                                    fused_xcorr, group_caf,
                                                    medfilt, sliding,
                                                    upfirdn, wola_fused)
    kernels = (wola_fused.wola_fused, wola_fused.wola_fused_planes,
               fused_xcorr.caf_peak, fused_caf3.caf3_peak,
               fft_peak.window_columns, fft_peak.stage2_peak,
               upfirdn.upfirdn_planes, medfilt.medfilt_kernel,
               group_caf.group_caf, sliding.sliding_multiply_normalised)
    shapes = dict(wola_shapes=((64, 1024, 300), (128, 1024, 150)),
                  fft_shape=(3, 4096), peaks=((3, 4096), (1, 2**21)))
    out = cs.transform(torch.device("cpu"), kernels, **shapes)
    assert set(out["launches"].values()) == {0}
    assert out["peaks"][1]["factors"] == [128, 128, 128]
    assert out["peaks"][1]["stage2_rows"] == [128, 128, 128]

    sc = cs.transform_scenes(**shapes)
    for n, taps, rows in shapes["wola_shapes"]:
        h = sc["taps"][(n, taps)]
        re, im = sc["re"][: rows * n], sc["im"][: rows * n]
        ref = jax_wola_planes_flat(jnp.asarray(h), jnp.asarray(re),
                                   jnp.asarray(im), n, n)
        got = wola_planes_flat(torch.from_numpy(h), torch.from_numpy(re),
                               torch.from_numpy(im), n)
        scale = max(np.max(np.abs(np.asarray(r))) for r in ref)
        for g, r in zip(got, ref):
            assert np.max(np.abs(g.numpy() - np.asarray(r))) < 1e-6 * scale
    x, bins = sc["rows"][(3, 4096)]
    _close(tfft.fft(torch.from_numpy(x)).numpy(), jfft.fft(jnp.asarray(x)),
           1e-5)
    jpk, jbin = jfft.get_fft_plan(4096).call_peak(jnp.asarray(x), mode="f32",
                                                  interpret=True)
    pk, pb = tfft.get_fft_plan(4096).call_peak(torch.from_numpy(x))
    assert pb.tolist() == np.asarray(jbin).tolist() == bins
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=PEAK_RTOL)
