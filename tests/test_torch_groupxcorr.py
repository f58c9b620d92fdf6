"""Parity of the port's group cross-correlation layer with the JAX package.

The same numpy inputs go through the JAX classes (CPU, x64 on) and the port
(CPU tensors, ``device="cpu"``). Tolerances:

* complex128, against the JAX XLA tier (``fused=False``): max|d| < 1e-6 on
  the 0..1 QF^2 grid, ``tests/test_groupxcorr.py:78``'s bound against its
  numpy re-derivation;
* complex64, against the JAX group CAF kernel itself (Pallas, interpret
  mode) and its tone-dot formulation: both run bf16 operands, so the
  planted peak must be exact, within rtol 2e-2 there and atol 5e-3*max on
  the grid (``tests/test_groupxcorr.py:219-220``);
* the kernel's twin against float64 numpy: rtol 1e-5 of the grid's max
  (an f32 product over G*m terms);
* the Hopper kernel's 3xTF32 arithmetic (``group_caf_staged``: TF32 hi/lo
  splits rounded as ``cvt.rna`` does, lo*hi + hi*lo + hi*hi in f32) on the
  QF^2 grid against float64 numpy within chip_smoke.py's GROUP_QF2_ATOL =
  4e-6, and against the JAX kernel at its bf16 bounds (above);
* the other classes at complex128: 1e-9; MultiPreambleCorrelator, which
  computes in complex64 on both sides, 1e-5 absolute on its 0..1 grid (the
  JAX side takes its window energies as differences of an f32 prefix sum,
  the port of a float64 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import groupxcorr as jg
from pydsproutines_tpu.ops import multicorr as jm
from pydsproutines_tpu_torch.ops import groupxcorr as tg
from pydsproutines_tpu_torch.ops import multicorr as tm
from pydsproutines_tpu_torch.ops.hopper.group_caf import (
    group_caf, group_caf_plain, group_caf_staged, group_windows,
    planes_unpacked, tf32_planes, tf32_round, tf32_split)
from pydsproutines_tpu_torch.ops.xcorr import power_prefix

# chip_smoke.py's gate on the kernel's whole QF^2 grid
GROUP_QF2_ATOL = 4e-6


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _scene(rng, starts, lengths, rxlen, offset, fshift=0.0, noise=0.05,
           dtype=np.complex128):
    """y (the burst layout at offset 0) and rx holding it at ``offset`` with
    a tone of ``fshift`` cycles per sample."""
    y = np.zeros(int(np.max(starts + lengths)), np.complex128)
    for s, ln in zip(starts, lengths):
        y[s: s + ln] = np.exp(0.5j * np.pi * rng.integers(0, 4, ln))
    rx = noise * _cplx(rng, rxlen)
    rx[offset: offset + y.size] += y * np.exp(2j * np.pi * fshift
                                              * np.arange(y.size))
    return y.astype(dtype), rx.astype(dtype)


def _np_truth(y, starts, lengths, f1, f2, bw, fs, rx, shifts):
    """tests/test_groupxcorr.py's numpy re-derivation (direct DFT)."""
    k = int((f2 - f1) / bw + 1)
    freqs = f1 + np.arange(k) * bw
    m = int(np.max(lengths))
    dftmat = np.exp(-2j * np.pi * freqs[:, None] * np.arange(m)[None] / fs)
    ynorm = sum(np.linalg.norm(y[s: s + ln]) ** 2
                for s, ln in zip(starts, lengths))
    out = np.zeros((len(shifts), k))
    for i, sh in enumerate(shifts):
        comb = np.zeros(k, complex)
        rxn = 0.0
        for s, ln in zip(starts, lengths):
            r = rx[sh + s: sh + s + ln].astype(np.complex128)
            rxn += np.linalg.norm(r) ** 2
            pdt = np.zeros(m, complex)
            pdt[:ln] = np.conj(y[s: s + ln]) * r
            comb += (dftmat @ pdt) * np.exp(-2j * np.pi * freqs * s / fs)
        out[i] = np.abs(comb) ** 2 / rxn / ynorm
    return out


# (starts, lengths, f1, f2, bw, fs): the JAX test's scene, ragged groups,
# and m*k past the tone-bank gate (the Bluestein route)
GEOMS = [
    (np.arange(3) * 192, np.full(3, 128), -0.01, 0.01, 5e-4, 1.0),
    (np.array([0, 150, 420]), np.array([128, 96, 60]), -0.01, 0.01, 5e-4,
     1.0),
    (np.array([0, 5000]), np.array([4000, 4000]), -0.006, 0.006, 1e-5, 1.0),
]


@pytest.mark.parametrize("geom", GEOMS, ids=["uniform", "ragged",
                                              "bluestein"])
def test_group_xcorr_czt_matches_jax_complex128(rng, geom):
    starts, lengths, f1, f2, bw, fs = geom
    y, rx = _scene(rng, starts, lengths, int(np.max(starts + lengths)) + 400,
                   300, fshift=0.004 if bw > 1e-4 else 0.002)
    shifts = np.arange(295, 306)
    jx = jg.GroupXcorrCZT(y, starts, lengths, f1, f2, bw, fs,
                          dtype=jnp.complex128)
    tx = tg.GroupXcorrCZT(y, starts, lengths, f1, f2, bw, fs,
                          dtype=torch.complex128, device="cpu")
    assert (tx.plan.tones is None) == (jx.plan.tones is None) == \
        (bw < 1e-4)
    ref, rfreq = jx.xcorr(jnp.asarray(rx), jnp.asarray(shifts), fused=False)
    got, gfreq = tx.xcorr(torch.from_numpy(rx), shifts)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(gfreq, np.asarray(rfreq))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < 1e-6
    if bw > 1e-4:      # the numpy re-derivation, small enough to afford
        truth = _np_truth(y, starts, lengths, f1, f2, bw, fs, rx, shifts)
        assert np.abs(got.numpy() - truth).max() < 1e-6
    si, fi = np.unravel_index(int(torch.argmax(got)), got.shape)
    assert shifts[si] == 300


def _kernel_scene(rng, g=4, m=128, span_pad=300, plant=97):
    """The geometry of tests/test_groupxcorr.py:189: G = 4 groups of 128,
    16 bins of fs/256, a planted copy at shift 97."""
    fs = 1e6
    starts = np.arange(g) * 384
    lengths = np.full(g, m)
    span = int(starts[-1] + m)
    y = _cplx(rng, span, np.complex64)
    rx = (0.05 * _cplx(rng, span + span_pad)).astype(np.complex64)
    rx[plant: plant + span] += y
    bw = fs / m / 2
    return y, rx, starts, lengths, (-8 * bw, 7 * bw, bw, fs)


@pytest.mark.parametrize("formulation", ["pallas", "tonedot"])
def test_group_xcorr_czt_matches_the_jax_kernel(rng, formulation):
    """The port (CPU: the kernel's twin over the folded tone bank) against
    the JAX group CAF kernel in interpret mode ("pallas") and its tone-dot
    formulation, at G = 4, m = 128, k = 16, 64 shifts."""
    y, rx, starts, lengths, grid = _kernel_scene(rng)
    shifts = np.arange(64, 128)
    jx = jg.GroupXcorrCZT(y, starts, lengths, *grid)
    consts = jx._fused_consts(batch=64, step=1)
    assert consts is not None
    ref = np.asarray(jx._xcorr_fused(jnp.asarray(rx), jnp.asarray(shifts),
                                     consts, formulation=formulation))
    tx = tg.GroupXcorrCZT(y, starts, lengths, *grid, device="cpu")
    got = tx.xcorr(torch.from_numpy(rx), shifts)[0].numpy()
    assert got.shape == ref.shape == (64, 16) and got.dtype == np.float32
    ri, rj = np.unravel_index(np.argmax(ref), ref.shape)
    assert np.unravel_index(np.argmax(got), got.shape) == (ri, rj)
    assert shifts[ri] == 97
    np.testing.assert_allclose(got[ri, rj], ref[ri, rj], rtol=2e-2)
    np.testing.assert_allclose(got, ref, rtol=0.2, atol=5e-3 * ref.max())


def test_group_xcorr_czt_ragged_sweep_and_shift_list(rng):
    """A 40-shift sweep (not a multiple of any chunk) and a non-uniform
    shift list against the JAX XLA tier at complex64 (f32 on both sides:
    rtol 1e-4 of the grid's max) and against each other."""
    y, rx, starts, lengths, grid = _kernel_scene(rng, g=3, span_pad=200,
                                                 plant=20)
    jx = jg.GroupXcorrCZT(y, starts, lengths, *grid)
    tx = tg.GroupXcorrCZT(y, starts, lengths, *grid, device="cpu")
    sweep = np.arange(40)
    ref = np.asarray(jx.xcorr(jnp.asarray(rx), jnp.asarray(sweep),
                              batch_size=16, fused=False)[0])
    got = tx.xcorr(torch.from_numpy(rx), sweep, batch_size=16)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * ref.max())
    assert int(np.argmax(got.max(1))) == 20
    listed = np.array([3, 4, 9, 20, 21, 33, 39])
    lst = tx.xcorr(torch.from_numpy(rx), listed)[0].numpy()
    np.testing.assert_allclose(lst, got[listed], rtol=1e-6,
                               atol=1e-7 * got.max())
    jl = np.asarray(jx.xcorr(jnp.asarray(rx), jnp.asarray(listed),
                             fused=False)[0])
    np.testing.assert_allclose(lst, jl, atol=1e-4 * ref.max())


def test_group_xcorr_czt_default_shifts_and_bad_shifts(rng):
    y, rx, starts, lengths, grid = _kernel_scene(rng, g=2, span_pad=30,
                                                 plant=10)
    tx = tg.GroupXcorrCZT(y, starts, lengths, *grid, device="cpu")
    got, _ = tx.xcorr(torch.from_numpy(rx))
    assert got.shape == (31, 16)
    assert int(torch.argmax(got.max(1).values)) == 10
    with pytest.raises(ValueError, match="exceed"):
        tx.xcorr(torch.from_numpy(rx), [0, 31])
    with pytest.raises(ValueError, match="plan on"):
        tx.xcorr(torch.from_numpy(rx).to("meta"))


def test_group_caf_plain_matches_numpy(rng):
    """The kernel's twin: |sum_g sum_t rx[o + s_g + t] * tfold[g*m + t]|^2
    at a shift list, with the last group's windows running past rx."""
    g, m, k = 3, 64, 24
    rx = _cplx(rng, 400, np.complex64)
    tfold = _cplx(rng, (g * m, k), np.complex64)
    starts = np.array([0, 100, 300])
    offsets = np.array([0, 7, 8, 30, 60])     # 60 + 300 + 64 > 400
    got = group_caf(torch.from_numpy(rx), torch.from_numpy(offsets),
                    torch.from_numpy(starts), torch.from_numpy(tfold), k)
    rxp = np.concatenate([rx, np.zeros(64)]).astype(np.complex128)
    truth = np.stack([
        sum(rxp[o + s: o + s + m] @ tfold[i * m: (i + 1) * m]
            for i, s in enumerate(starts)) for o in offsets])
    truth = np.abs(truth) ** 2
    assert got.dtype == torch.float32 and got.shape == (5, k)
    assert np.abs(got.numpy() - truth).max() < 1e-5 * truth.max()
    again = group_caf_plain(torch.from_numpy(rx), torch.from_numpy(offsets),
                            torch.from_numpy(starts), torch.from_numpy(tfold),
                            k, batch=2)
    torch.testing.assert_close(again, got, rtol=1e-5, atol=0)


def test_group_caf_reads_zero_before_rx(rng):
    """Windows starting before rx read zeros there, as in the kernel: no
    range check in group_caf (its callers check their shifts once)."""
    g, m, k = 3, 64, 24
    rx = _cplx(rng, 400, np.complex64)
    tfold = _cplx(rng, (g * m, k), np.complex64)
    starts = np.array([0, 100, 300])
    offsets = np.array([-120, -20, -1])
    got = group_caf(torch.from_numpy(rx), torch.from_numpy(offsets),
                    torch.from_numpy(starts), torch.from_numpy(tfold), k)
    rxp = np.concatenate([np.zeros(120), rx]).astype(np.complex128)
    truth = np.abs(np.stack([
        sum(rxp[120 + o + s: 120 + o + s + m] @ tfold[i * m: (i + 1) * m]
            for i, s in enumerate(starts)) for o in offsets])) ** 2
    assert got.shape == (3, k)
    assert np.abs(got.numpy() - truth).max() < 1e-5 * truth.max()


@pytest.mark.parametrize("offsets", [[-50, -3], [0, 5], [330, 399],
                                     [-200, 500]],
                         ids=["before", "inside", "past-the-end", "both"])
def test_group_windows_read_zero_outside_rx(rng, offsets):
    """The twin's gather reads as the kernel does: samples outside rx are
    zero, at either end."""
    rx = _cplx(rng, 400, np.complex64)
    starts = np.array([0, 100, 300])
    got = group_windows(torch.from_numpy(rx), torch.tensor(offsets),
                        torch.from_numpy(starts), 64).numpy()
    pad = np.zeros(1000, np.complex64)
    rxp = np.concatenate([pad, rx, pad])
    truth = np.stack([[rxp[1000 + o + s: 1000 + o + s + 64] for s in starts]
                      for o in offsets])
    np.testing.assert_array_equal(got, truth)


def test_group_caf_checks_its_inputs():
    rx = torch.zeros(100, dtype=torch.complex64)
    tf = torch.zeros((2 * 8, 4), dtype=torch.complex64)
    st = torch.tensor([0, 10])
    with pytest.raises(ValueError, match="int64"):
        group_caf(rx, torch.tensor([0], dtype=torch.int32), st, tf, 4)
    with pytest.raises(ValueError, match="tfold has shape"):
        group_caf(rx, torch.tensor([0]), st, tf[:15], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        group_caf(rx.to("meta"), torch.tensor([0], device="meta"),
                  st.to("meta"), tf.to("meta"), 4)


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_from_numpy_params_matches_jax(rng, dtype):
    """One JAX object's plan constants build the port's; both give the same
    grid (complex64: the f32 XLA tier, rtol 1e-4 of the max)."""
    # rx runs on past the last window: the JAX chunked tier pads its last
    # chunk and clamps its covering slice otherwise (ROADMAP Queue 3 item 7)
    y, rx, starts, lengths, grid = _kernel_scene(rng, g=3, span_pad=100,
                                                 plant=30)
    jx = jg.GroupXcorrCZT(y, starts, lengths, *grid, dtype=dtype)
    params = {"ystack": jx.ystack, "starts": jx.starts,
              "lengths": jx.lengths, "group_phases": jx.group_phases,
              "ystack_norm_sq": jx.ystack_norm_sq, "tones": jx.plan.tones,
              "f1": jx.plan.f1, "bin_width": jx.plan.bin_width,
              "k": jx.plan.k, "fs": jx.plan.fs}
    tx = tg.GroupXcorrCZT.from_numpy_params(params, device="cpu")
    direct = tg.GroupXcorrCZT(y, starts, lengths, *grid,
                              dtype=tx.plan.dtype, device="cpu")
    assert tx.plan.k == jx.plan.k and tx.max_length == jx.max_length
    np.testing.assert_array_equal(tx.czt_freq, jx.czt_freq)
    torch.testing.assert_close(tx._tfold, direct._tfold, rtol=0, atol=0)
    shifts = np.arange(61)
    rxc = rx.astype(np.dtype(dtype))
    got = tx.xcorr(torch.from_numpy(rxc), shifts)[0].numpy()
    ref = np.asarray(jx.xcorr(jnp.asarray(rxc), jnp.asarray(shifts),
                              fused=False)[0])
    tol = 1e-4 if dtype == jnp.complex64 else 1e-9
    np.testing.assert_allclose(got, ref, atol=tol * ref.max())
    assert int(np.argmax(got.max(1))) == 30


def test_fold_tone_bank():
    rng = np.random.default_rng(3)
    ys, tones, ph = (_cplx(rng, s) for s in ((2, 5), (5, 3), (2, 3)))
    tf = tg.fold_tone_bank(ys, tones, ph)
    assert tf.shape == (10, 3)
    np.testing.assert_allclose(tf[5 + 2], ys[1, 2] * tones[2] * ph[1],
                               rtol=1e-15)


def test_group_xcorr_fft_matches_jax(rng):
    starts = np.arange(3) * 192
    lengths = np.full(3, 128)
    y, rx = _scene(rng, starts, lengths, 1000, 300)
    ygroups = np.stack([y[s: s + 128] for s in starts])
    shifts = np.arange(290, 311)
    for fftlen in (None, 256):
        ref = np.asarray(jg.GroupXcorrFFT(ygroups, starts, 1.0, fftlen=fftlen,
                                          dtype=jnp.complex128)
                         .xcorr(jnp.asarray(rx), jnp.asarray(shifts)))
        got = tg.GroupXcorrFFT(ygroups, starts, 1.0, fftlen=fftlen,
                               dtype=torch.complex128, device="cpu").xcorr(
            torch.from_numpy(rx), shifts).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-9
        si, fi = np.unravel_index(np.argmax(got), got.shape)
        assert shifts[si] == 300 and fi == 0


def test_group_xcorr_freq_list_matches_jax(rng):
    starts = np.arange(3) * 192
    lengths = np.array([128, 100, 128])
    y, rx = _scene(rng, starts, lengths, 1000, 300, fshift=0.003)
    freqs = np.arange(-0.01, 0.0101, 1e-3)
    shifts = np.arange(295, 306)
    jq, jf = jg.GroupXcorr(y, starts, lengths, freqs, 1.0,
                           dtype=jnp.complex128).xcorr(jnp.asarray(rx),
                                                       jnp.asarray(shifts))
    tq, tf = tg.GroupXcorr(y, starts, lengths, freqs, 1.0,
                           dtype=torch.complex128, device="cpu").xcorr(
        torch.from_numpy(rx), shifts, batch_size=4)
    assert np.abs(tq.numpy() - np.asarray(jq)).max() < 1e-9
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    i = int(torch.argmax(tq))
    assert shifts[i] == 300 and abs(float(tf[i]) - 0.003) < 1e-3


@pytest.mark.parametrize("return_max", [False, True])
def test_template_cross_correlator_matches_jax(rng, return_max):
    templates = np.exp(0.5j * np.pi * rng.integers(0, 4, (2, 64)))
    n = 512
    x = 0.01 * _cplx(rng, n)
    x[100:164] += templates[0]
    x[300:364] += templates[1]
    ref = jg.TemplateCrossCorrelator(templates, n, dtype=jnp.complex128
                                     ).correlate(jnp.asarray(x), return_max)
    got = tg.TemplateCrossCorrelator(templates, n, dtype=torch.complex128,
                                     device="cpu").correlate(
        torch.from_numpy(x), return_max)
    if return_max:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert int(got[1][100]) == 0 and int(got[1][300]) == 1
        got, ref = got[0], ref[0]
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-9
    assert abs(np.abs(got[..., 100]).max() - 1.0) < 0.05
    with pytest.raises(ValueError, match="length"):
        tg.TemplateCrossCorrelator(templates, n, device="cpu").correlate(
            torch.zeros(10, dtype=torch.complex64))


def test_group_xcorr_czt_permutations_matches_jax(rng):
    """Two groups, two candidate templates for group 0 and one for group 1:
    every template spectrum and the CAF of each permutation."""
    length, fs = 96, 1.0
    ygroups = np.exp(0.5j * np.pi * rng.integers(0, 4, (3, length)))
    idxs = np.array([0, 0, 1])
    gstarts = np.array([0, 200])
    rx = 0.05 * _cplx(rng, 700)
    rx[150: 150 + length] += ygroups[1]        # group 0 sent template 1
    rx[350: 350 + length] += ygroups[2]
    args = (ygroups, idxs, gstarts, -0.02, 0.02, 2e-3, fs)
    jp = jg.GroupXcorrCZTPermutations(*args, dtype=jnp.complex128)
    tp = tg.GroupXcorrCZTPermutations(*args, dtype=torch.complex128,
                                      device="cpu")
    shifts = np.arange(140, 161)
    np.testing.assert_array_equal(
        tp.xcorr(torch.from_numpy(rx), shifts, batch_size=4),
        jp.xcorr(jnp.asarray(rx), jnp.asarray(shifts)))
    assert np.abs(tp.xc_templates.numpy()
                  - np.asarray(jp.xc_templates)).max() < 1e-9
    np.testing.assert_allclose(tp.rx_group_norm_sq.numpy(),
                               np.asarray(jp.rx_group_norm_sq), rtol=1e-12)
    for choice in ([0, 0], [1, 0]):
        got = tp.get_caf(choice).numpy()
        ref = np.asarray(jp.get_caf(choice))
        assert np.abs(got - ref).max() < 1e-9
    best = tp.get_caf([1, 0]).numpy()
    assert shifts[np.unravel_index(np.argmax(best), best.shape)[0]] == 150
    assert best.max() > tp.get_caf([0, 0]).numpy().max()
    with pytest.raises(ValueError, match="one template choice"):
        tp.get_caf([0])


def test_multi_preamble_correlator_matches_jax(rng):
    """tests/test_groupxcorr.py:151's scene: preamble 1 of 3, oversampled
    by 4, planted with a one-bin carrier offset."""
    import scipy.signal as sps
    k_, l_, osr, fsp = 3, 32, 4, 1000.0
    pres = np.exp(0.5j * np.pi * rng.integers(0, 4, (k_, l_))).astype(
        np.complex64)
    up = sps.resample_poly(pres[1], osr, 1).astype(np.complex64)
    x = (0.05 * _cplx(rng, 4000)).astype(np.complex64)
    df = fsp / l_
    x[1234: 1234 + up.size] += (up * np.exp(2j * np.pi * df * np.arange(
        up.size) / (osr * fsp))).astype(np.complex64)
    shifts = np.arange(1200, 1280)
    ref = np.asarray(jm.MultiPreambleCorrelator(pres, osr).correlate(
        jnp.asarray(x), jnp.asarray(shifts)))
    mc = tm.MultiPreambleCorrelator(pres, osr, device="cpu")
    got = mc.correlate(torch.from_numpy(x), shifts, batch_size=32).numpy()
    assert got.shape == ref.shape == (k_, 80, mc.c)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    ki, si, ci = np.unravel_index(np.argmax(got), got.shape)
    assert ki == 1 and shifts[si] == 1234
    np.testing.assert_allclose(mc.freq_offsets(fsp), jm.MultiPreambleCorrelator(
        pres, osr).freq_offsets(fsp))
    assert abs(mc.freq_offsets(fsp)[ci] - df) < fsp / l_ / 2 + 1e-9
    with pytest.raises(ValueError):
        tm.MultiPreambleCorrelator(pres, 0, device="cpu")


def test_group_xcorr_czt_exact_for_a_short_last_group_at_the_end(rng):
    """Groups of 128, 96 and 60 samples over every valid shift of a
    600-sample rx: the JAX XLA tier slices m = 128 samples for every group,
    so at the last 68 shifts the last group's slice runs past rx and clamps
    (its values move; ROADMAP Queue 3). The port reads each group's own
    samples where they lie: numpy truth within 1e-9 at every shift."""
    starts, lengths = np.array([0, 150, 420]), np.array([128, 96, 60])
    y = _cplx(rng, 480)
    rx = _cplx(rng, 600)
    shifts = np.arange(121)
    got, _ = tg.GroupXcorrCZT(y, starts, lengths, -0.01, 0.01, 5e-4, 1.0,
                              dtype=torch.complex128, device="cpu").xcorr(
        torch.from_numpy(rx))
    truth = _np_truth(y, starts, lengths, -0.01, 0.01, 5e-4, 1.0, rx, shifts)
    assert got.shape == truth.shape
    assert np.abs(got.numpy() - truth).max() < 1e-9


def test_tf32_round_is_cvt_rna(rng):
    """TF32 keeps 10 stored mantissa bits: x rounded to the nearest
    multiple of 2^(e - 10) (e = floor(log2|x|)), ties away from zero, as
    ``cvt.rna.tf32.f32``; the split's hi + lo is x to ~2^-22."""
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    q = np.abs(x.astype(np.float64)) / ulp
    want = np.sign(x) * np.floor(q + 0.5) * ulp
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                    np.float32)
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(ties)).numpy(),
                                  [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                   1 + 2 * 2.0 ** -10])
    hi, lo = tf32_split(torch.from_numpy(x))
    assert np.all(hi.numpy().view(np.int32) & 0x1FFF == 0)
    assert np.all(lo.numpy().view(np.int32) & 0x1FFF == 0)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert np.all(err <= 2.0 ** -22 * np.abs(x))


def test_tf32_planes_layout(rng):
    """The split tfold as the kernel's shared-memory image: padded to
    (32, 64) multiples with zeros; in tile (kb, nb), plane p (re hi, re lo,
    im hi, im lo), bin group ng, depth group kg, the 16 bytes of bin
    nb*64 + ng*8 + r hold depths kb*32 + kg*4 .. + 3; and unpacked back to
    the split planes."""
    tf = _cplx(rng, (40, 21), np.complex64)
    planes = tf32_planes(torch.from_numpy(tf))
    assert planes.shape == (64 // 32, 64 // 64, 4, 8, 8, 8, 4)
    assert planes.dtype == torch.float32
    kb, nb, ng, kg, r = 1, 0, 1, 1, 5
    row, col = kb * 32 + kg * 4, nb * 64 + ng * 8 + r
    hi, lo = tf32_split(torch.from_numpy(np.ascontiguousarray(tf.imag)))
    np.testing.assert_array_equal(planes[kb, nb, 3, ng, kg, r].numpy(),
                                  lo[row: row + 4, col].numpy())
    np.testing.assert_array_equal(planes[kb, nb, 2, ng, kg, r].numpy(),
                                  hi[row: row + 4, col].numpy())
    assert float(planes[1, :, :, :, 2:].abs().max()) == 0.0   # depths 40..63
    assert float(planes[:, :, :, 3:].abs().max()) == 0.0   # bins 24..63
    back = planes_unpacked(planes, 40, 21)
    for p, part in enumerate((tf.real, tf.imag)):
        for h, want in enumerate(tf32_split(
                torch.from_numpy(np.ascontiguousarray(part)))):
            torch.testing.assert_close(back[p, h], want, rtol=0, atol=0)


def _staged_qf2(tx, rx, shifts):
    """The Hopper kernel's 3xTF32 arithmetic over a CPU plan's folded tone
    bank, on the QF^2 scale ``GroupXcorrCZT.xcorr`` returns."""
    rxt, sh = torch.from_numpy(rx), torch.as_tensor(shifts)
    mag = group_caf_staged(rxt, sh, tx._starts_t, tf32_planes(tx._tfold),
                           tx.max_length, tx.plan.k)
    norms = tg._group_energy(power_prefix(rxt), sh, tx.starts, tx.lengths)
    return (mag.double() / norms[:, None] / tx.ystack_norm_sq).numpy()


@pytest.mark.parametrize("geom", GEOMS[:2], ids=["uniform", "ragged"])
def test_group_caf_staged_matches_numpy(rng, geom):
    """The kernel's 3xTF32 product against the float64 numpy re-derivation
    on the whole QF^2 grid within GROUP_QF2_ATOL, the planted shift exact;
    and against the full-f32 twin to the same bound."""
    starts, lengths, f1, f2, bw, fs = geom
    y, rx = _scene(rng, starts, lengths, int(np.max(starts + lengths)) + 400,
                   300, fshift=0.004, dtype=np.complex64)
    shifts = np.arange(280, 320)
    tx = tg.GroupXcorrCZT(y, starts, lengths, f1, f2, bw, fs, device="cpu")
    got = _staged_qf2(tx, rx, shifts)
    truth = _np_truth(y, starts, lengths, f1, f2, bw, fs, rx, shifts)
    assert np.abs(got - truth).max() < GROUP_QF2_ATOL
    assert shifts[np.unravel_index(np.argmax(got), got.shape)[0]] == 300
    twin = tx.xcorr(torch.from_numpy(rx), shifts)[0].numpy()
    assert np.abs(got - twin).max() < GROUP_QF2_ATOL


def test_group_caf_staged_matches_the_jax_kernel(rng):
    """The kernel's 3xTF32 product against the JAX group CAF kernel itself
    (Pallas, interpret mode, bf16 operands) at its bounds, G = 4, m = 128,
    k = 16, 64 shifts: the planted peak exact, within rtol 2e-2 there and
    atol 5e-3*max on the grid."""
    y, rx, starts, lengths, grid = _kernel_scene(rng)
    shifts = np.arange(64, 128)
    jx = jg.GroupXcorrCZT(y, starts, lengths, *grid)
    consts = jx._fused_consts(batch=64, step=1)
    ref = np.asarray(jx._xcorr_fused(jnp.asarray(rx), jnp.asarray(shifts),
                                     consts, formulation="pallas"))
    tx = tg.GroupXcorrCZT(y, starts, lengths, *grid, device="cpu")
    got = _staged_qf2(tx, rx, shifts)
    ri, rj = np.unravel_index(np.argmax(ref), ref.shape)
    assert np.unravel_index(np.argmax(got), got.shape) == (ri, rj)
    assert shifts[ri] == 97
    np.testing.assert_allclose(got[ri, rj], ref[ri, rj], rtol=2e-2)
    np.testing.assert_allclose(got, ref, rtol=0.2, atol=5e-3 * ref.max())
