"""Parity of the port's ``signal/`` and ``utils.freq`` tones with the JAX
package: the same numpy inputs through both, on the CPU.

Tolerance: max |port - jax| <= rtol * max |jax|, rtol 1e-12 in float64 and
1e-5 in float32. A carrier phase of ~4e5 rad (300 MHz over ~200 us) holds
its float64 fraction only to its ulp (5.8e-11 rad), and XLA rounds that sum
once differently from numpy and torch: there the bound adds 4 ulps of the
largest phase, and the port is held to a numpy float64 formula as well. The
random generators cannot replay a JAX key; they are held by shape, range,
noise power (within 5% at 2^16 samples) and by giving the same output for
the same ``torch.Generator`` seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.signal import channelsim as jcs
from pydsproutines_tpu.signal import creation as jcr
from pydsproutines_tpu.signal.pulses import make_scaled_src4
from pydsproutines_tpu.utils import freq as jfreq
from pydsproutines_tpu_torch.signal import channelsim as tcs
from pydsproutines_tpu_torch.signal import creation as tcr
from pydsproutines_tpu_torch.utils import freq as tfreq

RTOL = {torch.complex128: 1e-12, torch.complex64: 1e-5,
        torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.complex128: jnp.complex128, torch.complex64: jnp.complex64,
       torch.float64: jnp.float64, torch.float32: jnp.float32}
CDTYPES = [torch.complex128, torch.complex64]


def close(port, ref, dtype, phase=0.0):
    """max |port - ref| <= (rtol + 4 ulps of ``phase``) * max |ref|."""
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.max(np.abs(port - ref)) if ref.size else 0.0
    rtol = RTOL[dtype] + 4 * np.finfo(np.float64).eps * phase
    assert err <= rtol * max(np.max(np.abs(ref)), 1e-300), err


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# utils.freq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("length,freq,fs,phase", [
    (1000, 0.013, 1.0, 0.0), (4096, 213.4, 100e3, 0.7), (7, -3e3, 1e4, -2.0)])
def test_tone_matches_jax(dtype, length, freq, fs, phase):
    got = tfreq.tone(length, freq, fs, phase, dtype=dtype, device="cpu")
    assert got.dtype == dtype
    close(got, jfreq.tone(length, freq, fs, phase, dtype=JDT[dtype]), dtype)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64,
                                   torch.float64, torch.float32])
def test_freqshift_signal_matches_jax(rng, dtype):
    x = rng.standard_normal(513)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(513)
    x = x.astype(np.dtype(str(dtype).split(".")[1]))
    got = tfreq.freqshift_signal(torch.from_numpy(x), 1234.5, 1e5)
    ref = jfreq.freqshift_signal(jnp.asarray(x), 1234.5, 1e5)
    cdt = torch.complex128 if dtype in (torch.complex128, torch.float64) \
        else torch.complex64
    assert got.dtype == cdt
    close(got, ref, cdt)


# ---------------------------------------------------------------------------
# deterministic creation functions, from the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("dtype", CDTYPES)
def test_syms_from_bits_matches_jax(rng, m, dtype):
    bits = rng.integers(0, m, 300).astype(np.uint8)
    got = tcr.syms_from_bits(torch.from_numpy(bits), m, dtype)
    close(got, jcr.syms_from_bits(jnp.asarray(bits), m, JDT[dtype]), dtype)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("m,h,up,phase", [(2, 0.5, 8, 0.0), (2, 0.7, 4, 1.1),
                                          (4, 0.25, 8, 0.0)])
def test_make_cpfsk_syms_matches_jax(rng, dtype, m, h, up, phase):
    """m = 4 follows the JAX package's data = bits*m - 1 (not a ±1 or ±1/±3
    alphabet): the quirk is kept."""
    bits = rng.integers(0, m, 97).astype(np.uint8)
    sig, fs, data = tcr.make_cpfsk_syms(torch.from_numpy(bits), 1e3, m, h, up,
                                        phase, dtype)
    rsig, rfs, rdata = jcr.make_cpfsk_syms(jnp.asarray(bits), 1e3, m, h, up,
                                           phase, JDT[dtype])
    assert fs == rfs and sig.shape == (97 * up,)
    np.testing.assert_array_equal(data.numpy(), np.asarray(rdata))
    close(sig, rsig, dtype)
    if m == 4:
        assert set(np.unique(data.numpy())) <= {-1, 3, 7, 11}


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("pulse", ["default", "src4"])
def test_make_pulsed_cpfsk_syms_matches_jax(rng, dtype, pulse):
    up = 8
    g = None if pulse == "default" else make_scaled_src4(up)
    bits = rng.integers(0, 2, 120).astype(np.uint8)
    sig, fs, data, css = tcr.make_pulsed_cpfsk_syms(
        torch.from_numpy(bits), 2e3, g, 2, 0.5, up, 0.3, dtype)
    rsig, rfs, rdata, rcss = jcr.make_pulsed_cpfsk_syms(
        jnp.asarray(bits), 2e3, None if g is None else jnp.asarray(g), 2,
        0.5, up, 0.3, JDT[dtype])
    glen = up if g is None else g.size
    assert fs == rfs and sig.shape == (120 * up + glen,)
    np.testing.assert_array_equal(data.numpy(), np.asarray(rdata))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    close(css, rcss, rdt)
    close(sig, rsig, dtype)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("time", [0.37e-5, np.array([0.5e-5, -1.25e-5, 0.0])])
@pytest.mark.parametrize("freq", [None, 213.4])
@pytest.mark.parametrize("rows", [1, 3])
def test_propagate_signal_matches_jax(rng, dtype, time, freq, rows):
    n = 256
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(
        np.complex128 if dtype == torch.complex128 else np.complex64)
    x = x[0] if rows == 1 else x
    if rows == 3 and np.ndim(time) == 0:
        time = np.full(3, time)
    got = tcr.propagate_signal(torch.from_numpy(x), time, 1e5, freq)
    ref = jcr.propagate_signal(jnp.asarray(x), time, 1e5, freq)
    if freq is None:
        close(got, ref, dtype)
        if np.ndim(time) == 0:
            assert got.ndim == 1            # a scalar time gives the row
    else:
        close(got[0], ref[0], dtype)
        close(got[1], ref[1], dtype)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("f_c", [0.0, 3e8])
def test_propagate_signal_exact_matches_jax(rng, dtype, f_c):
    n = 256
    npd = np.complex128 if dtype == torch.complex128 else np.complex64
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(npd)
    tau = 3e-4 + 2.5e-6 * np.sin(np.arange(n) / 40.0)     # float64 delays
    got = tcr.propagate_signal_exact(torch.from_numpy(x),
                                     torch.from_numpy(tau), 1e6, f_c)
    ref = jcr.propagate_signal_exact(jnp.asarray(x), jnp.asarray(tau), 1e6,
                                     f_c)
    assert got.dtype == dtype
    close(got, ref, dtype)


@pytest.mark.parametrize("start", [0, 100, 450, 470, 10_000])
@pytest.mark.parametrize("fshift", [None, 0.01])
def test_add_sig_to_noise_at_infinite_snr_matches_jax(rng, start, fshift):
    """Starts past noise_len - len(signal) (470, 10_000) are clamped so the
    signal fits, as jax.lax.dynamic_update_slice clamps them."""
    sig = (rng.standard_normal(50) + 1j * rng.standard_normal(50))
    got = tcr.add_sig_to_noise(None, torch.from_numpy(sig), 500, start,
                               fshift=fshift, device="cpu")
    ref = jcr.add_sig_to_noise(None, jnp.asarray(sig), 500, start,
                               fshift=fshift)
    assert len(got) == len(ref) == (2 if fshift is None else 3)
    for a, b in zip(got, ref):
        close(a, b, torch.complex128)
    if start >= 450 and fshift is None:
        np.testing.assert_array_equal(got[1][450:].numpy(), sig)


def test_add_sig_to_noise_rejects_a_signal_longer_than_the_noise():
    with pytest.raises(ValueError, match="does not fit"):
        tcr.add_sig_to_noise(None, torch.ones(10), 5, device="cpu")


def test_add_many_sig_to_noise_signal_part_matches_jax(rng):
    """The noise draw differs (generator vs key); rx - noise is the placed,
    scaled and shifted signals, which must agree."""
    sigs = [rng.standard_normal(40) + 1j * rng.standard_normal(40)
            for _ in range(3)]
    starts, snrs, shifts = [5, 100, 300], [10.0, 40.0, 2.5], [0.0, 0.1, -0.2]
    noise, rx = tcr.add_many_sig_to_noise(gen(), 320, starts, sigs, 1.0, 1.0,
                                          snrs, shifts, device="cpu")
    jn, jrx = jcr.add_many_sig_to_noise(jax.random.key(0), 320, starts,
                                        [jnp.asarray(s) for s in sigs], 1.0,
                                        1.0, snrs, shifts)
    close(rx - noise, np.asarray(jrx) - np.asarray(jn), torch.complex128)


# ---------------------------------------------------------------------------
# random generators: shape, range, power, reproducibility
# ---------------------------------------------------------------------------

def test_rand_bits_and_psk_syms():
    bits = tcr.rand_bits(gen(3), 10_000, 4, device="cpu")
    assert bits.shape == (10_000,) and bits.dtype == torch.uint8
    assert set(torch.unique(bits).tolist()) == {0, 1, 2, 3}
    assert torch.equal(bits, tcr.rand_bits(gen(3), 10_000, 4, device="cpu"))
    syms, b2 = tcr.rand_psk_syms(gen(3), 10_000, 4, device="cpu")
    assert torch.equal(b2, bits) and syms.dtype == torch.complex64
    close(syms, jcr.syms_from_bits(jnp.asarray(bits.numpy()), 4),
          torch.complex64)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("bw,chn,snr,pwr", [(1.0, 1.0, 10.0, 1.0),
                                            (0.125, 1.0, 10.0, 2.0)])
def test_randnoise_power_and_reproducibility(dtype, bw, chn, snr, pwr):
    n = 1 << 16
    x = tcr.randnoise(gen(7), n, bw, chn, snr, pwr, dtype, device="cpu")
    assert x.shape == (n,) and x.dtype == dtype
    want = pwr / snr * chn / bw
    got = float((x.abs() ** 2).mean())
    assert abs(got / want - 1) < 0.05
    assert abs(float((x.real ** 2).mean()) / (want / 2) - 1) < 0.05
    assert torch.equal(x, tcr.randnoise(gen(7), n, bw, chn, snr, pwr, dtype,
                                        device="cpu"))
    assert not torch.equal(x, tcr.randnoise(gen(8), n, bw, chn, snr, pwr,
                                            dtype, device="cpu"))


def test_add_sig_to_noise_noise_power():
    n = 1 << 16
    sig = torch.ones(1000, dtype=torch.complex64)
    noise, rx = tcr.add_sig_to_noise(gen(1), sig, n, 500, 0.5, 1.0, 10.0,
                                     device="cpu")
    assert abs(float((noise.abs() ** 2).mean()) / 0.2 - 1) < 0.05
    close(rx - noise, np.pad(np.ones(1000), (500, n - 1500)),
          torch.complex64)


# ---------------------------------------------------------------------------
# channelsim: all four classes, mask edges included
# ---------------------------------------------------------------------------

def _phase_curve(rng, n=200):
    return np.cumsum(rng.standard_normal(n) * 0.3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sampled_linear_interpolator_matches_jax(rng, dtype):
    npd = np.dtype(str(dtype).split(".")[1])
    y = _phase_curve(rng).astype(npd)
    xq = np.concatenate([rng.uniform(-1e-3, 0.21, 300),
                         [0.0, 0.199, 0.2, 0.25]]).astype(npd)
    got = tcs.SampledLinearInterpolator(y, 1e-3, device="cpu").lerp(xq)
    ref = jcs.SampledLinearInterpolator(y, 1e-3).lerp(xq)
    close(got, ref, dtype)


def _times(t0, t1, fs, pad):
    t = np.arange(int((t1 - t0 + 2 * pad) * fs)) / fs + t0 - pad
    return t


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_const_amp_sig_lerp_matches_jax_at_the_mask_edges(rng, dtype):
    fs, fc = 1e6, 3e8 if dtype == torch.float64 else 1e3
    npd = np.dtype(str(dtype).split(".")[1])
    pv = _phase_curve(rng).astype(npd)
    t0, t1 = 1e-4, 1e-4 + 199 / fs
    t = _times(t0, t1, fs, 30 / fs).astype(npd)
    tau = (3e-4 + 1e-9 * np.arange(t.size)).astype(npd)
    # put samples exactly on both edges of the span
    t[10] = t0 + tau[10]
    t[-10] = t1 + tau[-10]
    port = tcs.ConstAmpSigLerp(t0, t1, pv, 1 / fs, 1.5, fc, device="cpu")
    ref = jcs.ConstAmpSigLerp(t0, t1, pv, 1 / fs, 1.5, fc)
    got = port.propagate(t, tau, 0.4)
    want = ref.propagate(jnp.asarray(t), jnp.asarray(tau), 0.4)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    assert got.dtype == cdt
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
    close(got, want, cdt, phase=2 * np.pi * fc * float(tau.max()))


def test_const_amp_carrier_is_formed_in_float64():
    """fc = 300 MHz, tau ~ 300 us: ~5.7e5 rad of carrier. Held against a
    numpy float64 formula of the same expression (equal to rounding); a
    float32 phase would be off by ~0.03 rad."""
    fs, fc, t0 = 1e6, 3e8, -5e-4
    n = 4096
    t = np.arange(n) / fs
    tau = 3e-4 + t * 250 / 299792458.0
    pv = np.cumsum(np.random.default_rng(5).standard_normal(8192) * 0.1)
    sig = tcs.ConstAmpSigLerp(t0, t0 + 8191 / fs, pv, 1 / fs, 1.0, fc,
                              device="cpu")
    got = sig.propagate(t, tau, 0.2).numpy()
    xg = (t - tau - t0) / (1 / fs)
    phase = np.interp(xg, np.arange(8192), pv)
    want = np.exp(1j * (phase + -2.0 * np.pi * fc * tau + 0.2))
    assert np.max(np.abs(got - want)) < 1e-9
    f32 = tcs.ConstAmpSigLerp(t0, t0 + 8191 / fs, pv.astype(np.float32),
                              1 / fs, 1.0, fc, device="cpu").propagate(
        t.astype(np.float32), tau.astype(np.float32), 0.2).numpy()
    assert np.max(np.abs(f32 - want)) > 1e-3


def test_bursty_and_multi_match_jax(rng):
    fs, fc = 1e6, 3e8
    t = np.arange(3000) / fs
    tau = 2e-4 + 5e-9 * np.arange(3000)
    CARRIER = 2 * np.pi * fc * (tau.max() + 2e-5)
    bursts = []
    for b in range(2):
        port_b = tcs.ConstAmpSigLerpBursty(device="cpu")
        jax_b = jcs.ConstAmpSigLerpBursty()
        for k in range(3):
            pv = _phase_curve(rng, 300)
            t0 = 1e-4 + k * 8e-4 + b * 3e-5
            args = (t0, t0 + 299 / fs, pv, 1 / fs, 1.0 + k, fc)
            port_b.add_signal(tcs.ConstAmpSigLerp(*args, device="cpu"))
            jax_b.add_signal(jcs.ConstAmpSigLerp(*args))
        phis = rng.uniform(-np.pi, np.pi, 3)
        jumps = rng.uniform(0, 2e-5, 3)
        bursts.append((port_b, jax_b, phis, jumps))
        close(port_b.propagate(t, tau, phis, jumps),
              jax_b.propagate(jnp.asarray(t), jnp.asarray(tau), phis, jumps),
              torch.complex128, phase=CARRIER)
    port_m = tcs.ConstAmpSigLerpBurstyMulti(device="cpu")
    jax_m = jcs.ConstAmpSigLerpBurstyMulti()
    for pb, jb, _, _ in bursts:
        port_m.add_signal(pb)
        jax_m.add_signal(jb)
    phis = [b[2] for b in bursts]
    jumps = [b[3] for b in bursts]
    close(port_m.propagate(t, tau, phis, jumps),
          jax_m.propagate(jnp.asarray(t), jnp.asarray(tau), phis, jumps),
          torch.complex128, phase=CARRIER)
    empty = tcs.ConstAmpSigLerpBurstyMulti(device="cpu").propagate(t, tau,
                                                                  [], [])
    assert empty.dtype == torch.complex128 and not bool(empty.abs().any())


def test_propagate_signal_exact_holds_large_float32_phases():
    """At N = 2048, fs = 1 MHz the basis phase reaches ~5.5e3 rad in float32;
    the result must equal float64 arithmetic on those very float32 phases,
    n / fs rounded once (an ulp of n / fs moves the phase by ~1e-3)."""
    n, fs, fc = 2048, 1e6, 3e8
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    tau = 3e-4 + 1e-9 * np.arange(n)
    got = tcr.propagate_signal_exact(torch.from_numpy(x),
                                     torch.from_numpy(tau), fs, fc).numpy()
    f = tfreq.make_freq(n, fs, torch.float32).numpy()
    ntau = np.arange(n, dtype=np.float32) / np.float32(fs) \
        - tau.astype(np.float32)
    phase = (np.float32(2 * np.pi) * ntau)[:, None] * f[None, :]
    want = (np.exp(1j * phase.astype(np.float64))
            @ np.fft.fft(x.astype(np.complex128))) / n \
        * np.exp(-2j * np.pi * fc * tau)
    assert np.abs(phase).max() > 5e3
    close(got, want, torch.complex64)
