"""The TDOA/FDOA workflow of ``examples/tdoa_pipeline.py`` at its own size
(an 8192-sample QPSK burst, 16,384-sample captures, fs 100 kHz, a delay of
1234.5 samples and a 213.4 Hz Doppler) through the JAX package and the port
on one scene: the scene is made once by the port's own generators on the
CPU and the same numpy arrays go through both packages.

Held: the coarse shift and bin equal; the fine delay within 1e-3 samples
(and both within 0.05 of the truth); the fine frequency within 1e-3 Hz; the
TDOA grid's argmin equal; the hyperboloid x WGS84 ground curve equal to
1e-9 relative. The CZT stage's frequency is held to a float64 direct DFT at
the CZT's bins: the port's is its argmax, the JAX package's may be one CZT
step off (its Bluestein constants are rounded to complex64, which errs by
~1.3e-2 on the QF^2 scale at n = 8192). The JAX coarse search runs its
XLA route (``_fast_xcorr_impl(..., interpret=False)``): the public
function interprets the Pallas kernel on the CPU at complex64, which is
slow at n = 8192.
"""

import jax.numpy as jnp
import numpy as np
import torch

import pydsproutines_tpu.ops.xcorr as jx
from pydsproutines_tpu.estimation.geometry import Hyperboloid as JaxHyp
from pydsproutines_tpu.estimation.localization import \
    grid_search_tdoa as jax_grid
from pydsproutines_tpu_torch.estimation.geometry import Hyperboloid
from pydsproutines_tpu_torch.estimation.localization import grid_search_tdoa
from pydsproutines_tpu_torch.ops import (czt_xcorr, fast_xcorr,
                                         fine_freq_time_search)
from pydsproutines_tpu_torch.signal import (add_sig_to_noise,
                                            propagate_signal, rand_psk_syms)

FS, N, NRX = 100e3, 8192, 16384
TRUE_FD = 213.4
C = 299792458.0


def _scene():
    """The example's scene, made by the port's generators on the CPU."""
    gen = torch.Generator().manual_seed(0)
    burst, _ = rand_psk_syms(gen, N, 4, device="cpu")
    _, rx1 = add_sig_to_noise(gen, burst, NRX, 1000, snr_inband_linear=100.0,
                              device="cpu")
    delayed, _ = propagate_signal(burst, 0.5 / FS, FS, freq=TRUE_FD)
    _, rx2 = add_sig_to_noise(gen, delayed, NRX, 2234,
                              snr_inband_linear=100.0, device="cpu")
    return rx1.numpy(), rx2.numpy()


def _coarse_fd(bin_):
    return bin_ * FS / N if bin_ < N // 2 else (bin_ - N) * FS / N


def _czt_truth(rx1, rx2, shift, freqs):
    """argmax over ``freqs`` of |DFT of rx2[shift:] * conj(cutout)|, in
    float64."""
    y = (rx2[shift:shift + N].astype(np.complex128)
         * np.conj(rx1[1000:1000 + N].astype(np.complex128)))
    n = np.arange(N)
    mag = [abs(np.sum(y * np.exp(-2j * np.pi * f * n / FS))) for f in freqs]
    return float(freqs[int(np.argmax(mag))])


def _port(rx1, rx2):
    rx1, rx2 = torch.from_numpy(rx1), torch.from_numpy(rx2)
    cutout = rx1[1000:1000 + N]
    qf2, bins = fast_xcorr(cutout, rx2, freqsearch=True)
    shift = int(torch.argmax(qf2))
    bin_ = int(bins[shift])
    fd = _coarse_fd(bin_)
    _, fhz = czt_xcorr(cutout, rx2, fd - 2 * FS / N, fd + 2 * FS / N, FS,
                       czt_step=0.5, shifts=np.array([shift]))
    ff, td, _ = fine_freq_time_search(
        cutout, rx2[shift:shift + N], fine_res=[0.5, 0.1],
        freqfound=float(fhz[0]), freq_res=FS / N, fs=FS,
        td_scan_range=torch.from_numpy(np.arange(-1.0, 1.0, 0.01) / FS))
    truth = _czt_truth(rx1.numpy(), rx2.numpy(), shift,
                       np.arange(fd - 2 * FS / N, fd + 2 * FS / N, 0.5))
    return shift, bin_, float(fhz[0]), float(ff), float(td) * FS, truth


def _jax(rx1, rx2):
    rx1, rx2 = jnp.asarray(rx1), jnp.asarray(rx2)
    cutout = rx1[1000:1000 + N]
    qf2, bins = jx._fast_xcorr_impl(
        cutout, rx2, jnp.arange(NRX - N + 1), n=N, freqsearch=True,
        output_caf=False, abs_result=True, batch_size=128, step=1,
        interpret=False)
    shift = int(np.argmax(np.asarray(qf2)))
    bin_ = int(np.asarray(bins)[shift])
    fd = _coarse_fd(bin_)
    _, fhz = jx.czt_xcorr(cutout, rx2, fd - 2 * FS / N, fd + 2 * FS / N, FS,
                          czt_step=0.5, shifts=np.array([shift]))
    ff, td, _ = jx.fine_freq_time_search(
        cutout, rx2[shift:shift + N], fine_res=[0.5, 0.1],
        freqfound=float(np.asarray(fhz)[0]), freq_res=FS / N, fs=FS,
        td_scan_range=np.arange(-1.0, 1.0, 0.01) / FS)
    return shift, bin_, float(np.asarray(fhz)[0]), float(ff), float(td) * FS


def test_tdoa_workflow_matches_jax():
    rx1, rx2 = _scene()
    p, j = _port(rx1, rx2), _jax(rx1, rx2)
    assert p[:2] == j[:2]
    assert p[0] - 1000 == 1234
    assert abs(_coarse_fd(p[1]) - TRUE_FD) <= FS / N
    assert abs(p[2] - p[5]) < 1e-3 and abs(j[2] - p[5]) <= 0.5 + 1e-3
    assert abs(p[3] - j[3]) < 1e-3
    assert abs(p[3] - TRUE_FD) < 1.0
    delay, jdelay = p[0] - 1000 + p[4], j[0] - 1000 + j[4]
    assert abs(delay - jdelay) <= 1e-3
    assert abs(delay - 1234.5) < 0.05 and abs(jdelay - 1234.5) < 0.05


def test_tdoa_grid_matches_jax():
    """The example's step 5: two sensor pairs on a 10 km flat grid."""
    s1 = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    s2 = np.array([[8000.0, 0.0, 0.0], [0.0, 8000.0, 0.0]])
    tgt = np.array([3000.0, 2000.0, 0.0])
    tds = [(np.linalg.norm(tgt - b) - np.linalg.norm(tgt - a)) / C
           for a, b in zip(s1, s2)]
    xr = np.arange(0.0, 10000.0, 100.0)
    cost = grid_search_tdoa(s1, s2, tds, [1e-7, 1e-7], xr, xr, 0.0,
                            device="cpu").numpy().reshape(len(xr), len(xr))
    ref = np.asarray(jax_grid(s1, s2, tds, [1e-7, 1e-7], xr, xr,
                              0.0)).reshape(len(xr), len(xr))
    assert np.all(np.abs(cost - ref) <= 1e-4 * np.maximum(1.0, np.abs(ref)))
    ij = np.unravel_index(np.argmin(cost), cost.shape)
    assert ij == np.unravel_index(np.argmin(ref), ref.shape)
    assert (xr[ij[1]], xr[ij[0]]) == (3000.0, 2000.0)


def test_hyperboloid_ground_curve_matches_jax():
    """The example's step 6: two GEO relays, TDOA hyperboloid x WGS84."""
    a_wgs, b_wgs = 6378137.0, 6356752.314245
    lat, lon = np.deg2rad(35.0), np.deg2rad(127.0)
    e2 = 1 - (b_wgs / a_wgs) ** 2
    nrad = a_wgs / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    emitter = np.array([nrad * np.cos(lat) * np.cos(lon),
                        nrad * np.cos(lat) * np.sin(lon),
                        nrad * (1 - e2) * np.sin(lat)])
    r_geo = 42164e3
    sat1 = r_geo * np.array([np.cos(np.deg2rad(116.0)),
                             np.sin(np.deg2rad(116.0)), 0.0])
    sat2 = r_geo * np.array([np.cos(np.deg2rad(113.0)),
                             np.sin(np.deg2rad(113.0)), 0.0])
    rd = np.linalg.norm(sat2 - emitter) - np.linalg.norm(sat1 - emitter)
    hyp = Hyperboloid.from_foci(sat1, sat2, rd)
    curve, ve = hyp.intersect_oblate_spheroid(num_pts=500)
    ref, jve = JaxHyp.from_foci(sat1, sat2, rd).intersect_oblate_spheroid(
        num_pts=500)
    assert curve.shape == ref.shape and curve.shape[1] > 100
    assert np.max(np.abs(curve - ref)) <= 1e-9 * np.max(np.abs(ref))
    np.testing.assert_allclose(ve, jve, rtol=1e-9)
    assert np.linalg.norm(curve - emitter[:, None], axis=0).min() < 50e3
