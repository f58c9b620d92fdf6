"""Parity of the port's ``estimation/localization`` with the JAX package:
the grid searches on the grids of ``tests/test_estimation.py`` and on a
LatLon ECEF grid, the range rate and the Doppler, the localizers, and the
rule that every new entry point targets the card when given no device.

Tolerances: argmin equal; float32 costs (TDOA, FDOA, TDFD) within
|port - jax| <= 1e-4 * max(1, |jax|); float64 costs (RTT, blind RTT) rtol
1e-10; range rate and Doppler rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from pydsproutines_tpu.estimation import localization as jl
from pydsproutines_tpu_torch import estimation as te
from pydsproutines_tpu_torch.estimation import localization as tl

C = 299792458.0


def f32_close(port, ref):
    port = port.cpu().numpy()
    ref = np.asarray(ref)
    assert port.dtype == np.float32 and port.shape == ref.shape
    assert np.all(np.abs(port - ref) <= 1e-4 * np.maximum(1.0, np.abs(ref)))
    assert int(np.argmin(port)) == int(np.argmin(ref))


def f64_close(port, ref, rtol=1e-10):
    port = port.cpu().numpy()
    ref = np.asarray(ref)
    assert port.dtype == np.float64 and port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=0)
    assert int(np.argmin(port)) == int(np.argmin(ref))


def _tdoa_scene():
    target = np.array([300.0, 400.0, 0.0])
    s1 = np.array([[0.0, 0.0, 0.0], [1000.0, 0.0, 0.0]])
    s2 = np.array([[0.0, 1000.0, 0.0], [1000.0, 1000.0, 0.0]])
    tdoa = (np.linalg.norm(s2 - target, axis=1)
            - np.linalg.norm(s1 - target, axis=1)) / C
    return target, s1, s2, tdoa, np.full(2, 1e-9)


def _mesh(xs, ys=None):
    ys = xs if ys is None else ys
    xm, ym = np.meshgrid(xs, ys)
    return np.stack([xm.flatten(), ym.flatten(), np.zeros(xm.size)], axis=1)


def _fdoa_scene():
    target, s1, s2, tdoa, sigma = _tdoa_scene()
    s1v = np.tile(np.array([50.0, 0.0, 0.0]), (2, 1))
    s2v = np.tile(np.array([0.0, 50.0, 0.0]), (2, 1))
    fc = 1e9
    d1 = (target - s1) / np.linalg.norm(target - s1, axis=1, keepdims=True)
    d2 = (target - s2) / np.linalg.norm(target - s2, axis=1, keepdims=True)
    fdoa = (np.sum(d2 * s2v, axis=1) - np.sum(d1 * s1v, axis=1)) / C * fc
    return s1, s2, tdoa, sigma, s1v, s2v, fdoa, np.full(2, 0.01), fc


def test_range_rate_and_doppler_match_jax(rng):
    tx = rng.uniform(-1e4, 1e4, (5, 3))
    rx = rng.uniform(-1e4, 1e4, (5, 3))
    txv, rxv = rng.uniform(-300, 300, 3), rng.uniform(-300, 300, 3)
    for args in ((tx[0], rx[0]), (tx, rx), (tx, rx, txv, rxv),
                 (tx[1], rx, None, rxv)):
        got = tl.calculate_range_rate(*args, device="cpu")
        assert got.dtype == torch.float64
        f64_close(got, jl.calculate_range_rate(*args), rtol=1e-12)
        f64_close(tl.calculate_doppler(3e8, *args, device="cpu"),
                  jl.calculate_doppler(3e8, *args), rtol=1e-12)


def test_grid_search_tdoa_direct_matches_jax():
    target, s1, s2, tdoa, sigma = _tdoa_scene()
    grid = _mesh(np.arange(0, 1000, 10.0))
    got = tl.grid_search_tdoa_direct(s1, s2, tdoa, sigma, grid, device="cpu")
    f32_close(got, jl.grid_search_tdoa_direct(s1, s2, tdoa, sigma, grid))
    assert np.linalg.norm(grid[int(torch.argmin(got))] - target) <= 15.0


def test_grid_search_tdoa_flat_matches_jax():
    _, s1, s2, tdoa, sigma = _tdoa_scene()
    xs, ys = np.arange(0, 1000, 10.0), np.arange(-50, 950, 20.0)
    f32_close(tl.grid_search_tdoa(s1, s2, tdoa, sigma, xs, ys, 3.0,
                                  device="cpu"),
              jl.grid_search_tdoa(s1, s2, tdoa, sigma, xs, ys, 3.0))


def test_grid_search_fdoa_and_tdfd_match_jax():
    s1, s2, tdoa, sigma, s1v, s2v, fdoa, fds, fc = _fdoa_scene()
    xs = np.arange(5.0, 1000, 10.0)
    f32_close(tl.grid_search_fdoa(s1, s2, s1v, s2v, fdoa, fds, xs, xs, 0.0,
                                  fc, device="cpu"),
              jl.grid_search_fdoa(s1, s2, s1v, s2v, fdoa, fds, xs, xs, 0.0,
                                  fc))
    grid = _mesh(xs)
    f32_close(tl.grid_search_tdfd_direct(s1, s2, tdoa, sigma, s1v, s2v, fdoa,
                                         fds, fc, grid, device="cpu"),
              jl.grid_search_tdfd_direct(s1, s2, tdoa, sigma, s1v, s2v, fdoa,
                                         fds, fc, grid))


def test_grid_search_rtt_matches_jax():
    target = np.array([500.0, 300.0, 0.0])
    tx = np.array([[0.0, 0.0, 0.0], [1000.0, 0.0, 0.0], [0.0, 1000.0, 0.0]])
    toa = 2 * np.linalg.norm(tx - target, axis=1) / C
    grid = _mesh(np.arange(0, 1000, 5.0))
    got = tl.grid_search_rtt(tx, tx, toa, np.full(3, 1e-9), grid,
                             device="cpu")
    f64_close(got, jl.grid_search_rtt(tx, tx, toa, np.full(3, 1e-9), grid))
    # one transmitter row shared by every measurement
    f64_close(tl.grid_search_rtt(tx[0], tx, toa, np.full(3, 1e-9), grid,
                                 device="cpu"),
              jl.grid_search_rtt(tx[0], tx, toa, np.full(3, 1e-9), grid))


def test_grid_search_blind_linear_rtt_matches_jax():
    rng = np.random.default_rng(4)
    target = np.array([2500.0, -1200.0, 0.0])
    n = 24
    tx = rng.uniform(-8000, 8000, size=(n, 3))
    tx[:, 2] = 0.0
    t = np.linspace(0, 10, n)
    toa = 2 * np.linalg.norm(tx - target, axis=1) / C + 3e-6 * t + 5e-6
    grid = _mesh(np.linspace(-5000, 5000, 41))
    got = tl.grid_search_blind_linear_rtt(tx, tx, t, toa, np.full(n, 1e-9),
                                          grid, device="cpu")
    ref = jl.grid_search_blind_linear_rtt(tx, tx, t, toa, np.full(n, 1e-9),
                                          grid)
    f64_close(got, ref)


def test_grid_localizers_match_jax():
    target = np.array([120.0, -80.0, 0.0])
    sensors = np.array([[1000.0, 0, 0], [-1000, 300, 0],
                        [200, -900, 0], [-400, 800, 0]])
    s1 = np.repeat(sensors[:1], 3, axis=0)
    s2 = sensors[1:]
    td = (np.linalg.norm(s2 - target, axis=1)
          - np.linalg.norm(s1 - target, axis=1)) / C
    xr = np.linspace(-500, 500, 101)
    loc = te.TDOAGridLocalizer.from_xy_meshgrid(xr, xr, device="cpu")
    ref = jl.TDOAGridLocalizer.from_xy_meshgrid(xr, xr)
    np.testing.assert_array_equal(loc.gridmat, ref.gridmat)
    cost = loc.run(s1, s2, td, np.full(3, 1e-9))
    rcost = ref.run(s1, s2, td, np.full(3, 1e-9))
    f32_close(cost, rcost)
    np.testing.assert_array_equal(loc.localize(cost), ref.localize(rcost))
    assert np.linalg.norm(loc.localize(cost)[:2] - target[:2]) < 15.0


def test_tdfd_localizer_matches_jax():
    s1, s2, tdoa, sigma, s1v, s2v, fdoa, fds, fc = _fdoa_scene()
    xs = np.arange(5.0, 1000, 10.0)
    loc = te.TDFDGridLocalizer.from_xy_meshgrid(xs, xs, device="cpu")
    ref = jl.TDFDGridLocalizer.from_xy_meshgrid(xs, xs)
    args = (s1, s2, tdoa, sigma, s1v, s2v, fdoa, fds, fc)
    cost, rcost = loc.run(*args), ref.run(*args)
    f32_close(cost, rcost)
    np.testing.assert_array_equal(loc.localize(cost), ref.localize(rcost))


def test_blind_rtt_localizer_matches_jax():
    class PortLoc(te.BlindLinearRTTMixin, te.GridLocalizer):
        pass

    class JaxLoc(jl.BlindLinearRTTMixin, jl.GridLocalizer):
        pass

    rng = np.random.default_rng(9)
    tx = rng.uniform(-3000, 3000, size=(12, 3))
    t = np.linspace(0, 4, 12)
    target = np.array([400.0, 250.0, 0.0])
    toa = 2 * np.linalg.norm(tx - target, axis=1) / C + 1e-6 * t
    grid = _mesh(np.linspace(-1000, 1000, 21))
    xr = np.linspace(-1000, 1000, 21)
    loc, ref = PortLoc(grid, xr, xr, device="cpu"), JaxLoc(grid, xr, xr)
    cost = loc.run(tx, tx, t, toa, np.full(12, 1e-9))
    rcost = ref.run(tx, tx, t, toa, np.full(12, 1e-9))
    f64_close(cost, rcost)
    np.testing.assert_array_equal(loc.localize(cost), ref.localize(rcost))


@pytest.mark.parametrize("kind", ["td", "tdfd"])
def test_latlon_ecef_grid_matches_jax(kind):
    """An ECEF grid (~6.4e6 m) in float32 is held to ~0.5 m: parity is a
    float32 statement here."""
    from pydsproutines_tpu_torch.estimation.coords import geodetic_lla_to_ecef
    lat0, lon0 = 1.3, 103.8
    emitter = geodetic_lla_to_ecef(np.radians(1.31), np.radians(103.79),
                                   0.0)[:, 0]
    sensors = geodetic_lla_to_ecef(
        np.radians([1.0, 1.6, 1.5, 1.1]),
        np.radians([103.5, 103.6, 104.1, 104.0]),
        np.array([9000.0, 8000.0, 10000.0, 30.0])).T
    s1 = np.repeat(sensors[3:], 3, axis=0)
    s2 = sensors[:3]
    td = (np.linalg.norm(s2 - emitter, axis=1)
          - np.linalg.norm(s1 - emitter, axis=1)) / C
    sig = np.full(3, 3e-8)
    cls_t = te.TDOALatLonGridLocalizer if kind == "td" \
        else te.TDFDLatLonGridLocalizer
    cls_j = jl.TDOALatLonGridLocalizer if kind == "td" \
        else jl.TDFDLatLonGridLocalizer
    loc = cls_t.from_latlon_limits(lat0, lon0, 0.2, 0.2, 41, 51,
                                   device="cpu")
    ref = cls_j.from_latlon_limits(lat0, lon0, 0.2, 0.2, 41, 51)
    np.testing.assert_array_equal(loc.gridmat, ref.gridmat)
    if kind == "td":
        args = (s1, s2, td, sig)
    else:
        v = np.array([[0.0, 0.0, 0.0]] * 3)
        s2v = np.array([[150.0, -40.0, 0.0], [0.0, 200.0, 5.0],
                        [-120.0, 60.0, 0.0]])
        d1 = (emitter - s1) / np.linalg.norm(emitter - s1, axis=1)[:, None]
        d2 = (emitter - s2) / np.linalg.norm(emitter - s2, axis=1)[:, None]
        fd = (np.sum(d2 * s2v, axis=1) - np.sum(d1 * v, axis=1)) / C * 3e8
        args = (s1, s2, td, sig, v, s2v, fd, np.full(3, 0.5), 3e8)
    cost, rcost = loc.run(*args), ref.run(*args)
    f32_close(cost, rcost)
    got, want = loc.localize(cost), ref.localize(rcost)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_latlongrid_to_ecef_is_the_jax_package_s():
    got = tl.latlongrid_to_ecef(1.0, 103.0, 0.5, 0.5, 5, 7)
    ref = jl.latlongrid_to_ecef(1.0, 103.0, 0.5, 0.5, 5, 7)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_crbs_and_ellipse_are_the_jax_package_s(rng):
    x = np.array([120.0, -30.0, 0.0])
    s = rng.uniform(-5000, 5000, (3, 4))
    sdot = rng.uniform(-200, 200, (3, 4))
    pairs = [(1, 0), (2, 0), (3, 0)]
    crb, fim = tl.calc_crb_td(x, s, np.ones(3), pairs=pairs)
    rcrb, rfim = jl.calc_crb_td(x, s, np.ones(3), pairs=pairs)
    np.testing.assert_allclose(crb, rcrb, rtol=1e-12)
    cmat = np.eye(6)[:, 2:]
    got = tl.calc_crb_tdfd(x, s, np.ones(3), np.zeros(3), sdot,
                           np.full(3, 0.1), pairs=pairs, cmat=cmat)
    want = jl.calc_crb_tdfd(x, s, np.ones(3), np.zeros(3), sdot,
                            np.full(3, 0.1), pairs=pairs, cmat=cmat)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 *
                               np.abs(want).max())
    np.testing.assert_allclose(tl.project_crb_to_ellipse(got[:3, :3], x, 0.95),
                               jl.project_crb_to_ellipse(want[:3, :3], x,
                                                         0.95),
                               rtol=1e-12)


def _entry_points():
    """Every entry point of this slice that makes tensors from host inputs,
    called with no device."""
    from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB
    from pydsproutines_tpu_torch.models import CheckpointedXcorrPipeline
    from pydsproutines_tpu_torch.signal import channelsim as cs
    from pydsproutines_tpu_torch.signal import creation as cr
    from pydsproutines_tpu_torch.utils.freq import tone
    g = torch.Generator()
    grid = _mesh(np.arange(3.0))
    s = np.ones((1, 3))
    return {
        "tone": lambda: tone(8, 0.1),
        "rand_bits": lambda: cr.rand_bits(g, 8, 2),
        "rand_psk_syms": lambda: cr.rand_psk_syms(g, 8, 2),
        "randnoise": lambda: cr.randnoise(g, 8, 1.0, 1.0, 10.0),
        "add_sig_to_noise": lambda: cr.add_sig_to_noise(g, np.ones(4), 8),
        "add_many_sig_to_noise": lambda: cr.add_many_sig_to_noise(
            g, 8, [0], [np.ones(4)], 1.0, 1.0, [10.0]),
        "SampledLinearInterpolator": lambda: cs.SampledLinearInterpolator(
            np.ones(4), 1.0),
        "ConstAmpSigLerp": lambda: cs.ConstAmpSigLerp(0, 1, np.ones(4), 1.0,
                                                      1.0, 0.0),
        "ConstAmpSigLerpBursty": lambda: cs.ConstAmpSigLerpBursty(),
        "ConstAmpSigLerpBurstyMulti": lambda: cs.ConstAmpSigLerpBurstyMulti(),
        "calculate_range_rate": lambda: tl.calculate_range_rate(
            np.zeros(3), np.ones(3)),
        "calculate_doppler": lambda: tl.calculate_doppler(
            1e9, np.zeros(3), np.ones(3)),
        "grid_search_tdoa_direct": lambda: tl.grid_search_tdoa_direct(
            s, 2 * s, [0.0], [1e-9], grid),
        "grid_search_tdoa": lambda: tl.grid_search_tdoa(
            s, 2 * s, [0.0], [1e-9], [0.0, 1.0], [0.0, 1.0], 0.0),
        "grid_search_fdoa": lambda: tl.grid_search_fdoa(
            s, 2 * s, s, s, [0.0], [1.0], [0.0, 1.0], [0.0, 1.0], 0.0, 1e9),
        "grid_search_tdfd_direct": lambda: tl.grid_search_tdfd_direct(
            s, 2 * s, [0.0], [1e-9], s, s, [0.0], [1.0], 1e9, grid),
        "grid_search_rtt": lambda: tl.grid_search_rtt(
            s, s, [1e-6], [1e-9], grid),
        "grid_search_blind_linear_rtt":
            lambda: tl.grid_search_blind_linear_rtt(
                np.ones((3, 3)), np.ones((3, 3)), [0.0, 1.0, 2.0],
                [1e-6] * 3, [1e-9] * 3, grid),
        "TDOAGridLocalizer": lambda: te.TDOAGridLocalizer.from_xy_meshgrid(
            [0.0, 1.0], [0.0, 1.0]),
        "TDFDLatLonGridLocalizer":
            lambda: te.TDFDLatLonGridLocalizer.from_latlon_limits(
                1.0, 2.0, 0.1, 0.1, 3, 3),
        "CheckpointedXcorrPipeline": lambda: CheckpointedXcorrPipeline(
            XcorrDB(":memory:"), "t", np.ones(8, np.complex64), 1e6),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """With no device each entry point targets the card: without CUDA it
    raises (never a silent CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
