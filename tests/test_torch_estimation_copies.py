"""The port's copies of the JAX package's numpy-only modules (estimation
``coords``, ``crb``, ``ellipses``, ``trajectory``, ``geometry``, ``cluster``,
``satellites``; ``signal.pulses``) against the originals, on the inputs of
``tests/test_estimation.py``, ``test_satellites.py`` and
``test_cluster.py``, to 1e-12; and the public names of every module of the
slice (the copies, ``localization``, ``signal``, ``io.xcorrdb``,
``utils.metrics``, ``models.pipeline``) against the JAX package's."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

import pydsproutines_tpu.estimation as jest
import pydsproutines_tpu.signal as jsig
import pydsproutines_tpu_torch.estimation as pest
import pydsproutines_tpu_torch.signal as tsig

RTOL = 1e-12

MODULES = ["estimation.coords", "estimation.crb", "estimation.ellipses",
           "estimation.trajectory", "estimation.geometry",
           "estimation.cluster", "estimation.satellites",
           "estimation.localization", "signal.pulses", "signal.creation",
           "signal.channelsim", "io.xcorrdb", "utils.metrics",
           "utils.freq", "models.pipeline"]


def pair(name):
    return (importlib.import_module(f"pydsproutines_tpu.{name}"),
            importlib.import_module(f"pydsproutines_tpu_torch.{name}"))


def public_names(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


@pytest.mark.parametrize("name", MODULES)
def test_every_public_jax_name_exists_in_the_port(name):
    jmod, tmod = pair(name)
    missing = public_names(jmod) - set(vars(tmod))
    assert not missing, missing


@pytest.mark.parametrize("pkg", ["estimation", "signal"])
def test_package_exports_are_the_jax_package_s(pkg):
    jmod, tmod = (jest, pest) if pkg == "estimation" else (jsig, tsig)
    assert tmod.__all__ == jmod.__all__
    for n in tmod.__all__:
        obj = getattr(tmod, n)
        if callable(obj):
            assert obj.__module__.startswith("pydsproutines_tpu_torch.")


def same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    if a is None or isinstance(a, (bool, str)):
        assert a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    atol = RTOL * max(np.abs(b).max(initial=0), 1e-300)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


def both(name, fn):
    """fn(module) through the JAX package's module and the port's copy."""
    jmod, tmod = pair(name)
    same(fn(tmod), fn(jmod))


# ---------------------------------------------------------------------------
# numeric parity on the existing tests' inputs
# ---------------------------------------------------------------------------

def test_coords():
    lat = np.radians([1.3, 45.0, -33.9])
    lon = np.radians([103.8, -75.0, 18.4])
    h = np.array([15.0, 200.0, 0.0])

    def run(m):
        ecef = m.geodetic_lla_to_ecef(lat, lon, h)
        p = ecef[:, 0]
        n = m.get_wgs84_tangent_plane_normal(p)
        return (ecef, m.ecef_to_geodetic_lla(ecef), n,
                m.get_wgs84_tangent_plane_north_east(n))
    both("estimation.coords", run)


def test_crb():
    x = np.array([300.0, 400.0, 50.0])
    s = np.array([[0, 0, 0], [1000, 0, 0], [0, 1000, 0], [800, 900, 400],
                  [500, -200, 800], [-300, 600, 100]], dtype=np.float64)
    sig_td = np.array([1e-9, 2e-9, 1.5e-9])

    def run(m):
        crb = m.CRB()
        for k in range(3):
            crb.add_component(m.TDOACRBComponent(x, 1 / sig_td[k] ** 2,
                                                 s[2 * k: 2 * k + 2]))
        y = np.array([100.0, 200.0, 300.0])
        return (crb.fim(), crb.compute(),
                m.TOACRBComponent(y, 1e18, np.zeros(3)).fim(),
                m.AOA3DCRBComponent(y, 1e-3, np.zeros(3)).fim())
    both("estimation.crb", run)


def test_ellipses():
    mus = np.array([[[0.0], [0.0]], [[2.0], [0.0]]])
    covs = np.array([np.eye(2), [[2.0, 0.3], [0.3, 0.5]]])

    def run(m):
        major, minor, angle = m.ellipse_params_from_cov(np.diag([4.0, 1.0]))
        return (m.average_ellipses_davis(mus, covs),
                m.average_ellipses_berkeley(mus, covs),
                m.ellipse_params_from_cov(covs[1]),
                bool(m.point_in_ellipse([1.0, 0.0], [0, 0], major, minor,
                                        angle, 1)),
                bool(m.point_in_ellipse([3.0, 0.0], [0, 0], major, minor,
                                        angle, 1)))
    both("estimation.ellipses", run)


def test_trajectory():
    def run(m):
        st = m.StationaryTrajectory(np.array([1.0, 2.0, 3.0]))
        cv = m.ConstantVelocityTrajectory(np.zeros(3), np.array([1.0, 0, 0]))
        tx = m.ConstantVelocityTrajectory(np.array([5e3, 2e3, 10.0]),
                                          np.array([30.0, -20.0, 0.0]))
        it = m.InterpolatedTrajectory(
            np.array([[0.0, 0, 0], [10, 5, 1], [20, -5, 2]]),
            np.array([-1.0, 1.0, 3.0]))
        t = np.linspace(0, 2, 5)
        lin = m.create_linear_trajectory(100, np.zeros(3),
                                         np.array([10.0, 0, 0]), 1.0, 0.5)
        circ = m.create_circular_trajectory(100)
        r_x = np.array([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]])
        r_xdot = np.array([[10.0, 0.0, 0.0], [0.0, 5.0, 0.0]])
        t_x = np.array([[1000.0, 500.0, 0.0]] * 2)
        pts = m.create_triangular_spaced_points(20, 2.0, make3d=True)
        txr = m.Transmitter.as_stationary(np.tile([0.0, 500.0, 0.0], (5, 1)),
                                          np.arange(5.0))
        r1 = m.Receiver.as_stationary(np.tile([-1000.0, 0, 0], (5, 1)),
                                      np.arange(5.0))
        r2 = m.Receiver.as_stationary(np.tile([1000.0, 0, 0], (5, 1)),
                                      np.arange(5.0))
        return (st.at([0.0, 5.0]), cv.at(t), it.at(t), it.x0, lin, circ,
                m.calc_foa(r_x, r_xdot, t_x, np.zeros_like(t_x), freq=1e9),
                tx.to(st, t), st.frm(tx, t), tx.to(cv, t), pts,
                txr.theoretical_range_diff(r1, r2))
    both("estimation.trajectory", run)


def test_geometry():
    a, b = 6378137.0, 6356752.314245
    lat, lon = np.deg2rad(35.0), np.deg2rad(127.0)
    e2 = 1 - (b / a) ** 2
    nrad = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    emitter = np.array([nrad * np.cos(lat) * np.cos(lon),
                        nrad * np.cos(lat) * np.sin(lon),
                        nrad * (1 - e2) * np.sin(lat)])
    r_geo = 42164e3
    sat1 = r_geo * np.array([np.cos(np.deg2rad(116.0)),
                             np.sin(np.deg2rad(116.0)), 0.0])
    sat2 = r_geo * np.array([np.cos(np.deg2rad(113.0)),
                             np.sin(np.deg2rad(113.0)), 0.0])
    rd = np.linalg.norm(sat2 - emitter) - np.linalg.norm(sat1 - emitter)

    def run(m):
        h = m.Hyperboloid.from_foci(sat1, sat2, rd)
        small = m.Hyperboloid.from_foci(np.array([-3.0, 0.2, 0.5]),
                                        np.array([3.0, -0.4, 0.1]), 0.8)
        v = np.linspace(0, 1.5, 10)
        wgs = m.WGS84Spheroid()
        sph = m.Sphere(1000.0, mu=np.array([6378137.0, 0.0, 0.0]))
        return (h.foci, h.intersect_oblate_spheroid(num_pts=500),
                small.intersect_oblate_spheroid(None, 1.0, 0.9, num_pts=200),
                small.intersect_xy(v),
                wgs.intersect_ray(np.array([2e7, 0.0, 0.0]),
                                  np.array([-1.0, 0.0, 0.0])),
                wgs.normal_at_point(emitter, normalised=True),
                sph.intersect_oblate_spheroid(np.arange(0.01, np.pi, 0.01),
                                              a, b))
    both("estimation.geometry", run)


def test_pulses():
    t = np.linspace(-1, 9, 301)
    both("signal.pulses", lambda m: (m.make_src4(t, 2.0),
                                     m.make_src4_clipped(t, 2.0, 0.7),
                                     m.make_scaled_src4(8)))


def _blobs(rng, centers, n_per=40, spread=0.05):
    return np.vstack([c + spread * rng.standard_normal(
        (n_per, len(np.atleast_1d(c)))) for c in centers])


@pytest.mark.parametrize("case", ["sil", "size", "fraction", "db"])
def test_cluster(case):
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(0xD5B)
    if case == "size":
        x = np.vstack([_blobs(rng, [(-2.0,), (2.0,)], n_per=50),
                       np.array([[9.0], [9.05]])])
    else:
        x = _blobs(rng, [(-3.0,), (0.0,), (4.0,)])
    kw = {"sil": {}, "size": {"min_cluster_size": 5},
          "fraction": {"min_cluster_fraction": 0.2},
          "db": {"scoretypes": ("db",)}}[case]

    def run(m):
        np.random.seed(11)          # KMeans draws its inits from here
        best, model, removed, used = m.ClusterEngine(
            guesses=[2, 3, 4], **kw).cluster(x)
        return best, np.sort(model.cluster_centers_, axis=0), removed, used
    both("estimation.cluster", run)


SAT5 = ("1 00005U 58002B   00179.78495062  .00000023  00000-0  28098-4 0  4753",
        "2 00005  34.2682 348.7242 1859667 331.7664  19.3264 10.82419157413667")
SDP = ("1 11801U          80230.29629788  .01431103  00000-0  14311-3      13",
       "2 11801  46.7916 230.4354 7318036  47.4722  10.4117  2.28537848    13")
ISS = ("1 25544U 98067A   19343.69339541  .00001764  00000-0  38792-4 0  9991",
       "2 25544  51.6439 211.2001 0007417  17.6667  85.6398 15.50103472202482")
K7 = ("1 42691U 17023A   23217.40909002 -.00000373  00000+0  00000+0 0  9996",
      "2 42691   0.0264  36.5306 0000462  83.0552  97.2787  1.00273009 22943")


@pytest.mark.parametrize("case", ["sgp4_check_states", "sdp4", "j2",
                                  "frames", "satellite"])
def test_satellites(case):
    def run(m):
        if case == "sgp4_check_states":
            p = m.SGP4Propagator(m.parse_tle(*SAT5), m.WGS72)
            return p.teme_posvel_tsince(np.arange(0.0, 1441.0, 360.0))
        if case == "sdp4":
            p = m.SGP4Propagator(m.parse_tle(*SDP, validate_checksum=False),
                                 m.WGS72)
            return p.teme_posvel_tsince(np.array([0.0, 720.0, 1440.0]))
        if case == "j2":
            tle = m.parse_tle(*ISS)
            return m.J2Propagator(tle, m.WGS72).teme_posvel(
                tle.epoch_unix + np.array([0.0, 600.0, 1800.0]))
        if case == "frames":
            r = np.array([[7000.0, 0.0, 0.0], [0.0, 42164.0, 10.0]])
            return (m.gmst_rad(1691227819.0 + np.arange(3.0)),
                    m.teme_to_itrs(r, 1691227819.0, np.ones((2, 3))))
        tle = dataclasses.asdict(m.parse_tle(*K7))
        out = []
        for lines in (ISS, K7):
            sat = m.Satellite(*lines)
            gc = m.sf_propagate_satellite_to_gpstime(sat, 1575806000.0)
            out += [sat.backend, m.sf_geocentric_to_itrs(gc)]
        return out + [np.array([v for v in tle.values()
                                if isinstance(v, float)])]
    both("estimation.satellites", run)
