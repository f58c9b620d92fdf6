"""Geometric surfaces: ellipsoids, spheroids, spheres, and TDOA hyperboloids.

Reference semantics: sphereRoutines.py (Ellipsoid :16,
intersectRay :107, normalAtPoint :158, north_and_east_vectors :193,
OblateSpheroid :229, WGS84Spheroid :245, Sphere :261 with
intersectOblateSpheroid) and hyperboloidRoutines.py
(Hyperboloid :17 — parametrization, transform :87, intersectXY :210,
fromFoci :417).

Host numpy: these are small-geometry helpers feeding plotting/localization.

A copy of the JAX package's ``pydsproutines_tpu/estimation/geometry.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np


class Ellipsoid:
    """x^2/a^2 + y^2/b^2 + z^2/c^2 = 1, optionally rotated (Rz@Rx) and
    translated by mu."""

    def __init__(self, a: float, b: float, c: float, mu=np.zeros(3),
                 rx=np.eye(3), rz=np.eye(3)):
        self.a, self.b, self.c = float(a), float(b), float(c)
        self.mu = np.asarray(mu, dtype=np.float64)
        self.Rx = np.asarray(rx, dtype=np.float64)
        self.Rz = np.asarray(rz, dtype=np.float64)

    def points_from_angles(self, theta, phi):
        return np.array([
            self.a * np.sin(theta) * np.cos(phi),
            self.b * np.sin(theta) * np.sin(phi),
            self.c * np.cos(theta),
        ])

    def transform(self, points):
        if points.ndim == 3:
            return points + self.mu.reshape(-1, 1, 1)
        return points + self.mu.reshape(-1, 1)

    def intersect_ray(self, s: np.ndarray, direction: np.ndarray):
        """Nearest non-negative ray intersection, or None (reference
        intersectRay, sphereRoutines.py:107)."""
        s = np.asarray(s, dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        if s.ndim != 1 or direction.ndim != 1:
            raise ValueError("s and direction must be 1-D arrays")
        denomsq = np.array([self.a ** 2, self.b ** 2, self.c ** 2])
        sp = s - self.mu
        coeffs = np.array([
            np.sum(sp ** 2 / denomsq) - 1.0,
            np.sum(2 * sp * direction / denomsq),
            np.sum(direction ** 2 / denomsq),
        ])
        roots = np.polynomial.Polynomial(coeffs).roots()
        roots = roots[np.isreal(roots)].real
        roots = roots[roots >= 0]
        if roots.size == 0:
            return None
        return s + direction * np.min(roots)

    def normal_at_point(self, x: np.ndarray, normalised: bool = False):
        normal = np.array([2 / self.a ** 2, 2 / self.b ** 2,
                           2 / self.c ** 2]) * np.asarray(x)
        if normalised:
            normal = normal / np.linalg.norm(normal)
        return normal

    @staticmethod
    def north_and_east_vectors(normal: np.ndarray, normalised: bool = False):
        east = np.cross(np.array([0.0, 0.0, 1.0]), normal)
        east = east / np.linalg.norm(east)
        north = np.cross(normal, east)
        north = north / np.linalg.norm(north)
        return north, east


class OblateSpheroid(Ellipsoid):
    def __init__(self, omega: float, lmbda: float, mu=np.zeros(3),
                 rx=np.eye(3), rz=np.eye(3)):
        assert lmbda < omega
        self.omega, self.lmbda = float(omega), float(lmbda)
        super().__init__(omega, omega, lmbda, mu, rx, rz)


class WGS84Spheroid(OblateSpheroid):
    def __init__(self, mu=np.zeros(3), rx=np.eye(3), rz=np.eye(3)):
        super().__init__(6378137.0, 6356752.314245, mu, rx, rz)


class Sphere(Ellipsoid):
    def __init__(self, r: float, mu=np.zeros(3)):
        self.r = float(r)
        super().__init__(r, r, r, mu)

    def intersect_oblate_spheroid(self, theta, omega, lmbda):
        """Intersection curve of this (translated) sphere with a
        centre-origin oblate spheroid (reference Sphere.intersectOblateSpheroid,
        sphereRoutines.py:267)."""
        theta = np.asarray(theta, dtype=np.float64)
        rs = self.r * np.sin(theta)
        rc = self.r * np.cos(theta)
        gamma = lmbda ** 2 * (rs ** 2 + self.mu[0] ** 2 + self.mu[1] ** 2)
        beta = omega ** 2 * (rc ** 2 + 2 * rc * self.mu[2] + self.mu[2] ** 2)
        a = lmbda ** 2 * 2 * rs * self.mu[0]
        b = lmbda ** 2 * 2 * rs * self.mu[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.arctan2(b, a)
            t = (lmbda ** 2 * omega ** 2 - beta - gamma) / np.sqrt(a ** 2 + b ** 2)
            basic = np.arccos(t)
        idx = ~np.isnan(basic)
        basic, alpha, theta = basic[idx], alpha[idx], theta[idx]
        phi = np.hstack((basic[::-1] + alpha[::-1], -basic + alpha))
        thetae = np.hstack((theta[::-1], theta))
        points = self.points_from_angles(thetae, phi)
        return self.transform(points)


class Hyperboloid:
    """Two-sheet z-axis hyperboloid of revolution
    x^2/a^2 + y^2/a^2 - z^2/c^2 = -1 (reference Hyperboloid,
    hyperboloidRoutines.py:17). Convention: c has the sign of the range
    difference; foci at +/- sqrt(a^2+c^2) along the (rotated) z-axis."""

    def __init__(self, a: float, c: float, mu=np.zeros(3), rx=np.eye(3),
                 rz=np.eye(3)):
        self.a, self.c = float(a), float(c)
        self.rangediff = c / 2
        self.focus_z = np.sqrt(a ** 2 + c ** 2)
        self.mu = np.asarray(mu, dtype=np.float64)
        self.Rx = np.asarray(rx, dtype=np.float64)
        self.Rz = np.asarray(rz, dtype=np.float64)
        self.Rot = self.Rz @ self.Rx
        foci_local = np.array([[0, 0, -self.focus_z],
                               [0, 0, self.focus_z]]).T  # (3, 2)
        self.foci = self.Rot @ foci_local + self.mu.reshape(-1, 1)

    # parametrization ---------------------------------------------------------
    def x(self, v, theta):
        return self.a * np.sinh(v) * np.cos(theta)

    def y(self, v, theta):
        return self.a * np.sinh(v) * np.sin(theta)

    def z(self, v, sign):
        return sign * self.c * np.cosh(v)

    def transform(self, vecs: np.ndarray) -> np.ndarray:
        """Rotate+translate (3, N) local points to world frame."""
        return self.Rot @ vecs + self.mu.reshape(-1, 1)

    def inverse_transform(self, points: np.ndarray) -> np.ndarray:
        return np.linalg.inv(self.Rot) @ (points - self.mu.reshape(-1, 1))

    # intersections -----------------------------------------------------------
    def _intersect_xy_sheet(self, v, sign):
        """Solve for theta(v) where the world-frame z = 0 (reference
        _intersectXYsheet, hyperboloidRoutines.py:170)."""
        v = np.asarray(v, dtype=np.float64)
        sinhv, coshv = np.sinh(v), np.cosh(v)
        a0 = self.Rot[2, 0] * self.a * sinhv
        a1 = self.Rot[2, 1] * self.a * sinhv
        a2 = self.Rot[2, 2] * sign * self.c * coshv + self.mu[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.arctan(a0 / a1)
            b = -a2 / np.sqrt(a0 ** 2 + a1 ** 2)
            theta1 = np.arcsin(b)
            theta2 = np.sign(b) * np.pi - theta1
        theta = np.hstack((theta2[::-1], theta1)) - np.hstack((alpha[::-1], alpha))
        v_ext = np.hstack((v[::-1], v))
        x = self.x(v_ext, theta)
        y = self.y(v_ext, theta)
        z = self.z(v_ext, sign)
        ok = ~(np.isnan(x) | np.isnan(y) | np.isnan(z))
        vec = np.vstack((x[ok], y[ok], np.broadcast_to(z, x.shape)[ok]))
        return self.transform(vec)

    def intersect_xy(self, v=None, only_return_one_sheet: bool = False):
        """World-frame z=0 plane intersection curve(s)."""
        if v is None:
            v = np.arange(0, 2, 0.01)
        msheet = self._intersect_xy_sheet(v, -1)
        if only_return_one_sheet:
            return msheet
        return msheet, self._intersect_xy_sheet(v, 1)

    # -- oblate-spheroid intersection (TDOA ground-curve) ---------------------
    #
    # Reference semantics: hyperboloidRoutines.py:346 intersectOblateSpheroid,
    # :283 coefficient generation, :222 _intersectOblateSpheroidLoop (per-v
    # np.roots + Descartes pre-check), :371-394 refineMiddle stitching.
    # Re-derivation used here: a point on the (-) sheet at parameter v is
    # p(theta) = Rot @ (a sinh v cos t, a sinh v sin t, -c cosh v) + mu, so
    # each world component is u0_k cos t + u1_k sin t + u2_k.  Substituting
    # t = tan(theta/2) turns the spheroid constraint
    # lmbda^2 (X^2 + Y^2) + omega^2 Z^2 = omega^2 lmbda^2 into a quartic in t
    # per v.  Instead of looping np.roots per v, all quartics are solved at
    # once as a batch of 4x4 companion-matrix eigenproblems.

    def _spheroid_quartic_coeffs(self, v, omega, lmbda):
        """Ascending-order quartic coefficients, shape (5, len(v))."""
        v = np.asarray(v, dtype=np.float64)
        sinhv, coshv = np.sinh(v), np.cosh(v)
        a_sinh = self.a * sinhv
        z_sheet = -self.c * coshv  # the sheet matching the rangediff sign
        # world component k of p(theta): ck*cos + sk*sin + dk
        c_k = self.Rot[:, 0:1] * a_sinh[None, :]        # (3, N)
        s_k = self.Rot[:, 1:2] * a_sinh[None, :]
        d_k = self.Rot[:, 2:3] * z_sheet[None, :] + self.mu.reshape(3, 1)
        # Weierstrass: (1+t^2) * comp = p2 t^2 + p1 t + p0
        p2 = d_k - c_k
        p1 = 2.0 * s_k
        p0 = d_k + c_k

        def sq(p0k, p1k, p2k):
            # ascending coefficients of (p2 t^2 + p1 t + p0)^2, shape (5, N)
            return np.stack([p0k ** 2, 2 * p0k * p1k, p1k ** 2 + 2 * p0k * p2k,
                             2 * p1k * p2k, p2k ** 2])

        w2l2 = omega ** 2 * lmbda ** 2
        tc = (lmbda ** 2 * (sq(p0[0], p1[0], p2[0]) + sq(p0[1], p1[1], p2[1]))
              + omega ** 2 * sq(p0[2], p1[2], p2[2]))
        tc[0] -= w2l2
        tc[2] -= 2 * w2l2
        tc[4] -= w2l2
        return tc

    @staticmethod
    def _batched_quartic_roots(tc):
        """Roots of many quartics at once via companion eigenvalues.

        ``tc``: ascending coefficients, shape (5, N). Returns complex (N, 4);
        rows whose leading coefficient is degenerate come back as NaN.
        """
        n = tc.shape[1]
        lead = tc[4]
        scale = np.max(np.abs(tc), axis=0)
        ok = np.abs(lead) > 1e-14 * np.maximum(scale, 1.0)
        mono = np.where(ok, lead, 1.0)
        a = tc[:4] / mono  # (4, N) monic remainder
        comp = np.zeros((n, 4, 4))
        comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
        comp[:, :, 3] = -a.T
        roots = np.linalg.eigvals(comp)
        roots[~ok] = np.nan
        return roots

    def _estimate_spheroid_v(self, omega, lmbda):
        """Bracket the v-range where the sheet can reach the spheroid
        (reference _estimateSpheroidV, hyperboloidRoutines.py:268)."""
        foci_mid = np.mean(self.foci, axis=1)
        pzero = self.inverse_transform(np.zeros((3, 1)))
        vmid = np.arcsinh(np.sqrt(np.sum(pzero[:2] ** 2) / self.a ** 2))
        outer = max(omega, lmbda) * foci_mid / np.linalg.norm(foci_mid)
        pouter = self.inverse_transform(outer.reshape(3, 1))
        vout = np.arcsinh(np.sqrt(np.sum(pouter[:2] ** 2) / self.a ** 2))
        return vout, vmid

    def _intersect_spheroid_branches(self, v, omega, lmbda):
        """Per-v real-root extraction -> (theta_lo, v_lo, theta_hi, v_hi).

        ``lo`` carries the smaller theta root for every v with >=1 real root
        (the reference's "minus" list), ``hi`` the larger root where two
        exist (the "plus" list).
        """
        v = np.asarray(v, dtype=np.float64)
        tc = self._spheroid_quartic_coeffs(v, omega, lmbda)
        roots = self._batched_quartic_roots(tc)  # (N, 4)
        real_ok = np.isfinite(roots.real) & (
            np.abs(roots.imag) <= 1e-8 * (1.0 + np.abs(roots.real)))
        theta = 2.0 * np.arctan(roots.real)
        # verify candidates by residual on the spheroid (guards against
        # eigenvalue jitter promoting a complex pair to "real")
        xs = self.x(v[:, None], theta)
        ys = self.y(v[:, None], theta)
        zs = np.broadcast_to(self.z(v, -1)[:, None], theta.shape)
        pts = self.transform(
            np.stack([xs.ravel(), ys.ravel(), zs.ravel()]))
        resid = np.abs(
            (pts[0] ** 2 + pts[1] ** 2) / omega ** 2
            + pts[2] ** 2 / lmbda ** 2 - 1.0).reshape(theta.shape)
        good = real_ok & (resid < 1e-6)
        count = good.sum(axis=1)
        th_lo = np.where(good, theta, np.inf).min(axis=1)
        th_hi = np.where(good, theta, -np.inf).max(axis=1)
        has1, has2 = count >= 1, count >= 2
        return th_lo[has1], v[has1], th_hi[has2], v[has2]

    def intersect_oblate_spheroid(self, v: np.ndarray | None = None,
                                  omega: float = 6378137.0,
                                  lmbda: float = 6356752.314245,
                                  num_pts: int = 100,
                                  refine_middle: bool = True):
        """Intersection curve of the rangediff sheet with a centre-origin
        oblate spheroid (default WGS84) — the TDOA ground-position curve.

        Returns ``(points, v_used)`` with ``points`` shaped (3, M), ordered
        as one continuous curve (lo branch by descending v, then the refined
        middle, then the hi branch by ascending v), matching the reference
        stitching (hyperboloidRoutines.py:396-405).
        """
        if v is None:
            vout, vmid = self._estimate_spheroid_v(omega, lmbda)
            v = np.linspace(0.9 * vout, vmid, num_pts)
        # ascending v makes the branch stitching below a continuous curve
        # regardless of the bracket direction the estimator produced
        v = np.sort(np.asarray(v, dtype=np.float64))
        th_lo, v_lo, th_hi, v_hi = self._intersect_spheroid_branches(
            v, omega, lmbda)

        if refine_middle and v_hi.size >= 2:
            vspace = v_hi[1] - v_hi[0]
            vext = np.linspace(v_hi[0] - vspace, v_hi[0],
                               max(num_pts // 2, 2), endpoint=False)
            eth_lo, ev_lo, eth_hi, ev_hi = self._intersect_spheroid_branches(
                vext, omega, lmbda)
            thetas = np.hstack((th_lo[::-1], eth_lo[::-1], eth_hi, th_hi))
            ve = np.hstack((v_lo[::-1], ev_lo[::-1], ev_hi, v_hi))
        else:
            thetas = np.hstack((th_lo[::-1], th_hi))
            ve = np.hstack((v_lo[::-1], v_hi))

        pts = np.vstack((self.x(ve, thetas), self.y(ve, thetas),
                         self.z(ve, -1)))
        return self.transform(pts), ve

    @classmethod
    def from_foci(cls, s1: np.ndarray, s2: np.ndarray, rangediff: float):
        """Hyperboloid sheet of constant range difference
        (|s2 - x| - |s1 - x| = rangediff) from two foci (reference fromFoci,
        hyperboloidRoutines.py:417)."""
        s1 = np.asarray(s1, dtype=np.float64)
        s2 = np.asarray(s2, dtype=np.float64)
        v = s2 - s1
        vnorm = np.linalg.norm(v)
        d = vnorm / 2
        theta = np.arccos(np.dot(v, np.array([0, 0, 1.0])) / vnorm)
        rx = np.array([[1, 0, 0],
                       [0, np.cos(theta), -np.sin(theta)],
                       [0, np.sin(theta), np.cos(theta)]])
        phi = np.arctan2(v[1], v[0]) + np.pi / 2
        rz = np.array([[np.cos(phi), -np.sin(phi), 0],
                       [np.sin(phi), np.cos(phi), 0],
                       [0, 0, 1]])
        c = 0.5 * rangediff
        a = np.sqrt(d ** 2 - c ** 2)
        mu = (s2 + s1) / 2
        return cls(a, c, mu, rx, rz)
