"""Trajectories and FOA.

Reference semantics: trajectoryRoutines.py (calcFOA :23,
Trajectory :63 with quadratic photon-flight tau, StationaryTrajectory :201,
ConstantVelocityTrajectory :216, InterpolatedTrajectory :250,
createLinearTrajectory :287, createCircularTrajectory :326,
Transceiver/Receiver/Transmitter :443-520).

A copy of the JAX package's ``pydsproutines_tpu/estimation/trajectory.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np

LIGHTSPEED = 299792458.0


def calc_foa(r_x, r_xdot, t_x, t_xdot, freq: float = 30e6):
    """Frequency of arrival from row-vector positions/velocities (reference
    calcFOA, trajectoryRoutines.py:23)."""
    r_x = np.atleast_2d(np.asarray(r_x, dtype=np.float64))
    t_x = np.atleast_2d(np.asarray(t_x, dtype=np.float64))
    r_xdot = np.atleast_2d(np.asarray(r_xdot, dtype=np.float64))
    t_xdot = np.atleast_2d(np.asarray(t_xdot, dtype=np.float64))
    radial = t_x - r_x
    radial_n = radial / np.linalg.norm(radial, axis=1, keepdims=True)
    vradial = np.sum(radial_n * r_xdot, axis=1) - np.sum(radial_n * t_xdot,
                                                         axis=1)
    return vradial / LIGHTSPEED * freq


class Trajectory:
    """Base trajectory (reference Trajectory, trajectoryRoutines.py:63)."""

    def __init__(self, x0: np.ndarray):
        x0 = np.asarray(x0, dtype=np.float64)
        if x0.ndim != 1 or x0.size not in (2, 3):
            raise ValueError("x0 must be a 1D 2- or 3-vector")
        self._x0 = x0

    @property
    def x0(self):
        return self._x0

    def at(self, t):
        raise NotImplementedError

    @staticmethod
    def _scalar_to_array(t):
        if isinstance(t, (int, float)):
            return np.array([t], dtype=np.float64)
        return np.asarray(t, dtype=np.float64)

    def _quadratic_velocity_tau(self, other: "ConstantVelocityTrajectory", t):
        """Photon flight time by solving |D + v*tau| = c*tau (reference
        _quadraticVelocityMethod)."""
        if not isinstance(other, ConstantVelocityTrajectory):
            raise TypeError("Quadratic method needs ConstantVelocityTrajectory")
        d = self.at(t) - other.at(t)
        a = np.linalg.norm(other.v) ** 2 - LIGHTSPEED ** 2
        b = -2 * d @ other.v.reshape(-1, 1)
        c = np.sum(d * d, axis=1, keepdims=True)
        disc = b ** 2 - 4 * a * c
        root = np.sqrt(disc)
        tau = np.hstack(((-b + root) / (2 * a), (-b - root) / (2 * a)))
        return tau

    def to(self, rx: "Trajectory", t):
        """Photon flight time from this trajectory at transmit time(s) t to
        trajectory ``rx`` (reference Trajectory.to)."""
        if isinstance(rx, StationaryTrajectory):
            return np.linalg.norm(self.at(t) - rx.at(t), axis=1) / LIGHTSPEED
        tau = self._quadratic_velocity_tau(rx, t)
        return np.max(tau, axis=1)

    def frm(self, tx: "Trajectory", t):
        """Photon flight time to this trajectory at receive time(s) t from
        trajectory ``tx`` (reference Trajectory.frm)."""
        if isinstance(tx, StationaryTrajectory):
            return np.linalg.norm(self.at(t) - tx.at(t), axis=1) / LIGHTSPEED
        tau = self._quadratic_velocity_tau(tx, t)
        if np.all(tau < 0):
            raise ValueError("Not sure how to select tau; both negative")
        return -np.min(tau, axis=1)


class StationaryTrajectory(Trajectory):
    def at(self, t):
        t = self._scalar_to_array(t)
        return self._x0 + np.zeros_like(t).reshape(-1, 1)


class ConstantVelocityTrajectory(Trajectory):
    def __init__(self, x0, v):
        super().__init__(x0)
        v = np.asarray(v, dtype=np.float64)
        if v.shape != self.x0.shape:
            raise ValueError("v must be the same shape as x0")
        self._v = v

    @property
    def v(self):
        return self._v

    def at(self, t):
        t = self._scalar_to_array(t)
        return self._x0 + t.reshape(-1, 1) * self._v


class InterpolatedTrajectory(Trajectory):
    """Piecewise-linear trajectory through sampled (position, time) points."""

    def __init__(self, xp: np.ndarray, tp: np.ndarray):
        xp = np.asarray(xp, dtype=np.float64)
        tp = np.asarray(tp, dtype=np.float64)
        self._xp = xp.T  # (3, N)
        self._tp = tp
        if tp[0] <= 0.0 <= tp[-1]:
            x0 = np.array([np.interp(0.0, tp, self._xp[i])
                           for i in range(self._xp.shape[0])])
        else:
            x0 = self._xp[:, 0]
        super().__init__(x0)

    @property
    def xp(self):
        return self._xp

    @property
    def tp(self):
        return self._tp

    def at(self, t):
        t = self._scalar_to_array(t)
        return np.stack([np.interp(t, self._tp, self._xp[i])
                         for i in range(self._xp.shape[0])], axis=1)


def create_linear_trajectory(total_samples: int, pos1, pos2, speed: float,
                             sample_time: float, start_coeff: float = 0.0):
    """Back-and-forth linear patrol between two anchors (reference
    createLinearTrajectory, trajectoryRoutines.py:287). Returns (r_x, r_xdot)."""
    pos1 = np.asarray(pos1, dtype=np.float64)
    pos2 = np.asarray(pos2, dtype=np.float64)
    dirvec = pos2 - pos1
    anchor_dist = np.linalg.norm(dirvec)
    dirvec_n = dirvec / anchor_dist
    percent_per_sample = sample_time * speed / anchor_dist
    percent = start_coeff + np.arange(total_samples) * percent_per_sample
    percent = np.mod(percent, 2)
    reverse = percent > 1.0
    percent = np.where(reverse, 2.0 - percent, percent)
    r_xdot = np.zeros((total_samples, pos1.size)) + dirvec_n * speed
    r_xdot[reverse] = -r_xdot[reverse]
    r_x = pos1 + percent.reshape(-1, 1) * dirvec
    return r_x, r_xdot


def create_circular_trajectory(total_samples: int, r_a: float = 100000.0,
                               desired_speed: float = 100.0, r_h: float = 300.0,
                               sample_time: float = 3.90625e-6,
                               phi: float = 0.0):
    """Circular orbit at height r_h (reference createCircularTrajectory,
    trajectoryRoutines.py:326). Returns (r_x, r_xdot, arcangle, dtheta/s)."""
    dtheta = desired_speed / r_a
    arcangle = total_samples * sample_time * dtheta
    theta = phi + np.arange(total_samples) * dtheta * sample_time
    r_x = np.stack([r_a * np.cos(theta), r_a * np.sin(theta),
                    np.full(total_samples, r_h)], axis=1)
    r_xdot = np.stack([-r_a * np.sin(theta) * dtheta,
                       r_a * np.cos(theta) * dtheta,
                       np.zeros(total_samples)], axis=1)
    return r_x, r_xdot, arcangle, dtheta


def create_triangular_spaced_points(num_pts: int, dist: float = 1.0,
                                    start_pt=np.array([0.0, 0.0]),
                                    make3d: bool = False):
    """Triangular-lattice point spawner (reference
    createTriangularSpacedPoints, trajectoryRoutines.py:360): points spaced
    ``dist`` apart on a hex/triangular lattice, spiralling out from
    start_pt."""
    start_pt = np.asarray(start_pt, dtype=np.float64)
    pts = [start_pt]
    ring = 1
    # hex-lattice basis
    basis = np.array([[1.0, 0.0],
                      [0.5, np.sqrt(3) / 2]]) * dist
    while len(pts) < num_pts:
        # walk the hexagonal ring at radius `ring`
        corner = ring * basis[0]
        directions = np.array([
            basis[1] - basis[0], -basis[0], -basis[1],
            basis[0] - basis[1], basis[0], basis[1]])
        p = corner.copy()
        for d in directions:
            for _ in range(ring):
                if len(pts) >= num_pts:
                    break
                pts.append(start_pt + p)
                p = p + d
        ring += 1
    pts = np.array(pts[:num_pts])
    if make3d:
        pts = np.hstack([pts, np.zeros((num_pts, 1))])
    return pts


# ---------------------------------------------------------------------------
# Transceiver family (reference trajectoryRoutines.py:443-520)
# ---------------------------------------------------------------------------

class Transceiver:
    """Position/velocity tracks sampled at common times (reference
    Transceiver, trajectoryRoutines.py:443; plotting is matplotlib here)."""

    def __init__(self, x, xdot, t, marker: str = "x", color: str = "b"):
        self.x = np.asarray(x, np.float64)
        self.xdot = np.asarray(xdot, np.float64)
        self.t = np.asarray(t, np.float64)
        self.marker = marker
        self.color = color

    @classmethod
    def as_stationary(cls, x, t):
        x = np.asarray(x, np.float64)
        return cls(x, np.zeros(x.shape), t)

    @staticmethod
    def plot_flat_2d(transceivers, idx, ax=None):
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots()
        for i, tr in enumerate(transceivers):
            if i > 0 and not np.array_equal(tr.t, transceivers[0].t):
                raise ValueError("all transceivers must share the time base")
            ax.plot(tr.x[idx, 0], tr.x[idx, 1], linestyle="none",
                    marker=tr.marker, color=tr.color)
        return ax


class Receiver(Transceiver):
    def __init__(self, x, xdot, t, marker: str = "x", color: str = "r"):
        super().__init__(x, xdot, t, marker, color)


class Transmitter(Transceiver):
    def __init__(self, x, xdot, t, marker: str = "o", color: str = "b"):
        super().__init__(x, xdot, t, marker, color)

    def theoretical_range_diff(self, rx1: Receiver, rx2: Receiver):
        """range(self -> rx2) - range(self -> rx1) per sample (reference
        Transmitter.theoreticalRangeDiff, trajectoryRoutines.py:513)."""
        if not (np.array_equal(self.t, rx1.t) and np.array_equal(self.t, rx2.t)):
            raise ValueError("time bases must match")
        r1 = np.linalg.norm(rx1.x - self.x, axis=1)
        r2 = np.linalg.norm(rx2.x - self.x, axis=1)
        return r2 - r1

    def plot_hyperbola_flat(self, rx1: Receiver, rx2: Receiver, idx: int = 0,
                            rangediff: float | None = None, z: float = 0.0,
                            half_num_pts: int = 100, orthostep: float = 0.1,
                            ax=None):
        """Plot the TDOA hyperbola for the sensor pair at sample ``idx``
        (reference plotHyperbolaFlat, trajectoryRoutines.py:520)."""
        from pydsproutines_tpu_torch.estimation.localization import (
            generate_hyperbola_xy)
        import matplotlib.pyplot as plt
        if rangediff is None:
            rangediff = self.theoretical_range_diff(rx1, rx2)[idx]
        hyp = generate_hyperbola_xy(half_num_pts, float(rangediff),
                                    rx1.x[idx], rx2.x[idx], z=z,
                                    orthostep=orthostep)
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(hyp[:, 0], hyp[:, 1], color=self.color)
        return ax, hyp
