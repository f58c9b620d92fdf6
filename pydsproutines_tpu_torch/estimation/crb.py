"""Composable CRB framework.

Reference semantics: crbRoutines.py (LocalizationCRBComponent
:6, AOA3DCRBComponent :85, TDOACRBComponent :172, TOACRBComponent :219,
CRB :262). Fisher-information components per measurement, summed and
optionally constraint-projected. Host numpy (3x3 matrices).

A copy of the JAX package's ``pydsproutines_tpu/estimation/crb.py``, which
is numpy only: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

LIGHTSPEED = 299792458.0


class LocalizationCRBComponent:
    """One measurement's Fisher information contribution."""

    def __init__(self, x: np.ndarray, inv_sigma_sq, s: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (3,):
            raise ValueError("x must be shape (3,)")
        self.x = x
        self.inv_sigma_sq = inv_sigma_sq
        self.S = np.asarray(s, dtype=np.float64)
        self.partials = self._differentiate()

    def _differentiate(self):
        raise NotImplementedError

    def fim(self) -> np.ndarray:
        j = self.partials.reshape(-1, 3)
        if isinstance(self.inv_sigma_sq, np.ndarray):
            return j.T @ self.inv_sigma_sq.T @ j
        return j.T @ j * self.inv_sigma_sq


class AOA3DCRBComponent(LocalizationCRBComponent):
    """3-D angle-of-arrival component: isotropic angular error ``delta``
    decomposed into (phi, theta) variances (reference crbRoutines.py:85)."""

    def __init__(self, x: np.ndarray, delta: float, s: np.ndarray):
        s = np.asarray(s, dtype=np.float64)
        if s.shape != (3,):
            raise ValueError("S must be shape (3,)")
        self.uf = np.asarray(x, dtype=np.float64) - s
        self.u = self.uf / np.linalg.norm(self.uf)
        self.phi = np.arctan2(self.u[1], self.u[0])
        self.theta = np.arcsin(self.u[2])
        self.delta = delta
        sigma_theta_sq = delta ** 2 / 2
        sigma_phi_sq = delta ** 2 / (2 * np.cos(self.theta) ** 2)
        super().__init__(x, np.diag([1 / sigma_phi_sq, 1 / sigma_theta_sq]), s)

    @property
    def dphi(self):
        return self.partials[0]

    @property
    def dtheta(self):
        return self.partials[1]

    def _differentiate(self):
        x2y2 = self.uf[0] ** 2 + self.uf[1] ** 2
        nsq = np.linalg.norm(self.uf) ** 2
        dphi = np.array([-self.uf[1] / x2y2, self.uf[0] / x2y2, 0.0])
        dtheta = np.array([
            -self.uf[2] * self.uf[0] / (nsq * np.sqrt(x2y2)),
            -self.uf[2] * self.uf[1] / (nsq * np.sqrt(x2y2)),
            np.sqrt(x2y2) / nsq,
        ])
        return np.vstack((dphi, dtheta))


class TDOACRBComponent(LocalizationCRBComponent):
    """Single TDOA measurement between 2 sensors; convention
    |x-S[1]| - |x-S[0]| (reference crbRoutines.py:172)."""

    def __init__(self, x: np.ndarray, inv_sigma_td_sq: float, s: np.ndarray):
        s = np.asarray(s, dtype=np.float64)
        if s.shape != (2, 3):
            raise ValueError("S must be shape (2, 3)")
        self.inv_sigma_rdoa_sq = inv_sigma_td_sq / LIGHTSPEED ** 2
        self.r = np.linalg.norm(np.asarray(x) - s, axis=1)
        super().__init__(x, self.inv_sigma_rdoa_sq, s)

    def _differentiate(self):
        r_dx = (self.x - self.S) / self.r.reshape(-1, 1)
        return r_dx[1] - r_dx[0]


class TOACRBComponent(LocalizationCRBComponent):
    """Single TOA measurement from one sensor (reference crbRoutines.py:219)."""

    def __init__(self, x: np.ndarray, inv_sigma_tau_sq: float, s: np.ndarray):
        s = np.asarray(s, dtype=np.float64)
        if s.shape != (3,):
            raise ValueError("S must be shape (3,)")
        self.inv_sigma_roa_sq = inv_sigma_tau_sq / LIGHTSPEED ** 2
        self.r = np.linalg.norm(np.asarray(x) - s)
        super().__init__(x, self.inv_sigma_roa_sq, s)

    def _differentiate(self):
        return (self.x - self.S) / self.r


class CRB:
    """Container summing component FIMs into the final (optionally
    constraint-projected) CRB (reference crbRoutines.py:262)."""

    def __init__(self, constraints: np.ndarray | None = None):
        self.components: list[LocalizationCRBComponent] = []
        self.constraints = constraints
        if self.constraints is not None:
            self.constraints = np.atleast_2d(np.asarray(self.constraints))

    def add_component(self, component: LocalizationCRBComponent):
        self.components.append(component)
        return self

    # reference-name alias
    addComponent = add_component

    def fim(self) -> np.ndarray:
        fim_mat = np.zeros((3, 3))
        for c in self.components:
            fim_mat += c.fim()
        return fim_mat

    def compute(self) -> np.ndarray:
        fim = self.fim()
        if self.constraints is not None:
            u = scipy.linalg.null_space(self.constraints)
            return u @ np.linalg.inv(u.T @ fim @ u) @ u.T
        return np.linalg.inv(fim)
