"""Covariance-ellipse fusion.

Reference semantics: averagingEllipsesRoutines.py
(averageEllipses_Davis :14, averageEllipses_Berkeley :39, pointInEllipse
:109). Small 2x2 algebra, host numpy, vectorized over the ellipse stack.

A copy of the JAX package's ``pydsproutines_tpu/estimation/ellipses.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np


def average_ellipses_davis(ellipse_mu: np.ndarray, ellipse_cov: np.ndarray):
    """Inverse-variance weighted fusion (Davis). ellipse_mu: (N, 2, 1) or
    (N, 2); ellipse_cov: (N, 2, 2). Returns (mu (2,1), cov (2,2))."""
    mu = np.asarray(ellipse_mu, dtype=np.float64).reshape(-1, 2, 1)
    cov = np.asarray(ellipse_cov, dtype=np.float64)
    inv = np.linalg.inv(cov)                       # (N, 2, 2)
    cov_davis = np.linalg.inv(inv.sum(axis=0))
    mu_w = cov_davis @ (inv @ mu).sum(axis=0)
    return mu_w, cov_davis


def average_ellipses_berkeley(ellipse_mu: np.ndarray, ellipse_cov: np.ndarray):
    """Davis mean with the Berkeley spread-corrected covariance
    (reference averageEllipses_Berkeley)."""
    mu = np.asarray(ellipse_mu, dtype=np.float64).reshape(-1, 2, 1)
    cov = np.asarray(ellipse_cov, dtype=np.float64)
    n = mu.shape[0]
    inv = np.linalg.inv(cov)
    cov_davis = np.linalg.inv(inv.sum(axis=0))
    mu_w = cov_davis @ (inv @ mu).sum(axis=0)
    diffs = mu - mu_w                              # (N, 2, 1)
    weights = cov_davis[None] @ inv                # (N, 2, 2)
    numer = (weights * (diffs @ diffs.transpose(0, 2, 1))).sum(axis=0)
    cov_berkeley = numer * n / (n - 1) / n
    return mu_w, cov_berkeley


def ellipse_params_from_cov(cov: np.ndarray):
    """(major, minor, angle) of the 1-sigma ellipse of a 2x2 covariance
    (reference plotEllipse's parameter extraction)."""
    rot, diag, _ = np.linalg.svd(np.asarray(cov))
    major = np.sqrt(diag[0])
    minor = np.sqrt(diag[1])
    angle = np.arctan2(rot[1, 0], rot[1, 1])
    return major, minor, angle


def point_in_ellipse(point, mu, major, minor, angle, n_sigma) -> bool:
    """Whether a point is inside the n-sigma ellipse (reference
    pointInEllipse)."""
    c, s = np.cos(angle), np.sin(angle)
    dx, dy = point[0] - mu[0], point[1] - mu[1]
    val = ((c * dx + s * dy) ** 2) / ((major * n_sigma) ** 2) \
        + ((s * dx - c * dy) ** 2) / ((minor * n_sigma) ** 2)
    return bool(val < 1)
