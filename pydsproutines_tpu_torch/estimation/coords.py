"""WGS84 coordinate conversions and tangent planes.

Reference semantics: coordinateRoutines.py (geodeticLLA2ecef
:7, ecef2geodeticLLA :31 — skyfield-backed there, closed-form here) and
localizationRoutines.py:30,56 (tangent plane normal and
north/east vectors).

A copy of the JAX package's ``pydsproutines_tpu/estimation/coords.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_B = 6356752.314245


def geodetic_lla_to_ecef(lat_rad, lon_rad, h, check_ranges: bool = False) -> np.ndarray:
    """Geodetic latitude/longitude (radians) + height (m) -> ECEF, returned as
    a (3, N) stack (reference geodeticLLA2ecef)."""
    lat_rad = np.asarray(lat_rad, dtype=np.float64)
    lon_rad = np.asarray(lon_rad, dtype=np.float64)
    if check_ranges and (np.any(np.abs(lat_rad) > np.pi / 2)
                         or np.any(np.abs(lon_rad) > np.pi)):
        raise ValueError("Latitude/longitude magnitudes too large — radians?")
    a, b = WGS84_A, WGS84_B
    n = a ** 2 / np.sqrt(a ** 2 * np.cos(lat_rad) ** 2
                         + b ** 2 * np.sin(lat_rad) ** 2)
    x = (n + h) * np.cos(lat_rad) * np.cos(lon_rad)
    y = (n + h) * np.cos(lat_rad) * np.sin(lon_rad)
    z = (b ** 2 / a ** 2 * n + h) * np.sin(lat_rad)
    return np.vstack((x, y, z))


def ecef_to_geodetic_lla(x: np.ndarray) -> np.ndarray:
    """ECEF (3,) or (3, N) -> (lat deg, lon deg, height m) stacked (3, N).

    Closed-form Bowring/Vermeille-style iteration (the reference delegates to
    skyfield; this matches to sub-millimetre for terrestrial heights).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x.reshape(3, 1)
    if x.shape[0] != 3:
        raise ValueError("Expected 3xN array.")
    a, b = WGS84_A, WGS84_B
    e2 = 1 - (b / a) ** 2
    ep2 = (a / b) ** 2 - 1
    px, py, pz = x[0], x[1], x[2]
    lon = np.arctan2(py, px)
    p = np.hypot(px, py)
    # Bowring's method
    theta = np.arctan2(pz * a, p * b)
    lat = np.arctan2(pz + ep2 * b * np.sin(theta) ** 3,
                     p - e2 * a * np.cos(theta) ** 3)
    for _ in range(3):  # a couple of fixed-point refinements
        n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - n
        lat = np.arctan2(pz, p * (1 - e2 * n / (n + h)))
    n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - n
    return np.vstack((np.degrees(lat), np.degrees(lon), h))


def get_wgs84_tangent_plane_normal(ecef_pos: np.ndarray) -> np.ndarray:
    """Ellipsoid-gradient normal at an ECEF position (reference
    get_wgs84_tangent_plane_normal, localizationRoutines.py:30)."""
    ecef_pos = np.asarray(ecef_pos)
    return np.array([2 / WGS84_A ** 2, 2 / WGS84_A ** 2,
                     2 / WGS84_B ** 2]) * ecef_pos


def get_wgs84_tangent_plane_north_east(ecef_normal: np.ndarray):
    """Unit north/east vectors of the tangent plane (reference
    localizationRoutines.py:56)."""
    east = np.cross(np.array([0.0, 0.0, 1.0]), ecef_normal)
    east = east / np.linalg.norm(east)
    north = np.cross(ecef_normal, east)
    north = north / np.linalg.norm(north)
    return north, east
