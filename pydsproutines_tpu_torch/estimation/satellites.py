"""Satellite ephemeris: TLE parsing, mean-element propagation, TEME->ITRS.

Reference semantics: satelliteRoutines.py (Satellite :28 — an
EarthSatellite with selectable gravity constants,
sf_propagate_satellite_to_gpstime :72, sf_geocentric_to_itrs :104). The
reference delegates the orbital mechanics to the third-party skyfield/sgp4
packages; those are optional here. When they are importable the same wrapper
surface routes to them. When they are not, a native backend keeps the module
fully executable:

* exact TLE field parsing (with checksum verification),
* a FULL SGP4/SDP4 propagator (SGP4Propagator): the published Vallado
  near-earth algorithm (secular J2/J2^2/J4, B* drag series, long/short
  periodics — validated to sub-metre against the classic check states)
  plus, for period >= 225 min TLEs, the complete deep-space (SDP4)
  machinery: lunar/solar secular + periodic perturbations (dscom/dpper)
  and the 12h/24h geopotential-resonance integrator (dsinit/dspace),
  validated at epoch to sub-metre against the published deep-space check
  state and by GEO/Molniya resonance invariants
  (tests/test_satellites.py),
* a Brouwer-style secular J2 propagator (J2Propagator) kept as a
  lightweight alternative backend,
* IAU-1982 GMST rotation TEME -> ITRS (ECEF), position and velocity.

GPS times follow the reference convention: UTC-locked unix seconds
(satelliteRoutines.py:91-95).

A copy of the JAX package's ``pydsproutines_tpu/estimation/satellites.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

import numpy as np

try:  # pragma: no cover - exercised only where skyfield is installed
    from sgp4.api import Satrec, WGS72 as _SGP4_WGS72
    from skyfield.api import EarthSatellite, load
    from skyfield.framelib import itrs as _itrs

    _HAVE_SKYFIELD = True
except ImportError:  # pragma: no cover
    _HAVE_SKYFIELD = False


# -- gravity models ----------------------------------------------------------

@dataclass(frozen=True)
class GravityConstants:
    """Earth gravity model constants (km, s)."""
    mu: float      # km^3/s^2
    re: float      # equatorial radius, km
    j2: float
    j3: float = 0.0
    j4: float = 0.0

    @property
    def ke(self) -> float:
        """sqrt(mu) in earth-radii^1.5 per minute (classic SGP4 units)."""
        return 60.0 / np.sqrt(self.re ** 3 / self.mu)


# TLEs are fitted against WGS72 — the reference defaults to it for the same
# reason (satelliteRoutines.py:14).
WGS72 = GravityConstants(mu=398600.8, re=6378.135, j2=0.001082616,
                         j3=-0.00000253881, j4=-0.00000165597)
WGS84 = GravityConstants(mu=398600.5, re=6378.137, j2=0.00108262998905,
                         j3=-0.00000253215306, j4=-0.00000161098761)


# -- TLE parsing -------------------------------------------------------------

def _tle_checksum(line: str) -> int:
    total = 0
    for ch in line[:68]:
        if ch.isdigit():
            total += int(ch)
        elif ch == "-":
            total += 1
    return total % 10


def _parse_implied_decimal(field: str) -> float:
    """TLE ``+NNNNN-E`` fields: mantissa with implied leading decimal point
    and a signed one-digit power-of-ten exponent."""
    field = field.strip()
    sign = -1.0 if field.startswith("-") else 1.0
    body = field.lstrip("+-")
    mantissa = body[:-2]
    exp = int(body[-2:].replace(" ", "0"))
    if not mantissa:
        return 0.0
    return sign * float("0." + mantissa) * 10.0 ** exp


@dataclass(frozen=True)
class TLE:
    """Parsed two-line element set (angles in radians, mean motion in
    rad/min, epoch as UTC-locked unix seconds)."""
    satnum: int
    epoch_unix: float
    bstar: float
    inclo: float       # inclination
    nodeo: float       # RAAN
    ecco: float        # eccentricity
    argpo: float       # argument of perigee
    mo: float          # mean anomaly
    no_kozai: float    # mean motion, rad/min (Kozai convention, as fitted)
    revnum: int
    line1: str = ""
    line2: str = ""


def parse_tle(line1: str, line2: str, validate_checksum: bool = True) -> TLE:
    """Parse a TLE pair into numeric elements.

    Field layout per the public TLE format specification; checksums are
    verified unless ``validate_checksum=False``.
    """
    line1 = line1.rstrip()
    line2 = line2.rstrip()
    if len(line1) < 69 or len(line2) < 69:
        raise ValueError("TLE lines must be at least 69 characters")
    if line1[0] != "1" or line2[0] != "2":
        raise ValueError("TLE line numbers must be '1' and '2'")
    if validate_checksum:
        for ln in (line1, line2):
            if _tle_checksum(ln) != int(ln[68]):
                raise ValueError(f"TLE checksum mismatch on line: {ln!r}")

    satnum = int(line1[2:7])
    if satnum != int(line2[2:7]):
        raise ValueError("TLE line1/line2 satellite numbers differ")

    # epoch: 2-digit year + fractional day-of-year
    yy = int(line1[18:20])
    year = 2000 + yy if yy < 57 else 1900 + yy
    doy = float(line1[20:32])
    epoch = (_dt.datetime(year, 1, 1, tzinfo=_dt.timezone.utc)
             + _dt.timedelta(days=doy - 1.0))
    epoch_unix = epoch.timestamp()

    bstar = _parse_implied_decimal(line1[53:61])
    inclo = np.deg2rad(float(line2[8:16]))
    nodeo = np.deg2rad(float(line2[17:25]))
    ecco = float("0." + line2[26:33].strip())
    argpo = np.deg2rad(float(line2[34:42]))
    mo = np.deg2rad(float(line2[43:51]))
    no_kozai = float(line2[52:63]) * 2.0 * np.pi / 1440.0  # rev/day -> rad/min
    revnum = int(line2[63:68])
    return TLE(satnum, epoch_unix, bstar, inclo, nodeo, ecco, argpo, mo,
               no_kozai, revnum, line1, line2)


# -- native J2 secular propagator -------------------------------------------

class J2Propagator:
    """Brouwer-style secular J2 mean-element propagator over a TLE.

    Carries the dominant secular terms SGP4 carries (RAAN regression, argp
    advance, mean-anomaly rate correction, Kozai->Brouwer mean-motion
    recovery) without the short/long-periodic or drag series. See module
    docstring for the accuracy statement.
    """

    def __init__(self, tle: TLE, const: GravityConstants = WGS72):
        self.tle = tle
        self.const = const
        k2 = const.j2 / 2.0  # earth radii^2
        cosi = np.cos(tle.inclo)
        cosi2 = cosi * cosi
        e2 = tle.ecco ** 2
        beta = np.sqrt(1.0 - e2)

        # Kozai -> Brouwer mean motion (standard element-recovery step of the
        # published SGP4 initialization; units: earth radii / minute).
        no = tle.no_kozai
        a1 = (const.ke / no) ** (2.0 / 3.0)
        d1 = 1.5 * k2 * (3.0 * cosi2 - 1.0) / (a1 ** 2 * beta ** 3)
        a0 = a1 * (1.0 - d1 / 3.0 - d1 ** 2 - 134.0 / 81.0 * d1 ** 3)
        d0 = 1.5 * k2 * (3.0 * cosi2 - 1.0) / (a0 ** 2 * beta ** 3)
        self.n_rad_min = no / (1.0 + d0)           # Brouwer mean motion
        self.a_er = (const.ke / self.n_rad_min) ** (2.0 / 3.0)
        self.a_km = self.a_er * const.re

        # secular rates (rad/min)
        p = self.a_er * beta ** 2                  # semilatus rectum, er
        fac = 1.5 * const.j2 * (1.0 / p) ** 2 * self.n_rad_min
        self.node_dot = -fac * cosi
        self.argp_dot = fac * (2.0 - 2.5 * np.sin(tle.inclo) ** 2)
        self.m_dot = self.n_rad_min * (
            1.0 + 1.5 * const.j2 * (1.0 / p) ** 2 * beta
            * (1.0 - 1.5 * np.sin(tle.inclo) ** 2))

    @staticmethod
    def _kepler(mean_anom: np.ndarray, ecc: float, iters: int = 12):
        """Newton solve E - e sin E = M (vectorized)."""
        e_anom = np.where(ecc < 0.8, mean_anom, np.pi * np.ones_like(mean_anom))
        for _ in range(iters):
            f = e_anom - ecc * np.sin(e_anom) - mean_anom
            fp = 1.0 - ecc * np.cos(e_anom)
            e_anom = e_anom - f / fp
        return e_anom

    def teme_posvel(self, t_unix) -> tuple[np.ndarray, np.ndarray]:
        """TEME position (km) and velocity (km/s), shapes (N, 3)."""
        t_unix = np.atleast_1d(np.asarray(t_unix, dtype=np.float64))
        tsince = (t_unix - self.tle.epoch_unix) / 60.0  # minutes

        ecc = self.tle.ecco
        m = self.tle.mo + self.m_dot * tsince
        node = self.tle.nodeo + self.node_dot * tsince
        argp = self.tle.argpo + self.argp_dot * tsince

        e_anom = self._kepler(np.mod(m, 2.0 * np.pi), ecc)
        cos_e, sin_e = np.cos(e_anom), np.sin(e_anom)
        beta = np.sqrt(1.0 - ecc ** 2)
        # perifocal coordinates (km, km/s)
        r_mag = self.a_km * (1.0 - ecc * cos_e)
        xp = self.a_km * (cos_e - ecc)
        yp = self.a_km * beta * sin_e
        # dE/dt from Kepler's equation; n in rad/s
        n_rad_s = self.n_rad_min / 60.0
        e_dot = n_rad_s * self.a_km / r_mag
        vxp = -self.a_km * sin_e * e_dot
        vyp = self.a_km * beta * cos_e * e_dot

        # perifocal -> TEME: Rz(-node) Rx(-i) Rz(-argp)
        ci, si = np.cos(self.tle.inclo), np.sin(self.tle.inclo)
        cn, sn = np.cos(node), np.sin(node)
        cw, sw = np.cos(argp), np.sin(argp)
        # row vectors of the combined rotation applied to (xp, yp, 0)
        px = cn * cw - sn * sw * ci
        py = -cn * sw - sn * cw * ci
        qx = sn * cw + cn * sw * ci
        qy = -sn * sw + cn * cw * ci
        wx = sw * si
        wy = cw * si
        r = np.stack([px * xp + py * yp,
                      qx * xp + qy * yp,
                      wx * xp + wy * yp], axis=-1)
        v = np.stack([px * vxp + py * vyp,
                      qx * vxp + qy * vyp,
                      wx * vxp + wy * vyp], axis=-1)
        return r, v


# -- native full SGP4 (near-earth) propagator --------------------------------

_TWOPI = 2.0 * np.pi


class DeepSpaceTLE(ValueError):
    """Retained for API compatibility (rounds 2-4 raised this for period
    >= 225 min TLEs). Round 5 implements the deep-space (SDP4) terms
    natively, so SGP4Propagator no longer raises it."""


# -- SDP4 deep-space machinery (Vallado revision) -----------------------------
# Published algorithm: "Revisiting Spacetrack Report #3" (Vallado, Crawford,
# Hujsak, Kelso 2006) deep-space sections — lunar/solar secular + periodic
# perturbations (dscom/dpper) and the 12h/24h geopotential-resonance
# integrator (dsinit/dspace). Reference reaches the same model through the
# sgp4 package (satelliteRoutines.py:28,72).

_ZES, _ZEL = 0.01675, 0.05490
_ZNS, _ZNL = 1.19459e-5, 1.5835218e-4      # solar/lunar mean motion, rad/min
_C1SS, _C1L = 2.9864797e-6, 4.7968065e-7
_RPTIM = 4.37526908801129966e-3             # earth rotation, rad/min


def _dscom(day1900: float, ep: float, argpp: float, inclp: float,
           nodep: float, np_: float) -> dict:
    """Lunar/solar geometry + periodic coefficients at epoch (dscom)."""
    d = {}
    emsq = ep * ep
    betasq = 1.0 - emsq
    rtemsq = np.sqrt(betasq)
    sinomm, cosomm = np.sin(argpp), np.cos(argpp)
    sinim, cosim = np.sin(inclp), np.cos(inclp)
    sinnod, cosnod = np.sin(nodep), np.cos(nodep)

    # lunar orbit geometry at epoch
    xnodce = np.mod(4.5236020 - 9.2422029e-4 * day1900, _TWOPI)
    stem, ctem = np.sin(xnodce), np.cos(xnodce)
    zcosil = 0.91375164 - 0.03568096 * ctem
    zsinil = np.sqrt(1.0 - zcosil * zcosil)
    zsinhl = 0.089683511 * stem / zsinil
    zcoshl = np.sqrt(1.0 - zsinhl * zsinhl)
    gam = 5.8351514 + 0.0019443680 * day1900
    zx = 0.39785416 * stem / zsinil
    zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
    zx = gam + np.arctan2(zx, zy) - xnodce
    zcosgl, zsingl = np.cos(zx), np.sin(zx)

    # two passes: solar (s prefix on output) then lunar
    zcosg, zsing = 0.1945905, -0.98088458   # solar
    zcosi, zsini = 0.91744867, 0.39785416
    zcosh, zsinh = cosnod, sinnod
    cc = _C1SS
    xnoi = 1.0 / np_
    for lsflg in (1, 2):
        a1 = zcosg * zcosh + zsing * zcosi * zsinh
        a3 = -zsing * zcosh + zcosg * zcosi * zsinh
        a7 = -zcosg * zsinh + zsing * zcosi * zcosh
        a8 = zsing * zsini
        a9 = zsing * zsinh + zcosg * zcosi * zcosh
        a10 = zcosg * zsini
        a2 = cosim * a7 + sinim * a8
        a4 = cosim * a9 + sinim * a10
        a5 = -sinim * a7 + cosim * a8
        a6 = -sinim * a9 + cosim * a10
        x1 = a1 * cosomm + a2 * sinomm
        x2 = a3 * cosomm + a4 * sinomm
        x3 = -a1 * sinomm + a2 * cosomm
        x4 = -a3 * sinomm + a4 * cosomm
        x5 = a5 * sinomm
        x6 = a6 * sinomm
        x7 = a5 * cosomm
        x8 = a6 * cosomm
        z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
        z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
        z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
        z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
        z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
        z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
        z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
        z12 = (-6.0 * (a1 * a6 + a3 * a5)
               + emsq * (-24.0 * (x2 * x7 + x1 * x8)
                         - 6.0 * (x3 * x6 + x4 * x5)))
        z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
        z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
        z22 = (6.0 * (a4 * a5 + a2 * a6)
               + emsq * (24.0 * (x2 * x5 + x1 * x6)
                         - 6.0 * (x4 * x7 + x3 * x8)))
        z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
        z1 = z1 + z1 + betasq * z31
        z2 = z2 + z2 + betasq * z32
        z3 = z3 + z3 + betasq * z33
        s3 = cc * xnoi
        s2 = -0.5 * s3 / rtemsq
        s4 = s3 * rtemsq
        s1 = -15.0 * ep * s4
        s5 = x1 * x3 + x2 * x4
        s6 = x2 * x3 + x1 * x4
        s7 = x2 * x4 - x1 * x3
        if lsflg == 1:
            d.update(ss1=s1, ss2=s2, ss3=s3, ss4=s4, ss5=s5, ss6=s6, ss7=s7,
                     sz1=z1, sz2=z2, sz3=z3, sz11=z11, sz12=z12, sz13=z13,
                     sz21=z21, sz22=z22, sz23=z23, sz31=z31, sz32=z32,
                     sz33=z33)
            zcosg, zsing = zcosgl, zsingl
            zcosi, zsini = zcosil, zsinil
            zcosh = zcoshl * cosnod + zsinhl * sinnod
            zsinh = sinnod * zcoshl - cosnod * zsinhl
            cc = _C1L
        else:
            d.update(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
                     z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
                     z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33)

    d["zmol"] = np.mod(4.7199672 + 0.22997150 * day1900 - gam, _TWOPI)
    d["zmos"] = np.mod(6.2565837 + 0.017201977 * day1900, _TWOPI)
    # lunar/solar periodic coefficients (applied by _dpper)
    d["se2"] = 2.0 * d["ss1"] * d["ss6"]
    d["se3"] = 2.0 * d["ss1"] * d["ss7"]
    d["si2"] = 2.0 * d["ss2"] * d["sz12"]
    d["si3"] = 2.0 * d["ss2"] * (d["sz13"] - d["sz11"])
    d["sl2"] = -2.0 * d["ss3"] * d["sz2"]
    d["sl3"] = -2.0 * d["ss3"] * (d["sz3"] - d["sz1"])
    d["sl4"] = -2.0 * d["ss3"] * (-21.0 - 9.0 * emsq) * _ZES
    d["sgh2"] = 2.0 * d["ss4"] * d["sz32"]
    d["sgh3"] = 2.0 * d["ss4"] * (d["sz33"] - d["sz31"])
    d["sgh4"] = -18.0 * d["ss4"] * _ZES
    d["sh2"] = -2.0 * d["ss2"] * d["sz22"]
    d["sh3"] = -2.0 * d["ss2"] * (d["sz23"] - d["sz21"])
    d["ee2"] = 2.0 * d["s1"] * d["s6"]
    d["e3"] = 2.0 * d["s1"] * d["s7"]
    d["xi2"] = 2.0 * d["s2"] * d["z12"]
    d["xi3"] = 2.0 * d["s2"] * (d["z13"] - d["z11"])
    d["xl2"] = -2.0 * d["s3"] * d["z2"]
    d["xl3"] = -2.0 * d["s3"] * (d["z3"] - d["z1"])
    d["xl4"] = -2.0 * d["s3"] * (-21.0 - 9.0 * emsq) * _ZEL
    d["xgh2"] = 2.0 * d["s4"] * d["z32"]
    d["xgh3"] = 2.0 * d["s4"] * (d["z33"] - d["z31"])
    d["xgh4"] = -18.0 * d["s4"] * _ZEL
    d["xh2"] = -2.0 * d["s2"] * d["z22"]
    d["xh3"] = -2.0 * d["s2"] * (d["z23"] - d["z21"])
    d["emsq0"] = emsq
    return d


def _dsinit(d: dict, tle: TLE, c: dict, gsto: float) -> None:
    """Deep-space secular rates + resonance initialization (dsinit);
    extends ``d`` in place."""
    nm = c["no_unkozai"]
    em = tle.ecco
    emsq = d["emsq0"]
    sinim, cosim = np.sin(tle.inclo), np.cos(tle.inclo)

    ses = d["ss1"] * _ZNS * d["ss5"]
    sis = d["ss2"] * _ZNS * (d["sz11"] + d["sz13"])
    sls = -_ZNS * d["ss3"] * (d["sz1"] + d["sz3"] - 14.0 - 6.0 * emsq)
    sghs = d["ss4"] * _ZNS * (d["sz31"] + d["sz33"] - 6.0)
    shs = -_ZNS * d["ss2"] * (d["sz21"] + d["sz23"])
    # inclination-singularity guards (i < 3 deg or > 177 deg)
    if tle.inclo < 5.2359877e-2 or tle.inclo > np.pi - 5.2359877e-2:
        shs = 0.0
    if sinim != 0.0:
        shs = shs / sinim
    sgs = sghs - cosim * shs

    d["dedt"] = ses + d["s1"] * _ZNL * d["s5"]
    d["didt"] = sis + d["s2"] * _ZNL * (d["z11"] + d["z13"])
    d["dmdt"] = sls - _ZNL * d["s3"] * (d["z1"] + d["z3"] - 14.0
                                        - 6.0 * emsq)
    sghl = d["s4"] * _ZNL * (d["z31"] + d["z33"] - 6.0)
    shll = -_ZNL * d["s2"] * (d["z21"] + d["z23"])
    if tle.inclo < 5.2359877e-2 or tle.inclo > np.pi - 5.2359877e-2:
        shll = 0.0
    d["domdt"] = sgs + sghl
    d["dnodt"] = shs
    if sinim != 0.0:
        d["domdt"] -= cosim / sinim * shll
        d["dnodt"] += shll / sinim

    # resonance selection
    theta = np.mod(gsto, _TWOPI)
    irez = 0
    if 0.0034906585 < nm < 0.0052359877:
        irez = 1                           # 24h synchronous band
    if 8.26e-3 <= nm <= 9.24e-3 and em >= 0.5:
        irez = 2                           # 12h eccentric (Molniya) band
    d["irez"] = irez
    if irez == 0:
        return

    aonv = (nm / c["xke"]) ** (2.0 / 3.0)
    cosisq = cosim * cosim
    eoc = em * emsq
    if irez == 2:
        # geopotential resonance G / F functions (12h band)
        g201 = -0.306 - (em - 0.64) * 0.440
        if em <= 0.65:
            g211 = 3.616 - 13.2470 * em + 16.2900 * emsq
            g310 = -19.302 + 117.3900 * em - 228.4190 * emsq + 156.5910 * eoc
            g322 = (-18.9068 + 109.7927 * em - 214.6334 * emsq
                    + 146.5816 * eoc)
            g410 = (-41.122 + 242.6940 * em - 471.0940 * emsq
                    + 313.9530 * eoc)
            g422 = (-146.407 + 841.8800 * em - 1629.014 * emsq
                    + 1083.4350 * eoc)
            g520 = (-532.114 + 3017.977 * em - 5740.032 * emsq
                    + 3708.2760 * eoc)
        else:
            g211 = -72.099 + 331.819 * em - 508.738 * emsq + 266.724 * eoc
            g310 = -346.844 + 1582.851 * em - 2415.925 * emsq + 1246.113 * eoc
            g322 = -342.585 + 1554.908 * em - 2366.899 * emsq + 1215.972 * eoc
            g410 = (-1052.797 + 4758.686 * em - 7193.992 * emsq
                    + 3651.957 * eoc)
            g422 = (-3581.690 + 16178.110 * em - 24462.770 * emsq
                    + 12422.520 * eoc)
            if em > 0.715:
                g520 = (-5149.66 + 29936.92 * em - 54087.36 * emsq
                        + 31324.56 * eoc)
            else:
                g520 = 1464.74 - 4664.75 * em + 3763.64 * emsq
        if em < 0.7:
            g533 = -919.22770 + 4988.6100 * em - 9064.7700 * emsq \
                + 5542.21 * eoc
            g521 = -822.71072 + 4568.6173 * em - 8491.4146 * emsq \
                + 5337.524 * eoc
            g532 = -853.66600 + 4690.2500 * em - 8624.7700 * emsq \
                + 5341.4 * eoc
        else:
            g533 = -37995.780 + 161616.52 * em - 229838.20 * emsq \
                + 109377.94 * eoc
            g521 = -51752.104 + 218913.95 * em - 309468.16 * emsq \
                + 146349.42 * eoc
            g532 = -40023.880 + 170470.89 * em - 242699.48 * emsq \
                + 115605.82 * eoc
        sini2 = sinim * sinim
        f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
        f221 = 1.5 * sini2
        f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
        f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
        f441 = 35.0 * sini2 * f220
        f442 = 39.3750 * sini2 * sini2
        f522 = 9.84375 * sinim * (sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
                                  + 0.33333333 * (-2.0 + 4.0 * cosim
                                                  + 6.0 * cosisq))
        f523 = sinim * (4.92187512 * sini2 * (-2.0 - 4.0 * cosim
                                              + 10.0 * cosisq)
                        + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq))
        f542 = 29.53125 * sinim * (2.0 - 8.0 * cosim
                                   + cosisq * (-12.0 + 8.0 * cosim
                                               + 10.0 * cosisq))
        f543 = 29.53125 * sinim * (-2.0 - 8.0 * cosim
                                   + cosisq * (12.0 + 8.0 * cosim
                                               - 10.0 * cosisq))
        xno2 = nm * nm
        ainv2 = aonv * aonv
        temp1 = 3.0 * xno2 * ainv2
        root22, root44, root54 = 1.7891679e-6, 7.3636953e-9, 2.1765803e-9
        root32, root52 = 3.7393792e-7, 1.1428639e-7
        temp = temp1 * root22
        d["d2201"] = temp * f220 * g201
        d["d2211"] = temp * f221 * g211
        temp1 = temp1 * aonv
        temp = temp1 * root32
        d["d3210"] = temp * f321 * g310
        d["d3222"] = temp * f322 * g322
        temp1 = temp1 * aonv
        temp = 2.0 * temp1 * root44
        d["d4410"] = temp * f441 * g410
        d["d4422"] = temp * f442 * g422
        temp1 = temp1 * aonv
        temp = temp1 * root52
        d["d5220"] = temp * f522 * g520
        d["d5232"] = temp * f523 * g532
        temp = 2.0 * temp1 * root54
        d["d5421"] = temp * f542 * g521
        d["d5433"] = temp * f543 * g533
        d["xlamo"] = np.mod(tle.mo + 2.0 * tle.nodeo - 2.0 * theta, _TWOPI)
        d["xfact"] = (c["mdot"] + d["dmdt"]
                      + 2.0 * (c["nodedot"] + d["dnodt"] - _RPTIM)
                      - c["no_unkozai"])
    else:
        # 24h synchronous resonance
        g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
        g310 = 1.0 + 2.0 * emsq
        g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
        f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim)
        f311 = (0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
                - 0.75 * (1.0 + cosim))
        f330 = 1.0 + cosim
        f330 = 1.875 * f330 * f330 * f330
        q22, q31, q33 = 1.7891679e-6, 2.1460748e-6, 2.2123015e-7
        del1 = 3.0 * nm * nm * aonv * aonv
        d["del2"] = 2.0 * del1 * f220 * g200 * q22
        d["del3"] = 3.0 * del1 * f330 * g300 * q33 * aonv
        d["del1"] = del1 * f311 * g310 * q31 * aonv
        d["xlamo"] = np.mod(tle.mo + tle.nodeo + tle.argpo - theta, _TWOPI)
        d["xfact"] = (c["mdot"] + c["argpdot"] + c["nodedot"] + d["dmdt"]
                      + d["domdt"] + d["dnodt"] - _RPTIM - c["no_unkozai"])


_FASX2, _FASX4, _FASX6 = 0.13130908, 2.8843198, 0.37448087
_G22, _G32, _G44, _G52, _G54 = (5.7686396, 0.95240898, 1.8014998,
                                1.0508330, 4.4108898)


def _dpper(d: dict, t, ep, inclp, nodep, argpp, mp):
    """Lunar/solar periodic perturbations at ``t`` minutes (dpper),
    vectorized; returns updated (ep, inclp, nodep, argpp, mp). Follows the
    published code: the epoch offsets peo..pho are zero, so the periodics
    are applied absolutely."""
    zm = d["zmos"] + _ZNS * t
    zf = zm + 2.0 * _ZES * np.sin(zm)
    sinzf = np.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * np.cos(zf)
    ses = d["se2"] * f2 + d["se3"] * f3
    sis = d["si2"] * f2 + d["si3"] * f3
    sls = d["sl2"] * f2 + d["sl3"] * f3 + d["sl4"] * sinzf
    sghs = d["sgh2"] * f2 + d["sgh3"] * f3 + d["sgh4"] * sinzf
    shs = d["sh2"] * f2 + d["sh3"] * f3
    zm = d["zmol"] + _ZNL * t
    zf = zm + 2.0 * _ZEL * np.sin(zm)
    sinzf = np.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * np.cos(zf)
    sel = d["ee2"] * f2 + d["e3"] * f3
    sil = d["xi2"] * f2 + d["xi3"] * f3
    sll = d["xl2"] * f2 + d["xl3"] * f3 + d["xl4"] * sinzf
    sghl = d["xgh2"] * f2 + d["xgh3"] * f3 + d["xgh4"] * sinzf
    shll = d["xh2"] * f2 + d["xh3"] * f3
    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    inclp = inclp + pinc
    ep = ep + pe
    sinip = np.sin(inclp)
    cosip = np.cos(inclp)

    # apply: direct form for i >= 0.2 rad, Lyddane modification below
    direct = inclp >= 0.2
    sini_safe = np.where(sinip == 0.0, 1.0, sinip)
    ph_d = ph / sini_safe
    argpp_d = argpp + (pgh - cosip * ph_d)
    nodep_d = nodep + ph_d
    mp_d = mp + pl

    sinop = np.sin(nodep)
    cosop = np.cos(nodep)
    alfdp = sinip * sinop + (ph * cosop + pinc * cosip * sinop)
    betdp = sinip * cosop + (-ph * sinop + pinc * cosip * cosop)
    nodel = np.mod(nodep, _TWOPI)
    xls = mp + argpp + cosip * nodel + (pl + pgh - pinc * nodel * sinip)
    xnoh = nodel
    nodel = np.arctan2(alfdp, betdp)
    nodel = np.where((np.abs(xnoh - nodel) > np.pi) & (nodel < xnoh),
                     nodel + _TWOPI, nodel)
    nodel = np.where((np.abs(xnoh - nodel) > np.pi) & (nodel >= xnoh),
                     nodel - _TWOPI, nodel)
    mp_l = mp + pl
    argpp_l = xls - mp_l - cosip * nodel

    return (ep, inclp,
            np.where(direct, nodep_d, nodel),
            np.where(direct, argpp_d, argpp_l),
            np.where(direct, mp_d, mp_l))


def _dspace_rates(d: dict, tle: TLE, c: dict, xli, xni, atime):
    """(xndt, xldot, xnddt) of the resonance integrator at state
    (xli, xni, atime); vectorized."""
    if d["irez"] == 2:
        xomi = tle.argpo + c["argpdot"] * atime
        x2omi = xomi + xomi
        x2li = xli + xli
        xndt = (d["d2201"] * np.sin(x2omi + xli - _G22)
                + d["d2211"] * np.sin(xli - _G22)
                + d["d3210"] * np.sin(xomi + xli - _G32)
                + d["d3222"] * np.sin(-xomi + xli - _G32)
                + d["d4410"] * np.sin(x2omi + x2li - _G44)
                + d["d4422"] * np.sin(x2li - _G44)
                + d["d5220"] * np.sin(xomi + xli - _G52)
                + d["d5232"] * np.sin(-xomi + xli - _G52)
                + d["d5421"] * np.sin(xomi + x2li - _G54)
                + d["d5433"] * np.sin(-xomi + x2li - _G54))
        xldot = xni + d["xfact"]
        xnddt = (d["d2201"] * np.cos(x2omi + xli - _G22)
                 + d["d2211"] * np.cos(xli - _G22)
                 + d["d3210"] * np.cos(xomi + xli - _G32)
                 + d["d3222"] * np.cos(-xomi + xli - _G32)
                 + d["d5220"] * np.cos(xomi + xli - _G52)
                 + d["d5232"] * np.cos(-xomi + xli - _G52)
                 + 2.0 * (d["d4410"] * np.cos(x2omi + x2li - _G44)
                          + d["d4422"] * np.cos(x2li - _G44)
                          + d["d5421"] * np.cos(xomi + x2li - _G54)
                          + d["d5433"] * np.cos(-xomi + x2li - _G54)))
        xnddt = xnddt * xldot
    else:
        xndt = (d["del1"] * np.sin(xli - _FASX2)
                + d["del2"] * np.sin(2.0 * (xli - _FASX4))
                + d["del3"] * np.sin(3.0 * (xli - _FASX6)))
        xldot = xni + d["xfact"]
        xnddt = (d["del1"] * np.cos(xli - _FASX2)
                 + 2.0 * d["del2"] * np.cos(2.0 * (xli - _FASX4))
                 + 3.0 * d["del3"] * np.cos(3.0 * (xli - _FASX6)))
        xnddt = xnddt * xldot
    return xndt, xldot, xnddt


class SGP4Propagator:
    """Full near-earth SGP4 mean-element propagator (Vallado revision).

    Implements the complete published near-earth SGP4 algorithm ("Revisiting
    Spacetrack Report #3", Vallado et al. 2006): Kozai->Brouwer element
    recovery, J2/J2^2/J4 secular rates, B* atmospheric-drag series
    (CC1..CC5, D2..D4 with the low-perigee s/q profile adjustments and the
    <220 km "simple" truncation), long-periodic axN/ayN/xL terms, the
    modified-Kepler solve, and the J2 short-periodic corrections — i.e. the
    same model the reference gets from the third-party sgp4 package
    (satelliteRoutines.py:28,72). Validated against the
    classic published verification vectors (tests/test_satellites.py).

    Deep-space orbits (period >= 225 min) additionally run the SDP4 terms
    (round 5): lunisolar secular rates + periodics (_dscom/_dsinit/_dpper)
    and the 12h/24h geopotential-resonance integrator (_dspace_rates with
    720-min steps), so GEO/HEO emitters get real fidelity instead of the
    former J2 fallback. ``deep`` reports the regime; propagation is
    vectorized over time in both.
    """

    def __init__(self, tle: TLE, const: GravityConstants = WGS72):
        if const.j3 == 0.0 or const.j4 == 0.0:
            raise ValueError("SGP4 needs j3/j4 (use WGS72/WGS84 constants)")
        self.tle = tle
        self.const = const
        c = {}
        j2, j3, j4 = const.j2, const.j3, const.j4
        re_km = const.re
        xke = const.ke
        j3oj2 = j3 / j2
        x2o3 = 2.0 / 3.0

        ecco, inclo = tle.ecco, tle.inclo
        no_kozai = tle.no_kozai
        eccsq = ecco * ecco
        omeosq = 1.0 - eccsq
        rteosq = np.sqrt(omeosq)
        cosio = np.cos(inclo)
        cosio2 = cosio * cosio
        sinio = np.sin(inclo)

        # Kozai -> Brouwer ("un-kozai") mean-motion recovery
        ak = (xke / no_kozai) ** x2o3
        d1 = 0.75 * j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
        del_ = d1 / (ak * ak)
        adel = ak * (1.0 - del_ * del_
                     - del_ * (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0))
        del_ = d1 / (adel * adel)
        no_unkozai = no_kozai / (1.0 + del_)
        # deep-space regime (period >= 225 min): SDP4's lunisolar +
        # resonance terms, initialized after the shared near-earth setup
        self.deep = _TWOPI / no_unkozai >= 225.0

        ao = (xke / no_unkozai) ** x2o3
        po = ao * omeosq
        con42 = 1.0 - 5.0 * cosio2
        con41 = -con42 - 2.0 * cosio2          # 3cos^2(i) - 1
        posq = po * po
        rp = ao * (1.0 - ecco)                 # perigee radius, earth radii

        # drag profile: s4 / (q0 - s)^4 with low-perigee adjustment
        sfour = 78.0 / re_km + 1.0
        qzms24 = ((120.0 - 78.0) / re_km) ** 4
        perige = (rp - 1.0) * re_km
        if perige < 156.0:
            sfour = perige - 78.0
            if perige < 98.0:
                sfour = 20.0
            qzms24 = ((120.0 - sfour) / re_km) ** 4
            sfour = sfour / re_km + 1.0
        pinvsq = 1.0 / posq

        tsi = 1.0 / (ao - sfour)
        eta = ao * ecco * tsi
        etasq = eta * eta
        eeta = ecco * eta
        psisq = abs(1.0 - etasq)
        coef = qzms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        cc2 = coef1 * no_unkozai * (
            ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * j2 * tsi / psisq * con41
            * (8.0 + 3.0 * etasq * (8.0 + etasq)))
        cc1 = tle.bstar * cc2
        cc3 = 0.0
        if ecco > 1.0e-4:
            cc3 = -2.0 * coef * tsi * j3oj2 * no_unkozai * sinio / ecco
        x1mth2 = 1.0 - cosio2
        cc4 = 2.0 * no_unkozai * coef1 * ao * omeosq * (
            eta * (2.0 + 0.5 * etasq) + ecco * (0.5 + 2.0 * etasq)
            - j2 * tsi / (ao * psisq)
            * (-3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
               + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
               * np.cos(2.0 * tle.argpo)))
        cc5 = 2.0 * coef1 * ao * omeosq * (
            1.0 + 2.75 * (etasq + eeta) + eeta * etasq)

        cosio4 = cosio2 * cosio2
        temp1 = 1.5 * j2 * pinvsq * no_unkozai
        temp2 = 0.5 * temp1 * j2 * pinvsq
        temp3 = -0.46875 * j4 * pinvsq * pinvsq * no_unkozai
        c["mdot"] = no_unkozai + 0.5 * temp1 * rteosq * con41 \
            + 0.0625 * temp2 * rteosq * (13.0 - 78.0 * cosio2 + 137.0 * cosio4)
        c["argpdot"] = (-0.5 * temp1 * con42
                        + 0.0625 * temp2
                        * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
                        + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4))
        xhdot1 = -temp1 * cosio
        c["nodedot"] = xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2)
                                 + 2.0 * temp3 * (3.0 - 7.0 * cosio2)) * cosio
        c["omgcof"] = tle.bstar * cc3 * np.cos(tle.argpo)
        c["xmcof"] = 0.0
        if ecco > 1.0e-4:
            c["xmcof"] = -x2o3 * coef * tle.bstar / eeta
        c["nodecf"] = 3.5 * omeosq * xhdot1 * cc1
        c["t2cof"] = 1.5 * cc1
        # xlcof: guarded against the i ~ 180 deg singularity
        denom = 1.0 + cosio if abs(1.0 + cosio) > 1.5e-12 else 1.5e-12
        c["xlcof"] = -0.25 * j3oj2 * sinio * (3.0 + 5.0 * cosio) / denom
        c["aycof"] = -0.5 * j3oj2 * sinio
        c["delmo"] = (1.0 + eta * np.cos(tle.mo)) ** 3
        c["sinmao"] = np.sin(tle.mo)
        c["x7thm1"] = 7.0 * cosio2 - 1.0

        c["isimp"] = rp < (220.0 / re_km + 1.0) or self.deep
        c["d2"] = c["d3"] = c["d4"] = 0.0
        c["t3cof"] = c["t4cof"] = c["t5cof"] = 0.0
        if not c["isimp"]:
            cc1sq = cc1 * cc1
            c["d2"] = 4.0 * ao * tsi * cc1sq
            temp = c["d2"] * tsi * cc1 / 3.0
            c["d3"] = (17.0 * ao + sfour) * temp
            c["d4"] = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1
            c["t3cof"] = c["d2"] + 2.0 * cc1sq
            c["t4cof"] = 0.25 * (3.0 * c["d3"]
                                 + cc1 * (12.0 * c["d2"] + 10.0 * cc1sq))
            c["t5cof"] = 0.2 * (3.0 * c["d4"] + 12.0 * cc1 * c["d3"]
                                + 6.0 * c["d2"] ** 2
                                + 15.0 * cc1sq * (2.0 * c["d2"] + cc1sq))
        c.update(no_unkozai=no_unkozai, ao=ao, cc1=cc1, cc4=cc4, cc5=cc5,
                 eta=eta, con41=con41, x1mth2=x1mth2, xke=xke, re_km=re_km)
        c["j3oj2"] = j3oj2
        self.c = c
        self.n_rad_min = no_unkozai
        self.a_km = ao * re_km
        self.ds = None
        if self.deep:
            self.gsto = float(gmst_rad(tle.epoch_unix)[0])
            # dscom's lunisolar phase polynomials are referenced to
            # 1900 Jan 0.5 (the published code's epoch-2433281.5 +
            # 18261.5): jd - 2415020.0
            day1900 = tle.epoch_unix / 86400.0 + 25567.5
            ds = _dscom(day1900, ecco, tle.argpo, inclo, tle.nodeo,
                        no_unkozai)
            _dsinit(ds, tle, c, self.gsto)
            self.ds = ds

    def teme_posvel_tsince(self, tsince_min):
        """TEME position (km) and velocity (km/s) at minutes since epoch;
        vectorized over ``tsince_min``, shapes (N, 3)."""
        c = self.c
        tle = self.tle
        t = np.atleast_1d(np.asarray(tsince_min, dtype=np.float64))
        bad = np.zeros(t.shape, dtype=bool)

        # secular gravity + atmospheric drag
        xmdf = tle.mo + c["mdot"] * t
        argpdf = tle.argpo + c["argpdot"] * t
        nodedf = tle.nodeo + c["nodedot"] * t
        argpm = argpdf
        mm = xmdf
        t2 = t * t
        nodem = nodedf + c["nodecf"] * t2
        tempa = 1.0 - c["cc1"] * t
        tempe = tle.bstar * c["cc4"] * t
        templ = c["t2cof"] * t2
        if not c["isimp"]:
            delomg = c["omgcof"] * t
            delmtemp = 1.0 + c["eta"] * np.cos(xmdf)
            delm = c["xmcof"] * (delmtemp ** 3 - c["delmo"])
            temp = delomg + delm
            mm = xmdf + temp
            argpm = argpdf - temp
            t3 = t2 * t
            t4 = t3 * t
            tempa = tempa - c["d2"] * t2 - c["d3"] * t3 - c["d4"] * t4
            tempe = tempe + tle.bstar * c["cc5"] * (np.sin(mm) - c["sinmao"])
            templ = templ + c["t3cof"] * t3 \
                + t4 * (c["t4cof"] + t * c["t5cof"])
        inclm = np.broadcast_to(np.float64(tle.inclo), t.shape)
        if self.deep:
            # SDP4 deep-space secular rates + resonance integration
            ds = self.ds
            em_pre = tle.ecco + ds["dedt"] * t
            inclm = tle.inclo + ds["didt"] * t
            argpm = argpm + ds["domdt"] * t
            nodem = nodem + ds["dnodt"] * t
            mm = mm + ds["dmdt"] * t
            nm = np.broadcast_to(np.float64(c["no_unkozai"]), t.shape)
            if ds["irez"] != 0:
                # resonance integrator: 720-min Euler steps from epoch
                # (stateless restart, identical to the published reset
                # path), vectorized over t with active-sample masking
                theta_t = np.mod(self.gsto + t * _RPTIM, _TWOPI)
                xli = np.full_like(t, ds["xlamo"])
                xni = np.full_like(t, c["no_unkozai"])
                atime = np.zeros_like(t)
                delt = np.where(t >= 0.0, 720.0, -720.0)
                nloops = int(np.ceil(np.max(np.abs(t)) / 720.0)) \
                    if t.size else 0
                for _ in range(nloops):
                    active = np.abs(t - atime) >= 720.0
                    xndt, xldot, xnddt = _dspace_rates(ds, tle, c, xli,
                                                       xni, atime)
                    xli = np.where(active,
                                   xli + xldot * delt + xndt * 259200.0,
                                   xli)
                    xni = np.where(active,
                                   xni + xndt * delt + xnddt * 259200.0,
                                   xni)
                    atime = np.where(active, atime + delt, atime)
                xndt, xldot, xnddt = _dspace_rates(ds, tle, c, xli, xni,
                                                   atime)
                ft = t - atime
                xl = xli + xldot * ft + xndt * ft * ft * 0.5
                nm = xni + xndt * ft + xnddt * ft * ft * 0.5
                if ds["irez"] == 1:
                    mm = xl - nodem - argpm + theta_t
                else:
                    mm = xl - 2.0 * nodem + 2.0 * theta_t
            bad = bad | (nm <= 0.0)
            am = (c["xke"] / np.where(nm > 0, nm, 1.0)) ** (2.0 / 3.0) \
                * tempa ** 2
            nm = c["xke"] / am ** 1.5
            em_raw = em_pre - tempe
        else:
            am = c["ao"] * tempa ** 2
            nm = c["xke"] / am ** 1.5
            em_raw = tle.ecco - tempe
        # reference error semantics (sgp4 package, as wrapped by
        # satelliteRoutines.py:28): mean motion <= 0 or
        # eccentricity >= 1 is a propagation error — flag the sample
        # instead of silently returning garbage (samples NaN-masked below)
        bad = bad | (nm <= 0.0) | (em_raw >= 1.0) | (em_raw < -0.001)
        em = np.maximum(em_raw, 1.0e-6)
        mm = mm + c["no_unkozai"] * templ
        xlm = mm + argpm + nodem
        nodem = np.mod(nodem, _TWOPI)
        argpm = np.mod(argpm, _TWOPI)
        xlm = np.mod(xlm, _TWOPI)
        mm = np.mod(xlm - argpm - nodem, _TWOPI)

        # lunar/solar periodics (deep space), then long-periodic terms
        ep, xincp, nodep, argpp, mp = em, inclm, nodem, argpm, mm
        if self.deep:
            ep, xincp, nodep, argpp, mp = _dpper(self.ds, t, ep, xincp,
                                                 nodep, argpp, mp)
            neg = xincp < 0.0
            xincp = np.where(neg, -xincp, xincp)
            nodep = np.where(neg, nodep + np.pi, nodep)
            argpp = np.where(neg, argpp - np.pi, argpp)
            bad = bad | (ep < 0.0) | (ep > 1.0)
            ep = np.clip(ep, 1.0e-6, 0.999999)
            sinip = np.sin(xincp)
            cosip = np.cos(xincp)
            aycof = -0.5 * c["j3oj2"] * sinip
            denom = np.where(np.abs(1.0 + cosip) > 1.5e-12, 1.0 + cosip,
                             1.5e-12)
            xlcof = -0.25 * c["j3oj2"] * sinip * (3.0 + 5.0 * cosip) / denom
            cosip2 = cosip * cosip
            con41 = 3.0 * cosip2 - 1.0
            x1mth2 = 1.0 - cosip2
            x7thm1 = 7.0 * cosip2 - 1.0
        else:
            sinip = np.sin(tle.inclo)
            cosip = np.cos(tle.inclo)
            aycof, xlcof = c["aycof"], c["xlcof"]
            con41, x1mth2 = c["con41"], c["x1mth2"]
            x7thm1 = c["x7thm1"]

        axnl = ep * np.cos(argpp)
        temp = 1.0 / (am * (1.0 - ep * ep))
        aynl = ep * np.sin(argpp) + temp * aycof
        xl = mp + argpp + nodep + temp * xlcof * axnl

        # modified-Kepler solve for E + omega
        u = np.mod(xl - nodep, _TWOPI)
        eo1 = u.copy()
        for _ in range(12):
            sineo1 = np.sin(eo1)
            coseo1 = np.cos(eo1)
            tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl
            tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5
            eo1 = eo1 + np.clip(tem5, -0.95, 0.95)
        sineo1 = np.sin(eo1)
        coseo1 = np.cos(eo1)

        # short-periodic corrections
        ecose = axnl * coseo1 + aynl * sineo1
        esine = axnl * sineo1 - aynl * coseo1
        el2 = axnl * axnl + aynl * aynl
        pl = am * (1.0 - el2)
        rl = am * (1.0 - ecose)
        rdotl = np.sqrt(am) * esine / rl
        rvdotl = np.sqrt(pl) / rl
        betal = np.sqrt(1.0 - el2)
        temp = esine / (1.0 + betal)
        sinu = am / rl * (sineo1 - aynl - axnl * temp)
        cosu = am / rl * (coseo1 - axnl + aynl * temp)
        su = np.arctan2(sinu, cosu)
        sin2u = 2.0 * cosu * sinu
        cos2u = 1.0 - 2.0 * sinu * sinu
        temp = 1.0 / pl
        temp1 = 0.5 * self.const.j2 * temp
        temp2 = temp1 * temp

        mrt = rl * (1.0 - 1.5 * temp2 * betal * con41) \
            + 0.5 * temp1 * x1mth2 * cos2u
        su = su - 0.25 * temp2 * x7thm1 * sin2u
        xnode = nodep + 1.5 * temp2 * cosip * sin2u
        xinc = xincp + 1.5 * temp2 * cosip * sinip * cos2u
        mvt = rdotl - nm * temp1 * x1mth2 * sin2u / c["xke"]
        rvdot = rvdotl + nm * temp1 * (x1mth2 * cos2u
                                       + 1.5 * con41) / c["xke"]

        # orientation vectors -> TEME
        sinsu = np.sin(su)
        cossu = np.cos(su)
        snod = np.sin(xnode)
        cnod = np.cos(xnode)
        sini = np.sin(xinc)
        cosi = np.cos(xinc)
        xmx = -snod * cosi
        xmy = cnod * cosi
        ux = xmx * sinsu + cnod * cossu
        uy = xmy * sinsu + snod * cossu
        uz = sini * sinsu
        vx = xmx * cossu - cnod * sinsu
        vy = xmy * cossu - snod * sinsu
        vz = sini * cossu

        re_km = c["re_km"]
        vkmps = re_km * c["xke"] / 60.0
        r = np.stack([mrt * ux, mrt * uy, mrt * uz], axis=-1) * re_km
        v = np.stack([mvt * ux + rvdot * vx,
                      mvt * uy + rvdot * vy,
                      mvt * uz + rvdot * vz], axis=-1) * vkmps
        # decayed-satellite check (reference sgp4 error code 6: mrt < 1.0
        # means the propagated radius is below the Earth's surface): NaN
        # the affected samples rather than returning subterranean states
        bad = bad | (mrt < 1.0)
        if np.any(bad):
            r = np.where(bad[..., None], np.nan, r)
            v = np.where(bad[..., None], np.nan, v)
        return r, v

    def teme_posvel(self, t_unix) -> tuple[np.ndarray, np.ndarray]:
        """TEME position (km) and velocity (km/s), shapes (N, 3) — same
        surface as J2Propagator.teme_posvel."""
        t_unix = np.atleast_1d(np.asarray(t_unix, dtype=np.float64))
        return self.teme_posvel_tsince((t_unix - self.tle.epoch_unix) / 60.0)


# -- earth rotation: TEME -> ITRS --------------------------------------------

_OMEGA_EARTH = 7.29211514670698e-05  # rad/s, IAU-82


def gmst_rad(t_unix) -> np.ndarray:
    """Greenwich mean sidereal time (IAU 1982), radians, UT1 ~= UTC."""
    t_unix = np.atleast_1d(np.asarray(t_unix, dtype=np.float64))
    jd = t_unix / 86400.0 + 2440587.5
    t = (jd - 2451545.0) / 36525.0
    gmst_sec = (67310.54841
                + (876600.0 * 3600.0 + 8640184.812866) * t
                + 0.093104 * t ** 2
                - 6.2e-6 * t ** 3)
    return np.mod(gmst_sec, 86400.0) * (2.0 * np.pi / 86400.0)


def teme_to_itrs(r_teme: np.ndarray, t_unix,
                 v_teme: np.ndarray | None = None):
    """Rotate TEME vectors into ITRS (ECEF) by GMST about +z.

    ``r_teme``: (N, 3) km (any length unit). Velocity, when given, picks up
    the -omega x r earth-rotation term. Polar motion (<1 arcsec) is ignored.
    """
    r_teme = np.atleast_2d(np.asarray(r_teme, dtype=np.float64))
    theta = gmst_rad(t_unix)
    c, s = np.cos(theta), np.sin(theta)
    x = c * r_teme[:, 0] + s * r_teme[:, 1]
    y = -s * r_teme[:, 0] + c * r_teme[:, 1]
    r_itrs = np.stack([x, y, r_teme[:, 2]], axis=-1)
    if v_teme is None:
        return r_itrs
    v_teme = np.atleast_2d(np.asarray(v_teme, dtype=np.float64))
    vx = c * v_teme[:, 0] + s * v_teme[:, 1]
    vy = -s * v_teme[:, 0] + c * v_teme[:, 1]
    v_rot = np.stack([vx, vy, v_teme[:, 2]], axis=-1)
    omega = np.array([0.0, 0.0, _OMEGA_EARTH])
    v_itrs = v_rot - np.cross(np.broadcast_to(omega, r_itrs.shape), r_itrs)
    return r_itrs, v_itrs


# -- reference-parity wrapper surface ----------------------------------------

class NativeGeocentric:
    """Propagated TEME state + times; the native stand-in for skyfield's
    ``Geocentric`` as far as the reference wrapper surface uses it."""

    def __init__(self, r_teme_km: np.ndarray, v_teme_kms: np.ndarray,
                 t_unix: np.ndarray):
        self.r_teme_km = r_teme_km
        self.v_teme_kms = v_teme_kms
        self.t_unix = t_unix

    def itrs_m(self, return_velocity: bool = False):
        if return_velocity:
            r, v = teme_to_itrs(self.r_teme_km, self.t_unix, self.v_teme_kms)
            return r.T * 1e3, v.T * 1e3
        return teme_to_itrs(self.r_teme_km, self.t_unix).T * 1e3


class Satellite:
    """TLE-backed satellite with selectable gravity constants (reference
    Satellite, satelliteRoutines.py:28).

    Uses skyfield/sgp4 when importable (drop-in reference behavior),
    otherwise the native J2 backend. ``backend`` reports which one.
    """

    def __init__(self, line1: str, line2: str, name: str | None = None,
                 ts=None, const: GravityConstants = WGS72):
        self.name = name
        self.tle = parse_tle(line1, line2)
        self.const = const
        if _HAVE_SKYFIELD:  # pragma: no cover
            self.backend = "skyfield"
            sf_const = _SGP4_WGS72  # closest published mapping
            self._sf = EarthSatellite(line1, line2, name=name, ts=ts)
            self._sf.model = Satrec.twoline2rv(line1, line2, sf_const)
            self._sf._setup(self._sf.model)
        else:
            # round 5: deep-space TLEs run the native SDP4 terms inside
            # SGP4Propagator — no J2 fallback remains
            self._prop = SGP4Propagator(self.tle, const)
            self.backend = ("native-sdp4" if self._prop.deep
                            else "native-sgp4")

    def at_gpstime(self, gpstime):
        """Propagate to UTC-locked unix second(s); returns a Geocentric
        (skyfield) or NativeGeocentric state."""
        if self.backend == "skyfield":  # pragma: no cover
            return _sf_propagate(self._sf, gpstime)
        t = np.atleast_1d(np.asarray(gpstime, dtype=np.float64))
        r, v = self._prop.teme_posvel(t)
        return NativeGeocentric(r, v, t)


def _sf_propagate(satellite, gpstime):  # pragma: no cover
    ts = load.timescale()
    if isinstance(gpstime, float):
        dd = [_dt.datetime.fromtimestamp(gpstime, tz=_dt.timezone.utc)]
    elif hasattr(gpstime, "__iter__") and not isinstance(gpstime, str):
        dd = [_dt.datetime.fromtimestamp(t, tz=_dt.timezone.utc)
              for t in gpstime]
    else:
        raise TypeError("gpstime must be float or iterable")
    return satellite.at(ts.from_datetimes(dd))


def sf_propagate_satellite_to_gpstime(satellite, gpstime):
    """Propagate a satellite to UTC-locked GPS time(s) (reference
    satelliteRoutines.py:72). Accepts this module's Satellite (either
    backend) or a raw skyfield EarthSatellite."""
    if isinstance(satellite, Satellite):
        return satellite.at_gpstime(gpstime)
    if _HAVE_SKYFIELD:  # pragma: no cover
        return _sf_propagate(satellite, gpstime)
    raise TypeError("expected a Satellite (skyfield absent)")


def sf_geocentric_to_itrs(geocentric, return_velocity: bool = False):
    """Geocentric -> ITRS (ECEF) positions in metres, shaped (3, N)
    (reference satelliteRoutines.py:104)."""
    if isinstance(geocentric, NativeGeocentric):
        return geocentric.itrs_m(return_velocity)
    if _HAVE_SKYFIELD:  # pragma: no cover
        if return_velocity:
            r, v = geocentric.frame_xyz_and_velocity(_itrs)
            return r.m, v.m_per_s
        return geocentric.frame_xyz(_itrs).m
    raise TypeError("expected NativeGeocentric (skyfield absent)")
