"""MUSIC / CAPON / ESPRIT subspace frequency estimation.

PyTorch counterpart of ``pydsproutines_tpu/ops/music.py`` (reference
musicRoutines.py: musicAlg :17, CovarianceTechnique :187, MUSIC :349,
CAPON :471, ESPRIT :500). The standalone estimators and ``music_xcorr`` are
host numpy in the JAX package too, and are copied here (the port never
imports that package). The throughput path, ``music_xcorr_device``, runs in
torch on the card: the shifted windows, the causal FIR of every shift in
one call of the upfirdn kernel (#5), the polyphase snapshot covariances,
forward-backward averaging, a batched ``torch.linalg.eigh`` (no TPU kernel
lies here: a library call is the port), and the pseudospectrum products;
only the final grids come back to the host. Every product runs under
``full_f32()``, never in TF32.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
import torch

from pydsproutines_tpu_torch.ops.filters import _conv_causal
from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.dtypes import (full_f32, real_dtype_for,
                                                  to_tensor)


def snapshot_matrix(x, rows: int, snapshot_jump: int | None = None) -> np.ndarray:
    """Arrange 1-d ``x`` (or a dict of 1-d arrays) into a (rows, cols)
    snapshot matrix (reference musicAlg matrix assembly, musicRoutines.py:66-118).

    snapshot_jump=None: disjoint columns via reshape. Otherwise columns are
    sliding windows advancing by ``snapshot_jump`` samples.
    """
    if isinstance(x, dict):
        mats = [snapshot_matrix(xi, rows, snapshot_jump) for xi in x.values()]
        return np.hstack(mats)
    x = np.asarray(x).flatten()
    if snapshot_jump is None:
        cols = len(x) // rows
        return x[: rows * cols].reshape(cols, rows).T
    if snapshot_jump <= 0:
        raise ValueError("snapshot_jump must be at least 1.")
    cols = (x.size - rows) // snapshot_jump + 1
    idx = np.arange(rows)[:, None] + snapshot_jump * np.arange(cols)[None, :]
    return x[idx]


def covariance(x, rows: int, snapshot_jump: int | None = None,
               fwd_bwd: bool = False, avg_to_toeplitz: bool = False,
               use_autocorr: bool = False) -> np.ndarray:
    """Covariance estimate with optional forward-backward correction,
    Toeplitz diagonal averaging, or the autocorrelation method (reference
    musicAlg, musicRoutines.py:55-135)."""
    if use_autocorr:
        x = np.asarray(x).flatten()
        autocorr = sps.correlate(x, x)
        import scipy.linalg as sla
        return sla.toeplitz(
            autocorr[len(x) - 1: len(x) - 1 + rows] / (len(x) - np.arange(rows)))

    xs = snapshot_matrix(x, rows, snapshot_jump)
    cols = xs.shape[1]
    rx = (1.0 / cols) * xs @ xs.conj().T
    if fwd_bwd:
        j = np.eye(rx.shape[0])[:, ::-1]
        rx = 0.5 * (rx + j @ rx.T @ j)
    if avg_to_toeplitz:
        rx_tp = np.zeros_like(rx)
        for k in range(-rx.shape[0] + 1, rx.shape[1]):
            d = np.mean(np.diag(rx, k))
            rx_tp += np.diag(np.full(rx.shape[0] - abs(k), d), k)
        rx = rx_tp
    return rx


def _pseudospectrum(u, s, freqlist, rows, p, use_signal_as_numerator):
    ehlist = np.exp(-2j * np.pi * np.asarray(freqlist).reshape(-1, 1)
                    * np.arange(rows))
    d = ehlist @ u[:, p:]
    denom = np.sum(np.abs(d) ** 2, axis=1)
    numerator = 1.0
    if use_signal_as_numerator:
        ssp = s[:p] ** -0.5
        siginv = u[:, :p] * ssp
        n = ehlist @ siginv
        numerator = np.sum(np.abs(n) ** 2, axis=1)
    return numerator / denom


def music_alg(x, freqlist, rows: int, plist, snapshot_jump=None,
              fwd_bwd: bool = False, use_signal_as_numerator: bool = False,
              avg_to_toeplitz: bool = False, use_autocorr: bool = False):
    """MUSIC pseudospectrum over ``freqlist`` (normalized to [-1, 1]) for each
    signal-subspace dimension in ``plist`` (reference musicAlg,
    musicRoutines.py:17). Returns (f, u, s, vh)."""
    freqlist = np.asarray(freqlist)
    if not np.all(np.abs(freqlist) <= 1.0):
        raise ValueError("Frequency list input must be normalized.")
    rx = covariance(x, rows, snapshot_jump, fwd_bwd, avg_to_toeplitz,
                    use_autocorr)
    u, s, vh = np.linalg.svd(rx)
    if not hasattr(plist, "__len__"):
        f = _pseudospectrum(u, s, freqlist, rows, int(plist),
                            use_signal_as_numerator)
    else:
        f = np.stack([
            _pseudospectrum(u, s, freqlist, rows, int(p),
                            use_signal_as_numerator) for p in plist])
    return f, u, s, vh


class CovarianceTechnique:
    """Base class holding covariance options + optional prewhitening
    (reference CovarianceTechnique, musicRoutines.py:187)."""

    def __init__(self, rows: int, snapshot_jump=None, fwd_bwd: bool = False,
                 avg_to_toeplitz: bool = False):
        self.rows = int(rows)
        self.snapshot_jump = snapshot_jump
        self.fwd_bwd = fwd_bwd
        self.avg_to_toeplitz = avg_to_toeplitz
        self.L = None  # prewhitening matrix (lower-triangular cholesky)

    def set_prewhitening_matrix(self, L: np.ndarray):
        self.L = np.asarray(L)

    def est_prewhitening_matrix(self, noise: np.ndarray):
        """Estimate the prewhitener as the Cholesky factor of the noise
        covariance."""
        rn = covariance(noise, self.rows, self.snapshot_jump)
        self.L = np.linalg.cholesky(rn)
        return self.L

    def calc_rx(self, x) -> np.ndarray:
        return covariance(x, self.rows, self.snapshot_jump, self.fwd_bwd,
                          self.avg_to_toeplitz)


class MUSIC(CovarianceTechnique):
    """MUSIC estimator class (reference MUSIC, musicRoutines.py:349)."""

    def run(self, x, freqlist, plist, use_signal_as_numerator: bool = False,
            prewhiten: bool = False):
        rx = self.calc_rx(x)
        if prewhiten:
            if self.L is None:
                raise ValueError("Set the prewhitening matrix first.")
            linv = np.linalg.inv(self.L)
            rx = linv @ rx @ linv.conj().T
        u, s, vh = np.linalg.svd(rx)
        if not hasattr(plist, "__len__"):
            f = _pseudospectrum(u, s, freqlist, self.rows, int(plist),
                                use_signal_as_numerator)
        else:
            f = np.stack([
                _pseudospectrum(u, s, freqlist, self.rows, int(p),
                                use_signal_as_numerator) for p in plist])
        return f, u, s, vh, rx

    @staticmethod
    def pick_peaks(f, p: int, height: float = 0):
        """Top-p peaks of the pseudospectrum (reference pickPeaks,
        musicRoutines.py:451)."""
        peakinds, props = sps.find_peaks(np.asarray(f), height=height)
        ph = props["peak_heights"]
        order = np.argsort(ph)[::-1]
        peakinds, ph = peakinds[order], ph[order]
        return peakinds[:p], ph[:p]


class CAPON(CovarianceTechnique):
    """Capon / MVDR spectrum (reference CAPON, musicRoutines.py:471)."""

    def run(self, x, freqlist):
        rx = self.calc_rx(x)
        inv_rx = np.linalg.inv(rx)
        freqlist = np.asarray(freqlist)
        eh = np.exp(-2j * np.pi * freqlist[:, None] * np.arange(self.rows))
        # f[i] = 1 / (eh_i inv_rx eh_i^H) — batched quadratic form
        denom = np.einsum("ij,jk,ik->i", eh, inv_rx, eh.conj())
        return 1.0 / denom, rx


class ESPRIT(CovarianceTechnique):
    """ESPRIT frequency estimates (reference ESPRIT, musicRoutines.py:500)."""

    def run(self, x, p: int, fs: float):
        rx = self.calc_rx(x)
        u, s, vh = np.linalg.svd(rx)
        sig_u = u[:, :p]
        phi, *_ = np.linalg.lstsq(sig_u[: self.rows - 1], sig_u[1:],
                                  rcond=None)
        w, v = np.linalg.eig(phi)
        freqs = np.angle(w) / (2 * np.pi) * fs
        return freqs, u, s, vh, rx


def music_xcorr(cutout, rx, f_search, ftap, fs: float, dsr: int, plist,
                musicrows: int = 130, shifts=None):
    """MUSIC-based xcorr: per shift, filter + polyphase-downsample the
    rx*conj(cutout) product and run MUSIC over all downsample phases as
    snapshots (reference musicXcorr, xcorrRoutines.py:378).

    Returns {p: (num_shifts, len(f_search)) pseudospectrum grid}.
    """
    cutout = np.asarray(cutout)
    rx = np.asarray(rx)
    ftap = np.asarray(ftap)
    cutoutconj = cutout.conj()
    music = MUSIC(musicrows, snapshot_jump=1, fwd_bwd=True)
    fs_ds = fs / dsr
    if shifts is None:
        shifts = np.arange(len(rx) - len(cutout) + 1)
    plist = np.atleast_1d(plist)
    resultsgrid = {int(p): np.zeros((len(shifts), len(f_search)))
                   for p in plist}
    f_search = np.asarray(f_search)
    for i, s in enumerate(shifts):
        pdt = rx[s: s + len(cutout)] * cutoutconj
        pdtfilt = sps.lfilter(ftap, 1, pdt)
        phases = {k: pdtfilt[len(ftap) // 2 + k:: dsr] for k in range(dsr)}
        f, u, sv, vh, rxcov = music.run(phases, f_search / fs_ds, plist,
                                        use_signal_as_numerator=True)
        f = np.atleast_2d(f)
        for k, p in enumerate(plist):
            resultsgrid[int(p)][i, :] = f[k]
    return resultsgrid


def _device_covs(cutout_conj: torch.Tensor, rx: torch.Tensor,
                 shifts: torch.Tensor, ftap: torch.Tensor, dsr: int,
                 rows: int, fwd_bwd: bool = True) -> torch.Tensor:
    """(num_shifts, rows, rows) snapshot covariances of music_xcorr, every
    shift at once on the device of ``rx``: modulate by the conjugate
    cutout, causal FIR (scipy lfilter semantics, one ``_conv_causal`` call
    for all shifts), the ``dsr`` polyphase streams y_k = filt[taps//2 + k ::
    dsr], and C = sum_k sum_j w_kj w_kj^H / (dsr * cols) over the sliding
    windows w_kj = y_k[j : j + rows] (the JAX package's
    ``_device_cov_fn``), then forward-backward averaging."""
    n = cutout_conj.shape[-1]
    start = ftap.shape[-1] // 2
    if (n - start) % dsr:
        raise ValueError(f"(len(cutout) - len(ftap)//2) = {n - start} is not "
                         f"a multiple of dsr = {dsr}: the polyphase streams "
                         f"would differ in length")
    avail = (n - start) // dsr
    cols = avail - rows + 1
    if cols < 1:
        raise ValueError(f"{avail} samples a phase cannot fill {rows} rows")
    dev = rx.device
    win = rx[shifts[:, None] + torch.arange(n, device=dev)]
    filt = _conv_causal(ftap, win * cutout_conj)
    y = filt[:, start:].reshape(-1, avail, dsr).transpose(1, 2)
    idx = torch.arange(rows, device=dev)[:, None] + torch.arange(
        cols, device=dev)
    snaps = y[:, :, idx].permute(0, 2, 1, 3).reshape(
        -1, rows, dsr * cols)                      # (S, rows, dsr * cols)
    with full_f32():
        c = snaps @ snaps.conj().transpose(1, 2) / (dsr * cols)
    if fwd_bwd:
        c = 0.5 * (c + torch.flip(c, (1, 2)).transpose(1, 2))
    return c


def _device_music_grids(covs: torch.Tensor, f_norm, plist,
                        use_signal_as_numerator: bool) -> torch.Tensor:
    """(len(plist), num_shifts, len(f_norm)) pseudospectra of the
    covariances on their device (the JAX package's
    ``_device_music_grid_fn``): a batched Hermitian ``eigh``, its ascending
    eigenpairs reversed to the SVD's descending order (the pseudospectrum
    depends only on the two subspace projectors, which are basis
    invariant), then the Vandermonde products in full f32, the steering
    vectors formed from float64 phases and rounded once."""
    rows = covs.shape[-1]
    eh = np.exp(-2j * np.pi * np.asarray(f_norm).reshape(-1, 1)
                * np.arange(rows))
    eh = torch.from_numpy(eh).to(covs.device, covs.dtype)
    with full_f32():
        w, v = torch.linalg.eigh(covs)
        w_desc, v_desc = w.flip(-1), v.flip(-1)
        grids = []
        for p in plist:
            d = eh @ v_desc[:, :, p:]                  # (S, F, rows - p)
            denom = torch.sum(torch.abs(d) ** 2, dim=-1)
            if use_signal_as_numerator:
                ssp = w_desc[:, :p] ** -0.5            # (S, p)
                num = (eh @ v_desc[:, :, :p]) * ssp[:, None, :].to(d.dtype)
                grids.append(torch.sum(torch.abs(num) ** 2, dim=-1) / denom)
            else:
                grids.append(1.0 / denom)
    return torch.stack(grids)


def music_xcorr_device(cutout, rx, f_search, ftap, fs: float, dsr: int,
                       plist, musicrows: int = 130, shifts=None,
                       use_signal_as_numerator: bool = True,
                       eig_on_device: bool = True, device=None):
    """music_xcorr with everything on the device: modulate, FIR, polyphase
    downsample, snapshot covariance, batched Hermitian eig, and the
    Vandermonde pseudospectrum products; only the final (num_shifts,
    len(f_search)) grids come back to the host. Matches music_xcorr's
    output grid. ``len(cutout) - len(ftap)//2`` must be a multiple of
    ``dsr`` (raises otherwise).

    ``rx`` as a tensor stays on its device; as an array it goes to
    ``device`` (the card when None); the cutout, taps and shifts follow it.
    The FIR of every shift is one upfirdn kernel (#5) launch on the card.
    ``eig_on_device=False`` takes the covariances to the host and runs
    np.linalg.svd a shift (the parity oracle).

    Returns {p: (num_shifts, len(f_search)) numpy grid}.

    Reference: musicXcorr (xcorrRoutines.py:378), which loops shifts in
    python and filters with scipy per shift.
    """
    rx = place(rx, device)
    cutout = to_tensor(cutout, rx.device)
    cdt = torch.promote_types(rx.dtype, cutout.dtype)
    rx, cutout = rx.to(cdt), cutout.to(cdt)
    ftap = to_tensor(ftap, rx.device).to(real_dtype_for(cdt))
    if shifts is None:
        shifts = np.arange(rx.shape[-1] - cutout.shape[-1] + 1)
    shifts = to_tensor(shifts, rx.device).to(torch.int64)
    plist = [int(p) for p in np.atleast_1d(plist)]
    f_norm = np.asarray(f_search) / (fs / dsr)

    covs = _device_covs(cutout.conj().resolve_conj(), rx, shifts, ftap,
                        int(dsr), int(musicrows))
    if eig_on_device:
        grids = _device_music_grids(covs, f_norm, plist,
                                    use_signal_as_numerator).cpu().numpy()
        return {p: grids[k] for k, p in enumerate(plist)}

    covs = covs.cpu().numpy()
    resultsgrid = {p: np.zeros((len(shifts), len(f_norm))) for p in plist}
    for i in range(len(shifts)):
        u, s, vh = np.linalg.svd(covs[i])
        for p in plist:
            resultsgrid[p][i, :] = _pseudospectrum(
                u, s, f_norm, int(musicrows), p, use_signal_as_numerator)
    return resultsgrid
