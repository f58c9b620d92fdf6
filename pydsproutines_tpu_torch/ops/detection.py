"""Burst / energy detection.

PyTorch counterpart of ``pydsproutines_tpu/ops/detection.py``, with its
names and outputs. Data-dependent outputs (edge lists, peak lists) are
fixed-capacity int32 tensors plus a count, invalid slots -1, built on the
device without a host sync (prefix-sum compaction). ``BurstDetector.medfilt``
runs ``ops.filters.medfilt``, which takes the median-filter kernel for 1-D
float input on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.filters import medfilt
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import to_tensor


class Edges(NamedTuple):
    """Fixed-capacity [start, end) slice list. Only the first ``count`` rows
    are valid; invalid slots are -1."""
    starts: torch.Tensor   # (capacity,) int32
    ends: torch.Tensor     # (capacity,) int32, exclusive
    count: torch.Tensor    # scalar int32


def _scatter_first(values: torch.Tensor, keep: torch.Tensor, capacity: int,
                   fill: int) -> torch.Tensor:
    """values[keep] in order, in a (capacity,) int64 tensor padded with
    ``fill`` (jnp.nonzero(size=capacity, fill_value=fill) of the kept
    positions when ``values`` are the indices)."""
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < capacity), rank, capacity)
    buf = torch.full((capacity + 1,), fill, dtype=torch.int64,
                     device=values.device)
    buf.scatter_(0, slot, values.to(torch.int64))
    return buf[:capacity]


def threshold_edges(power: torch.Tensor, threshold, capacity: int,
                    min_length: int = 0, max_length: int = 2**31 - 1
                    ) -> Edges:
    """[start, end) runs where ``power > threshold``, with length limits, in
    ``capacity`` slots. A run still open at the end of the array closes at
    len(power); runs past ``capacity`` are dropped before the length filter;
    the surviving runs are compacted to the front in order."""
    above = power > threshold
    no = above.new_zeros(1)
    rising = above & ~torch.cat([no, above[:-1]])      # run starts at i
    falling = above & ~torch.cat([above[1:], no])      # run ends at i
    idx = torch.arange(above.shape[-1], device=power.device)
    starts = _scatter_first(idx, rising, capacity, -1)
    ends = _scatter_first(idx, falling, capacity, -2) + 1   # exclusive
    n_runs = rising.sum()
    lengths = ends - starts
    valid = ((torch.arange(capacity, device=power.device) < n_runs)
             & (lengths >= min_length) & (lengths <= max_length))
    starts_c = _scatter_first(starts, valid, capacity, -1)
    ends_c = _scatter_first(ends, valid, capacity, -1)
    return Edges(starts_c.to(torch.int32), ends_c.to(torch.int32),
                 valid.sum().to(torch.int32))


def find_local_maxima(x: torch.Tensor, height, max_peaks: int):
    """Indices of local maxima above ``height``. Returns (indices, count)
    with fixed capacity ``max_peaks``; invalid slots are -1."""
    inf = x.new_full((1,), -float("inf"))
    left = torch.cat([inf, x[:-1]])
    right = torch.cat([x[1:], inf])
    is_peak = (x > left) & (x > right) & (x > height)
    idx = torch.arange(x.shape[-1], device=x.device)
    return (_scatter_first(idx, is_peak, max_peaks, -1).to(torch.int32),
            is_peak.sum().to(torch.int32))


def histogram_counts(values: torch.Tensor, edges) -> np.ndarray:
    """numpy.histogram(values, bins=edges)[0] on the values' device: bins
    [e_i, e_i+1), the last closed on the right, values outside dropped.
    Compared in float64."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.float64),
                        device=values.device)
    v = values.reshape(-1).to(torch.float64)
    nb = e.shape[0] - 1
    i = torch.bucketize(v, e, right=True) - 1
    i = torch.where(v == e[-1], nb - 1, i)
    i = torch.where((i >= 0) & (i < nb), i, nb)
    return torch.bincount(i, minlength=nb + 1)[:nb].cpu().numpy()


def auto_detect_threshold(medfiltered: torch.Tensor, noise_levels,
                          multiplier: float = 1.0):
    """Histogram the median-filtered power over ``noise_levels`` bin edges
    and return the first bin edge that is a strict local minimum of the
    counts, scaled by ``multiplier``; None if there is none."""
    counts = histogram_counts(medfiltered, noise_levels)
    for i in range(1, counts.size - 1):
        if counts[i] < counts[i - 1] and counts[i] < counts[i + 1]:
            return float(noise_levels[i]) * multiplier
    return None


def kmeans2(x: torch.Tensor, seed_lo, seed_hi, iters: int = 20):
    """1-D 2-means: (codebook_lo, codebook_hi) after ``iters`` Lloyd
    iterations from the given seeds."""
    lo = torch.as_tensor(seed_lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(seed_hi, dtype=x.dtype, device=x.device)
    zero = x.new_zeros(())
    for _ in range(iters):
        assign_hi = (x - hi).abs() < (x - lo).abs()
        n_hi = assign_hi.sum().clamp(min=1)
        n_lo = (~assign_hi).sum().clamp(min=1)
        lo, hi = (torch.where(assign_hi, zero, x).sum() / n_lo,
                  torch.where(assign_hi, x, zero).sum() / n_hi)
    return lo, hi


def _seeds(x: torch.Tensor, ratio: float):
    """(lo, hi) seeds of detect_single_emitter: hi = max(x), lo = the
    smallest value below max/ratio (min(x) when there is none)."""
    hi = x.max()
    lo = torch.where(x < hi / ratio, x, float("inf")).min()
    return torch.where(torch.isinf(lo), x.min(), lo), hi


class BurstDetector:
    """Median-filter + threshold burst detector, fixed-capacity outputs.

    Typical use::

        bd = BurstDetector(medfiltlen=65)
        bd.medfilt(x)                       # |x|^2 -> median filter
        thr = bd.auto_detect_threshold(np.arange(0, 1, 1e-2))
        edges = bd.detect_via_threshold(thr, capacity=256, min_length=100)
    """

    def __init__(self, medfiltlen: int):
        if medfiltlen % 2 != 1:
            raise ValueError("medfiltlen must be odd")
        self.medfiltlen = int(medfiltlen)
        self.amp_sq = None
        self.medfiltered = None
        self.threshold = None

    @classmethod
    def from_numpy_params(cls, params: dict, device=None) -> "BurstDetector":
        """Carry a detector across from ``{"medfiltlen", "amp_sq",
        "medfiltered", "threshold"}``: numpy copies of a JAX
        ``BurstDetector``'s state (arrays may be None), placed on
        ``device`` (``cuda`` when None)."""
        device = resolve_device(device)
        bd = cls(int(params["medfiltlen"]))
        for name in ("amp_sq", "medfiltered"):
            a = params.get(name)
            if a is not None:
                setattr(bd, name, to_tensor(a, device))
        thr = params.get("threshold")
        bd.threshold = None if thr is None else float(np.asarray(thr))
        return bd

    def medfilt(self, x: torch.Tensor) -> torch.Tensor:
        """Compute |x|^2 and median filter it (no need to abs first)."""
        self.amp_sq = (x.real * x.real + x.imag * x.imag) if x.is_complex() \
            else x * x
        self.medfiltered = medfilt(self.amp_sq, self.medfiltlen)
        return self.medfiltered

    def detect_via_threshold(self, threshold, capacity: int = 256,
                             min_length: int = 0,
                             max_length: int = 2**31 - 1) -> Edges:
        self._require_medfilt()
        self.threshold = threshold
        return threshold_edges(self.medfiltered, threshold, capacity,
                               min_length, max_length)

    def auto_detect_threshold(self, noise_levels, multiplier: float = 1.0):
        self._require_medfilt()
        return auto_detect_threshold(self.medfiltered, noise_levels,
                                     multiplier)

    def detect_single_emitter(self, ratio: float = 4.0, capacity: int = 256,
                              min_length: int = 0,
                              max_length: int = 2**31 - 1) -> Edges:
        """2-means cluster of the filtered power; threshold = cluster-mean
        midpoint."""
        self._require_medfilt()
        x = self.medfiltered
        lo, hi = kmeans2(x, *_seeds(x, ratio))
        self.threshold = (lo + hi) / 2
        return threshold_edges(x, self.threshold, capacity, min_length,
                               max_length)

    def detect_regular_sections(self, section_size_range,
                                ratio: float = 1.5):
        """Estimate the period of a regularly bursting signal: for each
        candidate period P, fold the filtered power into rows of length P,
        average the columns and 2-means cluster the profile. Returns numpy
        (metric (S, 2) of [codebook gap, distortion], codebooks (S, 2)); the
        true period has the largest gap."""
        self._require_medfilt()
        sizes = np.asarray(section_size_range).astype(int)
        metric = np.zeros((sizes.size, 2))
        codebooks = np.zeros((sizes.size, 2))
        x = self.medfiltered
        n = int(x.shape[-1])
        for i, p in enumerate(sizes):
            prof = _fold_profile(x, int(p), n - n % int(p))
            lo, hi = kmeans2(prof, *_seeds(prof, ratio))
            dist = torch.minimum((prof - lo).abs(), (prof - hi).abs()).mean()
            codebooks[i] = (float(lo), float(hi))
            metric[i] = (float(hi - lo), float(dist))
        return metric, codebooks

    def _require_medfilt(self):
        if self.medfiltered is None:
            raise ValueError("Run medfilt() first.")


def _fold_profile(x: torch.Tensor, p: int, trunc: int) -> torch.Tensor:
    """Column means of x[:trunc] folded into rows of length p."""
    return x[:trunc].abs().reshape(-1, p).mean(0)


def energy_detection(amp_sq: torch.Tensor, medfiltlen: int,
                     snr_req_linear: float = 4.0, noise_indices=None,
                     capacity: int = 256):
    """Median filter the power, estimate the noise floor over
    ``noise_indices`` (default the first min(100000, n) samples) and return
    the runs above noise*snr_req_linear.

    Returns (mean_noise, req_power, medfiltered, edges)."""
    if noise_indices is None:
        noise_indices = torch.arange(min(100_000, amp_sq.shape[-1]),
                                     device=amp_sq.device)
    noise_indices = torch.as_tensor(noise_indices, device=amp_sq.device)
    filtered = medfilt(amp_sq, medfiltlen)
    mean_noise = filtered[noise_indices].mean()
    req_power = mean_noise * snr_req_linear
    edges = threshold_edges(filtered, req_power, capacity)
    return mean_noise, req_power, filtered, edges
