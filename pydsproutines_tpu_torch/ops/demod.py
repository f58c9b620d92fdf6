"""PSK and CPFSK demodulation (reference demodulationRoutines: getEyeOpening,
lockPhase, mapSyms, ambleRotate, symsToBits, detect_B_or_Q, demodBatch,
demodulateCP2FSK, BurstyDemodulatorCP2FSK, ML_demod_QPSK).

PyTorch counterpart of ``pydsproutines_tpu/ops/demod.py``. The phase lock
uses the closed-form 2x2 symmetric eigen-decomposition in place of an SVD,
as the JAX package and the reference's own CUDA kernel do. No stage runs a
hand-written kernel: every one is a handful of elementwise and reduction
ops, so each follows its input's device.

Where the JAX package writes a table lookup as a chain of selects (a gather
is a scalar loop on the TPU), the port indexes an m-entry tensor; where it
stacks static slices or takes a one-hot over (shift, amble, m), the port
takes the windows with ``unfold`` and counts rotations with ``scatter_add``.
The batch chain keeps the natural (bursts, symbols, osr) layout.

Classes that hold tensors (the bitmaps) take ``device`` through
:func:`resolve_device`: ``cuda`` unless told otherwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for, to_tensor

# Constellations: monotonically increasing angle index (reference pskdicts).
_SQ2 = np.sqrt(2.0) / 2.0
PSK_CONSTS = {
    2: np.array([1.0, -1.0], dtype=np.complex128),
    4: np.array([1.0, 1.0j, -1.0, -1.0j], dtype=np.complex128),
    8: np.array([1.0, _SQ2 * (1 + 1j), 1.0j, _SQ2 * (-1 + 1j),
                 -1.0, _SQ2 * (-1 - 1j), -1.0j, _SQ2 * (1 - 1j)],
                dtype=np.complex128),
}
# Gray bit mapping per increasing angle index (reference pskbitmaps).
PSK_BITMAPS = {
    2: np.array([0b1, 0b0], dtype=np.uint8),
    4: np.array([0b11, 0b01, 0b00, 0b10], dtype=np.uint8),
    8: np.array([0b000, 0b001, 0b011, 0b010, 0b110, 0b111, 0b101, 0b100],
                dtype=np.uint8),
}

# QPSK comparator gray table [[2, 1], [3, 0]] indexed [x > 0][y > 0]
_GRAY4 = np.array([2, 1, 3, 0], dtype=np.uint8)
# 8PSK comparator table indexed [c1z][idx1][idx2] (reference mapSyms, :540)
_MAP8 = np.zeros((2, 2, 2), dtype=np.uint8)
_MAP8[1, 1, 1] = 0; _MAP8[0, 1, 1] = 1; _MAP8[1, 0, 1] = 2; _MAP8[0, 0, 1] = 3
_MAP8[1, 1, 0] = 4; _MAP8[0, 0, 0] = 5; _MAP8[1, 0, 0] = 6; _MAP8[0, 1, 0] = 7


def _table(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A small host table as a tensor on ``like``'s device."""
    return torch.as_tensor(values, device=like.device)


# ---------------------------------------------------------------------------
# Stage functions: plain functions on tensors, on their inputs' device
# ---------------------------------------------------------------------------

def get_eye_opening(x: torch.Tensor, osr: int):
    """Best sampling phase by maximum mean |x| over OSR phases. Returns
    (resampled syms, phase index, metric)."""
    x_rs = x.reshape(-1, osr)
    metric = torch.mean(torch.abs(x_rs), dim=0)
    i = torch.argmax(metric)
    return x_rs[:, i], i, metric


def _sym_eig2(a, b, c):
    """Eigen-decomposition of [[a, b], [b, c]]: returns (lam_max, lam_min,
    angle of principal eigenvector)."""
    tr = a + c
    half_diff = (a - c) / 2
    root = torch.sqrt(half_diff * half_diff + b * b)
    theta = 0.5 * torch.atan2(2 * b, a - c)
    return tr / 2 + root, tr / 2 - root, theta


def _int_power(x: torch.Tensor, p: int) -> torch.Tensor:
    """x ** p by repeated products (the JAX package's integer_pow)."""
    out = x
    for _ in range(p - 1):
        out = out * x
    return out


def _rotate(x: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """x * exp(1j * phase), the exponential formed from the real phase."""
    return x * torch.polar(torch.ones_like(phase), phase)


def lock_phase(reim: torch.Tensor, m: int):
    """Blind phase lock: raise to the m/2 power (fold to BPSK), form the 2x2
    real self-product, take the principal eigenvector angle. Returns
    (corrected, svd_metric, angle)."""
    powerup = m // 2
    reimp = _int_power(reim, powerup)
    re, im = reimp.real, reimp.imag
    lam_max, lam_min, theta = _sym_eig2(torch.sum(re * re), torch.sum(re * im),
                                        torch.sum(im * im))
    return _rotate(reim, -theta / powerup), lam_min / lam_max, theta


def map_syms(reimc: torch.Tensor, m: int) -> torch.Tensor:
    """Map phase-locked samples to symbol indices 0..m-1 by max dot product
    with the constellation vectors. Returns uint8."""
    const = torch.as_tensor(PSK_CONSTS[m], device=reimc.device).to(reimc.dtype)
    metric = (reimc.real[:, None] * const.real[None, :]
              + reimc.imag[:, None] * const.imag[None, :])
    return torch.argmax(metric, dim=-1).to(torch.uint8)


def map_syms_bpsk(reimc: torch.Tensor) -> torch.Tensor:
    """BPSK mapping: sign of the real part (reference
    SimpleDemodulatorBPSK.mapSyms)."""
    return (reimc.real < 0).to(torch.uint8)


def map_syms_qpsk(reimc: torch.Tensor) -> torch.Tensor:
    """QPSK quadrant-gray mapping (reference SimpleDemodulatorQPSK.mapSyms)
    of a constellation rotated into the 'box' (correctPhase adds pi/4)."""
    lin = (reimc.real > 0).long() * 2 + (reimc.imag > 0).long()
    return _table(_GRAY4, reimc)[lin]


def map_syms_8psk(reimc: torch.Tensor, eo_scaling) -> torch.Tensor:
    """8PSK 3-comparator mapping (reference SimpleDemodulator8PSK.mapSyms).
    ``eo_scaling`` is the max eye-opening metric (amplitude scale): a
    number, or a tensor that broadcasts against ``reimc`` (one per row)."""
    x, y = reimc.real, reimc.imag
    eo = torch.as_tensor(eo_scaling, dtype=x.dtype, device=x.device)
    thresh = torch.abs(torch.abs(math.cos(np.pi / 8) * eo)
                       - torch.abs(math.sin(np.pi / 8) * eo))
    xmy = torch.abs(x) - torch.abs(y)
    c1z = (torch.abs(xmy) - thresh) > 0
    cx2, cy2, cxmy2 = x > 0, y > 0, xmy > 0
    cx3 = cxmy2 & cx2
    cy3 = ~cxmy2 & cy2
    idx1 = (c1z & cxmy2) | (~c1z & cx2)
    idx2 = (c1z & (cx3 | cy3)) | (~c1z & cy2)
    lin = c1z.long() * 4 + idx1.long() * 2 + idx2.long()
    return _table(_MAP8.reshape(-1), reimc)[lin]


def _rotation_counts(windows: torch.Tensor, amble: torch.Tensor,
                     m: int) -> torch.Tensor:
    """counts[..., r] = #{a: (windows[..., a] + r) mod m == amble[a]}, the
    preamble matches of each constellation rotation r. ``windows`` (...,
    L) int64, ``amble`` (L,). Returns (..., m) int32."""
    diff = torch.remainder(amble.long() - windows, m)
    counts = torch.zeros(windows.shape[:-1] + (m,), dtype=torch.int32,
                         device=windows.device)
    return counts.scatter_add_(-1, diff, torch.ones_like(diff,
                                                         dtype=torch.int32))


def compare_int_preambles(amble: torch.Tensor, syms: torch.Tensor, m: int,
                          search_start: int, search_len: int,
                          amble_len: int) -> torch.Tensor:
    """Count preamble matches per (shift, rotation): matches[i, (p-s) % m]
    += 1 (reference compareIntPreambles). Returns (search_len, m) int32
    (the JAX package returns uint32)."""
    stop = search_start + search_len + amble_len - 1
    if search_start < 0 or stop > syms.shape[-1]:
        last = search_start + search_len - 1
        raise ValueError(f"shifts {search_start}..{last} with an amble of "
                         f"{amble_len} run past "
                         f"{syms.shape[-1]} symbols")
    windows = syms[search_start: stop].long().unfold(0, amble_len, 1)
    return _rotation_counts(windows, amble.to(syms.device)[:amble_len], m)


def syms_to_bits(syms: torch.Tensor, m: int, bitmap=None,
                 phase_sym_shift: int = 0) -> torch.Tensor:
    """Map symbol indices to bit values via the (rolled) bitmap (reference
    symsToBits)."""
    bm = PSK_BITMAPS[m] if bitmap is None else bitmap
    bm = torch.roll(to_tensor(bm, syms.device), int(phase_sym_shift))
    return bm[syms.long()]


def unpack_to_binary_bytes(packed: np.ndarray, m: int) -> np.ndarray:
    """One byte per bit expansion of symbol bit values (reference
    unpackToBinaryBytes). Host-side numpy."""
    bits_per_val = int(np.log2(m))
    unpacked = np.unpackbits(np.asarray(packed, dtype=np.uint8)).reshape(-1, 8)
    return unpacked[:, -bits_per_val:]


def pack_binary_bytes_to_bits(unpacked: np.ndarray) -> np.ndarray:
    """np.packbits over the flattened unpacked matrix (reference
    packBinaryBytesToBits)."""
    return np.packbits(np.asarray(unpacked).reshape(-1))


def find_plain_text(syms, m: int, bitmap=None, phase_sym_shift: int = 0):
    """Search symbol alignments for the most readable UTF-8 characters
    (reference findPlainText). Host-side: ``syms`` goes to numpy."""
    syms = syms.cpu().numpy() if isinstance(syms, torch.Tensor) \
        else np.asarray(syms)
    symbol_skips = np.arange(np.lcm(m, 8), dtype=np.uint32)
    utf8chars = np.zeros(symbol_skips.size, dtype=np.uint32)
    for i, skip in enumerate(symbol_skips):
        mapped = syms_to_bits(torch.from_numpy(syms[skip:].copy()), m, bitmap,
                              phase_sym_shift).numpy()
        packed = pack_binary_bytes_to_bits(unpack_to_binary_bytes(mapped, m))
        utf8chars[i] = np.count_nonzero((packed >= 0x21) & (packed <= 0x7E))
    return int(np.argmax(utf8chars)), utf8chars


def detect_b_or_q(reim: torch.Tensor, threshold: float = 0.5):
    """BPSK-vs-QPSK classification via the 2x2 self-product eigenvalue ratio
    (reference detect_B_or_Q). Row-wise for 2-D input. Returns (m: 2 or 4
    as uint8, ratio)."""
    reim2 = reim if reim.dim() >= 2 else reim.reshape(1, -1)
    re, im = reim2.real, reim2.imag
    lam_max, lam_min, _ = _sym_eig2(torch.sum(re * re, dim=-1),
                                    torch.sum(re * im, dim=-1),
                                    torch.sum(im * im, dim=-1))
    ratio = lam_min / lam_max
    m = torch.where(ratio < threshold, 2, 4).to(torch.uint8)
    return m, ratio


# ---------------------------------------------------------------------------
# Demodulator classes (reference-compatible workflow)
# ---------------------------------------------------------------------------

def _own_bitmap(m: int, bitmap, device) -> torch.Tensor:
    """A demodulator's own copy of its bitmap (PSK_BITMAPS[m] by default)
    on ``device``: never a view of the shared table or the caller's array."""
    return to_tensor(PSK_BITMAPS[m] if bitmap is None else bitmap,
                     device).clone()


def _check_device(x: torch.Tensor, device: torch.device, what: str) -> None:
    if x.device != device:
        raise ValueError(f"{what} on {x.device}, demodulator on {device}")


class SimpleDemodulatorPSK:
    """Generic BPSK/QPSK/8PSK demodulator: eye-opening -> blind phase lock ->
    constellation mapping (reference SimpleDemodulatorPSK). Its bitmap lives
    on ``device`` (``cuda`` when None); its inputs must too."""

    def __init__(self, m: int, bitmap=None, cluster_threshold: float = 0.1,
                 device=None):
        self.m = int(m)
        self.device = resolve_device(device)
        self.bitmap = _own_bitmap(self.m, bitmap, self.device)
        self.cluster_threshold = cluster_threshold
        # interim outputs (reference attribute parity)
        self.xeo = None
        self.xeo_i = None
        self.eo_metric = None
        self.reimc = None
        self.svd_metric = None
        self.angleCorrection = None
        self.syms = None
        self.matches = None

    @classmethod
    def from_numpy_params(cls, params: dict, device=None):
        """Carry a demodulator across from a JAX instance's attributes
        (``m`` for the generic class, ``bitmap``, ``cluster_threshold``)."""
        kw = {"bitmap": params.get("bitmap"),
              "cluster_threshold": params.get("cluster_threshold", 0.1),
              "device": device}
        if cls is SimpleDemodulatorPSK:
            return cls(int(params["m"]), **kw)
        return cls(**kw)

    # subclass hooks -------------------------------------------------------
    def _correct_phase(self, reim, phase):
        return _rotate(reim, phase)

    def _map(self, reimc):
        return map_syms(reimc, self.m)

    # main chain -----------------------------------------------------------
    def demod(self, x: torch.Tensor, osr: int):
        _check_device(x, self.device, "x")
        self.xeo, self.xeo_i, self.eo_metric = get_eye_opening(x, osr)
        _, self.svd_metric, theta = lock_phase(self.xeo, self.m)
        self.angleCorrection = theta
        self.reimc = self._correct_phase(self.xeo, -theta / (self.m // 2))
        self.syms = self._map(self.reimc)
        return self.syms

    def amble_rotate(self, amble, search=None, syms=None):
        """Preamble search over shifts and constellation rotations (reference
        ambleRotate). Returns (rotated syms, sample index, rotation, best
        match count); ties go to the first (shift, rotation) in row-major
        order, as in the JAX package."""
        syms = self.syms if syms is None else syms
        amble = to_tensor(amble, syms.device)
        if search is None:
            start, length = 0, syms.shape[-1] - amble.shape[-1] + 1
        else:
            search = np.asarray(search)
            start, length = int(search[0]), int(search[-1] - search[0] + 1)
        self.matches = compare_int_preambles(
            amble, syms, self.m, start, length, amble.shape[-1])
        flat = torch.argmax(self.matches)
        s, rotation = flat // self.m, flat % self.m
        rotated = torch.remainder(syms.long() + rotation, self.m).to(
            torch.uint8)
        return rotated, start + s, rotation, self.matches[s, rotation]

    def syms_to_bits(self, syms=None, phase_sym_shift: int = 0):
        syms = self.syms if syms is None else syms
        return syms_to_bits(syms, self.m, self.bitmap, phase_sym_shift)


class SimpleDemodulatorBPSK(SimpleDemodulatorPSK):
    """Specialized BPSK (reference SimpleDemodulatorBPSK)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1,
                 device=None):
        super().__init__(2, bitmap, cluster_threshold, device)

    def _map(self, reimc):
        return map_syms_bpsk(reimc)


class SimpleDemodulatorQPSK(SimpleDemodulatorPSK):
    """Specialized QPSK with quadrant-gray comparators (reference
    SimpleDemodulatorQPSK)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1,
                 device=None):
        super().__init__(4, bitmap, cluster_threshold, device)

    def _correct_phase(self, reim, phase):
        # rotate into the comparator 'box' (reference correctPhase adds pi/4)
        return _rotate(reim, phase + np.pi / 4)

    def _map(self, reimc):
        return map_syms_qpsk(reimc)


class SimpleDemodulator8PSK(SimpleDemodulatorPSK):
    """Specialized 8PSK 3-comparator demodulator (reference
    SimpleDemodulator8PSK)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1,
                 device=None):
        super().__init__(8, bitmap, cluster_threshold, device)

    def _map(self, reimc):
        return map_syms_8psk(reimc, torch.max(self.eo_metric))


# ---------------------------------------------------------------------------
# Burst-batched PSK demod chain
# ---------------------------------------------------------------------------

class BatchDemodResult(NamedTuple):
    """Outputs of the burst-batched PSK chain (the reference's demodBatch
    output tuple)."""
    reimc: torch.Tensor          # (B, nsym) phase-locked constellation
    syms: torch.Tensor           # (B, nsym) uint8 mapped symbols, unrotated
    eo_idx: torch.Tensor         # (B,) eye-opening phase per burst
    eo_metric: torch.Tensor      # (B, osr)
    svd_metric: torch.Tensor     # (B,) phase-lock cluster quality
    theta: torch.Tensor          # (B,) phase-lock angle
    best_matches: torch.Tensor   # (B,) best preamble match count
    best_rotations: torch.Tensor  # (B,) winning constellation rotation
    best_idx: torch.Tensor       # (B,) winning preamble start (symbol index)
    rotated_syms: torch.Tensor   # (B, nsym) rotation-corrected symbols
    bits: torch.Tensor           # (B, num_out_syms*bps) unpacked payload bits
    bit_counts: torch.Tensor     # (B,) valid symbols written per burst


def _psk_demod_batch_impl(xbatch, lengths, amble, bitmap, *, m, osr,
                          search_start, search_len, amble_len, num_out_syms,
                          variant) -> BatchDemodResult:
    """The whole burst-batched chain: masked eye-opening -> masked 2x2-eig
    phase lock -> constellation map -> preamble shift/rotation search ->
    payload cut + rotate + bit unpack through ``bitmap``. Every stage runs
    on all bursts at once; samples at or past a burst's ``lengths`` entry
    take no part."""
    B = xbatch.shape[0]
    nsym = xbatch.shape[1] // osr
    dev = xbatch.device
    xs = xbatch[:, : nsym * osr].reshape(B, nsym, osr)
    pos = (torch.arange(nsym, device=dev)[:, None] * osr
           + torch.arange(osr, device=dev)[None, :])             # (nsym, osr)
    mask = pos[None] < lengths[:, None, None]               # (B, nsym, osr)

    # -- eye opening (masked mean |x| per phase) ------------------------------
    counts = mask.sum(dim=1).to(real_dtype_for(xbatch.dtype))    # (B, osr)
    eo_metric = (torch.abs(xs) * mask).sum(dim=1) / counts.clamp(min=1)
    eo_idx = torch.argmax(eo_metric, dim=-1)                     # (B,)
    pick = eo_idx[:, None, None].expand(B, nsym, 1)
    xeo = torch.gather(xs, 2, pick)[..., 0]                      # (B, nsym)
    symmask = torch.gather(mask, 2, pick)[..., 0]                # (B, nsym)
    nsym_valid = symmask.sum(dim=1)                              # (B,)

    # -- blind phase lock (masked 2x2 self-product, closed-form eig) ----------
    powerup = m // 2
    reimp = _int_power(torch.where(symmask, xeo, 0), powerup)
    re, im = reimp.real, reimp.imag
    lam_max, lam_min, theta = _sym_eig2(re.mul(re).sum(1), re.mul(im).sum(1),
                                        im.mul(im).sum(1))
    svd_metric = lam_min / lam_max.clamp(min=torch.finfo(lam_max.dtype).tiny)
    box = np.pi / 4 if variant == "qpsk" else 0.0
    reimc = _rotate(xeo, (-theta / powerup + box)[:, None])

    # -- constellation mapping ----------------------------------------------
    if variant == "bpsk":
        syms = map_syms_bpsk(reimc)
    elif variant == "qpsk":
        syms = map_syms_qpsk(reimc)
    elif variant == "8psk":
        syms = map_syms_8psk(reimc, eo_metric.amax(dim=1, keepdim=True))
    else:
        syms = map_syms(reimc.reshape(-1), m).reshape(B, nsym)

    # -- preamble shift x rotation search (all bursts) ------------------------
    stop = search_start + search_len + amble_len - 1
    windows = syms[:, search_start: stop].long().unfold(1, amble_len, 1)
    matches = _rotation_counts(windows, amble, m)                # (B, S, m)
    shifts = search_start + torch.arange(search_len, device=dev)
    # shifts whose amble window runs past the burst's valid symbols lose
    valid_shift = (shifts[None, :] + amble_len) <= nsym_valid[:, None]
    matches = torch.where(valid_shift[:, :, None], matches, -1)
    flat = torch.argmax(matches.reshape(B, -1), dim=1)
    best_matches = torch.gather(matches.reshape(B, -1), 1, flat[:, None])[:, 0]
    best_rotations = flat % m
    best_idx = search_start + flat // m
    rotated = torch.remainder(syms.long() + best_rotations[:, None], m)

    # -- payload cut + bit unpack (reference cutAndRotateFromPreambles) -------
    out_pos = (best_idx[:, None] + amble_len
               + torch.arange(num_out_syms, device=dev)[None, :])
    in_range = out_pos < nsym_valid[:, None]
    # zero right padding keeps every cut in bounds; in_range masks it
    gathered = torch.gather(
        torch.nn.functional.pad(rotated, (0, num_out_syms)), 1, out_pos)
    gathered = torch.where(in_range, gathered, 0)
    bps = int(np.log2(m))
    bitvals = bitmap.long()[gathered]
    shifts_b = torch.arange(bps - 1, -1, -1, device=dev)
    bits = ((bitvals[:, :, None] >> shifts_b) & 1).reshape(B, -1)
    bits = torch.where(in_range.repeat_interleave(bps, dim=1), bits, 0)

    i32 = torch.int32
    return BatchDemodResult(
        reimc=reimc, syms=syms, eo_idx=eo_idx.to(i32), eo_metric=eo_metric,
        svd_metric=svd_metric, theta=theta, best_matches=best_matches,
        best_rotations=best_rotations.to(i32), best_idx=best_idx.to(i32),
        rotated_syms=rotated.to(torch.uint8), bits=bits.to(torch.uint8),
        bit_counts=in_range.sum(dim=1).to(i32))


class DemodulatorBatchPSK:
    """Burst-batched PSK demodulator: the full eye-opening -> phase-lock ->
    map -> preamble-search -> bit-cut chain over a (bursts, maxlen) matrix
    with per-burst lengths (reference CupyDemodulatorQPSK.demodBatch /
    getEyeOpeningBatch / cutAndRotateFromPreambles).

    ``variant`` picks the specialized mapping ("bpsk"/"qpsk"/"8psk"), default
    the generic dot-product map. Symbol/rotation conventions match
    ``SimpleDemodulatorPSK`` exactly, so row b of the result equals the
    single-burst chain run on ``xbatch[b, :lengths[b]]``.

    Divergence from the JAX package: the payload bits go through this
    demodulator's ``bitmap``. The JAX ``DemodulatorBatchPSK`` stores its
    bitmap but always maps through ``PSK_BITMAPS[m]``, so with a custom
    bitmap its rows differ from its own single-burst chain; with the
    default bitmap the two packages agree.
    """

    def __init__(self, m: int, variant: str = "generic", bitmap=None,
                 device=None):
        if variant not in ("generic", "bpsk", "qpsk", "8psk"):
            raise ValueError(f"unknown variant {variant!r}")
        self.m = int(m)
        self.variant = variant
        self.device = resolve_device(device)
        self.bitmap = _own_bitmap(self.m, bitmap, self.device)

    @classmethod
    def from_numpy_params(cls, params: dict, device=None):
        """Carry a batch demodulator across from a JAX instance's
        attributes (``m`` and ``variant`` for the generic class,
        ``bitmap``)."""
        if cls is DemodulatorBatchPSK:
            return cls(int(params["m"]), params.get("variant", "generic"),
                       params.get("bitmap"), device=device)
        return cls(params.get("bitmap"), device=device)

    def demod_batch(self, xbatch: torch.Tensor, osr: int, amble,
                    search_start: int = 0, search_len: int = 128,
                    num_out_syms: int | None = None,
                    lengths=None) -> BatchDemodResult:
        _check_device(xbatch, self.device, "xbatch")
        B, L = xbatch.shape
        nsym = L // osr
        amble = to_tensor(amble, self.device)
        amble_len = int(amble.shape[-1])
        if lengths is None:
            lengths = torch.full((B,), L, dtype=torch.int64,
                                 device=self.device)
        else:
            lengths = to_tensor(lengths, self.device).long()
        if num_out_syms is None:
            num_out_syms = nsym - amble_len - search_start
        search_len = int(min(search_len, nsym - amble_len - search_start + 1))
        return _psk_demod_batch_impl(
            xbatch, lengths, amble, self.bitmap, m=self.m, osr=int(osr),
            search_start=int(search_start), search_len=search_len,
            amble_len=amble_len, num_out_syms=int(num_out_syms),
            variant=self.variant)


class DemodulatorBatchQPSK(DemodulatorBatchPSK):
    """QPSK burst-batched chain (reference CupyDemodulatorQPSK)."""

    def __init__(self, bitmap=None, device=None):
        super().__init__(4, "qpsk", bitmap, device)


# ---------------------------------------------------------------------------
# CPFSK demodulation
# ---------------------------------------------------------------------------

def _cp2fsk_tones(h: float, up: int, dtype, device) -> torch.Tensor:
    """(2, up) tones exp(-/+1j pi h t / up), the phase formed in the real
    dtype of ``dtype`` as the JAX package forms it."""
    phase = (np.pi * h) * torch.arange(up, dtype=real_dtype_for(dtype),
                                       device=device) / up
    mvals = torch.tensor([[-1.0], [1.0]], dtype=phase.dtype, device=device)
    return torch.polar(torch.ones_like(phase * mvals), phase[None, :] * mvals)


def demodulate_cp2fsk(syms: torch.Tensor, h: float, up: int):
    """2-tone dot-product CP2FSK demod (reference demodulateCP2FSK).
    Returns (bits, bitCost, tones)."""
    tones = _cp2fsk_tones(h, up, syms.dtype, syms.device)       # (2, up)
    num_syms = syms.shape[-1] // up
    folded = syms[: num_syms * up].reshape(num_syms, 1, up)
    # cost[k, i] = |sum(conj(symbol_i) * tone_k)| as explicit products
    prods = (torch.conj(folded) * tones[None]).sum(-1)          # (numSyms, 2)
    bit_cost = torch.abs(prods).T                               # (2, numSyms)
    bits = torch.argmax(bit_cost, dim=0).to(torch.uint8)
    return bits, bit_cost, tones


class BurstyDemodulatorCP2FSK:
    """Joint synchronous demodulation of regularly spaced CP2FSK bursts
    (reference BurstyDemodulatorCP2FSK): one correlation pass against both
    tones, then the per-symbol max costs are summed across all bursts at
    each candidate alignment; the argmax alignment demodulates every burst
    at once. It holds no tensors between calls, so it follows its input's
    device."""

    def __init__(self, burst_len: int, guard_len: int, up: int = 1,
                 h: float = 0.5):
        self.burst_len = int(burst_len)
        self.guard_len = int(guard_len)
        self.period = self.burst_len + self.guard_len
        self.up = int(up)
        self.h = float(h)
        self.burst_idxs = None
        self.d_costs = None
        self.search_idx = None

    def set_burst_idxs(self, burst_idxs):
        self.burst_idxs = np.asarray(burst_idxs)

    def demod(self, x: torch.Tensor, num_bursts: int | None = None,
              search_idx=None):
        if self.burst_idxs is None:
            if num_bursts is None:
                raise ValueError("set_burst_idxs() first or pass num_bursts")
            self.set_burst_idxs(np.arange(num_bursts))

        up = self.up
        # the tones of demodulate_cp2fsk: [conj(g), g], g = exp(1j pi h t/up)
        tones = _cp2fsk_tones(self.h, up, x.dtype, x.device)
        # one-pass correlation: xc[i, k] = sum_j x[i+j] * conj(tones[k, j])
        windows = x.unfold(0, up, 1)                              # (n_out, up)
        xc_abs = torch.abs((windows[:, None, :] * torch.conj(tones)).sum(-1))
        xc_max, xc_argmax = xc_abs.amax(dim=-1), xc_abs.argmax(dim=-1)
        n_out = windows.shape[0]

        burst_starts = self.burst_idxs * self.period * up
        symbol_spacing = np.arange(0, self.burst_len * up, up)
        gen_idx = (burst_starts[:, None] + symbol_spacing[None, :]).flatten()
        if search_idx is None:
            search_idx = np.arange(n_out - int(gen_idx[-1]))
        search_idx = np.asarray(search_idx)
        gi = torch.as_tensor(gen_idx, device=x.device)
        si = torch.as_tensor(search_idx, device=x.device)
        costs = torch.sum(xc_max[si[:, None] + gi[None, :]], dim=-1)
        self.d_costs = costs
        self.search_idx = search_idx

        mi = si[torch.argmax(costs)]
        dbits = xc_argmax[mi + gi].reshape(-1, self.burst_len).to(torch.uint8)
        return dbits, mi


def ml_demod_qpsk(y: torch.Tensor, h, up: int, num_syms: int):
    """Brute-force ML QPSK over all 4^num_syms sequences (reference
    ML_demod_QPSK), fully batched: every candidate symbol sequence is
    synthesized and filtered by the channel ``h`` at once (explicit
    shifted sums over the taps: no convolution library call). Returns
    (best base-4 sequence, best index, cost array)."""
    total = 4 ** num_syms
    ints = np.arange(total)
    digits = np.stack([(ints // 4 ** (num_syms - 1 - k)) % 4
                       for k in range(num_syms)], axis=1).astype(np.uint8)
    syms = torch.as_tensor(np.exp(1j * digits * (np.pi / 2)),
                           device=y.device).to(y.dtype)
    h = to_tensor(h, y.device).to(y.dtype)
    n_ups = num_syms * up
    ups = torch.zeros((total, n_ups), dtype=y.dtype, device=y.device)
    ups[:, ::up] = syms
    # full convolution of each row with h, then its [up, up + len(y)) part
    test = torch.zeros((total, n_ups + h.shape[0] - 1), dtype=y.dtype,
                       device=y.device)
    for k in range(h.shape[0]):
        test[:, k: k + n_ups] += h[k] * ups
    test = test[:, up: up + y.shape[-1]]
    cost = -torch.linalg.vector_norm(test - y[None, :], dim=-1)
    ii = int(torch.argmax(cost))
    return digits[ii], ii, cost
