"""Last-stage DFT peak kernel (TPU kernel #4) and its plain PyTorch twin.

Kernel: ``csrc/fft_peak.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/fft_peak.py:_kernel``. Given the
stage-1 output F (B, K1, J) of a DFT plan and the twiddle TW (K1, J), it
computes ``(F * TW) @ DFT_J`` as a J-point FFT in shared memory
(``csrc/fft_smem.cuh``'s row pass, the twiddle applied as each row is
loaded), ``|.|^2`` and the per-row (max, argmax k2), then reduces the rows
of each transform to (peak, true bin). For a two-factor plan the bin is
k1 + K1*k2; for deeper plans the leading rows are folded into the batch and
rebuilt as ``ops/fft.peak_winner`` does. J <= 8192.

The JAX kernel takes the last stage's DFT matrix ``w2``; the JAX package
only ever passes DFT_J there (``FourStepFFT._peak_consts``), so the port's
``stage2_peak(f1, tw, factors)`` takes none: the kernel runs the FFT and the
twin ``torch.fft.fft``. Ties go to the lowest true bin, as ``torch.argmax``
on the natural-order spectrum does (the TPU kernel takes the first in its
permuted order). ``ops/fft.FourStepFFT.call_peak``, whose last stage this
kernel is, keeps that rule: the one the JAX tests hold ``call_peak`` to
(``np.argmax`` of the natural spectrum, ``tests/test_fft_peak.py:27-28``).
``ops/fft.stage2_staged`` is the kernel's schedule in torch.

``peak_sweep`` is the ``fast_xcorr`` "peak-kernel-hopper" route: a sweep over
an arbitrary int64 list of shift offsets under a two-pass ``caf_plan`` n =
n1*n2, whose stage 1 is ``window_columns`` (``pdsp_window_cols``:
``fft_smem.cuh``'s column pass over the windows read through the offset
list and modulated on the fly, stored without the four-step twiddle) and
whose last stage is this kernel, which applies that twiddle on load.

Each wrapper routes by the tensor's device: a CPU tensor takes the plain
twin; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pydsproutines_tpu_torch.ops.fft import (caf_plan, row_plan,
                                             spectrum_peaks, stage_tables,
                                             twiddle)
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import CafLaunch
from pydsproutines_tpu_torch.utils.dtypes import full_f32
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# stage-1 output of the sweep per (shift, sample), complex64
SCRATCH_BYTES_PER_SAMPLE = 8


def _factors(f1: torch.Tensor, factors) -> tuple:
    return tuple(int(f) for f in factors) if factors is not None \
        else (f1.shape[1], f1.shape[2])


def _check_stage2(f1, tw, factors):
    if f1.ndim != 3 or tw.ndim != 2:
        raise ValueError("stage2_peak takes f1 (B, K1, J) and tw (K1, J)")
    b, k1, j = f1.shape
    if tuple(tw.shape) != (k1, j):
        raise ValueError(f"stage2_peak shapes f1 {tuple(f1.shape)}, tw "
                         f"{tuple(tw.shape)}")
    if f1.device != tw.device:
        raise ValueError(f"f1 on {f1.device}, tw on {tw.device}")
    if len(factors) < 2 or factors[-2] != k1 or factors[-1] != j:
        raise ValueError(f"factors {factors} do not end in (K1, J) = "
                         f"({k1}, {j})")
    rows = math.prod(factors[:-1])
    if (b * k1) % rows:
        raise ValueError(f"B*K1 = {b * k1} rows is not a whole number of "
                         f"{rows}-row transforms")


def stage2_peak_plain(f1: torch.Tensor, tw: torch.Tensor, factors=None):
    """Torch twin of the kernel: ``torch.fft.fft`` of the twiddled rows,
    (peak |X|^2 as float32, int64 true bin) per transform."""
    factors = _factors(f1, factors)
    _check_stage2(f1, tw, factors)
    return spectrum_peaks(torch.fft.fft(f1 * tw, dim=-1), factors)


def stage2_peak(f1: torch.Tensor, tw: torch.Tensor, factors=None):
    """(max |X|^2 as float32, its true bin as int64) per transform, where
    X = DFT_J(f1 * tw) row by row and ``factors`` (default (K1, J)) is the
    DFT plan whose last two factors are K1 and J."""
    factors = _factors(f1, factors)
    _check_stage2(f1, tw, factors)
    if f1.device.type == "cpu":
        return stage2_peak_plain(f1, tw, factors)
    if f1.device.type != "cuda":
        raise ValueError(f"stage2_peak: unsupported device {f1.device}")
    return _stage2_peak_cuda(f1, tw, factors)


stage2_peak.launches = 0


def require_c64(*tensors):
    for t in tensors:
        if t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError("the Hopper CAF kernels take contiguous "
                             f"complex64 tensors (got {t.dtype}, "
                             f"contiguous={t.is_contiguous()})")


@functools.lru_cache(maxsize=8)
def _row_launch(j: int, device: torch.device) -> CafLaunch:
    """The tables of kernel #4's J-point row FFT (``row_plan``)."""
    return CafLaunch(j, device, row_plan(j))


def _stage2_peak_cuda(f1, tw, factors):
    lib = _build.library()
    require_c64(f1, tw)
    b, k1, j = f1.shape
    if b * k1 >= 2**31:
        raise ValueError(f"{b} x {k1} rows exceed the kernel's 32-bit rows")
    rows = _row_launch(j, f1.device)
    ntrans = b * k1 // math.prod(factors[:-1])
    dev = f1.device
    rowmax = torch.empty(b * k1, dtype=torch.float32, device=dev)
    rowarg = torch.empty(b * k1, dtype=torch.int32, device=dev)
    out_max = torch.empty(ntrans, dtype=torch.float32, device=dev)
    out_bin = torch.empty(ntrans, dtype=torch.int32, device=dev)
    fac = (ctypes.c_int * len(factors))(*factors)
    with torch.cuda.device(dev):
        rc = lib.pdsp_stage2_peak(
            f1.data_ptr(), tw.data_ptr(), rows.tables[0].data_ptr(),
            rows.tables[5].data_ptr(), ctypes.addressof(rows.plan_ints),
            rowmax.data_ptr(), rowarg.data_ptr(), out_max.data_ptr(),
            out_bin.data_ptr(), b, k1, fac, len(factors),
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"stage2_peak launch (B={b}, K1={k1}, J={j})")
        stage2_peak.launches += 1
    return out_max, out_bin.long()


def leading_stages_plain(x: torch.Tensor, factors) -> torch.Tensor:
    """Stages 0..L-2 of the plan ``factors`` over the rows of x (..., n) in
    torch, the last of them without its twiddle: the (B*rows, K1, J) input
    of ``stage2_peak`` (the XLA einsums of the JAX ``call_peak``,
    ``pydsproutines_tpu/ops/fft.py:327-335``), in full f32 (no TF32). A
    plain twin for the tests and of ``FourStepFFT.call_peak``'s leading
    stages; the fast_xcorr routes run their stage 1 in a kernel."""
    stage_w, stage_tw = stage_tables(factors)
    cur = x.reshape(-1, math.prod(factors))
    for s, n1 in enumerate(factors[:-1]):
        cur = cur.reshape(cur.shape[:-1] + (n1, -1))
        w = torch.from_numpy(stage_w[s]).to(x.device)
        with full_f32():
            cur = torch.einsum("kn,...nm->...km", w, cur)
        if s < len(factors) - 2:
            cur = cur * torch.from_numpy(stage_tw[s]).to(x.device)
    return cur.reshape(-1, factors[-2], factors[-1]).contiguous()


def sweep_plan(n: int) -> dict:
    """The two-pass plan n = n1*n2 of the "peak-kernel-hopper" route:
    ``caf_plan(n)`` where that has two passes, and for an n that fits one
    block the same ranking of two-factor splits. Raises where n has none."""
    plan = caf_plan(n, min_passes=2)
    if plan is None or len(plan["factors"]) != 2:
        raise ValueError(f"n={n} has no two-pass shared-memory FFT plan for "
                         "the peak kernel's route")
    return plan


def window_columns_plain(rx, cutout_conj, offsets):
    """Torch twin of ``window_columns``: the n1-point DFT down the columns
    of each window rx[s:s+n] * cc viewed as (n1, n2) (``sweep_plan(n)``),
    no twiddle."""
    n1, n2 = sweep_plan(cutout_conj.shape[-1])["factors"]
    idx = offsets[:, None] + torch.arange(n1 * n2, device=rx.device)[None, :]
    return torch.fft.fft((rx[idx] * cutout_conj).reshape(-1, n1, n2), dim=1)


@functools.lru_cache(maxsize=8)
def _sweep_launch(n: int, device: torch.device) -> CafLaunch:
    """The route's tables at n: the column FFT's and the twiddle TW
    (n1, n2), ``tables[3]``."""
    return CafLaunch(n, device, sweep_plan(n))


def window_columns(rx, cutout_conj, offsets, out=None):
    """Stage 1 of the route's two-pass plan n = n1*n2 (``sweep_plan(n)``,
    n = len(cutout_conj)) for the windows at int64 ``offsets``:
    (len(offsets), n1, n2) complex64 column DFTs without the four-step
    twiddle, written into ``out`` when given (CUDA only)."""
    if rx.device.type == "cpu":
        return window_columns_plain(rx, cutout_conj, offsets)
    if rx.device.type != "cuda":
        raise ValueError(f"window_columns: unsupported device {rx.device}")
    lib = _build.library()
    require_c64(rx, cutout_conj)
    tabs = _sweep_launch(cutout_conj.shape[-1], rx.device)
    n1, n2 = tabs.factors
    nb = offsets.shape[0]
    if out is None:
        out = torch.empty((nb, n1, n2), dtype=torch.complex64,
                          device=rx.device)
    if out.shape != (nb, n1, n2) or not out.is_contiguous():
        raise ValueError(f"window_columns out {tuple(out.shape)} is not a "
                         f"contiguous ({nb}, {n1}, {n2})")
    with torch.cuda.device(rx.device):
        rc = lib.pdsp_window_cols(
            rx.data_ptr(), cutout_conj.data_ptr(), offsets.data_ptr(),
            tabs.tables[0].data_ptr(), tabs.tables[5].data_ptr(),
            ctypes.addressof(tabs.plan_ints), out.data_ptr(), nb,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"window_columns launch (nb={nb}, n={n1}x{n2})")
        window_columns.launches += 1
    return out


window_columns.launches = 0


def check_offsets(rx: torch.Tensor, offsets: torch.Tensor, n: int) -> None:
    """Raise unless ``offsets`` is a non-empty 1-D int64 tensor on rx's
    device whose windows rx[s, s+n) all lie inside rx."""
    if offsets.ndim != 1 or offsets.shape[0] == 0 \
            or offsets.dtype != torch.int64:
        raise ValueError("shift offsets must be a non-empty 1-D int64 tensor")
    if offsets.device != rx.device:
        raise ValueError(f"offsets on {offsets.device}, rx on {rx.device}")
    lo, hi = int(offsets.min()), int(offsets.max())
    if lo < 0 or hi + n > rx.shape[-1]:
        raise ValueError(f"windows [{lo}, {hi} + {n}) run outside rx of "
                         f"length {rx.shape[-1]}")


def peak_sweep(rx: torch.Tensor, cutout_conj: torch.Tensor,
               offsets: torch.Tensor, batch: int = 128):
    """(max_k |DFT_n(rx[s:s+n] * cutout_conj)[k]|^2 as float32, its bin as
    int64) for each s in ``offsets``, over the two-pass plan n = n1*n2
    (``sweep_plan``): stage 1 in ``window_columns``, the twiddle and the
    rest in ``stage2_peak``, in chunks of at most ``batch`` shifts within the
    byte budget. CPU tensors run both twins."""
    n = cutout_conj.shape[-1]
    if rx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"peak_sweep: unsupported device {rx.device}")
    check_offsets(rx, offsets, n)
    offsets = offsets.contiguous()
    n1, n2 = sweep_plan(n)["factors"]
    if rx.device.type == "cuda":
        tw = _sweep_launch(n, rx.device).tables[3]
    else:
        tw = torch.from_numpy(twiddle(n1, n2))
    nb = chunk_shifts(n, min(batch, offsets.shape[0]),
                      SCRATCH_BYTES_PER_SAMPLE)
    scratch = None
    if rx.device.type == "cuda":
        scratch = torch.empty((nb, n1, n2), dtype=torch.complex64,
                              device=rx.device)
    maxv, bins = [], []
    for c0 in range(0, offsets.shape[0], nb):
        chunk = offsets[c0: c0 + nb]
        out = None if scratch is None else scratch[: chunk.shape[0]]
        f1 = window_columns(rx, cutout_conj, chunk, out=out)
        m, b = stage2_peak(f1, tw, (n1, n2))
        maxv.append(m)
        bins.append(b)
    return torch.cat(maxv), torch.cat(bins)
