"""Frequency-scanning CAF peak-search kernel and its plain PyTorch twin.

Kernel: ``csrc/fused_xcorr.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/fused_xcorr.py:_caf_kernel``. For each
shift s = s0 + i*step it returns ``max_k |X_s[k]|^2`` and its bin, with
``X_s = DFT_n(rx[s:s+n] * conj(cutout))``. The DFT is an FFT the kernel runs
in shared memory (``csrc/fft_smem.cuh``) under ``ops/fft.caf_plan``: one pass
for n <= 8192, else a column pass and a row pass over a complex64 scratch
(n = n1*n2, four-step), twiddles from f32 tables (``ops/fft.caf_tables``);
no FFT or BLAS library is involved. It is bound by bytes: the window, the
template and one scratch round trip per shift.

Ties go to the lowest bin, as ``torch.argmax`` over the natural-order
spectrum does, so the kernel and the twin agree even on exact ties.

``caf_peak`` routes by the tensor's device: a CPU tensor takes the plain twin
``caf_peak_plain``; a CUDA tensor launches the kernel or raises. QF^2
normalisation is the caller's (``ops/xcorr``). ``ops/fft.caf_staged`` is the
kernel's pass schedule in torch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pydsproutines_tpu_torch.ops.fft import (caf_plan, caf_tables, dft_matrix,
                                             plan_ints, twiddle)
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# kernel scratch per (shift, sample) of a plan of two or more passes: one
# complex64 buffer, the column passes writing it in place (a one-pass plan
# has none)
SCRATCH_BYTES_PER_SAMPLE = 8


def caf_peak_plain(rx: torch.Tensor, cutout_conj: torch.Tensor, s0: int,
                   step: int, num_shifts: int, batch: int = 128):
    """torch.fft twin of the kernel: (peak |X|^2, int64 bin) per shift."""
    # imported here: ops.xcorr imports this module for its kernel route
    from pydsproutines_tpu_torch.ops.xcorr import peak_search_plain

    shifts = s0 + step * torch.arange(num_shifts, device=rx.device)
    return peak_search_plain(rx, cutout_conj, shifts, batch, step)


def _check(rx, cutout_conj, s0, step, num_shifts):
    if rx.ndim != 1 or cutout_conj.ndim != 1:
        raise ValueError("caf_peak takes 1-D rx and cutout")
    if not (rx.is_complex() and cutout_conj.is_complex()):
        raise ValueError("caf_peak takes complex rx and cutout")
    if rx.device != cutout_conj.device:
        raise ValueError(f"rx on {rx.device}, cutout on {cutout_conj.device}")
    if s0 < 0 or step < 1 or num_shifts < 1:
        raise ValueError(f"bad sweep s0={s0}, step={step}, "
                         f"num_shifts={num_shifts}")
    n = cutout_conj.shape[-1]
    last = s0 + (num_shifts - 1) * step + n
    if last > rx.shape[-1]:
        raise ValueError(f"last window ends at {last} > len(rx) "
                         f"{rx.shape[-1]}")


def caf_peak(rx: torch.Tensor, cutout_conj: torch.Tensor, s0: int, step: int,
             num_shifts: int, batch: int = 128):
    """(max_k |DFT(rx[s:s+n] * cutout_conj)[k]|^2 as float32, its bin as
    int64) for the shifts s = s0 + i*step, i < num_shifts, processed in
    chunks of at most ``batch`` shifts whose scratch fits the byte budget
    (``utils.memory``)."""
    _check(rx, cutout_conj, s0, step, num_shifts)
    if rx.device.type == "cpu":
        return caf_peak_plain(rx, cutout_conj, s0, step, num_shifts, batch)
    if rx.device.type != "cuda":
        raise ValueError(f"caf_peak: unsupported device {rx.device}")
    return _caf_peak_cuda(rx, cutout_conj, s0, step, num_shifts, batch)


caf_peak.launches = 0


@functools.lru_cache(maxsize=4)
def split_tables(n1: int, n2: int, device: torch.device):
    """Device copies of (W1, TW, W2) for the split n = n1*n2 (the dense
    stage-1 tables of ``ops/hopper/fft_peak``)."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in (dft_matrix(n1), twiddle(n1, n2), dft_matrix(n2)))


class CafLaunch:
    """What a launch of the CAF kernels (#2, #3) needs for an n-point
    window on one device: the plan, its device tables, and the two host
    arrays the C entry points read (the five table pointers, the plan's
    ints)."""

    def __init__(self, n: int, device: torch.device):
        self.plan = caf_plan(n)
        if self.plan is None:
            raise ValueError(f"n={n} has no shared-memory FFT plan for the "
                             "CAF kernels")
        self.n = n
        self.factors = self.plan["factors"]
        self.tables = [None if t is None else torch.from_numpy(t).to(device)
                       for t in caf_tables(self.plan)]
        self.table_ptrs = (ctypes.c_void_p * len(self.tables))(
            *[0 if t is None else t.data_ptr() for t in self.tables])
        ints = plan_ints(self.plan)
        self.plan_ints = (ctypes.c_int * len(ints))(*ints)

    @property
    def passes(self) -> int:
        return len(self.factors)

    def buffers(self, nb: int, device: torch.device):
        """(scratch, rowmax, rowarg) for chunks of nb shifts; empty for a
        one-pass plan."""
        multi = self.passes > 1
        rows = self.n // self.factors[-1] if multi else 0
        return (torch.empty(nb * self.n if multi else 0, dtype=torch.complex64,
                            device=device),
                torch.empty(nb * rows, dtype=torch.float32, device=device),
                torch.empty(nb * rows, dtype=torch.int32, device=device))

    def scratch_bytes(self, nb: int) -> int:
        return nb * self.n * SCRATCH_BYTES_PER_SAMPLE if self.passes > 1 \
            else 0

    def args(self):
        """The (tables, plan) pointer pair of the C entry points."""
        return ctypes.addressof(self.table_ptrs), \
            ctypes.addressof(self.plan_ints)


@functools.lru_cache(maxsize=8)
def caf_launch(n: int, device: torch.device) -> CafLaunch:
    return CafLaunch(n, device)


def _caf_peak_cuda(rx, cutout_conj, s0, step, num_shifts, batch):
    lib = _build.library()
    n = cutout_conj.shape[-1]
    if rx.dtype != torch.complex64 or cutout_conj.dtype != torch.complex64:
        raise ValueError("the CAF kernel takes complex64 "
                         f"(got {rx.dtype}, {cutout_conj.dtype})")
    if not (rx.is_contiguous() and cutout_conj.is_contiguous()):
        raise ValueError("the CAF kernel takes contiguous tensors")
    if rx.shape[-1] >= 2**31:
        raise ValueError("rx too long for 32-bit sample indexing")
    dev = rx.device
    launch = caf_launch(n, dev)
    nb_max = chunk_shifts(n, min(batch, num_shifts), SCRATCH_BYTES_PER_SAMPLE)
    scratch, rowmax, rowarg = launch.buffers(nb_max, dev)
    out_max = torch.empty(num_shifts, dtype=torch.float32, device=dev)
    out_bin = torch.empty(num_shifts, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, num_shifts, nb_max):
            nb = min(nb_max, num_shifts - c0)
            rc = lib.pdsp_caf_peak(
                rx.data_ptr(), cutout_conj.data_ptr(), *launch.args(),
                scratch.data_ptr(), rowmax.data_ptr(), rowarg.data_ptr(),
                out_max[c0:].data_ptr(), out_bin[c0:].data_ptr(),
                s0 + c0 * step, step, nb, stream)
            _build.check(rc, f"caf_peak launch (n={n}, chunk at {c0})")
            caf_peak.launches += 1
    return out_max, out_bin.long()
