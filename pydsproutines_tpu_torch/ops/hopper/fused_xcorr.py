"""Frequency-scanning CAF peak-search kernel and its plain PyTorch twin.

Kernel: ``csrc/fused_xcorr.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/fused_xcorr.py:_caf_kernel``. For each
shift s = s0 + i*step it returns ``max_k |X_s[k]|^2`` and its bin, with
``X_s = DFT_n(rx[s:s+n] * conj(cutout))``. The DFT is computed in the kernel
as a two-stage split n = n1*n2 (``ops/fft.best_two_factor``) against f32
tables (``ops/fft.dft_matrix`` / ``twiddle``); no FFT or BLAS library is
involved. It is bound by f32 arithmetic: n*(n1 + n2) complex MACs per shift.

Ties go to the lowest bin, as ``torch.argmax`` over the natural-order
spectrum does, so the kernel and the twin agree even on exact ties.

``caf_peak`` routes by the tensor's device: a CPU tensor takes the plain twin
``caf_peak_plain``; a CUDA tensor launches the kernel or raises. QF^2
normalisation is the caller's (``ops/xcorr``).
"""

from __future__ import annotations

import functools

import torch

from pydsproutines_tpu_torch.ops.fft import best_two_factor, dft_matrix, twiddle
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# kernel scratch per (shift, sample): the (n1, n2) complex64 stage-1 output
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
    """Device copies of (W1, TW, W2) for the split n = n1*n2."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in (dft_matrix(n1), twiddle(n1, n2), dft_matrix(n2)))


def _caf_peak_cuda(rx, cutout_conj, s0, step, num_shifts, batch):
    lib = _build.library()
    n = cutout_conj.shape[-1]
    split = best_two_factor(n)
    if split is None:
        raise ValueError(f"n={n} has no two-factor split for the CAF kernel")
    if rx.dtype != torch.complex64 or cutout_conj.dtype != torch.complex64:
        raise ValueError("the CAF kernel takes complex64 "
                         f"(got {rx.dtype}, {cutout_conj.dtype})")
    if not (rx.is_contiguous() and cutout_conj.is_contiguous()):
        raise ValueError("the CAF kernel takes contiguous tensors")
    if rx.shape[-1] >= 2**31:
        raise ValueError("rx too long for 32-bit sample indexing")
    n1, n2 = split
    dev = rx.device
    w1, tw, w2 = split_tables(n1, n2, dev)
    nb_max = chunk_shifts(n, min(batch, num_shifts), SCRATCH_BYTES_PER_SAMPLE)
    scratch = torch.empty((nb_max, n1, n2), dtype=torch.complex64, device=dev)
    rowmax = torch.empty((nb_max, n1), dtype=torch.float32, device=dev)
    rowarg = torch.empty((nb_max, n1), dtype=torch.int32, device=dev)
    out_max = torch.empty(num_shifts, dtype=torch.float32, device=dev)
    out_bin = torch.empty(num_shifts, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, num_shifts, nb_max):
            nb = min(nb_max, num_shifts - c0)
            rc = lib.pdsp_caf_peak(
                rx.data_ptr(), cutout_conj.data_ptr(), w1.data_ptr(),
                tw.data_ptr(), w2.data_ptr(), scratch.data_ptr(),
                rowmax.data_ptr(), rowarg.data_ptr(),
                out_max[c0:].data_ptr(), out_bin[c0:].data_ptr(),
                s0 + c0 * step, step, nb, n1, n2, stream)
            _build.check(rc, f"caf_peak launch (n={n}, chunk at {c0})")
            caf_peak.launches += 1
    return out_max, out_bin.long()
