"""WOLA channelizer kernel (N == Dec) and its plain PyTorch twin.

Kernel: ``csrc/wola_fused.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/wola_fused.py:_kernel`` and
``:_kernel_direct`` and computes, in one pass over the input,

    out[r, k] = sum_a dft_in[r, a] * exp(+2*pi*i*a*k/N)
    dft_in[r, a] = sum_b x[r*N - b*N - a] * h[b*N + a],   x = 0 before 0.

It is built for the memory floor (one read, one write: 128 MB at 8M
samples); the source note says what its direct f32 IDFT costs on top.

``wola_fused`` routes by the tensor's device: a CPU tensor takes the plain
twin ``wola_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for


def wola_plain(f_tap: torch.Tensor, x: torch.Tensor, dec: int,
               n: int) -> torch.Tensor:
    """N * IDFT_N of the polyphase fold, for N == Dec or N == 2*Dec (the odd
    row flip of N == 2*Dec is the caller's). Returns (len(x)//dec, n).

    With y[r, a] = x[r*dec - a] (zero before 0), the fold is a B-tap FIR down
    each column of y at a row stride of q = n/dec:
    dft_in[r, a] = sum_b h[b*n + a] * y[r - b*q, a].
    """
    taps = f_tap.shape[-1]
    nb, q = taps // n, n // dec
    rows = x.shape[-1] // dec
    h = f_tap.to(real_dtype_for(x.dtype)).reshape(nb, n)
    xp = torch.cat([x.new_zeros(n), x[: rows * dec]])
    # y_rev[r, j] = xp[1 + r*dec + j] = x[r*dec - (n-1-j)]
    y = xp.as_strided((rows, n), (dec, 1), xp.storage_offset() + 1).flip(-1)
    acc = y * h[0]
    for b in range(1, nb):
        if b * q >= rows:
            break
        acc[b * q:] += y[: rows - b * q] * h[b]
    return torch.fft.ifft(acc, dim=-1) * n


def _check(f_tap: torch.Tensor, x: torch.Tensor, n: int) -> None:
    if f_tap.ndim != 1 or f_tap.is_complex():
        raise ValueError("wola_fused takes real 1-D taps")
    if x.ndim != 1 or not x.is_complex():
        raise ValueError("wola_fused takes a complex 1-D input")
    if n < 1 or f_tap.shape[-1] % n != 0:
        raise ValueError(f"tap length {f_tap.shape[-1]} is not a multiple "
                         f"of N={n}")
    if f_tap.device != x.device:
        raise ValueError(f"taps on {f_tap.device}, input on {x.device}")


def wola_fused(f_tap: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """Critically sampled WOLA channelize (N == Dec). Returns the
    (len(x)//n, n) channel matrix. CPU tensors take the plain twin; CUDA
    tensors launch the Hopper kernel."""
    _check(f_tap, x, n)
    if x.device.type == "cpu":
        return wola_plain(f_tap, x, n, n)
    if x.device.type != "cuda":
        raise ValueError(f"wola_fused: unsupported device {x.device}")
    return _wola_fused_cuda(f_tap, x, n)


wola_fused.launches = 0


@functools.lru_cache(maxsize=8)
def _idft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    m = np.arange(n, dtype=np.float64)
    return torch.from_numpy(
        np.exp(2j * np.pi * m / n).astype(np.complex64)).to(device)


def _wola_fused_cuda(f_tap: torch.Tensor, x: torch.Tensor,
                     n: int) -> torch.Tensor:
    lib = _build.library()
    if x.dtype != torch.complex64 or f_tap.dtype != torch.float32:
        raise ValueError("the WOLA kernel takes complex64 input and float32 "
                         f"taps (got {x.dtype}, {f_tap.dtype})")
    if not (x.is_contiguous() and f_tap.is_contiguous()):
        raise ValueError("the WOLA kernel takes contiguous tensors")
    rows = x.shape[-1] // n
    if rows * n >= 2**31:
        raise ValueError("input too long for 32-bit row indexing")
    out = torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    tw = _idft_twiddles(n, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pdsp_wola_fused(x.data_ptr(), f_tap.data_ptr(),
                                 tw.data_ptr(), out.data_ptr(), rows, n,
                                 f_tap.shape[-1] // n, stream)
    _build.check(rc, f"wola_fused launch (rows={rows}, n={n})")
    wola_fused.launches += 1
    return out
