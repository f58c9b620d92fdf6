"""Median filter (TPU kernel #6) and its plain PyTorch twin.

Kernel: ``csrc/medfilt.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/medfilt.py:_kernel`` and keeps its
method: floats become order-preserving unsigned keys (-0.0 below +0.0, the
zero padding the key of +0.0) and each output is the largest key v with
count(window keys < v) <= k//2, found by an MSB-first radix select, then
mapped back to the float's bits. The result is bit-identical to
``scipy.signal.medfilt`` (zero-padded edges, odd k) and to the twin.
float32 takes 32 steps over uint32 keys, float64 64 over uint64.

``medfilt_kernel`` routes by the tensor's device: a CPU tensor takes the
plain twin ``medfilt_plain`` (pad + unfold + ``torch.median`` in chunks of
_MEDFILT_ELEMS window elements); a CUDA tensor launches the kernel or
raises. The kernel filters contiguous 1-D float32/float64 signals; float16
and bfloat16 signals are filtered as float32 and cast back, which is exact
(the median is one of the inputs, and the casts are exact). Windows whose
(256 + k - 1) keys do not fit shared memory take its unstaged variant, so
any odd k runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pydsproutines_tpu_torch.ops.hopper import _build

# window-matrix elements per twin chunk (the JAX package's ops/filters
# _MEDFILT_ELEMS): a 4M x 129 filter never holds its 2 GB window matrix
_MEDFILT_ELEMS = 1 << 23


def _check_k(kernel_size) -> int:
    k = int(kernel_size)
    if k < 1 or k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    return k


def medfilt_plain(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Median over each zero-padded window of odd length k along the last
    axis (scipy.signal.medfilt for 1-D input), in chunks of at most
    _MEDFILT_ELEMS window elements."""
    k = _check_k(kernel_size)
    half = k // 2
    n = x.shape[-1]
    x2 = x.reshape(-1, n)
    xp = F.pad(x2, (half, half))
    step = max(1, _MEDFILT_ELEMS // (k * max(1, x2.shape[0])))
    parts = [xp[:, i: i + step + k - 1].unfold(-1, k, 1).median(-1).values
             for i in range(0, n, step)]
    return torch.cat(parts, dim=-1).reshape(x.shape)


def medfilt_kernel(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """scipy.signal.medfilt(x, kernel_size) of a 1-D real signal, bit-exact.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    k = _check_k(kernel_size)
    if x.ndim != 1 or x.is_complex():
        raise ValueError("medfilt_kernel takes a 1-D real signal")
    if x.device.type == "cpu":
        return medfilt_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"medfilt_kernel: unsupported device {x.device}")
    return _medfilt_cuda(x, k)


medfilt_kernel.launches = 0


def _medfilt_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.dtype in (torch.float16, torch.bfloat16):
        return _medfilt_cuda(x.float(), k).to(x.dtype)
    lib = _build.library()
    fn = {torch.float32: lib.pdsp_medfilt_f32,
          torch.float64: lib.pdsp_medfilt_f64}.get(x.dtype)
    if fn is None:
        raise ValueError(f"the medfilt kernel takes a float signal "
                         f"(got {x.dtype})")
    if k >= 2**31:
        raise ValueError(f"kernel_size {k} exceeds the kernel's 32-bit window")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], k, stream)
    _build.check(rc, f"medfilt launch (n={x.shape[0]}, k={k})")
    medfilt_kernel.launches += 1
    return out
