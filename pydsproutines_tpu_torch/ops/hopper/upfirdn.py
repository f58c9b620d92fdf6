"""upfirdn of real-tap planes (TPU kernel #5) and its plain PyTorch twin.

Kernel: ``csrc/upfirdn.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/upfirdn.py:_kernel`` and
``:_kernel_nopad`` and computes scipy.signal.upfirdn of one or two real
planes with real taps: for output j, with m = j*down, p = m mod up and
q = m div up,

    out[j] = sum_l h[p + l*up] * x[q - l],   l in [0, ceil(T/up)),

x zero outside [0, n). The planes are read where they lie, at any row and
element stride: the real and imaginary parts of a complex tensor
(``x.real``/``x.imag``, element stride 2) or two separate float planes,
with no stacked copy. Rows of a 2-D input and both planes share one launch.
float32 and float64 planes each have a kernel route.

The TPU kernel's gp = 128 band matrices, 8-row DMA alignment and viability
gate (``upfirdn_pallas_viable``: n_out >= 2*128*cols, <= 2 planes) belong to
the TPU layout and do not apply: every geometry launches. The launcher picks
the slab size and whether the block stages its input span and taps in shared
memory; when they do not fit, the unstaged variant reads them through the
caches, so no tap length is refused.

``upfirdn_planes`` routes by the tensors' device: CPU tensors take the plain
twin ``upfirdn_planes_plain`` (polyphase windows x banded tap matrix, full
f32); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import full_f32

# twin working set per chunk of windows (elements)
PLAIN_CHUNK_ELEMS = 1 << 24


def get_upfirdn_size(original_size: int, taps_size: int, up: int,
                     down: int) -> int:
    """Output size matching scipy.signal.upfirdn:
    ceil((n*up - (up-1) + T - 1)/down)."""
    return -(-(original_size * up - (up - 1) + taps_size - 1) // down)


def _band(taps: torch.Tensor, up: int, down: int):
    """(K, P, S, lw): the polyphase band matrix of one phase period,
    K[t, c] = h[p_c + l*up] with l = qc_c + lh - 1 - t, zero off the band."""
    g = math.gcd(up, down)
    P, S = up // g, down // g
    T = taps.shape[-1]
    lh = -(-T // up)
    hp = F.pad(taps, (0, lh * up - T)).reshape(lh, up).T     # hp[p, l]
    dev = taps.device
    c = torch.arange(P, device=dev)
    pc, qc = (c * down) % up, (c * down) // up
    lw = lh + (P - 1) * down // up
    l_idx = qc[None, :] + lh - 1 - torch.arange(lw, device=dev)[:, None]
    valid = (l_idx >= 0) & (l_idx < lh)
    K = torch.where(valid, hp[pc[None, :].expand(lw, P),
                              l_idx.clamp(0, lh - 1)], 0)
    return K, P, S, lw


def upfirdn_planes_plain(planes: Sequence[torch.Tensor], taps: torch.Tensor,
                         up: int, down: int, n_out: int | None = None
                         ) -> tuple[torch.Tensor, ...]:
    """Plain twin: each plane's windows of one phase period times the banded
    tap matrix, in chunks of PLAIN_CHUNK_ELEMS, matrix products in full f32.
    Returns one (..., n_out) tensor per plane."""
    n = planes[0].shape[-1]
    T = taps.shape[-1]
    if n_out is None:
        n_out = get_upfirdn_size(n, T, up, down)
    K, P, S, lw = _band(taps, up, down)
    lh = -(-T // up)
    ni = -(-n_out // P)
    right = max(0, (ni - 1) * S + lw - (n + lh - 1))
    outs = []
    for x in planes:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, n)
        xp = F.pad(x2, (lh - 1, right))
        win = xp.unfold(-1, lw, S)[:, :ni]                   # (rows, ni, lw)
        step = max(1, PLAIN_CHUNK_ELEMS // (lw * max(1, x2.shape[0])))
        with full_f32():
            y = torch.cat([win[:, i: i + step] @ K
                           for i in range(0, ni, step)], dim=1)
        outs.append(y.reshape(x2.shape[0], ni * P)[:, :n_out]
                    .reshape(*lead, n_out))
    return tuple(outs)


def _check(planes, taps):
    if not 1 <= len(planes) <= 2:
        raise ValueError("upfirdn_planes takes one or two planes")
    x0 = planes[0]
    for x in planes:
        if x.is_complex() or not x.is_floating_point():
            raise ValueError(f"upfirdn_planes takes real float planes "
                             f"(got {x.dtype})")
        if x.ndim not in (1, 2):
            raise ValueError("upfirdn_planes takes 1-D or 2-D (rows, n) "
                             "planes")
        if (x.shape, x.dtype, x.device) != (x0.shape, x0.dtype, x0.device):
            raise ValueError("the planes differ in shape, dtype or device")
    if taps.ndim != 1 or taps.is_complex() or taps.shape[-1] < 1:
        raise ValueError("upfirdn_planes takes non-empty real 1-D taps")
    if taps.dtype != x0.dtype or taps.device != x0.device:
        raise ValueError(f"taps are {taps.dtype} on {taps.device}, planes "
                         f"{x0.dtype} on {x0.device}")
    if x0.shape[-1] < 1:
        raise ValueError("upfirdn_planes takes non-empty planes")


def upfirdn_planes(planes: Sequence[torch.Tensor], taps: torch.Tensor,
                   up: int, down: int, n_out: int | None = None,
                   out: Sequence[torch.Tensor] | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """scipy.signal.upfirdn(taps, plane, up, down)[..., :n_out] of each of
    one or two real planes ((n,) or (rows, n), any strides), written into
    ``out`` when given (e.g. ``(y.real, y.imag)`` of a complex result).
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    planes = tuple(planes)
    _check(planes, taps)
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up={up}, down={down} must be >= 1")
    if n_out is None:
        n_out = get_upfirdn_size(planes[0].shape[-1], taps.shape[-1], up,
                                 down)
    dev = planes[0].device
    if dev.type == "cpu":
        got = upfirdn_planes_plain(planes, taps, up, down, n_out)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"upfirdn_planes: unsupported device {dev}")
    return _upfirdn_cuda(planes, taps, up, down, int(n_out), out)


upfirdn_planes.launches = 0


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """(row stride, element stride) of a 1-D or 2-D tensor, in elements."""
    return (t.stride(0) if t.ndim == 2 else 0), t.stride(-1)


def _upfirdn_cuda(planes, taps, up, down, n_out, out):
    lib = _build.library()
    x0 = planes[0]
    fn = {torch.float32: lib.pdsp_upfirdn_f32,
          torch.float64: lib.pdsp_upfirdn_f64}.get(x0.dtype)
    if fn is None:
        raise ValueError(f"the upfirdn kernel takes float32 or float64 planes "
                         f"(got {x0.dtype})")
    if len({_strides(x) for x in planes}) != 1:
        raise ValueError("the planes must share their strides")
    T = taps.shape[-1]
    if T >= 2**31 or up * (-(-T // up)) >= 2**31:
        raise ValueError(f"{T} taps at up={up} exceed the kernel's 32-bit "
                         f"tap indexing")
    rows = x0.shape[0] if x0.ndim == 2 else 1
    shape = (*x0.shape[:-1], n_out)
    if out is None:
        out = tuple(torch.empty(shape, dtype=x0.dtype, device=x0.device)
                    for _ in planes)
    out = tuple(out)
    if len(out) != len(planes) or any(
            (o.shape, o.dtype, o.device) != (shape, x0.dtype, x0.device)
            for o in out) or len({_strides(o) for o in out}) != 1:
        raise ValueError(f"out must be {len(planes)} {x0.dtype} tensors of "
                         f"shape {shape} on {x0.device} sharing strides")
    if n_out < 1 or rows == 0:
        return out
    taps = taps.contiguous()
    in_rs, in_es = _strides(x0)
    out_rs, out_es = _strides(out[0])
    second = planes[-1].data_ptr(), out[-1].data_ptr()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x0.data_ptr(), second[0], out[0].data_ptr(), second[1],
                len(planes), rows, x0.shape[-1], in_rs, in_es, n_out, out_rs,
                out_es, taps.data_ptr(), T, up, down, stream)
    _build.check(rc, f"upfirdn launch (n={x0.shape[-1]}, taps={T}, "
                     f"up={up}, down={down})")
    upfirdn_planes.launches += 1
    return out
