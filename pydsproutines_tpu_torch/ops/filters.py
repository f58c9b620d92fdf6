"""FIR filtering, rational resampling (upfirdn), moving sums/averages and
median filtering.

PyTorch counterpart of ``pydsproutines_tpu/ops/filters.py``, with its names,
signatures and defaults. Every FIR here is one upfirdn:

  * ``upfirdn``/``fir_upfirdn``/``fir_upfirdn_planes_flat``/
    ``StreamUpfirdn`` run the upfirdn kernel (``ops/hopper/upfirdn.py``) on
    the real and imaginary planes of the input, read in place; complex taps
    take two launches (real and imaginary taps), combined afterwards;
  * ``lfilter_fir(method="direct")``, ``StreamFilter``, ``moving_average``
    and ``complex_moving_sum`` are upfirdn at up = down = 1, cut to the
    causal length, so on the card they run the same kernel in full f32
    (the JAX package computes them at Precision.HIGHEST; a cuDNN conv1d
    would be TF32 by default). ``method="fft"`` uses torch.fft.

``medfilt`` runs the median-filter kernel (``ops/hopper/medfilt.py``) for
1-D float input on the card, as the JAX package does on the TPU.

``select_upfirdn_path`` and ``select_medfilt_path`` make the routing
decisions and say why: ``"upfirdn-hopper"``/``"medfilt-hopper"`` or
``"plain"`` (CPU tensors take each kernel's plain twin). A CUDA tensor on a
kernel route launches the kernel or raises.

The TPU's ``prec="bf16x3"`` kernel mode, a measured negative result on the
TPU (its dot results are bf16-rounded whatever the operand split), has no
counterpart: the kernel accumulates in f32 FMA.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.hopper.medfilt import (medfilt_kernel,
                                                        medfilt_plain,
                                                        medfilt_plan)
from pydsproutines_tpu_torch.ops.hopper.upfirdn import (get_upfirdn_size,
                                                        upfirdn_plan,
                                                        upfirdn_planes)
from pydsproutines_tpu_torch.ops.hopper.upfirdn import \
    plan_text as upfirdn_plan_text
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for, to_tensor
from pydsproutines_tpu_torch.utils.fftlen import next_fast_len

__all__ = ["lfilter_fir", "StreamFilter", "stream_lfilter_step",
           "get_upfirdn_size", "upfirdn", "fir_upfirdn",
           "fir_upfirdn_planes_flat", "StreamUpfirdn",
           "resample_factor_wizard", "moving_average", "multi_moving_average",
           "complex_moving_sum", "medfilt", "select_upfirdn_path",
           "select_medfilt_path"]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def select_upfirdn_path(n: int, taps_len: int, up: int, down: int,
                        dtype: torch.dtype, device) -> tuple[str, str]:
    """The routing decision of the upfirdn family for an ``n``-sample input
    whose result type (input and taps promoted) is ``dtype``: (path,
    reason)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain", f"{device.type} tensor: plain torch twin"
    rdt = _work_real_dtype(dtype)
    n_out = get_upfirdn_size(n, taps_len, up, down)
    pair = dtype.is_complex and rdt == torch.float32
    plan = upfirdn_plan(taps_len, up, down, 8 if rdt == torch.float64 else 4,
                        2 if pair else 1)
    return "upfirdn-hopper", (
        f"n={n} -> n_out={n_out}, {taps_len} taps, up={up}, down={down}, "
        f"{rdt} planes: Hopper upfirdn kernel, any tap length, "
        f"{upfirdn_plan_text(plan)}; the TPU kernel's gate (n_out >= "
        f"2*128*cols, <= 2 planes) does not apply")


def select_medfilt_path(ndim: int, dtype: torch.dtype, device,
                        kernel_size: int = 3) -> tuple[str, str]:
    """The routing decision of ``medfilt``: (path, reason)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain", f"{device.type} tensor: plain torch twin"
    if ndim != 1:
        return "plain", (f"{ndim}-D input: the kernel filters 1-D signals "
                         f"(the JAX package sends only 1-D float input to "
                         f"its kernel); plain torch along the last axis")
    if not dtype.is_floating_point:
        return "plain", (f"dtype {dtype}: the kernel takes real float input "
                         f"(integer input takes plain torch.median)")
    if dtype == torch.float64:
        how = "64 key bits"
    elif dtype == torch.float32:
        how = "32 key bits"
    else:
        how = "32 key bits, filtered as float32 and cast back (exact)"
    plan = medfilt_plan(kernel_size, 8 if dtype == torch.float64 else 4)
    if plan["route"] == "tile":
        method = (f"tile-shared sort and select, C={plan['c']} outputs a "
                  f"tile share a sorted core of {kernel_size - plan['c'] + 1}"
                  f" keys, {plan['smem']} B of shared memory a block")
    else:
        method = (f"{plan['route']} select: a tile's core of about "
                  f"{kernel_size} keys is past one warp's sort, so each "
                  f"output walks its key bits over its window"
                  + (" read from device memory"
                     if plan["route"] == "radix-unstaged" else ""))
    return "medfilt-hopper", (f"1-D {dtype}, k={kernel_size}: Hopper median "
                              f"kernel, {how}, any odd k; {method}")


# ---------------------------------------------------------------------------
# upfirdn core
# ---------------------------------------------------------------------------

def _work_real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The kernel's plane type for a result type: float32 or float64."""
    return real_dtype_for(torch.promote_types(dtype, torch.float32))


def _upfirdn_rows(taps: torch.Tensor, x: torch.Tensor, up: int, down: int,
                  n_out: int) -> torch.Tensor:
    """First ``n_out`` outputs of scipy's upfirdn of the 1-D ``x`` or of
    each row of the 2-D ``x``, in the promoted type of taps and input
    (computed in at least float32)."""
    if x.ndim == 1:
        return _upfirdn_rows(taps, x[None], up, down, n_out)[0]
    res = torch.promote_types(x.dtype, taps.dtype)
    rdt = _work_real_dtype(res)
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    x_c = x.is_complex()
    xw = x.to(cdt if x_c else rdt)
    planes = (xw.real, xw.imag) if x_c else (xw,)
    if not taps.is_complex():
        out = torch.empty((x.shape[0], n_out), dtype=xw.dtype,
                          device=x.device)
        upfirdn_planes(planes, taps.to(rdt), up, down, n_out,
                       (out.real, out.imag) if x_c else (out,))
        return out.to(res)
    yr, yi = (upfirdn_planes(planes, h.to(rdt), up, down, n_out)
              for h in (taps.real, taps.imag))          # two launches
    if x_c:
        out = torch.complex(yr[0] - yi[1], yr[1] + yi[0])
    else:
        out = torch.complex(yr[0], yi[0])
    return out.to(res)


# ---------------------------------------------------------------------------
# FIR filtering
# ---------------------------------------------------------------------------

def _conv_causal(taps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., i] = sum_k taps[k] x[..., i-k], len(y) == len(x)."""
    taps = to_tensor(taps, x.device)
    x2 = x.reshape(-1, x.shape[-1])
    y = _upfirdn_rows(taps, x2, 1, 1, x.shape[-1])
    return y.reshape(*x.shape[:-1], x.shape[-1])


def _conv_full_fft(taps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of 1-D ``taps`` with 1-D ``x`` by torch.fft."""
    n = x.shape[-1] + taps.shape[-1] - 1
    nfft = next_fast_len(n)
    res = torch.promote_types(taps.dtype, x.dtype)
    cdt = torch.promote_types(res, torch.complex64)
    X = torch.fft.fft(x.to(cdt), nfft)
    H = torch.fft.fft(taps.to(cdt), nfft)
    y = torch.fft.ifft(X * H)[:n]
    if not res.is_complex:
        y = y.real
    return y.to(res)


def lfilter_fir(taps, x: torch.Tensor, method: str = "direct"
                ) -> torch.Tensor:
    """FIR filter: y[n] = sum_k taps[k] * x[n-k], output length == len(x).

    ``method``: "direct" (the upfirdn kernel at up = down = 1 on the card,
    its twin on the CPU) or "fft" (torch.fft overlap)."""
    taps = to_tensor(taps, x.device)
    if method == "direct":
        return _conv_causal(taps, x)
    return _conv_full_fft(taps, x)[: x.shape[-1]]


class StreamFilter:
    """Streaming FIR filter with an explicit delay-line carry.

    Successive calls to :meth:`lfilter` on contiguous blocks give the same
    output as one call on the concatenated signal. The state lives on
    ``device``, ``cuda`` when None."""

    def __init__(self, taps, dtype: torch.dtype = torch.complex64,
                 device=None):
        self.taps = to_tensor(taps, resolve_device(device))
        self.dtype = dtype
        self.delay = torch.zeros(self.taps.shape[-1], dtype=dtype,
                                 device=self.taps.device)

    @classmethod
    def from_numpy_params(cls, params: dict, device=None) -> "StreamFilter":
        """Continue a stream from ``{"taps": ..., "delay": ...}``, numpy
        copies of a JAX ``StreamFilter``'s state (``np.asarray(sf.taps)``,
        ``np.asarray(sf.delay)``)."""
        delay = to_tensor(params["delay"], resolve_device(device))
        sf = cls(params["taps"], dtype=delay.dtype, device=device)
        sf.delay = delay
        return sf

    def reset(self):
        self.delay = torch.zeros_like(self.delay)

    def lfilter(self, x) -> torch.Tensor:
        x = to_tensor(x, self.taps.device).to(self.dtype)
        y, self.delay = stream_lfilter_step(self.taps, x, self.delay)
        return y


def stream_lfilter_step(taps: torch.Tensor, x: torch.Tensor,
                        delay: torch.Tensor):
    """One streaming FIR block step. Returns (filtered block, new delay).

    ``delay`` holds the last len(taps) input samples of the previous
    block."""
    t = taps.shape[-1]
    xp = torch.cat([delay, x])
    c = _conv_causal(taps, xp)
    return c[t: t + x.shape[-1]], xp[-t:].clone()


# ---------------------------------------------------------------------------
# upfirdn — scipy-size-compatible rational resampling
# ---------------------------------------------------------------------------

def upfirdn(taps, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Upsample-filter-downsample identical to scipy.signal.upfirdn, on 1-D
    input or row-wise on 2-D input; real or complex taps and input. The
    zero-stuffed signal is never built."""
    taps = to_tensor(taps, x.device)
    n_out = get_upfirdn_size(x.shape[-1], taps.shape[-1], up, down)
    return _upfirdn_rows(taps, x, int(up), int(down), n_out)


def _host_bytes(a: torch.Tensor) -> bytes:
    if a.is_complex():
        raise ValueError("the host tap combination takes real taps")
    return np.ascontiguousarray(a.detach().cpu().numpy(),
                                dtype=np.float64).tobytes()


@functools.lru_cache(maxsize=32)
def _combine(fir: bytes, rs: bytes, up: int) -> np.ndarray:
    f = np.frombuffer(fir, np.float64)
    hu = np.zeros(f.size * up - (up - 1), np.float64)
    hu[::up] = f
    return np.convolve(hu, np.frombuffer(rs, np.float64))


def combined_taps(fir_taps, rs_taps, up: int) -> np.ndarray:
    """conv(upsample(fir_taps, up), rs_taps) in float64 on the host (the
    JAX package's host tap pipeline), cached per tap tuple. Each caller
    gets its own copy of the cached array."""
    return _combine(_host_bytes(to_tensor(fir_taps)),
                    _host_bytes(to_tensor(rs_taps)), int(up)).copy()


def fir_upfirdn(fir_taps, rs_taps, x: torch.Tensor, up: int,
                down: int) -> torch.Tensor:
    """FIR filter + polyphase resample as ONE upfirdn with the combined
    taps conv(upsample(fir_taps, up), rs_taps).

    The output length is the two-op chain's. The fused form applies the
    full FIR convolution, so the last ceil((len(rs_taps) - 1) / down)
    samples differ from ``upfirdn(rs_taps, lfilter_fir(fir_taps, x))``
    (the fused values are scipy's full-conv ones)."""
    fir_taps, rs_taps = to_tensor(fir_taps), to_tensor(rs_taps)
    if fir_taps.is_complex() or rs_taps.is_complex():
        return upfirdn(rs_taps, lfilter_fir(fir_taps, x), up, down)
    h = torch.from_numpy(combined_taps(fir_taps, rs_taps, up)).to(
        device=x.device,
        dtype=torch.promote_types(fir_taps.dtype, rs_taps.dtype))
    n_out = get_upfirdn_size(x.shape[-1], rs_taps.shape[-1], up, down)
    return _upfirdn_rows(h, x, int(up), int(down), n_out)


def fir_upfirdn_planes_flat(fir_taps, rs_taps, re: torch.Tensor,
                            im: torch.Tensor, up: int, down: int):
    """The fused FIR + resample chain on flat quadrature planes: the same
    numbers as ``fir_upfirdn`` on ``re + 1j*im``, as (re, im) float32 output
    planes of the two-op chain's length. The complex array never
    materializes and only the chain-length output is computed. Real taps
    only; they are combined on the host in float64 once per tap tuple."""
    rs_taps = to_tensor(rs_taps)
    h32 = torch.from_numpy(combined_taps(fir_taps, rs_taps, up).astype(
        np.float32)).to(re.device)
    n_out = get_upfirdn_size(re.shape[-1], rs_taps.shape[-1], up, down)
    return upfirdn_planes((re.to(torch.float32), im.to(torch.float32)), h32,
                          int(up), int(down), n_out)


class StreamUpfirdn:
    """Streaming upfirdn with delay memory: each block is prepended with the
    previous block's tail and the warm-up region is skipped, so contiguous
    blocks concatenate seamlessly. The state lives on ``device``, ``cuda``
    when None."""

    def __init__(self, taps, up: int, down: int, memory: int,
                 dtype: torch.dtype = torch.complex64, device=None):
        self.taps = to_tensor(taps, resolve_device(device))
        self.up = int(up)
        self.down = int(down)
        self.memory = int(memory)
        self.dtype = dtype
        self.delay = torch.zeros(self.memory, dtype=dtype,
                                 device=self.taps.device)

    @classmethod
    def from_numpy_params(cls, params: dict, device=None) -> "StreamUpfirdn":
        """Continue a stream from ``{"taps", "up", "down", "memory",
        "delay"}``, numpy copies of a JAX ``StreamUpfirdn``'s state."""
        delay = to_tensor(params["delay"], resolve_device(device))
        su = cls(params["taps"], params["up"], params["down"],
                 params["memory"], dtype=delay.dtype, device=device)
        su.delay = delay
        return su

    def reset(self):
        self.delay = torch.zeros_like(self.delay)

    def resample(self, x) -> torch.Tensor:
        x = to_tensor(x, self.taps.device).to(self.dtype)
        xext = torch.cat([self.delay, x])
        skip = self.memory * self.up // self.down
        length = x.shape[-1] * self.up // self.down
        out = _upfirdn_rows(self.taps, xext, self.up, self.down,
                            skip + length)
        self.delay = x[-self.memory:].clone()
        return out[skip: skip + length]


def resample_factor_wizard(fs: int, rsfs: int) -> tuple[int, int]:
    """Smallest integer (up, down) factors taking sample rate ``fs`` to
    ``rsfs``."""
    g = math.gcd(int(fs), int(rsfs))
    return int(rsfs) // g, int(fs) // g


# ---------------------------------------------------------------------------
# Moving sums / averages
# ---------------------------------------------------------------------------

def moving_average(x: torch.Tensor, length: int,
                   sum_instead: bool = False) -> torch.Tensor:
    """Causal moving average (or sum), output length == input length,
    zero-padded at the front: lfilter(ones(L)/L, 1, x). Row-wise on 2-D
    input."""
    rdt = real_dtype_for(x.dtype)
    window = _conv_causal(torch.ones(int(length), dtype=rdt,
                                     device=x.device), x)
    out = window if sum_instead else window / length
    return out.to(x.dtype)


multi_moving_average = moving_average  # row-wise by construction


def complex_moving_sum(x: torch.Tensor, length: int,
                       sum_instead: bool = True) -> torch.Tensor:
    """|moving window sum|^2 of a complex signal over forward windows,
    output length n - L + 1, in the real type of x."""
    rdt = real_dtype_for(x.dtype)
    window = _conv_causal(torch.ones(int(length), dtype=rdt,
                                     device=x.device), x)[length - 1:]
    if not sum_instead:
        window = window / length
    if window.is_complex():
        return (window.real * window.real
                + window.imag * window.imag).to(rdt)
    return (window * window).to(rdt)


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------

def medfilt(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """1-D median filter with zero padding, scipy.signal.medfilt semantics,
    bit-exact. 1-D float input on the card runs the radix-select kernel;
    integer or n-D input takes plain torch (``select_medfilt_path``)."""
    k = int(kernel_size)
    if k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    path, _ = select_medfilt_path(x.ndim, x.dtype, x.device, k)
    if path == "medfilt-hopper":
        return medfilt_kernel(x, k)
    return medfilt_plain(x, k)
