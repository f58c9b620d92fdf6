"""Sliding normalised matched filter (TPU kernel #7) and its plain twin.

Kernel: ``csrc/sliding.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/sliding.py:_kernel``: for every
template t and dense shift s,

    qf2[t, s] = |sum_n x[s+n] * conj(tmpl[t, n])|^2
                / sum_n |x[s+n]|^2 / ||tmpl_t||^2,

0 where the denominator is 0. The kernel sums each window's energy in f32
over its staged samples (as the TPU kernel does); the twin sums it in
float64 (not as a prefix-sum difference, whose cancellation is as large as
a short window's energy far into a long capture). Both are f32-grade
against float64 numpy: the tests hold them to 1e-5 absolute on the 0..1
QF^2 scale, the JAX kernel test's bound.

``sliding_multiply_normalised`` is the counterpart of the JAX
``ops.pallas.sliding`` function (its ``tile`` is accepted for the signature;
the kernel's tile is fixed). A CPU tensor takes the twin ``sliding_plain``;
a CUDA tensor launches the kernel (inputs computed as complex64, as the
JAX kernel computes in f32) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import full_f32, to_tensor
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# template-length cap of the JAX kernel (ops/pallas/sliding.py:40); the
# Hopper kernel stages up to 8 templates of this length in shared memory
MAX_TEMPLATE_LEN = 2048
# the twin's working set per (shift, sample): the unfolded window's
# contiguous copy for the product (complex64) and its slack
PLAIN_BYTES_PER_SAMPLE = 16


def _prepare(x, templates):
    """(x, 2-D templates) as tensors on x's device, after the JAX
    function's checks."""
    x = to_tensor(x)
    templates = to_tensor(templates, x.device)
    if templates.ndim == 1:
        templates = templates[None, :]
    if x.ndim != 1 or templates.ndim != 2:
        raise ValueError("x must be 1-D and templates (T, L)")
    tlen = templates.shape[1]
    if tlen > MAX_TEMPLATE_LEN:
        raise ValueError(
            f"template length {tlen} > {MAX_TEMPLATE_LEN}; use the FFT "
            "overlap-save xcorr path for long templates")
    if x.shape[-1] - tlen + 1 <= 0:
        raise ValueError("template longer than input")
    return x, templates


def sliding_plain(x: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """The twin: unfolded windows times the conjugated templates in full
    f32, window energies summed in float64, in chunks of shifts within the
    byte budget. Returns (T, N - L + 1) float32."""
    x, templates = _prepare(x, templates)
    tlen = templates.shape[1]
    ns = x.shape[0] - tlen + 1
    power = x.real.double() ** 2 + x.imag.double() ** 2
    tconj = templates.conj().T.to(x.dtype)
    tnorm = (templates.real.double() ** 2
             + templates.imag.double() ** 2).sum(-1)
    chunk = chunk_shifts(tlen, ns, PLAIN_BYTES_PER_SAMPLE)
    mags, energy = [], []
    with full_f32():
        for c0 in range(0, ns, chunk):
            w = x[c0: c0 + chunk + tlen - 1].unfold(0, tlen, 1)
            c = w @ tconj
            mags.append(c.real.double() ** 2 + c.imag.double() ** 2)
            energy.append(power[c0: c0 + chunk + tlen - 1].unfold(
                0, tlen, 1).sum(-1))
    den = torch.cat(energy)[:, None] * tnorm[None, :]
    mag = torch.cat(mags)
    out = torch.where(den > 0, mag / torch.where(den > 0, den, 1.0), 0.0)
    return out.T.contiguous().to(torch.float32)


def sliding_multiply_normalised(x: torch.Tensor, templates,
                                tile: int = 1024) -> torch.Tensor:
    """QF^2 of every template against every dense shift of ``x``.

    x : (N,) complex; templates : (T, L) complex, L <= 2048. Returns
    (T, N - L + 1) float32. ``tile`` is the JAX kernel's tile and is
    ignored (the Hopper kernel's is fixed at 1024 shifts per block)."""
    del tile
    x, templates = _prepare(x, templates)
    if x.device.type == "cpu":
        return sliding_plain(x, templates)
    if x.device.type != "cuda":
        raise ValueError(f"sliding_multiply_normalised: unsupported device "
                         f"{x.device}")
    return _sliding_cuda(x, templates)


sliding_multiply_normalised.launches = 0


def _sliding_cuda(x, templates):
    lib = _build.library()
    x = x.to(torch.complex64).contiguous()
    templates = templates.to(torch.complex64).contiguous()
    t, tlen = templates.shape
    ns = x.shape[0] - tlen + 1
    tnorm = (templates.real ** 2 + templates.imag ** 2).sum(-1)
    out = torch.empty((t, ns), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pdsp_sliding(x.data_ptr(), x.shape[0], templates.data_ptr(),
                              t, tlen, tnorm.data_ptr(), out.data_ptr(),
                              stream)
    _build.check(rc, f"sliding launch (n={x.shape[0]}, T={t}, L={tlen})")
    sliding_multiply_normalised.launches += 1
    return out


def sliding_multiply_normalised_reference(x, templates) -> np.ndarray:
    """Plain numpy version with the same semantics (a copy of the JAX
    package's, for the tests): float64 sums, float32 result."""
    x = np.asarray(x)
    templates = np.atleast_2d(np.asarray(templates))
    tlen = templates.shape[1]
    nshifts = x.shape[-1] - tlen + 1
    power = np.abs(x) ** 2
    energy = np.convolve(power, np.ones(tlen), mode="valid")
    out = np.zeros((templates.shape[0], nshifts), np.float32)
    for t in range(templates.shape[0]):
        corr = np.correlate(x, templates[t], mode="valid")
        tnorm = np.sum(np.abs(templates[t]) ** 2)
        out[t] = (np.abs(corr) ** 2 / energy[:nshifts] / tnorm).astype(
            np.float32)
    return out
