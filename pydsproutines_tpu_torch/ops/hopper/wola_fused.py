"""WOLA channelizer kernel (N == Dec) and its plain PyTorch twin.

Kernel: ``csrc/wola_fused.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/wola_fused.py:_kernel`` and
``:_kernel_direct`` and computes, in one pass over the input,

    out[r, k] = sum_a dft_in[r, a] * exp(+2*pi*i*a*k/N)
    dft_in[r, a] = sum_b x[r*N - b*N - a] * h[b*N + a],   x = 0 before 0.

Its schedule (``wola_plan``): a block owns a chunk of ``rc`` rows; a thread
folds one column over a run of ``RUN`` = 8 rows in registers, with ``kb``
taps of its column held at a time (the B taps in chunks of kb, zero past
B), into the row's digit-reversed slot; then one shared-memory line FFT a
row (``csrc/fft_smem.cuh``, the radices of ``ops/fft.radix_plan``) takes the
N * IDFT as conj(FFT(conj(.))). ``wola_staged`` runs that schedule in torch
over the kernel's own tables, for the tests.

The kernel has two instances, one per I/O layout, with one fold and FFT:
``wola_fused`` takes a complex64 input and returns complex64 rows;
``wola_fused_planes`` takes and returns float32 quadrature planes, the TPU
kernel's own I/O (``wola_fused_planes2`` / ``wola_fused_planes_flat``), so
a plane caller pays no interleave or split. On the same samples the two
give bit-identical outputs.

Each wrapper routes by the tensor's device: a CPU tensor takes the plain
twin (``wola_plain``; ``wola_planes_plain`` on the planes); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.fft import (digit_reversal, fft_staged,
                                             line_table, radix_plan)
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for

# the kernel's threads a block, output rows a thread's run, the taps a
# thread may hold in registers, and a block's shared-memory limit
THREADS, RUN, MAX_KB, MAX_SMEM = 256, 8, 32, 227 * 1024
FAST_RADICES = (2, 3, 4, 5, 8)


def wola_plain(f_tap: torch.Tensor, x: torch.Tensor, dec: int,
               n: int) -> torch.Tensor:
    """N * IDFT_N of the polyphase fold, for N == Dec or N == 2*Dec (the odd
    row flip of N == 2*Dec is the caller's). Returns (len(x)//dec, n).

    With y[r, a] = x[r*dec - a] (zero before 0), the fold is a B-tap FIR down
    each column of y at a row stride of q = n/dec:
    dft_in[r, a] = sum_b h[b*n + a] * y[r - b*q, a].

    Complex taps stay complex (the JAX N == 2*Dec fold keeps them so,
    ``pydsproutines_tpu/ops/wola.py:82``); real taps take x's real dtype.
    """
    taps = f_tap.shape[-1]
    nb, q = taps // n, n // dec
    rows = x.shape[-1] // dec
    hdt = x.dtype if f_tap.is_complex() else real_dtype_for(x.dtype)
    h = f_tap.to(hdt).reshape(nb, n)
    xp = torch.cat([x.new_zeros(n), x[: rows * dec]])
    # y_rev[r, j] = xp[1 + r*dec + j] = x[r*dec - (n-1-j)]
    y = xp.as_strided((rows, n), (dec, 1), xp.storage_offset() + 1).flip(-1)
    acc = y * h[0]
    for b in range(1, nb):
        if b * q >= rows:
            break
        acc[b * q:] += y[: rows - b * q] * h[b]
    return torch.fft.ifft(acc, dim=-1) * n


@functools.lru_cache(maxsize=64)
def wola_plan(n: int, nb: int) -> dict:
    """The kernel's schedule for N = ``n`` channels and B = ``nb`` taps a
    channel: ``radices`` of the row FFT (none at N = 1), ``kb`` taps a
    thread holds (the power of two >= B, at most MAX_KB), ``tap_chunks``
    (ceil(B / kb)), ``rc`` rows a chunk (RUN rows times max(1, THREADS // n)
    runs), ``smem`` bytes a block (the chunk's rows at line stride n|1,
    twice for a generic radix) and the ``route`` name. Raises ValueError
    when a chunk does not fit shared memory."""
    if n < 1 or nb < 1:
        raise ValueError(f"WOLA plan needs N >= 1 and B >= 1 (got {n}, {nb})")
    radices = radix_plan(n) if n > 1 else ()
    kb = min(MAX_KB, 1 << (nb - 1).bit_length())
    rc = RUN * max(1, THREADS // n)
    generic = any(r not in FAST_RADICES for r in radices)
    smem = rc * (n | 1) * 8 * (2 if generic else 1)
    if smem > MAX_SMEM:
        raise ValueError(f"N={n}: a chunk of {rc} rows needs {smem} B of "
                         f"shared memory (> {MAX_SMEM})")
    return {"route": "fold-fft", "radices": radices, "kb": kb,
            "tap_chunks": -(-nb // kb), "rc": rc, "smem": smem,
            "generic": generic}


def plan_text(plan: dict) -> str:
    """One line naming the route and its plan, for routers and logs."""
    rad = "x".join(map(str, plan["radices"])) or "none (N = 1)"
    return (f"register fold ({plan['kb']} taps a thread, "
            f"{plan['tap_chunks']} chunk(s), runs of {RUN} rows) + "
            f"shared-memory FFT (radices {rad}), {plan['rc']} rows a chunk, "
            f"{plan['smem']} B of shared memory")


def fold_sources(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold's index map: column a of the folded row r reads, at tap b,
    xq[r - b - shift[a], col[a]] with xq = x viewed as (rows, n): column 0
    and no shift for a == 0, column n - a one row back for a >= 1."""
    a = torch.arange(n)
    return torch.where(a == 0, 0, n - a), (a != 0).long()


def wola_staged(f_tap: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's schedule in torch, for complex64 x and real taps: per
    run of RUN rows and column a, the tap chunks of kb taps, and in each the
    RUN + kb - 1 rows of xq the run reaches (zero before row 0 and from row
    ``rows`` on), each added to the accumulators it feeds; then the
    conjugated fold through ``ops/fft.fft_staged`` over the kernel's line
    table and radices, conjugated back. Returns (len(x)//n, n)."""
    rows, nb = x.shape[-1] // n, f_tap.shape[-1] // n
    plan = wola_plan(n, nb)
    kb = plan["kb"]
    rpad = -(-rows // plan["rc"]) * plan["rc"]
    xq = x[: rows * n].reshape(rows, n)
    h = torch.zeros(plan["tap_chunks"] * kb, n, dtype=torch.float32)
    h[:nb] = f_tap.to(torch.float32).reshape(nb, n)
    col, shift = fold_sources(n)
    run0 = torch.arange(0, rpad, RUN)[:, None]               # (runs, 1)
    acc = torch.zeros(rpad // RUN, RUN, n, dtype=x.dtype)
    for c in range(plan["tap_chunks"]):
        hk = h[c * kb: (c + 1) * kb]                          # (kb, n)
        q0 = run0 - shift[None, :] - c * kb - (kb - 1)        # (runs, n)
        for i in range(RUN + kb - 1):
            q = q0 + i
            ok = (q >= 0) & (q < rows)
            v = torch.where(ok, xq[q.clamp(0, max(rows - 1, 0)), col], 0)
            lo, hi = max(0, i - kb + 1), min(RUN, i + 1)      # outputs fed
            taps = hk[kb - 1 - i + lo: kb - 1 - i + hi]       # m - i + kb - 1
            acc[:, lo:hi] += taps[None] * v[:, None, :]
    rad = plan["radices"]
    wl = torch.from_numpy(line_table(n, rad))
    y = fft_staged(acc.reshape(rpad, n).conj().resolve_conj(), rad, wl)
    return y[:rows].conj().resolve_conj()


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


def _check_planes(f_tap: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
                  n: int) -> None:
    if f_tap.ndim != 1 or f_tap.is_complex():
        raise ValueError("wola_fused_planes takes real 1-D taps")
    if re.ndim != 1 or re.is_complex() or re.shape != im.shape \
            or re.dtype != im.dtype:
        raise ValueError("wola_fused_planes takes two real 1-D planes of one "
                         f"shape and dtype (got {tuple(re.shape)} "
                         f"{re.dtype}, {tuple(im.shape)} {im.dtype})")
    if n < 1 or f_tap.shape[-1] % n != 0:
        raise ValueError(f"tap length {f_tap.shape[-1]} is not a multiple "
                         f"of N={n}")
    if not f_tap.device == re.device == im.device:
        raise ValueError(f"taps on {f_tap.device}, planes on {re.device} "
                         f"and {im.device}")


def wola_planes_plain(f_tap: torch.Tensor, re: torch.Tensor,
                      im: torch.Tensor, n: int):
    """Plain twin of ``wola_fused_planes``: ``wola_plain`` on the
    interleaved samples, split into (rows, n) planes."""
    out = wola_plain(f_tap, torch.complex(re, im), n, n)
    return out.real.contiguous(), out.imag.contiguous()


def wola_fused_planes(f_tap: torch.Tensor, re: torch.Tensor,
                      im: torch.Tensor, n: int):
    """Critically sampled WOLA channelize (N == Dec) of float32 quadrature
    planes: (out_re, out_im), each (len(re)//n, n) float32, with the same
    numbers as ``wola_fused(f_tap, torch.complex(re, im), n)``. CPU tensors
    take the plain twin; CUDA tensors launch the kernel's plane instance."""
    _check_planes(f_tap, re, im, n)
    if re.device.type == "cpu":
        return wola_planes_plain(f_tap, re, im, n)
    if re.device.type != "cuda":
        raise ValueError(f"wola_fused_planes: unsupported device {re.device}")
    return _wola_fused_planes_cuda(f_tap, re, im, n)


wola_fused_planes.launches = 0


@functools.lru_cache(maxsize=8)
def _tables(n: int, device: torch.device):
    """(line table, digit reversal, radices as C ints) of the N-point row
    FFT, on ``device``."""
    rad = wola_plan(n, 1)["radices"]
    wl = torch.from_numpy(line_table(n, rad)).to(device)
    rev = torch.from_numpy(digit_reversal(n, rad)).to(device)
    return wl, rev, (ctypes.c_int * max(1, len(rad)))(*rad)


def _launch(lib, entry: str, f_tap: torch.Tensor, ins, outs, rows: int,
            n: int) -> None:
    """Launch the instance behind C entry ``entry`` on the input and
    output pointers of ``ins`` / ``outs`` (rows >= 1)."""
    nb = f_tap.shape[-1] // n
    plan = wola_plan(n, nb)
    wl, rev, rad = _tables(n, f_tap.device)
    with torch.cuda.device(f_tap.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in ins), f_tap.data_ptr(), wl.data_ptr(),
            rev.data_ptr(), *(t.data_ptr() for t in outs), rows, n, nb,
            ctypes.addressof(rad), len(plan["radices"]), plan["kb"],
            plan["rc"], stream)
    _build.check(rc, f"{entry} launch (rows={rows}, n={n}, B={nb})")


def _wola_fused_cuda(f_tap: torch.Tensor, x: torch.Tensor,
                     n: int) -> torch.Tensor:
    lib = _build.library()
    if x.dtype != torch.complex64 or f_tap.dtype != torch.float32:
        raise ValueError("the WOLA kernel takes complex64 input and float32 "
                         f"taps (got {x.dtype}, {f_tap.dtype})")
    if not (x.is_contiguous() and f_tap.is_contiguous()):
        raise ValueError("the WOLA kernel takes contiguous tensors")
    rows = x.shape[-1] // n
    out = torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    _launch(lib, "pdsp_wola_fused", f_tap, (x,), (out,), rows, n)
    wola_fused.launches += 1
    return out


def _wola_fused_planes_cuda(f_tap: torch.Tensor, re: torch.Tensor,
                            im: torch.Tensor, n: int):
    lib = _build.library()
    if re.dtype != torch.float32 or f_tap.dtype != torch.float32:
        raise ValueError("the WOLA kernel's plane instance takes float32 "
                         f"planes and taps (got {re.dtype}, {f_tap.dtype})")
    if not (re.is_contiguous() and im.is_contiguous()
            and f_tap.is_contiguous()):
        raise ValueError("the WOLA kernel takes contiguous tensors")
    rows = re.shape[-1] // n
    out = torch.empty((2, rows, n), dtype=torch.float32, device=re.device)
    if rows == 0:
        return out[0], out[1]
    _launch(lib, "pdsp_wola_fused_planes", f_tap, (re, im),
            (out[0], out[1]), rows, n)
    wola_fused_planes.launches += 1
    return out[0], out[1]


def wola_direct_cuda(f_tap: torch.Tensor, x: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The kernel's first version (a direct IDFT sum), kept in
    ``csrc/wola_fused.cu`` for ``scripts/exp_wola.py``'s same-call
    comparison; the port's routes never call it."""
    lib = _build.library()
    _check(f_tap, x, n)
    rows = x.shape[-1] // n
    if rows * n >= 2**31:
        raise ValueError("the first version indexes rows in 32 bits")
    m = np.arange(n, dtype=np.float64)
    tw = torch.from_numpy(np.exp(2j * np.pi * m / n).astype(
        np.complex64)).to(x.device)
    out = torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    rc = lib.pdsp_wola_direct(x.data_ptr(), f_tap.data_ptr(), tw.data_ptr(),
                              out.data_ptr(), rows, n, f_tap.shape[-1] // n,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"wola direct launch (rows={rows}, n={n})")
    return out
