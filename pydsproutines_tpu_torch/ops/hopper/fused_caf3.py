"""CAF peak search over a shift list (TPU kernel #3) and its plain twin.

Kernel: ``csrc/fused_caf3.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/fused_caf3.py:_stage1_kernel`` and
``_stage23_kernel``. For each shift s of an int64 offset list it returns
``max_k |X_s[k]|^2`` and its true bin, with ``X_s = DFT_n(rx[s:s+n] *
conj(cutout))`` computed as an FFT in shared memory (``csrc/fft_smem.cuh``)
under ``ops/fft.caf_plan``: the fewest passes whose FFT lengths fit a
block, two at n = 10M = 1250 x 8000 (a column pass, a row pass with each
row's peak, a reduction), three only where no two-factor split fits. It is
bound by bytes: 32 bytes per (shift, sample) of window, template and one
scratch round trip, against the n*(f0 + f1 + f2) complex MACs of the dense
three-stage products it replaced.

The kernel reads rx only inside each window, so a sweep whose last window
ends at the end of rx needs no padding (the JAX route's padding fault,
``pydsproutines_tpu/ops/xcorr.py:362``, has no counterpart). Its complex64
scratch takes 8 bytes per (shift, sample), 80 MB per shift at 10M, so
shifts run in chunks within the byte budget (``utils.memory``).

Ties go to the lowest true bin, as ``torch.argmax`` on the natural-order
spectrum does (the TPU kernels take the first in their permuted order).

``caf3_peak`` routes by the tensor's device: a CPU tensor takes the plain
twin ``caf3_peak_plain`` (``torch.fft``); a CUDA tensor launches the kernel
or raises. ``ops/fft.caf_staged`` is the kernel's pass schedule in torch;
``caf3_staged`` is the JAX kernels' three-stage algebra over the tables of
``ops/fft.caf3_tables`` (``find_triple``), which the tests hold against the
TPU kernels.
"""

from __future__ import annotations

import functools

import torch

from pydsproutines_tpu_torch.ops.fft import (caf3_tables, find_triple,
                                             spectrum_peaks)
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.ops.hopper.fft_peak import (check_offsets,
                                                         require_c64)
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (
    SCRATCH_BYTES_PER_SAMPLE, caf_launch)
from pydsproutines_tpu_torch.utils.memory import chunk_shifts


def caf3_peak_plain(rx: torch.Tensor, cutout_conj: torch.Tensor,
                    offsets: torch.Tensor, batch: int = 128):
    """torch.fft twin of the kernel: (peak |X|^2 as float32, int64 bin) per
    offset, chunked by the byte budget."""
    # imported here: ops.xcorr imports this module for its kernel route
    from pydsproutines_tpu_torch.ops.xcorr import peak_search_plain

    check_offsets(rx, offsets, cutout_conj.shape[-1])
    return peak_search_plain(rx, cutout_conj, offsets, batch)


@functools.lru_cache(maxsize=4)
def _tables(triple: tuple[int, int, int], device: torch.device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in caf3_tables(*triple).items()}


def _triple(n: int) -> tuple[int, int, int]:
    triple = find_triple(n)
    if triple is None:
        raise ValueError(f"n={n} has no factor triple in [16, 1024] for the "
                         "three-stage CAF kernel")
    return triple


def caf3_staged(rx: torch.Tensor, cutout_conj: torch.Tensor,
                offsets: torch.Tensor, triple=None):
    """The JAX kernels' three-stage algebra (``find_triple``) in torch
    einsums over the complex64 tables of ``caf3_tables``: (peak |X|^2 as
    float32, int64 true bin) per offset. For tests at small n; it holds
    every (shift, n) intermediate at once."""
    n = cutout_conj.shape[-1]
    check_offsets(rx, offsets, n)
    f0, f1, f2 = triple or _triple(n)
    t = _tables((f0, f1, f2), rx.device)
    idx = offsets[:, None] + torch.arange(n, device=rx.device)[None, :]
    p = (rx[idx] * cutout_conj).reshape(-1, f0, f1, f2)
    s1 = torch.einsum("kn,bnij->bkij", t["w0"], p)
    s1 = s1 * t["a1"][None, :, :, None] * t["a2"][None, :, None, :]
    s2 = torch.einsum("ln,bkni->bkli", t["w1"], s1) * t["tw2"]
    x = torch.einsum("bkli,im->bklm", s2, t["w2"])   # (b, k0, k1, k2)
    return spectrum_peaks(x, (f0, f1, f2))


def caf3_peak(rx: torch.Tensor, cutout_conj: torch.Tensor,
              offsets: torch.Tensor, batch: int = 128):
    """(max_k |DFT(rx[s:s+n] * cutout_conj)[k]|^2 as float32, its bin as
    int64) for each s in the int64 ``offsets``, n = f0*f1*f2, in chunks of
    at most ``batch`` shifts whose scratch fits the byte budget."""
    if rx.ndim != 1 or cutout_conj.ndim != 1:
        raise ValueError("caf3_peak takes 1-D rx and cutout")
    if rx.device != cutout_conj.device:
        raise ValueError(f"rx on {rx.device}, cutout on {cutout_conj.device}")
    if rx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"caf3_peak: unsupported device {rx.device}")
    check_offsets(rx, offsets, cutout_conj.shape[-1])
    if rx.device.type == "cpu":
        return caf3_peak_plain(rx, cutout_conj, offsets, batch)
    return _caf3_peak_cuda(rx, cutout_conj, offsets.contiguous(), batch)


caf3_peak.launches = 0


def _caf3_peak_cuda(rx, cutout_conj, offsets, batch):
    lib = _build.library()
    n = cutout_conj.shape[-1]
    require_c64(rx, cutout_conj)
    dev = rx.device
    launch = caf_launch(n, dev)
    num = offsets.shape[0]
    nb_max = chunk_shifts(n, min(batch, num), SCRATCH_BYTES_PER_SAMPLE)
    scratch, rowmax, rowarg = launch.buffers(nb_max, dev)
    out_max = torch.empty(num, dtype=torch.float32, device=dev)
    out_bin = torch.empty(num, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, num, nb_max):
            nb = min(nb_max, num - c0)
            rc = lib.pdsp_caf3_peak(
                rx.data_ptr(), cutout_conj.data_ptr(),
                offsets[c0:].data_ptr(), *launch.args(), scratch.data_ptr(),
                rowmax.data_ptr(), rowarg.data_ptr(),
                out_max[c0:].data_ptr(), out_bin[c0:].data_ptr(), nb, stream)
            _build.check(rc, f"caf3_peak launch (n={n}, chunk at {c0})")
            caf3_peak.launches += 1
    return out_max, out_bin.long()
