"""Group cross-correlation CAF kernel (TPU kernel #8) and its plain twin.

Kernel: ``csrc/group_caf.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/group_caf.py:_kernel`` and computes
the contract it shares with that module's ``group_caf_tonedot``: for each
shift offset o_b,

    C[b, f] = sum_g sum_t rx[o_b + starts[g] + t] * tfold[g*m + t, f],

returning |C|^2 as float32 (B, k). ``tfold`` (G*m, k) is the conjugated,
zero-padded template times the CZT tone bank times the group phases, folded
on the host (``ops/groupxcorr.fold_tone_bank``). The product against the
tone bank is computed in the kernel: no cuBLAS, no ``torch.matmul``. The
kernel's launcher splits the depth G*m into slabs so that enough blocks are
in flight, within the scratch this wrapper gives it; the slabs are summed
coherently, in order, before |.|^2 (see the source). ``group_caf.splits``
holds the split of the last launch.

``group_caf`` routes by the tensor's device: a CPU tensor takes the twin
``group_caf_plain``; a CUDA tensor launches the kernel or raises. Samples
outside rx read as zero, in the kernel and in the twin alike, so no shift
needs a range check here (callers check theirs once: ``GroupXcorrCZT.xcorr``).
QF^2 normalisation is the caller's.
"""

from __future__ import annotations

import ctypes

import torch

from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import full_f32, real_dtype_for
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# the most depth slabs this wrapper holds scratch for (complex64, per shift
# and bin); the launcher chooses how many of them to use
SCRATCH_SLABS = 32
# the twin's working set per (shift, sample): the gather's index, its
# clamped copy and mask, the gathered windows and their masked copy
PLAIN_BYTES_PER_SAMPLE = 40


def _check(rx, offsets, starts, tfold, k):
    if rx.ndim != 1 or not rx.is_complex():
        raise ValueError("group_caf takes a 1-D complex rx")
    if offsets.ndim != 1 or starts.ndim != 1 or offsets.shape[0] < 1:
        raise ValueError("group_caf takes 1-D offsets and starts")
    if offsets.dtype != torch.int64 or starts.dtype != torch.int64:
        raise ValueError("group_caf takes int64 offsets and starts")
    g = starts.shape[0]
    if tfold.ndim != 2 or tfold.shape[1] != k or tfold.shape[0] % g:
        raise ValueError(f"tfold has shape {tuple(tfold.shape)}, expected "
                         f"({g}*m, {k})")
    if len({rx.device, offsets.device, starts.device, tfold.device}) != 1:
        raise ValueError("group_caf inputs lie on different devices")
    if rx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_caf: unsupported device {rx.device}")


def group_windows(rx: torch.Tensor, offsets: torch.Tensor,
                  starts: torch.Tensor, m: int) -> torch.Tensor:
    """(B, G, m) windows rx[o_b + starts[g] : + m]; samples outside rx
    read as zero, as in the kernel. Nothing here waits on the device."""
    idx = (offsets[:, None, None] + starts[None, :, None]
           + torch.arange(m, device=rx.device)[None, None, :])
    inside = (idx >= 0) & (idx < rx.shape[0])
    return torch.where(inside, rx[idx.clamp(0, rx.shape[0] - 1)],
                       rx.new_zeros(()))


def group_caf_plain(rx: torch.Tensor, offsets: torch.Tensor,
                    starts: torch.Tensor, tfold: torch.Tensor, k: int,
                    batch: int = 1 << 30) -> torch.Tensor:
    """The twin: the gathered windows (B, G*m) times tfold (G*m, k) in
    full f32, then |.|^2, in chunks of at most ``batch`` shifts within the
    byte budget."""
    g = starts.shape[0]
    m = tfold.shape[0] // g
    chunk = chunk_shifts(g * m, min(batch, offsets.shape[0]),
                         PLAIN_BYTES_PER_SAMPLE)
    rows = []
    with full_f32():
        for c0 in range(0, offsets.shape[0], chunk):
            wins = group_windows(rx, offsets[c0: c0 + chunk], starts, m)
            c = wins.reshape(wins.shape[0], g * m) @ tfold
            rows.append(c.real * c.real + c.imag * c.imag)
    return torch.cat(rows).to(real_dtype_for(tfold.dtype))


def group_caf(rx: torch.Tensor, offsets: torch.Tensor, starts: torch.Tensor,
              tfold: torch.Tensor, k: int) -> torch.Tensor:
    """|C|^2 (B, k) of the group CAF at the shift offsets ``offsets`` (see
    the module docstring). CPU tensors take the twin; CUDA tensors launch
    the kernel."""
    _check(rx, offsets, starts, tfold, k)
    if rx.device.type == "cpu":
        return group_caf_plain(rx, offsets, starts, tfold, k)
    return _group_caf_cuda(rx, offsets, starts, tfold, k)


group_caf.launches = 0
group_caf.splits = 0


def _group_caf_cuda(rx, offsets, starts, tfold, k):
    lib = _build.library()
    if rx.dtype != torch.complex64 or tfold.dtype != torch.complex64:
        raise ValueError("the group CAF kernel takes complex64 "
                         f"(got {rx.dtype}, {tfold.dtype})")
    if tfold.shape[0] >= 2**31:
        raise ValueError("G*m too large for the kernel's 32-bit depth")
    rx, offsets = rx.contiguous(), offsets.contiguous()
    starts, tfold = starts.contiguous(), tfold.contiguous()
    g = starts.shape[0]
    m = tfold.shape[0] // g
    nb = offsets.shape[0]
    dev = rx.device
    chunk = chunk_shifts(k, nb, 8 * SCRATCH_SLABS)
    part = torch.empty(SCRATCH_SLABS * min(chunk, nb) * k,
                       dtype=torch.complex64, device=dev)
    out = torch.empty((nb, k), dtype=torch.float32, device=dev)
    splits = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, nb, chunk):
            b = min(chunk, nb - c0)
            rc = lib.pdsp_group_caf(
                rx.data_ptr(), rx.shape[0], offsets[c0:].data_ptr(), b,
                starts.data_ptr(), g, m, tfold.data_ptr(), k, part.data_ptr(),
                part.numel(), out[c0:].data_ptr(), ctypes.addressof(splits),
                stream)
            _build.check(rc, f"group_caf launch (G={g}, m={m}, k={k}, "
                             f"chunk at {c0})")
            group_caf.launches += 1
            group_caf.splits = splits.value
    return out
