"""Group cross-correlation CAF kernel (TPU kernel #8) and its plain twin.

Kernel: ``csrc/group_caf.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/group_caf.py:_kernel`` and computes
the contract it shares with that module's ``group_caf_tonedot``: for each
shift offset o_b,

    C[b, f] = sum_g sum_t rx[o_b + starts[g] + t] * tfold[g*m + t, f],

returning |C|^2 as float32 (B, k). ``tfold`` (G*m, k) is the conjugated,
zero-padded template times the CZT tone bank times the group phases, folded
on the host (``ops/groupxcorr.fold_tone_bank``). The product against the
tone bank is computed in the kernel, a complex GEMM on the tensor cores
(wgmma) in 3xTF32 (each f32 operand split into a TF32 hi and lo, each
product taken as lo*hi + hi*lo + hi*hi with f32 accumulation, each 32-deep
step's sum added to the running one by round-to-nearest f32 adds): no
cuBLAS, no
``torch.matmul``. The kernel reads tfold already split, as ``tf32_planes``
lays it out (``GroupXcorrCZT`` splits it once, at plan build); a call with
no planes splits tfold first. The launcher splits the depth G*m into slabs
so that enough blocks are in flight, within the scratch this wrapper gives
it; the slabs are summed coherently, in order, before |.|^2 (see the
source). ``group_caf.splits`` holds the split of the last launch.
``group_caf_staged`` is the kernel's arithmetic in torch, for the tests.

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
# the kernel's depth stage and bin tile (csrc/group_caf.cu BK, BN): the
# split tfold is padded with zeros to whole ones
DEPTH_STEP, BIN_TILE = 32, 64
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does: half a TF32 unit
    added to the magnitude's bit pattern, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)): x ~ hi + lo to ~2^-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def tf32_planes(tfold: torch.Tensor,
                depth_step: int = DEPTH_STEP) -> torch.Tensor:
    """The split tfold as the kernel reads it: (G*m, k) complex64 padded
    with zeros to (Kp, kp) = (a multiple of the kernel's stage depth, 32,
    and of 64), four planes (real hi, real lo, imaginary hi, imaginary lo;
    ``tf32_split``), cut into 32-deep x 64-bin tiles, each tile the
    shared-memory image of the kernel's wgmma B operand: per plane, K-major
    core matrices of 8 bins x 4 depths. Shape (Kp/32, kp/64, 4, 8, 8, 8, 4)
    float32: [depth tile, bin tile, plane, bin group, depth group, bin % 8,
    depth % 4]. ``depth_step`` lays it out for a kernel built with another
    stage depth (scripts/exp_group_caf.py). On tfold's device."""
    kk, k = tfold.shape
    kp_, np_ = _up(kk, depth_step), _up(k, BIN_TILE)
    t = tfold.new_zeros((kp_, np_))
    t[:kk, :k] = tfold
    planes = [x for part in (t.real, t.imag)
              for x in tf32_split(part.contiguous())]
    return torch.stack(planes).reshape(
        4, kp_ // depth_step, depth_step // 4, 4, np_ // BIN_TILE, 8,
        8).permute(1, 4, 0, 5, 2, 6, 3).contiguous()


def planes_unpacked(planes: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """(2, 2, rows, k) float32 [real, imaginary][hi, lo] planes of
    ``tf32_planes``' layout, the padding cut off."""
    kb, nb, depth = planes.shape[0], planes.shape[1], planes.shape[4] * 4
    x = planes.permute(2, 0, 4, 6, 1, 3, 5).reshape(4, kb * depth,
                                                    nb * BIN_TILE)
    return x[:, :rows, :k].reshape(2, 2, rows, k)


def group_caf_staged(rx: torch.Tensor, offsets: torch.Tensor,
                     starts: torch.Tensor, planes: torch.Tensor,
                     m: int, k: int) -> torch.Tensor:
    """The kernel's arithmetic in torch: the gathered windows split into
    TF32 hi/lo as the kernel forms its A fragments, tfold's hi/lo read back
    from ``planes``, and each real product taken as lo*hi + hi*lo + hi*hi,
    every product of two TF32 values exact in f32 and summed in f32 (full
    f32 matrix products; the kernel sums in another order). Returns |C|^2
    (B, k) float32."""
    g = starts.shape[0]
    wins = group_windows(rx, offsets, starts, m).reshape(-1, g * m)
    (arh, arl), (aih, ail) = (tf32_split(p.contiguous())
                              for p in (wins.real, wins.imag))
    (brh, brl), (bih, bil) = planes_unpacked(planes, g * m, k)
    with full_f32():
        re = (arl @ brh + arh @ brl) - (ail @ bih + aih @ bil) \
            + arh @ brh - aih @ bih
        im = (arl @ bih + arh @ bil) + (ail @ brh + aih @ brl) \
            + arh @ bih + aih @ brh
    return re * re + im * im


def group_caf(rx: torch.Tensor, offsets: torch.Tensor, starts: torch.Tensor,
              tfold: torch.Tensor, k: int,
              planes: torch.Tensor | None = None) -> torch.Tensor:
    """|C|^2 (B, k) of the group CAF at the shift offsets ``offsets`` (see
    the module docstring). CPU tensors take the twin; CUDA tensors launch
    the kernel, over ``planes`` (``tf32_planes(tfold)``, made here when not
    given)."""
    _check(rx, offsets, starts, tfold, k)
    if rx.device.type == "cpu":
        return group_caf_plain(rx, offsets, starts, tfold, k)
    return _group_caf_cuda(rx, offsets, starts, tfold, k, planes)


group_caf.launches = 0
group_caf.splits = 0


def _group_caf_cuda(rx, offsets, starts, tfold, k, planes=None):
    lib = _build.library()
    if rx.dtype != torch.complex64 or tfold.dtype != torch.complex64:
        raise ValueError("the group CAF kernel takes complex64 "
                         f"(got {rx.dtype}, {tfold.dtype})")
    if tfold.shape[0] >= 2**31 - DEPTH_STEP:
        raise ValueError("G*m too large for the kernel's 32-bit depth")
    if planes is None:
        planes = tf32_planes(tfold)
    kp = planes.shape[1] * BIN_TILE
    want = (_up(tfold.shape[0], DEPTH_STEP) // DEPTH_STEP,
            _up(k, BIN_TILE) // BIN_TILE, 4, 8, DEPTH_STEP // 4, 8, 4)
    if tuple(planes.shape) != want or planes.dtype != torch.float32 \
            or not planes.is_contiguous() or planes.device != rx.device:
        raise ValueError(f"planes {tuple(planes.shape)} {planes.dtype} on "
                         f"{planes.device} are not tf32_planes(tfold) "
                         f"{want} on {rx.device}")
    rx, offsets = rx.contiguous(), offsets.contiguous()
    starts = starts.contiguous()
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
                starts.data_ptr(), g, m, planes.data_ptr(), k, kp,
                part.data_ptr(),
                part.numel(), out[c0:].data_ptr(), ctypes.addressof(splits),
                stream)
            _build.check(rc, f"group_caf launch (G={g}, m={m}, k={k}, "
                             f"chunk at {c0})")
            group_caf.launches += 1
            group_caf.splits = splits.value
    return out
