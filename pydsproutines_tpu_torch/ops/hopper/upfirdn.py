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

The kernel is a register-window polyphase FIR (``upfirdn_plan``): a warp
takes one output phase, a lane M consecutive outputs of it, and the taps
are walked in residue classes mod S = down/g, so one sample and one tap
load feed M FMAs. Two float32 planes run together as the two parts of
one float2 (read as one 8-byte value where they are the parts of a complex
tensor). ``upfirdn_staged`` runs that schedule in torch over the
kernel's tap table, for the tests.

The TPU kernel's gp = 128 band matrices, 8-row DMA alignment and viability
gate (``upfirdn_pallas_viable``: n_out >= 2*128*cols, <= 2 planes) belong to
the TPU layout and do not apply: every geometry launches. When a block's tap
table, input span and output tile do not fit its shared-memory budget, the
unstaged variant reads taps and samples through the caches, so no tap length
is refused.

``upfirdn_planes`` routes by the tensors' device: CPU tensors take the plain
twin ``upfirdn_planes_plain`` (polyphase windows x banded tap matrix, full
f32); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import full_f32

# twin working set per chunk of windows (elements)
PLAIN_CHUNK_ELEMS = 1 << 24
# shared memory a staged block may take: small enough for several blocks an
# SM at the chain's geometry, far below the 227 KB limit
SMEM_BUDGET = 96 * 1024
# the most warps a block runs (its phase tasks loop past them)
MAX_WARPS = 16


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


def _pad_shift(stride: int) -> int:
    """log2 of the pad period of a shared-memory tile whose lanes read
    ``stride`` elements apart: one pad element every 2^shift elements puts
    the 32 lanes of a warp on distinct banks (stride a multiple of 32: the
    period is 32 times its largest power-of-two factor past 32)."""
    if stride % 32:
        return 5
    m = stride // 32
    return 5 + (m & -m).bit_length() - 1


@functools.lru_cache(maxsize=256)
def upfirdn_plan(taps_len: int, up: int, down: int, itemsize: int = 4,
                 comps: int = 1) -> dict:
    """The kernel's schedule for ``taps_len`` taps at up/down over planes of
    ``itemsize`` bytes, ``comps`` = 2 for two float32 planes run as the
    parts of one float2: P, S, lh, the lane's outputs ``m`` (16 when the
    longest residue class has >= 16 taps, else 4; at the chain 8 and 32 ran
    slower), ``tpad`` = ceil(lh/S) steps of the longest class (class rho
    runs ceil((lh - rho)/S)), ``nir`` warp rows a block (8 // P for P < 8,
    halved until the tiles fit SMEM_BUDGET), ``ib`` = 32*m*nir outputs a phase a block,
    ``threads``, the tiles' pad shifts ``xsh`` / ``osh``, ``span`` samples
    staged, ``smem`` bytes and ``staged``; ``route`` names the variant."""
    g = math.gcd(up, down)
    P, S = up // g, down // g
    lh = -(-taps_len // up)
    tpad = -(-lh // S)
    m = 16 if tpad >= 16 else 4
    qcmax = (P - 1) * down // up
    xsh, osh = _pad_shift(m * S), _pad_shift(m * P)
    # the tap table's rows are padded to a multiple of 4 steps
    ntab = -(-P * S * (-(-tpad // 4) * 4) // (2 * comps)) * 2 * comps

    def smem_of(nir):
        ib = 32 * m * nir
        span = (ib - 1) * S + qcmax + (S - 1) + tpad * S + 1
        tile = ib * P
        # the tap table, two input spans (one copied while the other is
        # read) and the output tile
        return span, itemsize * (ntab + comps * (
            2 * (span + (span >> xsh) + 1) + (tile + (tile >> osh) + 1)))

    nir = max(1, 8 // P)
    while nir > 1 and smem_of(nir)[1] > SMEM_BUDGET:
        nir //= 2
    span, smem = smem_of(nir)
    staged = smem <= SMEM_BUDGET
    route = ("window-staged" if staged else "window-unstaged") + (
        "-float2" if comps == 2 else "")
    return {"route": route, "P": P, "S": S, "lh": lh, "m": m, "tpad": tpad,
            "nir": nir, "ib": 32 * m * nir, "threads": 32 * min(P * nir,
                                                                MAX_WARPS),
            "xsh": xsh, "osh": osh, "span": span,
            "smem": smem if staged else 0, "staged": staged, "comps": comps}


def plan_text(plan: dict) -> str:
    """One line naming the kernel's route and its plan."""
    where = (f"{plan['smem']} B of shared memory a block" if plan["staged"]
             else "taps and samples through L1/L2 (past the shared-memory "
                  "budget)")
    pair = "; two planes as float2" if plan["comps"] == 2 else ""
    return (f"register-window polyphase FIR ({plan['route']}): {plan['m']} "
            f"outputs a lane, up to {plan['tpad']} steps a residue class, "
            f"{plan['ib'] * plan['P']} outputs a block, {where}{pair}")


def tap_table(taps: torch.Tensor, up: int, down: int,
              tpad: int) -> torch.Tensor:
    """The kernel's phase-tap table (P, S, tpad): entry [c, rho, t] is
    h[p_c + l*up] with l = rho + t*S, zero where l >= lh or the index is
    past the taps (p_c = (c*down) mod up)."""
    g = math.gcd(up, down)
    P, S = up // g, down // g
    T = taps.shape[-1]
    lh = -(-T // up)
    c = torch.arange(P)[:, None, None]
    l = torch.arange(S)[None, :, None] + torch.arange(tpad)[None, None, :] * S
    k = (c * down) % up + l * up
    ok = (l < lh) & (k < T)
    return torch.where(ok, taps[k.clamp(max=T - 1)], 0)


def upfirdn_staged(planes: Sequence[torch.Tensor], taps: torch.Tensor,
                   up: int, down: int, n_out: int | None = None,
                   comps: int = 1) -> tuple[torch.Tensor, ...]:
    """The kernel's schedule in torch, on the plane's dtype: per block of
    ``ib`` outputs a phase, each warp task (phase c, warp row) and lane (M
    consecutive outputs i0 ..), each residue class rho: the window of M
    samples x[i0*S + q_c - rho + u*S], then ceil((lh - rho)/S) steps
    (fewer than tpad for the shorter classes), step t adding tap
    table[c, rho, t] times slot (u - t) mod M to output u and loading
    x[. - (t+1)*S] into slot (-(t+1)) mod M; samples from the block's span,
    zero outside [0, n); outputs j = (i0 + u)*P + c stored where j < n_out.
    ``comps`` = 2 picks the plan of two planes run as float2 (the
    arithmetic is the same per plane). Returns one (..., n_out) tensor per plane."""
    up, down = int(up), int(down)
    n, T = planes[0].shape[-1], taps.shape[-1]
    if n_out is None:
        n_out = get_upfirdn_size(n, T, up, down)
    plan = upfirdn_plan(T, up, down, planes[0].element_size(), comps)
    P, S, M, tpad, ib = (plan[k] for k in ("P", "S", "m", "tpad", "ib"))
    tab = tap_table(taps, up, down, tpad)
    blocks = -(-n_out // (ib * P))
    # lanes (blocks, P*nir tasks, 32) -> phase c and first output i0
    b = torch.arange(blocks)[:, None, None]
    task = torch.arange(P * plan["nir"])[None, :, None]
    lane = torch.arange(32)[None, None, :]
    c = task % P
    i0 = b * ib + (task // P) * 32 * M + lane * M
    qc = (c * down) // up
    span_lo = b * ib * S - (S - 1) - tpad * S
    outs = []
    for x in planes:
        x2 = x.reshape(-1, n)
        res = x2.new_zeros(x2.shape[0], blocks * ib * P)
        for row in range(x2.shape[0]):
            xr = x2[row]

            def X(o):                   # span offset -> sample, zero outside
                gi = span_lo + o
                ok = (gi >= 0) & (gi < n)
                return torch.where(ok, xr[gi.clamp(0, n - 1)], 0)

            acc = [torch.zeros(i0.shape, dtype=x.dtype) for _ in range(M)]
            for r in range(min(S, plan["lh"])):
                ob = i0 * S + qc - r - span_lo
                w = [X(ob + u * S) for u in range(M)]
                hr = tab[c[..., 0], r]                     # (1, tasks, tpad)
                for t in range(-(-(plan["lh"] - r) // S)):
                    s, hv = t % M, hr[..., t, None]
                    for u in range(M):
                        acc[u] = acc[u] + hv * w[(u - s) % M]
                    w[M - 1 - s] = X(ob - (t + 1) * S)
            j = torch.stack([(i0 + u) * P + c for u in range(M)], -1)
            res[row, j.reshape(-1)] = torch.stack(acc, -1).reshape(-1)
        outs.append(res[:, :n_out].reshape(*x.shape[:-1], n_out))
    return tuple(outs)


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


def _complex_pair(planes) -> bool:
    """Whether two float32 planes are the real and imaginary parts of one
    complex tensor (the second one element after the first), so that their
    outputs go to one complex tensor too and the kernel moves each sample
    pair as one float2."""
    return (len(planes) == 2 and planes[0].dtype == torch.float32
            and planes[1].data_ptr() == planes[0].data_ptr() + 4)


def _upfirdn_cuda(planes, taps, up, down, n_out, out, kernel="window"):
    """The launch. ``kernel="v1"`` runs the first version, for
    scripts/exp_upfirdn.py's comparison."""
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
        if _complex_pair(planes):
            y = torch.empty(shape, dtype=torch.complex64, device=x0.device)
            out = (y.real, y.imag)
        else:
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
    # two float32 planes run as the parts of one float2 (read as one where
    # they are the parts of a complex tensor, csrc/upfirdn.cu decides)
    comps = 2 if len(planes) == 2 and x0.dtype == torch.float32 else 1
    plan = upfirdn_plan(T, up, down, x0.element_size(), comps)
    second = planes[-1].data_ptr(), out[-1].data_ptr()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (x0.data_ptr(), second[0], out[0].data_ptr(), second[1])
        if kernel == "v1":              # the first version, for comparisons
            if x0.dtype != torch.float32:
                raise ValueError("the first version takes float32 planes")
            rc = lib.pdsp_upfirdn_v1_f32(
                *args, len(planes), rows, x0.shape[-1], in_rs, in_es, n_out,
                out_rs, out_es, taps.data_ptr(), T, up, down, stream)
            _build.check(rc, "upfirdn v1 launch")
            return out
        rc = fn(*args, len(planes), rows, x0.shape[-1], in_rs, in_es, n_out,
                out_rs, out_es, taps.data_ptr(), T, up, down, plan["m"],
                plan["nir"], int(plan["staged"]), plan["comps"], plan["xsh"],
                plan["osh"], stream)
    _build.check(rc, f"upfirdn launch (n={x0.shape[-1]}, taps={T}, "
                     f"up={up}, down={down}, {plan['route']})")
    upfirdn_planes.launches += 1
    return out
