"""Median filter (TPU kernel #6) and its plain PyTorch twin.

Kernel: ``csrc/medfilt.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/medfilt.py:_kernel``. Floats become
order-preserving unsigned keys (-0.0 below +0.0, the zero padding the key
of +0.0) and each output is its window's key of rank k//2, mapped back to
the float's bits, so the result is bit-identical to
``scipy.signal.medfilt`` (zero-padded edges, odd k) and to the twin.
float32 takes uint32 keys, float64 uint64.

The kernel has two routes, chosen by ``medfilt_plan``:

* **tile** (a tile's core of at most 1024 keys): a block cuts its 256
  outputs into tiles of C (a power of two <= k//2 + 1); the C windows of a
  tile share a core of k - C + 1 keys, sorted once per tile by one warp in
  its registers, and each output's median is the key of rank C - 1 among
  2C - 1 candidates: the sorted core's entries k//2 - C + 1 .. k//2 and
  its C - 1 own keys;
* **radix** (a longer core, e.g. k = 60,001): the first version's
  MSB-first radix select per output, 32 (64) steps over the window, staged
  in shared memory when the block's 256 + k - 1 keys fit, else read from
  device memory, so any odd k runs.

``medfilt_staged`` runs the tile schedule (or the radix select) in torch,
for the tests. ``medfilt_kernel`` routes by the tensor's device: a CPU
tensor takes the plain twin ``medfilt_plain`` (pad + unfold +
``torch.median`` in chunks of _MEDFILT_ELEMS window elements); a CUDA
tensor launches the kernel or raises. The kernel filters contiguous 1-D
float32/float64 signals; float16 and bfloat16 signals are filtered as
float32 and cast back, which is exact (the median is one of the inputs, and
the casts are exact).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pydsproutines_tpu_torch.ops.hopper import _build

# window-matrix elements per twin chunk (the JAX package's ops/filters
# _MEDFILT_ELEMS): a 4M x 129 filter never holds its 2 GB window matrix
_MEDFILT_ELEMS = 1 << 23
# the kernel's outputs (threads) per block, shared memory a block may use,
# preferred tile width (the fastest of 4, 8, 16, 32 at k = 129 on the H100,
# scripts/exp_medfilt.py), largest tile width, and the fewest and most keys
# of a tile's sort (a warp's 32 lanes, up to 32 keys each; csrc/medfilt.cu)
BLOCK_OUTPUTS = 256
MAX_SMEM = 227 * 1024
TILE_C = 16
MAX_TILE_C = 32
MIN_SORT, MAX_SORT = 32, 1024
# keys a lane of a tile's sort the kernel is built for, by tile width: all
# at TILE_C, else 1 (the default width below k = 31) and 4 (k = 129)
SORT_LANE_KEYS = {TILE_C: (1, 2, 4, 8, 16, 32)}
OTHER_LANE_KEYS = (1, 4)


def _check_k(kernel_size) -> int:
    k = int(kernel_size)
    if k < 1 or k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    return k


def _pow2_floor(v: int) -> int:
    return 1 << (v.bit_length() - 1)


def medfilt_plan(kernel_size: int, key_bytes: int = 4,
                 c: int | None = None) -> dict:
    """The kernel's route for window k and keys of ``key_bytes`` (4 for
    float32, 8 for float64): ``route`` ("tile", "radix-staged" or
    "radix-unstaged"), the tile width ``c`` (0 on the radix routes), the
    sorted core's padded length ``p``, the block's shared memory ``smem`` and
    the key compares an output takes, ``compares`` (tile: the core sort's
    compare-exchanges shared by the tile's C outputs plus the select's
    (C-1)(3C-2); radix: key bits x k). The tile width is ``c`` when given,
    else TILE_C, cut to k//2 + 1; the tile route runs while its core of
    k - C + 1 keys fits a warp's sort (MAX_SORT) the kernel is built for
    (SORT_LANE_KEYS)."""
    k = _check_k(kernel_size)
    width = min(c or TILE_C, MAX_TILE_C, _pow2_floor(k // 2 + 1))
    p = max(MIN_SORT, 1 << (k - width).bit_length())   # >= k - width + 1
    built = SORT_LANE_KEYS.get(width, OTHER_LANE_KEYS)
    if p <= MAX_SORT and p // MIN_SORT in built and c != 0:
        lg = p.bit_length() - 1
        sort = p // 2 * lg * (lg + 1) // 2 / width
        return {"route": "tile", "c": width, "p": p,
                "smem": key_bytes * (2 * BLOCK_OUTPUTS + k - 1),
                "compares": sort + (width - 1) * (3 * width - 2)}
    smem = key_bytes * (BLOCK_OUTPUTS + k - 1)
    staged = smem <= MAX_SMEM
    return {"route": "radix-staged" if staged else "radix-unstaged", "c": 0,
            "p": 0, "smem": smem if staged else 0,
            "compares": 8 * key_bytes * k}


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


def _to_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the float order of x (float32 or
    float64), -0.0 below +0.0, +0.0 at 0."""
    bits = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
    flip = torch.iinfo(bits.dtype).max
    return torch.where(bits < 0, bits ^ flip, bits).long()


def _from_keys(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    idt = torch.int32 if dtype == torch.float32 else torch.int64
    bits = keys.to(idt)
    return torch.where(bits < 0, bits ^ torch.iinfo(idt).max, bits).view(dtype)


def _bitonic_tiles(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's bitonic network over every row of (tiles, P) keys at
    once, P a power of two, rows sorted ascending: for each merge size and
    stride j, pair p compares i = 2p - (p mod j) with i + j, ascending
    where the merge's size bit of i is clear (or in the last merge)."""
    flat = keys.reshape(-1).clone()
    width = keys.shape[-1]
    i0 = torch.arange(flat.numel() // 2)
    size = 2
    while size <= width:
        j = size // 2
        while j:
            i = 2 * i0 - (i0 & (j - 1))
            a, b = flat[i], flat[i + j]
            swap = (a > b) == ((size == width) | ((i & size) == 0))
            flat[i], flat[i + j] = (torch.where(swap, b, a),
                                    torch.where(swap, a, b))
            j //= 2
        size *= 2
    return flat.reshape(keys.shape)


def medfilt_staged(x: torch.Tensor, kernel_size: int,
                   c: int | None = None) -> torch.Tensor:
    """The kernel's schedule in torch for a 1-D float32/float64 ``x``, over
    its keys, on the route ``medfilt_plan`` gives (tile width ``c`` if
    given). Tile: per tile of C outputs the core (k - C + 1 keys, padded to
    P with the largest key and sorted by the kernel's bitonic network,
    ``_bitonic_tiles``), the candidates core[k//2 - C + 1 .. k//2] and each
    output's C - 1 extra keys, and the largest candidate v with
    count(candidates < v) <= C - 1, where a core candidate's sorted index
    stands in for its count of core keys below it. Radix: the MSB-first
    select over each window's keys."""
    k = _check_k(kernel_size)
    n, half = x.shape[0], k // 2
    plan = medfilt_plan(k, x.element_size(), c)
    width = plan["c"] or 1
    tiles = -(-n // width)
    keys = _to_keys(x)
    w = torch.zeros(tiles * width + k - 1, dtype=torch.int64)
    w[half: half + n] = keys
    if plan["c"] == 0:                       # radix select per window
        win = w[: n + k - 1].unfold(0, k, 1)
        bits = 8 * x.element_size()
        acc = torch.zeros(n, dtype=torch.int64)
        lo = -(1 << (bits - 1))              # the signed keys' least value
        for b in range(bits - 1, -1, -1):
            cand = acc + (1 << b)
            cnt = (win < (cand + lo)[:, None]).sum(-1)
            acc = torch.where(cnt <= half, cand, acc)
        return _from_keys(acc + lo, x.dtype)
    core_len, s = k - width + 1, half - width + 1
    core = torch.full((tiles, plan["p"]), torch.iinfo(torch.int64).max)
    core[:, :core_len] = w[width - 1:].unfold(0, core_len, width)[:tiles]
    a = _bitonic_tiles(core)[:, s: s + width]                  # (tiles, C)
    j, i = torch.meshgrid(torch.arange(width), torch.arange(width - 1),
                          indexing="ij")
    idx = j + i + torch.where(j + i >= width - 1, core_len, 0)  # (C, C-1)
    e = w[(torch.arange(tiles) * width)[:, None, None] + idx]  # (tiles, C, C-1)
    a_b = a[:, None, :].expand(-1, width, -1)                  # (tiles, C, C)
    lt_a = (torch.arange(width) + (e[..., :, None] < a_b[..., None, :]).sum(-2))
    lt_e = ((a_b[..., :, None] < e[..., None, :]).sum(-2)
            + (e[..., :, None] < e[..., None, :]).sum(-2))
    cand = torch.cat([a_b, e], -1)
    ok = torch.cat([lt_a, lt_e], -1) <= width - 1
    best = torch.where(ok, cand, torch.iinfo(torch.int64).min).max(-1).values
    return _from_keys(best.reshape(-1)[:n], x.dtype)


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
    plan = medfilt_plan(k, x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], k, plan["c"],
                stream)
    _build.check(rc, f"medfilt launch (n={x.shape[0]}, k={k}, "
                     f"{plan['route']} c={plan['c']})")
    medfilt_kernel.launches += 1
    return out
