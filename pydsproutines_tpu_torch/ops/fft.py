"""The transform API, DFT plans and the f32 tables of the Hopper CAF kernels.

The transform API is the JAX package's: ``FourStepFFT(n)`` (its ``factors``
and ``viable`` chosen by the same rules, ``fft_factors``), ``get_fft_plan``,
``fft`` and ``ifft``. The JAX package computes the transform as matrix
stages because XLA's TPU FFT was slow; here the transform is
``torch.fft`` on the input's device (f32-exact where the JAX stages run at
the TPU's default, bf16-grade, precision), and the plan's factors drive
the permuted layout and the fused peak path, whose last stage is TPU
kernel #4 (``ops/hopper/fft_peak.stage2_peak``).

The kernels need the plan's factors and their tables, built here on the
host from float64 phases reduced mod their period before the exponential
(the pattern of ``pydsproutines_tpu/ops/fft.py`` and
``ops/pallas/fused_caf3.py``), stored complex64.

Two-factor split n = n1*n2 (kernels #2 and #4), t = t1*n2 + t2,
k = k1 + n1*k2:

    W1[k1, t1] = exp(-2*pi*i*k1*t1/n1)      (n1, n1)
    TW[k1, t2] = exp(-2*pi*i*k1*t2/n)       (n1, n2)
    W2[t2, k2] = exp(-2*pi*i*t2*k2/n2)      (n2, n2)

so that X[k1 + n1*k2] = sum_t2 W2[t2, k2] TW[k1, t2] sum_t1 W1[k1, t1]
x[t1*n2 + t2].

Three-factor split n = f0*f1*f2 (kernel #4's multi-stage plans and the JAX
package's three-stage kernel), see ``caf3_tables``.

The CAF peak kernels #2, #3 and #4 compute their DFTs as FFTs in shared
memory (``csrc/fft_smem.cuh``). Their plan is ``caf_plan``: one pass when
the window fits one block, else two (three where no two-factor split fits)
passes over a device scratch, each a batch of line FFTs of length at most
``SMEM_LINE_MAX``; kernel #4 alone is the last of them, a row pass
(``row_plan``). Each line FFT is an in-place decimation-in-time schedule of
the radices ``radix_plan`` picks, its input loaded in digit-reversed order
(``digit_reversal``); ``fft_staged``, ``caf_staged``, ``stage2_staged`` and
``peak_sweep_staged`` run that very schedule in torch over the tables the
kernels read, for the tests.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def best_two_factor(n: int, max_factor: int = 8192) -> tuple[int, int] | None:
    """Factor n = n1*n2 with n1 <= n2, n1 as close to sqrt(n) as possible.
    Returns None if no factorization fits under max_factor (e.g. primes)."""
    for n1 in range(int(math.isqrt(n)), 1, -1):
        if n % n1 == 0:
            n2 = n // n1
            if n1 <= max_factor and n2 <= max_factor:
                return n1, n2
            return None
    return None


def factorize_for_mxu(n: int, max_factor: int = 1024,
                      min_factor: int = 16) -> list[int] | None:
    """Stage sizes of a multi-stage matmul DFT (the JAX package's
    ``factorize_for_mxu``): about ceil(log_512 n) stages of size ~n^(1/k),
    picking the divisor closest to the target at each step. None when n has
    a prime factor > max_factor."""
    if n < 2:
        return None
    k = max(1, math.ceil(math.log(n) / math.log(512)))
    factors: list[int] = []
    rem = n
    while rem > max_factor:
        stages_left = max(2, k - len(factors))
        target = rem ** (1.0 / stages_left)
        best = None
        for d in range(2, max_factor + 1):
            if rem % d == 0 and d >= min_factor:
                if best is None or abs(d - target) < abs(best - target):
                    best = d
        if best is None:
            for d in range(2, max_factor + 1):
                if rem % d == 0:
                    best = d
                    break
            if best is None:
                return None
        factors.append(best)
        rem //= best
    factors.append(rem)
    return factors


def fft_factors(n: int, max_factor: int = 8192) -> list[int] | None:
    """The stage factors the JAX package's ``FourStepFFT(n)`` chooses: two
    balanced factors while n1 + n2 <= 3000, else the multi-stage split when
    it is cheaper; a single stage [n] for 128 <= n < 4096; None when no plan
    is viable (e.g. a large prime)."""
    two = best_two_factor(n, max_factor)
    if two is not None and sum(two) <= 3000:
        factors = list(two)
    else:
        multi = factorize_for_mxu(n, max_factor=1024)
        if multi is not None and (two is None or sum(multi) < sum(two)):
            factors = multi
        else:
            factors = list(two) if two is not None else None
    if factors is not None and n >= 4096 and len(factors) >= 2:
        return factors
    if 128 <= n < 4096:
        return [n]
    return None


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_macs(f0: int, f1: int, f2: int) -> int:
    """Complex MACs per shift of a three-stage dense DFT with 64 x 64
    output tiles and depth-16 steps padded (the tie-break of the first
    Hopper three-stage kernel's triple)."""
    return (_pad(f0, 64) * _pad(f0, 16) * f1 * f2
            + f0 * _pad(f1, 64) * _pad(f1, 16) * _pad(f2, 64)
            + f0 * _pad(f1, 64) * _pad(f2, 16) * _pad(f2, 64))


@functools.lru_cache(maxsize=64)
def find_triple(n: int, lo: int = 16,
                hi: int = 1024) -> tuple[int, int, int] | None:
    """Factor n = f0*f1*f2 with every factor in [lo, hi], minimising
    f0 + f1 + f2 (the per-sample MAC count), then the kernel's tile-padded
    MAC count. The JAX package's finder also requires f2 % 128 == 0, a TPU
    lane rule that a Hopper tile does not have, so e.g. 5^10 = 125*125*625
    has a triple here and none there. None when no triple exists."""
    best, best_key = None, None
    for f0 in range(lo, min(hi, n) + 1):
        if n % f0:
            continue
        rest = n // f0
        for f1 in range(lo, min(hi, rest) + 1):
            if rest % f1:
                continue
            f2 = rest // f1
            if not lo <= f2 <= hi:
                continue
            key = (f0 + f1 + f2, _tile_macs(f0, f1, f2), (f0, f1, f2))
            if best_key is None or key < best_key:
                best, best_key = (f0, f1, f2), key
    return best


def _phase_exp(a: np.ndarray, b: np.ndarray, period: int) -> np.ndarray:
    """exp(-2*pi*i*(a x b mod period)/period) as complex64, phases in
    float64 reduced mod the period before the exponential."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.exp(-2j * np.pi * np.mod(np.outer(a, b), period)
                  / period).astype(np.complex64)


def dft_matrix(n: int) -> np.ndarray:
    """(n, n) complex64 forward DFT matrix exp(-2*pi*i*j*k/n)."""
    k = np.arange(n)
    return _phase_exp(k, k, n)


def twiddle(n1: int, n2: int) -> np.ndarray:
    """(n1, n2) complex64 four-step twiddle exp(-2*pi*i*k1*t2/(n1*n2))."""
    return _phase_exp(np.arange(n1), np.arange(n2), n1 * n2)


def stage_tables(factors) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-stage DFT matrices and twiddles of a multi-stage plan (the JAX
    ``FourStepFFT.stage_w`` / ``stage_tw``): at stage s, with the remaining
    transform length m = prod(factors[s:]) split as n1 x rest,
    TW_s[k1, j] = exp(-2*pi*i*k1*j/m), j < rest."""
    stage_w, stage_tw = [], []
    m = int(np.prod(factors))
    for n1 in factors[:-1]:
        rest = m // n1
        stage_w.append(dft_matrix(n1))
        stage_tw.append(_phase_exp(np.arange(n1), np.arange(rest), m))
        m = rest
    stage_w.append(dft_matrix(factors[-1]))
    return stage_w, stage_tw


def peak_consts(factors) -> tuple[np.ndarray, np.ndarray]:
    """(TW (K1, J), W2 (J, K2)) of the last-stage peak kernel for a plan
    whose last two factors are K1 and J = K2 (the JAX
    ``FourStepFFT._peak_consts``)."""
    k1, j = factors[-2], factors[-1]
    return twiddle(k1, j), dft_matrix(j)


def caf3_tables(f0: int, f1: int, f2: int) -> dict[str, np.ndarray]:
    """Tables of the three-stage split n = f0*f1*f2 (t = n0*f1*f2 + n1*f2 +
    n2, k = k0 + f0*k1 + f0*f1*k2):

        w0 (f0, f0), w1 (f1, f1), w2 (f2, f2)   the stage DFT matrices
        a1[k0, n1] = exp(-2*pi*i*k0*n1/(f0*f1))  stage-1 twiddle, n1 digit
        a2[k0, n2] = exp(-2*pi*i*k0*n2/n)        stage-1 twiddle, n2 digit
        tw2[k1, n2] = exp(-2*pi*i*k1*n2/(f1*f2)) stage-2 twiddle

    so that X[k] = sum_n2 w2[n2,k2] tw2[k1,n2] sum_n1 w1[k1,n1] a1[k0,n1]
    a2[k0,n2] sum_n0 w0[k0,n0] x[n0, n1, n2] (``fused_caf3.py:38-43``)."""
    n = f0 * f1 * f2
    k0, k1 = np.arange(f0), np.arange(f1)
    return {"w0": dft_matrix(f0), "w1": dft_matrix(f1), "w2": dft_matrix(f2),
            "a1": _phase_exp(k0, np.arange(f1), f0 * f1),
            "a2": _phase_exp(k0, np.arange(f2), n),
            "tw2": _phase_exp(k1, np.arange(f2), f1 * f2)}


# --- the shared-memory FFT plans of the CAF kernels (csrc/fft_smem.cuh) ---

# Complex elements one block holds: its lines (columns or rows) of one pass
# times their length. 8192 complex64 are 64 KB of shared memory; the kernel
# keeps PER_THREAD of them in each of at most 512 threads' registers across
# a radix stage.
SMEM_LINE_MAX = 8192
# radices with an unrolled butterfly; any other prime takes the generic one
FAST_RADICES = (8, 4, 2, 3, 5)
MAX_RADICES = 16
# elements per block of a one-pass plan (several windows when they are short)
SINGLE_BLOCK_ELEMS = 2048


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=256)
def radix_plan(length: int) -> tuple[int, ...]:
    """The radices of the kernels' line FFT of ``length`` points, in stage
    order: 8s, then one 4 or 2 for the rest of the power of two, then 3s,
    5s, then every other prime factor (each a generic direct radix-p
    stage)."""
    if length < 2:
        raise ValueError(f"FFT length {length} < 2")
    primes = _prime_factors(length)
    twos = primes.count(2)
    radices = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    radices += [p for p in primes if p != 2]
    if len(radices) > MAX_RADICES:
        raise ValueError(f"FFT length {length} has more than {MAX_RADICES} "
                         "stages")
    return tuple(radices)


def _split_key(n1: int, n2: int, emax: int):
    """Rank a column-pass split n1 x n2: strided loads of at least 8
    adjacent columns (64-byte segments) first, then the most balanced."""
    cols = min(emax // n1, n2)
    return (min(cols, 8), -abs(math.log(n1 / n2)))


def _two_split(n: int, emax: int) -> tuple[int, int] | None:
    best, best_key = None, None
    for n1 in range(2, min(n // 2, emax) + 1):
        if n % n1 or n // n1 > emax:
            continue
        key = _split_key(n1, n // n1, emax)
        if best_key is None or key > best_key:
            best, best_key = (n1, n // n1), key
    return best


@functools.lru_cache(maxsize=64)
def caf_plan(n: int, emax: int = SMEM_LINE_MAX,
             min_passes: int = 1) -> dict | None:
    """The pass plan of the CAF peak kernels for an n-point window:
    ``factors`` (f0, ..., f_{p-1}) with n = prod, one pass per factor, the
    first p-1 passes column FFTs over a scratch (t = t0*f1*f2 + t1*f2 + t2),
    the last a row FFT with the per-row peak; ``lines`` the columns (or
    rows) each block of a pass transforms. The fewest passes, at least
    ``min_passes``, whose lengths fit ``emax``: one when n <= emax, else two
    (the split of ``_split_key``), else three. None when no plan exists (a
    prime factor > emax, or no three-factor split)."""
    if n < 2:
        return None
    if n <= emax and min_passes < 2:
        # one block per SINGLE_BLOCK_ELEMS-ish: several short windows per
        # block, but enough blocks to spread a short sweep over the SMs
        factors, lines = (n,), (max(1, SINGLE_BLOCK_ELEMS // n),)
    else:
        factors = _two_split(n, emax)
        if factors is None:
            # the smallest first factor whose rest splits in two
            factors = next(((f0, *rest) for f0 in range(2, min(n, emax) + 1)
                            if n % f0 == 0
                            and (rest := _two_split(n // f0, emax))), None)
            if factors is None:
                return None
        lines, cols = [], n
        for f in factors[:-1]:
            cols //= f
            lines.append(min(emax // f, cols))
        lines = (*lines, emax // factors[-1])
    return {"factors": factors, "lines": lines,
            "radices": tuple(radix_plan(f) for f in factors)}


def row_plan(length: int, emax: int = SMEM_LINE_MAX) -> dict:
    """The one-pass plan of kernel #4's row FFT over rows of ``length``
    points: as many rows a block as fit ``emax`` elements (the last pass of
    a two-pass ``caf_plan``)."""
    if not 2 <= length <= emax:
        raise ValueError(f"row length {length} is not in [2, {emax}]")
    return {"factors": (length,), "lines": (emax // length,),
            "radices": (radix_plan(length),)}


def plan_ints(plan: dict) -> list[int]:
    """The plan as the int array the C entry points read (``read_plan`` in
    csrc/fft_smem.cuh): [passes, f0, f1, f2, lines0, lines1, lines2, then
    for each pass its length, its radix count and MAX_RADICES radices]."""
    f, ln = list(plan["factors"]), list(plan["lines"])
    out = [len(f), *(f + [0] * (3 - len(f))), *(ln + [0] * (3 - len(ln)))]
    for i in range(3):
        r = list(plan["radices"][i]) if i < len(f) else []
        out += [f[i] if i < len(f) else 0, len(r),
                *(r + [0] * (MAX_RADICES - len(r)))]
    return out


def digit_reversal(length: int, radices=None) -> np.ndarray:
    """(L,) int32 slot of sample t in a decimation-in-time line FFT over
    ``radices`` (r_0 first): t's mixed-radix digits with r_last least
    significant, digit i weighted by r_0*...*r_{i-1}."""
    radices = radix_plan(length) if radices is None else radices
    t, pos = np.arange(length), np.zeros(length, dtype=np.int64)
    weights = np.cumprod([1, *radices[:-1]])
    for r, w in zip(reversed(radices), reversed(weights)):
        pos += (t % r) * w
        t //= r
    return pos.astype(np.int32)


def line_table(length: int, radices=None) -> np.ndarray:
    """complex64 table of an L-point line FFT: W_L^m = exp(-2*pi*i*m/L) for
    m < L (the generic radix's butterflies), then each radix-R stage's
    twiddles in the order its threads read them: for P = the product of
    the earlier radices, (R - 1) rows k = 1..R-1 of P entries W_L^(k * j *
    L/(P*R)), j < P, so that neighbouring butterflies read neighbouring
    entries. Every entry comes from a float64 phase reduced mod L."""
    radices = radix_plan(length) if radices is None else radices
    phases, ns = [np.arange(length)], 1
    for r in radices:
        k = np.arange(1, r)[:, None]
        phases.append((k * np.arange(ns)[None, :]
                       * (length // (ns * r))).ravel())
        ns *= r
    return _phase_exp(np.concatenate(phases), np.ones(1), length)[:, 0]


def caf_tables(plan: dict) -> list[np.ndarray | None]:
    """The eight tables the kernels read, in the C order: the line tables
    of passes 0-2; the four-step twiddle of each column pass, W_M^(k*c) as
    a (f_i, cols) matrix with M = f_i*cols (pass 0: (f0, n/f0); pass 1 of a
    three-pass plan: (f1, f2)); the digit reversals of passes 0-2. None
    where the plan has no such pass."""
    f = plan["factors"]
    out = [line_table(x, r) for x, r in zip(f, plan["radices"])]
    out += [None] * (3 - len(f))
    cols = int(np.prod(f))
    for i in range(2):
        cols //= f[i] if i < len(f) else 1
        out.append(twiddle(f[i], cols) if i < len(f) - 1 else None)
    out += [digit_reversal(x, r) for x, r in zip(f, plan["radices"])]
    return out + [None] * (3 - len(f))


def _butterfly_matrix(wl: torch.Tensor, r: int) -> torch.Tensor:
    """(R, R) DFT matrix W_R^(a*b) read from an L-point line table."""
    a = torch.arange(r, device=wl.device)
    return wl[(a[:, None] * a[None, :] % r) * (wl.shape[0] // r)]


def fft_staged(x: torch.Tensor, radices=None,
               wl: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' line FFT along the last axis of complex64 x, stage by
    stage over the f32 line table (``line_table``): x goes to its
    digit-reversed slots (``digit_reversal``); at a radix-R stage with P =
    the product of the earlier radices and Q = P*R, butterfly u < L/R (j =
    u % P, b = u // P) reads slots b*Q + j + k*P, multiplies slot k by
    W_Q^(j*k), takes an R-point DFT and writes back in place. Natural order
    out."""
    length = x.shape[-1]
    radices = radix_plan(length) if radices is None else radices
    if wl is None:
        wl = torch.from_numpy(line_table(length, radices)).to(x.device)
    y = torch.empty_like(x)
    y[..., torch.from_numpy(digit_reversal(length, radices)).long()] = x
    p, off = 1, length
    for r in radices:
        u = torch.arange(length // r, device=x.device)
        j, k = u % p, torch.arange(r, device=x.device)
        slots = ((u // p) * p * r + j)[:, None] + k[None, :] * p   # (L/R, R)
        stage = torch.cat([torch.ones(1, p, dtype=wl.dtype, device=wl.device),
                           wl[off: off + (r - 1) * p].reshape(r - 1, p)])
        y[..., slots] = (y[..., slots] * stage[:, j].T) @ _butterfly_matrix(
            wl[:length], r)
        p, off = p * r, off + (r - 1) * p
    return y


def caf_staged(rx: torch.Tensor, cutout_conj: torch.Tensor,
               offsets: torch.Tensor, plan: dict | None = None):
    """The CAF kernels' pass schedule in torch over their tables: per shift
    s, the modulated window p[t] = rx[s + t] * cc[t] viewed as (f0, ..., f_
    last); each column pass an f_i-point ``fft_staged`` along its axis and
    the twiddle hi*lo of W_M^(k_i * c) (c the column, M the pass's
    modulus); the last pass a row FFT, |X|^2 and each row's peak; the
    reduction ``peak_winner``. Returns (peak |X|^2 as float32, int64 bin)
    per offset."""
    n = cutout_conj.shape[-1]
    plan = plan or caf_plan(n)
    f = plan["factors"]
    tabs = [None if t is None else torch.from_numpy(t).to(rx.device)
            for t in caf_tables(plan)]
    idx = offsets[:, None] + torch.arange(n, device=rx.device)[None, :]
    x = (rx[idx] * cutout_conj).reshape(offsets.shape[0], 1, f[0], -1)
    for i in range(len(f) - 1):
        # x: (shifts, rows, f_i, cols) -> column FFT along f_i, twiddle
        x = fft_staged(x.transpose(-1, -2), plan["radices"][i],
                       tabs[i]).transpose(-1, -2) * tabs[3 + i]
        cols = x.shape[-1]
        if i + 1 < len(f) - 1:
            x = x.reshape(x.shape[0], -1, f[i + 1], cols // f[i + 1])
    x = fft_staged(x.reshape(offsets.shape[0], -1, f[-1]), plan["radices"][-1],
                   tabs[len(f) - 1])
    return spectrum_peaks(x, f)


def spectrum_peaks(x: torch.Tensor, factors):
    """(peak |X|^2, int64 true bin) per transform of the plan ``factors``
    from its last-stage rows x (..., f_last), the R = f0*...*f_{L-2} rows of
    a transform consecutive: |X|^2, each row's peak and lowest argmax, then
    ``peak_winner``."""
    mag = x.real * x.real + x.imag * x.imag
    rowarg = torch.argmax(mag, dim=-1)
    rowmax = torch.gather(mag, -1, rowarg[..., None])[..., 0]
    rows = math.prod(factors[:-1])
    return peak_winner(rowmax.reshape(-1, rows), rowarg.reshape(-1, rows),
                       factors)


def stage2_staged(f1: torch.Tensor, tw: torch.Tensor, factors=None):
    """Kernel #4's schedule in torch: each row r of the (B, K1, J) stage-1
    output times tw[r % K1] as it is loaded, the J-point ``fft_staged`` over
    the row plan's tables, |X|^2, each row's peak, ``peak_winner`` over the
    plan ``factors`` (default (K1, J)). Returns (peak |X|^2 as float32,
    int64 true bin) per transform."""
    factors = tuple(factors or f1.shape[1:])
    j = f1.shape[-1]
    plan = row_plan(j)
    wl = torch.from_numpy(line_table(j, plan["radices"][0])).to(f1.device)
    return spectrum_peaks(fft_staged(f1 * tw, plan["radices"][0], wl),
                          factors)


def peak_sweep_staged(rx: torch.Tensor, cutout_conj: torch.Tensor,
                      offsets: torch.Tensor):
    """The "peak-kernel-hopper" route's schedule in torch over its tables:
    per shift s the window rx[s:s+n] * cc viewed as (n1, n2) (the two-pass
    ``caf_plan(n, min_passes=2)``), its n1-point column ``fft_staged``
    stored without the twiddle (col_pass's unmodulated store), then
    ``stage2_staged`` with TW = W_n^(k1*t2) applied on load. Returns (peak
    |X|^2 as float32, int64 bin) per offset."""
    n = cutout_conj.shape[-1]
    plan = caf_plan(n, min_passes=2)
    n1, n2 = plan["factors"]
    wl = torch.from_numpy(line_table(n1, plan["radices"][0])).to(rx.device)
    idx = offsets[:, None] + torch.arange(n, device=rx.device)[None, :]
    x = (rx[idx] * cutout_conj).reshape(-1, n1, n2)
    f1 = fft_staged(x.transpose(-1, -2), plan["radices"][0],
                    wl).transpose(-1, -2)
    tw = torch.from_numpy(twiddle(n1, n2)).to(rx.device)
    return stage2_staged(f1, tw, (n1, n2))


def _butterfly_flop(r: int) -> int:
    """f32 operations of one radix-r butterfly of csrc/fft_smem.cuh, its
    r - 1 twiddle products (6 each) included; a generic radix does r^2
    complex multiply-adds."""
    fixed = {2: 4, 3: 16, 4: 16, 5: 48, 8: 56}
    return fixed[r] + 6 * (r - 1) if r in fixed else 8 * r * r


def plan_flop(plan: dict) -> float:
    """f32 operations the CAF kernels do per shift under ``plan``: the
    window product (6 per sample), every line FFT's butterflies, each
    column pass's twiddle (6 per sample), |X|^2 and the row peak (3 per
    sample)."""
    f = plan["factors"]
    n = int(np.prod(f))
    ops = 6.0 * n + 3.0 * n + 6.0 * n * (len(f) - 1)
    for length, radices in zip(f, plan["radices"]):
        ops += (n // length) * sum(length // r * _butterfly_flop(r)
                                   for r in radices)
    return ops


def true_bins(rowarg: torch.Tensor, factors) -> torch.Tensor:
    """True bin of each row winner. rowarg (..., R) holds the last digit
    k_{L-1} of each of the R = f0*...*f_{L-2} rows of a transform, row r
    holding the digits (k0, ..., k_{L-2}) in row-major order; the bin is
    k0 + f0*(k1 + f1*(... + f_{L-2}*k_{L-1}))."""
    rem = torch.arange(rowarg.shape[-1], device=rowarg.device)
    bins = rowarg.long()
    for f in reversed(factors[:-1]):
        bins = rem % f + f * bins
        rem = rem // f
    return bins


def peak_winner(rowmax: torch.Tensor, rowarg: torch.Tensor, factors):
    """(peak, true bin) per transform from the per-row winners (..., R) of
    the last-stage peak kernel (the JAX ``_peak_winner``, ``ops/fft.py:122``).
    Ties go to the lowest true bin, as torch.argmax on the natural-order
    spectrum does; the JAX version takes the first row in permuted order."""
    bins = true_bins(rowarg, factors)
    peak = rowmax.max(dim=-1).values
    cand = torch.where(rowmax == peak[..., None], bins,
                       torch.iinfo(torch.int64).max)
    return peak, cand.min(dim=-1).values


def _fft_output_perm(factors) -> np.ndarray:
    """True bin of each position of the permuted spectrum of the plan
    ``factors`` (the JAX package's ``_fft_output_perm``): position
    (k1, j) holds bin k1 + n1 * perm_rest[j], k1-major."""
    if len(factors) == 1:
        return np.arange(factors[0], dtype=np.int64)
    n1 = factors[0]
    inner = _fft_output_perm(factors[1:])
    return (np.arange(n1, dtype=np.int64)[:, None]
            + n1 * inner[None, :]).reshape(-1)


PEAK_MODES = ("bf16", "bf16x3", "f32")


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype string."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class FourStepFFT:
    """Plan of an n-point DFT over the JAX package's stage factors
    (``pydsproutines_tpu/ops/fft.py:151``): ``factors`` and ``viable`` are
    the JAX plan's for every n (two balanced factors while their sum is at
    most 3000, else the multi-stage split when cheaper, a single stage for
    128 <= n < 4096, None for e.g. a large prime; ``factors`` given
    explicitly are kept).

    ``__call__`` is the DFT along the last axis, ``torch.fft.fft`` on the
    input's device and in its precision (complex128 stays complex128):
    the JAX stages are XLA einsums outside any Pallas kernel, so the
    library FFT is their plain form. ``call_permuted`` orders the same
    spectrum as the JAX stages leave it (``permutation``). ``call_peak``
    runs the leading stages in torch and the last stage on kernel #4.

    Not ported: ``device_gen`` and the host stage matrices (``stage_w``,
    ``stage_tw``, ``_mats``), the TPU transport's workarounds for large
    embedded constants. ``dtype`` (a torch or numpy dtype or a string) is
    kept as ``self.dtype``; the transforms follow their input's dtype.
    """

    def __init__(self, n: int, dtype=torch.complex64, max_factor: int = 8192,
                 factors: list[int] | None = None):
        self.n = int(n)
        self.dtype = _torch_dtype(dtype)
        if factors is None:
            factors = fft_factors(self.n, max_factor)
            self.viable = factors is not None
        else:
            factors = [int(f) for f in factors]
            self.viable = self.n >= 4096 and len(factors) >= 2
            if not self.viable and 128 <= self.n < 4096:
                factors, self.viable = [self.n], True
        self.factors = factors if self.viable else None
        self._tables = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.fft.fft(x, dim=-1)

    def call_permuted(self, x: torch.Tensor) -> torch.Tensor:
        """The DFT in the permuted order of the JAX stages: position j holds
        bin ``permutation[j]`` (the natural order where the plan is not
        viable, as in JAX)."""
        out = self(x)
        if not self.viable:
            return out
        return out[..., self._device_table("perm", out.device)]

    @property
    def permutation(self) -> np.ndarray:
        """int32 host array: the true bin of each ``call_permuted``
        position."""
        if not self.viable:
            raise ValueError(f"FourStepFFT({self.n}) is not viable: it has "
                             "no stage order")
        return _fft_output_perm(self.factors).astype(np.int32)

    def peak_viable(self, mode: str = "bf16") -> bool:
        """True when ``call_peak`` can run this plan: at least two factors
        and a last factor J in [2, SMEM_LINE_MAX = 8192], the row length
        kernel #4's shared-memory FFT takes (``row_plan``). The JAX test is
        a VMEM budget for the (J, J) stage matrix and row tiles
        (``pick_row_tile``), which refuses some plans the port takes, e.g.
        a two-factor plan with J = 8192; ``mode`` does not change the
        answer here."""
        return (self.viable and len(self.factors) >= 2
                and 2 <= self.factors[-1] <= SMEM_LINE_MAX)

    def _device_table(self, name: str, device: torch.device):
        """A table of the plan on ``device``, built once: "perm" (the
        gather of ``call_permuted``), "tw<s>" (stage s's twiddle, m =
        prod(factors[s:]) split as n1 x rest: exp(-2*pi*i*k1*j/m)), "peak"
        (kernel #4's (K1, J) twiddle). The tables stay with the plan, and
        ``get_fft_plan`` keeps its plans: the 10^7 plan's stage-0 twiddle
        holds 80 MB on each device it ran on."""
        key = (name, device)
        if key not in self._tables:
            f = self.factors
            if name == "perm":
                t = torch.from_numpy(_fft_output_perm(f))
            elif name == "peak":
                t = torch.from_numpy(peak_consts(f)[0])
            else:
                s = int(name[2:])
                m = math.prod(f[s:])
                t = torch.from_numpy(_phase_exp(np.arange(f[s]),
                                                np.arange(m // f[s]), m))
            self._tables[key] = t.to(device)
        return self._tables[key]

    def _leading_stages(self, x: torch.Tensor) -> torch.Tensor:
        """Stages 0..L-2 over the rows of x (B, n) complex64: stage s a
        ``torch.fft`` of length f_s down the strided axis of the (rows, f_s,
        rest) view, times its twiddle, the last of them without it (the JAX
        ``call_peak``, ``pydsproutines_tpu/ops/fft.py:327-335``). Returns
        the (B * f0 * ... * f_{L-3}, K1, J) input of kernel #4, rows in
        digit order (k0, ..., k_{L-2})."""
        f = self.factors
        cur, lead, m = x, x.shape[0], self.n
        for s, n1 in enumerate(f[:-1]):
            cur = torch.fft.fft(cur.reshape(lead, n1, m // n1), dim=1)
            if s < len(f) - 2:
                cur.mul_(self._device_table(f"tw{s}", x.device))
            lead, m = lead * n1, m // n1
        return cur.contiguous()

    def call_peak(self, x: torch.Tensor, mode: str = "bf16",
                  interpret: bool = False):
        """(peak |X[k]|^2 as float32, its bin k as int64) over the DFT of
        each row of x (..., n), in x's leading shape, without the spectrum:
        the leading stages in torch (``_leading_stages``), then the last
        twiddle, the J-point DFT, |.|^2 and the peak on kernel #4
        (``stage2_peak``: the kernel for a CUDA tensor, its plain twin for a
        CPU one). Ties go to the lowest true bin, the rule of
        ``np.argmax`` on the natural spectrum (the JAX docstring promises
        the first in permuted order).

        Every route computes in f32 whatever ``mode`` is ("bf16", "bf16x3"
        or "f32", validated as JAX does): the port takes no precision below
        f32. ``interpret`` is kept for the JAX signature and has no effect.
        Raises ValueError where ``peak_viable`` does not hold."""
        if mode not in PEAK_MODES:
            raise ValueError(f"call_peak mode {mode!r} is not one of "
                             f"{PEAK_MODES}")
        if not self.peak_viable(mode):
            raise ValueError(f"FourStepFFT({self.n}), factors {self.factors}"
                             ": no plan of kernel #4 (at least two factors "
                             f"and a last factor in [2, {SMEM_LINE_MAX}])")
        if x.shape[-1] != self.n:
            raise ValueError(f"rows of {x.shape[-1]} samples for an "
                             f"{self.n}-point plan")
        from pydsproutines_tpu_torch.ops.hopper.fft_peak import stage2_peak
        lead = x.shape[:-1]
        f1 = self._leading_stages(x.reshape(-1, self.n).to(torch.complex64))
        peak, bins = stage2_peak(f1, self._device_table("peak", x.device),
                                 tuple(self.factors))
        return peak.reshape(lead), bins.reshape(lead)

    def call_peak_planes(self, xr: torch.Tensor, xi: torch.Tensor,
                         mode: str = "bf16", interpret: bool = False,
                         mats=None):
        """``call_peak`` over separate real and imaginary planes (..., n).
        ``mode`` is "bf16" or "f32" (ValueError otherwise, as in JAX); the
        planes are interleaved once and take ``call_peak``'s path in f32.
        The JAX plane route exists to store bf16 intermediates; the port
        keeps f32 ones. ``interpret`` and ``mats`` are kept for the JAX
        signature and have no effect."""
        if mode not in ("bf16", "f32"):
            raise ValueError("call_peak_planes supports bf16/f32 only")
        return self.call_peak(torch.complex(xr.to(torch.float32),
                                            xi.to(torch.float32)), mode)


@functools.lru_cache(maxsize=64)
def get_fft_plan(n: int, dtype_str: str = "complex64") -> FourStepFFT:
    """The cached plan of ``FourStepFFT(n, dtype_str)``."""
    return FourStepFFT(n, dtype=dtype_str)


def fft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The DFT along ``axis`` through the plan of its length (the JAX
    package's drop-in ``fft``)."""
    if axis not in (-1, x.ndim - 1):
        return fft(x.movedim(axis, -1), -1).movedim(-1, axis)
    plan = get_fft_plan(int(x.shape[-1]), "complex128"
                        if x.dtype == torch.complex128 else "complex64")
    return plan(x)


def ifft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The inverse DFT along ``axis``, ``torch.fft.ifft``: equal within
    rounding to the JAX package's conj(fft(conj(x))) / n."""
    return torch.fft.ifft(x, dim=axis)
