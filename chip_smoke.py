#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written Hopper kernels from ``pydsproutines_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time.
2. Checks each kernel against its plain PyTorch twin on the card at the
   main path's shapes: the WOLA channelizer at 131,072 rows x 64 channels
   with 2048 taps, and at N = Dec = 128 and 256 with 8 taps a channel (the
   JAX ``_kernel_direct`` shapes); the CAF peak search (shared-memory FFT,
   its plan's passes, split and scratch printed) at n = 1,000,000 x 128
   shifts and at n = 1024 x 256 shifts on a 131,072-sample channel; the
   shift-list CAF peak search at n = 10,000,000 x 128 shifts, and at
   shifts[0] > 0 in an rx that ends exactly at the last window; the
   last-stage peak kernel (twiddle on load, 1000-point row FFTs in shared
   memory) on the (128, 1000, 1000) stage-1 output of a 1M sweep over a
   sorted non-uniform list of 128 shifts (the column pass of that route,
   stored without its twiddle), against its twin, ``torch.matmul`` by the
   DFT matrix and ``torch.fft.fft`` of the twiddled rows, and that sweep's
   route against torch.fft; upfirdn through ``fir_upfirdn_planes_flat`` at
   the JAX bench's chain (4,194,304 complex samples, 128 FIR and 95
   resampler taps, up 5, down 4: 730 combined taps), and the median filter
   at 4,194,304 float32 samples with k = 129 (bit-equal), each also against
   scipy at a reduced size; the group CAF at the JAX bench's group-xcorr
   cell (8 groups of 4096 samples every 16,384, 128 CZT bins of fs/16384,
   1024 shifts of an rx of 119,872 samples, a copy planted at shift 517 and
   bin 70), on the uniform sweep and on a sorted list of 128 of its shifts
   (a 3xTF32 product on the tensor cores, wgmma, over the tone bank split
   at plan build);
   the sliding normalised matched filter at 4,194,304 samples x 4 templates
   of 1024 with one template planted, and against numpy at a reduced size.
3. Drives the main path through the public entry points, with every kernel's
   launch count set to 0 first: ``WidebandReceiver(64 ch, 2048 taps,
   template 1024, 256 shifts).run`` on an 8,388,608-sample wideband scene
   (a QPSK template on channel 1), then ``fast_xcorr(freqsearch=True)`` at
   1M x 128, at 10M x 128 ("fused3-hopper") and at 1M over the shift list
   ("peak-kernel-hopper"), each with a planted peak; the resampling chain
   ``fir_upfirdn_planes_flat`` at the bench geometry; and the burst-detection
   front end on an 8,388,608-sample scene with three bursts of the template
   on channel 1: ``Channeliser.channelise`` -> strongest channel ->
   ``BurstDetector(129).medfilt`` -> ``auto_detect_threshold`` ->
   ``detect_via_threshold`` -> ``fast_xcorr`` on each detected slice.
   Then, each with every launch count set to 0 just before it and read
   just after: ``GroupXcorrCZT(...).xcorr`` over the bench cell's 1024
   shifts ("group-caf-hopper"), and ``sliding_multiply_normalised`` at
   4,194,304 x 4 x 1024.
   Checks the routes, the launch counts, the planted channel, edges, shifts
   and bins, the receiver's answer and the detection chain's against the
   same calls on the CPU (plain twins), both big-window routes and the group
   sweep (64 shifts) against the same calls on CPU tensors at a reduced
   size.
4. Times each kernel, its twin, the one PyTorch library call that computes
   the same function where there is one (timed here only; the port never
   calls it), the whole receiver step, the whole detection chain, the
   resampling chain's and the group sweep's public entry points and
   ``sliding_multiply_normalised`` on CUDA events (one warm-up, median of
   >= 3), each line tagged with the card's name and power limit; and
   computes each kernel's bound: the larger of the fewest operations that
   compute its function (its own algorithm's or an FFT formulation's,
   whichever is fewer; both are printed) over the f32 peak and its bytes
   (each input read once, each output written once) over the HBM rate.
   The CAF kernels' own count is their plan's (``ops/fft.plan_flop``; for
   the last-stage peak kernel its row plan's); the group CAF's is the f32
   count of its product, which it runs as three TF32 passes.

Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the script exits non-zero and prints no result; so does a
machine without CUDA.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# Tolerances, with their reasons:
# - WOLA kernel vs twin: both f32; the twin's IDFT is torch.fft, the
#   kernel's a direct f32 sum, so they differ by summation order only:
#   max|d| / max|ref| < 1e-5 (the CPU parity tests' bound).
WOLA_RTOL = 1e-5
# - CAF peak |X|^2 per shift, kernel vs twin: the kernel's shared-memory f32
#   FFT over f32 tables vs cuFFT; relative error of each shift's maximum
#   < 1e-4 (the QF^2 tolerance of the CPU parity tests). Peak shift and bin
#   must be equal.
CAF_RTOL = 1e-4
# - upfirdn kernel vs twin: f32 FMA chains of 146 taps per phase against a
#   full-f32 matrix product; max|d| / max|ref| < 1e-5 (the WOLA bound). At
#   a reduced size against float64 scipy: tests/test_filters.py:181's
#   atol 2e-4*sqrt(T), rtol 1e-4.
UPFIRDN_RTOL = 1e-5
# - medfilt kernel vs twin and scipy: bit-equal (an exact order statistic).
# - group CAF |C|^2 kernel vs twin: per-shift maximum within CAF_RTOL (f32
#   sums of 32,768 products in another order); the planted shift and bin
#   equal; and every bin of every shift, on the QF^2 scale users threshold,
#   within GROUP_QF2_ATOL, on the sweep and on the list, as is the public
#   sweep's grid on the card vs on the CPU. Sound runs read 8.1e-7 (H100);
#   a noise bin's QF^2 is about 1/(G*m) = 3.1e-5, so a bin moved or lost
#   anywhere in the grid exceeds the limit.
GROUP_QF2_ATOL = 4e-6
# - sliding QF^2 kernel vs twin and numpy: max|d| / max|ref| < 1e-5 (the JAX
#   kernel test's bound, tests/test_extras.py:317).
SLIDING_RTOL = 1e-5

# One H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores and HBM.
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12

NCH, TAPS, ROWS = 64, 2048, 131072
# the JAX _kernel_direct shapes (N = Dec = 128, 256; 8 taps a channel), the
# same 8,388,608 samples as the N = 64 case
WOLA_DIRECT = ((128, 1024, 65536), (256, 2048, 32768))
N_BIG, SHIFTS_BIG = 1_000_000, 128
N_RX, SHIFTS_RX, CHAN_LEN = 1024, 256, 131072
N_3, SHIFTS_3 = 10_000_000, 128          # the three-stage kernel's sweep
EDGE_S0, EDGE_STEP, EDGE_SHIFTS = 1000, 3, 8   # shifts[0] > 0, rx ends there
N_4, SHIFTS_4, SPAN_4 = 1_000_000, 128, 1024   # 128 sorted shifts of 1024
N_3_CPU, N_4_CPU = 2**21, 65536          # CPU comparison of the two routes
N_FIR, FIR_TAPS, RS_TAPS, UP, DOWN = 4_194_304, 128, 95, 5, 4   # bench.py:204
N_MED, MED_K = 4_194_304, 129            # ops/pallas/medfilt.py:5
N_SMALL = 65536                          # reduced-size checks against scipy
# the JAX bench's group-xcorr cell (bench.py:340): 8 groups of 4096 every
# 16,384, 128 bins of fs/4096/4 at fs = 1e6, 1024 shifts of step 1
G_GROUPS, G_LEN, G_BINS, G_SHIFTS, G_FS = 8, 4096, 128, 1024, 1e6
G_STAR, G_BIN = 517, 70                  # planted shift and CZT bin
G_LIST, G_CPU = 128, 64                  # shift-list length; CPU check span
N_SL, T_SL, L_SL = 4_194_304, 4, 1024    # sliding: chain length, templates
SL_T, SL_S = 2, 1_234_567                # planted template and shift
BURSTS = (20000, 60000, 100000)          # channel-rate burst positions
EDGE_MARGIN = 16                         # detected edge vs planted burst
SEARCH = 64                              # xcorr shifts either side of an edge
# noise-level grid of auto_detect_threshold: 1 dB steps, -30 .. 0 dB
NOISE_LEVELS_DB = np.arange(-30, 1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def fft_flop(n: float) -> float:
    """Operations of one n-point complex FFT, the customary 5 n log2 n."""
    return 5.0 * n * math.log2(n) if n > 1 else 0.0


def ols_flop(n_out: int, taps: int, filters: int) -> float:
    """Operations of the cheapest overlap-save FFT correlation of one
    complex stream with ``filters`` filters of ``taps`` samples, ``n_out``
    outputs each, over power-of-two blocks: each filter's transform once;
    per block one forward transform shared by the filters, and per filter a
    product (6 per point) and an inverse transform."""
    best, nfft = math.inf, 1 << max(taps - 1, 0).bit_length()
    while True:
        valid = nfft - taps + 1
        blocks = -(-n_out // valid)
        best = min(best, filters * fft_flop(nfft) + blocks * (
            fft_flop(nfft) + filters * (6.0 * nfft + fft_flop(nfft))))
        if valid >= n_out:
            return best
        nfft *= 2


def bound(algorithm_flop: float, fft_form_flop: float,
          nbytes: float) -> dict:
    """The least time one H100 could take for a kernel's function: the
    larger of the fewest f32 operations that compute it (its own
    algorithm's, ``algorithm_flop``, or an FFT formulation's, whichever is
    fewer) over the f32 peak, and the bytes it must move (each input read
    once, each output written once) over the HBM rate."""
    flop = min(algorithm_flop, fft_form_flop)
    t_ops, t_bytes = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_flop": flop, "algorithm_flop": algorithm_flop,
            "bound_bytes": nbytes}


def wola_bound(rows: int, nch: int, taps: int) -> dict:
    """WOLA (N == Dec): the direct IDFT per row, or an FFT; the fold of
    taps/N taps either way; complex64 in and out, f32 taps."""
    outs = rows * nch
    return bound(outs * (8.0 * nch + 4.0 * taps / nch),
                 rows * (4.0 * taps + fft_flop(nch)), 16 * outs + 4 * taps)


def plan_info(launch, shifts: int) -> dict:
    """The CAF kernels' plan at one sweep: passes, split, lines per block,
    scratch bytes of one chunk and the plan's f32 operations."""
    from pydsproutines_tpu_torch.ops.fft import plan_flop
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (
        SCRATCH_BYTES_PER_SAMPLE)
    from pydsproutines_tpu_torch.utils.memory import chunk_shifts
    nb = chunk_shifts(launch.n, shifts, SCRATCH_BYTES_PER_SAMPLE)
    return {"passes": launch.passes, "factors": list(launch.factors),
            "lines": list(launch.plan["lines"]),
            "scratch_bytes": launch.scratch_bytes(nb),
            "plan_flop": plan_flop(launch.plan) * shifts}


def plan_keys(info: dict) -> dict:
    return {k: info[k] for k in ("passes", "factors", "lines",
                                 "scratch_bytes")}


def plan_text(info: dict) -> str:
    return (f"{info['passes']} pass(es), split "
            f"{'x'.join(map(str, info['factors']))}, lines per block "
            f"{info['lines']}, scratch {info['scratch_bytes']} B per chunk")


def group_scene(rng, device):
    """(GroupXcorrCZT built with no device, so on the card; the same on
    the CPU; rx on ``device``) at the bench's group-xcorr cell: a random
    template's 8 groups planted at shift G_STAR on CZT bin G_BIN, in
    noise."""
    import torch
    from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT
    starts = np.arange(G_GROUPS) * 4 * G_LEN
    span = int(starts[-1] + G_LEN)
    y = (rng.standard_normal(span) + 1j * rng.standard_normal(span))
    rxlen = span + G_SHIFTS + 64
    rx = 0.7 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    bw = G_FS / G_LEN / 4
    f1, f2 = -G_BINS / 2 * bw, (G_BINS / 2 - 1) * bw
    f_star = f1 + G_BIN * bw
    rx[G_STAR: G_STAR + span] += y * np.exp(2j * np.pi * f_star
                                            * np.arange(span) / G_FS)
    args = (y.astype(np.complex64), starts, np.full(G_GROUPS, G_LEN), f1, f2,
            bw, G_FS)
    return (GroupXcorrCZT(*args), GroupXcorrCZT(*args, device="cpu"),
            torch.from_numpy(rx.astype(np.complex64)).to(device))


def planted_sweep(rng, n, num_shifts, s_star, f_star, device):
    """cutout, rx with cutout * exp(2*pi*i*f_star*t/n) planted at shift
    s_star in noise: the peak is at (s_star, bin f_star)."""
    import torch
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    rxlen = n + num_shifts - 1
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    t = np.arange(n)
    rx[s_star: s_star + n] += cut * np.exp(2j * np.pi * f_star * t / n)
    return (torch.from_numpy(cut.astype(np.complex64)).to(device),
            torch.from_numpy(rx.astype(np.complex64)).to(device))


def listed_sweep(rng, n, offsets, i_star, f_star, device):
    """cutout, rx for a sweep over ``offsets`` with rx ending exactly at the
    last window, the planted peak at (offsets[i_star], f_star)."""
    import torch
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    rxlen = int(offsets[-1]) + n
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    s = int(offsets[i_star])
    rx[s: s + n] += cut * np.exp(2j * np.pi * f_star * np.arange(n) / n)
    return (torch.from_numpy(cut.astype(np.complex64)).to(device),
            torch.from_numpy(rx.astype(np.complex64)).to(device))


def qf2_abs_err(km, pm, cut, rx, offsets, n) -> float:
    """Largest kernel-vs-twin difference on the QF^2 scale (0..1) users
    threshold."""
    import torch
    power = torch.cumsum((rx.abs() ** 2).double(), 0)
    power = torch.cat([power.new_zeros(1), power])
    norm = float((cut.abs() ** 2).sum(dtype=torch.float64)) * (
        power[offsets + n] - power[offsets])
    return float(((km.double() - pm.double()) / norm).abs().max())


def hold_peaks(name, km, kb, pm, pb, i_star, f_star) -> float:
    """Check a kernel's per-shift (peak, bin) against its twin's: finite,
    same shape, per-shift peak within CAF_RTOL, the planted shift and bin
    exact. Returns the per-shift relative error."""
    import torch
    torch.cuda.synchronize()
    check(bool(torch.isfinite(km).all()) and km.shape == pm.shape,
          f"{name} output shape or finiteness")
    err = float(((km - pm).abs() / pm).max())
    check(err < CAF_RTOL, f"{name} kernel vs twin rel err {err:.3e}")
    ks, ps = int(torch.argmax(km)), int(torch.argmax(pm))
    check(ks == ps == i_star, f"{name} peak shift {ks} / {ps}")
    check(int(kb[ks]) == int(pb[ps]) == f_star,
          f"{name} peak bin {int(kb[ks])} / {int(pb[ps])}")
    return err


def wideband_scene(rcv, n_wide: int, seed: int):
    """(template_ri, rx_ri) on the receiver's device: a QPSK template held
    for one channel-rate sample per symbol (a rectangular pulse of Dec
    samples), on the channel-1 tone, in noise. Unlike the impulse-train
    example of ``example_inputs``, its energy sits in channel 1, so the
    strongest channel is the planted one."""
    import torch
    rng = np.random.default_rng(seed)
    dec = rcv.dec
    syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, rcv.template_len))
    rx = 0.1 * (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
    start = (rcv.num_shifts // 2 + rcv.num_taps // dec) * dec
    span = slice(start, start + rcv.template_len * dec)
    t = np.arange(span.start, span.stop)
    rx[span] += np.repeat(syms, dec) * np.exp(2j * np.pi * t / rcv.num_channels)
    tri = np.stack([syms.real, syms.imag]).astype(np.float32)
    xri = np.stack([rx.real, rx.imag]).astype(np.float32)
    dev = rcv.f_tap.device
    return torch.from_numpy(tri).to(dev), torch.from_numpy(xri).to(dev)


def burst_scene(n_wide: int, template_len: int, seed: int, device):
    """(template, rx) complex64 on ``device``: three bursts of one QPSK
    template, each symbol held for Dec = 64 samples on the channel-1 tone,
    in noise, built as ``wideband_scene`` builds its one burst. Burst b
    starts at wideband sample 64*(BURSTS[b] - 17) + 32, so that after the
    2048-tap channelizer's 1023.5-sample delay channel 1 samples each symbol
    at its centre from channel-rate sample BURSTS[b] on."""
    import torch
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, template_len))
    rx = 0.1 * (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
    for p in BURSTS:
        start = 64 * (p - 17) + 32
        t = np.arange(start, start + template_len * 64)
        rx[start: t[-1] + 1] += np.repeat(syms, 64) * np.exp(2j * np.pi * t / 64)
    return (torch.from_numpy(syms.astype(np.complex64)).to(device),
            torch.from_numpy(rx.astype(np.complex64)).to(device))


def detection_chain(chan, template, rx):
    """The burst-detection front end through the public entry points:
    channelise, strongest channel, median-filtered power, histogram
    threshold, edges, then fast_xcorr of the template over each detected
    slice. Returns the channel, threshold, edges and per-edge (shift, bin,
    QF^2) of the peak."""
    import torch
    from pydsproutines_tpu_torch.ops.detection import BurstDetector
    from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr
    chan.reset()
    ch = chan.channelise(rx)
    energy = torch.mean(ch.real ** 2 + ch.imag ** 2, dim=0)
    best = int(torch.argmax(energy))
    x = ch[:, best].contiguous()
    bd = BurstDetector(MED_K)
    bd.medfilt(x)
    thr = bd.auto_detect_threshold(10.0 ** (NOISE_LEVELS_DB / 10))
    check(thr is not None, "auto_detect_threshold found no threshold")
    edges = bd.detect_via_threshold(thr, capacity=16, min_length=512)
    count = int(edges.count)
    spans = list(zip(edges.starts[:count].tolist(),
                     edges.ends[:count].tolist()))
    n = template.shape[-1]
    peaks = []
    for start, _ in spans:
        s0 = min(max(0, start - SEARCH), x.shape[0] - n)
        qf2, bins = fast_xcorr(template, x[s0: s0 + n + 2 * SEARCH], True)
        k = int(torch.argmax(qf2))
        peaks.append((s0 + k, int(bins[k]), float(qf2[k])))
    return {"channel": best, "threshold": thr, "edges": spans,
            "peaks": peaks}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure",
              file=sys.stderr)
        return 1
    from scipy import signal as sps

    from pydsproutines_tpu_torch.models import WidebandReceiver
    from pydsproutines_tpu_torch.ops.detection import energy_detection
    from pydsproutines_tpu_torch.ops.filters import (fir_upfirdn_planes_flat,
                                                     get_upfirdn_size, medfilt,
                                                     select_medfilt_path,
                                                     select_upfirdn_path)
    from pydsproutines_tpu_torch.ops.fft import (dft_matrix, plan_flop,
                                                 row_plan, twiddle)
    from pydsproutines_tpu_torch.ops.hopper import _build
    from pydsproutines_tpu_torch.ops.hopper.fft_peak import (
        peak_sweep, stage2_peak, stage2_peak_plain, sweep_plan,
        window_columns)
    from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import (
        caf3_peak, caf3_peak_plain)
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (
        caf_launch, caf_peak, caf_peak_plain)
    from pydsproutines_tpu_torch.ops.groupxcorr import select_group_caf_path
    from pydsproutines_tpu_torch.ops.hopper.group_caf import (
        _group_caf_cuda, group_caf, group_caf_plain)
    from pydsproutines_tpu_torch.ops.hopper.medfilt import (medfilt_kernel,
                                                            medfilt_plain)
    from pydsproutines_tpu_torch.ops.hopper.sliding import (
        _sliding_cuda, sliding_multiply_normalised,
        sliding_multiply_normalised_reference, sliding_plain)
    from pydsproutines_tpu_torch.ops.hopper.upfirdn import (
        upfirdn_planes, upfirdn_planes_plain)
    from pydsproutines_tpu_torch.ops.hopper.wola_fused import (wola_fused,
                                                               wola_plain)
    from pydsproutines_tpu_torch.ops.wola import Channeliser, select_wola_path
    from pydsproutines_tpu_torch.ops.xcorr import (fast_xcorr, power_prefix,
                                                   select_xcorr_path)
    from pydsproutines_tpu_torch.utils.dtypes import full_f32
    from pydsproutines_tpu_torch.utils.timing import Timer, median_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    rng = np.random.default_rng(2024)

    # 1) build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.seconds:.2f} s, "
          f"compiled={_build.build_info.compiled})")
    for line in _build.build_info.log.splitlines():
        if "registers" in line or "Function properties" in line:
            print("  ptxas:", line.strip())

    # 2) kernels vs plain twins at the slice's shapes --------------------------
    h = torch.from_numpy(sps.firwin(TAPS, 1.0 / NCH).astype(np.float32)).to(dev)
    xw = torch.from_numpy(
        (rng.standard_normal(ROWS * NCH) + 1j * rng.standard_normal(ROWS * NCH)
         ).astype(np.complex64)).to(dev)
    got, ref = wola_fused(h, xw, NCH), wola_plain(h, xw, NCH, NCH)
    torch.cuda.synchronize()
    wola_err = rel_err(got, ref)
    wola_abs = float((got - ref).abs().max())
    check(got.shape == (ROWS, NCH) and bool(torch.isfinite(got.real).all()),
          "WOLA output shape or finiteness")
    check(wola_err < WOLA_RTOL, f"WOLA kernel vs twin rel err {wola_err:.3e}")
    wola_ms = median_ms(lambda: wola_fused(h, xw, NCH), reps=5)
    wola_plain_ms = median_ms(lambda: wola_plain(h, xw, NCH, NCH), reps=5)
    print(f"wola {ROWS}x{NCH} ch, {TAPS} taps: kernel {wola_ms:.4f} ms, "
          f"plain {wola_plain_ms:.4f} ms, rel err {wola_err:.3e} {tag}")
    wola_direct = []
    for nd, taps_d, rows_d in WOLA_DIRECT:
        hd = torch.from_numpy(sps.firwin(taps_d, 1.0 / nd).astype(
            np.float32)).to(dev)
        xd = xw[: rows_d * nd]
        got, ref = wola_fused(hd, xd, nd), wola_plain(hd, xd, nd, nd)
        torch.cuda.synchronize()
        err_d = rel_err(got, ref)
        check(got.shape == (rows_d, nd) and err_d < WOLA_RTOL,
              f"WOLA N={nd} kernel vs twin rel err {err_d:.3e}")
        wola_direct.append({
            "shape": f"{rows_d}x{nd} ch, {taps_d} taps",
            "max_abs_err": float((got - ref).abs().max()),
            "ms": median_ms(lambda: wola_fused(hd, xd, nd), reps=5),
            "plain_ms": median_ms(lambda: wola_plain(hd, xd, nd, nd), reps=5),
            **wola_bound(rows_d, nd, taps_d)})
        print(f"wola {rows_d}x{nd} ch, {taps_d} taps: kernel "
              f"{wola_direct[-1]['ms']:.4f} ms, plain "
              f"{wola_direct[-1]['plain_ms']:.4f} ms, bound "
              f"{wola_direct[-1]['bound_ms']:.4f} ms "
              f"({wola_direct[-1]['bound_by']}), rel err {err_d:.3e} {tag}")
        del got, ref

    caf = {}
    for n, nshift, s_star, f_star, rxlen in (
            (N_BIG, SHIFTS_BIG, 77, 12345, None),
            (N_RX, SHIFTS_RX, 100, 5, CHAN_LEN)):
        cut, rx = planted_sweep(rng, n, rxlen - n + 1 if rxlen else nshift,
                                s_star, f_star, dev)
        cc = cut.conj().resolve_conj().contiguous()
        km, kb = caf_peak(rx, cc, 0, 1, nshift, 128)
        pm, pb = caf_peak_plain(rx, cc, 0, 1, nshift, 128)
        err = hold_peaks(f"CAF n={n}", km, kb, pm, pb, s_star, f_star)
        reps = 3 if n == N_BIG else 5
        k_ms = median_ms(lambda: caf_peak(rx, cc, 0, 1, nshift, 128), reps=reps)
        p_ms = median_ms(lambda: caf_peak_plain(rx, cc, 0, 1, nshift, 128),
                         reps=reps)
        caf[n] = {"ms": k_ms, "plain_ms": p_ms, "rel_err": err,
                  **plan_info(caf_launch(n, dev), nshift),
                  "max_abs_err": qf2_abs_err(
                      km, pm, cut, rx, torch.arange(nshift, device=dev), n),
                  "cut": cut, "rx": rx, "s_star": s_star, "f_star": f_star}
        print(f"caf n={n} x {nshift} shifts: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, per-shift rel err {err:.3e}, peak at shift "
              f"{s_star} bin {f_star}; {plan_text(caf[n])} {tag}")

    # the three-stage kernel at 10M x 128, then at shifts[0] > 0 with rx
    # ending exactly at the last window
    offs3 = torch.arange(SHIFTS_3, device=dev)
    cut3, rx3 = listed_sweep(rng, N_3, offs3.cpu().numpy(), 77, 1234567, dev)
    cc3 = cut3.conj().resolve_conj().contiguous()
    km, kb = caf3_peak(rx3, cc3, offs3)
    pm, pb = caf3_peak_plain(rx3, cc3, offs3)
    err3 = hold_peaks(f"caf3 n={N_3}", km, kb, pm, pb, 77, 1234567)
    abs3 = qf2_abs_err(km, pm, cut3, rx3, offs3, N_3)
    caf3_ms = median_ms(lambda: caf3_peak(rx3, cc3, offs3), reps=3)
    caf3_plain_ms = median_ms(lambda: caf3_peak_plain(rx3, cc3, offs3), reps=3)
    plan3 = plan_info(caf_launch(N_3, dev), SHIFTS_3)
    print(f"caf3 n={N_3} x {SHIFTS_3} shifts: kernel {caf3_ms:.4f} ms, plain "
          f"{caf3_plain_ms:.4f} ms, per-shift rel err {err3:.3e}, QF^2 abs "
          f"err {abs3:.3e}; {plan_text(plan3)} {tag}")
    edge = torch.arange(EDGE_SHIFTS, device=dev) * EDGE_STEP + EDGE_S0
    cute, rxe = listed_sweep(rng, N_3, edge.cpu().numpy(), 5, 4242, dev)
    cce = cute.conj().resolve_conj().contiguous()
    check(rxe.shape[0] == int(edge[-1]) + N_3, "edge rx length")
    km, kb = caf3_peak(rxe, cce, edge)
    pm, pb = caf3_peak_plain(rxe, cce, edge)
    erre = hold_peaks("caf3 shifts[0] > 0 at the end of rx", km, kb, pm, pb,
                      5, 4242)
    print(f"caf3 n={N_3}, shifts {EDGE_S0} + {EDGE_STEP}*i, i < {EDGE_SHIFTS}, "
          f"rx ends at the last window: per-shift rel err {erre:.3e}")
    del rxe, cute, cce

    # the last-stage peak kernel on a 1M sweep over a sorted shift list
    offs4 = torch.from_numpy(np.sort(rng.choice(
        SPAN_4, SHIFTS_4, replace=False))).to(dev)
    cut4, rx4 = listed_sweep(rng, N_4, offs4.cpu().numpy(), 77, 54321, dev)
    cc4 = cut4.conj().resolve_conj().contiguous()
    plan4 = sweep_plan(N_4)
    n1, n2 = plan4["factors"]
    tw4 = torch.from_numpy(twiddle(n1, n2)).to(dev)
    f1 = window_columns(rx4, cc4, offs4)
    km, kb = stage2_peak(f1, tw4)
    pm, pb = stage2_peak_plain(f1, tw4)
    err4 = hold_peaks(f"stage2_peak ({SHIFTS_4}, {n1}, {n2})", km, kb, pm, pb,
                      77, 54321)
    abs4 = qf2_abs_err(km, pm, cut4, rx4, offs4, N_4)
    s2_ms = median_ms(lambda: stage2_peak(f1, tw4), reps=5)
    s2_plain_ms = median_ms(lambda: stage2_peak_plain(f1, tw4), reps=3)
    w24 = torch.from_numpy(dft_matrix(n2)).to(dev)
    with full_f32():                  # the last stage's product alone
        s2_lib_ms = median_ms(lambda: torch.matmul(f1, w24), reps=3)
    f1t = f1 * tw4                    # the twiddled rows, then cuFFT alone
    s2_fft_ms = median_ms(lambda: torch.fft.fft(f1t, dim=-1), reps=3)
    del f1, f1t, w24
    km, kb = peak_sweep(rx4, cc4, offs4)
    pm, pb = caf3_peak_plain(rx4, cc4, offs4)
    errs = hold_peaks(f"peak sweep n={N_4}", km, kb, pm, pb, 77, 54321)
    sweep_ms = median_ms(lambda: peak_sweep(rx4, cc4, offs4), reps=3)
    sweep_plain_ms = median_ms(lambda: caf3_peak_plain(rx4, cc4, offs4),
                               reps=3)
    print(f"stage2_peak ({SHIFTS_4}, {n1}, {n2}): kernel {s2_ms:.4f} ms, plain "
          f"{s2_plain_ms:.4f} ms, torch.matmul {s2_lib_ms:.4f} ms, torch.fft "
          f"{s2_fft_ms:.4f} ms, rel err {err4:.3e}; shift-list sweep n={N_4} "
          f"x {SHIFTS_4}: column pass + kernel {sweep_ms:.4f} ms, torch.fft "
          f"{sweep_plain_ms:.4f} ms, rel err {errs:.3e} {tag}")

    # upfirdn at the JAX bench's resampling chain, planes read where they lie
    frng = np.random.default_rng(1)
    x_ri = frng.standard_normal((2, N_FIR), dtype=np.float32)
    h_fir = frng.standard_normal(FIR_TAPS).astype(np.float32)
    h_rs = frng.standard_normal(RS_TAPS).astype(np.float32)
    fre, fim = (torch.from_numpy(p).to(dev) for p in x_ri)
    n_fir_out = get_upfirdn_size(N_FIR, RS_TAPS, UP, DOWN)
    y_re, y_im = fir_upfirdn_planes_flat(h_fir, h_rs, fre, fim, UP, DOWN)
    hu = np.zeros(FIR_TAPS * UP - (UP - 1))
    hu[::UP] = h_fir
    h64 = np.convolve(hu, h_rs.astype(np.float64))
    h32 = torch.from_numpy(h64.astype(np.float32)).to(dev)
    r_re, r_im = upfirdn_planes_plain((fre, fim), h32, UP, DOWN, n_fir_out)
    torch.cuda.synchronize()
    got_f, ref_f = torch.stack([y_re, y_im]), torch.stack([r_re, r_im])
    check(got_f.shape == (2, n_fir_out) and bool(torch.isfinite(got_f).all()),
          "upfirdn output shape or finiteness")
    fir_err = rel_err(got_f, ref_f)
    fir_abs = float((got_f - ref_f).abs().max())
    check(fir_err < UPFIRDN_RTOL, f"upfirdn kernel vs twin rel err "
                                  f"{fir_err:.3e}")
    s_re, s_im = fir_upfirdn_planes_flat(h_fir, h_rs, fre[:N_SMALL],
                                         fim[:N_SMALL], UP, DOWN)
    xs = x_ri[0, :N_SMALL].astype(np.float64) + 1j * x_ri[1, :N_SMALL]
    truth = sps.upfirdn(h64, xs, UP, DOWN)[: s_re.shape[0]]
    np.testing.assert_allclose(
        s_re.cpu().numpy() + 1j * s_im.cpu().numpy(), truth,
        atol=2e-4 * np.sqrt(h64.size), rtol=1e-4,
        err_msg="upfirdn kernel vs float64 scipy")
    fir_ms = median_ms(lambda: upfirdn_planes((fre, fim), h32, UP, DOWN,
                                              n_fir_out), reps=5)
    fir_plain_ms = median_ms(lambda: upfirdn_planes_plain(
        (fre, fim), h32, UP, DOWN, n_fir_out), reps=5)
    # the public entry point: host tap key and combination (cached) + copy
    # of the combined taps to the card + the kernel
    fir_chain_ms = median_ms(lambda: fir_upfirdn_planes_flat(
        h_fir, h_rs, fre, fim, UP, DOWN), reps=5)
    print(f"upfirdn {N_FIR} complex, {h64.size} taps, {UP}/{DOWN}: kernel "
          f"{fir_ms:.4f} ms, plain {fir_plain_ms:.4f} ms, rel err "
          f"{fir_err:.3e}; vs float64 scipy at {N_SMALL} within "
          f"2e-4*sqrt(T); resampling chain (fir_upfirdn_planes_flat) "
          f"{fir_chain_ms:.4f} ms {tag}")

    # the median filter at the JAX package's measured size
    xm = torch.from_numpy(np.abs(rng.standard_normal(N_MED) + 1j
                                 * rng.standard_normal(N_MED)).astype(
        np.float32) ** 2).to(dev)
    got_m, ref_m = medfilt(xm, MED_K), medfilt_plain(xm, MED_K)
    torch.cuda.synchronize()
    check(torch.equal(got_m, ref_m), "medfilt kernel vs twin not bit-equal")
    med_abs = float((got_m - ref_m).abs().max())
    small = xm[:N_SMALL]
    check(np.array_equal(medfilt_kernel(small, MED_K).cpu().numpy(),
                         sps.medfilt(small.cpu().numpy(), MED_K)),
          "medfilt kernel vs scipy not bit-equal")
    med_ms = median_ms(lambda: medfilt_kernel(xm, MED_K), reps=5)
    med_plain_ms = median_ms(lambda: medfilt_plain(xm, MED_K), reps=3)
    print(f"medfilt {N_MED} x k={MED_K}: kernel {med_ms:.4f} ms, plain "
          f"{med_plain_ms:.4f} ms, bit-equal to the twin and (at {N_SMALL}) "
          f"to scipy {tag}")

    # the group CAF at the bench's group-xcorr cell: the uniform sweep, then
    # a sorted list of 128 of its shifts holding the planted one
    gx, gx_cpu, rx_g = group_scene(rng, dev)
    tfold, starts_g, k_g = gx._tfold, gx._starts_t, gx.plan.k
    planes_g = gx._tf32               # split once at plan build
    offs_g = torch.arange(G_SHIFTS, device=dev)
    pw = power_prefix(rx_g)

    def gnorm(offs):                  # |C|^2 over this is the QF^2 scale
        return gx.ystack_norm_sq * sum(pw[offs + s + G_LEN] - pw[offs + s]
                                       for s in gx.starts.tolist())
    listed = np.sort(np.append(rng.choice(
        np.setdiff1d(np.arange(G_SHIFTS), [G_STAR]), G_LIST - 1,
        replace=False), G_STAR))
    g_err, g_abs = {}, {}
    for name, offs in (("sweep", offs_g),
                       ("list", torch.from_numpy(listed).to(dev))):
        got = group_caf(rx_g, offs, starts_g, tfold, k_g, planes_g)
        ref = group_caf_plain(rx_g, offs, starts_g, tfold, k_g)
        torch.cuda.synchronize()
        check(got.shape == (offs.shape[0], k_g)
              and bool(torch.isfinite(got).all()),
              f"group CAF ({name}) shape or finiteness")
        gm, rm = got.max(1).values, ref.max(1).values
        g_err[name] = float(((gm - rm).abs() / rm).max())
        check(g_err[name] < CAF_RTOL, f"group CAF ({name}) kernel vs twin "
                                      f"rel err {g_err[name]:.3e}")
        i_g = int(torch.argmax(gm))
        check(int(offs[i_g]) == int(offs[int(torch.argmax(rm))]) == G_STAR
              and int(torch.argmax(got[i_g])) == int(torch.argmax(ref[i_g]))
              == G_BIN, f"group CAF ({name}) peak at shift {int(offs[i_g])}"
                        f" bin {int(torch.argmax(got[i_g]))}")
        g_abs[name] = float(((got - ref).double()
                             / gnorm(offs)[:, None]).abs().max())
        check(g_abs[name] < GROUP_QF2_ATOL, f"group CAF ({name}) kernel vs "
              f"twin over the whole grid: QF^2 max|d| {g_abs[name]:.3e}")
    g_ms = median_ms(lambda: _group_caf_cuda(rx_g, offs_g, starts_g, tfold,
                                             k_g, planes_g), reps=5)
    g_plain_ms = median_ms(lambda: group_caf_plain(rx_g, offs_g, starts_g,
                                                   tfold, k_g), reps=3)
    xg = rx_g[offs_g[:, None] + (starts_g[:, None] + torch.arange(
        G_LEN, device=dev)).reshape(1, -1)]
    with full_f32():
        g_lib_ms = median_ms(lambda: torch.matmul(xg, tfold), reps=5)
    del xg
    # the FFT formulation of the uniform sweep: each bin's column of tfold is
    # a filter spanning the group layout, correlated with rx by overlap-save
    g_span = int(gx.starts[-1]) + G_LEN
    g_bound = bound(8.0 * G_SHIFTS * G_GROUPS * G_LEN * k_g,
                    ols_flop(G_SHIFTS, g_span, k_g),
                    tfold.numel() * 8 + rx_g.numel() * 8 + G_SHIFTS * k_g * 4)
    print(f"group CAF {G_GROUPS}x{G_LEN}, {k_g} bins, {G_SHIFTS} shifts: "
          f"kernel {g_ms:.4f} ms (3xTF32 wgmma, {group_caf.splits} depth slabs, "
          f"{g_bound['algorithm_flop'] / g_ms / 1e9:.1f} f32-equivalent "
          f"TFLOP/s), plain "
          f"{g_plain_ms:.4f} ms, torch.matmul {g_lib_ms:.4f} ms, bound "
          f"{g_bound['bound_ms']:.4f} ms ({g_bound['bound_by']}); per-shift "
          f"peak rel err {g_err['sweep']:.3e} (sweep), {g_err['list']:.3e} "
          f"({G_LIST}-shift list); QF^2 max|d| over the grid "
          f"{g_abs['sweep']:.3e}, {g_abs['list']:.3e}; peak at shift "
          f"{G_STAR} bin {G_BIN} {tag}")

    # the sliding matched filter at the resampling chain's length
    srng = np.random.default_rng(5)
    x_sl = (srng.standard_normal(N_SL) + 1j * srng.standard_normal(N_SL)
            ).astype(np.complex64)
    t_sl = (srng.standard_normal((T_SL, L_SL))
            + 1j * srng.standard_normal((T_SL, L_SL))).astype(np.complex64)
    x_sl[SL_S: SL_S + L_SL] += 4 * t_sl[SL_T]
    xs_d, ts_d = torch.from_numpy(x_sl).to(dev), torch.from_numpy(t_sl).to(dev)
    got_s = sliding_multiply_normalised(xs_d, ts_d)
    ref_s = sliding_plain(xs_d, ts_d)
    torch.cuda.synchronize()
    ns_sl = N_SL - L_SL + 1
    check(got_s.shape == (T_SL, ns_sl) and bool(torch.isfinite(got_s).all()),
          "sliding output shape or finiteness")
    sl_err = rel_err(got_s, ref_s)
    sl_abs = float((got_s - ref_s).abs().max())
    check(sl_err < SLIDING_RTOL, f"sliding kernel vs twin rel err "
                                 f"{sl_err:.3e}")
    ti, si = np.unravel_index(int(torch.argmax(got_s)), got_s.shape)
    check((ti, si) == (SL_T, SL_S), f"sliding peak at {(ti, si)}")
    small = sliding_multiply_normalised(xs_d[:N_SMALL], ts_d).cpu().numpy()
    truth = sliding_multiply_normalised_reference(x_sl[:N_SMALL], t_sl)
    check(np.abs(small - truth).max() / np.abs(truth).max() < SLIDING_RTOL,
          "sliding kernel vs numpy")
    sl_ms = median_ms(lambda: _sliding_cuda(xs_d, ts_d), reps=5)
    sl_plain_ms = median_ms(lambda: sliding_plain(xs_d, ts_d), reps=3)
    # cuDNN's conv1d of the re/im planes: the complex correlation (not its
    # normalisation) in one call, TF32 off (set above)
    w_sl = torch.cat([torch.stack([ts_d.real, ts_d.imag], 1),
                      torch.stack([-ts_d.imag, ts_d.real], 1)])
    x_ri = torch.stack([xs_d.real, xs_d.imag])[None]
    sl_lib_ms = median_ms(lambda: torch.nn.functional.conv1d(x_ri, w_sl),
                          reps=5)
    # FFT formulation: overlap-save over the templates, the window energies
    # as a running sum (4 per sample) and the normalisation (3 per output)
    sl_bound = bound(8.0 * T_SL * L_SL * ns_sl,
                     ols_flop(ns_sl, L_SL, T_SL) + 4.0 * N_SL
                     + 3.0 * T_SL * ns_sl,
                     8 * N_SL + 8 * T_SL * L_SL + 4 * T_SL * ns_sl)
    print(f"sliding {N_SL} x {T_SL} templates of {L_SL}: kernel {sl_ms:.4f} "
          f"ms, plain {sl_plain_ms:.4f} ms, cuDNN conv1d {sl_lib_ms:.4f} ms, "
          f"bound {sl_bound['bound_ms']:.4f} ms ({sl_bound['bound_by']}); "
          f"rel err "
          f"{sl_err:.3e}; vs numpy at {N_SMALL} within {SLIDING_RTOL} {tag}")
    del ref_s, x_ri

    # 3) the main path, through the public entry points ------------------------
    rcv = WidebandReceiver(num_channels=NCH, num_taps=TAPS, template_len=N_RX,
                           num_shifts=SHIFTS_RX, osr=4, demod_syms=128, m=4,
                           device=dev)
    tri, xri = wideband_scene(rcv, ROWS * NCH, seed=7)
    big = caf[N_BIG]
    chan = Channeliser(num_taps=TAPS, num_channels=NCH, device=dev)
    tmpl_b, rx_b = burst_scene(ROWS * NCH, N_RX, seed=11, device=dev)
    kernels = (wola_fused, caf_peak, caf3_peak, window_columns, stage2_peak,
               upfirdn_planes, medfilt_kernel)
    for kernel in kernels:
        kernel.launches = 0
    timer = Timer().start()
    out = rcv.run(tri, xri)
    rcv_ms = timer.evt("receiver run")
    qf2, bins = fast_xcorr(big["cut"], big["rx"], freqsearch=True,
                           shifts=torch.arange(SHIFTS_BIG, device=dev))
    i_big = int(torch.argmax(qf2))
    xcorr_ms = timer.evt("fast_xcorr 1M x 128")
    q3, b3 = fast_xcorr(cut3, rx3, True, shifts=offs3)
    i3 = int(torch.argmax(q3))
    caf3_path_ms = timer.evt("fast_xcorr 10M x 128")
    q4, b4 = fast_xcorr(cut4, rx4, True, shifts=offs4)
    i4 = int(torch.argmax(q4))
    peak_path_ms = timer.evt("fast_xcorr 1M shift list")
    m_re, m_im = fir_upfirdn_planes_flat(h_fir, h_rs, fre, fim, UP, DOWN)
    fir_path_ms = timer.evt("fir_upfirdn_planes_flat 4M")
    noise, req, filtered, e_edges = energy_detection(xm, MED_K)
    e_count = int(e_edges.count)
    energy_ms = timer.evt("energy_detection 4M")
    before = {k.__name__: k.launches for k in kernels}
    det = detection_chain(chan, tmpl_b, rx_b)
    det_path_ms = timer.evt("detection chain")
    launches = {k.__name__: k.launches for k in kernels}
    det_launches = {k: launches[k] - before[k] for k in launches}
    # this slice's paths, each with every count at 0 just before it
    every = kernels + (group_caf, sliding_multiply_normalised)
    for kernel in every:
        kernel.launches = 0
    timer.evt("counts reset")
    qg, fg = gx.xcorr(rx_g, offs_g)
    gi_, gj_ = np.unravel_index(int(torch.argmax(qg)), qg.shape)
    group_path_ms = timer.evt("GroupXcorrCZT.xcorr")
    group_launches = {k.__name__: k.launches for k in every}
    for kernel in every:
        kernel.launches = 0
    timer.evt("counts reset")
    q_sl = sliding_multiply_normalised(xs_d, ts_d)
    sti, ssi = np.unravel_index(int(torch.argmax(q_sl)), q_sl.shape)
    sliding_path_ms = timer.evt("sliding_multiply_normalised")
    sliding_launches = {k.__name__: k.launches for k in every}
    print(f"main path: receiver run {rcv_ms:.2f} ms, fast_xcorr "
          f"{xcorr_ms:.2f} ms (1M x 128), {caf3_path_ms:.2f} ms (10M x 128), "
          f"{peak_path_ms:.2f} ms (1M list), fir_upfirdn_planes_flat "
          f"{fir_path_ms:.2f} ms, energy_detection {energy_ms:.2f} ms, "
          f"detection chain {det_path_ms:.2f} ms, GroupXcorrCZT.xcorr "
          f"{group_path_ms:.2f} ms, sliding_multiply_normalised "
          f"{sliding_path_ms:.2f} ms (first calls), launches {launches}; "
          f"group sweep {group_launches}; sliding {sliding_launches} {tag}")
    print("detection:", json.dumps({**det, "launches": det_launches}))
    print("receiver:", json.dumps({k: v for k, v in out.items()
                                   if k not in ("channel_energy_db",
                                                "demod_syms")}))
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(group_launches["group_caf"] > 0
          and sliding_launches["sliding_multiply_normalised"] > 0,
          f"the group sweep or the sliding filter skipped its kernel: "
          f"{group_launches}, {sliding_launches}")
    route_g = select_group_caf_path(G_GROUPS, G_LEN, k_g, torch.complex64,
                                    dev, gx.plan.tones is not None)[0]
    check(route_g == "group-caf-hopper", f"group sweep route {route_g}")
    check(qg.shape == (G_SHIFTS, k_g) and bool(torch.isfinite(qg).all())
          and (gi_, gj_) == (G_STAR, G_BIN) and 0 < float(qg.max()) <= 1,
          f"GroupXcorrCZT.xcorr peak at shift {gi_} bin {gj_}")
    check(q_sl.shape == (T_SL, ns_sl) and (sti, ssi) == (SL_T, SL_S)
          and torch.equal(q_sl, got_s),
          f"sliding_multiply_normalised peak at {(sti, ssi)}")
    cpu_span = torch.arange(G_STAR - G_CPU // 2, G_STAR + G_CPU // 2)
    q_cpu, _ = gx_cpu.xcorr(rx_g.cpu(), cpu_span)
    g_cpu_err = float((qg[cpu_span].cpu() - q_cpu).abs().max())
    check(g_cpu_err < GROUP_QF2_ATOL, f"group sweep card vs CPU: QF^2 "
                                      f"max|d| {g_cpu_err:.3e}")
    print(f"GroupXcorrCZT.xcorr on the card vs on the CPU ({G_CPU} shifts): "
          f"QF^2 max|d| {g_cpu_err:.3e}; peak QF^2 {float(qg.max()):.4f}"
          f" at shift {G_STAR} bin {G_BIN} ({fg[G_BIN]:.3f} Hz)")
    routes = (select_xcorr_path(N_3, torch.complex64, 1, dev)[0],
              select_xcorr_path(N_4, torch.complex64, None, dev)[0])
    check(routes == ("fused3-hopper", "peak-kernel-hopper"),
          f"big-window / shift-list routes {routes}")
    check(i3 == 77 and int(b3[i3]) == 1234567 and q3.shape == (SHIFTS_3,)
          and bool(torch.isfinite(q3).all()),
          f"fast_xcorr 10M peak at shift {i3} bin {int(b3[i3])}")
    check(i4 == 77 and int(b4[i4]) == 54321 and q4.shape == (SHIFTS_4,)
          and bool(torch.isfinite(q4).all()),
          f"fast_xcorr 1M shift-list peak at {i4} bin {int(b4[i4])}")
    check(out["kernel_launches"]["wola_fused"] > 0
          and out["kernel_launches"]["caf_peak"] > 0,
          f"receiver launches {out['kernel_launches']}")
    check(out["xcorr_path"] == "fused-hopper" == out["wola_path"],
          f"routes {out['xcorr_path']} / {out['wola_path']}")
    check(out["best_channel"] == 1, f"best channel {out['best_channel']}")
    check(len(out["channel_energy_db"]) == NCH
          and bool(np.isfinite(out["channel_energy_db"]).all())
          and np.isfinite(out["qf2_peak"]) and 0 < out["qf2_peak"] <= 1,
          "receiver energies / QF^2 not finite or out of range")
    check(i_big == big["s_star"] and int(bins[i_big]) == big["f_star"],
          f"fast_xcorr 1M peak at shift {i_big} bin {int(bins[i_big])}")
    check(qf2.shape == (SHIFTS_BIG,) and bool(torch.isfinite(qf2).all()),
          "fast_xcorr QF^2 shape or finiteness")
    check(torch.equal(m_re, y_re) and torch.equal(m_im, y_im),
          "fir_upfirdn_planes_flat on the main path differs from phase 2")
    check(torch.equal(filtered, got_m) and bool(torch.isfinite(noise))
          and float(req) == 4.0 * float(noise)
          and 0 <= e_count <= e_edges.starts.shape[0],
          "energy_detection on the main path")
    routes = (select_upfirdn_path(N_FIR, h64.size, UP, DOWN, torch.float32,
                                  dev)[0],
              select_medfilt_path(1, torch.float32, dev, MED_K)[0],
              select_wola_path(NCH, NCH, dev)[0],
              select_xcorr_path(N_RX, torch.complex64, 1, dev)[0])
    check(routes == ("upfirdn-hopper", "medfilt-hopper", "fused-hopper",
                     "fused-hopper"), f"front-end routes {routes}")
    check(all(det_launches[k] > 0 for k in
              ("wola_fused", "medfilt_kernel", "caf_peak")),
          f"the detection chain skipped a kernel: {det_launches}")
    check(det["channel"] == 1, f"detection channel {det['channel']}")
    check(len(det["edges"]) == len(BURSTS)
          and all(abs(s - p) <= EDGE_MARGIN
                  and abs(e - (p + N_RX)) <= EDGE_MARGIN
                  for (s, e), p in zip(det["edges"], BURSTS)),
          f"detected edges {det['edges']} vs bursts at {BURSTS}")
    check([pk[:2] for pk in det["peaks"]] == [(p, 0) for p in BURSTS]
          and all(np.isfinite(pk[2]) and 0 < pk[2] <= 1
                  for pk in det["peaks"]),
          f"burst peaks {det['peaks']} vs bursts at {BURSTS}, bin 0")

    # the same receiver and input on the CPU: plain twins throughout
    ref = WidebandReceiver.from_numpy_params(
        {"f_tap": rcv.f_tap.cpu().numpy(), "num_channels": NCH,
         "num_taps": TAPS, "template_len": N_RX, "num_shifts": SHIFTS_RX,
         "osr": 4, "demod_syms": 128, "m": 4},
        device="cpu").run(tri.cpu(), xri.cpu())
    for key in ("best_channel", "best_shift", "freq_bin", "demod_syms"):
        check(out[key] == ref[key], f"receiver {key}: card {out[key]} vs "
              f"plain twin {ref[key]}")
    qerr = abs(out["qf2_peak"] - ref["qf2_peak"]) / ref["qf2_peak"]
    check(qerr < CAF_RTOL, f"receiver QF^2 rel err {qerr:.3e}")

    # the same detection chain and scene on the CPU: plain twins throughout
    det_cpu = detection_chain(
        Channeliser(num_channels=NCH, f_tap=chan.f_tap.cpu(), device="cpu"),
        tmpl_b.cpu(), rx_b.cpu())
    for key in ("channel", "threshold", "edges"):
        check(det[key] == det_cpu[key], f"detection {key}: card {det[key]} "
              f"vs plain twins {det_cpu[key]}")
    for (s1, b1, q1), (s2, b2, q2) in zip(det["peaks"], det_cpu["peaks"]):
        check(s1 == s2 and b1 == b2 and abs(q1 - q2) / q2 < CAF_RTOL,
              f"detection peak card {(s1, b1, q1)} vs CPU {(s2, b2, q2)}")
    print(f"detection chain on the card vs on the CPU: channel, threshold "
          f"{det['threshold']:.4g}, edges {det['edges']}, shifts and bins "
          f"equal; QF^2 within {CAF_RTOL}")

    # both new routes against the same call on CPU tensors, reduced size
    for n, offs, route in (
            (N_3_CPU, list(range(0, 24, 3)), "fused3-hopper"),
            (N_4_CPU, [0, 5, 6, 11, 40, 77, 78, 200], "peak-kernel-hopper")):
        step = 3 if route == "fused3-hopper" else None
        check(select_xcorr_path(n, torch.complex64, step, dev)[0] == route,
              f"n={n} route")
        cut_c, rx_c = listed_sweep(rng, n, offs, 3, 999, "cpu")
        gq, gb = fast_xcorr(cut_c.to(dev), rx_c.to(dev), True, shifts=offs)
        cq, cb = fast_xcorr(cut_c, rx_c, True, shifts=offs)
        qerr = float(((gq.cpu() - cq).abs() / cq).max())
        check(qerr < CAF_RTOL and int(torch.argmax(gq)) == 3
              and int(torch.argmax(cq)) == 3
              and int(gb[3]) == int(cb[3]) == 999,
              f"{route} n={n} card vs CPU: QF^2 rel err {qerr:.3e}, peaks "
              f"{int(torch.argmax(gq))}/{int(torch.argmax(cq))}")
        print(f"{route} n={n} on the card vs on the CPU: QF^2 rel err "
              f"{qerr:.3e}, planted shift and bin equal")

    # 4) whole-step time -------------------------------------------------------
    step_ms = median_ms(lambda: rcv.step(tri, xri), reps=5)
    print(f"receiver step, {ROWS * NCH} samples: {step_ms:.4f} ms "
          f"({ROWS * NCH / step_ms / 1e6:.3f} GS/s) {tag}")
    det_ms = median_ms(lambda: detection_chain(chan, tmpl_b, rx_b), reps=5)
    print(f"detection chain, {ROWS * NCH} samples, {len(BURSTS)} bursts: "
          f"{det_ms:.4f} ms ({ROWS * NCH / det_ms / 1e6:.3f} GS/s) {tag}")
    gx_ms = median_ms(lambda: gx.xcorr(rx_g, offs_g), reps=5)
    gx_rate = G_GROUPS * G_LEN * G_SHIFTS / gx_ms / 1e6
    print(f"GroupXcorrCZT.xcorr {G_GROUPS}x{G_LEN}x{k_g}x{G_SHIFTS}: "
          f"{gx_ms:.4f} ms ({gx_rate:.3f} Gsample-shift/s) {tag}")
    sl_path_ms = median_ms(lambda: sliding_multiply_normalised(xs_d, ts_d),
                           reps=5)
    print(f"sliding_multiply_normalised {N_SL} x {T_SL} x {L_SL}: "
          f"{sl_path_ms:.4f} ms {tag}")

    # each kernel's bound at the shapes timed above: its own algorithm's
    # operations, an FFT formulation's, and its bytes
    w_bound = wola_bound(ROWS, NCH, TAPS)
    # CAF sweeps: per shift the window product (6 n), a transform, |.|^2
    # (3 n); the kernels' own count is their plan's (ops/fft.plan_flop)
    c_bound = bound(caf[N_BIG]["plan_flop"],
                    SHIFTS_BIG * (9.0 * N_BIG + fft_flop(N_BIG)),
                    8 * (2 * N_BIG + 2 * SHIFTS_BIG - 1))
    c3_bound = bound(plan3["plan_flop"],
                     SHIFTS_3 * (9.0 * N_3 + fft_flop(N_3)),
                     8 * (2 * N_3 + 2 * SHIFTS_3 - 1))
    # the last stage: per row a twiddle (6 n2), an n2-point transform, |.|^2
    # and the row peak (3 n2); the kernel's own count is its row plan's
    s2_bound = bound(SHIFTS_4 * n1 * plan_flop(row_plan(n2)),
                     SHIFTS_4 * n1 * (9.0 * n2 + fft_flop(n2)),
                     8 * (SHIFTS_4 * n1 * n2 + n1 * n2 + SHIFTS_4))
    # upfirdn: two planes x real taps per output phase, or each phase's
    # filter by overlap-save over the input
    f_bound = bound(2.0 * 2 * n_fir_out * -(-h64.size // UP),
                    ols_flop(N_FIR, -(-h64.size // UP), UP),
                    8 * (N_FIR + n_fir_out) + 4 * h64.size)
    # integer compare steps are not f32 work: bytes alone
    m_bound = bound(0.0, 0.0, 8 * N_MED)

    def costs(b, lib):
        return {**b, "library_ms": lib}

    rx_caf = caf[N_RX]
    print(json.dumps({"kernels": [
        {"name": "wola_fused", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/wola_fused.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/wola_fused.py:99",
         "shape": f"{ROWS}x{NCH} ch, {TAPS} taps",
         "launches": launches["wola_fused"], "max_abs_err": wola_abs,
         "ms": wola_ms, "plain_ms": wola_plain_ms, **costs(w_bound, None),
         "direct_shapes": wola_direct},
        {"name": "caf_peak", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/fused_xcorr.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/fused_xcorr.py:60",
         "shape": f"n={N_BIG} x {SHIFTS_BIG} shifts",
         "launches": launches["caf_peak"], "max_abs_err": big["max_abs_err"],
         "ms": big["ms"], "plain_ms": big["plain_ms"],
         **costs(c_bound, big["plain_ms"]), **plan_keys(big),
         "receiver_shape": {"shape": f"n={N_RX} x {SHIFTS_RX} shifts",
                            "max_abs_err": rx_caf["max_abs_err"],
                            "ms": rx_caf["ms"],
                            "plain_ms": rx_caf["plain_ms"],
                            **plan_keys(rx_caf)}},
        {"name": "caf3_peak", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/fused_caf3.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/fused_caf3.py:166",
         "also_replaces": "pydsproutines_tpu/ops/pallas/fused_caf3.py:210",
         "shape": f"n={N_3} x {SHIFTS_3} shifts",
         "launches": launches["caf3_peak"], "max_abs_err": abs3,
         "ms": caf3_ms, "plain_ms": caf3_plain_ms,
         **costs(c3_bound, caf3_plain_ms), **plan_keys(plan3)},
        {"name": "stage2_peak", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/fft_peak.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/fft_peak.py:48",
         "shape": f"({SHIFTS_4}, {n1}, {n2}) stage-1 output of n={N_4}",
         "launches": launches["stage2_peak"], "max_abs_err": abs4,
         "ms": s2_ms, "plain_ms": s2_plain_ms, **costs(s2_bound, s2_lib_ms),
         "library": "torch.matmul by the DFT matrix, full f32",
         "fft_library_ms": s2_fft_ms,
         "sweep": {"shape": f"n={N_4} x {SHIFTS_4} listed shifts",
                   "ms": sweep_ms, "plain_ms": sweep_plain_ms,
                   "factors": [n1, n2],
                   "column_pass_launches": launches["window_columns"]}},
        {"name": "upfirdn_planes", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/upfirdn.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/upfirdn.py:109",
         "also_replaces": "pydsproutines_tpu/ops/pallas/upfirdn.py:209",
         "shape": f"2 planes x {N_FIR}, {h64.size} taps, up {UP} down {DOWN}",
         "launches": launches["upfirdn_planes"], "max_abs_err": fir_abs,
         "ms": fir_ms, "plain_ms": fir_plain_ms, **costs(f_bound, None)},
        {"name": "medfilt_kernel", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/medfilt.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/medfilt.py:32",
         "shape": f"{N_MED} float32, k={MED_K}",
         "launches": launches["medfilt_kernel"], "max_abs_err": med_abs,
         "ms": med_ms, "plain_ms": med_plain_ms,
         **costs(m_bound, med_plain_ms)},
        {"name": "group_caf", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/group_caf.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/group_caf.py:46",
         "shape": f"{G_GROUPS} groups x {G_LEN}, {k_g} bins, {G_SHIFTS} "
                  f"shifts",
         "launches": group_launches["group_caf"],
         "max_abs_err": g_abs["sweep"], "list_max_abs_err": g_abs["list"],
         "ms": g_ms, "plain_ms": g_plain_ms, **costs(g_bound, g_lib_ms),
         "precision": "3xTF32 on the tensor cores (wgmma m64n64k8), f32 "
                      "accumulation, fresh sums each 32-deep stage",
         "tensor_core_passes": 3, "splits": group_caf.splits},
        {"name": "sliding_multiply_normalised", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/sliding.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/sliding.py:43",
         "shape": f"{N_SL} samples x {T_SL} templates of {L_SL}",
         "launches": sliding_launches["sliding_multiply_normalised"],
         "max_abs_err": sl_abs, "ms": sl_ms, "plain_ms": sl_plain_ms,
         **costs(sl_bound, sl_lib_ms)},
    ], "receiver_step_ms": step_ms, "detection_chain_ms": det_ms,
        "resampling_chain_ms": fir_chain_ms, "group_xcorr_ms": gx_ms,
        "group_xcorr_gsample_shift_per_s": gx_rate,
        "sliding_ms": sl_path_ms, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
