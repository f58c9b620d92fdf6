#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written Hopper kernels from ``pydsproutines_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time.
2. Checks each kernel against its plain PyTorch twin on the card at the
   main path's shapes: the WOLA channelizer (a register fold and one
   shared-memory FFT a row; its route and plan printed) at 131,072 rows x 64
   channels with 2048 taps, and at N = Dec = 128 and 256 with 8 taps a
   channel (the JAX ``_kernel_direct`` shapes); the CAF peak search (shared-memory FFT,
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
   resampler taps, up 5, down 4: 730 combined taps; a register-window
   polyphase FIR, its route and plan printed, timed beside cuDNN's
   ``conv_transpose1d``), and the median filter
   at 4,194,304 float32 samples with k = 129 (bit-equal; its tile route, a
   core sort shared by 16 outputs and a select, with its key compares beside
   a running median's), each also against scipy at a reduced size; the group CAF at the JAX bench's group-xcorr
   cell (8 groups of 4096 samples every 16,384, 128 CZT bins of fs/16384,
   1024 shifts of an rx of 119,872 samples, a copy planted at shift 517 and
   bin 70), on the uniform sweep and on a sorted list of 128 of its shifts
   (a 3xTF32 product on the tensor cores, wgmma, over the tone bank split
   at plan build);
   the sliding normalised matched filter at 4,194,304 samples x 4 templates
   of 1024 with one template planted (overlap-save on the shared-memory
   FFT, no segment re-checked), against numpy at a reduced size, and on a
   burst-edge scene (-40 dB noise around a 20,000-sample burst holding the
   template, a run of zeros) where the segments at the burst's edges are
   re-checked by the kernel's masked direct launch (their count printed).
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
   shifts ("group-caf-hopper"), ``sliding_multiply_normalised`` at
   4,194,304 x 4 x 1024, and the demodulation layer, which runs no kernel
   (every count must still read 0 after it) at the JAX bench's demod and
   Viterbi cells: ``DemodulatorBatchQPSK.demod_batch`` on 256 planted QPSK
   bursts of 4096 samples (a preamble at a known shift, four ragged
   bursts), ``viterbi_path_acs_batch`` on 64 x 512 CP2FSK and CPM
   (k_syms = 2) bursts, ``ViterbiDemodulator("branch").run`` one burst a
   call, and the general and bursty scans at 128 symbols, each against the
   same call on the CPU (integers equal, metrics within rtol 1e-4) and its
   planted truth, timed on CUDA events in the bench's units. Last, with
   every count at 0 before it, the TDOA/FDOA geolocation path
   (``geolocation``): a scene synthesised on the card by the port's
   ``signal/`` (a 16,384-sample CP2FSK burst from a stationary ground
   emitter, propagated in float64 along the delay curves of a stationary
   reference and three moving receivers at fs 1 MHz, fc 300 MHz, into
   2^20-sample captures with noise at 10 dB in-band), one
   ``CheckpointedXcorrPipeline`` a pair over 15 blocks of 65,536 shifts
   (route "fused-hopper": only the CAF kernel #2 may launch, 8 launches a
   block), ``czt_xcorr`` and ``fine_freq_time_search`` at each peak,
   ``TDFDGridLocalizer`` over 2048 x 2048 points of the 200 km area, the
   TDOA+FDOA CRB and its 95% ellipse, and ``propagate_signal_exact`` at
   N = 8192; each stage against the same call on the CPU (the peak block
   of each pipeline, the fine stage, the whole cost grid) and the scene's
   truth (TDOA and FDOA within 5 sigma, the emitter within the CRB's 95%
   semi-major axis plus sqrt(cond) half cell diagonals of the located
   point). Last, with every count at 0 before it, the capture-to-analysis
   path (``analysis``): the receiver's 8M-sample scene written as int16
   I/Q to eight files of 2^20 samples, read back by
   ``io.StreamingCaptureLoader`` (halo 0; the native or the numpy loader,
   printed) and channelised a frame at a time by one ``Channeliser`` (#1,
   8 launches; against one channelisation of the whole capture),
   ``multichannel_minmax_scale`` in both modes, ``fast_xcorr`` of the
   strongest channel over 256 shifts (#2; the planted shift 176, bin 0),
   ``cancel_signal_at_idx`` of the template at the peak (it must remove
   the window's QF^2 share) and of the burst as the channel received it
   (residual norm < 0.2), ``music_xcorr_device`` over the peak +- 64
   (one launch of #5), ``PSKOrderDetector`` on 256 x 4096 BPSK/QPSK/8PSK
   rows, ``estimate_offset_via_cm`` on 2^20 QPSK symbols,
   ``estimate_baud``, ``MatrixProfile(output_chains=True)`` at n = 16,384,
   w = 256 over all 16,128 diagonals (its window sums through #5; a
   planted motif found as a chain; 64 diagonals of ``matrix_profile``
   against float64 numpy), and the masked-row
   products at 1024 x 8192; each against the same call on the CPU, timed,
   with the device busy share and heaviest kernels of the path, MUSIC and
   the matrix profile from the profiler (device events only). Last, the
   distribution layer (``pydsproutines_tpu_torch.parallel``), every launch
   count at 0 before each part: (a) on the one NCCL rank that
   ``make_mesh()`` starts on the card, ``sharded_wola`` on the receiver's
   8,388,608-sample capture at 64 ch and 2048 taps (#1),
   ``sharded_multichannel_wola`` on it as 4 x 2,097,152 (#1),
   ``sharded_lfilter`` at 4,194,304 samples and 128 taps (#5),
   ``sharded_fast_xcorr`` and ``sharded_caf_peak`` at n = 1,000,000 x 128
   shifts (#2, "fused-hopper") and ``sharded_caf_peak`` over a sorted
   list of 128 shifts (#4, "peak-kernel-hopper"), and
   ``sharded_group_xcorr_czt`` / ``_peak`` at the group cell (#8), the
   routes and launches checked (#1, #2, #4, #5, #8 launched, every other
   kernel 0), each against the single-device call on the card (peaks
   exact, arrays within PAR_TOL of max |ref|) and both timed (the
   difference is the wrapper's cost at world 1); (b) 4 ranks of one gloo
   group spawned on the one card (NCCL refuses two ranks on one device;
   gloo carries halos and scalars through host memory), at SCALING.json's
   sizes a process: the 8M capture through ``sharded_wola`` and
   ``sharded_lfilter`` (2,097,152 samples a rank, a non-zero halo and row
   offset), a 4096-sample cutout over 1024 shifts (256 a rank) through
   ``sharded_fast_xcorr`` / ``sharded_caf_peak``, the group cell's 1024
   shifts; each rank's block or peak against the single-device call on the
   card, its launches and times ("4 ranks sharing one card", not a scaling
   figure) and the exchanges' backend printed; (c) on the same ranks the
   multi-host flow: a 4,194,304-sample int16 capture written to a file,
   ``read_local_capture`` a block a rank, ``shard_local_blocks`` on the
   card, ``sharded_lfilter``, and ``sharded_caf_peak`` over shifts made
   global the same way (the planted shift 2600, bin 0, found on rank 2's
   block and returned to every rank). Last, the transform phase
   (``transform``), every launch count at 0 before its path:
   ``wola_planes_flat`` and ``wola_planes`` at the JAX bench's
   ``wola_64ch_8M`` (8,388,608 float32 samples a plane, 64 ch, 2048 taps)
   and at N = 128, 256 (the plane-I/O instance of #1, 2 launches a shape,
   first held bit-equal to the complex instance on the same samples),
   ``fft`` / ``ifft`` / ``FourStepFFT.__call__`` / ``call_permuted`` at 16
   x 2^20 complex64 against complex128 CPU FFTs, ``call_peak`` at 16 x
   2^20 ([1024, 1024]) and 1 x 10^7 ([200, 200, 250]) and
   ``call_peak_planes`` at 1 x 10^7 (#4 once a call; bins equal to the
   complex128 argmax and the planted tones), timed beside the interleave
   -> kernel -> split route and ``torch.fft.fft -> |.|^2 -> max``.
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
   whichever is fewer; both are printed) over the f32 peak (the median
   filter: key compares, its plan's or a running median's 2 ceil(log2 k)
   an output, over the int32 rate) and its bytes (each input read once,
   each output written once) over the HBM rate.
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
#   kernel's a shared-memory f32 FFT over f32 tables, its fold in another
#   order: max|d| / max|ref| < 1e-5 (the CPU parity tests' bound).
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

# One H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores and HBM;
# 32-bit integer operations issue at half the f32 FMA rate.
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
INT32_OPS = F32_FLOPS / 2

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
# the sliding filter's burst-edge scene: a 20,000-sample burst from SLB_AT
# holding template SL_T at SLB_AT + SLB_OFF, zeros from SLB_ZEROS. The
# burst starts 1100 samples into the overlap-save route's segment 650 (3073
# shifts a segment at L = 1024), so that segment's quiet windows sit beside
# ~3000 burst samples: an energy ratio ~3e4, past the re-check's limit.
SLB_AT, SLB_OFF, SLB_ZEROS, SLB_ZLEN = 650 * 3073 + 1100, 9000, 3_000_000, \
    6000
BURSTS = (20000, 60000, 100000)          # channel-rate burst positions
EDGE_MARGIN = 16                         # detected edge vs planted burst
SEARCH = 64                              # xcorr shifts either side of an edge
# noise-level grid of auto_detect_threshold: 1 dB steps, -30 .. 0 dB
NOISE_LEVELS_DB = np.arange(-30, 1)
# the demodulation layer at the JAX bench's shapes (bench.py:397-587): the
# burst-batched QPSK chain, 256 bursts x 1024 symbols at osr 4, a 32-symbol
# preamble searched over 64 shifts, 928 payload symbols; the CP2FSK and CPM
# (k_syms = 2) trellises, 64 bursts x 512 symbols at up 8
DM_B, DM_NSYMS, DM_OSR, DM_AMBLE, DM_SEARCH = 256, 1024, 4, 32, 64
DM_OUT = DM_NSYMS - DM_AMBLE - DM_SEARCH
DM_EYE = (0.55, 1.0, 0.8, 0.35)          # amplitude per sampling phase
DM_SIGMA = 0.126                         # noise per component: Es/N0 15 dB
DM_RAGGED = (1, 37, 1000, 2001)          # samples cut from bursts 0-3
VT_B, VT_NSYMS, VT_UP = 64, 512, 8
# Viterbi metrics, card vs CPU: f32 sums of up to 8,192 terms in another
# order; the JAX tests' tolerance (tests/test_viterbi.py)
VT_RTOL = 1e-4
# the geolocation phase: a TDOA/FDOA scene at fs 1 MHz, fc 300 MHz; one
# stationary ground emitter in a 200 km x 200 km area, a stationary
# reference receiver and three moving ones (x, y, z in metres; speeds in
# m/s); 2^20-sample captures; a 16,384-sample CP2FSK burst (2047 bits at 8
# samples a bit, h 0.5) that the reference receives from sample 400,000;
# noise at an in-band SNR of 10 dB in the baud's 125 kHz
GEO_FS, GEO_FC, GEO_CAPTURE, GEO_BURST, GEO_UP = 1e6, 300e6, 1 << 20, \
    16384, 8
GEO_T0, GEO_SNR_DB = 400_000, 10.0
GEO_EMITTER = (23_456.7, -31_234.5, 0.0)
GEO_REF = (-60e3, -70e3, 30.0)
GEO_LINEAR = (((-80e3, 60e3, 6000.0), (40e3, 90e3, 6000.0), 220.0),
              ((70e3, -80e3, 4000.0), (90e3, 40e3, 4000.0), 130.0))
GEO_CIRCLE = (90e3, 180.0, 8000.0, 0.3)   # radius, speed, height, phase
# the pipeline: 65,536 shifts a block (15 blocks a pair), 8192 shifts a
# kernel launch (the 1 GiB scratch budget's cap at n = 16,384)
GEO_BLOCK, GEO_BATCH = 65536, 8192
GEO_GRID, GEO_HALF = 2048, 100e3          # 2048 x 2048 points over the area
# the fine stage: a CZT over +-2 coarse bins at 0.5 Hz, then two frequency
# passes (0.5, 0.1 Hz) and a +-1 sample delay scan at 0.01 sample
GEO_CZT_STEP, GEO_FINE_RES, GEO_TD_STEP = 0.5, (0.5, 0.1), 0.01
GEO_TD_BAND = (-GEO_FS / GEO_UP, GEO_FS / GEO_UP)
# card vs CPU: the pipeline's QF^2 per shift within CAF_RTOL; the fine
# stage's CZT and fine-search costs within CAF_RTOL (f32 sums of 16,384
# products in another order), and its picks on the CPU's peaks: the CZT
# bin and the delay within CAF_RTOL of the CPU's maximum, the FDOA within
# one 0.1 Hz step (a 0.1 Hz step moves a 16,384-sample peak by ~1e-6,
# the size of the sums' rounding: on an H100 the card picked 125.0297 Hz
# where the CPU picked 124.9297);
# the grid's float32 costs within GEO_GRID_RTOL * max(1, |cost|) (the CPU
# parity tests' bound); propagate_signal_exact within 1e-5 of max |ref|
# (its float32 parity test's bound)
GEO_GRID_RTOL, GEO_EXACT_N, GEO_EXACT_RTOL = 1e-4, 8192, 1e-5
LIGHTSPEED = 299792458.0
# the analysis phase: the receiver's scene (``scene_burst``, seed 7: 64 ch,
# 2048 taps, a 1024-symbol template, 256 shifts) written as int16 I/Q to
# eight files of 2^20 samples, its largest component at half of full scale;
# the burst's CAF peak in channel 1: the template's symbols start at
# channel-rate sample (128 + 32) and the 2048-tap prototype delays them by
# 16.5 samples, so the peak is at shift 176, bin 0 (the channel's centre)
AN_FILES, AN_FILE_SAMPS, AN_INT16_PEAK = 8, 1 << 20, 0.5 * 32767
AN_CHANNEL, AN_SHIFT, AN_BIN = 1, 176, 0
# MUSIC around the peak: +-64 shifts, dsr 4, 130 rows (the JAX default), a
# 32-tap FIR of cutoff 0.8/dsr, 201 frequencies over +-2 CAF bins, p = 1, 2
AN_MU_HALF, AN_MU_DSR, AN_MU_ROWS, AN_MU_TAPS, AN_MU_POINTS = 64, 4, 130, \
    32, 201
# blind modulation: 256 rows x 4096 symbols a batch (the QPSK batch cell's
# rows) at Es/N0 20 dB; a 2^20-symbol QPSK burst with a carrier offset of
# 0.0123456 cycles a sample for the CM estimate; half-sine BPSK at 8 samples
# a symbol for the baud
AN_PSK_ROWS, AN_PSK_LEN, AN_PSK_SIGMA = 256, 4096, np.sqrt(0.01 / 2)
AN_CM_LEN, AN_CM_F0, AN_BAUD_SYMS, AN_BAUD_UP = 1 << 20, 0.0123456, 4096, 8
# the matrix profile at the JAX benchmark's defaults
# (benchmarks/benchmark_matrixprofile.py: n = 16,384, w = 256, every
# diagonal), a 256-symbol motif at sample 1000 repeated 9000 samples later
# in noise of 0.05 a component; 64 diagonals held to float64 numpy
AN_MP_N, AN_MP_W, AN_MP_AT, AN_MP_LAG, AN_MP_HELD = 16384, 256, 1000, 9000, \
    64
AN_MP_ATOL = 1e-4                         # times max(1, |v|)
# masked rows: 1024 x 8192 complex64, one row in 8 selected, capacity 128
AN_MASK_ROWS, AN_MASK_LEN, AN_MASK_EVERY, AN_MASK_CAP = 1024, 8192, 8, 128
# card vs CPU: min-max scaling within 1e-6 (values in [0, 1]); the
# cancellation's amplitude within rtol 1e-5; the masked products within
# 1e-6 of max |ref|; MUSIC's inverse grids within the JAX eig test's
# rtol 1e-3, atol 1e-6 * max (tests/test_analysis_ops.py:268-306) wherever
# the CPU's grid is at least AN_MU_NOTCH of its shift's maximum, and the
# grid within AN_MU_NOTCH of that maximum everywhere: at shifts of noise
# alone a p = 1 pseudospectrum has notches (values 1e-5 of their
# neighbours) where a 1-ulp change of the covariance moves the value by
# up to 134% (a CPU rehearsal with a perturbed covariance), so no two f32
# machines agree there to 1e-3
AN_MINMAX_ATOL, AN_CANCEL_RTOL, AN_MASK_RTOL, AN_MU_NOTCH = 1e-6, 1e-5, \
    1e-6, 1e-3
# the distribution layer (parallel/): (a) one NCCL rank at the main path's
# widths, the channel-sharded WOLA over PAR_MC captures of the 8M capture;
# (b) PAR_RANKS gloo ranks sharing the one card at SCALING.json's sizes a
# process: the 8M capture (2,097,152 samples a rank) through WOLA and the
# chain's FIR, a PAR_CUT-sample cutout over PAR_SHIFTS shifts (256 a rank)
# planted at PAR_STAR, bin PAR_BIN, and the group cell's 1024 shifts (256 a
# rank); (c) the multi-host flow: a PAR_CAP-sample int16 capture holding
# the PAR_CUT-sample template at PAR_CAP_STAR, bin 0, read a block a rank,
# and swept over PAR_SHIFTS shifts from PAR_CAP_S0 (both planted shifts lie
# in rank 2's block). Sharded vs single-device on the card: the JAX tests'
# 1e-4 (tests/test_parallel.py), here of max |ref|; peaks exact.
PAR_RANKS, PAR_MC, PAR_TOL = 4, 4, 1e-4
PAR_PEAK, PAR_LIST_BIN = (77, 12345), 54321   # (a): the main path's plants
PAR_CUT, PAR_SHIFTS, PAR_STAR, PAR_BIN = 4096, 1024, 700, 5
PAR_CAP, PAR_CAP_S0, PAR_CAP_STAR = 1 << 22, 2048, 2600
# the transform phase: WOLA's plane entry points at the bench cell
# wola_64ch_8M (bench.py:269-306: 8,388,608 samples, 64 ch, Dec 64, 2048
# taps) and at the #1b shapes (the same samples); the transform API at
# benchmarks/benchmark_fft.py's 16 x 2^20 complex64; call_peak at 16 x 2^20
# (plan [1024, 1024]) and at 1 x 10^7 ([200, 200, 250],
# benchmarks/exp_10m_breakdown.py), call_peak_planes at 1 x 10^7
# (benchmarks/exp_10m_prod.py); one tone a row (TF_BIN0 + r * TF_BIN_STEP,
# and TF_BIN10 at 10^7, past 2^23) in unit complex noise, so no two bins
# tie. Gates: the plane instance equal to the complex instance (max|d| 0)
# and within WOLA_RTOL of its plain version; fft / ifft within TF_RTOL *
# max|X| of a complex128 CPU FFT, ifft(fft(x)) within TF_RTOL * max|x| of
# x (f32 FFTs of 2^20 points: ~1e-7 relative per pass); call_peak's bins
# equal to the complex128 argmax and its peaks within CAF_RTOL of its max
# |X|^2; call_peak against its twin (einsum leading stages, torch.fft last
# stage) within CAF_RTOL, kernel #4 on the same stage-2 input within
# CAF_RTOL of its twin.
TF_WOLA = ((NCH, TAPS, ROWS),) + WOLA_DIRECT
TF_FFT = (16, 1 << 20)
TF_PEAK = ((16, 1 << 20), (1, 10_000_000))
TF_BIN0, TF_BIN_STEP, TF_BIN10 = 12345, 65537, 9_876_543
TF_RTOL = 1e-5


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
          nbytes: float, rate: float = F32_FLOPS) -> dict:
    """The least time one H100 could take for a kernel's function: the
    larger of the fewest operations that compute it (its own algorithm's,
    ``algorithm_flop``, or another formulation's, ``fft_form_flop``,
    whichever is fewer) over their peak ``rate`` (f32, or INT32_OPS for
    integer compares), and the bytes it must move (each input read once,
    each output written once) over the HBM rate."""
    flop = min(algorithm_flop, fft_form_flop)
    t_ops, t_bytes = flop / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
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


def upfirdn_library_call(planes, h, up, down, n_out):
    """The one PyTorch call that computes upfirdn of the planes: cuDNN's
    ``conv_transpose1d`` with stride ``up`` (the full convolution of the
    zero-stuffed planes with h), then every ``down``-th sample, cut to
    scipy's first ``n_out``; TF32 is the caller's to turn off. Returns a
    callable, timed here and never called by the port."""
    import torch
    x = torch.stack(planes)[:, None]
    w = h[None, None]
    return lambda: torch.nn.functional.conv_transpose1d(
        x, w, stride=up)[:, 0, ::down][:, :n_out]


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
    the CPU; rx on ``device``) of ``group_args``."""
    import torch
    from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT
    args, rx = group_args(rng)
    return (GroupXcorrCZT(*args), GroupXcorrCZT(*args, device="cpu"),
            torch.from_numpy(rx).to(device))


def group_args(rng):
    """(GroupXcorrCZT's arguments, complex64 rx) at the bench's group-xcorr
    cell: a random template's 8 groups planted at shift G_STAR on CZT bin
    G_BIN, in noise."""
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
    return args, rx.astype(np.complex64)


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


def scene_burst(dec: int, taps: int, template_len: int, num_shifts: int,
                n_wide: int, seed: int):
    """(QPSK template, complex128 noisy capture, its planted burst alone)
    of ``wideband_scene``: the template held for one channel-rate sample a
    symbol (a rectangular pulse of Dec samples) on the channel-1 tone from
    wideband sample (num_shifts // 2 + taps // dec) * dec, in noise of 0.1
    a component."""
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, template_len))
    rx = 0.1 * (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
    start = (num_shifts // 2 + taps // dec) * dec
    span = slice(start, start + template_len * dec)
    t = np.arange(span.start, span.stop)
    burst = np.zeros(n_wide, complex)
    burst[span] = np.repeat(syms, dec) * np.exp(2j * np.pi * t / dec)
    return syms, rx + burst, burst


def wideband_scene(rcv, n_wide: int, seed: int):
    """(template_ri, rx_ri) on the receiver's device: ``scene_burst``'s
    template and capture. Unlike the impulse-train example of
    ``example_inputs``, its energy sits in channel 1, so the strongest
    channel is the planted one."""
    import torch
    syms, rx, _ = scene_burst(rcv.dec, rcv.num_taps, rcv.template_len,
                              rcv.num_shifts, n_wide, seed)
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


def burst_edge_scene(seed, n, t, length, plant_t, burst_at, plant_off,
                     zeros_at, zeros_len, noise_db=-40.0, burst_len=20_000):
    """(x, templates) complex64 numpy: noise at ``noise_db`` around a
    unit-power burst of ``burst_len`` samples holding template ``plant_t``
    at burst_at + plant_off, and a run of zeros. The quiet windows beside
    the burst's edges are where an FFT correlation's rounding, which scales
    with a segment's energy, is largest against a window's own energy."""
    rng = np.random.default_rng(seed)
    sig = 10 ** (noise_db / 20) / np.sqrt(2)
    x = sig * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    tm = (rng.standard_normal((t, length))
          + 1j * rng.standard_normal((t, length))) / np.sqrt(2)
    b = (rng.standard_normal(burst_len)
         + 1j * rng.standard_normal(burst_len)) / np.sqrt(2)
    b[plant_off: plant_off + length] = tm[plant_t]
    x[burst_at: burst_at + burst_len] += b
    x[zeros_at: zeros_at + zeros_len] = 0
    return x.astype(np.complex64), tm.astype(np.complex64)


def sliding_scene():
    """(x, templates) complex64 numpy of the sliding filter's stationary
    scene: unit noise, T_SL random templates of L_SL, template SL_T planted
    at 4x amplitude at shift SL_S."""
    srng = np.random.default_rng(5)
    x = (srng.standard_normal(N_SL) + 1j * srng.standard_normal(N_SL)
         ).astype(np.complex64)
    tm = (srng.standard_normal((T_SL, L_SL))
          + 1j * srng.standard_normal((T_SL, L_SL))).astype(np.complex64)
    x[SL_S: SL_S + L_SL] += 4 * tm[SL_T]
    return x, tm


def sliding_burst_scene():
    """The sliding filter's burst-edge scene at N_SL (``burst_edge_scene``):
    the planted template at (SL_T, SLB_AT + SLB_OFF)."""
    return burst_edge_scene(6, N_SL, T_SL, L_SL, SL_T, SLB_AT, SLB_OFF,
                            SLB_ZEROS, SLB_ZLEN)


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


def qpsk_batch_scene(seed: int):
    """The batch chain's scene: per burst random QPSK symbols held for osr
    samples with a clear best sampling phase (DM_EYE), a random carrier
    phase, DM_AMBLE planted at a shift < DM_SEARCH, complex noise at Es/N0
    15 dB; bursts 0-3 cut short by DM_RAGGED, with loud garbage past their
    ends. Returns (x (B, L) complex64, lengths, amble, shifts, symbols)."""
    rng = np.random.default_rng(seed)
    L = DM_NSYMS * DM_OSR
    amble = rng.integers(0, 4, DM_AMBLE)
    syms = rng.integers(0, 4, (DM_B, DM_NSYMS))
    shifts = rng.integers(0, DM_SEARCH, DM_B)
    for b in range(DM_B):
        syms[b, shifts[b]: shifts[b] + DM_AMBLE] = amble
    const = np.array([1, 1j, -1, -1j])
    x = (np.repeat(const[syms], DM_OSR, axis=1) * np.tile(DM_EYE, DM_NSYMS)
         * np.exp(1j * rng.uniform(-np.pi, np.pi, (DM_B, 1))))
    x += DM_SIGMA * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    lengths = np.full(DM_B, L)
    lengths[: len(DM_RAGGED)] -= DM_RAGGED
    for b in range(len(DM_RAGGED)):
        x[b, lengths[b]:] = 10.0 * rng.standard_normal(L - lengths[b])
    return x.astype(np.complex64), lengths, amble, shifts, syms


def trellis_scene(seed: int, pulse, omega: float, sigma: float):
    """VT_B bursts of VT_NSYMS random +/-1 symbols through ``pulse`` (one
    source, frequency offset ``omega``) at VT_UP samples a symbol, plus
    complex noise of ``sigma`` per component. Returns (ys (B, n) complex64,
    the symbol indices)."""
    rng = np.random.default_rng(seed)
    n = VT_NSYMS * VT_UP
    truth = rng.integers(0, 2, (VT_B, VT_NSYMS))
    ups = np.zeros((VT_B, n), complex)
    ups[:, ::VT_UP] = 1.0 - 2.0 * truth
    ys = np.stack([np.convolve(pulse, u)[:n] for u in ups])
    ys = ys * np.exp(-1j * omega * np.arange(n))
    ys += sigma * (rng.standard_normal(ys.shape)
                   + 1j * rng.standard_normal(ys.shape))
    return ys.astype(np.complex64), truth


def close(card, cpu, rtol: float) -> float:
    """max |card - cpu| / max |cpu| over the finite entries, which must be
    the same entries on both; fails at ``rtol`` or above."""
    import torch
    card, cpu = card.cpu(), cpu.cpu()
    fin = torch.isfinite(cpu)
    check(torch.equal(torch.isfinite(card), fin), "infinite entries differ")
    err = float((card[fin] - cpu[fin]).abs().max() / cpu[fin].abs().max())
    check(err < rtol, f"relative error {err:.3e} >= {rtol}")
    return err


def demod_layer(dev, tag: str, kernels) -> dict:
    """The demodulation layer on the card at the JAX bench's shapes, every
    call against the port's own CPU run of it (integers equal, metrics
    within their tolerance) and against the scene's planted truth, with
    CUDA-event medians in the bench's units. No TPU kernel lies on this
    path: every kernel count is set to 0 before it and must read 0 after."""
    import torch
    from pydsproutines_tpu_torch.ops import (BurstyViterbiDemodulator,
                                             DemodulatorBatchQPSK,
                                             ViterbiDemodulator,
                                             viterbi_path_acs_batch)
    from pydsproutines_tpu_torch.utils.timing import median_ms
    for kernel in kernels:
        kernel.launches = 0
    out = {}

    # -- the burst-batched QPSK chain (qpsk_demod_batch_256x4096) ------------
    x, lengths, amble, shifts, syms = qpsk_batch_scene(seed=31)
    res = {}
    for where in (dev, "cpu"):
        dm = DemodulatorBatchQPSK(device=where)
        res[where] = dm.demod_batch(
            torch.from_numpy(x).to(where), DM_OSR, amble, 0, DM_SEARCH,
            DM_OUT, lengths=torch.from_numpy(lengths).to(where))
    g, c = res[dev], res["cpu"]
    for name in ("syms", "eo_idx", "best_matches", "best_rotations",
                 "best_idx", "rotated_syms", "bits", "bit_counts"):
        check(torch.equal(getattr(g, name).cpu(), getattr(c, name)),
              f"demod_batch {name}: card vs CPU")
    errs = {name: close(getattr(g, name), getattr(c, name), VT_RTOL)
            for name in ("eo_metric", "svd_metric", "reimc")}
    errs["theta_abs"] = float((g.theta.cpu() - c.theta).abs().max())
    check(errs["theta_abs"] < VT_RTOL, f"demod_batch theta {errs}")
    # symbol n is valid while its eye-phase sample n*osr + 1 is inside
    nvalid = -(-(lengths - 1) // DM_OSR)
    counts = np.minimum(DM_OUT, nvalid - shifts - DM_AMBLE)
    check(np.array_equal(g.best_idx.cpu().numpy(), shifts)
          and bool((g.best_matches == DM_AMBLE).all())
          and bool((g.eo_idx == 1).all())
          and np.array_equal(g.bit_counts.cpu().numpy(), counts),
          "demod_batch: planted preambles, eye phase or payload counts")
    bitmap = np.array([0b11, 0b01, 0b00, 0b10])
    rot = g.rotated_syms.cpu().numpy()
    bits = g.bits.cpu().numpy().reshape(DM_B, DM_OUT, 2)
    for b in range(DM_B):
        pay = slice(shifts[b] + DM_AMBLE, shifts[b] + DM_AMBLE + counts[b])
        want = bitmap[syms[b, pay]]
        check(np.array_equal(rot[b, : nvalid[b]], syms[b, : nvalid[b]])
              and np.array_equal(bits[b, : counts[b], 0], want >> 1)
              and np.array_equal(bits[b, : counts[b], 1], want & 1)
              and not bits[b, counts[b]:].any(),
              f"demod_batch burst {b}: symbols or payload bits")
    xd, ld = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    dmq = DemodulatorBatchQPSK(device=dev)
    ms = median_ms(lambda: dmq.demod_batch(xd, DM_OSR, amble, 0, DM_SEARCH,
                                           DM_OUT, lengths=ld), reps=5)
    out["qpsk_demod_batch_256x4096"] = {
        "ms": ms, "msamples_per_s": DM_B * x.shape[1] / ms / 1e3,
        "card_vs_cpu": errs}
    print(f"DemodulatorBatchQPSK.demod_batch {DM_B} x {x.shape[1]}: {ms:.4f}"
          f" ms ({DM_B * x.shape[1] / ms / 1e3:.1f} Msample/s); symbols, "
          f"shifts, rotations, bits equal on the card and the CPU and to the"
          f" planted scene; {errs} {tag}")

    # -- CP2FSK and CPM trellises -----------------------------------------------
    alphabet = np.array([1.0, -1.0], np.complex64)
    pret = np.array([[0, 1], [0, 1]], np.int32)
    start = np.array([True, True])
    static = dict(pret_static=((0, 1), (0, 1)), start_static=(True, True))
    cells = (("cp2fsk_viterbi_path_64x512", np.ones(VT_UP), 0.0, 0.3),
             ("cpm_viterbi_k2_path_64x512", np.full(2 * VT_UP, 0.5), 0.05,
              0.1))
    for cell, pulse, omega, sigma in cells:
        ys, truth = trellis_scene(41, pulse, omega, sigma)
        k_syms = pulse.size // VT_UP
        args = (alphabet, pret, pulse[None].astype(np.complex64),
                np.array([omega], np.float32), start)
        kw = dict(up=VT_UP, pulselen=pulse.size, k_syms=k_syms,
                  pathlen=VT_NSYMS, **static)
        yd = torch.from_numpy(ys).to(dev)
        gp, gm = viterbi_path_acs_batch(yd, *args, **kw)
        cp, cm = viterbi_path_acs_batch(torch.from_numpy(ys), *args, **kw)
        check(torch.equal(gp.cpu(), cp), f"{cell}: paths card vs CPU")
        err = close(gm, cm, VT_RTOL)
        best = gp[torch.arange(VT_B, device=dev),
                  gm.argmin(dim=1)].cpu().numpy()
        check(np.array_equal(best, truth), f"{cell}: planted symbols")
        ms = median_ms(lambda: viterbi_path_acs_batch(yd, *args, **kw),
                       reps=5)
        out[cell] = {"ms": ms, "msymbols_per_s": VT_B * VT_NSYMS / ms / 1e3,
                     "metric_rel_err": err}
        print(f"viterbi_path_acs_batch {cell}: {ms:.4f} ms "
              f"({VT_B * VT_NSYMS / ms / 1e3:.2f} Msymbol/s); paths equal on"
              f" the card and the CPU, metrics within {err:.2e}, planted "
              f"symbols decoded {tag}")
        if k_syms == 1:
            cp2fsk = (ys, args)

    # -- the faithful "branch" survivors, one burst a call -----------------------
    # (cp2fsk_viterbi_branch_tables_64x512): on memoryless pulses their
    # survivors are data-independent (state 0, then the final state), so
    # the truth is each metric summed in float64 along that survivor
    ys, args = cp2fsk
    vd = {w: ViterbiDemodulator(alphabet, pret, args[2], args[3], VT_UP,
                                np.array([0, 1]), "branch", device=w)
          for w in (dev, "cpu")}
    yb = torch.from_numpy(ys).to(dev)
    runs = [vd[dev].run(yb[b], VT_NSYMS) for b in range(VT_B)]
    err = 0.0
    for b, (_, gm, gv) in enumerate(runs):
        _, cm, cv = vd["cpu"].run(torch.from_numpy(ys[b]), VT_NSYMS)
        check(torch.equal(gv.cpu(), cv), f"branch burst {b}: paths")
        err = max(err, close(gm, cm, VT_RTOL))
        bm = (np.abs(ys[b].reshape(VT_NSYMS, VT_UP).astype(complex)
                     - alphabet[:, None, None]) ** 2).sum(-1)   # (A, N)
        surv = bm[0, :-1].sum() + bm[:, -1]
        check(np.allclose(gm.cpu().numpy(), surv, rtol=VT_RTOL),
              f"branch burst {b}: metrics vs float64 survivors")
    ms = median_ms(lambda: [vd[dev].run(yb[b], VT_NSYMS)
                            for b in range(VT_B)], reps=3)
    out["cp2fsk_viterbi_branch_tables_64x512"] = {
        "ms": ms, "msymbols_per_s": VT_B * VT_NSYMS / ms / 1e3,
        "metric_rel_err": err}
    print(f"ViterbiDemodulator(branch).run x {VT_B} bursts of {VT_NSYMS}: "
          f"{ms:.4f} ms ({VT_B * VT_NSYMS / ms / 1e3:.2f} Msymbol/s); paths "
          f"equal on the card and the CPU, metrics within {err:.2e} and "
          f"equal to the float64 survivor sums {tag}")

    # -- the sequential scans: general trellis and bursty ------------------------
    up, pathlen = 4, 128
    cpm = np.exp(1j * np.arange(4) * np.pi / 2).astype(np.complex64)
    pre4 = np.array([[(p - 1) % 4, (p + 1) % 4] for p in range(4)], np.int32)
    pulse4 = np.full((1, 2 * up), 0.5, np.complex64)
    rng = np.random.default_rng(43)
    walk = np.cumsum(np.r_[0, rng.choice([-1, 1], pathlen - 1)]) % 4
    nsamps = pathlen * up + 2 * up
    up_syms = np.zeros(nsamps, complex)
    up_syms[: pathlen * up: up] = cpm[walk]
    y = (np.convolve(pulse4[0], up_syms)[:nsamps]
         * np.exp(-1j * 0.05 * np.arange(nsamps))
         + 0.05 * (rng.standard_normal(nsamps)
                   + 1j * rng.standard_normal(nsamps))).astype(np.complex64)
    burst, guard = 20, 4
    active = (np.arange(pathlen) % (burst + guard)) < burst
    bsyms = np.where(active, alphabet[rng.integers(0, 2, pathlen)], 0)
    up_b = np.zeros(nsamps, complex)
    up_b[: pathlen * up: up] = bsyms
    yb = (np.convolve(pulse4[0], up_b)[:nsamps]
          + 0.05 * (rng.standard_normal(nsamps)
                    + 1j * rng.standard_normal(nsamps))).astype(np.complex64)
    scans = (
        ("general scan (4 states, k_syms 2)",
         lambda w: ViterbiDemodulator(cpm, pre4, pulse4, [0.05], up,
                                      device=w), y, cpm[walk]),
        (f"BurstyViterbiDemodulator ({burst} + {guard} guard)",
         lambda w: BurstyViterbiDemodulator(alphabet, pret, pulse4, [0.0],
                                            up, burst, guard, device=w),
         yb, bsyms))
    for name, make, yv, want in scans:
        gdem, cdem = make(dev), make("cpu")
        yd = torch.from_numpy(yv).to(dev)
        gbest, gm, gv = gdem.run(yd, pathlen)
        _, cm, cv = cdem.run(torch.from_numpy(yv), pathlen)
        check(torch.equal(gv.cpu(), cv), f"{name}: paths card vs CPU")
        err = close(gm, cm, VT_RTOL)
        check(np.allclose(gbest.cpu().numpy(), want, atol=1e-4),
              f"{name}: planted symbols")
        ms = median_ms(lambda: gdem.run(yd, pathlen), reps=3)
        key = "viterbi_general_scan" if "general" in name \
            else "bursty_viterbi_scan"
        out[key] = {"ms": ms, "msymbols_per_s": pathlen / ms / 1e3,
                    "pathlen": pathlen, "metric_rel_err": err}
        us = ms / pathlen * 1e3
        print(f"{name}, {pathlen} symbols: {ms:.4f} ms ({us:.1f} us a "
              f"symbol); paths equal on the card and the CPU, planted "
              f"symbols decoded {tag}")

    launches = {k.__name__: k.launches for k in kernels}
    check(not any(launches.values()),
          f"the demodulation layer launched a kernel: {launches}")
    out["launches"] = launches
    return out


def geo_scene(dev, seed: int) -> dict:
    """The TDOA/FDOA scene on ``dev``, made by the port's own generators:
    the receivers' tracks (host float64, one row a sample), a CP2FSK burst
    whose phase curve a ``ConstAmpSigLerp`` propagates along each receiver's
    tau(t) = |r(t) - e| / c in float64 (carrier included), cast to complex64
    and summed with ``randnoise``; the template is the reference capture's
    ``GEO_BURST`` samples from ``GEO_T0``."""
    import torch
    from pydsproutines_tpu_torch.estimation import (
        create_circular_trajectory, create_linear_trajectory)
    from pydsproutines_tpu_torch.signal import (ConstAmpSigLerp,
                                                make_pulsed_cpfsk_syms,
                                                rand_bits, randnoise)
    dt, baud = 1.0 / GEO_FS, GEO_FS / GEO_UP
    gen = torch.Generator(device=dev).manual_seed(seed)
    (a1, b1, v1), (a3, b3, v3) = GEO_LINEAR
    radius, speed, height, phi = GEO_CIRCLE
    n = GEO_CAPTURE
    tracks = [(np.tile(GEO_REF, (n, 1)), np.zeros((n, 3))),
              create_linear_trajectory(n, a1, b1, v1, dt),
              create_circular_trajectory(n, radius, speed, height, dt,
                                         phi)[:2],
              create_linear_trajectory(n, a3, b3, v3, dt)]
    e = torch.tensor(GEO_EMITTER, dtype=torch.float64, device=dev)
    taus = [torch.linalg.vector_norm(torch.from_numpy(r).to(dev) - e, dim=1)
            / LIGHTSPEED for r, _ in tracks]
    # the full convolution with the 8-tap phase pulse adds 8 samples
    bits = rand_bits(gen, (GEO_BURST - GEO_UP) // GEO_UP, 2, device=dev)
    css = make_pulsed_cpfsk_syms(bits, baud, up=GEO_UP,
                                 dtype=torch.complex128)[3]
    check(css.shape[0] == GEO_BURST, f"burst of {css.shape[0]} samples")
    t_e = GEO_T0 * dt - float(taus[0][0])      # emission of the first sample
    sig = ConstAmpSigLerp(t_e, t_e + (GEO_BURST - 1) * dt, css, dt, 1.0,
                          GEO_FC, device=dev)
    t = torch.arange(n, dtype=torch.float64, device=dev) * dt
    snr = 10 ** (GEO_SNR_DB / 10)
    caps = [sig.propagate(t, tau).to(torch.complex64)
            + randnoise(gen, n, baud, GEO_FS, snr, device=dev)
            for tau in taus]
    return {"caps": caps,
            "template": caps[0][GEO_T0: GEO_T0 + GEO_BURST].clone(),
            "tracks": tracks, "taus": taus}


def geo_truth(scene: dict, k: int) -> tuple[float, float]:
    """Pair (0, k)'s TDOA (s) and FDOA (Hz) at the burst's centre: tau_k -
    tau_0, and -fc times the rate of that difference."""
    mid = GEO_T0 + GEO_BURST // 2
    e = np.asarray(GEO_EMITTER)
    rate = []
    for r, v in (scene["tracks"][0], scene["tracks"][k]):
        u = (r[mid] - e) / np.linalg.norm(r[mid] - e)
        rate.append(u @ v[mid] / LIGHTSPEED)
    td = float(scene["taus"][k][mid] - scene["taus"][0][mid])
    return td, -GEO_FC * (rate[1] - rate[0])


def geo_fine(template, rx, shift: int, bin_: int) -> dict:
    """The fine stage of one pair on the capture's device: ``czt_xcorr``
    over +-2 coarse bins at 0.5 Hz at the coarse shift, then
    ``fine_freq_time_search`` (0.5 and 0.1 Hz passes, +-1 sample of delay
    at 0.01)."""
    import torch
    from pydsproutines_tpu_torch.ops import czt_xcorr, fine_freq_time_search
    n, fs = template.shape[-1], GEO_FS
    fd = (bin_ if bin_ < n // 2 else bin_ - n) * fs / n
    caf, freqs = czt_xcorr(template, rx, fd - 2 * fs / n, fd + 2 * fs / n,
                           fs, czt_step=GEO_CZT_STEP, output_caf=True,
                           shifts=np.array([shift]))
    ci = int(torch.argmax(caf[0]))
    td_scan = np.arange(-1.0, 1.0, GEO_TD_STEP) / fs
    ff, td, cost = fine_freq_time_search(
        template, rx[shift: shift + n], fine_res=list(GEO_FINE_RES),
        freqfound=float(freqs[ci]), freq_res=fs / n, fs=fs,
        td_scan_range=td_scan,
        td_scan_freq_bounds=GEO_TD_BAND)
    return {"caf": caf[0], "czt_i": ci, "fhz": float(freqs[ci]),
            "ff": float(ff), "td": float(td), "cost": cost.abs()}


def geo_measurements(scene: dict, peaks, fines) -> dict:
    """The grid search's inputs: per pair (0, k) the receivers' positions
    and velocities at the burst's reception (the reference at its template's
    centre, receiver k at its peak shift's), the measured TDOA (coarse shift
    plus the fine delay) and FDOA, and Stein's sigmas for the scene's
    in-band SNR over the burst."""
    from pydsproutines_tpu_torch.ops.xcorr import (expected_eff_snr,
                                                   sigma_dfo, sigma_dto)
    half, t0 = GEO_BURST // 2, GEO_T0
    r0, v0 = scene["tracks"][0]
    s1, s2, v1, v2, tdoa, fdoa = [], [], [], [], [], []
    for k, (shift, _, _), fine in zip((1, 2, 3), peaks, fines):
        rk, vk = scene["tracks"][k]
        s1.append(r0[t0 + half])
        v1.append(v0[t0 + half])
        s2.append(rk[shift + half])
        v2.append(vk[shift + half])
        tdoa.append((shift - t0) / GEO_FS + fine["td"])
        fdoa.append(fine["ff"])
    # per-sample SNR over the whole band: the in-band SNR times baud / fs
    snr = 10 ** (GEO_SNR_DB / 10) / GEO_UP
    eff = expected_eff_snr(snr, snr)
    integ = GEO_BURST / GEO_FS
    return {"s1": np.array(s1), "s2": np.array(s2), "v1": np.array(v1),
            "v2": np.array(v2), "tdoa": np.array(tdoa),
            "fdoa": np.array(fdoa),
            "td_sigma": float(sigma_dto(GEO_FS / GEO_UP, GEO_FS, integ, eff)),
            "fd_sigma": float(sigma_dfo(GEO_FS, integ, eff))}


def geo_run_grid(loc, m: dict):
    return loc.run(m["s1"], m["s2"], m["tdoa"], [m["td_sigma"]] * 3,
                   m["v1"], m["v2"], m["fdoa"], [m["fd_sigma"]] * 3, GEO_FC)


def geo_crb(m: dict, located) -> dict:
    """The TDOA+FDOA CRB at the planted emitter, constrained to a stationary
    emitter on z = 0 (position x, y free), and its 95% ellipse around the
    located point."""
    from scipy.stats import chi2
    from pydsproutines_tpu_torch.estimation import (calc_crb_tdfd,
                                                    project_crb_to_ellipse)
    s = np.column_stack([m["s1"][0], *m["s2"]])
    sdot = np.column_stack([m["v1"][0], *m["v2"]])
    crb = calc_crb_tdfd(np.asarray(GEO_EMITTER), s,
                        np.full(3, m["td_sigma"] * LIGHTSPEED), np.zeros(3),
                        sdot, np.full(3, m["fd_sigma"] / GEO_FC * LIGHTSPEED),
                        pairs=[(1, 0), (2, 0), (3, 0)],
                        cmat=np.eye(6)[:, 2:])
    ellipse = project_crb_to_ellipse(crb[:3, :3], located, 0.95)
    return {"crb": crb, "ellipse": ellipse, "k95": float(chi2.ppf(0.95, 2))}


def geolocation(dev, kernels) -> tuple[dict, dict]:
    """The TDOA/FDOA geolocation path on ``dev`` through the public entry
    points: the scene (``geo_scene``), one ``CheckpointedXcorrPipeline`` a
    pair (0, k) over the whole capture in blocks (each timed run on a fresh
    database), the fine stage (``geo_fine``), ``TDFDGridLocalizer`` over a
    ``GEO_GRID`` x ``GEO_GRID`` mesh of the area, the CRB and its 95%
    ellipse, and ``propagate_signal_exact`` at ``GEO_EXACT_N``. Every
    kernel count is set to 0 before the path and read after it: only the
    CAF kernel (#2) runs, one launch a chunk of ``GEO_BATCH`` shifts. Each
    stage is held against the same call on the CPU and the scene's truth.
    Returns (the phase's results, the CAF kernel's row at the pipeline's
    shape)."""
    import os
    import statistics
    import tempfile
    from pydsproutines_tpu_torch.estimation import TDFDGridLocalizer
    from pydsproutines_tpu_torch.io import XcorrDB
    from pydsproutines_tpu_torch.models import CheckpointedXcorrPipeline
    from pydsproutines_tpu_torch.ops.fft import caf_plan, plan_flop
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (
        SCRATCH_BYTES_PER_SAMPLE, caf_peak, caf_peak_plain)
    from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr
    from pydsproutines_tpu_torch.signal import propagate_signal_exact
    from pydsproutines_tpu_torch.utils.memory import chunk_shifts
    from pydsproutines_tpu_torch.utils.timing import median_ms

    held = {}
    scene_ms = median_ms(lambda: held.update(scene=geo_scene(dev, 41)),
                         reps=3)
    sc = held["scene"]
    caps, tmpl = sc["caps"], sc["template"]
    xr = np.linspace(-GEO_HALF, GEO_HALF, GEO_GRID)
    loc = TDFDGridLocalizer.from_xy_meshgrid(xr, xr, 0.0, device=dev)
    nblocks = (GEO_CAPTURE - GEO_BURST + 1) // GEO_BLOCK
    chunks = -(-GEO_BLOCK // chunk_shifts(GEO_BURST, GEO_BATCH,
                                      SCRATCH_BYTES_PER_SAMPLE))

    with tempfile.TemporaryDirectory() as tmp:
        runs = iter(range(10**6))

        def pipeline(k):
            db = XcorrDB(os.path.join(tmp, f"run{next(runs)}.db"))
            pipe = CheckpointedXcorrPipeline(db, f"pair0{k}", tmpl, GEO_FS,
                                             GEO_FC, GEO_BLOCK, GEO_BATCH,
                                             device=dev)
            check(pipe.run(caps[k]) == nblocks, f"pair (0, {k}) blocks")
            return db, pipe

        # the path, every count at 0 just before it
        for kernel in kernels:
            kernel.launches = 0
        pipes = [pipeline(k) for k in (1, 2, 3)]
        peaks = [pipe.peak() for _, pipe in pipes]
        fines = [geo_fine(tmpl, caps[k], shift, bin_)
                 for k, (shift, _, bin_) in zip((1, 2, 3), peaks)]
        m = geo_measurements(sc, peaks, fines)
        cost = geo_run_grid(loc, m)
        located = loc.localize(cost)
        launches = {k.__name__: k.launches for k in kernels}

        route = "fused-hopper"
        want = {k.__name__: 0 for k in kernels}
        want["caf_peak"] = 3 * nblocks * chunks
        check(launches == want, f"geolocation launches {launches}, "
                                f"expected {want}")
        for (_, pipe), k in zip(pipes, (1, 2, 3)):
            check(pipe.xcorr_path == route,
                  f"pair (0, {k}) route {pipe.xcorr_path}")

        # each pair's peak block against the same sweep on the CPU; the
        # truth of the scene
        pairs, abs_errs = [], []
        cpu_tmpl = tmpl.cpu()
        for k, (db, pipe), (shift, qf2, bin_), fine in zip(
                (1, 2, 3), pipes, peaks, fines):
            b0 = shift // GEO_BLOCK * GEO_BLOCK
            row = [r for r in db.select_results(f"pair0{k}")
                   if int(r[1]) == b0]
            check(len(row) == 1, f"pair (0, {k}) block at {b0}")
            gq, gb = XcorrDB.regenerate_1d(row[0][-3], row[0][-2])
            cq, cb = fast_xcorr(cpu_tmpl, caps[k].cpu(), True,
                                shifts=np.arange(b0, b0 + GEO_BLOCK),
                                batch_size=GEO_BATCH)
            cq, cb = cq.double().numpy(), cb.numpy()
            err = float(np.max(np.abs(gq - cq) / cq))
            abs_errs.append(float(np.max(np.abs(gq - cq))))
            i = int(np.argmax(cq))
            check(err < CAF_RTOL and int(np.argmax(gq)) == i
                  and b0 + i == shift and int(gb[i]) == int(cb[i]) == bin_,
                  f"pair (0, {k}) block vs CPU: QF^2 rel err {err:.3e}, "
                  f"peak {b0 + int(np.argmax(gq))}/{b0 + i}, bins "
                  f"{int(gb[i])}/{int(cb[i])}")
            # the fine stage's picks sit on peaks flat to f32 rounding: the
            # card's must be a peak of the CPU's curves, its frequency
            # within one step of the last pass of the CPU's
            cf = geo_fine(cpu_tmpl, caps[k].cpu(), shift, bin_)
            ferr = max(rel_err(fine["caf"].cpu(), cf["caf"]),
                       rel_err(fine["cost"].cpu(), cf["cost"]))
            tdi = int(round((fine["td"] * GEO_FS + 1.0) / GEO_TD_STEP))
            near = (float(cf["caf"][fine["czt_i"]])
                    >= float(cf["caf"].max()) * (1 - CAF_RTOL)
                    and float(cf["cost"][tdi])
                    >= float(cf["cost"].max()) * (1 - CAF_RTOL))
            check(ferr < CAF_RTOL and near
                  and abs(fine["ff"] - cf["ff"]) <= GEO_FINE_RES[-1] + 1e-3,
                  f"pair (0, {k}) fine stage vs CPU: {ferr:.3e}, CZT "
                  f"{fine['fhz']}/{cf['fhz']} Hz, FDOA {fine['ff']}/"
                  f"{cf['ff']} Hz, delay {fine['td']}/{cf['td']} s")
            td_true, fd_true = geo_truth(sc, k)
            td = m["tdoa"][k - 1]
            check(abs(td - td_true) < 5 * m["td_sigma"]
                  and abs(fine["ff"] - fd_true) < 5 * m["fd_sigma"],
                  f"pair (0, {k}): TDOA {td:.9e} s (true {td_true:.9e}), "
                  f"FDOA {fine['ff']:.3f} Hz (true {fd_true:.3f})")
            pairs.append({"pair": [0, k], "shift": shift, "bin": bin_,
                          "qf2": qf2, "block_rel_err": err,
                          "czt_hz": fine["fhz"], "fdoa_hz": fine["ff"],
                          "fdoa_true_hz": fd_true, "tdoa_s": td,
                          "tdoa_true_s": td_true, "fine_rel_err": ferr})

        # the whole grid against the CPU's; the located point and the CRB
        cpu_loc = TDFDGridLocalizer.from_xy_meshgrid(xr, xr, 0.0,
                                                     device="cpu")
        ccost = geo_run_grid(cpu_loc, m).numpy()
        gcost = cost.cpu().numpy()
        grid_err = float(np.max(np.abs(gcost - ccost)
                                / np.maximum(1.0, np.abs(ccost))))
        gi, ci = int(np.argmin(gcost)), int(np.argmin(ccost))
        adjacent = (abs(gi // GEO_GRID - ci // GEO_GRID) <= 1
                    and abs(gi % GEO_GRID - ci % GEO_GRID) <= 1)
        check(grid_err <= GEO_GRID_RTOL and (gi == ci or adjacent),
              f"grid vs CPU: {grid_err:.3e} of max(1, |cost|), argmin "
              f"{gi}/{ci}")
        t_crb = []
        for _ in range(5):
            c0 = time.perf_counter()
            crb = geo_crb(m, located)
            t_crb.append((time.perf_counter() - c0) * 1e3)
        cxy = crb["crb"][:2, :2]
        d = located[:2] - np.asarray(GEO_EMITTER)[:2]
        maha = float(d @ np.linalg.solve(cxy, d))
        lam = np.linalg.eigvalsh(cxy)
        a95 = float(np.sqrt(crb["k95"] * lam[-1]))
        step = float(xr[1] - xr[0])
        # the grid's argmin g scores no worse than the point nearest the
        # cost's continuous minimum m, at most half a cell's diagonal h
        # away; the cost's curvature is the FIM's, so |g - m| <=
        # sqrt(cond) * h, and m lies within a95 of the emitter
        cond = float(lam[-1] / lam[0])
        allowed = a95 + np.sqrt(cond) * step * np.sqrt(0.5)
        miss = float(np.linalg.norm(d))
        check(maha <= crb["k95"] or miss <= allowed,
              f"emitter {miss:.1f} m from the located point: Mahalanobis^2 "
              f"{maha:.2f} > {crb['k95']:.2f} and > {allowed:.1f} m")

        # propagate_signal_exact on the card vs on the CPU: the burst's
        # first exact_n samples along receiver 1's tau
        tau1 = sc["taus"][1][GEO_T0: GEO_T0 + GEO_EXACT_N]
        ex = propagate_signal_exact(tmpl[:GEO_EXACT_N], tau1, GEO_FS, GEO_FC)
        ex_cpu = propagate_signal_exact(tmpl[:GEO_EXACT_N].cpu(), tau1.cpu(),
                                        GEO_FS, GEO_FC)
        ex_err = rel_err(ex.cpu(), ex_cpu)
        check(ex_err < GEO_EXACT_RTOL,
              f"propagate_signal_exact vs CPU: {ex_err:.3e}")

        # times, each on CUDA events around the public call
        pipe_ms = median_ms(lambda: pipeline(1)[0].close(), reps=3)
        fine_ms = median_ms(lambda: [geo_fine(tmpl, caps[k], s, b) for
                                     k, (s, _, b) in zip((1, 2, 3), peaks)],
                            reps=3)
        grid_ms = median_ms(lambda: geo_run_grid(loc, m), reps=5)
        exact_ms = median_ms(lambda: propagate_signal_exact(
            tmpl[:GEO_EXACT_N], tau1, GEO_FS, GEO_FC), reps=3)
        # the CAF kernel alone at a block of the pipeline, and its twin
        cc = tmpl.conj().resolve_conj().contiguous()
        b0 = peaks[0][0] // GEO_BLOCK * GEO_BLOCK
        k_ms = median_ms(lambda: caf_peak(caps[1], cc, b0, 1, GEO_BLOCK,
                                          GEO_BATCH), reps=3)
        p_ms = median_ms(lambda: caf_peak_plain(caps[1], cc, b0, 1, GEO_BLOCK,
                                                GEO_BATCH), reps=3)
        for db, _ in pipes:
            db.close()

    shifts_searched = nblocks * GEO_BLOCK
    out = {
        "scene_ms": scene_ms, "pipeline_ms_per_pair": pipe_ms,
        "gsample_shift_per_s": GEO_BURST * shifts_searched / pipe_ms / 1e6,
        "fine_ms_3_pairs": fine_ms, "grid_ms": grid_ms,
        "gpoint_pair_per_s": GEO_GRID * GEO_GRID * 3 / grid_ms / 1e6,
        "crb_host_ms": statistics.median(t_crb),
        "propagate_exact_ms": exact_ms, "route": route,
        "blocks_per_pair": nblocks, "launches_per_block": chunks,
        "launches": launches, "pairs": pairs,
        "located_m": [float(located[0]), float(located[1])],
        "emitter_m": list(GEO_EMITTER[:2]), "miss_m": miss,
        "mahalanobis_sq": maha, "a95_m": a95, "crb_cond": cond,
        "allowed_m": allowed,
        "allowed_cells": allowed / step, "grid_step_m": step,
        "grid_argmin_card_cpu": [gi, ci], "grid_err": grid_err,
        "td_sigma_s": m["td_sigma"], "fd_sigma_hz": m["fd_sigma"],
        "exact_rel_err": ex_err}
    plan = caf_plan(GEO_BURST)
    caf_row = {
        "shape": f"n={GEO_BURST} x {GEO_BLOCK} shifts (a pipeline block)",
        "launches": launches["caf_peak"], "max_abs_err": max(abs_errs),
        "ms": k_ms, "plain_ms": p_ms, "factors": list(plan["factors"]),
        **bound(plan_flop(plan) * GEO_BLOCK,
                GEO_BLOCK * (9.0 * GEO_BURST + fft_flop(GEO_BURST)),
                8 * (2 * GEO_BURST + 2 * GEO_BLOCK - 1))}
    return out, caf_row


def int16_capture(rx: np.ndarray, files: int, peak: float):
    """(files x 2n int16 interleaved I/Q, scale): ``rx`` scaled so its
    largest component reads ``peak`` counts, rounded, split into files."""
    scale = peak / max(np.abs(rx.real).max(), np.abs(rx.imag).max())
    iq = np.stack([rx.real, rx.imag], -1) * scale
    return np.round(iq).astype(np.int16).reshape(files, -1), scale


def psk_order_scene(seed: int, rows: int, length: int, sigma: float):
    """Two batches of ``rows`` PSK rows in noise of ``sigma`` a component,
    complex64, with the orders ``PSKOrderDetector`` must read: BPSK then
    QPSK under max_m = 4, QPSK then 8PSK under max_m = 8."""
    rng = np.random.default_rng(seed)

    def batch(m1, m2):
        m = np.repeat([m1, m2], rows // 2)
        k = rng.integers(0, 8, (rows, length)) // (8 // m)[:, None]
        x = np.exp(2j * np.pi * k / m[:, None])
        x += sigma * (rng.standard_normal(x.shape)
                      + 1j * rng.standard_normal(x.shape))
        return x.astype(np.complex64), m

    return {4: batch(2, 4), 8: batch(4, 8)}


def cm_scene(seed: int, n: int, f0: float, sigma: float) -> np.ndarray:
    """A QPSK burst of ``n`` symbols at ``f0`` cycles a sample, complex64."""
    rng = np.random.default_rng(seed)
    x = np.exp(0.5j * np.pi * rng.integers(0, 4, n) + 2j * np.pi * f0
               * np.arange(n))
    x += sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def baud_scene(seed: int, syms: int, up: int) -> np.ndarray:
    """Half-sine BPSK at ``up`` samples a symbol (tests/test_analysis_ops.py's
    baud scene), complex128."""
    bits = np.random.default_rng(seed).integers(0, 2, syms)
    x = np.zeros(syms * up)
    x[::up] = bits * 2.0 - 1.0
    return np.convolve(x, np.sin(np.pi * np.arange(up) / up))[
        : syms * up].astype(complex)


def motif_scene(seed: int, n: int, w: int, at: int, lag: int) -> np.ndarray:
    """Noise of 0.05 a component with one w-symbol QPSK motif at ``at`` and
    again at ``at + lag``, complex64."""
    rng = np.random.default_rng(seed)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    motif = np.exp(0.5j * np.pi * rng.integers(0, 4, w))
    x[at: at + w] += motif
    x[at + lag: at + lag + w] += motif
    return x.astype(np.complex64)


def mp_reference(x: np.ndarray, w: int, d: int) -> np.ndarray:
    """Diagonal d of the normalized matrix profile in float64 numpy (window
    sums by float64 prefix sums: exact enough for a reference)."""
    x = x.astype(np.complex128)

    def sums(v):
        c = np.concatenate([[0], np.cumsum(v)])
        return c[w:] - c[:-w]

    norms = sums(np.abs(x) ** 2)
    k = sums(x[:-d] * x[d:].conj())
    return np.abs(k) ** 2 / norms[:-d] / norms[d:]


def device_profile(fn, top: int = 5) -> dict:
    """One call of ``fn`` under the profiler's CUDA activity alone: the
    host's wall ms (the call ends in a synchronize); the device's busy ms,
    the union of the intervals of its device events (kernels, copies,
    sets), each counted once, as torch's own table counts only device
    events; the busy share, busy over wall; and the ``top`` kernels by
    device ms, each [name, ms, launches]. NaN and an empty list where the
    profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, n + 1)
    busy_ms = busy_us / 1e3 if spans else float("nan")
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "device_events": len(spans),
            "top": [[name[:60], us / 1e3, n] for name, (us, n) in heavy]}


def analysis(dev, kernels) -> dict:
    """The capture-to-analysis path on ``dev`` through the public entry
    points: the receiver's 8M-sample scene written as int16 I/Q files, read
    back by ``StreamingCaptureLoader`` (halo 0) and each frame channelised
    on the card by one ``Channeliser`` (#1); ``multichannel_minmax_scale``
    in both modes; the strongest channel's ``fast_xcorr`` over 256 shifts
    (#2); ``cancel_signal_at_idx`` of the template at the peak and of the
    burst as the channel received it; ``music_xcorr_device`` around the
    peak (its FIR one launch of #5); ``PSKOrderDetector``,
    ``estimate_offset_via_cm`` and ``estimate_baud``;
    ``MatrixProfile(output_chains=True)`` at the JAX benchmark's size (its
    window sums through #5); the three masked-row products. Every kernel count is set
    to 0 before the path and read after it, against the counts the code
    predicts; each step is then held against the same call on the CPU and
    the scene's truth, and timed on CUDA events (median of 3). The whole
    path, MUSIC and the matrix profile are each profiled once more for
    their device busy time and heaviest kernels."""
    import os
    import tempfile
    import torch
    from scipy import signal as sps
    from pydsproutines_tpu_torch.io import (StreamingCaptureLoader,
                                            is_int16_clipping)
    from pydsproutines_tpu_torch.ops import (
        Channeliser, MatrixProfile, PSKOrderDetector, cancel_signal_at_idx,
        estimate_baud, estimate_offset_via_cm, fast_xcorr, matrix_profile,
        multichannel_minmax_scale, multiply_masked_rows_gathered,
        multiply_only_masked_rows, multiply_rows_based_on_mask,
        music_xcorr_device)
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import \
        SCRATCH_BYTES_PER_SAMPLE
    from pydsproutines_tpu_torch.ops.hopper.upfirdn import upfirdn_planes
    from pydsproutines_tpu_torch.utils.memory import chunk_shifts
    from pydsproutines_tpu_torch.utils.timing import median_ms

    secs, t0 = {}, time.perf_counter()

    def lap(name):                       # host seconds of each section
        nonlocal t0
        t1 = time.perf_counter()
        secs[name] = t1 - t0
        t0 = t1

    n_wide = AN_FILES * AN_FILE_SAMPS
    syms, rx, burst = scene_burst(NCH, TAPS, N_RX, SHIFTS_RX, n_wide, seed=7)
    raw, scale = int16_capture(rx, AN_FILES, AN_INT16_PEAK)
    capture = raw.reshape(-1).astype(np.float32).view(np.complex64)
    template = torch.from_numpy(syms.astype(np.complex64)).to(dev)
    # the burst alone, as the channel receives it (scene, not path)
    replica = Channeliser(TAPS, NCH, device=dev).channelise(
        torch.from_numpy((burst * scale).astype(np.complex64)).to(dev))
    psk = psk_order_scene(51, AN_PSK_ROWS, AN_PSK_LEN, AN_PSK_SIGMA)
    cm_x = cm_scene(52, AN_CM_LEN, AN_CM_F0, AN_PSK_SIGMA)
    baud_x = baud_scene(53, AN_BAUD_SYMS, AN_BAUD_UP)
    mp_x = motif_scene(54, AN_MP_N, AN_MP_W, AN_MP_AT, AN_MP_LAG)
    g = torch.Generator(device=dev).manual_seed(55)
    mx, my, my1 = (torch.randn((AN_MASK_ROWS, AN_MASK_LEN),
                               dtype=torch.complex64, device=dev,
                               generator=g) for _ in range(3))
    mask = torch.zeros(AN_MASK_ROWS, dtype=torch.int32, device=dev)
    mask[::AN_MASK_EVERY] = 1
    mu_taps = sps.firwin(AN_MU_TAPS, 0.8 / AN_MU_DSR)
    num_diags = AN_MP_N - AN_MP_W

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{1000 + i}.bin") for i in range(AN_FILES)]
        for part, path in zip(raw, paths):
            part.tofile(path)

        def read_and_channelise():
            chan = Channeliser(TAPS, NCH, device=dev)
            frames, outs = [], []
            with StreamingCaptureLoader(paths, AN_FILE_SAMPS, halo=0) as ldr:
                loader = "native" if ldr._handle is not None else "numpy"
                for _, frame in ldr:
                    frames.append(frame)
                    outs.append(chan.channelise(torch.from_numpy(frame).to(dev)))
            return frames, torch.cat(outs), loader

        def music(x, pk, f_pk):
            return music_xcorr_device(
                template, x, f_pk + np.linspace(-2, 2, AN_MU_POINTS) / N_RX,
                mu_taps, 1.0, AN_MU_DSR, [1, 2], musicrows=AN_MU_ROWS,
                shifts=np.arange(pk - AN_MU_HALF, pk + AN_MU_HALF))

        e_rep = replica[:, AN_CHANNEL].abs() ** 2
        nz = torch.nonzero(e_rep > 1e-6 * e_rep.max()).flatten()
        span = (int(nz[0]), int(nz[-1]) + 1)

        def path():
            r = {}
            r["frames"], chans, r["loader"] = read_and_channelise()
            r["chans"] = chans
            ch = chans.T.contiguous()
            r["scaled"] = multichannel_minmax_scale(ch)
            r["scaled_c"] = multichannel_minmax_scale(ch, preserve_phase=True)
            energy = torch.mean(chans.real ** 2 + chans.imag ** 2, dim=0)
            r["best"] = best = int(torch.argmax(energy))
            r["x"] = x = chans[:, best].contiguous()
            r["qf2"], r["bins"] = fast_xcorr(
                template, x, True, shifts=torch.arange(SHIFTS_RX, device=dev))
            r["pk"] = pk = int(torch.argmax(r["qf2"]))
            b = int(r["bins"][pk])
            r["f_pk"] = ((b + N_RX // 2) % N_RX - N_RX // 2) / N_RX
            r["cancel"] = cancel_signal_at_idx(template, x, pk)
            lo, hi = span
            r["cancel_rep"] = cancel_signal_at_idx(replica[lo:hi, best], x, lo)
            before = upfirdn_planes.launches
            r["grids"] = music(x, pk, r["f_pk"])
            r["music_launches"] = upfirdn_planes.launches - before
            r["orders"] = {m: PSKOrderDetector(m).estimate_order(
                torch.from_numpy(psk[m][0]).to(dev)) for m in (4, 8)}
            r["offset"] = float(estimate_offset_via_cm(
                torch.from_numpy(cm_x).to(dev), 1.0, 4))
            r["baud"] = estimate_baud(baud_x, 1.0)[0]
            r["chains"] = MatrixProfile(AN_MP_W, output_chains=True,
                                        min_threshold=0.5).compute(
                torch.from_numpy(mp_x).to(dev))
            r["masked"] = (multiply_only_masked_rows(mask, mx, my),
                           multiply_rows_based_on_mask(mask, mx, my, my1),
                           multiply_masked_rows_gathered(mask, mx, my,
                                                         AN_MASK_CAP))
            torch.cuda.synchronize()
            return r

        lap("scene")
        # the path, every count at 0 just before it
        for kernel in kernels:
            kernel.launches = 0
        r = path()
        launches = {k.__name__: k.launches for k in kernels}
        want = {k.__name__: 0 for k in kernels}
        want["wola_fused"] = AN_FILES
        want["caf_peak"] = -(-SHIFTS_RX // chunk_shifts(
            N_RX, min(128, SHIFTS_RX), SCRATCH_BYTES_PER_SAMPLE))
        # MUSIC's FIR, then the matrix profile's norms and one a batch
        want["upfirdn_planes"] = 1 + 1 + -(-num_diags // 64)
        check(launches == want, f"analysis launches {launches}, expected "
                                f"{want}")
        check(r["music_launches"] == 1,
              f"music_xcorr_device launched #5 {r['music_launches']} times")

        lap("path")
        # the capture read back, and streaming continuity
        frames, chans = r["frames"], r["chans"]
        check(all(isinstance(f, np.ndarray) and f.dtype == np.complex64
                  and f.shape == (AN_FILE_SAMPS,) for f in frames)
              and np.array_equal(np.concatenate(frames), capture),
              "the frames read differ from the capture written")
        check(not is_int16_clipping(capture)
              and not any(is_int16_clipping(f) for f in frames),
              "the capture clips")
        whole = Channeliser(TAPS, NCH, device=dev).channelise(
            torch.from_numpy(capture).to(dev))
        stream_err = rel_err(chans, whole)
        check(chans.shape == (n_wide // NCH, NCH) and stream_err < WOLA_RTOL,
              f"streamed channels vs the whole capture: {stream_err:.3e}")
        ms = {"read_channelise": median_ms(read_and_channelise, reps=3)}

        # min-max scaling against the CPU
        ch = chans.T.contiguous()
        ch_cpu = ch.cpu()
        mm_err = []
        for key, mode in (("scaled", False), ("scaled_c", True)):
            ref = multichannel_minmax_scale(ch_cpu, mode)
            mm_err.append(float((r[key].cpu() - ref).abs().max()))
            ms[f"minmax_{int(mode)}"] = median_ms(
                lambda m=mode: multichannel_minmax_scale(ch, m), reps=3)
        sc = r["scaled"]
        check(max(mm_err) < AN_MINMAX_ATOL and float(sc.min()) == 0.0
              and float(sc.amax(-1).min()) == 1.0,
              f"min-max scaling card vs CPU {mm_err}")

        # the burst: channel, CAF peak against the CPU and the plant
        x, pk, best = r["x"], r["pk"], r["best"]
        x_cpu, t_cpu = x.cpu(), template.cpu()
        q_cpu, b_cpu = fast_xcorr(t_cpu, x_cpu, True,
                                  shifts=torch.arange(SHIFTS_RX))
        pk_cpu = int(torch.argmax(q_cpu))
        check(best == AN_CHANNEL and pk == pk_cpu == AN_SHIFT
              and int(r["bins"][pk]) == int(b_cpu[pk_cpu]) == AN_BIN,
              f"burst at channel {best}, shift {pk} (CPU {pk_cpu}), bin "
              f"{int(r['bins'][pk])}")
        ms["fast_xcorr"] = median_ms(lambda: fast_xcorr(
            template, x, True, shifts=torch.arange(SHIFTS_RX, device=dev)),
            reps=3)

        # cancellation: the template at the peak removes its share QF^2 of
        # the window's energy; the burst as received leaves the noise
        win = slice(pk, pk + N_RX)
        (c_t, amp_t), (c_r, amp_r) = r["cancel"], r["cancel_rep"]
        amp_t_cpu = cancel_signal_at_idx(t_cpu, x_cpu, pk)[1]
        lo, hi = span
        amp_r_cpu = cancel_signal_at_idx(replica[lo:hi, best].cpu(), x_cpu,
                                         lo)[1]
        amp_errs = [float(abs(a.cpu() - b) / abs(b)) for a, b in
                    ((amp_t, amp_t_cpu), (amp_r, amp_r_cpu))]
        removed = float((c_t[win].abs() ** 2).sum() / (x[win].abs() ** 2)
                        .sum())
        q_pk = float(r["qf2"][pk])
        resid = float(c_r[lo:hi].norm() / x[lo:hi].norm())
        check(max(amp_errs) < AN_CANCEL_RTOL, f"cancellation amplitudes "
                                              f"card vs CPU {amp_errs}")
        check(abs(removed - (1 - q_pk)) < CAF_RTOL,
              f"template cancellation left {removed:.6f} of the window, "
              f"1 - QF^2 = {1 - q_pk:.6f}")
        check(resid < 0.2 and abs(complex(amp_r) - 1) < 0.05,
              f"received-burst cancellation: residual {resid:.4f} of the "
              f"window's norm, amplitude {complex(amp_r):.4f}")
        ms["cancel"] = median_ms(lambda: cancel_signal_at_idx(template, x,
                                                              pk), reps=3)

        lap("capture_minmax_xcorr_cancel")
        # MUSIC around the peak against the CPU
        grids_cpu = music(x_cpu, pk, r["f_pk"])
        mu = {"notch_entries": 0, "inverse_rel_err": 0.0, "row_err": 0.0}
        for p in (1, 2):
            a, b = r["grids"][p], grids_cpu[p]
            rowmax = b.max(axis=1, keepdims=True)
            held = b >= AN_MU_NOTCH * rowmax
            inv_ok = (np.abs(1 / a - 1 / b)
                      <= 1e-3 * np.abs(1 / b) + 1e-6 * np.max(1 / b))
            row_err = float((np.abs(a - b) / rowmax).max())
            check(a.shape == (2 * AN_MU_HALF, AN_MU_POINTS)
                  and bool(np.isfinite(a).all()) and bool(inv_ok[held].all())
                  and row_err < AN_MU_NOTCH,
                  f"MUSIC p={p} card vs CPU: {int((~inv_ok[held]).sum())} "
                  f"inverse-grid entries off, grid {row_err:.3e} of a row's "
                  f"maximum")
            i, j = np.unravel_index(np.argmax(a), a.shape)
            check((i, j) == np.unravel_index(np.argmax(b), b.shape)
                  and pk - AN_MU_HALF + i == AN_SHIFT,
                  f"MUSIC p={p} peaks at shift {pk - AN_MU_HALF + i}")
            mu["notch_entries"] += int((~held).sum())
            mu["row_err"] = max(mu["row_err"], row_err)
            mu["inverse_rel_err"] = max(mu["inverse_rel_err"], float(
                (np.abs(1 / a - 1 / b) / np.abs(1 / b))[held].max()))
        ms["music"] = median_ms(lambda: music(x, pk, r["f_pk"]), reps=3)

        lap("music")
        # blind modulation estimates against the CPU and the plants
        for m in (4, 8):
            rows, want_m = psk[m]
            cpu_order = PSKOrderDetector(m).estimate_order(
                torch.from_numpy(rows))
            check(np.array_equal(r["orders"][m], want_m)
                  and np.array_equal(cpu_order, want_m),
                  f"PSK orders under max_m={m}: card "
                  f"{np.bincount(r['orders'][m])}, CPU "
                  f"{np.bincount(cpu_order)}")
            rows_d = torch.from_numpy(rows).to(dev)
            ms[f"psk_order_{m}"] = median_ms(
                lambda d=rows_d, mm=m: PSKOrderDetector(mm).estimate_order(d),
                reps=3)
        off_cpu = float(estimate_offset_via_cm(torch.from_numpy(cm_x), 1.0, 4))
        check(r["offset"] == off_cpu and abs(r["offset"] - AN_CM_F0) < 1e-3,
              f"CM offset {r['offset']} (CPU {off_cpu}, planted {AN_CM_F0})")
        cm_d = torch.from_numpy(cm_x).to(dev)
        ms["offset_via_cm"] = median_ms(
            lambda: estimate_offset_via_cm(cm_d, 1.0, 4), reps=3)
        check(abs(r["baud"] - 1 / AN_BAUD_UP) * AN_BAUD_UP < 0.05,
              f"baud {r['baud']} vs {1 / AN_BAUD_UP}")

        lap("modulation")
        # the matrix profile against float64 numpy and the motif
        xm = torch.from_numpy(mp_x).to(dev)
        mp, nout = matrix_profile(xm, AN_MP_W, num_diags), num_diags + 1
        check(mp.shape == (num_diags, nout) and mp.dtype == torch.float32,
              f"matrix profile shape {tuple(mp.shape)}")
        mp_err = 0.0
        for d in np.linspace(1, num_diags, AN_MP_HELD).astype(int):
            row = mp[d - 1].cpu().numpy().astype(np.float64)
            ref = mp_reference(mp_x, AN_MP_W, d)
            mp_err = max(mp_err, float((np.abs(row[:nout - d] - ref)
                                        / np.maximum(1, np.abs(ref))).max()))
            check(not row[nout - d:].any(), f"diagonal {d} past its end")
        check(mp_err < AN_MP_ATOL, f"matrix profile vs float64 {mp_err:.3e}")
        check(any(d == AN_MP_LAG and s <= AN_MP_AT < e
                  for d, s, e in r["chains"]),
              f"no chain at diagonal {AN_MP_LAG} over {AN_MP_AT}: "
              f"{r['chains'][:8]}")
        del mp
        ms["matrix_profile"] = median_ms(
            lambda: matrix_profile(xm, AN_MP_W, num_diags), reps=3)
        ms["matrix_profile_chains"] = median_ms(
            lambda: MatrixProfile(AN_MP_W, output_chains=True,
                                  min_threshold=0.5).compute(xm), reps=3)

        lap("matrix_profile")
        # masked rows against the CPU
        m_cpu = [t.cpu() for t in (mask, mx, my, my1)]
        ref = (multiply_only_masked_rows(m_cpu[0], m_cpu[1], m_cpu[2]),
               multiply_rows_based_on_mask(*m_cpu),
               multiply_masked_rows_gathered(m_cpu[0], m_cpu[1], m_cpu[2],
                                             AN_MASK_CAP))
        got = r["masked"]
        mask_err = max(close(got[0], ref[0], AN_MASK_RTOL),
                       close(got[1], ref[1], AN_MASK_RTOL),
                       close(got[2][0], ref[2][0], AN_MASK_RTOL))
        count = got[2][1]
        check(count.dtype == torch.int32 and int(count) == int(ref[2][1])
              == AN_MASK_ROWS // AN_MASK_EVERY, f"masked count {int(count)}")
        ms["masked_only"] = median_ms(
            lambda: multiply_only_masked_rows(mask, mx, my), reps=3)
        ms["masked_two_banks"] = median_ms(
            lambda: multiply_rows_based_on_mask(mask, mx, my, my1), reps=3)
        ms["masked_gathered"] = median_ms(
            lambda: multiply_masked_rows_gathered(mask, mx, my, AN_MASK_CAP),
            reps=3)

        lap("masked")
        ms["path"] = median_ms(path, reps=3, warmup=0)
        prof = {"path": device_profile(path),
                "music": device_profile(lambda: music(x, pk, r["f_pk"])),
                "matrix_profile_chains": device_profile(
                    lambda: MatrixProfile(AN_MP_W, output_chains=True,
                                          min_threshold=0.5).compute(xm))}
        lap("profiled")

    pairs = num_diags * nout - num_diags * (num_diags + 1) // 2
    mp_bytes = 4 * num_diags * nout
    return {
        "loader": r["loader"], "launches": launches,
        "music_launches": r["music_launches"],
        "stream_rel_err": stream_err, "minmax_abs_err": max(mm_err),
        "peak": [best, pk, int(r["bins"][pk])], "qf2": q_pk,
        "cancel_amp_rel_err": max(amp_errs), "template_left": removed,
        "received_left_norm": resid,
        "received_amp": [complex(amp_r).real, complex(amp_r).imag],
        "music": mu, "cm_offset": r["offset"], "baud": r["baud"],
        "mp_err": mp_err, "mp_chains": len(r["chains"]),
        "mp_gpairs_per_s": pairs / ms["matrix_profile"] / 1e6,
        "mp_output_bytes": mp_bytes,
        "mp_bytes_bound_ms": mp_bytes / HBM_BYTES_PER_S * 1e3,
        "masked_rel_err": mask_err, "ms": ms, "profile": prof,
        "busy_share": prof["path"]["busy_share"], "phase_s": secs}


def receiver_capture() -> np.ndarray:
    """The receiver's 8,388,608-sample capture (``scene_burst``, seed 7),
    complex64."""
    return scene_burst(NCH, TAPS, N_RX, SHIFTS_RX, ROWS * NCH,
                       7)[1].astype(np.complex64)


def group_params(gx) -> dict:
    """A GroupXcorrCZT plan's numpy constants: every rank builds an equal
    plan from them with ``GroupXcorrCZT.from_numpy_params``."""
    return {"ystack": gx.ystack, "starts": gx.starts, "lengths": gx.lengths,
            "group_phases": gx.group_phases,
            "ystack_norm_sq": gx.ystack_norm_sq, "tones": gx.plan.tones,
            "f1": gx.plan.f1, "bin_width": gx.plan.bin_width,
            "k": gx.plan.k, "fs": gx.plan.fs}


def sweep_peak(qf2, bins, shifts) -> tuple:
    """(QF^2, shift, bin) of a sweep's largest QF^2, the first on ties."""
    import torch
    i = int(torch.argmax(qf2))
    return float(qf2[i]), int(shifts[i]), int(bins[i])


def grid_peak(caf, shifts) -> tuple:
    """(QF^2, shift, bin) of a (shifts, k) grid's largest entry."""
    import torch
    i, j = np.unravel_index(int(torch.argmax(caf)), caf.shape)
    return float(caf[i, j]), int(shifts[i]), int(j)


def par_ms(fn, dev):
    """Median CUDA-event ms of ``fn()`` (3 calls after a warm-up) on the
    card; None on the CPU, where nothing is measured."""
    from pydsproutines_tpu_torch.utils.timing import median_ms
    return median_ms(fn, reps=3) if dev.type == "cuda" else None


def hold_sharded(name, got, ref, coord: int, size: int, planted) -> float:
    """A sharded call's result on this rank against the single-device
    call's: each DTensor's local block against its slice of the whole
    (floats within PAR_TOL of max |ref|, integers equal), a peak triple
    equal on every field and at the ``planted`` (shift, bin). Returns the
    largest |d|."""
    import torch
    if not isinstance(got[0] if isinstance(got, tuple) else got,
                      torch.Tensor):
        check(tuple(got) == tuple(ref), f"{name}: peak {got} vs the "
                                        f"single-device call's {ref}")
        check(planted is None or tuple(got[1:]) == planted,
              f"{name}: peak at {got[1:]}, planted at {planted}")
        return 0.0
    err = 0.0
    for g, r in zip(*((v if isinstance(v, tuple) else (v,))
                      for v in (got, ref))):
        g, n = g.to_local(), r.shape[0] // size
        r = r[coord * n: (coord + 1) * n]
        check(g.shape == r.shape, f"{name}: block {tuple(g.shape)} vs "
                                  f"{tuple(r.shape)}")
        if r.is_floating_point() or r.is_complex():
            d = float((g - r).abs().max())
            err = max(err, d)
            check(bool(torch.isfinite(g).all())
                  and d <= PAR_TOL * float(r.abs().max()),
                  f"{name}: max|d| {d:.3e} against the single-device call")
        else:
            check(torch.equal(g, r), f"{name}: bins differ from the "
                                     f"single-device call's")
    return err


def par_run(calls: dict, kernels, mesh, dev) -> dict:
    """Run every sharded call once with each kernel's launch count at 0
    before them and read after; hold each against its single-device call
    (``hold_sharded``); time both. ``calls``: name -> (sharded call,
    single-device call, the function whose ``route`` the call sets or None,
    the planted (shift, bin) or None)."""
    import torch
    sub = mesh["dsp"]
    for kernel in kernels:
        kernel.launches = 0
    outs, routes = {}, {}
    for name, (fn, _, holder, _) in calls.items():
        outs[name] = fn()
        if holder is not None:
            routes[name] = list(holder.route)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    errs = {name: hold_sharded(name, outs[name], single(),
                               sub.get_local_rank(), sub.size(), planted)
            for name, (_, single, _, planted) in calls.items()}
    return {"routes": routes, "launches": launches, "max_abs_err": errs,
            "ms": {n: par_ms(c[0], dev) for n, c in calls.items()},
            "single_ms": {n: par_ms(c[1], dev) for n, c in calls.items()}}


def parallel_one_rank(dev, kernels) -> dict:
    """(a) The distribution layer on the one rank of the group that
    ``make_mesh()`` starts (NCCL on the card), at the main path's widths:
    ``sharded_wola`` on the receiver's 8M capture (#1),
    ``sharded_multichannel_wola`` on it as 4 captures (#1),
    ``sharded_lfilter`` on 4M samples with 128 taps (#5),
    ``sharded_fast_xcorr`` / ``sharded_caf_peak`` at n = 1M x 128 (#2) and
    over a listed sweep (#4), the group CAF at the bench cell (#8); each
    against the single-device call (``par_run``)."""
    import torch
    import torch.distributed as dist
    from scipy import signal as sps
    from pydsproutines_tpu_torch import parallel as par
    from pydsproutines_tpu_torch.ops import fast_xcorr, lfilter_fir, wola
    from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT
    from pydsproutines_tpu_torch.parallel._exchange import transport

    rng = np.random.default_rng(12)
    x8 = torch.from_numpy(receiver_capture()).to(dev)
    xm, x4 = x8.reshape(PAR_MC, -1), x8[:N_FIR]
    h = torch.from_numpy(sps.firwin(TAPS, 1.0 / NCH).astype(np.float32)
                         ).to(dev)
    fir = torch.from_numpy(sps.firwin(FIR_TAPS, 0.25).astype(np.float32)
                           ).to(dev)
    cut, rx = planted_sweep(rng, N_BIG, SHIFTS_BIG, *PAR_PEAK, dev)
    sweep = np.arange(SHIFTS_BIG)
    listed = np.sort(rng.choice(SPAN_4, SHIFTS_4, replace=False))
    cut4, rx4 = listed_sweep(rng, N_4, listed, PAR_PEAK[0], PAR_LIST_BIN,
                             dev)
    args, rx_g = group_args(rng)
    plan = GroupXcorrCZT.from_numpy_params(
        group_params(GroupXcorrCZT(*args, device="cpu")), device=dev)
    rx_g, g_sweep = torch.from_numpy(rx_g).to(dev), np.arange(G_SHIFTS)
    mesh = par.make_mesh(device_type=dev.type)
    calls = {
        "sharded_wola": (
            lambda: par.sharded_wola(h, x8, NCH, NCH, mesh),
            lambda: wola(h, x8, NCH, NCH), par.sharded_wola, None),
        "sharded_multichannel_wola": (
            lambda: par.sharded_multichannel_wola(h, xm, NCH, NCH, mesh),
            lambda: torch.stack([wola(h, r, NCH, NCH) for r in xm]),
            par.sharded_multichannel_wola, None),
        "sharded_lfilter": (lambda: par.sharded_lfilter(fir, x4, mesh),
                            lambda: lfilter_fir(fir, x4), None, None),
        "sharded_fast_xcorr": (
            lambda: par.sharded_fast_xcorr(cut, rx, sweep, mesh),
            lambda: fast_xcorr(cut, rx, True, shifts=sweep),
            par.sharded_fast_xcorr, None),
        "sharded_caf_peak": (
            lambda: par.sharded_caf_peak(cut, rx, sweep, mesh),
            lambda: sweep_peak(*fast_xcorr(cut, rx, True, shifts=sweep),
                               sweep), par.sharded_caf_peak, PAR_PEAK),
        "sharded_caf_peak (listed)": (
            lambda: par.sharded_caf_peak(cut4, rx4, listed, mesh),
            lambda: sweep_peak(*fast_xcorr(cut4, rx4, True, shifts=listed),
                               listed), par.sharded_caf_peak,
            (int(listed[PAR_PEAK[0]]), PAR_LIST_BIN)),
        "sharded_group_xcorr_czt": (
            lambda: par.sharded_group_xcorr_czt(plan, rx_g, g_sweep,
                                                mesh)[0],
            lambda: plan.xcorr(rx_g, g_sweep)[0], None, None),
        "sharded_group_xcorr_peak": (
            lambda: par.sharded_group_xcorr_peak(plan, rx_g, g_sweep, mesh),
            lambda: grid_peak(plan.xcorr(rx_g, g_sweep)[0], g_sweep), None,
            (G_STAR, G_BIN)),
    }
    res = par_run(calls, kernels, mesh, dev)
    on_card = dev.type == "cuda"
    want = {"sharded_wola": "fused-hopper",
            "sharded_multichannel_wola": "fused-hopper",
            "sharded_fast_xcorr": "fused-hopper",
            "sharded_caf_peak": "fused-hopper",
            "sharded_caf_peak (listed)": "peak-kernel-hopper"}
    got = {n: r[0] for n, r in res["routes"].items()}
    check(got == (want if on_card else dict.fromkeys(want, "plain")),
          f"sharded routes {got}")
    ran = ("wola_fused", "caf_peak", "window_columns", "stage2_peak",
           "upfirdn_planes", "group_caf")
    launched = res["launches"]
    check(not on_card or (all(launched[k] > 0 for k in ran) and all(
        v == 0 for k, v in launched.items() if k not in ran)),
        f"launches of the sharded calls {launched}")
    res.update(backend=str(dist.get_backend()),
               world=dist.get_world_size(),
               transport=transport(mesh["dsp"].get_group(), dev),
               overhead_ms={n: (None if res["ms"][n] is None else
                                res["ms"][n] - res["single_ms"][n])
                            for n in calls})
    dist.destroy_process_group()
    return res


def parallel_ranks(dev) -> list[dict]:
    """(b) and (c) on PAR_RANKS ranks of one gloo group spawned on the one
    card (NCCL refuses two ranks on one device), each rank on ``dev``; the
    inputs go to the ranks by file (``parallel_rank``). Returns each rank's
    results."""
    import pickle
    import tempfile
    from pathlib import Path
    from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT
    from pydsproutines_tpu_torch.parallel import dryrun

    rng = np.random.default_rng(13)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        np.save(out / "x8.npy", receiver_capture())
        cut, rx = planted_sweep(rng, PAR_CUT, PAR_SHIFTS, PAR_STAR, PAR_BIN,
                                "cpu")
        np.savez(out / "caf.npz", cut=cut.numpy(), rx=rx.numpy())
        args, rx_g = group_args(rng)
        (out / "group.pkl").write_bytes(pickle.dumps({
            "params": group_params(GroupXcorrCZT(*args, device="cpu")),
            "rx": rx_g}))
        # (c): a QPSK template planted at PAR_CAP_STAR in noise, as int16
        syms = np.exp(0.5j * np.pi * rng.integers(0, 4, PAR_CUT))
        cap = 0.3 * (rng.standard_normal(PAR_CAP)
                     + 1j * rng.standard_normal(PAR_CAP))
        cap[PAR_CAP_STAR: PAR_CAP_STAR + PAR_CUT] += syms
        raw, scale = int16_capture(cap, 1, AN_INT16_PEAK)
        raw.tofile(out / "capture.bin")
        np.save(out / "template.npy", (syms * scale).astype(np.complex64))
        (out / "spec.json").write_text(json.dumps({
            "device": dev.type, "nch": NCH, "taps": TAPS,
            "fir_taps": FIR_TAPS, "shifts": PAR_SHIFTS, "star": PAR_STAR,
            "bin": PAR_BIN, "g_shifts": G_SHIFTS, "g_star": G_STAR,
            "g_bin": G_BIN, "cap": PAR_CAP, "cap_s0": PAR_CAP_S0,
            "cap_star": PAR_CAP_STAR}))
        dryrun.run_ranks(parallel_rank, PAR_RANKS, (tmp,), "gloo", 600.0)
        return [json.loads((out / f"rank{r}.json").read_text())
                for r in range(PAR_RANKS)]


def parallel_rank(rank: int, world: int, outdir: str) -> None:
    """One rank of (b) and (c), all ranks on the one card (device 0).
    (b): ``sharded_wola`` (#1) and ``sharded_lfilter`` (#5) over the 8M
    capture, 2,097,152 samples a rank; ``sharded_fast_xcorr`` /
    ``sharded_caf_peak`` (#2) with a PAR_CUT-sample cutout over PAR_SHIFTS
    shifts; the group CAF (#8) over the cell's 1024 shifts; each rank's
    block or peak against the single-device call on the card
    (``par_run``). (c): ``read_local_capture`` of this rank's block of the
    int16 capture, ``shard_local_blocks`` on the card, ``sharded_lfilter``
    and ``sharded_caf_peak`` over shifts made global the same way, against
    the single-device calls on the whole capture and the planted peak.
    Writes ``outdir/rank{rank}.json``."""
    import pickle
    from pathlib import Path
    import torch
    from scipy import signal as sps
    from pydsproutines_tpu_torch import parallel as par
    from pydsproutines_tpu_torch.io.binfiles import simple_bin_read
    from pydsproutines_tpu_torch.ops import fast_xcorr, lfilter_fir, wola
    from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT
    from pydsproutines_tpu_torch.ops.hopper import (fft_peak, fused_caf3,
                                                    fused_xcorr, group_caf,
                                                    medfilt, sliding,
                                                    upfirdn, wola_fused)
    from pydsproutines_tpu_torch.parallel._exchange import transport
    from pydsproutines_tpu_torch.parallel.multihost import (
        read_local_capture, shard_local_blocks)

    out = Path(outdir)
    sp = json.loads((out / "spec.json").read_text())
    dev = torch.device(sp["device"], 0 if sp["device"] == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kernels = (wola_fused.wola_fused, fused_xcorr.caf_peak,
               fused_caf3.caf3_peak, fft_peak.window_columns,
               fft_peak.stage2_peak, upfirdn.upfirdn_planes,
               medfilt.medfilt_kernel, group_caf.group_caf,
               sliding.sliding_multiply_normalised)
    mesh = par.make_mesh((world,), ("dsp",), dev.type)
    nch = sp["nch"]
    x8 = torch.from_numpy(np.load(out / "x8.npy")).to(dev)
    h = torch.from_numpy(sps.firwin(sp["taps"], 1.0 / nch).astype(
        np.float32)).to(dev)
    fir = torch.from_numpy(sps.firwin(sp["fir_taps"], 0.25).astype(
        np.float32)).to(dev)
    with np.load(out / "caf.npz") as f:
        cut, rx = (torch.from_numpy(f[k]).to(dev) for k in ("cut", "rx"))
    g = pickle.loads((out / "group.pkl").read_bytes())
    plan = GroupXcorrCZT.from_numpy_params(g["params"], device=dev)
    rx_g = torch.from_numpy(g["rx"]).to(dev)
    sweep, g_sweep = np.arange(sp["shifts"]), np.arange(sp["g_shifts"])
    calls = {
        "sharded_wola": (lambda: par.sharded_wola(h, x8, nch, nch, mesh),
                         lambda: wola(h, x8, nch, nch), par.sharded_wola,
                         None),
        "sharded_lfilter": (lambda: par.sharded_lfilter(fir, x8, mesh),
                            lambda: lfilter_fir(fir, x8), None, None),
        "sharded_fast_xcorr": (
            lambda: par.sharded_fast_xcorr(cut, rx, sweep, mesh),
            lambda: fast_xcorr(cut, rx, True, shifts=sweep),
            par.sharded_fast_xcorr, None),
        "sharded_caf_peak": (
            lambda: par.sharded_caf_peak(cut, rx, sweep, mesh),
            lambda: sweep_peak(*fast_xcorr(cut, rx, True, shifts=sweep),
                               sweep), par.sharded_caf_peak,
            (sp["star"], sp["bin"])),
        "sharded_group_xcorr_czt": (
            lambda: par.sharded_group_xcorr_czt(plan, rx_g, g_sweep,
                                                mesh)[0],
            lambda: plan.xcorr(rx_g, g_sweep)[0], None, None),
        "sharded_group_xcorr_peak": (
            lambda: par.sharded_group_xcorr_peak(plan, rx_g, g_sweep, mesh),
            lambda: grid_peak(plan.xcorr(rx_g, g_sweep)[0], g_sweep), None,
            (sp["g_star"], sp["g_bin"])),
    }
    res = par_run(calls, kernels, mesh, dev)

    # (c) the multi-host flow: this rank's block read from the file
    path = out / "capture.bin"
    tmpl = torch.from_numpy(np.load(out / "template.npy")).to(dev)
    per = sp["shifts"] // world
    s0 = sp["cap_s0"] + rank * per
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    local = read_local_capture(path, sp["cap"], world, rank)
    y = par.sharded_lfilter(fir, shard_local_blocks(local, mesh, "dsp"),
                            mesh)
    whole = torch.from_numpy(simple_bin_read(path)).to(dev)
    peak = par.sharded_caf_peak(
        tmpl, whole, shard_local_blocks(np.arange(s0, s0 + per), mesh,
                                        "dsp"), mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    flow_ms = 1e3 * (time.perf_counter() - t0)
    flow_launches = {k.__name__: k.launches for k in kernels}
    cap_sweep = sp["cap_s0"] + np.arange(sp["shifts"])
    ref = sweep_peak(*fast_xcorr(tmpl, whole, True, shifts=cap_sweep),
                     cap_sweep)
    err = hold_sharded("capture sharded_lfilter", y,
                       lfilter_fir(fir, whole), rank, world, None)
    hold_sharded("capture sharded_caf_peak", peak, ref, rank, world,
                 (sp["cap_star"], 0))
    res["capture"] = {"peak": list(peak), "max_abs_err": err,
                      "route": list(par.sharded_caf_peak.route),
                      "launches": flow_launches, "ms": flow_ms}
    res.update(rank=rank, transport=transport(mesh["dsp"].get_group(), dev),
               backend=str(torch.distributed.get_backend()))
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def transform_scenes(wola_shapes=TF_WOLA, fft_shape=TF_FFT,
                     peaks=TF_PEAK, seed: int = 17) -> dict:
    """The transform phase's inputs as numpy arrays, made from ``seed``:
    "re", "im" float32 planes of the largest WOLA shape's samples (the
    smaller shapes take prefixes), their taps by (N, taps); "x" the
    (rows, n) complex64 rows of each peak shape (the FFT shape's rows are
    the first peak shape's), one tone a row at "bins"."""
    from scipy import signal as sps
    rng = np.random.default_rng(seed)
    samples = max(n * rows for n, _, rows in wola_shapes)
    re, im = (rng.standard_normal(samples, dtype=np.float32)
              for _ in range(2))
    taps = {(n, t): sps.firwin(t, 1.0 / n).astype(np.float32)
            for n, t, _ in wola_shapes}
    rows_of = {}
    for b, n in peaks:
        x = np.empty((b, n), np.complex64)
        x.real = rng.standard_normal((b, n), dtype=np.float32)
        x.imag = rng.standard_normal((b, n), dtype=np.float32)
        bins = ([TF_BIN10 % n] if b == 1 else
                [(TF_BIN0 + r * TF_BIN_STEP) % n for r in range(b)])
        t = np.arange(n)
        for r, k in enumerate(bins):
            x[r] += np.exp(2j * np.pi * ((k * t) % n) / n).astype(
                np.complex64)
        rows_of[(b, n)] = (x, bins)
    check(rows_of[peaks[0]][0].shape == fft_shape,
          "the FFT shape is the first peak shape")
    return {"re": re, "im": im, "taps": taps, "rows": rows_of}


def row_flop(j: int) -> float:
    """Kernel #4's own f32 operations a row of J points (its row plan:
    the twiddle on load, the FFT, |.|^2 and the row peak)."""
    from pydsproutines_tpu_torch.ops.fft import plan_flop, row_plan
    return plan_flop(row_plan(j))


def call_peak_bound(b: int, factors) -> dict:
    """``FourStepFFT.call_peak`` over b rows of prod(factors) points: its
    own count (each leading stage's FFTs at 5 f log2 f a line, their
    twiddles, kernel #4's row plan) or one FFT and |.|^2 a row; the rows
    read once, a float32 peak and an int64 bin written."""
    n, j = math.prod(factors), factors[-1]
    lead = (sum(n // f * fft_flop(f) for f in factors[:-1])
            + 6.0 * n * (len(factors) - 2))
    return bound(b * (lead + n // j * row_flop(j)),
                 b * (fft_flop(n) + 3.0 * n), 8.0 * b * n + 12.0 * b)


def transform(dev, kernels, wola_shapes=TF_WOLA, fft_shape=TF_FFT,
              peaks=TF_PEAK, reps: int = 3) -> dict:
    """The transform phase. Kernel checks (launches not counted): the
    plane-I/O instance of #1 (``wola_fused_planes``) against the complex
    instance on the same samples (equal) and against its plain version, at
    each WOLA shape; kernel #4 on ``call_peak``'s stage-2 input against its
    twin at each peak shape. Then the path through the public entry points,
    every count at 0 just before it and read just after:
    ``wola_planes_flat`` and ``wola_planes`` (its routed core
    ``_wola_planes_impl``) at each WOLA shape, ``fft``, ``ifft``, a plan's
    ``__call__`` and ``call_permuted`` at ``fft_shape``, ``call_peak`` at
    each peak shape and ``call_peak_planes`` at the last; launches as the
    code predicts (the plane instance twice a shape, #4 once a peak call,
    every other kernel 0; all 0 on the CPU, where the twins run), routes
    the kernel's. Last the gates against complex128 CPU FFTs and, on the
    card, CUDA-event medians of ``reps`` after a warm-up."""
    import torch
    from pydsproutines_tpu_torch.ops.fft import fft, get_fft_plan, ifft
    from pydsproutines_tpu_torch.ops.hopper.fft_peak import (
        leading_stages_plain, stage2_peak, stage2_peak_plain)
    from pydsproutines_tpu_torch.ops.hopper.wola_fused import (
        wola_fused, wola_fused_planes, wola_plain, wola_planes_plain)
    from pydsproutines_tpu_torch.ops.wola import (_wola_planes_impl,
                                                  wola_planes_flat)
    from pydsproutines_tpu_torch.utils.timing import median_ms
    on_card = dev.type == "cuda"
    sc = transform_scenes(wola_shapes, fft_shape, peaks)
    re_all = torch.from_numpy(sc["re"]).to(dev)
    im_all = torch.from_numpy(sc["im"]).to(dev)
    planes = {}
    for n, t, rows in wola_shapes:
        h = torch.from_numpy(sc["taps"][(n, t)]).to(dev)
        planes[(n, t, rows)] = (h, re_all[: rows * n], im_all[: rows * n])
    xs = {k: (torch.from_numpy(x).to(dev), bins)
          for k, (x, bins) in sc["rows"].items()}
    plans = {k: get_fft_plan(k[1]) for k in peaks}
    out = {"wola": [], "peaks": [], "card": on_card}

    # kernel checks, counts not read ---------------------------------------
    for (n, t, rows), (h, re, im) in planes.items():
        pr, pi = wola_fused_planes(h, re, im, n)
        xc = torch.complex(re, im)
        c = wola_fused(h, xc, n)
        ref = wola_plain(h, xc, n, n)
        got = torch.complex(pr, pi)
        check(pr.shape == (rows, n) and bool(torch.isfinite(got).all()),
              f"WOLA planes {rows}x{n}: shape or finiteness")
        check(torch.equal(pr, c.real) and torch.equal(pi, c.imag),
              f"WOLA planes {rows}x{n}: the plane instance differs from the "
              f"complex instance by {float((got - c).abs().max()):.3e}")
        err = rel_err(got, ref)
        check(err < WOLA_RTOL, f"WOLA planes {rows}x{n} vs plain: {err:.3e}")
        rec = {"shape": f"{rows}x{n} ch, {t} taps", "rows": rows, "n": n,
               "taps": t, "rel_err": err,
               "max_abs_err": float((got - ref).abs().max()),
               "vs_complex_max_abs": float((got - c).abs().max()),
               **wola_bound(rows, n, t)}
        if on_card:
            def split():
                o = wola_fused(h, torch.complex(re, im), n)
                return o.real.contiguous(), o.imag.contiguous()
            rec.update(
                ms=median_ms(lambda: wola_fused_planes(h, re, im, n),
                             reps=reps),
                complex_ms=median_ms(lambda: wola_fused(h, xc, n),
                                     reps=reps),
                interleave_split_ms=median_ms(split, reps=reps),
                plain_ms=median_ms(
                    lambda: wola_planes_plain(h, re, im, n), reps=reps))
        out["wola"].append(rec)
        del xc, c, ref, got
    for (b, n) in peaks:
        plan, (x, bins) = plans[(b, n)], xs[(b, n)]
        check(plan.peak_viable(), f"call_peak plan {plan.factors}")
        f1 = plan._leading_stages(x)
        tw = plan._device_table("peak", dev)
        km, kb = stage2_peak(f1, tw, tuple(plan.factors))
        pm, pb = stage2_peak_plain(f1, tw, tuple(plan.factors))
        s2_err = float(((km - pm).abs() / pm).max())
        check(kb.tolist() == pb.tolist() == bins and s2_err < CAF_RTOL,
              f"kernel #4 at {b} x {n}: bins {kb.tolist()} / {pb.tolist()} "
              f"vs {bins}, rel err {s2_err:.3e}")
        rec = {"shape": f"{b} x {n}", "rows": b, "n": n,
               "factors": list(plan.factors),
               "stage2_rows": list(f1.shape),
               "stage2_max_abs_err": float((km - pm).abs().max()),
               "stage2_rel_err": s2_err, **call_peak_bound(b, plan.factors)}
        nrows, j = f1.shape[0] * f1.shape[1], plan.factors[-1]
        rec["stage2_bound"] = bound(nrows * row_flop(j),
                                    nrows * (9.0 * j + fft_flop(j)),
                                    8.0 * (f1.numel() + tw.numel()) + 12 * b)
        if on_card:
            rec.update(
                stage2_ms=median_ms(lambda: stage2_peak(
                    f1, tw, tuple(plan.factors)), reps=reps),
                plain_ms=median_ms(lambda: stage2_peak_plain(
                    f1, tw, tuple(plan.factors)), reps=reps),
                ms=median_ms(lambda: plan.call_peak(x), reps=reps),
                library_ms=median_ms(lambda: torch.fft.fft(
                    x).abs().square().max(dim=-1), reps=reps))
        del f1
        # the whole call against its twin: einsum leading stages (full
        # f32), torch.fft last stage
        cm, cb = plan.call_peak(x)
        tm, tb = stage2_peak_plain(leading_stages_plain(x, plan.factors), tw,
                                   tuple(plan.factors))
        rec["twin_rel_err"] = float(((cm - tm).abs() / tm).max())
        check(cb.tolist() == tb.tolist() == bins
              and rec["twin_rel_err"] < CAF_RTOL,
              f"call_peak at {b} x {n} vs its twin: bins {cb.tolist()} / "
              f"{tb.tolist()}, rel err {rec['twin_rel_err']:.3e}")
        out["peaks"].append(rec)

    # the path, through the public entry points, counts at 0 just before ----
    xf, _ = xs[fft_shape]
    plan_f = get_fft_plan(fft_shape[1])
    x_last = xs[peaks[-1]][0]
    xr, xi = x_last.real.contiguous(), x_last.imag.contiguous()
    if on_card:
        torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    wola_out, routes = {}, {}
    for key, (h, re, im) in planes.items():
        flat = wola_planes_flat(h, re, im, key[0])
        two, routes[key] = _wola_planes_impl(h, re, im, key[0])
        wola_out[key] = (flat, two)
    spec = fft(xf)
    back = ifft(spec)
    inv = ifft(xf)
    called = plan_f(xf)
    permuted = plan_f.call_permuted(xf)
    peak_out = {k: plans[k].call_peak(xs[k][0]) for k in peaks}
    planes_out = plans[peaks[-1]].call_peak_planes(xr, xi)
    if on_card:
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    want = {k.__name__: 0 for k in kernels}
    if on_card:
        want["wola_fused_planes"] = 2 * len(wola_shapes)
        want["stage2_peak"] = len(peaks) + 1
    check(launches == want, f"transform launches {launches}, expected {want}")
    want_route = "fused-planes-hopper" if on_card else "plain"
    check(all(r[0] == want_route for r in routes.values()),
          f"transform WOLA routes {routes}")
    out["launches"], out["routes"] = launches, {
        f"{k[2]}x{k[0]}": list(r) for k, r in routes.items()}

    # the gates ---------------------------------------------------------------
    for key, (flat, two) in wola_out.items():
        h, re, im = planes[key]
        ref = wola_fused_planes(h, re, im, key[0])
        check(all(f.shape == (key[2] * key[0],) for f in flat)
              and all(torch.equal(f, w.reshape(-1)) and torch.equal(w, r)
                      for f, w, r in zip(flat, two, ref)),
              f"wola_planes(_flat) {key}: outputs differ from the kernel "
              "check's")
    x128 = xf.cpu().to(torch.complex128)
    spec128 = torch.fft.fft(x128)
    out["fft_rel_err"] = float((spec.cpu() - spec128).abs().max()
                               / spec128.abs().max())
    ref_inv = torch.fft.ifft(x128)
    out["ifft_rel_err"] = float((inv.cpu() - ref_inv).abs().max()
                                / ref_inv.abs().max())
    out["roundtrip_rel_err"] = float((back - xf).abs().max()
                                     / xf.abs().max())
    check(out["fft_rel_err"] < TF_RTOL and out["ifft_rel_err"] < TF_RTOL
          and out["roundtrip_rel_err"] < TF_RTOL,
          f"fft / ifft / round trip vs complex128: {out['fft_rel_err']:.3e}"
          f" / {out['ifft_rel_err']:.3e} / {out['roundtrip_rel_err']:.3e}")
    perm = torch.from_numpy(plan_f.permutation).long().to(dev)
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.shape[0], device=dev)
    check(torch.equal(called, spec) and torch.equal(permuted[:, inverse],
                                                    spec),
          "__call__ / call_permuted differ from fft")
    del ref_inv, back, inv, called, permuted
    for (key, (pk, pb)), rec in zip(peak_out.items(), out["peaks"]):
        x, bins = xs[key]
        mag = (spec128 if key == fft_shape else torch.fft.fft(
            x.cpu().to(torch.complex128))).abs() ** 2
        rm, rb = mag.max(dim=-1)
        rec["peak_rel_err"] = float(((pk.cpu().double() - rm).abs()
                                     / rm).max())
        check(pk.shape == pb.shape == (key[0],)
              and pb.tolist() == rb.tolist() == bins
              and rec["peak_rel_err"] < CAF_RTOL,
              f"call_peak at {key[0]} x {key[1]}: bins {pb.tolist()} vs "
              f"complex128 {rb.tolist()}, planted {bins}; peak rel err "
              f"{rec['peak_rel_err']:.3e}")
        del mag
    check(torch.equal(planes_out[0], peak_out[peaks[-1]][0])
          and torch.equal(planes_out[1], peak_out[peaks[-1]][1]),
          "call_peak_planes differs from call_peak")

    if on_card:
        h, re, im = planes[wola_shapes[0]]
        n0 = wola_shapes[0][0]
        out["ms"] = {
            "wola_planes_flat": median_ms(lambda: wola_planes_flat(
                h, re, im, n0), reps=reps),
            "fft": median_ms(lambda: fft(xf), reps=reps),
            "ifft": median_ms(lambda: ifft(xf), reps=reps),
            "__call__": median_ms(lambda: plan_f(xf), reps=reps),
            "call_permuted": median_ms(lambda: plan_f.call_permuted(xf),
                                       reps=reps),
            "call_peak_planes": median_ms(lambda: plans[peaks[-1]]
                                          .call_peak_planes(xr, xi),
                                          reps=reps)}
    return out


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
                                                            medfilt_plain,
                                                            medfilt_plan)
    from pydsproutines_tpu_torch.ops.hopper.sliding import (
        FLAG_RATIO, _sliding_cuda, select_sliding_path,
        sliding_multiply_normalised, sliding_multiply_normalised_reference,
        sliding_plain, sliding_plan)
    from pydsproutines_tpu_torch.ops.hopper.upfirdn import (
        plan_text as upfirdn_plan_text, upfirdn_plan, upfirdn_planes,
        upfirdn_planes_plain)
    from pydsproutines_tpu_torch.ops.hopper.wola_fused import (
        plan_text as wola_plan_text, wola_fused, wola_fused_planes,
        wola_plain, wola_plan)
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
    w_plan = wola_plan(NCH, TAPS // NCH)
    print(f"wola {ROWS}x{NCH} ch, {TAPS} taps: kernel {wola_ms:.4f} ms, "
          f"plain {wola_plain_ms:.4f} ms, rel err {wola_err:.3e} "
          f"({select_wola_path(NCH, NCH, dev)[1]}) {tag}")
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
            "kernel_plan": wola_plan_text(wola_plan(nd, taps_d // nd)),
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
    # cuDNN's transposed convolution, TF32 off (set above): the yardstick
    fir_lib = upfirdn_library_call((fre, fim), h32, UP, DOWN, n_fir_out)
    lib_err = rel_err(fir_lib(), ref_f)
    check(lib_err < 1e-4, f"conv_transpose1d yardstick rel err {lib_err:.3e}")
    fir_lib_ms = median_ms(fir_lib, reps=5)
    f_plan = upfirdn_plan(h64.size, UP, DOWN, 4, 2)   # two planes
    # the public entry point: host tap key and combination (cached) + copy
    # of the combined taps to the card + the kernel
    fir_chain_ms = median_ms(lambda: fir_upfirdn_planes_flat(
        h_fir, h_rs, fre, fim, UP, DOWN), reps=5)
    print(f"upfirdn {N_FIR} complex, {h64.size} taps, {UP}/{DOWN}: kernel "
          f"{fir_ms:.4f} ms ({upfirdn_plan_text(f_plan)}), plain "
          f"{fir_plain_ms:.4f} ms, cuDNN conv_transpose1d {fir_lib_ms:.4f} "
          f"ms, rel err {fir_err:.3e}; vs float64 scipy at {N_SMALL} within "
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
    med_plan = medfilt_plan(MED_K)
    med_route = select_medfilt_path(1, torch.float32, dev, MED_K)
    check(med_plan["route"] == "tile" and "tile-shared" in med_route[1],
          f"medfilt route {med_route}")
    # bound: bytes, or the fewest compares of a running median (a sorted
    # window's insert and delete, 2 ceil(log2 k) an output) at the int32
    # issue rate; the kernel's own count is its plan's
    m_bound = bound(med_plan["compares"] * N_MED,
                    2 * math.ceil(math.log2(MED_K)) * N_MED, 8 * N_MED,
                    INT32_OPS)
    print(f"medfilt {N_MED} x k={MED_K}: kernel {med_ms:.4f} ms ({med_route[0]}"
          f": {med_route[1]}; {med_plan['compares']:.0f} key compares an "
          f"output, {m_bound['algorithm_flop']:.4g} in all, vs "
          f"{m_bound['bound_flop']:.4g} for a running median), plain "
          f"{med_plain_ms:.4f} ms, bound {m_bound['bound_ms']:.4f} ms "
          f"({m_bound['bound_by']}), bit-equal to the twin and (at {N_SMALL}) "
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
    x_sl, t_sl = sliding_scene()
    xs_d, ts_d = torch.from_numpy(x_sl).to(dev), torch.from_numpy(t_sl).to(dev)
    sl_route = select_sliding_path(N_SL, T_SL, L_SL, torch.complex64, dev)
    check(sl_route[0] == "sliding-ols-hopper", f"sliding route {sl_route}")
    got_s = sliding_multiply_normalised(xs_d, ts_d)
    sl_flagged = int(sliding_multiply_normalised.flagged)
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
    check(sl_flagged == 0, f"stationary scene: {sl_flagged} segments "
                           f"re-checked")
    # the burst-edge scene: the segments whose quiet windows sit beside the
    # burst's edges are re-checked, computed by the masked direct launch
    xb, tb = (torch.from_numpy(a).to(dev) for a in sliding_burst_scene())
    got_b = sliding_multiply_normalised(xb, tb)
    slb_flagged = int(sliding_multiply_normalised.flagged)
    ref_b = sliding_plain(xb, tb)
    torch.cuda.synchronize()
    slb_abs = float((got_b - ref_b).abs().max())
    bi, bs = np.unravel_index(int(torch.argmax(got_b)), got_b.shape)
    check(got_b.shape == (T_SL, ns_sl) and bool(torch.isfinite(got_b).all())
          and slb_abs < SLIDING_RTOL and (bi, bs) == (SL_T, SLB_AT + SLB_OFF)
          and slb_flagged >= 1
          and float(got_b[:, SLB_ZEROS: SLB_ZEROS + SLB_ZLEN - L_SL + 1]
                    .abs().max()) == 0.0,
          f"sliding burst-edge scene: QF^2 max|d| {slb_abs:.3e}, peak at "
          f"{(bi, bs)}, {slb_flagged} segments re-checked")
    slb_ms = median_ms(lambda: _sliding_cuda(xb, tb), reps=5)
    del got_b, ref_b, xb, tb
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
    # (the kernel's own count: its overlap-save plan's, ops/hopper/sliding)
    sl_plan = sliding_plan(N_SL, T_SL, L_SL)
    sl_bound = bound(sl_plan["ols_flop"],
                     ols_flop(ns_sl, L_SL, T_SL) + 4.0 * N_SL
                     + 3.0 * T_SL * ns_sl,
                     8 * N_SL + 8 * T_SL * L_SL + 4 * T_SL * ns_sl)
    print(f"sliding {N_SL} x {T_SL} templates of {L_SL}: kernel {sl_ms:.4f} "
          f"ms ({sl_route[0]}: {sl_route[1]}; {sl_flagged} segments "
          f"re-checked), plain {sl_plain_ms:.4f} ms, cuDNN conv1d "
          f"{sl_lib_ms:.4f} ms, bound {sl_bound['bound_ms']:.4f} ms "
          f"({sl_bound['bound_by']}; {sl_bound['algorithm_flop']:.4g} f32 "
          f"operations its plan's, {sl_bound['bound_flop']:.4g} the fewest); "
          f"rel err {sl_err:.3e}; vs numpy at {N_SMALL} within {SLIDING_RTOL};"
          f" burst-edge scene {slb_ms:.4f} ms, QF^2 max|d| {slb_abs:.3e}, "
          f"{slb_flagged} segments re-checked by the direct product "
          f"(energy ratio > {FLAG_RATIO:g}), peak at ({SL_T}, "
          f"{SLB_AT + SLB_OFF}) {tag}")
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
    rcv_ms = 1e3 * timer.evt("receiver run")
    qf2, bins = fast_xcorr(big["cut"], big["rx"], freqsearch=True,
                           shifts=torch.arange(SHIFTS_BIG, device=dev))
    i_big = int(torch.argmax(qf2))
    xcorr_ms = 1e3 * timer.evt("fast_xcorr 1M x 128")
    q3, b3 = fast_xcorr(cut3, rx3, True, shifts=offs3)
    i3 = int(torch.argmax(q3))
    caf3_path_ms = 1e3 * timer.evt("fast_xcorr 10M x 128")
    q4, b4 = fast_xcorr(cut4, rx4, True, shifts=offs4)
    i4 = int(torch.argmax(q4))
    peak_path_ms = 1e3 * timer.evt("fast_xcorr 1M shift list")
    m_re, m_im = fir_upfirdn_planes_flat(h_fir, h_rs, fre, fim, UP, DOWN)
    fir_path_ms = 1e3 * timer.evt("fir_upfirdn_planes_flat 4M")
    noise, req, filtered, e_edges = energy_detection(xm, MED_K)
    e_count = int(e_edges.count)
    energy_ms = 1e3 * timer.evt("energy_detection 4M")
    before = {k.__name__: k.launches for k in kernels}
    det = detection_chain(chan, tmpl_b, rx_b)
    det_path_ms = 1e3 * timer.evt("detection chain")
    launches = {k.__name__: k.launches for k in kernels}
    det_launches = {k: launches[k] - before[k] for k in launches}
    # this slice's paths, each with every count at 0 just before it
    every = kernels + (group_caf, sliding_multiply_normalised,
                       wola_fused_planes)
    for kernel in every:
        kernel.launches = 0
    timer.evt("counts reset")
    qg, fg = gx.xcorr(rx_g, offs_g)
    gi_, gj_ = np.unravel_index(int(torch.argmax(qg)), qg.shape)
    group_path_ms = 1e3 * timer.evt("GroupXcorrCZT.xcorr")
    group_launches = {k.__name__: k.launches for k in every}
    for kernel in every:
        kernel.launches = 0
    timer.evt("counts reset")
    q_sl = sliding_multiply_normalised(xs_d, ts_d)
    sti, ssi = np.unravel_index(int(torch.argmax(q_sl)), q_sl.shape)
    sliding_path_ms = 1e3 * timer.evt("sliding_multiply_normalised")
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
    print(f"sliding_multiply_normalised route: {sl_route[0]} ({sl_route[1]});"
          f" medfilt route in the detection chain: {med_route[0]}")
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

    # this slice's path: the demodulation layer, counts at 0 before it
    demod = demod_layer(dev, tag, every)
    print("demod layer:", json.dumps(demod))

    # this slice's path: TDOA/FDOA geolocation, counts at 0 before it
    geo, geo_caf = geolocation(dev, every)
    print(f"geolocation scene: 4 captures of {GEO_CAPTURE} samples "
          f"(float64 synthesis, complex64 out) {geo['scene_ms']:.4f} ms {tag}")
    print(f"geolocation pipeline: {geo['blocks_per_pair']} blocks of "
          f"{GEO_BLOCK} shifts at n={GEO_BURST} a pair, route "
          f"{geo['route']}, caf_peak launches {geo['launches']['caf_peak']} "
          f"for 3 pairs ({geo['launches_per_block']} a block); "
          f"{geo['pipeline_ms_per_pair']:.4f} ms a pair "
          f"({geo['gsample_shift_per_s']:.3f} Gsample-shift/s) {tag}")
    print(f"geolocation fine stage (czt_xcorr + fine_freq_time_search), 3 "
          f"pairs: {geo['fine_ms_3_pairs']:.4f} ms {tag}")
    print(f"geolocation grid: TDFD over {GEO_GRID}x{GEO_GRID} points, 3 "
          f"pairs: {geo['grid_ms']:.4f} ms ({geo['gpoint_pair_per_s']:.3f} "
          f"Gpoint-pair/s); located {geo['miss_m']:.1f} m from the emitter "
          f"(allowed {geo['allowed_m']:.1f} m = {geo['allowed_cells']:.2f} "
          f"cells: the 95% CRB ellipse's semi-major axis "
          f"{geo['a95_m']:.1f} m plus sqrt(cond {geo['crb_cond']:.1f}) "
          f"half diagonals of a cell) {tag}")
    print(f"geolocation host CRB + 95% ellipse: {geo['crb_host_ms']:.4f} ms; "
          f"propagate_signal_exact N={GEO_EXACT_N}: "
          f"{geo['propagate_exact_ms']:.4f} ms, rel err vs CPU "
          f"{geo['exact_rel_err']:.3e} {tag}")
    print(f"caf_peak at the pipeline's block (n={GEO_BURST} x {GEO_BLOCK}): "
          f"kernel {geo_caf['ms']:.4f} ms, plain {geo_caf['plain_ms']:.4f} "
          f"ms, bound {geo_caf['bound_ms']:.4f} ms ({geo_caf['bound_by']}) "
          f"{tag}")
    print("geolocation:", json.dumps(geo))

    # this slice's path: capture to analysis, counts at 0 before it
    ana = analysis(dev, every)
    a_ms = ana["ms"]
    print(f"analysis capture: {AN_FILES} int16 files of {AN_FILE_SAMPS} "
          f"samples, read by the {ana['loader']} loader and channelised a "
          f"frame at a time (#1): {a_ms['read_channelise']:.4f} ms, vs one "
          f"channelisation of the whole capture rel err "
          f"{ana['stream_rel_err']:.3e}; launches on the path "
          f"{ana['launches']} (#5 by music_xcorr_device "
          f"{ana['music_launches']}, the rest by the matrix profile) {tag}")
    print(f"analysis steps (ms): min-max {a_ms['minmax_0']:.4f} / "
          f"{a_ms['minmax_1']:.4f} (magnitude / phase kept), fast_xcorr "
          f"{a_ms['fast_xcorr']:.4f}, cancel {a_ms['cancel']:.4f}, MUSIC "
          f"{a_ms['music']:.4f}, PSK order {a_ms['psk_order_4']:.4f} / "
          f"{a_ms['psk_order_8']:.4f}, CM offset "
          f"{a_ms['offset_via_cm']:.4f}, masked rows "
          f"{a_ms['masked_only']:.4f} / {a_ms['masked_two_banks']:.4f} / "
          f"{a_ms['masked_gathered']:.4f}; the whole path "
          f"{a_ms['path']:.2f} ms {tag}")
    for name, p in ana["profile"].items():
        print(f"analysis profile of {name}: {p['wall_ms']:.2f} ms wall, "
              f"device busy {p['busy_ms']:.2f} ms ({p['busy_share']:.3f}) in "
              f"{p['device_events']} device events; heaviest "
              + "; ".join(f"{k} {t:.2f} ms x{n}" for k, t, n in p["top"])
              + f" {tag}")
    print(f"analysis matrix profile n={AN_MP_N} w={AN_MP_W}, "
          f"{AN_MP_N - AN_MP_W} diagonals: {a_ms['matrix_profile']:.4f} ms "
          f"({ana['mp_gpairs_per_s']:.3f} Gpairs/s; output "
          f"{ana['mp_output_bytes'] / 1e9:.3f} GB, bytes bound "
          f"{ana['mp_bytes_bound_ms']:.4f} ms), with chains "
          f"{a_ms['matrix_profile_chains']:.4f} ms; vs float64 "
          f"{ana['mp_err']:.3e} {tag}")
    print("analysis:", json.dumps(ana))

    # this slice's path: the distribution layer, counts at 0 before each part
    par_one = parallel_one_rank(dev, every)
    for name in par_one["ms"]:
        print(f"parallel (a) {name}, 1 {par_one['backend']} rank: "
              f"{par_one['ms'][name]:.4f} ms, single-device "
              f"{par_one['single_ms'][name]:.4f} ms (the wrapper "
              f"{par_one['overhead_ms'][name]:+.4f} ms), max|d| "
              f"{par_one['max_abs_err'][name]:.3e}, route "
              f"{par_one['routes'].get(name, ['-'])[0]} {tag}")
    print(f"parallel (a) launches {par_one['launches']}; exchanges "
          f"{par_one['transport']} (world 1: no halo crosses a rank)")
    par_four = parallel_ranks(dev)
    for r in par_four:
        check(all(r["launches"][k] > 0 for k in (
            "wola_fused", "upfirdn_planes", "caf_peak", "group_caf"))
            and r["capture"]["launches"]["upfirdn_planes"] > 0
            and r["capture"]["launches"]["caf_peak"] > 0,
            f"rank {r['rank']} skipped a kernel: {r['launches']}, "
            f"{r['capture']['launches']}")
        check(r["capture"]["peak"] == par_four[0]["capture"]["peak"],
              "the ranks' capture peaks differ")
        print(f"parallel (b) rank {r['rank']} of {PAR_RANKS} ranks sharing "
              f"one card ({r['backend']}, exchanges {r['transport']}): "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in r["ms"].items())
              + f"; launches {r['launches']}; max|d| "
              f"{max(r['max_abs_err'].values()):.3e} {tag}")
        print(f"parallel (c) rank {r['rank']}: read_local_capture -> "
              f"shard_local_blocks -> sharded_lfilter -> sharded_caf_peak "
              f"{r['capture']['ms']:.2f} ms (host clock, 4 ranks sharing "
              f"one card), peak {r['capture']['peak']}, launches "
              f"{r['capture']['launches']} {tag}")
    parallel = {"card": card, "one_rank": par_one, "four_ranks": par_four}

    # this slice's path: the transform API and WOLA's plane entry points,
    # counts at 0 before it
    tf = transform(dev, every)
    for w in tf["wola"]:
        print(f"transform wola_planes {w['shape']}: plane instance "
              f"{w['ms']:.4f} ms, complex instance {w['complex_ms']:.4f} ms,"
              f" interleave -> kernel -> split {w['interleave_split_ms']:.4f}"
              f" ms, plain {w['plain_ms']:.4f} ms, bound {w['bound_ms']:.4f}"
              f" ms ({w['bound_by']}); equal to the complex instance (max|d| "
              f"{w['vs_complex_max_abs']:.1e}), rel err vs plain "
              f"{w['rel_err']:.3e} {tag}")
    for pk in tf["peaks"]:
        print(f"transform call_peak {pk['shape']} (plan {pk['factors']}, "
              f"kernel #4 on {pk['stage2_rows']}): {pk['ms']:.4f} ms, "
              f"torch.fft -> |.|^2 -> max {pk['library_ms']:.4f} ms, bound "
              f"{pk['bound_ms']:.4f} ms ({pk['bound_by']}); kernel #4 alone "
              f"{pk['stage2_ms']:.4f} ms, its twin {pk['plain_ms']:.4f} ms, "
              f"bound {pk['stage2_bound']['bound_ms']:.4f} ms "
              f"({pk['stage2_bound']['bound_by']}); bins equal to complex128"
              f", peak rel err {pk['peak_rel_err']:.3e} {tag}")
    print(f"transform {TF_FFT[0]} x {TF_FFT[1]}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in tf["ms"].items())
          + f"; fft / ifft vs complex128 {tf['fft_rel_err']:.3e} / "
          f"{tf['ifft_rel_err']:.3e}, round trip "
          f"{tf['roundtrip_rel_err']:.3e}; launches {tf['launches']}, "
          f"routes {sorted({r[0] for r in tf['routes'].values()})} {tag}")

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
         "library": "none", "kernel_route": w_plan["route"],
         "kernel_plan": wola_plan_text(w_plan),
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
                            **plan_keys(rx_caf)},
         "geolocation_shape": {**geo_caf,
                               "library_ms": geo_caf["plain_ms"]}},
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
                   "column_pass_launches": launches["window_columns"]},
         "transform_launches": tf["launches"]["stage2_peak"],
         "call_peak": tf["peaks"]},
        {"name": "wola_fused_planes", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/wola_fused.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/wola_fused.py:99",
         "shape": tf["wola"][0]["shape"],
         "launches": tf["launches"]["wola_fused_planes"],
         "max_abs_err": tf["wola"][0]["max_abs_err"],
         "ms": tf["wola"][0]["ms"], "plain_ms": tf["wola"][0]["plain_ms"],
         **costs({k: tf["wola"][0][k] for k in (
             "bound_ms", "bound_by", "bound_flop", "algorithm_flop",
             "bound_bytes")}, None),
         "library": "none", "io": "float32 quadrature planes in and out",
         "complex_instance_ms": tf["wola"][0]["complex_ms"],
         "interleave_split_ms": tf["wola"][0]["interleave_split_ms"],
         "shapes": tf["wola"]},
        {"name": "upfirdn_planes", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/upfirdn.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/upfirdn.py:109",
         "also_replaces": "pydsproutines_tpu/ops/pallas/upfirdn.py:209",
         "shape": f"2 planes x {N_FIR}, {h64.size} taps, up {UP} down {DOWN}",
         "launches": launches["upfirdn_planes"], "max_abs_err": fir_abs,
         "ms": fir_ms, "plain_ms": fir_plain_ms,
         **costs(f_bound, fir_lib_ms),
         "library": "cuDNN conv_transpose1d(stride=up)[..., ::down], TF32 "
                    "off",
         "kernel_route": f_plan["route"],
         "kernel_plan": upfirdn_plan_text(f_plan)},
        {"name": "medfilt_kernel", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/medfilt.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/medfilt.py:32",
         "shape": f"{N_MED} float32, k={MED_K}",
         "launches": launches["medfilt_kernel"], "max_abs_err": med_abs,
         "ms": med_ms, "plain_ms": med_plain_ms,
         **costs(m_bound, med_plain_ms),
         "library": "unfold + torch.median (the twin)",
         "kernel_route": med_plan["route"], "tile_c": med_plan["c"],
         "compares_per_output": med_plan["compares"]},
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
         **costs(sl_bound, sl_lib_ms),
         "library": "cuDNN conv1d of the planes, TF32 off",
         "kernel_route": sl_route[0], "nfft": sl_plan["nfft"],
         "segments": sl_plan["segments"],
         "rechecked_segments": sl_flagged,
         "burst_edge": {"ms": slb_ms, "max_abs_err": slb_abs,
                        "rechecked_segments": slb_flagged}},
    ], "receiver_step_ms": step_ms, "detection_chain_ms": det_ms,
        "resampling_chain_ms": fir_chain_ms, "group_xcorr_ms": gx_ms,
        "group_xcorr_gsample_shift_per_s": gx_rate,
        "sliding_ms": sl_path_ms,
        "geolocation": {k: geo[k] for k in (
            "scene_ms", "pipeline_ms_per_pair", "gsample_shift_per_s",
            "fine_ms_3_pairs", "grid_ms", "gpoint_pair_per_s",
            "crb_host_ms", "propagate_exact_ms")},
        "transform": {k: tf[k] for k in (
            "ms", "fft_rel_err", "ifft_rel_err", "roundtrip_rel_err",
            "routes")},
        "analysis": {**ana["ms"], "busy_share": ana["busy_share"],
                     "mp_gpairs_per_s": ana["mp_gpairs_per_s"],
                     "launches": ana["launches"]}, "parallel": parallel,
        "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
