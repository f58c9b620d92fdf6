// Hopper WOLA channelizer for N == Dec: polyphase fold + N-point IDFT in one
// kernel, one read of the input and one write of the output.
//
// Replaces the TPU kernels pydsproutines_tpu/ops/pallas/wola_fused.py:_kernel
// (N = 64, pair-row layout) and :_kernel_direct (N = 128, 256). Contract, as
// ops/wola.wola for N == Dec:
//
//   out[r, k]     = sum_a dft_in[r, a] * exp(+2*pi*i*a*k/N)
//   dft_in[r, a]  = sum_b x[r*N - b*N - a] * h[b*N + a],   x = 0 before 0,
//
// for r in [0, rows), a, k in [0, N), b in [0, B), B = len(h)/N. With xq = x
// viewed as (rows, N), x[(r-b)N - a] is xq[r-b, 0] for a == 0 and
// xq[r-b-1, N-a] for a >= 1: the fold is a B-tap FIR down each column of xq.
//
// Design (wola_fold_fft). A block owns a chunk of rc rows (rc = 8 rows a
// run times max(1, 256/N) runs, so rc*N ~ 2048 points):
//
//   1. fold in registers: a thread owns one column a and a run of WM = 8
//      consecutive output rows; it holds KB taps of its column and WM
//      accumulators in registers and streams its column of xq down the WM +
//      KB - 1 rows the run reaches, so each loaded value feeds up to KB
//      accumulators (B > KB: the taps in chunks of KB, zero past B).
//      Consecutive threads take consecutive columns, so a warp's loads are
//      one contiguous segment of a row. The run's result goes, conjugated,
//      to the line's digit-reversed slot in shared memory (line stride N|1);
//   2. IDFT by fft_smem.cuh's fft_lines: one N-point line FFT a row, radices
//      of ops/fft.radix_plan, twiddles from the host's f32 table of float64
//      phases; the inverse by conjugation, N*IDFT(d) = conj(FFT(conj(d))),
//      so no scaling;
//   3. the rows, conjugated back, stored coalesced; rows past `rows` (the
//      last chunk's tail) are neither read nor stored.
//
// Two instances, one per I/O layout (float2 or float samples): complex64 in
// and out (pdsp_wola_fused, behind ops/wola.wola), or the TPU kernel's float32
// quadrature planes in and out (pdsp_wola_fused_planes, behind
// ops/wola.wola_planes / wola_planes_flat), so that a plane caller pays no
// interleave before the kernel and no split after it. Only the loads in
// step 1 and the stores in step 3 differ; the arithmetic is one template
// body, so the two give bit-identical outputs on the same samples.
//
// A run re-reads the B - 1 rows of history before it; they come from L1/L2
// (the neighbouring runs of the block read them), so device memory sees each
// input row about once. Indices into device memory are 64-bit.
//
// What bounds it on the H100: bytes. 16 bytes a sample move in either
// layout (8 in, 8 out: 134 MB at 8M samples, 40 us at 3.35 TB/s). At N = 64, B = 32 the fold is
// 1.07 GFLOP (16 us at the f32 peak, ~0.15 L1 loads per complex-by-real
// FMA pair) and the FFT ~0.25 GFLOP; the shared-memory tile of a chunk is
// ~16 KB, so several blocks share an SM at every N the port runs.
//
// wola_direct_kernel is this kernel's first version (a direct N-point IDFT
// sum from shared memory, 4N FMAs an output), kept whole for
// scripts/exp_wola.py's same-call comparison; the port does not call it.

#include "fft_smem.cuh"

namespace {

// Blocks an SM the register budget is cut for: 2 ran faster than 1, 3 and
// 4 at N = 64 on the H100 (3 and 4 spill the 32-tap instance;
// scripts/exp_wola.py --variants builds others).
#ifndef WOLA_MIN_BLOCKS
#define WOLA_MIN_BLOCKS 2
#endif

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int WM = 8;                 // output rows of a thread's run

// The taps of column a, chunk c (KB of them, zero past B), into hk.
template <int KB>
__device__ __forceinline__ void load_taps(float (&hk)[KB],
                                          const float* __restrict__ taps,
                                          int n, int nb, int a, int c) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const int b = c * KB + kb;
    hk[kb] = b < nb ? __ldg(taps + (size_t)b * n + a) : 0.f;
  }
}

// The kernel's two I/O layouts, chosen by the sample type T: where sample i
// of xq is read and output i is written. The fold, the FFT and their
// arithmetic are the kernel's own, so both instances give the same bits on
// the same input. T = float2: complex64 in and out, one float2 a sample
// (the second pointers unused). T = float: float32 quadrature planes in and
// out (the TPU kernel's own I/O, ops/pallas/wola_fused.py:99), one float
// from each plane at the same index, so a warp's loads and stores are one
// contiguous segment of each plane. The pointers are __restrict__ kernel
// parameters: with them as members of an I/O struct instead, the complex
// instance at N = 128, 256 ran 0.175 ms of device time against 0.144 on an
// H100 (scripts/exp_transform.py), and this form gives back the 0.144.
__device__ __forceinline__ float2 load_sample(const float2* __restrict__ x,
                                              const float2*, long long i) {
  return __ldg(x + i);
}
__device__ __forceinline__ float2 load_sample(const float* __restrict__ re,
                                              const float* __restrict__ im,
                                              long long i) {
  return make_float2(__ldg(re + i), __ldg(im + i));
}
__device__ __forceinline__ void store_sample(float2* __restrict__ out,
                                             float2*, long long i, float2 v) {
  out[i] = v;
}
__device__ __forceinline__ void store_sample(float* __restrict__ re,
                                             float* __restrict__ im,
                                             long long i, float2 v) {
  re[i] = v.x;
  im[i] = v.y;
}

template <int KB, class T>
__global__ void __launch_bounds__(kThreads, WOLA_MIN_BLOCKS)
wola_fold_fft(const T* __restrict__ x, const T* __restrict__ xim,
              const float* __restrict__ taps, const float2* __restrict__ wl,
              const int* __restrict__ rev, T* __restrict__ out,
              T* __restrict__ oim, long long rows, int n, int nb,
              LinePlan lp, int rc, int generic) {
  extern __shared__ float2 tile[];
  const int S = line_stride(n), tid = threadIdx.x;
  float2* tmp = generic ? tile + (size_t)rc * S : tile;
  const int items = n * (rc / WM), nbc = (nb + KB - 1) / KB;
  const FastDiv by_n(n);
  const long long r0 = (long long)blockIdx.x * rc;
  float hk[KB];
  // 1. fold: item = (run, column a)
  for (int it = tid; it < items; it += kThreads) {
    const int run = by_n.div(it), a = it - run * n;
    const int col = a == 0 ? 0 : n - a;
    // xq row of output row r0 + run*WM, tap 0
    const long long rbase = r0 + run * WM - (a == 0 ? 0 : 1);
    float2 acc[WM];
#pragma unroll
    for (int m = 0; m < WM; ++m) acc[m] = make_float2(0.f, 0.f);
    for (int c = 0; c < nbc; ++c) {
      load_taps<KB>(hk, taps, n, nb, a, c);
      // input i of this chunk is xq row q0 + i; output m takes it with
      // tap c*KB + kb where m = i - (KB - 1) + kb
      const long long q0 = rbase - (long long)c * KB - (KB - 1);
#pragma unroll
      for (int i = 0; i < WM + KB - 1; ++i) {
        const long long q = q0 + i;
        const float2 v = (q >= 0 && q < rows)
                             ? load_sample(x, xim, q * n + col)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int m = i - (KB - 1) + kb;
          if (m >= 0 && m < WM) {
            acc[m].x = fmaf(hk[kb], v.x, acc[m].x);
            acc[m].y = fmaf(hk[kb], v.y, acc[m].y);
          }
        }
      }
    }
    const int slot = __ldg(rev + a);
#pragma unroll
    for (int m = 0; m < WM; ++m)
      tile[(size_t)(run * WM + m) * S + slot] =
          make_float2(acc[m].x, -acc[m].y);
  }
  __syncthreads();
  // 2. N * IDFT of each row = conj(FFT(conj(row)))
  fft_lines(tile, tmp, rc, S, lp, wl);
  // 3. store the chunk's rows
  const long long left = rows - r0;
  const int valid = left < rc ? (int)left : rc;
  for (int e = tid; e < valid * n; e += kThreads) {
    const int r = by_n.div(e), k = e - r * n;
    const float2 v = tile[(size_t)r * S + k];
    store_sample(out, oim, (r0 + r) * n + k, make_float2(v.x, -v.y));
  }
}

// ---------------------------------------------- the first version, kept whole

__host__ __device__ inline size_t taps_floats(int n, int nb) {
  return ((size_t)n * nb + 1) & ~(size_t)1;
}

inline size_t direct_smem_bytes(int n, int nb, int r) {
  return 4 * taps_floats(n, nb) +
         8 * ((size_t)(r + nb) * n + (size_t)r * n + n);
}

__global__ void __launch_bounds__(kThreads)
wola_direct_kernel(const float2* __restrict__ x,
                   const float* __restrict__ taps,
                   const float2* __restrict__ tw, float2* __restrict__ out,
                   int rows, int n, int nb, int rpb) {
  extern __shared__ float direct_smem[];
  float* h = direct_smem;
  float2* tile = reinterpret_cast<float2*>(direct_smem + taps_floats(n, nb));
  float2* folded = tile + (size_t)(rpb + nb) * n;
  float2* w = folded + (size_t)rpb * n;

  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int ntaps = n * nb;

  for (int i = tid; i < ntaps; i += kThreads) h[i] = taps[i];
  for (int i = tid; i < n; i += kThreads) w[i] = tw[i];
  // tile row t holds xq row r0 - nb + t
  const int tile_elems = (rpb + nb) * n;
  for (int e = tid; e < tile_elems; e += kThreads) {
    const long long gr = r0 - nb + e / n;
    tile[e] = (gr >= 0 && gr < rows) ? x[gr * n + e % n]
                                     : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // fold: folded[r, a] = sum_b h[b*N + a] * x[(r0+r-b)N - a]
  const int out_elems = rpb * n;
  for (int e = tid; e < out_elems; e += kThreads) {
    const int r = e / n, a = e % n;
    float2 acc = make_float2(0.f, 0.f);
    if (a == 0) {
      for (int b = 0; b < nb; ++b) {
        const float hb = h[b * n];
        const float2 v = tile[(r - b + nb) * n];
        acc.x = fmaf(hb, v.x, acc.x);
        acc.y = fmaf(hb, v.y, acc.y);
      }
    } else {
      for (int b = 0; b < nb; ++b) {
        const float hb = h[b * n + a];
        const float2 v = tile[(r - b - 1 + nb) * n + (n - a)];
        acc.x = fmaf(hb, v.x, acc.x);
        acc.y = fmaf(hb, v.y, acc.y);
      }
    }
    folded[e] = acc;
  }
  __syncthreads();

  // IDFT: out[r, k] = sum_a folded[r, a] * w[(a*k) mod N]
  for (int e = tid; e < out_elems; e += kThreads) {
    const int r = e / n, k = e % n;
    if (r0 + r >= rows) continue;
    const float2* f = folded + (size_t)r * n;
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;
    for (int a = 0; a < n; ++a) {
      cmac(acc, f[a], w[m]);
      m += k;
      if (m >= n) m -= n;
    }
    out[(r0 + r) * n + k] = acc;
  }
}

template <int KB, class T>
int launch_fold_fft(const T* x, const T* xim, const float* taps,
                    const float2* wl, const int* rev, T* out, T* oim,
                    long long rows, int n, int nb, const LinePlan& lp, int rc,
                    int generic, size_t smem, cudaStream_t st) {
  return (int)launch(wola_fold_fft<KB, T>, (rows + rc - 1) / rc, kThreads,
                     smem, st, x, xim, taps, wl, rev, out, oim, rows, n, nb,
                     lp, rc, generic);
}

// Checks the plan and launches the instance of sample type T; a
// cudaError_t.
template <class T>
int run_wola(const T* x, const T* xim, const void* taps, const void* wl,
             const void* rev, T* out, T* oim, long long rows, int n, int nb,
             const int* radices, int nr, int kb, int rc, void* stream) {
  if (rows <= 0 || n <= 0 || nb <= 0 || nr < 0 || nr > MAX_RADICES ||
      rc < WM || rc % WM)
    return (int)cudaErrorInvalidValue;
  LinePlan lp;
  lp.L = n;
  lp.nr = nr;
  long long prod = 1;
  bool generic = false;
  for (int i = 0; i < nr; ++i) {
    const int r = radices[i];
    if (r < 2) return (int)cudaErrorInvalidValue;
    lp.r[i] = r;
    prod *= r;
    generic |= !(r == 2 || r == 3 || r == 4 || r == 5 || r == 8);
  }
  if (prod != n) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rc * line_stride(n) * sizeof(float2) *
                      (generic ? 2 : 1);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const float* tp = static_cast<const float*>(taps);
  const float2* wp = static_cast<const float2*>(wl);
  const int* rp = static_cast<const int*>(rev);
  cudaStream_t st = (cudaStream_t)stream;
  const int g = generic ? 1 : 0;
  switch (kb) {
#define PDSP_WOLA_KB(K)                                                  \
    case K:                                                              \
      return launch_fold_fft<K>(x, xim, tp, wp, rp, out, oim, rows, n, nb, \
                                lp, rc, g, smem, st);
    PDSP_WOLA_KB(1)
    PDSP_WOLA_KB(2)
    PDSP_WOLA_KB(4)
    PDSP_WOLA_KB(8)
    PDSP_WOLA_KB(16)
    PDSP_WOLA_KB(32)
#undef PDSP_WOLA_KB
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (>= rows*n,) complex64; taps: (nb*n,) float32; wl: the N-point line
// table of ops/fft.line_table over the nr radices (host ints, stage order;
// nr = 0 for N = 1); rev: (n,) int32 digit reversal; out: (rows, n)
// complex64. kb: taps a thread holds (1, 2, 4, 8, 16 or 32); rc: rows a
// block (a multiple of 8, max(1, 256/n) runs). Returns a cudaError_t.
extern "C" int pdsp_wola_fused(const void* x, const void* taps,
                               const void* wl, const void* rev, void* out,
                               long long rows, int n, int nb,
                               const int* radices, int nr, int kb, int rc,
                               void* stream) {
  return run_wola(static_cast<const float2*>(x), (const float2*)nullptr, taps,
                  wl, rev, static_cast<float2*>(out), (float2*)nullptr, rows,
                  n, nb, radices, nr, kb, rc, stream);
}

// The same on float32 planes: xre, xim (>= rows*n,) each; out_re, out_im
// (rows, n) each. Bit-identical to pdsp_wola_fused on the same samples.
extern "C" int pdsp_wola_fused_planes(const void* xre, const void* xim,
                                      const void* taps, const void* wl,
                                      const void* rev, void* out_re,
                                      void* out_im, long long rows, int n,
                                      int nb, const int* radices, int nr,
                                      int kb, int rc, void* stream) {
  return run_wola(static_cast<const float*>(xre),
                  static_cast<const float*>(xim), taps, wl, rev,
                  static_cast<float*>(out_re), static_cast<float*>(out_im),
                  rows, n, nb, radices, nr, kb, rc, stream);
}

// The first version (direct IDFT), for scripts/exp_wola.py: tw (n,)
// complex64 with tw[m] = exp(+2*pi*i*m/n). Returns a cudaError_t.
extern "C" int pdsp_wola_direct(const void* x, const void* taps,
                                const void* tw, void* out, int rows, int n,
                                int nb, void* stream) {
  if (rows <= 0 || n <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  // largest row tile (<= 32) whose shared-memory footprint fits the SM
  int rpb = 32;
  while (rpb > 1 && direct_smem_bytes(n, nb, rpb) > (size_t)kMaxSmem)
    rpb /= 2;
  const size_t smem = direct_smem_bytes(n, nb, rpb);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wola_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + rpb - 1) / rpb;
  wola_direct_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(taps),
      static_cast<const float2*>(tw), static_cast<float2*>(out), rows, n, nb,
      rpb);
  return (int)cudaGetLastError();
}
