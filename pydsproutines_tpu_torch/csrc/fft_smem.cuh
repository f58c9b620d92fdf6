// A block-level mixed-radix complex64 FFT in shared memory, and the passes
// of the CAF peak kernels (fused_xcorr.cu, fused_caf3.cu) built on it.
//
// Line FFT. A block holds `lines` lines of L <= BLOCK_ELEMS points in shared
// memory (line stride L | 1, odd, so that a column-major load is free of
// bank conflicts) and transforms all of them in place, decimation in time
// over the radices r_0, r_1, ... of ops/fft.radix_plan. The digit reversal
// costs no pass: each sample t is stored at its digit-reversed slot as the
// block loads it (ops/fft.digit_reversal, a table). At a radix-R stage, with
// P the product of the earlier radices and Q = P*R, butterfly u < L/R of a
// line (j = u % P, b = u / P)
//
//   reads the R slots b*Q + j + k*P, k < R, multiplies slot k by
//   W_Q^(j*k), takes an R-point DFT and writes the results back in place,
//
// so the block synchronises once a stage and no thread holds data across a
// barrier; the output is in natural order. Radices 2, 3, 4, 5, 8 run
// unrolled butterflies on registers; any other prime p a generic direct
// radix-p stage, p^2 complex multiply-adds per butterfly, through a second
// buffer. Twiddles come from an f32 table built on the host from float64
// phases reduced mod L (ops/fft.line_table), never from sincosf, so the
// error stays at the table's rounding times the number of stages: W_L^m for
// m < L (the generic radix), then each stage's twiddles in the order
// neighbouring butterflies read them. ops/fft.fft_staged runs the same
// schedule in torch over the same tables.
//
// The CAF passes (ops/fft.caf_plan chooses them). For each shift s, p[t] =
// rx[s + t] * cc[t], n = f0 [* f1 [* f2]]:
//
//   one pass  (n <= BLOCK_ELEMS): row_peak over the modulated windows, one row
//             per shift, writes (max_k |X[k]|^2, k) per shift directly;
//   col_pass  a column FFT of length f0 along t0 of the window viewed as
//             (f0, n/f0), C adjacent columns per block (so the strided
//             loads come in segments of C*8 bytes), the four-step twiddle
//             W_M^(k0*c) on store (M the pass's length times its columns,
//             from a (L, cols) table that the shifts of a chunk share in L2)
//             into a complex64 scratch (nb, n); a second col_pass (three-pass
//             plans only) does the same in place over each k0 slab viewed
//             as (f1, f2);
//   row_peak  the last factor's FFT along the contiguous rows of the
//             scratch, |X|^2 and each row's (max, lowest argmax) in
//             registers, one or more warps a row: the spectrum is never
//             stored;
//   peak_reduce (cgemm.cuh) the best row per shift and its true bin k0 +
//             f0*(k1 [+ f1*k2]), ties to the lowest bin.
//
// What bounds it on the H100: bytes. Per shift a two-pass plan reads the
// window and the template (16 n bytes), writes and reads the scratch (16 n)
// and does ~5 n log2 n flops, against n*(n1+n2) complex MACs for the dense
// DFT products it replaces (csrc/cgemm.cuh, which #4 and #8 still use).
//
// Everything sits in an anonymous namespace (see cgemm.cuh).

#pragma once

#include "cgemm.cuh"

namespace {

constexpr int BLOCK_ELEMS = 8192;          // complex elements per block
constexpr int PER = 16;                    // elements per thread
constexpr int MAX_THREADS = BLOCK_ELEMS / PER;   // 512
constexpr int MAX_RADICES = 16;

struct LinePlan {
  int L, nr, r[MAX_RADICES];
};

struct CafPlan {
  int nf, f[3], lines[3];
  LinePlan lp[3];
};

__host__ __device__ __forceinline__ int line_stride(int L) { return L | 1; }

// x / d for 0 <= x < 2^24 by a float reciprocal and one correction step,
// instead of a runtime integer division (tens of instructions) per element.
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ explicit FastDiv(int d_)
      : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int div(int x) const {
    const int q = __float2int_rz(__int2float_rn(x) * inv);
    const int r = x - q * d;
    return r >= d ? q + 1 : (r < 0 ? q - 1 : q);
  }
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// In-place forward R-point DFT y[a] = sum_b v[b] exp(-2 pi i a b / R).
template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void butterfly<8>(float2 (&v)[8]) {
  constexpr float h = 0.70710678118654752f;    // 1/sqrt(2)
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  butterfly<4>(e);
  butterfly<4>(o);
  o[1] = make_float2((o[1].x + o[1].y) * h, (o[1].y - o[1].x) * h);   // W8
  o[2] = mul_mi(o[2]);                                                // W8^2
  o[3] = make_float2((o[3].y - o[3].x) * h, -(o[3].x + o[3].y) * h);  // W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&v)[3]) {
  constexpr float s3 = 0.86602540378443865f;   // sin(2 pi / 3)
  const float2 s = cadd(v[1], v[2]), d = csub(v[1], v[2]);
  const float2 t = csub(v[0], scale(s, 0.5f)), m = scale(mul_mi(d), s3);
  v[0] = cadd(v[0], s);
  v[1] = cadd(t, m);
  v[2] = csub(t, m);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&v)[5]) {
  constexpr float c1 = 0.30901699437494742f;   // cos(2 pi / 5)
  constexpr float c2 = -0.80901699437494742f;  // cos(4 pi / 5)
  constexpr float s1 = 0.95105651629515357f;   // sin(2 pi / 5)
  constexpr float s2 = 0.58778525229247313f;   // sin(4 pi / 5)
  const float2 b1 = cadd(v[1], v[4]), b2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 t1 = cadd(v[0], cadd(scale(b1, c1), scale(b2, c2)));
  const float2 t2 = cadd(v[0], cadd(scale(b1, c2), scale(b2, c1)));
  const float2 u1 = mul_mi(cadd(scale(d1, s1), scale(d2, s2)));
  const float2 u2 = mul_mi(csub(scale(d1, s2), scale(d2, s1)));
  v[0] = cadd(v[0], cadd(b1, b2));
  v[1] = cadd(t1, u1);
  v[4] = csub(t1, u1);
  v[2] = cadd(t2, u2);
  v[3] = csub(t2, u2);
}

// One in-place radix-R stage (R in 2, 3, 4, 5, 8) over `lines` lines; st:
// the stage's twiddles, (R - 1) rows of P (ops/fft.line_table).
template <int R>
__device__ __forceinline__ void stage_fast(float2* buf, int lines, int S,
                                           int L, int P,
                                           const float2* __restrict__ st) {
  const int nb = L / R, Q = P * R;
  const FastDiv by_nb(nb), by_p(P);
#pragma unroll 2
  for (int u = threadIdx.x; u < lines * nb; u += blockDim.x) {
    const int line = by_nb.div(u), w = u - line * nb, b = by_p.div(w);
    const int j = w - b * P;
    float2* x = buf + line * S + b * Q + j;
    const float2* tw = st + j - P;
    float2 v[R];
    v[0] = x[0];
#pragma unroll
    for (int k = 1; k < R; ++k) v[k] = cmul(x[k * P], __ldg(tw + k * P));
    butterfly<R>(v);
#pragma unroll
    for (int k = 0; k < R; ++k) x[k * P] = v[k];
  }
  __syncthreads();
}

// One generic radix-R stage: each output is R complex multiply-adds against
// W_L^(b*j*L/Q + (a*b mod R)*L/R), the stage twiddle and the DFT in one
// table read; written to tmp, then copied back.
__device__ void stage_generic(float2* buf, float2* tmp, int lines, int S,
                              int L, int R, int P,
                              const float2* __restrict__ wl) {
  const int nb = L / R, Q = P * R, step = L / Q;
  const FastDiv by_l(L), by_nb(nb), by_p(P);
  for (int g = threadIdx.x; g < lines * L; g += blockDim.x) {
    const int line = by_l.div(g), rem = g - line * L, a = by_nb.div(rem);
    const int w = rem - a * nb, b = by_p.div(w), j = w - b * P;
    const int base = line * S + b * Q + j, jm = j * step;
    float2 acc = make_float2(0.f, 0.f);
    int ab = 0;                                   // a*k mod R
    for (int k = 0; k < R; ++k) {
      const int m = k * jm + ab * nb;             // < 2L
      cmac(acc, buf[base + k * P], __ldg(wl + (m >= L ? m - L : m)));
      ab += a;
      if (ab >= R) ab -= R;
    }
    tmp[base + a * P] = acc;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < lines * L; g += blockDim.x) {
    const int line = by_l.div(g), k = line * S + g - line * L;
    buf[k] = tmp[k];
  }
  __syncthreads();
}

// The FFT of `lines` lines of lp.L points at buf + line*S, each loaded in
// digit-reversed order, in place; tmp (same size) is used only by a
// generic radix; wl the line table. Called by the whole block after the
// lines are loaded and synchronised; returns synchronised.
__device__ void fft_lines(float2* buf, float2* tmp, int lines, int S,
                          const LinePlan& lp, const float2* __restrict__ wl) {
  const float2* st = wl + lp.L;
  int P = 1;
  for (int i = 0; i < lp.nr; ++i) {
    const int R = lp.r[i];
    switch (R) {
      case 2: stage_fast<2>(buf, lines, S, lp.L, P, st); break;
      case 3: stage_fast<3>(buf, lines, S, lp.L, P, st); break;
      case 4: stage_fast<4>(buf, lines, S, lp.L, P, st); break;
      case 5: stage_fast<5>(buf, lines, S, lp.L, P, st); break;
      case 8: stage_fast<8>(buf, lines, S, lp.L, P, st); break;
      default: stage_generic(buf, tmp, lines, S, lp.L, R, P, wl);
    }
    st += (R - 1) * P;
    P *= R;
  }
}

// Shift z's window start: offs[z] for a shift list, else s0 + z*step.
struct Shifts {
  const long long* offs;
  long long s0;
  int step;
  __device__ __forceinline__ long long at(long long z) const {
    return offs ? offs[z] : s0 + z * step;
  }
};

// The modulated window rx[s + i] * cc[i] read as a (., ncols) matrix or a row.
struct WindowView {
  const float2* rx;
  const float2* cc;
  int ncols;
  __device__ __forceinline__ float2 operator()(int t, int c) const {
    const long long i = (long long)t * ncols + c;
    return cmul(__ldg(rx + i), __ldg(cc + i));
  }
  __device__ __forceinline__ float2 operator()(int k) const {
    return cmul(__ldg(rx + k), __ldg(cc + k));
  }
};

struct Windows {
  const float2* rx;
  const float2* cc;
  Shifts sh;
  int ncols;
  __device__ __forceinline__ WindowView at(long long z, int = 0) const {
    return WindowView{rx + sh.at(z), cc, ncols};
  }
};

// Slab q of shift z of the scratch, a (L, ncols) matrix; or row r.
struct ScratchView {
  const float2* p;
  int ncols;
  __device__ __forceinline__ float2 operator()(int t, int c) const {
    return p[(size_t)t * ncols + c];
  }
  __device__ __forceinline__ float2 operator()(int k) const { return p[k]; }
};

struct Scratch {
  const float2* p;
  int L, ncols, nmat;
  __device__ __forceinline__ ScratchView at(long long z, int q) const {
    return ScratchView{p + ((size_t)z * nmat + q) * ((size_t)L * ncols),
                       ncols};
  }
  // row r of length L
  __device__ __forceinline__ ScratchView at(long long r) const {
    return ScratchView{p + (size_t)r * L, L};
  }
};

// grid (nb * nmat * ceil(ncols / C)): for slab q of shift z, the L-point
// FFT of C adjacent columns (rev: the line's digit reversal), times tw[k, c]
// = W_M^(k*c) with M = L*ncols, stored to out (nb, nmat, L, ncols). out may
// be the source itself (each block reads all it writes first). Shifts vary
// fastest over the grid, so blocks that run together read the same template
// columns and (for a sweep) nearly the same rx samples, from L2.
//
// Both passes ask for three blocks of MAX_THREADS an SM (at most 40
// registers): three 64 KB blocks fill the SM's shared memory, and this ran
// faster than one or two blocks with more registers (scripts/exp_caf_smem.py).
template <class Src>
__global__ void __launch_bounds__(MAX_THREADS, 3)
col_pass(Src src, float2* out, LinePlan lp, const float2* __restrict__ wl,
         const int* __restrict__ rev, const float2* __restrict__ tw,
         long long nb, int ncols, int nmat, int C) {
  extern __shared__ float2 smem[];
  const int L = lp.L, S = line_stride(L), T = blockDim.x, tid = threadIdx.x;
  long long b = blockIdx.x;
  const long long z = b % nb;
  b /= nb;
  const int q = (int)(b % nmat);
  const int c0 = (int)(b / nmat) * C;
  const int cols = min(C, ncols - c0), E = cols * L;
  const FastDiv by_cols(cols);
  const auto in = src.at(z, q);
#pragma unroll 4
  for (int g = tid; g < E; g += T) {
    const int t = by_cols.div(g), c = g - t * cols;
    smem[c * S + __ldg(rev + t)] = in(t, c0 + c);
  }
  __syncthreads();
  fft_lines(smem, smem + C * S, cols, S, lp, wl);
  float2* o = out + ((size_t)z * nmat + q) * ((size_t)L * ncols) + c0;
  tw += c0;
  for (int g = tid; g < E; g += T) {
    const int k = by_cols.div(g), c = g - k * cols;
    const size_t i = (size_t)k * ncols + c;
    o[i] = cmul(smem[c * S + k], __ldg(tw + i));
  }
}

// grid (ceil(nrows / Rb)): the L-point FFT of rows r0 .. r0+Rb-1 of src,
// then per row max_k |X[k]|^2 and its k (lowest on ties), one warp a row.
template <class Src>
__global__ void __launch_bounds__(MAX_THREADS, 3)
row_peak(Src src, LinePlan lp, const float2* __restrict__ wl,
         const int* __restrict__ rev, float* __restrict__ rowmax,
         int* __restrict__ rowarg, long long nrows, int Rb) {
  extern __shared__ float2 smem[];
  const int L = lp.L, S = line_stride(L), T = blockDim.x, tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * Rb;
  const int rows = (int)min((long long)Rb, nrows - r0);
  const FastDiv by_l(L);
#pragma unroll 4
  for (int g = tid; g < rows * L; g += T) {
    const int r = by_l.div(g), k = g - r * L;
    smem[r * S + __ldg(rev + k)] = src.at(r0 + r)(k);
  }
  __syncthreads();
  fft_lines(smem, smem + Rb * S, rows, S, lp, wl);
  // wpr warps scan each row (all warps share the rows when there are fewer
  // rows than warps), then one thread a row combines their winners
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int wpr = rows < nw ? nw / rows : 1, part = warp % wpr;
  __shared__ float part_v[MAX_THREADS / 32];
  __shared__ int part_k[MAX_THREADS / 32];
  for (int rb = 0; rb < rows; rb += nw / wpr) {   // uniform over the block
    const int r = rb + warp / wpr;
    float bv = -1.f;
    int bk = INT_MAX;
    if (r < rows) {
      for (int k = part * 32 + lane; k < L; k += 32 * wpr) {
        const float2 x = smem[r * S + k];
        const float v = x.x * x.x + x.y * x.y;
        if (better(v, k, bv, bk)) {
          bv = v;
          bk = k;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (better(ov, ok, bv, bk)) {
        bv = ov;
        bk = ok;
      }
    }
    if (wpr == 1) {
      if (r < rows && lane == 0) {
        rowmax[r0 + r] = bv;
        rowarg[r0 + r] = bk;
      }
      continue;
    }
    // wpr > 1: nw / wpr >= rows, so this is the only round
    if (lane == 0) {
      part_v[warp] = bv;
      part_k[warp] = bk;
    }
    __syncthreads();
    if (tid < rows) {
      bv = -1.f;
      bk = INT_MAX;
      for (int w = tid * wpr; w < (tid + 1) * wpr; ++w) {
        if (better(part_v[w], part_k[w], bv, bk)) {
          bv = part_v[w];
          bk = part_k[w];
        }
      }
      rowmax[r0 + tid] = bv;
      rowarg[r0 + tid] = bk;
    }
  }
}

// ---------------------------------------------------------------- host side

// The int array of ops/fft.plan_ints; false if it is not a plan the
// kernels can run.
inline bool read_plan(const int* p, CafPlan& out) {
  out.nf = p[0];
  if (out.nf < 1 || out.nf > 3) return false;
  long long n = 1;
  for (int i = 0; i < 3; ++i) {
    out.f[i] = p[1 + i];
    out.lines[i] = p[4 + i];
    const int* q = p + 7 + i * (2 + MAX_RADICES);
    LinePlan& lp = out.lp[i];
    lp.L = q[0];
    lp.nr = q[1];
    if (i >= out.nf) continue;
    if (lp.L != out.f[i] || lp.L < 2 || out.lines[i] < 1 ||
        (long long)lp.L * out.lines[i] > BLOCK_ELEMS || lp.nr < 1 ||
        lp.nr > MAX_RADICES)
      return false;
    long long prod = 1;
    for (int k = 0; k < lp.nr; ++k) {
      lp.r[k] = q[2 + k];
      if (lp.r[k] < 2) return false;
      prod *= lp.r[k];
    }
    if (prod != lp.L) return false;
    n *= lp.L;
  }
  return n <= INT_MAX;
}

inline int threads_for(int elems) {
  int t = ((elems + PER - 1) / PER + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

inline size_t smem_bytes(const LinePlan& lp, int lines) {
  bool generic = false;
  for (int i = 0; i < lp.nr; ++i) {
    const int r = lp.r[i];
    generic |= !(r == 2 || r == 3 || r == 4 || r == 5 || r == 8);
  }
  return (size_t)lines * line_stride(lp.L) * sizeof(float2) * (generic ? 2 : 1);
}

// Launch on `st` with `smem` bytes of dynamic shared memory (raising the
// kernel's limit past 48 KB first); the launch's cudaError_t.
template <class K, class... A>
cudaError_t launch(K kernel, long long blocks, int threads, size_t smem,
                   cudaStream_t st, A... args) {
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The whole CAF peak search of nb shifts under plan p. tab: the eight
// tables of ops/fft.caf_tables (line tables of passes 0-2, the pass-0 and
// pass-1 column twiddles, the digit reversals of passes 0-2); scratch
// (nb, n) complex64 and
// rowmax / rowarg (nb * n / f_last) for plans of two or three passes.
inline int run_caf(const float2* rx, const float2* cc, Shifts sh, int nb,
                   const CafPlan& p, const void* const* tables,
                   float2* scratch, float* rowmax, int* rowarg,
                   float* out_max, int* out_bin, cudaStream_t st) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  const float2* tab[5];
  const int* rev[3];
  for (int i = 0; i < 5; ++i) tab[i] = static_cast<const float2*>(tables[i]);
  for (int i = 0; i < 3; ++i) rev[i] = static_cast<const int*>(tables[5 + i]);
  if (p.nf == 1) {
    const LinePlan& lp = p.lp[0];
    const int rb = p.lines[0];
    return (int)launch(row_peak<Windows>, (nb + rb - 1) / rb,
                       threads_for(rb * lp.L), smem_bytes(lp, rb), st,
                       Windows{rx, cc, sh, lp.L}, lp, tab[0], rev[0], out_max,
                       out_bin, (long long)nb, rb);
  }
  long long n = 1;
  for (int i = 0; i < p.nf; ++i) n *= p.f[i];
  // pass 0: columns of each window
  const int cols0 = (int)(n / p.f[0]), c0 = p.lines[0];
  cudaError_t err = launch(
      col_pass<Windows>, (long long)nb * ((cols0 + c0 - 1) / c0),
      threads_for(c0 * p.f[0]), smem_bytes(p.lp[0], c0), st,
      Windows{rx, cc, sh, cols0}, scratch, p.lp[0], tab[0], rev[0], tab[3],
      (long long)nb, cols0, 1, c0);
  if (err != cudaSuccess) return (int)err;
  if (p.nf == 3) {   // pass 1: columns of each k0 slab, in place
    const int c1 = p.lines[1];
    err = launch(col_pass<Scratch>,
                 (long long)nb * p.f[0] * ((p.f[2] + c1 - 1) / c1),
                 threads_for(c1 * p.f[1]), smem_bytes(p.lp[1], c1), st,
                 Scratch{scratch, p.f[1], p.f[2], p.f[0]}, scratch, p.lp[1],
                 tab[1], rev[1], tab[4], (long long)nb, p.f[2], p.f[0], c1);
    if (err != cudaSuccess) return (int)err;
  }
  // last pass: rows, each row's peak
  const int fl = p.f[p.nf - 1], rb = p.lines[p.nf - 1];
  const long long rows = n / fl, nrows = (long long)nb * rows;
  err = launch(row_peak<Scratch>, (nrows + rb - 1) / rb, threads_for(rb * fl),
               smem_bytes(p.lp[p.nf - 1], rb), st,
               Scratch{scratch, fl, 0, 0}, p.lp[p.nf - 1], tab[p.nf - 1],
               rev[p.nf - 1], rowmax, rowarg, nrows, rb);
  if (err != cudaSuccess) return (int)err;
  Digits d{p.nf, {p.f[0], p.f[1], p.f[2]}};
  return (int)launch(peak_reduce, nb, NT, 0, st, (const float*)rowmax,
                     (const int*)rowarg, out_max, out_bin, (int)rows, d);
}

}  // namespace
