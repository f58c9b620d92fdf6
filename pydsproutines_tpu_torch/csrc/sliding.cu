// Hopper sliding normalised matched filter (dense short-template QF^2).
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/sliding.py:_kernel.
// Contract: for every template t < T and shift s < ns = n - l + 1,
//
//   c[t, s]   = sum_{j < l} x[s + j] * conj(tmpl[t, j]),
//   e[s]      = sum_{j < l} |x[s + j]|^2,
//   out[t, s] = |c[t, s]|^2 / (e[s] * tnorm[t])   (0 where that is 0),
//
// with tnorm[t] = ||tmpl_t||^2 (template_norms, which also zeroes the
// re-check's counter: a launch where the wrapper would take five). Window
// energies are f32 sums of the window's own samples, so a window of zeros
// gives exactly 0.
// Two routes; ops/hopper/sliding.sliding_plan picks one (select_sliding_path
// says which and why).
//
// Overlap-save route (sliding_ols). c is a correlation, so per segment of
// nfft samples (nfft a power of two, 4l <= nfft <= 8192) the V = nfft - l + 1
// shifts s0 .. s0 + V - 1 come out of one FFT of x[s0, s0 + nfft) and, per
// template, a product with the template's conjugated spectrum and an inverse
// FFT, all on fft_smem.cuh's shared-memory line FFT (twiddles from the host's
// f32 table, digit reversal folded into each load). The inverse is the
// forward FFT by conjugation: FFT(conj(X) * Tf) = nfft * conj(c), and only
// |c|^2 is kept. One block a segment:
//
//   1. stage x[s0 + i] (0 past n) in digit-reversed order, |x|^2 in natural
//      order; per aligned 32-sample run (one warp a run, by shuffles) its
//      prefix and suffix sums and total, and sums of 8 runs;
//   2. e[s] = the head run's suffix + the tail run's prefix + the whole runs
//      between, kept in shared memory: ~20 shared reads a shift at l = 1024
//      (summing the partial runs sample by sample took ~94, about 40% of
//      the segment's shared traffic), and never a difference of sums;
//   3. the precision re-check: the FFT's rounding in c scales with the
//      segment's energy, not the window's, so a quiet window beside a loud
//      burst could miss the f32 grade of the direct product. A segment whose
//      energy exceeds `limit` times its least non-zero window energy
//      (ops/hopper/sliding.FLAG_RATIO, calibrated on the CPU emulation
//      ops/hopper/sliding.sliding_staged) is flagged (flags[b] = 1, counted
//      in *flagged) and left; a launch of the direct route over the whole
//      sweep, masked by the flags, then computes its shifts by the direct
//      f32 product, a few blocks a segment (its blocks over unflagged
//      segments return at once). Computed in the segment's own block, a
//      flagged segment held the kernel ~1.2 ms longer (one SM doing 3073 x
//      T x L products) on the 4M burst-edge scene (scripts/exp_sliding.py);
//   4. FFT the segment in place; per template: conj(X) * Tf into the second
//      buffer (digit-reversed), FFT, out = |B[s] / nfft|^2 / (e[s] tnorm).
//
// The T template spectra (T x nfft complex64, read from L2 by every block)
// come from one small launch of the same line FFT (template_spectra).
//
// Direct route (sliding_kernel, the first version of this kernel, for
// templates so short that the transforms cost more than the products). A
// block owns TILE = 1024 consecutive shifts: it stages x[s0, s0 + TILE + l -
// 1) and the templates in shared memory, and each of its 256 threads
// accumulates the shifts tid + 256*q, q < 4, for every template in
// registers. More than 8 templates run as several launches of at most 8.
//
// What bounds it on the H100: at T = 4, l = 1024, n = 4M the direct product
// is 137 GFLOP (2.05 ms at 67 TFLOP/s); overlap-save at nfft = 4096 is ~2
// GFLOP of butterflies and products over 1365 segments (5 line FFTs of 4096
// a segment), so its limits are the shared-memory traffic of the FFT stages
// (12 radix-8 passes a segment) and its barriers, then the 8 B a sample in
// and 16 B a shift out of HBM (~0.03 ms).

#include "fft_smem.cuh"

namespace {

constexpr int SNT_NORM = 256;         // threads per template_norms block

// grid (T): tnorm[t] = ||tmpl_t||^2 in f32; block 0 zeroes *flagged.
__global__ void __launch_bounds__(SNT_NORM)
template_norms(const float2* __restrict__ tmpl, int l,
               float* __restrict__ tnorm, int* __restrict__ flagged) {
  __shared__ float part[SNT_NORM / 32];
  const float2* tp = tmpl + (size_t)blockIdx.x * l;
  float e = 0.f;
  for (int j = threadIdx.x; j < l; j += SNT_NORM)
    e = fmaf(tp[j].x, tp[j].x, fmaf(tp[j].y, tp[j].y, e));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    e += __shfl_xor_sync(0xffffffffu, e, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < SNT_NORM / 32; ++w) t += part[w];
    tnorm[blockIdx.x] = t;
    if (blockIdx.x == 0) *flagged = 0;
  }
}

// ------------------------------------------------------------ direct route

constexpr int SNT = 256;              // threads per block
constexpr int SPT = 4;                // shifts per thread
constexpr int TILE = SNT * SPT;       // shifts per block
constexpr int MAX_TT = 8;             // templates per launch
constexpr size_t kMaxSmem = 227 * 1024;

// flags (the overlap-save route's re-check): null, or one int per segment
// of V shifts; then only the shifts of flagged segments are computed.
template <int TT>
__global__ void __launch_bounds__(SNT)
sliding_kernel(const float2* __restrict__ x, long long n,
               const float2* __restrict__ tmpl, int l,
               const float* __restrict__ tnorm, float* __restrict__ out,
               long long ns, const int* __restrict__ flags, int V) {
  extern __shared__ float2 sm[];
  float2* xs = sm;                          // TILE + l - 1 samples
  float2* ts = sm + TILE + l - 1;           // TT * l taps
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * TILE;
  if (flags) {                              // uniform over the block
    bool any = false;
    const long long last = min(s0 + TILE, ns) - 1;
    for (long long b = s0 / V; b <= last / V; ++b) any |= flags[b] != 0;
    if (!any) return;
  }
  for (int i = tid; i < TILE + l - 1; i += SNT) {
    const long long gi = s0 + i;
    xs[i] = gi < n ? x[gi] : make_float2(0.f, 0.f);
  }
  for (int i = tid; i < TT * l; i += SNT) ts[i] = tmpl[i];
  __syncthreads();

  float2 acc[TT][SPT];
  float e[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    e[q] = 0.f;
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t][q] = make_float2(0.f, 0.f);
  }
  for (int j = 0; j < l; ++j) {
    float2 xv[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      xv[q] = xs[tid + q * SNT + j];
      e[q] = fmaf(xv[q].x, xv[q].x, fmaf(xv[q].y, xv[q].y, e[q]));
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float2 tv = ts[t * l + j];
#pragma unroll
      for (int q = 0; q < SPT; ++q) {        // x * conj(tv)
        acc[t][q].x = fmaf(xv[q].x, tv.x, fmaf(xv[q].y, tv.y, acc[t][q].x));
        acc[t][q].y = fmaf(xv[q].y, tv.x, fmaf(-xv[q].x, tv.y, acc[t][q].y));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const long long s = s0 + tid + q * SNT;
    if (s >= ns || (flags && !flags[s / V])) continue;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float mag = acc[t][q].x * acc[t][q].x + acc[t][q].y * acc[t][q].y;
      const float den = e[q] * tnorm[t];
      out[(size_t)t * ns + s] = den > 0.f ? mag / den : 0.f;
    }
  }
}

template <int TT>
int launch_direct(const float2* x, long long n, const float2* tmpl, int l,
                  const float* tnorm, float* out, long long ns,
                  const int* flags, int V, cudaStream_t st) {
  const size_t smem = sizeof(float2) * ((size_t)TILE + l - 1 + (size_t)TT * l);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sliding_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (ns + TILE - 1) / TILE;
  sliding_kernel<TT><<<(unsigned)blocks, SNT, smem, st>>>(
      x, n, tmpl, l, tnorm, out, ns, flags, V);
  return (int)cudaGetLastError();
}

// The direct route over every shift, or (flags given) over the shifts of
// the flagged segments of V shifts.
int run_direct(const float2* xp, long long n, const float2* tmpl, int t,
               int l, const float* tnorm, float* out, long long ns,
               const int* flags, int V, cudaStream_t st) {
  for (int t0 = 0; t0 < t; t0 += MAX_TT) {
    const float2* tp = tmpl + (size_t)t0 * l;
    const float* np_ = tnorm + t0;
    float* op = out + (size_t)t0 * ns;
    int rc;
    switch (t - t0 < MAX_TT ? t - t0 : MAX_TT) {
      case 1: rc = launch_direct<1>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 2: rc = launch_direct<2>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 3: rc = launch_direct<3>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 4: rc = launch_direct<4>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 5: rc = launch_direct<5>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 6: rc = launch_direct<6>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      case 7: rc = launch_direct<7>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
      default: rc = launch_direct<8>(xp, n, tp, l, np_, op, ns, flags, V,
                                      st); break;
    }
    if (rc != 0) return rc;
  }
  return 0;
}

// ------------------------------------------------------ overlap-save route

constexpr int ONT = 512;              // threads per overlap-save block

// grid (T): spec[t] = FFT_L of template t zero-padded to L points.
__global__ void __launch_bounds__(ONT)
template_spectra(const float2* __restrict__ tmpl, int l, LinePlan lp,
                 const float2* __restrict__ wl, const int* __restrict__ rev,
                 float2* __restrict__ spec) {
  extern __shared__ float2 buf[];
  const int L = lp.L;
  const size_t t = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    buf[__ldg(rev + i)] = i < l ? __ldg(tmpl + t * l + i)
                                : make_float2(0.f, 0.f);
  __syncthreads();
  fft_lines(buf, buf, 1, L, lp, wl);
  for (int i = threadIdx.x; i < L; i += blockDim.x) spec[t * L + i] = buf[i];
}

// grid (segments): segment b holds the shifts b*V .. b*V + V - 1, V = L - l
// + 1. Shared memory: A, B (L complex each; B holds the in-run prefix and
// suffix sums until step 4), |x|^2 (L), E (V), run sums (L/32), sums of 8
// runs (L/256), floats.
__global__ void __launch_bounds__(ONT, 2)
sliding_ols(const float2* __restrict__ x, long long n,
            const float2* __restrict__ spec, int T, int l,
            const float* __restrict__ tnorm, float* __restrict__ out,
            long long ns, LinePlan lp, const float2* __restrict__ wl,
            const int* __restrict__ rev, float limit,
            int* __restrict__ flags, int* __restrict__ flagged) {
  extern __shared__ float2 sm[];
  const int L = lp.L, V = L - l + 1, tid = threadIdx.x, nt = blockDim.x;
  float2* A = sm;
  float2* B = sm + L;
  float* pre = reinterpret_cast<float*>(B);       // until step 4
  float* suf = pre + L;
  float* p = reinterpret_cast<float*>(sm + 2 * L);
  float* E = p + L;
  float* runs = E + V;
  float* sup = runs + (L >> 5);
  __shared__ float red_sum[ONT / 32], red_min[ONT / 32];
  __shared__ int flag;
  const long long s0 = (long long)blockIdx.x * V;
  // 1. stage; per 32-sample run (a warp) its prefix and suffix sums
  for (int i = tid; i < L; i += nt) {
    const long long gi = s0 + i;
    const float2 v = gi < n ? __ldg(x + gi) : make_float2(0.f, 0.f);
    A[__ldg(rev + i)] = v;
    p[i] = fmaf(v.x, v.x, v.y * v.y);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5, nruns = L >> 5;
  for (int r = warp; r < nruns; r += nw) {
    const float v = p[r * 32 + lane];
    float up = v, down = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a = __shfl_up_sync(0xffffffffu, up, off);
      const float b = __shfl_down_sync(0xffffffffu, down, off);
      if (lane >= off) up += a;
      if (lane + off < 32) down += b;
    }
    pre[r * 32 + lane] = up;
    suf[r * 32 + lane] = down;
    if (lane == 31) runs[r] = up;
  }
  __syncthreads();
  for (int q = tid; q < (nruns >> 3); q += nt) {
    float e = 0.f;
    for (int r = 8 * q; r < 8 * q + 8; ++r) e += runs[r];
    sup[q] = e;
  }
  __syncthreads();
  // 2. window energies, the least non-zero one among the valid shifts: a
  // window [s, s + l) in one run sums its samples; else its first run's
  // suffix, its last run's prefix and the whole runs between (8 at a time
  // where aligned). Sums of the window's own samples only: no cancellation,
  // and 0 for a window of zeros.
  const float inf = __int_as_float(0x7f800000);
  float mn = inf;
  for (int s = tid; s < V; s += nt) {
    const int last = s + l - 1, ra = s >> 5, rb = last >> 5;
    float e = 0.f;
    if (ra == rb) {
      for (int i = s; i <= last; ++i) e += p[i];
    } else {
      e = suf[s] + pre[last];
      int r = ra + 1;
      for (; r < rb && (r & 7); ++r) e += runs[r];
      for (; r + 8 <= rb; r += 8) e += sup[r >> 3];
      for (; r < rb; ++r) e += runs[r];
    }
    E[s] = e;
    if (s0 + s < ns && e > 0.f) mn = fminf(mn, e);
  }
  float seg = 0.f;
  for (int q = tid; q < (nruns >> 3); q += nt) seg += sup[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    seg += __shfl_xor_sync(0xffffffffu, seg, off);
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) {
    red_sum[warp] = seg;
    red_min[warp] = mn;
  }
  __syncthreads();
  // 3. the precision re-check
  if (tid == 0) {
    float tot = 0.f, m = inf;
    for (int w = 0; w < nw; ++w) {
      tot += red_sum[w];
      m = fminf(m, red_min[w]);
    }
    flag = tot > limit * m;
    flags[blockIdx.x] = flag;
    if (flag) atomicAdd(flagged, 1);
  }
  __syncthreads();
  if (flag) return;                       // the masked direct pass's
  // 4. the segment's spectrum, then per template the correlation
  fft_lines(A, A, 1, L, lp, wl);
  const float inv = 1.f / (float)L;               // a power of two: exact
  for (int t = 0; t < T; ++t) {
    const float2* st = spec + (size_t)t * L;
    for (int k = tid; k < L; k += nt) {
      const float2 a = A[k], b = __ldg(st + k);   // conj(a) * b
      B[__ldg(rev + k)] = make_float2(fmaf(a.x, b.x, a.y * b.y),
                                      fmaf(a.x, b.y, -a.y * b.x));
    }
    __syncthreads();
    fft_lines(B, B, 1, L, lp, wl);
    const float tn = tnorm[t];
    for (int s = tid; s < V; s += nt) {
      const long long gs = s0 + s;
      if (gs >= ns) break;
      const float cx = B[s].x * inv, cy = B[s].y * inv;
      const float den = E[s] * tn;
      out[(size_t)t * ns + gs] = den > 0.f ? (cx * cx + cy * cy) / den : 0.f;
    }
    __syncthreads();
  }
}

int run_ols(const float2* x, long long n, const float2* tmpl, int T, int l,
            const float* tnorm, float* out, long long ns, const int* plan,
            const float2* wl, const int* rev, float2* spec, float limit,
            int* flags, int* flagged, cudaStream_t st) {
  CafPlan p;
  if (!read_plan(plan, p) || p.nf != 1) return (int)cudaErrorInvalidValue;
  const LinePlan& lp = p.lp[0];
  const int L = lp.L, V = L - l + 1;
  if (V < 1 || (L & 255)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < lp.nr; ++i)                 // powers of two only
    if (lp.r[i] != 2 && lp.r[i] != 4 && lp.r[i] != 8)
      return (int)cudaErrorInvalidValue;
  cudaError_t err = launch(template_spectra, T, ONT, sizeof(float2) * L, st,
                           tmpl, l, lp, wl, rev, spec);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float2) * 2 * (size_t)L +
                      sizeof(float) * ((size_t)L + V + (L >> 5) + (L >> 8));
  err = launch(sliding_ols, (ns + V - 1) / V, ONT, smem, st, x, n,
               (const float2*)spec, T, l, tnorm, out, ns, lp, wl, rev, limit,
               flags, flagged);
  if (err != cudaSuccess) return (int)err;
  return run_direct(x, n, tmpl, T, l, tnorm, out, ns, flags, V, st);
}

}  // namespace

// x: (n,) complex64; tmpl: (t, l) complex64 row-major, not conjugated;
// tnorm: (t,) float32, written with ||tmpl_t||^2; out: (t, n - l + 1)
// float32. plan: null
// for the direct route, else the overlap-save route's one-line plan
// (ops/fft.plan_ints of nfft points), with wl / rev its line table and digit
// reversal, spec a (t, nfft) complex64 scratch, limit the re-check's energy
// ratio, flags one int per segment (written) and flagged one int (written)
// that counts the segments sent to the direct product. Returns a
// cudaError_t.
extern "C" int pdsp_sliding(const void* x, long long n, const void* tmpl,
                            int t, int l, void* tnorm, void* out,
                            const void* plan, const void* wl, const void* rev,
                            void* spec, float limit, void* flags,
                            void* flagged, void* stream) {
  const long long ns = n - l + 1;
  if (t <= 0 || l <= 0 || ns <= 0 || (ns + TILE - 1) / TILE > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* xp = static_cast<const float2*>(x);
  const float2* tp = static_cast<const float2*>(tmpl);
  const float* np_ = static_cast<const float*>(tnorm);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      launch(template_norms, t, SNT_NORM, 0, st, tp, l,
             static_cast<float*>(tnorm), static_cast<int*>(flagged));
  if (err != cudaSuccess) return (int)err;
  if (!plan) return run_direct(xp, n, tp, t, l, np_, op, ns, nullptr, 1, st);
  return run_ols(xp, n, tp, t, l, np_, op, ns, static_cast<const int*>(plan),
                 static_cast<const float2*>(wl), static_cast<const int*>(rev),
                 static_cast<float2*>(spec), limit, static_cast<int*>(flags),
                 static_cast<int*>(flagged), st);
}
