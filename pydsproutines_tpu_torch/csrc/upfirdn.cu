// Hopper upfirdn: zero-stuff by `up`, FIR with real taps, keep every
// `down`-th sample, scipy.signal.upfirdn's output, on one or two real planes.
//
// Replaces the TPU kernels pydsproutines_tpu/ops/pallas/upfirdn.py:_kernel
// and :_kernel_nopad (the padded and pad-free forms of one contract). With
// m = j*down, p = m mod up and q = m div up, each output is
//
//   out[j] = sum_l h[p + l*up] * x[q - l],   l in [0, Lh), Lh = ceil(T/up),
//
// h zero past its length T and x zero outside [0, n) (ops/filters.py
// _upfirdn_poly_planes). No zero-stuffed signal is built: n*T/down MACs.
//
// Design (upfirdn_window, a register-window polyphase FIR). Outputs come in
// phase periods of P = up/g outputs that consume S = down/g inputs (g =
// gcd(up, down)): output i*P + c has phase p_c = (c*down) mod up and reads
// x[i*S + q_c - l], q_c = (c*down) div up, with taps h_c[l] = h[p_c + l*up].
// Tap l of output i reads the same sample as tap l + S of output i + 1. So a
// warp takes one phase c and each lane M consecutive outputs i0 .. i0+M-1 of
// it, and walks the taps in residue classes rho = l mod S (l = rho + t*S):
// at step t output i0 + u reads x[i0*S + q_c - rho + (u - t)*S], so a window
// of M samples in registers serves all M outputs, and each step loads one
// new sample into the slot the oldest one leaves (slot (u - t) mod M; the t
// loop is unrolled by M, so every slot index is a constant) and one tap, a
// broadcast: 2/M shared-memory loads a FMA (the first version: 1.25). Class
// rho runs its ceil((Lh - rho)/S) steps exactly: whole groups of M unrolled,
// then the rest under a guard uniform over the warp.
//
// A tile is Ib = 32*M*nir consecutive outputs of every phase (nir warp
// rows; P*nir warp tasks, at most 16 warps). The card's resident blocks
// each walk tiles blockIdx.x, + gridDim.x, ...; a block stages in shared
// memory its phase-tap table hs[c][rho][t] once, each tile's input span
// (zeros outside [0, n)) by cp.async into one of two buffers while it
// computes the tile before, and each tile's outputs, which it then stores
// contiguously, so the P-strided outputs leave coalesced. Lanes read the span M*S samples
// apart and write the output tile M*P apart; both tiles insert one pad
// element every 2^shift, shift chosen (by the wrapper) so that the lanes of
// a warp fall on distinct banks. When the tiles pass the wrapper's budget,
// the unstaged variant reads taps and samples through L1/L2 and stores
// directly, with the same schedule, so any tap length runs.
//
// Two float32 planes run as the two parts of one float2 (C = 2): each tap
// and each index computation feed both, and where the planes are the real
// and imaginary parts of one complex tensor (adjacent, element stride 2)
// each sample moves as one 8-byte value, so its sector is read once.
// float64 runs one plane per grid z; rows on grid y. Indices into device
// memory are 64-bit.
//
// What bounds it on the H100: at the JAX bench's chain (4,194,304 complex
// samples, up 5, down 4, 730 combined taps, Lh = 146) the two planes need
// 1.53e9 FMAs against 75 MB of traffic (~22 us at 3.35 TB/s), so it is
// bound by the f32 FMA rate; at M = 16 a step issues 16 FMAs, 2 shared
// loads and ~3 integer operations.
//
// upfirdn_v1 is this kernel's first version (kR = 4 outputs a thread, one
// tap and four samples from shared memory for four FMAs), kept whole for
// scripts/exp_upfirdn.py's same-call comparison; the port does not call it.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Blocks of kMaxThreads an SM the register budget is cut for: 2 (64
// registers) where the window and sums take at most 32 registers, else 1.
// On the H100 at the chain, a 64-register cap made the one-plane M = 16
// kernel ~7% faster and the float2 one spill (3.6x slower).
#define UPFIRDN_BLOCKS(T, C, M) ((M) * (C) * sizeof(T) <= 64 ? 2 : 1)

constexpr int kMaxThreads = 512;
constexpr long long kMaxSmem = 227 * 1024;

// Row stride of the tap table: steps rounded up to 4, so that a group's
// taps load as float4 (double2).
__host__ __device__ inline int tap_stride(int tpad) { return (tpad + 3) & ~3; }

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
struct Planes {
  const T* in[2];
  T* out[2];
};

// C components of type T, loaded and stored as one vector
template <typename T, int C>
struct alignas(sizeof(T) * C) Vec {
  T v[C];
};

template <typename T, int C>
__device__ __forceinline__ Vec<T, C> zero_vec() {
  Vec<T, C> z;
#pragma unroll
  for (int k = 0; k < C; ++k) z.v[k] = T(0);
  return z;
}

// The M taps of one step group, from shared memory, in 16-byte loads.
template <typename T, int M>
__device__ __forceinline__ void load_group(T (&hv)[M],
                                           const T* __restrict__ p) {
  if constexpr (sizeof(T) == 4 && M % 4 == 0) {
#pragma unroll
    for (int k = 0; k < M / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      hv[4 * k] = v.x;
      hv[4 * k + 1] = v.y;
      hv[4 * k + 2] = v.z;
      hv[4 * k + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && M % 2 == 0) {
#pragma unroll
    for (int k = 0; k < M / 2; ++k) {
      const double2 v = reinterpret_cast<const double2*>(p)[k];
      hv[2 * k] = v.x;
      hv[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k) hv[k] = p[k];
  }
}

long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// An asynchronous copy of one V from device to shared memory; zeros when
// `valid` is false (nothing is read then).
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src, bool valid) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8 || sizeof(V) == 16, "size");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(V)), "r"(valid ? (int)sizeof(V) : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// grid (resident blocks, each walking tiles of Ib*P outputs blockIdx.x,
// blockIdx.x + gridDim.x, ...; rows (looped past 65535); planes).
template <typename T, int C, int M, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads, UPFIRDN_BLOCKS(T, C, M))
upfirdn_window(Planes<T> pl, const T* __restrict__ h, int ntaps,
               long long n, long long n_out, int rows, long long in_rs,
               long long in_es, long long out_rs, long long out_es, int up,
               int down, int P, int S, int lh, int tpad, int nir, int xsh,
               int osh, int pair) {
  using V = Vec<T, C>;
  // span offsets: int in shared memory, 64-bit when read from device memory
  using O = std::conditional_t<kStaged, int, long long>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ib = 32 * M * nir;
  const long long ntiles = (n_out + (long long)Ib * P - 1) / ((long long)Ib * P);
  const long long qcmax = ((long long)(P - 1) * down) / up;
  // a tile's span offset 0 is x index I0*S - (S - 1) - tpad*S, the lowest
  // sample its lanes read
  const long long reach = (S - 1) + (long long)tpad * S;
  const int span = (int)((long long)(Ib - 1) * S + qcmax + reach + 1);
  const int span_pad = span + (span >> xsh) + 1;
  const int tst = tap_stride(tpad);
  const long long ntab = (long long)P * S * tst;
  T* hs = reinterpret_cast<T*>(smem_raw);
  V* xs0 = reinterpret_cast<V*>(hs + ((ntab + 2 * C - 1) / (2 * C)) * 2 * C);
  V* os = xs0 + 2 * span_pad;               // after two input buffers
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  if (kStaged) {          // hs[c][rho][t] = h[p_c + (rho + t*S)*up], or 0
    for (int cr = warp; cr < P * S; cr += nw) {
      const int c = cr / S, r = cr - c * S;
      const long long pc = ((long long)c * down) % up;
      for (int t = lane; t < tst; t += 32) {
        const long long l = r + (long long)t * S, k = pc + l * up;
        hs[(size_t)cr * tst + t] = (l < lh && k < ntaps) ? h[k] : T(0);
      }
    }
  }
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    // C == 1: plane blockIdx.z (selected, not indexed: a dynamic index
    // would put `pl` on the stack); C == 2: both planes, as the two parts of
    // one V, read and written as a V when `pair` (the second plane one
    // element after the first), else part by part
    const T* x = (blockIdx.z ? pl.in[1] : pl.in[0]) + (long long)row * in_rs;
    const T* x1 = pl.in[1] + (long long)row * in_rs;
    T* out = (blockIdx.z ? pl.out[1] : pl.out[0]) + (long long)row * out_rs;
    T* out1 = pl.out[1] + (long long)row * out_rs;
    const bool split = C == 2 && !pair;
    auto load_x = [&](long long gi) -> V {
      if (gi < 0 || gi >= n) return zero_vec<T, C>();
      if (split) {
        V v = zero_vec<T, C>();
        v.v[0] = x[gi * in_es];
        v.v[C - 1] = x1[gi * in_es];
        return v;
      }
      return *reinterpret_cast<const V*>(x + gi * in_es);
    };
    auto put = [&](long long j, const V& v) {
      if (split) {
        out[j * out_es] = v.v[0];
        out1[j * out_es] = v.v[C - 1];
      } else {
        *reinterpret_cast<V*>(out + j * out_es) = v;
      }
    };
    // the copies of a tile's span into buffer b (zeros outside [0, n))
    auto stage = [&](long long tile, int b) {
      if (tile < ntiles) {
        const long long lo = tile * Ib * S - reach;
        V* dst = xs0 + b * span_pad;
        for (int o = tid; o < span; o += nt) {
          const long long gi = lo + o;
          const bool ok = gi >= 0 && gi < n;
          const long long at = (ok ? gi : 0) * in_es;
          V* d = dst + o + (o >> xsh);
          if (split) {
            copy_async(&d->v[0], x + at, ok);
            copy_async(&d->v[C - 1], x1 + at, ok);
          } else {
            copy_async(d, reinterpret_cast<const V*>(x + at), ok);
          }
        }
      }
      copy_commit();
    };
    if (kStaged) {
      __syncthreads();                   // the previous row's reads are done
      stage(blockIdx.x, 0);
    }
    int buf = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long I0 = tile * Ib;
      const long long span_lo = I0 * S - reach;
      const V* xs = xs0 + buf * span_pad;
      if (kStaged) {
        // the other buffer's last reader and the output tile's last store
        // are done: copy the next tile while this one is computed
        __syncthreads();
        stage(tile + gridDim.x, buf ^ 1);
        copy_wait_all_but_one();
        __syncthreads();
      }
      auto X = [&](O o) -> V {
        if constexpr (kStaged) {
          return xs[o + (o >> xsh)];
        } else {
          return load_x(span_lo + o);
        }
      };
      for (int task = warp; task < P * nir; task += nw) {
        const int c = task % P, sub = task / P;
        const long long cd = (long long)c * down;
        const int pc = (int)(cd % up), qc = (int)(cd / up);
        const int i_rel = sub * 32 * M + lane * M;      // i0 - I0
        V acc[M];
#pragma unroll
        for (int u = 0; u < M; ++u) acc[u] = zero_vec<T, C>();
        for (int r = 0; r < S && r < lh; ++r) {
          // the class's taps l = r + t*S < lh, t < steps
          const int steps = (lh - r + S - 1) / S;
          const T* hr = hs + (size_t)(c * S + r) * tst;
          // the taps of steps t0 .. t0 + M - 1 (past the class's steps:
          // read, never used)
          T hv[M];
          auto taps_at = [&](int t0) {
            if constexpr (kStaged) {
              load_group<T, M>(hv, hr + t0);
            } else {
#pragma unroll
              for (int s = 0; s < M; ++s) {
                const long long k = pc + (r + (long long)(t0 + s) * S) * up;
                hv[s] = k < ntaps ? __ldg(h + k) : T(0);
              }
            }
          };
          // span offset of x[i0*S + q_c - rho] (d = 0); the window holds
          // d = u - t in slot (u - t) mod M
          const O ob = (O)((I0 + i_rel) * S + qc - r - span_lo);
          V w[M];
#pragma unroll
          for (int u = 0; u < M; ++u) w[u] = X(ob + (O)u * S);
          O o = ob - S;                                  // d = -1 next
          const int full = steps / M * M;
          // step s of a group: the sample d = -(t + 1) is loaded first, the
          // FMAs run, then it replaces d = M - 1 - t in slot M - 1 - s
          auto step = [&](int s) {
            const V nx = X(o);
            o -= S;
#pragma unroll
            for (int u = 0; u < M; ++u) {
              const V& xv = w[(u - s + M) % M];
#pragma unroll
              for (int k = 0; k < C; ++k)
                acc[u].v[k] = fma_t(hv[s], xv.v[k], acc[u].v[k]);
            }
            w[M - 1 - s] = nx;
          };
          for (int t0 = 0; t0 < full; t0 += M) {
            taps_at(t0);
#pragma unroll
            for (int s = 0; s < M; ++s) step(s);
          }
          // the class's last steps - full steps (uniform over the warp)
          if (full < steps) {
            taps_at(full);
#pragma unroll
            for (int s = 0; s < M; ++s)
              if (full + s < steps) step(s);
          }
        }
#pragma unroll
        for (int u = 0; u < M; ++u) {
          const int e = (i_rel + u) * P + c;           // offset in the tile
          if (kStaged) {
            os[e + (e >> osh)] = acc[u];
          } else {
            const long long j = I0 * P + e;
            if (j < n_out) put(j, acc[u]);
          }
        }
      }
      if (kStaged) {
        __syncthreads();
        const long long j0 = I0 * P;
        const long long left = n_out - j0;
        const int cnt = left < (long long)Ib * P ? (int)left : Ib * P;
        for (int e = tid; e < cnt; e += nt)
          put(j0 + e, os[e + (e >> osh)]);
      }
      buf ^= 1;
    }
  }
}

template <typename T, int C, int M>
int launch_window(const Planes<T>& pl, int groups, int rows, long long n,
                  long long in_rs, long long in_es, long long n_out,
                  long long out_rs, long long out_es, const T* h, int ntaps,
                  int up, int down, int nir, bool staged, int xsh, int osh,
                  cudaStream_t st) {
  const long long g = gcd_ll(up, down);
  const int P = (int)(up / g), S = (int)(down / g);
  const int lh = (int)((ntaps + (long long)up - 1) / up);
  const int tpad = (lh + S - 1) / S;            // steps of the longest class
  const long long Ib = 32LL * M * nir;
  const long long qcmax = ((long long)(P - 1) * down) / up;
  const long long span = (Ib - 1) * S + qcmax + (S - 1) + (long long)tpad * S
                         + 1;
  const long long ntab = (long long)P * S * tap_stride(tpad);
  const long long tile = Ib * P;
  const long long ntiles = (n_out + tile - 1) / tile;
  if (ntiles > 0x7fffffffLL || tile >= (1LL << 30) ||
      (staged && (span >= (1LL << 30) || ntab >= (1LL << 30))))
    return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)P * nir;
  const int threads = (int)(32 * (tasks < 16 ? tasks : 16));
  long long smem = 0;
  auto kernel = staged ? upfirdn_window<T, C, M, true>
                       : upfirdn_window<T, C, M, false>;
  if (staged) {
    smem = (long long)sizeof(T) * ((ntab + 2 * C - 1) / (2 * C) * 2 * C) +
           (long long)sizeof(Vec<T, C>) *
               (2 * (span + (span >> xsh) + 1) + (tile + (tile >> osh) + 1));
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // as many blocks as the card holds at once (each walks its tiles), no
  // more than there are tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int gy = rows < 65535 ? rows : 65535;
  const int gz = C == 2 ? 1 : groups;         // C == 2: both planes a block
  long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) /
                       ((long long)gy * gz);
  if (resident < 1) resident = 1;
  const long long blocks = ntiles < resident ? ntiles : resident;
  const dim3 grid((unsigned)blocks, (unsigned)gy, (unsigned)gz);
  // the two planes of one complex tensor: the second one element after the
  // first, even strides, V-aligned, so each sample moves as one V
  const size_t vb = sizeof(Vec<T, C>);
  const int pair = C == 2 && pl.in[1] == pl.in[0] + 1 &&
                   pl.out[1] == pl.out[0] + 1 &&
                   (size_t)pl.in[0] % vb == 0 && (size_t)pl.out[0] % vb == 0 &&
                   in_es % 2 == 0 && in_rs % 2 == 0 && out_es % 2 == 0 &&
                   out_rs % 2 == 0;
  kernel<<<grid, threads, (size_t)smem, st>>>(
      pl, h, ntaps, n, n_out, rows, in_rs, in_es, out_rs, out_es, up, down,
      P, S, lh, tpad, nir, xsh, osh, pair);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_m(const Planes<T>& pl, int groups, int rows, long long n,
             long long in_rs, long long in_es, long long n_out,
             long long out_rs, long long out_es, const T* h, int ntaps,
             int up, int down, int m, int nir, bool staged, int xsh, int osh,
             cudaStream_t st) {
#define PDSP_UPFIRDN_M(MM)                                                  \
  if (m == MM)                                                              \
    return launch_window<T, C, MM>(pl, groups, rows, n, in_rs, in_es, n_out, \
                                   out_rs, out_es, h, ntaps, up, down, nir,  \
                                   staged, xsh, osh, st);
  PDSP_UPFIRDN_M(4)
  PDSP_UPFIRDN_M(16)
#undef PDSP_UPFIRDN_M
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* in0, const void* in1, void* out0, void* out1,
           int groups, int rows, long long n, long long in_rs,
           long long in_es, long long n_out, long long out_rs,
           long long out_es, const void* h, int ntaps, int up, int down,
           int m, int nir, int staged, int comps, int xsh, int osh,
           void* stream) {
  if (groups < 1 || groups > 2 || rows < 1 || n < 1 || n_out < 1 ||
      ntaps < 1 || up < 1 || down < 1 || nir < 1 || comps < 1 ||
      comps > 2 || (comps == 2 && groups != 2) || xsh < 0 || xsh > 30 ||
      osh < 0 || osh > 30)
    return (int)cudaErrorInvalidValue;
  Planes<T> pl;
  pl.in[0] = static_cast<const T*>(in0);
  pl.in[1] = static_cast<const T*>(groups == 2 ? in1 : in0);
  pl.out[0] = static_cast<T*>(out0);
  pl.out[1] = static_cast<T*>(groups == 2 ? out1 : out0);
  const T* hp = static_cast<const T*>(h);
  cudaStream_t st = (cudaStream_t)stream;
  if (comps == 2) {                      // the float2 pair: float32 only
    if constexpr (sizeof(T) == 4)
      return launch_m<T, 2>(pl, groups, rows, n, in_rs, in_es, n_out,
                            out_rs, out_es, hp, ntaps, up, down, m, nir,
                            staged != 0, xsh, osh, st);
    return (int)cudaErrorInvalidValue;
  }
  return launch_m<T, 1>(pl, groups, rows, n, in_rs, in_es, n_out, out_rs,
                        out_es, hp, ntaps, up, down, m, nir, staged != 0, xsh,
                        osh, st);
}

// ---------------------------------------------- the first version, kept whole

constexpr int kV1Threads = 256;
constexpr int kR = 4;                     // outputs per thread, one per slab
constexpr int kSlabOutputs = 1024;        // outputs per slab aimed at
constexpr long long kV1SmemBudget = 96 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kV1Threads)
upfirdn_v1(Planes<float> pl, const float* __restrict__ h, int ntaps,
           long long n, long long n_out, int rows, long long in_row_stride,
           long long in_elem_stride, long long out_row_stride,
           long long out_elem_stride, int up, int down, int P, int S, int lh,
           int gp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);
  const int hlen = lh * up;
  float* xs = hs + hlen;

  const int tid = threadIdx.x;
  const int slab = gp * P;                                 // outputs per slab
  const long long j0 = (long long)blockIdx.x * kR * slab;  // period-aligned
  const long long q0 = (long long)blockIdx.x * kR * gp * S - (lh - 1);
  const int qcmax = (int)(((long long)(P - 1) * down) / up);
  const int span = (kR * gp - 1) * S + qcmax + lh;

  if (kStaged) {
    for (int i = tid; i < hlen; i += kV1Threads)
      hs[i] = i < ntaps ? h[i] : 0.f;
  }
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* x = (blockIdx.z ? pl.in[1] : pl.in[0]) +
                     (long long)row * in_row_stride;
    float* out = (blockIdx.z ? pl.out[1] : pl.out[0]) +
                 (long long)row * out_row_stride;
    if (kStaged) {
      __syncthreads();
      for (int t = tid; t < span; t += kV1Threads) {
        const long long gi = q0 + t;
        xs[t] = (gi >= 0 && gi < n) ? x[gi * in_elem_stride] : 0.f;
      }
      __syncthreads();
    }
    for (int w = tid; w < slab; w += kV1Threads) {
      const int c = w % P;
      const long long cd = (long long)c * down;
      const int p = (int)(cd % up);
      const int tb = (w / P) * S + (int)(cd / up) + (lh - 1);
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = 0.f;
      for (int l = 0; l < lh; ++l) {
        float hv;
        if (kStaged) {
          hv = hs[p + l * up];
        } else {
          const int k = p + l * up;
          hv = k < ntaps ? h[k] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int t = tb + r * gp * S - l;
          float xv;
          if (kStaged) {
            xv = xs[t];
          } else {
            const long long gi = q0 + t;
            xv = (gi >= 0 && gi < n) ? x[gi * in_elem_stride] : 0.f;
          }
          acc[r] = fmaf(hv, xv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long j = j0 + (long long)r * slab + w;
        if (j < n_out) out[j * out_elem_stride] = acc[r];
      }
    }
  }
}

}  // namespace

// in0/in1: the planes (in1 unused when groups == 1), each `rows` rows of n
// samples at the given row and element strides (in elements); out0/out1 the
// same for n_out outputs; h: ntaps real taps of the planes' type. The plan
// (ops/hopper/upfirdn.upfirdn_plan): m outputs a lane (4 or 16), nir warp
// rows a block, staged or not, comps (2: in0/out0 are the real parts of
// complex float32 planes whose imaginary parts follow each element, read
// and written as float2), and the pad shifts of the input and output tiles.
// Returns a cudaError_t.
extern "C" int pdsp_upfirdn_f32(const void* in0, const void* in1, void* out0,
                                void* out1, int groups, int rows, long long n,
                                long long in_row_stride,
                                long long in_elem_stride, long long n_out,
                                long long out_row_stride,
                                long long out_elem_stride, const void* h,
                                int ntaps, int up, int down, int m, int nir,
                                int staged, int comps, int xsh, int osh,
                                void* stream) {
  return launch<float>(in0, in1, out0, out1, groups, rows, n, in_row_stride,
                       in_elem_stride, n_out, out_row_stride, out_elem_stride,
                       h, ntaps, up, down, m, nir, staged, comps, xsh, osh,
                       stream);
}

extern "C" int pdsp_upfirdn_f64(const void* in0, const void* in1, void* out0,
                                void* out1, int groups, int rows, long long n,
                                long long in_row_stride,
                                long long in_elem_stride, long long n_out,
                                long long out_row_stride,
                                long long out_elem_stride, const void* h,
                                int ntaps, int up, int down, int m, int nir,
                                int staged, int comps, int xsh, int osh,
                                void* stream) {
  return launch<double>(in0, in1, out0, out1, groups, rows, n, in_row_stride,
                        in_elem_stride, n_out, out_row_stride,
                        out_elem_stride, h, ntaps, up, down, m, nir, staged,
                        comps, xsh, osh, stream);
}

// The first version (float32), for scripts/exp_upfirdn.py: the same
// arguments as pdsp_upfirdn_f32 without the plan; it picks its own slabs.
extern "C" int pdsp_upfirdn_v1_f32(const void* in0, const void* in1,
                                   void* out0, void* out1, int groups,
                                   int rows, long long n,
                                   long long in_row_stride,
                                   long long in_elem_stride, long long n_out,
                                   long long out_row_stride,
                                   long long out_elem_stride, const void* h,
                                   int ntaps, int up, int down,
                                   void* stream) {
  if (groups < 1 || groups > 2 || rows < 1 || n < 1 || n_out < 1 ||
      ntaps < 1 || up < 1 || down < 1)
    return (int)cudaErrorInvalidValue;
  const int g = (int)gcd_ll(up, down);
  const int P = up / g, S = down / g;
  const int lh = (ntaps + up - 1) / up;
  const long long qcmax = ((long long)(P - 1) * down) / up;
  auto span_of = [&](long long gp) { return (kR * gp - 1) * S + qcmax + lh; };
  auto smem_of = [&](long long gp) {
    return (long long)sizeof(float) * ((long long)lh * up + span_of(gp));
  };
  long long gp = kSlabOutputs / P > 1 ? kSlabOutputs / P : 1;
  while (gp > 1 && smem_of(gp) > kV1SmemBudget) gp /= 2;
  const bool staged = smem_of(gp) <= kV1SmemBudget;
  const long long slab = gp * P;
  if (slab * kR > (1LL << 30) || span_of(gp) > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_out + kR * slab - 1) / (kR * slab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Planes<float> pl;
  pl.in[0] = static_cast<const float*>(in0);
  pl.in[1] = static_cast<const float*>(groups == 2 ? in1 : in0);
  pl.out[0] = static_cast<float*>(out0);
  pl.out[1] = static_cast<float*>(groups == 2 ? out1 : out0);
  const dim3 grid((unsigned)blocks, (unsigned)(rows < 65535 ? rows : 65535),
                  (unsigned)groups);
  cudaStream_t s = (cudaStream_t)stream;
  const float* hp = static_cast<const float*>(h);
  if (staged) {
    const size_t smem = (size_t)smem_of(gp);
    cudaError_t err = cudaFuncSetAttribute(
        upfirdn_v1<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    upfirdn_v1<true><<<grid, kV1Threads, smem, s>>>(
        pl, hp, ntaps, n, n_out, rows, in_row_stride, in_elem_stride,
        out_row_stride, out_elem_stride, up, down, P, S, lh, (int)gp);
  } else {
    upfirdn_v1<false><<<grid, kV1Threads, 0, s>>>(
        pl, hp, ntaps, n, n_out, rows, in_row_stride, in_elem_stride,
        out_row_stride, out_elem_stride, up, down, P, S, lh, (int)gp);
  }
  return (int)cudaGetLastError();
}
