// Hopper median filter: scipy.signal.medfilt of a 1-D real signal (odd
// window k, zero-padded edges), bit-exact, on order-preserving unsigned keys.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/medfilt.py:_kernel.
// Each float maps to an unsigned key whose integer order is the float order
// (sign bit clear: set it; sign bit set: flip every bit), so -0.0 sorts below
// +0.0 and the zero padding is the key of +0.0. The median of a window is its
// key of rank m = k/2, mapped back to the float's exact bits.
//
// Tile route (ops/hopper/medfilt.medfilt_plan picks it and its tile width C,
// a power of two <= m + 1). A block owns NT = 256 consecutive outputs, one a
// thread, and stages the NT + k - 1 keys they read in shared memory. It cuts
// its outputs into tiles of C. The C windows of a tile share a core of
// K = k - C + 1 keys; output j of the tile adds C - 1 extra keys of the
// tile's two wings (the C - 1 - j left of the core from j on, and the first
// j right of it). Then
//
//   1. every tile's core is sorted once, by one warp in its registers: a
//      bitonic network over P = max(32, 2^ceil(log2 K)) <= 1024 keys padded
//      with the largest key, E = P/32 a lane, strides below E within a
//      lane and the rest by shuffle (warp_bitonic);
//   2. core keys below sorted index s = m - C + 1 lie below the median in any
//      window of the tile (at most C - 1 extras precede them) and those above
//      index m lie above it, so the median is the key of rank C - 1 among the
//      2C - 1 candidates a = core[s .. m] and the output's C - 1 extras;
//   3. that key is the largest candidate v with count(candidates < v) <= C-1,
//      counted in registers (a's sorted index stands in for its own count:
//      never below it, and exact for the first copy of each value).
//
// Radix route (a core of more than 1024 keys, e.g. k = 60001, or the plan's
// c = 0): the first version of this kernel, kept whole. Each output walks
// the 32 (64) key bits MSB first, keeping the largest key v with
// count(window keys < v) <= m; staged in shared memory when the NT + k - 1
// keys fit, else read from device memory (L1/L2), so any odd k runs.
//
// What bounds it on the H100: integer compare-and-select work, not HBM (8
// bytes an output, ~10 us at 4M). At k = 129 the radix route does 32*k =
// 4,128 compare-and-count steps an output; the tile route at C = 16 does 112
// compare-exchanges an output in the sort (P = 128: 28 bitonic steps of 64
// pairs a tile, shared by 16 outputs) and (C-1)(3C-2) = 690 compares in
// registers in the select. A first tile route sorted the cores in shared
// memory, all tiles of a block at once: 28 steps of 4 loads and stores a
// pair moved ~0.9 MB of shared memory a block, ~0.45 ms of the SMs' 128
// B/clk at 4M, most of its 0.656 ms (scripts/exp_medfilt.py); in registers
// the sort moves none.
// Templated on the key width: uint32 for float32, uint64 for float64. Indices
// into device memory are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNT = 256;                  // outputs (threads) per block
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t to_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ uint64_t to_key(double v) {
  const uint64_t u = (uint64_t)__double_as_longlong(v);
  return (u >> 63) ? ~u : (u | (1ull << 63));
}
__device__ __forceinline__ double from_key(uint64_t k) {
  return __longlong_as_double(
      (long long)((k >> 63) ? (k & ~(1ull << 63)) : ~k));
}

// keys of x[o0 - half + t], t < count, zero padding outside [0, n)
template <typename T, typename K>
__device__ __forceinline__ void stage_keys(const T* __restrict__ x, K* s,
                                           long long o0, int half, int count,
                                           long long n) {
  const K zero_key = to_key(T(0));
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const long long gi = o0 + t - half;
    s[t] = (gi >= 0 && gi < n) ? to_key(x[gi]) : zero_key;
  }
}

// ---------------------------------------------------------------- tile route

// One in-lane step of warp_bitonic: stride J < E, keys r and r | J of a
// lane (compile-time indices, so v stays in registers).
template <int J, typename K, int E>
__device__ __forceinline__ void lane_step(K (&v)[E], int lane, int size) {
  if constexpr (J < E) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & J) continue;
      const int e = lane * E + r;
      const bool up = size == 32 * E || (e & size) == 0;
      const K a = v[r], b = v[r | J];
      if ((a > b) == up) {
        v[r] = b;
        v[r | J] = a;
      }
    }
  }
}

// One step (merge size, stride j) of warp_bitonic on the keys of a lane.
template <typename K, int E>
__device__ __forceinline__ void bitonic_step(K (&v)[E], int lane, int size,
                                             int j) {
  if (j >= E) {                           // across lanes
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = lane * E + r;
      const bool up = size == 32 * E || (e & size) == 0;
      const K o = __shfl_xor_sync(0xffffffffu, v[r], j / E);
      const bool keep_min = ((e & j) == 0) == up;
      v[r] = keep_min ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
    }
    return;
  }
  switch (j) {
    case 1: lane_step<1>(v, lane, size); break;
    case 2: lane_step<2>(v, lane, size); break;
    case 4: lane_step<4>(v, lane, size); break;
    case 8: lane_step<8>(v, lane, size); break;
    default: lane_step<16>(v, lane, size); break;
  }
}

// Bitonic sort, ascending, of the P = 32*E keys a warp holds, lane l holding
// keys l*E .. l*E + E - 1 in v: compare key e with e ^ j, the lower one
// keeping the smaller where bit `size` of e is clear or at the last merge
// (ops/hopper/medfilt._bitonic_tiles). Strides below E stay in a lane's
// registers, the rest cross lanes by shuffle; no shared memory is touched.
// Unrolled whole up to E = 4 (P = 128, k <= 143 at C = 16): with the steps'
// strides and directions constants it ran 0.49 ms where the same sort in
// loops ran 0.64 ms at k = 129 (scripts/exp_medfilt.py); larger sorts keep
// the loops, which keeps the build to seconds.
template <typename K, int E>
__device__ __forceinline__ void warp_bitonic(K (&v)[E], int lane) {
  constexpr int P = 32 * E;
  if constexpr (E <= 4) {
#pragma unroll
    for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) bitonic_step(v, lane, size, j);
    }
  } else {
    for (int size = 2; size <= P; size <<= 1)
      for (int j = size >> 1; j > 0; j >>= 1) bitonic_step(v, lane, size, j);
  }
}

template <typename T, typename K, int C, int E>
__global__ void __launch_bounds__(kNT)
medfilt_tile(const T* __restrict__ x, T* __restrict__ out, long long n,
             int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* w = reinterpret_cast<K*>(smem_raw);            // kNT + k - 1 keys
  K* cand = w + kNT + k - 1;                        // kNT / C tiles of C
  constexpr int kTiles = kNT / C;
  const int half = k / 2, K_ = k - C + 1, s = half - C + 1;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long o0 = (long long)blockIdx.x * kNT;
  stage_keys<T, K>(x, w, o0, half, kNT + k - 1, n);
  __syncthreads();
  // a warp a tile: its core, padded with the largest key to 32*E, sorted
  // in registers; the candidates core[s .. s + C - 1] go to shared memory
  for (int tile = tid >> 5; tile < kTiles; tile += kNT / 32) {
    K v[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = lane * E + r;
      v[r] = e < K_ ? w[tile * C + C - 1 + e] : ~K(0);
    }
    warp_bitonic<K, E>(v, lane);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = lane * E + r - s;
      if (e >= 0 && e < C) cand[tile * C + e] = v[r];
    }
  }
  __syncthreads();
  const long long o = o0 + tid;
  if (o >= n) return;
  const int tile = tid / C, jj = tid - tile * C, tb = tile * C;
  K a[C], e[C > 1 ? C - 1 : 1];
#pragma unroll
  for (int i = 0; i < C; ++i) a[i] = cand[tb + i];
#pragma unroll
  for (int i = 0; i < C - 1; ++i)
    e[i] = w[tb + jj + i + (jj + i >= C - 1 ? K_ : 0)];
  K best = a[0];                 // a[0] passes: at most C - 1 keys below it
#pragma unroll
  for (int i = 1; i < C; ++i) {
    int lt = i;
#pragma unroll
    for (int q = 0; q < C - 1; ++q) lt += e[q] < a[i];
    if (lt <= C - 1 && a[i] > best) best = a[i];
  }
#pragma unroll
  for (int i = 0; i < C - 1; ++i) {
    int lt = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) lt += a[q] < e[i];
#pragma unroll
    for (int q = 0; q < C - 1; ++q) lt += e[q] < e[i];
    if (lt <= C - 1 && e[i] > best) best = e[i];
  }
  out[o] = from_key(best);
}

// --------------------------------------------------------------- radix route

template <typename T, typename K, bool kStaged>
__global__ void __launch_bounds__(kNT)
medfilt_radix(const T* __restrict__ x, T* __restrict__ out, long long n,
              int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const int half = k / 2;
  const int tid = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * kNT;
  const K zero_key = to_key(T(0));
  if (kStaged) {
    stage_keys<T, K>(x, s, o0, half, kNT + k - 1, n);
    __syncthreads();
  }
  const long long o = o0 + tid;
  if (o >= n) return;
  constexpr int kBits = 8 * sizeof(K);
  K acc = 0;
  for (int b = kBits - 1; b >= 0; --b) {
    const K cand = acc | ((K)1 << b);
    int cnt = 0;
    for (int t = 0; t < k; ++t) {
      K key;
      if (kStaged) {
        key = s[tid + t];
      } else {
        const long long gi = o + t - half;
        key = (gi >= 0 && gi < n) ? to_key(x[gi]) : zero_key;
      }
      cnt += key < cand;
    }
    if (cnt <= half) acc = cand;
  }
  out[o] = from_key(acc);
}

template <typename T, typename K, int C, int E>
cudaError_t launch_tile(const T* x, T* out, long long n, int k,
                        long long blocks, cudaStream_t st) {
  const size_t smem = sizeof(K) * ((size_t)kNT + k - 1 + kNT);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        medfilt_tile<T, K, C, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  medfilt_tile<T, K, C, E><<<(unsigned)blocks, kNT, smem, st>>>(x, out, n, k);
  return cudaGetLastError();
}

// the tile route at width C, its sort's keys a lane E = P / 32. Built for
// every E at the default width 16 (k >= 31); at the other widths for E = 1
// (the default for k < 31) and E = 4 (k = 129, the widths
// scripts/exp_medfilt.py compares); ops/hopper/medfilt.medfilt_plan knows.
template <typename T, typename K, int C>
cudaError_t launch_width(const T* x, T* out, long long n, int k, int E,
                         long long blocks, cudaStream_t st) {
  switch (E) {
    case 1: return launch_tile<T, K, C, 1>(x, out, n, k, blocks, st);
    case 4: return launch_tile<T, K, C, 4>(x, out, n, k, blocks, st);
  }
  if constexpr (C == 16) {
    switch (E) {
      case 2: return launch_tile<T, K, C, 2>(x, out, n, k, blocks, st);
      case 8: return launch_tile<T, K, C, 8>(x, out, n, k, blocks, st);
      case 16: return launch_tile<T, K, C, 16>(x, out, n, k, blocks, st);
      case 32: return launch_tile<T, K, C, 32>(x, out, n, k, blocks, st);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename K>
cudaError_t launch_radix(const T* x, T* out, long long n, int k,
                         long long blocks, cudaStream_t st) {
  const size_t smem = sizeof(K) * ((size_t)kNT + k - 1);
  if (smem <= kMaxSmem) {                 // the block's keys fit: staged
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          medfilt_radix<T, K, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    medfilt_radix<T, K, true><<<(unsigned)blocks, kNT, smem, st>>>(x, out, n,
                                                                   k);
  } else {
    medfilt_radix<T, K, false><<<(unsigned)blocks, kNT, 0, st>>>(x, out, n,
                                                                 k);
  }
  return cudaGetLastError();
}

template <typename T, typename K>
int launch(const void* xv, void* outv, long long n, int k, int c,
           void* stream) {
  if (n < 1 || k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kNT - 1) / kNT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  if (c == 0) return (int)launch_radix<T, K>(x, out, n, k, blocks, st);
  if (c > k / 2 + 1) return (int)cudaErrorInvalidValue;
  int P = 32;                             // the sort's keys: a warp's lanes
  while (P < k - c + 1) P <<= 1;
  const int E = P / 32;
  switch (c) {
    case 1: return (int)launch_width<T, K, 1>(x, out, n, k, E, blocks, st);
    case 2: return (int)launch_width<T, K, 2>(x, out, n, k, E, blocks, st);
    case 4: return (int)launch_width<T, K, 4>(x, out, n, k, E, blocks, st);
    case 8: return (int)launch_width<T, K, 8>(x, out, n, k, E, blocks, st);
    case 16: return (int)launch_width<T, K, 16>(x, out, n, k, E, blocks, st);
    case 32: return (int)launch_width<T, K, 32>(x, out, n, k, E, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n,) contiguous; out: (n,) of the same type; k odd; c: the tile width
// of ops/hopper/medfilt.medfilt_plan (1, 2, 4, 8, 16 or 32, at most k/2 + 1,
// its core of k - c + 1 keys at most 1024), or 0 for the radix route. Returns a
// cudaError_t.
extern "C" int pdsp_medfilt_f32(const void* x, void* out, long long n, int k,
                                int c, void* stream) {
  return launch<float, uint32_t>(x, out, n, k, c, stream);
}

extern "C" int pdsp_medfilt_f64(const void* x, void* out, long long n, int k,
                                int c, void* stream) {
  return launch<double, uint64_t>(x, out, n, k, c, stream);
}
