// Hopper median filter: scipy.signal.medfilt of a 1-D real signal (odd
// window k, zero-padded edges), bit-exact, by a radix select on
// order-preserving unsigned keys.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/medfilt.py:_kernel
// and keeps its method. Each float maps to an unsigned key whose integer
// order is the float order (sign bit clear: set it; sign bit set: flip every
// bit), so -0.0 sorts below +0.0 and the zero padding is the key of +0.0.
// The median of a window is the largest key v with count(keys < v) <= k/2,
// found MSB first in one step per key bit; the key maps back to the float's
// exact bits.
//
// Design (simple first version). A block owns kC = 256 consecutive outputs,
// one per thread, and stages the kC + k - 1 keys they read in shared memory;
// thread i walks the bit steps over keys i .. i + k - 1, so at each step the
// warp reads consecutive words (no bank conflicts). Windows too long for
// shared memory take the unstaged variant, which forms the keys from device
// memory in the loop (through L1/L2), so any odd k runs. Templated on the
// key width: 32 steps over uint32 keys for float32, 64 over uint64 for
// float64. Indices into device memory are 64-bit.
//
// What bounds it on the H100: 32*k key compares per output (4M outputs at
// k = 129: 1.7e10 compare-and-count pairs, about 2.4 ms at the SMs' integer
// and shared-load rates) against 8 bytes of traffic per output (~10 us), so
// it is bound by integer issue and shared-memory loads, not by HBM. A
// select that shares its prefix steps between neighbouring windows is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;                   // outputs (threads) per block
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

template <typename T, typename K, bool kStaged>
__global__ void __launch_bounds__(kC)
medfilt_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
               int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const int half = k / 2;
  const int tid = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * kC;
  const K zero_key = to_key(T(0));
  if (kStaged) {
    for (int t = tid; t < kC + k - 1; t += kC) {
      const long long gi = o0 + t - half;
      s[t] = (gi >= 0 && gi < n) ? to_key(x[gi]) : zero_key;
    }
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

template <typename T, typename K>
int launch(const void* x, void* out, long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kC - 1) / kC;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const size_t smem = sizeof(K) * ((size_t)kC + k - 1);
  if (smem <= kMaxSmem) {                 // the block's keys fit: staged
    cudaError_t err = cudaFuncSetAttribute(
        medfilt_kernel<T, K, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    medfilt_kernel<T, K, true><<<(unsigned)blocks, kC, smem, s>>>(xp, op, n,
                                                                   k);
  } else {
    medfilt_kernel<T, K, false><<<(unsigned)blocks, kC, 0, s>>>(xp, op, n, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n,) contiguous; out: (n,) of the same type; k odd. The keys are staged
// in shared memory when (256 + k - 1) of them fit. Returns a cudaError_t.
extern "C" int pdsp_medfilt_f32(const void* x, void* out, long long n, int k,
                                void* stream) {
  return launch<float, uint32_t>(x, out, n, k, stream);
}

extern "C" int pdsp_medfilt_f64(const void* x, void* out, long long n, int k,
                                void* stream) {
  return launch<double, uint64_t>(x, out, n, k, stream);
}
