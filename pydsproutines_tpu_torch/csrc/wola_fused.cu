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
// for r in [0, rows), a, k in [0, N), b in [0, B), B = len(h)/N.
//
// Design (simple first version). One block owns R consecutive output rows.
// It stages in shared memory the taps h, the N-point twiddle table and the
// R + B input rows the fold reaches back to (rows before 0 are zeros), so
// every input sample leaves device memory once per block and every output
// is stored once, coalesced. Threads then fold over (row, phase): with
// xq = x viewed as (rows, N), x[(r-b)N - a] is xq[r-b, 0] for a == 0 and
// xq[r-b-1, N-a] for a >= 1. The folded rows stay in shared memory for the
// IDFT, which threads compute over (row, channel) as a direct N-point sum
// against the shared twiddle table (index a*k mod N kept as a running sum).
// The TPU kernel's pair-row layout existed for the TPU's 128-lane tiles and
// is not carried over. Any B >= 1 and N whose tile fits shared memory.
//
// What bounds it on the H100: the memory floor is 16 bytes per sample
// (8 in, 8 out: 128 MB at 8M samples, ~40 us at 3.35 TB/s), so the kernel is
// designed around one read and one write. The arithmetic is 2B FMAs per
// sample for the fold and 4N for the direct IDFT in f32 on the CUDA cores:
// at N = 64, B = 32 that is 320 FMAs per sample, about as long at the
// f32 peak as the memory floor. A factored IDFT or tensor cores would put
// the kernel back under the memory floor; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void cmac(float2& c, float2 a, float2 b) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
}

// Shared-memory layout of one block: taps (L floats, padded to an even count
// so the float2 arrays after it stay 8-byte aligned), the (R + B, N) input
// tile, the (R, N) folded rows and the N twiddles.
__host__ __device__ inline size_t taps_floats(int n, int nb) {
  return ((size_t)n * nb + 1) & ~(size_t)1;
}

inline size_t smem_bytes(int n, int nb, int r) {
  return 4 * taps_floats(n, nb) +
         8 * ((size_t)(r + nb) * n + (size_t)r * n + n);
}

__global__ void __launch_bounds__(kThreads)
wola_fused_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
                  const float2* __restrict__ tw, float2* __restrict__ out,
                  int rows, int n, int nb, int rpb) {
  extern __shared__ float smem[];
  float* h = smem;
  float2* tile = reinterpret_cast<float2*>(smem + taps_floats(n, nb));
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

}  // namespace

// x: (>= rows*n,) complex64; taps: (nb*n,) float32; tw: (n,) complex64 with
// tw[m] = exp(+2*pi*i*m/n); out: (rows, n) complex64. Returns a cudaError_t.
extern "C" int pdsp_wola_fused(const void* x, const void* taps, const void* tw,
                               void* out, int rows, int n, int nb,
                               void* stream) {
  if (rows <= 0 || n <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  // largest row tile (<= 32) whose shared-memory footprint fits the SM
  int rpb = 32;
  while (rpb > 1 && smem_bytes(n, nb, rpb) > (size_t)kMaxSmem) rpb /= 2;
  const size_t smem = smem_bytes(n, nb, rpb);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wola_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + rpb - 1) / rpb;
  wola_fused_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(taps),
      static_cast<const float2*>(tw), static_cast<float2*>(out), rows, n, nb,
      rpb);
  return (int)cudaGetLastError();
}
