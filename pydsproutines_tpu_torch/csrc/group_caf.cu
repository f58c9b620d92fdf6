// Hopper group cross-correlation CAF (the group-xcorr CZT sweep).
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/group_caf.py:_kernel
// (and its tone-dot formulation group_caf_tonedot, which computes the same
// contract). For each shift b, with K = G*m,
//
//   C[b, f] = sum_{kk < K} rx[offs[b] + starts[kk / m] + kk % m] * T[kk, f],
//   out[b, f] = |C[b, f]|^2,
//
// where T = Tfold (K, k) is the conjugated template times the CZT tone bank
// times the per-group phase, folded on the host in float64. The DFT against
// the tone bank is this product: no FFT or BLAS library is involved.
//
// Design (simple first version). C is a complex GEMM (nb x K) @ (K x k)
// whose A operand is a Hankel gather from rx, read in place by the
// GroupWindows loader through each shift's own int64 offset (uniform sweeps
// and shift lists are the same launch), never materialised; samples past the
// end of rx read as zero (their T rows are the zero padding of short
// groups). The product is cgemm.cuh's 64 x 64 x 16 f32 complex tile. At the
// bench geometry (nb = 1024, k = 128) the output has only 32 such tiles for
// 132 SMs, so the depth K is split into slabs on grid z (group_caf_partial):
// each block writes its slab's partial C to a complex f32 scratch (splits,
// nb, k), and group_caf_reduce sums the slabs in slab order, then squares.
// The launcher chooses the split (choose_splits) from the occupancy of
// group_caf_partial on this device, within the scratch the caller gives it.
// For a given device the split, and so the order of every sum, is fixed: the
// result does not change from run to run.
//
// What bounds it on the H100: f32 arithmetic. nb*K*k complex MACs (4.3e9,
// 34 GFLOP at the bench geometry, ~0.51 ms at 67 TFLOP/s) against ~35 MB of
// Tfold, rx and output (~0.01 ms at 3.35 TB/s). The TPU kernel ran bf16
// operands (rel err ~1e-2); here everything is f32, so there is no
// reduced-precision tier to re-check. Tensor cores (3xTF32) are later work.

#include <algorithm>

#include "cgemm.cuh"

namespace {

// A[r, c] = rx[offs[r] + starts[g] + t], kk = kbeg + c = g*m + t, for the
// slab's columns c < klen; zero outside the slab, past nb rows, and outside
// rx.
struct GroupWindows {
  const float2* rx;
  long long n_rx;
  const long long* offs;
  const long long* starts;
  int nb, m, kbeg, klen;
  __device__ __forceinline__ float2 operator()(int r, int c) const {
    if (r >= nb || c >= klen) return make_float2(0.f, 0.f);
    const int kk = kbeg + c;
    const int g = kk / m;
    const long long i = offs[r] + starts[g] + (kk - g * m);
    return (i >= 0 && i < n_rx) ? rx[i] : make_float2(0.f, 0.f);
  }
};

// grid (ceil(nb/TM), ceil(k/TN), splits): slab z covers depth
// [z*slab, min((z+1)*slab, K)); its partial C goes to scratch[z].
__global__ void __launch_bounds__(NT)
group_caf_partial(const float2* __restrict__ rx, long long n_rx,
                  const long long* __restrict__ offs,
                  const long long* __restrict__ starts,
                  const float2* __restrict__ tfold, float2* __restrict__ part,
                  int nb, int m, int K, int k, int slab) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const int z = blockIdx.z;
  const int kbeg = z * slab;
  const int klen = min(slab, K - kbeg);
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  float2 acc[4][4];
  cgemm_tile(GroupWindows{rx, n_rx, offs, starts, nb, m, kbeg, klen},
             Dense{tfold + (size_t)kbeg * k, klen, k}, klen, m0, n0, As, Bs,
             acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = n0 + tx + 16 * j;
      if (b < nb && f < k) part[((size_t)z * nb + b) * k + f] = acc[i][j];
    }
  }
}

// out[i] = |sum_z part[z, i]|^2 for i < nb*k, slabs summed in order.
__global__ void __launch_bounds__(NT)
group_caf_reduce(const float2* __restrict__ part, float* __restrict__ out,
                 long long count, int splits) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= count) return;
  float2 s = part[i];
  for (int z = 1; z < splits; ++z) {
    const float2 v = part[(size_t)z * count + i];
    s.x += v.x;
    s.y += v.y;
  }
  out[i] = s.x * s.x + s.y * s.y;
}

// The shallowest slab worth a block: 16 steps of the TK-deep tile.
constexpr int MIN_SLAB = 16 * TK;

// Slabs of the depth K: as many as keep the output tiles times the slabs
// within one wave of resident group_caf_partial blocks on this device (a
// second, part-empty wave would cost a whole slab's time), each slab at least
// MIN_SLAB deep, all within `cap` complex elements of scratch. At the bench
// geometry: 4 blocks per SM (64 registers x 256 threads), 32 tiles, so 16
// slabs = 512 blocks on 132 SMs.
cudaError_t choose_splits(int nb, int k, int K, long long cap, int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, group_caf_partial, NT, 0);
  if (err != cudaSuccess) return err;
  const long long one = (long long)nb * k;
  if (cap < one) return cudaErrorInvalidValue;
  const long long tiles =
      (long long)((nb + TM - 1) / TM) * ((k + TN - 1) / TN);
  long long s = (long long)per_sm * sms / tiles;
  s = std::min({s, (long long)(K / MIN_SLAB), cap / one, 65535LL});
  *splits = (int)std::max(1LL, s);
  return cudaSuccess;
}

}  // namespace

// rx: (n_rx,) complex64; offs: (nb,) int64; starts: (g,) int64; tfold:
// (g*m, k) complex64 row-major; part: complex64 scratch of `part_cap`
// elements, at least nb*k; out: (nb, k) float32. Writes the split it chose
// to *splits_out. Returns a cudaError_t.
extern "C" int pdsp_group_caf(const void* rx, long long n_rx, const void* offs,
                              int nb, const void* starts, int g, int m,
                              const void* tfold, int k, void* part,
                              long long part_cap, void* out, void* splits_out,
                              void* stream) {
  if (nb <= 0 || g <= 0 || m <= 0 || k <= 0 || n_rx <= 0 ||
      (long long)g * m > 0x7fffffffLL || (k + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const int K = g * m;
  int splits = 1;
  cudaError_t err = choose_splits(nb, k, K, part_cap, &splits);
  if (err != cudaSuccess) return (int)err;
  // slabs a whole number of tiles deep, none of them empty
  const int slab = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  splits = (K + slab - 1) / slab;
  *static_cast<int*>(splits_out) = splits;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((nb + TM - 1) / TM, (k + TN - 1) / TN, splits);
  group_caf_partial<<<grid, NT, 0, st>>>(
      static_cast<const float2*>(rx), n_rx,
      static_cast<const long long*>(offs),
      static_cast<const long long*>(starts),
      static_cast<const float2*>(tfold), static_cast<float2*>(part), nb, m, K,
      k, slab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)nb * k;
  group_caf_reduce<<<(unsigned)((count + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const float2*>(part), static_cast<float*>(out), count,
      splits);
  return (int)cudaGetLastError();
}
