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
// Design. C is a complex GEMM (nb x K) @ (K x k) on the tensor cores at f32
// grade, in 3xTF32: every f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, round to nearest, ties away), and each real
// product is taken as lo*hi + hi*lo + hi*hi with f32 accumulation, the
// dropped lo*lo term ~2^-22 of it. A complex 8-deep step is four real
// products, twelve wgmma.m64n64k8 tf32 instructions of one warpgroup; the
// products with -Ai*Bi negate A in the instruction (imm-scale-a = -1).
// A stage is 32 deep: 48 instructions.
//
//   B (Tfold) is split once, at plan build (ops/hopper/group_caf.
//     tf32_planes), padded with zeros to whole 32 x 64 tiles and stored as
//     the shared-memory image the wgmma descriptors read: four planes (re
//     hi, re lo, im hi, im lo), each K-major without swizzle, core matrices
//     of 8 bins x 4 depths (16 bytes a row), 128 bytes apart along the
//     depth and 1 KB apart along the bins. A stage copies its 32 KB tile
//     with 16-byte cp.async; the kernel never re-splits it.
//   A is the Hankel gather rx[offs[b] + starts[g] + t], read in place
//     through each shift's own int64 offset (uniform sweeps and shift lists
//     are the same launch) with 8-byte cp.async copies (a row start is only
//     float2-aligned) into a two-stage shared-memory ring; samples outside
//     rx, rows past nb and depth past K read as zero (the cp.async zero
//     fill). Each warp forms its 16 rows' wgmma A fragments (the mma
//     m16n8k8 layout) from shared memory, a row stride of BK + 4 float2 (4
//     mod 16) keeping a half-warp's loads on 16 distinct bank pairs, and
//     splits them into hi/lo in registers.
//   The tensor cores' f32 accumulation does not round to nearest: an
//     mma.sync version of this kernel that kept one accumulator over a
//     slab's 1536 steps lost ~n*2^-24 on the coherent peak (4.6e-5 on the
//     QF^2 scale at the bench cell against the f32 twin, past the 4e-6
//     gate). So each stage's 48 instructions start fresh accumulators
//     (scale-d = 0), and after wgmma.wait_group those are added to the
//     running sums by ordinary (round-to-nearest) f32 adds: ~5e-7 there
//     with 16-deep stages, ~7.5e-7 with 32, which ran ~10% faster on an
//     H100 (scripts/exp_group_caf.py --variants).
//   A block is one warpgroup owning 64 shifts x 64 bins, two blocks an SM
//     (202 registers, 101 KB of shared memory each), so one block's adds,
//     copies and fragment loads overlap the other's products. At the bench
//     geometry (nb = 1024, k = 128) the output has 32 such tiles for 132
//     SMs, so the depth K is split into slabs on grid z: each block writes
//     its slab's partial C to a complex f32 scratch (splits, nb, k), and
//     group_caf_reduce sums the slabs in slab order, then squares. The
//     launcher chooses the split (choose_splits) from the occupancy of
//     group_caf_wg on this device, within the scratch the caller gives it.
//     For a given device the split, and so the order of every sum, is
//     fixed: the result does not change from run to run.
//
// What bounds it on the H100: tensor-core arithmetic. nb*K*k complex MACs
// (4.3e9, 34.4 GFLOP in f32 at the bench geometry) are 103 GFLOP of TF32
// products at three passes, 0.21 ms at the 495 TFLOP/s dense TF32 peak,
// against ~35 MB of rx and output and the 4x larger split Tfold (64 MB at
// the bench geometry, read from HBM once and by the 16 row tiles of a slab
// from L2). The f32 CUDA-core version this replaced ran 28 TFLOP/s, under
// the 67 TFLOP/s f32 peak that bounds any CUDA-core design; an mma.sync
// m16n8k8 version of this kernel ran it at ~150 TFLOP/s on an H100.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The depth of a stage and of the ring; scripts/exp_group_caf.py
// --variants builds this source with other values (-D) to compare them.
#ifndef GROUP_CAF_BK
#define GROUP_CAF_BK 32
#endif
#ifndef GROUP_CAF_STAGES
#define GROUP_CAF_STAGES 2
#endif

constexpr int BM = 64, BN = 64, BK = GROUP_CAF_BK;   // block tile, depth
constexpr int STAGES = GROUP_CAF_STAGES, THREADS = 128;   // one warpgroup
constexpr int AS = BK + 4;                 // A row stride (float2), 4 mod 16
constexpr int NT = 256;                    // reduce block
constexpr int PLANE = BN * BK;             // floats of one plane a stage

struct Smem {
  float b[STAGES][4][PLANE];            // re hi, re lo, im hi, im lo
  float2 a[STAGES][BM][AS];
  long long offs[BM];
};
constexpr size_t SMEM_BYTES = sizeof(Smem);

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// wgmma descriptor of one plane of a stage: K-major, no swizzle, core
// matrices of 8 rows x 16 bytes, LBO = 128 bytes between core matrices
// along the depth, SBO = BK/4 * 128 bytes between 8-row groups along the
// bins
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((BK / 4 * 128) >> 4) << 32);
}

// Ties a register to this point, so that the compiler neither reads an
// asynchronous wgmma's accumulator early nor reuses its A registers before
// wgmma.wait_group.
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (+)= (scale_a * a) (64 x 8, registers) * b (8 x 64, shared memory,
// descriptor), tf32 in, f32 accumulate; scale_d = 0 starts a fresh sum
template <int ScaleA>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(ScaleA));
}

// grid (ceil(nb/BM), kp/BN, splits): slab z covers depth [z*slab,
// min((z+1)*slab, Kp)) of the padded depth Kp (a multiple of BK); its
// partial C goes to part[z]. planes: the split Tfold, (Kp/BK, kp/BN) tiles
// of 4 planes x PLANE floats; kp the padded bins (a multiple of BN).
__global__ void __launch_bounds__(THREADS, 2)
group_caf_wg(const float2* __restrict__ rx, long long n_rx,
             const long long* __restrict__ offs,
             const long long* __restrict__ starts,
             const float4* __restrict__ planes, float2* __restrict__ part,
             int nb, int m, int K, int Kp, int k, int kp, int slab) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int kbeg = z * slab;
  const int nk = (min(slab, Kp - kbeg)) / BK;
  const int nb64 = kp / BN;

  for (int r = tid; r < BM; r += THREADS)
    sm.offs[r] = m0 + r < nb ? offs[m0 + r] : -(1LL << 62);
  __syncthreads();

  // this thread's A copies: column c of rows rb + 4*i, i < 16, of a stage
  const int c = tid & (BK - 1), rb = tid / BK;
  int ld_kk = kbeg + c;                     // depth of its next copy
  int ld_g = ld_kk / m, ld_t = ld_kk - ld_g * m;

  auto load_stage = [&](int slot, int kt) {
    const bool kin = ld_kk < K;
    const long long base = kin ? starts[ld_g] + ld_t : 0;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int r = rb + (THREADS / BK) * i;
      const long long idx = sm.offs[r] + base;
      const bool ok = kin && idx >= 0 && idx < n_rx;
      cp_async8(&sm.a[slot][r][c], ok ? rx + idx : rx, ok);
    }
    ld_kk += BK;
    ld_t += BK;
    while (ld_t >= m) {
      ld_t -= m;
      ++ld_g;
    }
    // B: the stage's 32 KB tile, contiguous
    const float4* src = planes +
        ((size_t)((kbeg + kt * BK) / BK) * nb64 + n0 / BN) * (4 * PLANE / 4);
    float4* dst = reinterpret_cast<float4*>(&sm.b[slot][0][0]);
#pragma unroll
    for (int i = 0; i < 4 * PLANE / 4 / THREADS; ++i)
      cp_async16(dst + tid + THREADS * i, src + tid + THREADS * i);
  };

  float acc_re[32], acc_im[32], t_re[32], t_im[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc_re[e] = acc_im[e] = t_re[e] = t_im[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    // the copies' writes, visible to the wgmma (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_commit();
    const int slot = kt % STAGES;
    uint32_t rh[BK / 8][4], rl[BK / 8][4], ih[BK / 8][4], il[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 x = sm.a[slot][16 * warp + gid + (q & 1) * 8]
                             [8 * s + tig + (q >> 1) * 4];
        split(x.x, rh[s][q], rl[s][q]);
        split(x.y, ih[s][q], il[s][q]);
      }
    }
    const uint64_t brh = desc(sm.b[slot][0]), brl = desc(sm.b[slot][1]);
    const uint64_t bih = desc(sm.b[slot][2]), bil = desc(sm.b[slot][3]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      // the s-th 8 depths: two core matrices (256 bytes) on; fresh sums at 0
      const uint64_t o = (uint64_t)(256 * s) >> 4;
      const int f = s;
      // re = Ar*Br - Ai*Bi, im = Ar*Bi + Ai*Br, the small terms first
      wgmma_tf32<1>(t_re, rl[s], brh + o, f);
      wgmma_tf32<1>(t_im, rl[s], bih + o, f);
      wgmma_tf32<1>(t_re, rh[s], brl + o, 1);
      wgmma_tf32<1>(t_im, rh[s], bil + o, 1);
      wgmma_tf32<-1>(t_re, il[s], bih + o, 1);
      wgmma_tf32<1>(t_im, il[s], brh + o, 1);
      wgmma_tf32<-1>(t_re, ih[s], bil + o, 1);
      wgmma_tf32<1>(t_im, ih[s], brl + o, 1);
      wgmma_tf32<1>(t_re, rh[s], brh + o, 1);
      wgmma_tf32<1>(t_im, rh[s], bih + o, 1);
      wgmma_tf32<-1>(t_re, ih[s], bih + o, 1);
      wgmma_tf32<1>(t_im, ih[s], brh + o, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        keep(rh[s][q]); keep(rl[s][q]); keep(ih[s][q]); keep(il[s][q]);
      }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      keep(t_re[e]);
      keep(t_im[e]);
      acc_re[e] += t_re[e];
      acc_im[e] += t_im[e];
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int b = m0 + 16 * warp + gid + 8 * ((e >> 1) & 1);
    const int f = n0 + 8 * (e >> 2) + 2 * tig + (e & 1);
    if (b < nb && f < k)
      part[((size_t)z * nb + b) * k + f] = make_float2(acc_re[e], acc_im[e]);
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

// The shallowest slab worth a block: 16 stages.
constexpr int MIN_SLAB = 16 * BK;

// Slabs of the padded depth Kp: as many as keep the output tiles times the
// slabs within one wave of resident group_caf_wg blocks on this device (a
// second, part-empty wave would cost a whole slab's time), each slab at
// least MIN_SLAB deep, all within `cap` complex elements of scratch. At the
// bench geometry: two blocks an SM, 32 tiles, so 8 slabs = 256 blocks on
// 132 SMs.
cudaError_t choose_splits(int nb, int k, int Kp, long long cap,
                          int* splits) {
  // resident blocks an SM and SMs, asked once per device: the queries cost
  // tens of microseconds, longer than a small launch
  static int known[64][2];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev][0] > 0) {
    per_sm = known[dev][0];
    sms = known[dev][1];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(group_caf_wg,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, group_caf_wg, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (dev < 64) {
      known[dev][1] = sms;
      known[dev][0] = per_sm;
    }
  }
  const long long one = (long long)nb * k;
  if (cap < one) return cudaErrorInvalidValue;
  const long long tiles =
      (long long)((nb + BM - 1) / BM) * ((k + BN - 1) / BN);
  long long s = (long long)per_sm * sms / tiles;
  s = std::min({s, (long long)(Kp / MIN_SLAB), cap / one, 65535LL});
  *splits = (int)std::max(1LL, s);
  return cudaSuccess;
}

}  // namespace

// rx: (n_rx,) complex64; offs: (nb,) int64; starts: (g,) int64; planes: the
// split Tfold of ops/hopper/group_caf.tf32_planes for K = g*m rows padded
// to Kp = a multiple of BK and kp (a multiple of 64) >= k bins; part:
// complex64 scratch of `part_cap` elements, at least nb*k; out: (nb, k)
// float32. Writes the split it chose to *splits_out. Returns a cudaError_t.
extern "C" int pdsp_group_caf(const void* rx, long long n_rx, const void* offs,
                              int nb, const void* starts, int g, int m,
                              const void* planes, int k, int kp, void* part,
                              long long part_cap, void* out, void* splits_out,
                              void* stream) {
  if (nb <= 0 || g <= 0 || m <= 0 || k <= 0 || n_rx <= 0 || kp < k ||
      kp % BN != 0 || (long long)g * m > 0x7fffffffLL - BK ||
      kp / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const int K = g * m;
  const int Kp = (K + BK - 1) / BK * BK;
  int splits = 1;
  cudaError_t err = choose_splits(nb, k, Kp, part_cap, &splits);
  if (err != cudaSuccess) return (int)err;
  // slabs a whole number of stages deep, none of them empty
  const int slab = ((Kp + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (Kp + slab - 1) / slab;
  *static_cast<int*>(splits_out) = splits;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((nb + BM - 1) / BM, kp / BN, splits);
  group_caf_wg<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const float2*>(rx), n_rx,
      static_cast<const long long*>(offs),
      static_cast<const long long*>(starts),
      static_cast<const float4*>(planes), static_cast<float2*>(part), nb, m,
      K, Kp, k, kp, slab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)nb * k;
  group_caf_reduce<<<(unsigned)((count + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const float2*>(part), static_cast<float*>(out), count,
      splits);
  return (int)cudaGetLastError();
}
