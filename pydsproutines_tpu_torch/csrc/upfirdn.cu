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
// Design (simple first version). Outputs come in phase periods of P = up/g
// outputs that consume S = down/g inputs (g = gcd(up, down)); output i*P + c
// has phase p = (c*down) mod up and reads x[i*S + (c*down) div up - l]. A
// block owns kR slabs of gp periods (gp*P outputs each, ~1024); a thread
// takes one output in each slab, all of the same phase, so it loads each tap
// once for kR FMAs. Consecutive threads hold consecutive outputs, so their
// shared-memory reads of x fall on consecutive (or equal) words. The block
// stages in shared memory the input span its slabs read (zeros outside
// [0, n)) and the taps; the launcher halves gp until the two fit kSmemBudget,
// and when one period per slab still does not fit it launches the unstaged
// variant, which reads both through L1/L2 with the same indexing, so any
// tap length runs. Several rows (grid y) and one or two
// planes (grid z, e.g. the real and imaginary parts of a complex tensor read
// in place at element stride 2, or two separate float planes) share a
// launch. Indices into device memory are 64-bit.
//
// What bounds it on the H100: at the JAX bench's chain (4,194,304 complex
// samples, up 5, down 4, 730 combined taps, Lh = 146) the two planes need
// 1.5e9 FMAs against 75 MB of traffic (~22 us at 3.35 TB/s), so it is bound
// by the FMAs and the 1.25 shared-memory loads each costs (kR = 4), not by
// HBM. Tensor-core band products, as the TPU kernel's MXU dots, are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 4;                     // outputs per thread, one per slab
constexpr int kSlabOutputs = 1024;        // outputs per slab aimed at
// shared memory a staged block may take: small enough for several blocks
// per SM at the chain's geometry, far below the 227 KB limit
constexpr long long kSmemBudget = 96 * 1024;

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

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
upfirdn_kernel(Planes<T> pl, const T* __restrict__ h, int ntaps,
               long long n, long long n_out, int rows,
               long long in_row_stride, long long in_elem_stride,
               long long out_row_stride, long long out_elem_stride,
               int up, int down, int P, int S, int lh, int gp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);
  const int hlen = lh * up;
  T* xs = hs + hlen;

  const int tid = threadIdx.x;
  const int slab = gp * P;                                 // outputs per slab
  const long long j0 = (long long)blockIdx.x * kR * slab;  // period-aligned
  const long long q0 = (long long)blockIdx.x * kR * gp * S - (lh - 1);
  const int qcmax = (int)(((long long)(P - 1) * down) / up);
  const int span = (kR * gp - 1) * S + qcmax + lh;

  if (kStaged) {
    for (int i = tid; i < hlen; i += kThreads) hs[i] = i < ntaps ? h[i] : T(0);
  }
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    // selected, not indexed: a dynamic index would put `pl` on the stack
    const T* x = (blockIdx.z ? pl.in[1] : pl.in[0]) +
                 (long long)row * in_row_stride;
    T* out = (blockIdx.z ? pl.out[1] : pl.out[0]) +
             (long long)row * out_row_stride;
    if (kStaged) {
      __syncthreads();                   // the previous row's reads are done
      for (int t = tid; t < span; t += kThreads) {
        const long long gi = q0 + t;
        xs[t] = (gi >= 0 && gi < n) ? x[gi * in_elem_stride] : T(0);
      }
      __syncthreads();
    }
    for (int w = tid; w < slab; w += kThreads) {
      const int c = w % P;
      const long long cd = (long long)c * down;
      const int p = (int)(cd % up);
      // span index of x[q - l] for the slab-0 output, l = 0
      const int tb = (w / P) * S + (int)(cd / up) + (lh - 1);
      T acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = T(0);
      for (int l = 0; l < lh; ++l) {
        T hv;
        if (kStaged) {
          hv = hs[p + l * up];
        } else {
          const int k = p + l * up;
          hv = k < ntaps ? h[k] : T(0);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int t = tb + r * gp * S - l;
          T xv;
          if (kStaged) {
            xv = xs[t];
          } else {
            const long long gi = q0 + t;
            xv = (gi >= 0 && gi < n) ? x[gi * in_elem_stride] : T(0);
          }
          acc[r] = fma_t(hv, xv, acc[r]);
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

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T>
int launch(const void* in0, const void* in1, void* out0, void* out1,
           int groups, int rows, long long n, long long in_row_stride,
           long long in_elem_stride, long long n_out, long long out_row_stride,
           long long out_elem_stride, const void* h, int ntaps, int up,
           int down, void* stream) {
  if (groups < 1 || groups > 2 || rows < 1 || n < 1 || n_out < 1 ||
      ntaps < 1 || up < 1 || down < 1)
    return (int)cudaErrorInvalidValue;
  const int g = gcd_int(up, down);
  const int P = up / g, S = down / g;
  const int lh = (ntaps + up - 1) / up;
  const long long qcmax = ((long long)(P - 1) * down) / up;
  // slabs of ~kSlabOutputs outputs, halved while a staged block's shared
  // memory (taps + input span) exceeds the budget; unstaged when one period
  // per slab still does not fit
  auto span_of = [&](long long gp) { return (kR * gp - 1) * S + qcmax + lh; };
  auto smem_of = [&](long long gp) {
    return (long long)sizeof(T) * ((long long)lh * up + span_of(gp));
  };
  long long gp = kSlabOutputs / P > 1 ? kSlabOutputs / P : 1;
  while (gp > 1 && smem_of(gp) > kSmemBudget) gp /= 2;
  const bool staged = smem_of(gp) <= kSmemBudget;
  const long long slab = gp * P;
  const long long span = span_of(gp);
  if (slab * kR > (1LL << 30) || span > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_out + kR * slab - 1) / (kR * slab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Planes<T> pl;
  pl.in[0] = static_cast<const T*>(in0);
  pl.in[1] = static_cast<const T*>(groups == 2 ? in1 : in0);
  pl.out[0] = static_cast<T*>(out0);
  pl.out[1] = static_cast<T*>(groups == 2 ? out1 : out0);
  const dim3 grid((unsigned)blocks, (unsigned)(rows < 65535 ? rows : 65535),
                  (unsigned)groups);
  cudaStream_t s = (cudaStream_t)stream;
  if (staged) {
    const size_t smem = (size_t)smem_of(gp);
    cudaError_t err = cudaFuncSetAttribute(
        upfirdn_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    upfirdn_kernel<T, true><<<grid, kThreads, smem, s>>>(
        pl, static_cast<const T*>(h), ntaps, n, n_out, rows, in_row_stride,
        in_elem_stride, out_row_stride, out_elem_stride, up, down, P, S, lh,
        (int)gp);
  } else {
    upfirdn_kernel<T, false><<<grid, kThreads, 0, s>>>(
        pl, static_cast<const T*>(h), ntaps, n, n_out, rows, in_row_stride,
        in_elem_stride, out_row_stride, out_elem_stride, up, down, P, S, lh,
        (int)gp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in0/in1: the planes (in1 unused when groups == 1), each `rows` rows of n
// samples at the given row and element strides (in elements); out0/out1 the
// same for n_out outputs; h: ntaps real taps of the planes' type. The tiling
// and the staged or unstaged variant are chosen here. Returns a cudaError_t.
extern "C" int pdsp_upfirdn_f32(const void* in0, const void* in1, void* out0,
                                void* out1, int groups, int rows, long long n,
                                long long in_row_stride,
                                long long in_elem_stride, long long n_out,
                                long long out_row_stride,
                                long long out_elem_stride, const void* h,
                                int ntaps, int up, int down,
                                void* stream) {
  return launch<float>(in0, in1, out0, out1, groups, rows, n, in_row_stride,
                       in_elem_stride, n_out, out_row_stride, out_elem_stride,
                       h, ntaps, up, down, stream);
}

extern "C" int pdsp_upfirdn_f64(const void* in0, const void* in1, void* out0,
                                void* out1, int groups, int rows, long long n,
                                long long in_row_stride,
                                long long in_elem_stride, long long n_out,
                                long long out_row_stride,
                                long long out_elem_stride, const void* h,
                                int ntaps, int up, int down,
                                void* stream) {
  return launch<double>(in0, in1, out0, out1, groups, rows, n, in_row_stride,
                        in_elem_stride, n_out, out_row_stride,
                        out_elem_stride, h, ntaps, up, down, stream);
}
