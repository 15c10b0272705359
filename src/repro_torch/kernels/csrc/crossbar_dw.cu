// Crossbar weight-gradient kernel for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel repro/kernels/crossbar.py:crossbar_dw_kernel
// (body _dw_kernel), which repro/kernels/ops.py:_dw_stacked_call vmaps over
// the core stack.  Here the core stack is the grid's z axis (the chip axis
// of a farm is folded into it by the Python wrapper).
//
// For each core t:  dw[t] = x[t]^T @ d[t]   (paper Eq. 6, batch-summed)
//   x (T, M, K) fp32; dy (T, M, N) as fp32 values, or as int8 / int32
//   sign-magnitude error codes with one fp32 scale read from device memory;
//   dw (T, K, N) fp32.  All row-major and contiguous.  With codes,
//   d = float(code) * scale is formed as each element is loaded into shared
//   memory, before the product, as the TPU kernel does.
//
// Design: one block per (n-tile, k-tile, core) of the output.  The TPU
// kernel accumulated over a sequential batch grid axis; here each block
// walks the whole batch axis M itself in ascending order, staging a
// BMC x BK tile of x and a BMC x BN tile of d in shared memory, each thread
// keeping a 2 x 2 block of fp32 sums in registers (fmaf).  There is no
// split-M and no atomics: every output is one thread's ascending-M sum, so
// results are deterministic run to run.  Small 32 x 32 output tiles keep
// enough blocks in flight for one core (400 x 100 -> 52 blocks).  Ragged
// edges are masked.  Build without --use_fast_math.
//
// What bounds it on an H100 SXM: at M = 4096, one paper core (K=400,
// N=100) is 2*4096*400*100 = 328 MFLOP = 4.9 us at 67 TFLOP/s fp32,
// against 4*(4096*400 + 4096*100 + 400*100) = 8.4 MB = 2.5 us of HBM
// traffic: operations bound it.  One shared-memory load per FMA limits
// this simple design well below that peak.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BK = 32;        // fan-in lines (rows of dw) per block
constexpr int BN = 32;        // neurons (columns of dw) per block
constexpr int BMC = 32;       // samples per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TK = BK / 16;   // outputs per thread along K
constexpr int TN = BN / 16;   // outputs per thread along N

template <typename TIn, bool kDequant>
__global__ void __launch_bounds__(THREADS)
crossbar_dw(const float* __restrict__ x, const TIn* __restrict__ dy,
            const float* __restrict__ scale, float* __restrict__ dw,
            int M, int K, int N) {
  __shared__ float xs[BMC][BK];
  __shared__ float ds[BMC][BN];

  const size_t t = blockIdx.z;
  x += t * static_cast<size_t>(M) * K;
  dy += t * static_cast<size_t>(M) * N;
  dw += t * static_cast<size_t>(K) * N;
  const float s = kDequant ? *scale : 1.f;

  const int k0 = blockIdx.y * BK;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BMC) {
#pragma unroll
    for (int e = tid; e < BMC * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int row = m0 + mm, col = k0 + kk;
      xs[mm][kk] = (row < M && col < K)
                       ? x[static_cast<size_t>(row) * K + col] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BMC * BN; e += THREADS) {
      const int mm = e / BN, nn = e % BN;
      const int row = m0 + mm, col = n0 + nn;
      float v = 0.f;
      if (row < M && col < N) {
        v = static_cast<float>(dy[static_cast<size_t>(row) * N + col]);
        if (kDequant) v = __fmul_rn(v, s);
      }
      ds[mm][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < BMC; ++mm) {
      float a[TK], b[TN];
#pragma unroll
      for (int i = 0; i < TK; ++i) a[i] = xs[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ds[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) dw[static_cast<size_t>(k) * N + n] = acc[i][j];
    }
  }
}

template <typename TIn, bool kDequant>
int launch(const float* x, const void* dy, const float* scale, float* dw,
           int T, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (K + BK - 1) / BK, T);
  crossbar_dw<TIn, kDequant><<<grid, THREADS, 0, stream>>>(
      x, static_cast<const TIn*>(dy), scale, dw, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  `dy_kind` is 0 for fp32
// values (scale unused), 1 for int8 codes and 2 for int32 codes, both
// dequantized with *scale.  Returns cudaGetLastError() after the launch:
// 0 on success, -1 for an unknown dy_kind.  The caller checks shapes,
// types and contiguity and keeps T and ceil(K / 32) within the grid's
// 65535 limit.
extern "C" int crossbar_dw_launch(const float* x, const void* dy,
                                  int dy_kind, const float* scale, float* dw,
                                  int T, int M, int K, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dy_kind) {
    case 0: return launch<float, false>(x, dy, scale, dw, T, M, K, N, st);
    case 1: return launch<int8_t, true>(x, dy, scale, dw, T, M, K, N, st);
    case 2: return launch<int32_t, true>(x, dy, scale, dw, T, M, K, N, st);
    default: return -1;
  }
}
