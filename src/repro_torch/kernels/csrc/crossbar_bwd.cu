// Crossbar error-backprop kernel for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel repro/kernels/crossbar.py:crossbar_bwd_kernel
// (body _bwd_kernel), which repro/kernels/ops.py:_bwd_stacked_call vmaps
// over the core stack.  Here the core stack is the grid's z axis, so one
// launch drives the error of every core of a pipeline stage back through
// its conductances (the chip axis of a farm is folded into it by the
// Python wrapper).
//
// For each core t:  dx[t] = d[t] @ (gp[t] - gm[t])^T   (paper Eq. 7)
//   dy (T, M, N) as fp32 values, or as int8 / int32 sign-magnitude error
//   codes with one fp32 scale (read from device memory, so the host never
//   waits for it); gp/gm (T, K, N); dx (T, M, K) fp32.  All row-major and
//   contiguous.  With codes, d = float(code) * scale is formed as each
//   element is loaded into shared memory, before the product, as the TPU
//   kernel does: the codes are never widened in device memory.
//
// Design: one block per (k-tile, m-tile, core).  Each block stages a
// BN x BM tile of d and a BN x BK tile of delta = gp - gm (formed as the
// tile is loaded, stored transposed) in shared memory and walks the neuron
// axis N in ascending order, each thread keeping a 4 x 4 block of fp32 sums
// in registers (fmaf).  Ragged M/K/N edges are masked in the loads and the
// store.  There is no split-N and no atomics: every output is one thread's
// ascending-N sum, so results are deterministic run to run.  Build without
// --use_fast_math.
//
// What bounds it on an H100 SXM: at M = 4096, mnist stage 0 (T=6, K=400,
// N=100) is 2*6*4096*400*100 = 1.97 GFLOP = 29 us at 67 TFLOP/s fp32,
// against 6*4*(4096*100 + 2*400*100 + 4096*400) = 51 MB = 15 us of HBM
// traffic: operations bound it.  Like the forward kernel, this simple
// design is limited by shared-memory reads well below that peak.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;        // samples (rows of dy / dx) per block
constexpr int BK = 64;        // fan-in lines (columns of dx) per block
constexpr int BN = 16;        // neurons per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = BM / 16;   // outputs per thread along M
constexpr int TK = BK / 16;   // outputs per thread along K

template <typename TIn, bool kDequant>
__global__ void __launch_bounds__(THREADS)
crossbar_bwd(const TIn* __restrict__ dy, const float* __restrict__ scale,
             const float* __restrict__ gp, const float* __restrict__ gm,
             float* __restrict__ dx, int M, int K, int N) {
  __shared__ float ds[BN][BM + 1];  // error tile, transposed (+1: bank skew)
  __shared__ float ws[BN][BK + 1];  // delta tile, transposed

  const size_t t = blockIdx.z;
  dy += t * static_cast<size_t>(M) * N;
  gp += t * static_cast<size_t>(K) * N;
  gm += t * static_cast<size_t>(K) * N;
  dx += t * static_cast<size_t>(M) * K;
  const float s = kDequant ? *scale : 1.f;

  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BN) {
#pragma unroll
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int mm = e / BN, nn = e % BN;
      const int row = m0 + mm, col = n0 + nn;
      float v = 0.f;
      if (row < M && col < N) {
        v = static_cast<float>(dy[static_cast<size_t>(row) * N + col]);
        if (kDequant) v = __fmul_rn(v, s);
      }
      ds[nn][mm] = v;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int row = k0 + kk, col = n0 + nn;
      float w = 0.f;
      if (row < K && col < N) {
        const size_t o = static_cast<size_t>(row) * N + col;
        w = __fsub_rn(gp[o], gm[o]);
      }
      ws[nn][kk] = w;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < BN; ++nn) {
      float a[TM], b[TK];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ds[nn][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TK; ++j) b[j] = ws[nn][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) dx[static_cast<size_t>(m) * K + k] = acc[i][j];
    }
  }
}

template <typename TIn, bool kDequant>
int launch(const void* dy, const float* scale, const float* gp,
           const float* gm, float* dx, int T, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((K + BK - 1) / BK, (M + BM - 1) / BM, T);
  crossbar_bwd<TIn, kDequant><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(dy), scale, gp, gm, dx, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  `dy_kind` is 0 for fp32
// values (scale unused), 1 for int8 codes and 2 for int32 codes, both
// dequantized with *scale.  Returns cudaGetLastError() after the launch:
// 0 on success, -1 for an unknown dy_kind.  The caller checks shapes,
// types and contiguity and keeps T and ceil(M / 64) within the grid's
// 65535 limit.
extern "C" int crossbar_bwd_launch(const void* dy, int dy_kind,
                                   const float* scale, const float* gp,
                                   const float* gm, float* dx, int T, int M,
                                   int K, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dy_kind) {
    case 0: return launch<float, false>(dy, scale, gp, gm, dx, T, M, K, N, st);
    case 1: return launch<int8_t, true>(dy, scale, gp, gm, dx, T, M, K, N, st);
    case 2: return launch<int32_t, true>(dy, scale, gp, gm, dx, T, M, K, N,
                                         st);
    default: return -1;
  }
}
