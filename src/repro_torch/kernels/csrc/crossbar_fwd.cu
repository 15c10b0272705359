// Crossbar forward kernel for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/crossbar.py:crossbar_fwd_kernel
// (body _fwd_kernel), which repro/kernels/ops.py:_fwd_stacked_call vmaps
// over the core stack.  Here the core stack is the grid's z axis, so one
// launch evaluates every core of a pipeline stage (the chip axis of a farm
// is folded into it by the Python wrapper).
//
// For each core t:  y[t] = ADC(h(x[t] @ (gp[t] - gm[t])))
//   x (T, M, K), gp/gm (T, K, N), y (T, M, N), all fp32, row-major and
//   contiguous; h(o) = clip(0.25 o, -0.5, 0.5) when `activation`; the
//   optional ADC is clip(o, +-r) then rint((o + r) / scale) * scale - r.
//
// Design: one block per (n-tile, m-tile, core).  Each block stages a
// BM x BK tile of x and a BK x BN tile of delta = gp - gm (formed as the
// tile is loaded) in shared memory and walks K in ascending order, each
// thread keeping a 4 x 4 block of fp32 sums in registers (fmaf).  Ragged
// M/N/K edges are masked in the loads and the store, so the wrapper pads
// nothing (N = 100 and K = 200/300/600 are not tile multiples).  There is
// no split-K and no atomics: every output is one thread's ascending-K sum,
// so results are deterministic run to run.  The epilogue rounds halves to
// even (rintf) and divides with IEEE division (__fdiv_rn), as the
// reference does; explicit _rn intrinsics keep nvcc from contracting the
// epilogue into FMAs.  Build without --use_fast_math.
//
// What bounds it on an H100 SXM: without TF32 the product runs on the CUDA
// cores at 67 TFLOP/s fp32.  At the smoke's batch M = 4096, mnist stage 0
// (T=6, K=400, N=100) is 2*6*4096*400*100 = 1.97 GFLOP = 29 us at that
// rate, against 6*4*(4096*400 + 2*400*100 + 4096*100) = 51 MB = 15 us of
// HBM traffic at 3.35 TB/s: operations bound it.  This simple design is
// limited by shared-memory reads (8 loads per 16 FMAs) well below that
// peak; wgmma/TMA tiling is later work.  Measured times, beside the card's
// name and power limit, are in PERF.md (chip_smoke.py prints them).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // samples (rows of x) per block
constexpr int BN = 64;        // neurons (output columns) per block
constexpr int BK = 16;        // fan-in lines per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = BM / 16;   // outputs per thread along M
constexpr int TN = BN / 16;   // outputs per thread along N

__global__ void __launch_bounds__(THREADS)
crossbar_fwd(const float* __restrict__ x, const float* __restrict__ gp,
             const float* __restrict__ gm, float* __restrict__ y,
             int M, int K, int N, int activation, int adc,
             float adc_range, float scale) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed (+1: bank skew)
  __shared__ float ws[BK][BN];      // delta tile

  const size_t t = blockIdx.z;
  x += t * static_cast<size_t>(M) * K;
  gp += t * static_cast<size_t>(K) * N;
  gm += t * static_cast<size_t>(K) * N;
  y += t * static_cast<size_t>(M) * N;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int row = m0 + mm, col = k0 + kk;
      xs[kk][mm] = (row < M && col < K)
                       ? x[static_cast<size_t>(row) * K + col] : 0.f;
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
      ws[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float o = acc[i][j];
      if (activation) o = fminf(fmaxf(__fmul_rn(o, 0.25f), -0.5f), 0.5f);
      if (adc) {
        o = fminf(fmaxf(o, -adc_range), adc_range);
        o = rintf(__fdiv_rn(__fadd_rn(o, adc_range), scale));
        o = __fsub_rn(__fmul_rn(o, scale), adc_range);
      }
      y[static_cast<size_t>(m) * N + n] = o;
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Returns cudaGetLastError()
// after the launch: 0 on success.  The caller checks shapes, types and
// contiguity and keeps T and ceil(M / 64) within the grid's 65535 limit.
extern "C" int crossbar_fwd_launch(const float* x, const float* gp,
                                   const float* gm, float* y, int T, int M,
                                   int K, int N, int activation, int adc,
                                   float adc_range, float scale,
                                   void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, T);
  crossbar_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gp, gm, y, M, K, N, activation, adc, adc_range, scale);
  return static_cast<int>(cudaGetLastError());
}
