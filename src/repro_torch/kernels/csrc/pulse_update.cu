// Crossbar pulse-update kernel for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel repro/kernels/crossbar.py:pulse_update_kernel
// (body _upd_kernel), which repro/kernels/ops.py:_pulse_stacked_call vmaps
// over the core stack.  Here the core stack is the grid's z axis, so one
// launch is the update phase of every core of a pipeline stage (the chip
// axis of a farm is folded into it by the Python wrapper).
//
// For each core t (paper III.F step 3):
//   acc = x[t]^T @ d[t]                           (batch-summed outer product)
//   c   = clip(rint(two_lr * acc / unit), -levels, levels)    (pulse count)
//   gp' = clip(gp[t] + c*unit/2, 0, w_max),  gm' = clip(gm[t] - c*unit/2, ...)
//   x (T, M, K), d (T, M, N), gp/gm and the new gp'/gm' (T, K, N), all fp32,
//   row-major and contiguous.  The new conductances go to separate outputs.
//
// Rounding, as the reference: two_lr = fp32(2 * lr) and unit =
// fp32(max_dw / levels) are rounded once on the host; two_lr * acc is one
// fp32 product; the division by unit is IEEE (__fdiv_rn) and the count
// rounds halves to even (rintf, as jnp.round).  Explicit _rn intrinsics
// keep nvcc from contracting the epilogue into FMAs.  Build without
// --use_fast_math.
//
// Design: as the weight-gradient kernel (crossbar_dw.cu), whose product
// this is: one block per 32 x 32 output tile and core, the batch axis M
// walked in ascending order inside the block, each output one thread's
// fmaf chain (no split-M, no atomics, deterministic), ragged edges masked;
// then the pulse epilogue reads the old conductances and writes the new.
// A pad line (zero input or zero error) sums to 0, so its conductances
// stay as they were.
//
// What bounds it on an H100 SXM: at M = 4096, mnist stage 0 (T=6, K=400,
// N=100) is 1.97 GFLOP = 29 us at 67 TFLOP/s fp32, against
// 6*4*(4096*400 + 4096*100 + 4*400*100) = 53 MB = 16 us of HBM traffic:
// operations bound it; at M = 1 the 4 conductance arrays dominate and
// bytes bound it.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;        // fan-in lines per block
constexpr int BN = 32;        // neurons per block
constexpr int BMC = 32;       // samples per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TK = BK / 16;   // outputs per thread along K
constexpr int TN = BN / 16;   // outputs per thread along N

__global__ void __launch_bounds__(THREADS)
pulse_update(const float* __restrict__ gp, const float* __restrict__ gm,
             const float* __restrict__ x, const float* __restrict__ d,
             float* __restrict__ gp_out, float* __restrict__ gm_out,
             int M, int K, int N, float two_lr, float unit, float levels,
             float w_max) {
  __shared__ float xs[BMC][BK];
  __shared__ float ds[BMC][BN];

  const size_t t = blockIdx.z;
  x += t * static_cast<size_t>(M) * K;
  d += t * static_cast<size_t>(M) * N;
  const size_t g_off = t * static_cast<size_t>(K) * N;
  gp += g_off;
  gm += g_off;
  gp_out += g_off;
  gm_out += g_off;

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
      ds[mm][nn] = (row < M && col < N)
                       ? d[static_cast<size_t>(row) * N + col] : 0.f;
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
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(k) * N + n;
      float c = rintf(__fdiv_rn(__fmul_rn(two_lr, acc[i][j]), unit));
      c = fminf(fmaxf(c, -levels), levels);
      const float half = __fmul_rn(0.5f, __fmul_rn(c, unit));
      gp_out[o] = fminf(fmaxf(__fadd_rn(gp[o], half), 0.f), w_max);
      gm_out[o] = fminf(fmaxf(__fsub_rn(gm[o], half), 0.f), w_max);
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Returns cudaGetLastError()
// after the launch: 0 on success.  The caller checks shapes, types and
// contiguity, keeps T and ceil(K / 32) within the grid's 65535 limit, and
// rounds two_lr = 2 * lr and unit = max_dw / levels to fp32 once.
extern "C" int pulse_update_launch(const float* gp, const float* gm,
                                   const float* x, const float* d,
                                   float* gp_out, float* gm_out, int T,
                                   int M, int K, int N, float two_lr,
                                   float unit, float levels, float w_max,
                                   void* stream) {
  const dim3 grid((N + BN - 1) / BN, (K + BK - 1) / BK, T);
  pulse_update<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, gm, x, d, gp_out, gm_out, M, K, N, two_lr, unit, levels, w_max);
  return static_cast<int>(cudaGetLastError());
}
