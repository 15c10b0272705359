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
// Design: acc is crossbar_dw.cu's product, from the same batch walk
// (outer_product.cuh: one block per output tile and core, a ring of batch
// stages that a producer warp fills with tensor-memory-accelerator boxes of
// x and d, compute warps with register tiles, each cell one thread's
// ascending-M fmaf chain from 0.f; no split-M, no atomics); then each
// thread applies the pulse epilogue to its cells, reading the old
// conductances and writing the new.  crossbar_train.cu's update blocks sum
// in the same order, so the fused kernel equals this one bit for bit.  A
// pad line (zero input or zero error) sums to 0, so its conductances stay
// as they were.  The launcher takes the tile index the Python wrapper
// picked for the shape.
//
// What bounds it on an H100 SXM: at M = 4096, mnist stage 0 (T=6, K=400,
// N=100) is 1.97 GFLOP = 29 us at 67 TFLOP/s fp32, against
// 6*4*(4096*400 + 4096*100 + 4*400*100) = 53 MB = 16 us of HBM traffic:
// operations bound it.  Shared memory feeding the registers binds first on
// the CUDA cores (a 4 x 2 tile reads 24 bytes for its 8 fmaf), and N = 100
// pads to the tile.  A stage of one or two cores (40,000 or 80,000 cells)
// cannot give every warp scheduler a warp: there one warp's walk of the
// 4096 samples sets the time, above the chain floor of 4096 dependent fmaf
// (about 9 us) and the 4.9 us bound; only a split batch would go below it.
// At M = 1 the 4 conductance arrays dominate and bytes bound it.

#include <cuda_runtime.h>

#include "outer_product.cuh"

namespace {

using outer_product::Tile;

template <class C>
__global__ void __launch_bounds__(C::THREADS)
pulse_update(const float* __restrict__ gp, const float* __restrict__ gm,
             const float* __restrict__ x, const float* __restrict__ d,
             float* __restrict__ gp_out, float* __restrict__ gm_out,
             int M, int K, int N, float two_lr, float unit, float levels,
             float w_max,
             const __grid_constant__ outer_product::Operands ops) {
  extern __shared__ __align__(128) char smem[];
  const size_t t = blockIdx.z;
  x += t * static_cast<size_t>(M) * K;
  d += t * static_cast<size_t>(M) * N;
  const size_t g_off = t * static_cast<size_t>(K) * N;
  gp += g_off;
  gm += g_off;
  gp_out += g_off;
  gm_out += g_off;
  const int k0 = blockIdx.y * C::BK;
  const int n0 = blockIdx.x * C::BN;

  float acc[C::TK][C::TN];
  outer_product::batch_walk<C, float>(x, d, 1.f, M, K, N, blockIdx.z, k0, n0,
                                      ops, smem, acc);
  if (threadIdx.x >= C::COMPUTE) return;   // the producer warp

  const int k = k0 + outer_product::tile_k<C>();
  const int n = n0 + outer_product::tile_n<C>();
#pragma unroll
  for (int i = 0; i < C::TK; ++i) {
    if (k + i >= K) break;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      if (n + j >= N) continue;
      const size_t o = static_cast<size_t>(k + i) * N + n + j;
      float c = rintf(__fdiv_rn(__fmul_rn(two_lr, acc[i][j]), unit));
      c = fminf(fmaxf(c, -levels), levels);
      const float half = __fmul_rn(0.5f, __fmul_rn(c, unit));
      gp_out[o] = fminf(fmaxf(__fadd_rn(gp[o], half), 0.f), w_max);
      gm_out[o] = fminf(fmaxf(__fsub_rn(gm[o], half), 0.f), w_max);
    }
  }
}

template <class C>
int launch(const float* gp, const float* gm, const float* x, const float* d,
           float* gp_out, float* gm_out, int T, int M, int K, int N,
           float two_lr, float unit, float levels, float w_max,
           cudaStream_t stream) {
  constexpr int smem = outer_product::smem_bytes<C, float>();
  static unsigned long long devices = 0;
  const cudaError_t err =
      outer_product::allow_smem(pulse_update<C>, smem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + C::BN - 1) / C::BN, (K + C::BK - 1) / C::BK, T);
  pulse_update<C><<<grid, C::THREADS, smem, stream>>>(
      gp, gm, x, d, gp_out, gm_out, M, K, N, two_lr, unit, levels, w_max,
      outer_product::operands<C>(x, d, true, T, M, K, N));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); `tile` indexes
// OUTER_PRODUCT_TILES.  Returns cudaGetLastError() after the launch: 0 on
// success, -1 for an unknown tile.  The caller checks shapes, types and
// contiguity, keeps T and the k-tiles within the grid's 65535 limit, and
// rounds two_lr = 2 * lr and unit = max_dw / levels to fp32 once.
extern "C" int pulse_update_launch(const float* gp, const float* gm,
                                   const float* x, const float* d,
                                   float* gp_out, float* gm_out, int T,
                                   int M, int K, int N, float two_lr,
                                   float unit, float levels, float w_max,
                                   int tile, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define OUTER_PRODUCT_CASE(i, tk, tn, wk, wn, bm, s)                     \
    case i:                                                              \
      return launch<Tile<tk, tn, wk, wn, bm, s>>(gp, gm, x, d, gp_out,   \
                                                 gm_out, T, M, K, N,     \
                                                 two_lr, unit, levels,   \
                                                 w_max, st);
    OUTER_PRODUCT_TILES(OUTER_PRODUCT_CASE)
#undef OUTER_PRODUCT_CASE
    default: return -1;
  }
}
