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
// Design: the product is row_product.cuh's forward walk.  One block per
// (column tile, row tile, core); a producer warp keeps a ring of fan-in
// stages in flight (x, g+ and g- as tensor-memory-accelerator boxes, or
// 4-byte cp.async copies where no tensor map can read an operand: K = 41,
// N = 10, 15 or 26, a base not 16-byte aligned) and forms w = g+ - g- in
// shared memory; compute warps hold a TM x TC register tile each and read
// x along K and w along N as vector loads.  Every output is one thread's
// ascending-K fmaf chain from 0.f, as in the reference's order and in the
// fused kernel's y blocks, so every tile gives the same bits and the
// launcher may pick any (by shape, from a sweep on the card).  Ragged
// M/N/K edges are masked, nothing is padded by the wrapper (N = 100 is a
// whole tile of 25 x 4 columns).  No split-K, no atomics.  The epilogue
// rounds halves to even (rintf) and divides with IEEE division
// (__fdiv_rn), as the reference does; explicit _rn intrinsics keep nvcc
// from contracting the epilogue into FMAs.  Build without --use_fast_math.
//
// What bounds it on an H100 SXM: without TF32 the product runs on the CUDA
// cores at 67 TFLOP/s fp32.  At the smoke's batch M = 4096, mnist stage 0
// (T=6, K=400, N=100) is 2*6*4096*400*100 = 1.97 GFLOP = 29 us at that
// rate, against 6*4*(4096*400 + 2*400*100 + 4096*100) = 51 MB = 15 us of
// HBM traffic: operations bound it.  The register tile's vector loads keep
// shared memory below the fp32 rate; what is left is the tail of the grid
// (a stage of one core has 409,600 outputs, a few warps per SM) and the
// g+/g- boxes every row tile reads again from L2.  Measured times, beside
// the card's name and power limit, are in PERF.md (chip_smoke.py prints
// them with every tile's time).

#include <cuda_runtime.h>

#include "row_product.cuh"

namespace {

using row_product::Tile;

template <class C>
__global__ void __launch_bounds__(C::THREADS)
crossbar_fwd(const float* __restrict__ x, const float* __restrict__ gp,
             const float* __restrict__ gm, float* __restrict__ y, int M,
             int K, int N, int activation, int adc, float adc_range,
             float scale, const __grid_constant__ row_product::FwdMaps maps) {
  extern __shared__ __align__(128) char smem[];
  const size_t t = blockIdx.z;
  const int m0 = blockIdx.y * C::BM;
  const int c0 = blockIdx.x * C::BC;
  float acc[C::TM][C::TC];
  row_product::fwd_walk<C>(x + t * static_cast<size_t>(M) * K,
                           gp + t * static_cast<size_t>(K) * N,
                           gm + t * static_cast<size_t>(K) * N, M, K, N,
                           blockIdx.z, m0, c0, maps, smem, acc);
  if (threadIdx.x >= C::ACTIVE) return;   // idle lanes and the producer

  y += t * static_cast<size_t>(M) * N;
  const int mt = m0 + row_product::tile_m<C>();
  const int ct = c0 + row_product::tile_c<C>();
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = mt + C::NTM * i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < C::TC; ++j) {
      const int n = ct + j;
      if (n >= N) break;
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

template <class C>
int launch(const float* x, const float* gp, const float* gm, float* y,
           int T, int M, int K, int N, int activation, int adc,
           float adc_range, float scale, cudaStream_t stream) {
  constexpr int smem = row_product::fwd_smem_bytes<C>();
  static unsigned long long devices = 0;
  const cudaError_t err =
      outer_product::allow_smem(crossbar_fwd<C>, smem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + C::BC - 1) / C::BC, (M + C::BM - 1) / C::BM, T);
  crossbar_fwd<C><<<grid, C::THREADS, smem, stream>>>(
      x, gp, gm, y, M, K, N, activation, adc, adc_range, scale,
      row_product::fwd_maps<C>(x, gp, gm, T, M, K, N));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream, or the stream a CUDA graph
// captures: the tensor maps are launch parameters, so a replay reads the
// captured buffers); `tile` indexes ROW_PRODUCT_TILES.  Returns
// cudaGetLastError() after the launch: 0 on success, -1 for an unknown
// tile.  The caller checks shapes, types and contiguity and keeps T and
// the row tiles within the grid's 65535 limit.
extern "C" int crossbar_fwd_launch(const float* x, const float* gp,
                                   const float* gm, float* y, int T, int M,
                                   int K, int N, int activation, int adc,
                                   float adc_range, float scale, int tile,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define ROW_PRODUCT_CASE(i, tm, tc, ntc, ntm, br, s)                      \
    case i:                                                               \
      return launch<Tile<tm, tc, ntc, ntm, br, s>>(x, gp, gm, y, T, M, K, \
                                                   N, activation, adc,    \
                                                   adc_range, scale, st);
    ROW_PRODUCT_TILES(ROW_PRODUCT_CASE)
#undef ROW_PRODUCT_CASE
    default: return -1;
  }
}
