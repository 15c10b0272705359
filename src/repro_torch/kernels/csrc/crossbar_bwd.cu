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
//   d (T, M, N) as fp32 values, or as int8 / int32 sign-magnitude error
//   codes with one fp32 scale (read from device memory, so the host never
//   waits for it); gp/gm (T, K, N); dx (T, M, K) fp32.  All row-major and
//   contiguous.  Codes are dequantized as __fmul_rn(float(code), scale) in
//   shared memory, before the product, as the TPU kernel does: they are
//   never widened in device memory.
//
// The summation order is the contract (row_product.cuh): every output is
// one thread's ascending-n fmaf chain from 0.f, w = __fsub_rn(gp, gm).
// That is the chain of the fused kernel's dx blocks, so crossbar_train.cu
// equals the four-call sequence (fwd, this kernel, pulse) bit for bit, and
// every tile and run below gives the same bits.  No split over N, no
// atomics.  Build without --use_fast_math.
//
// Design: one instance per tile of CROSSBAR_BWD_TILES (row_product::Tile:
// TM x TC register tiles, NTC x NTM compute threads and a producer warp),
// error type and walk.
//   * N <= 128 (every chip stage): row_product::dx_walk, the walk of the
//     fused kernel's dx blocks.  A block forms its BC columns of w once,
//     transposed, then walks a run of `run` consecutive BM-row tiles of d,
//     each tile's N lines one stage of a ring the producer warp fills (fp32
//     d as tensor-map boxes, int8 codes as 16-byte cp.async windows
//     dequantized in shared memory, int32 codes as 4-byte copies).  Grid:
//     (column tiles, runs, cores).
//   * N > 128 (crossbar_apply's layers of 300 and 200 columns): a stage
//     cannot hold all N lines, so row_product::dx_ring_walk rings N in
//     stages of BR lines, as the forward rings K: the producer lands the
//     stage's d rows and BC rows of g+ and g- and forms that stage's lines
//     of w^T; the compute threads dequantize int8 codes (one producer warp
//     doing it for every short stage held the walk back).  Grid: (column
//     tiles, row tiles, cores).
// The launcher takes the tile and the run from the wrapper, which picks
// them by shape (kernels/crossbar.py: bwd_tile, bwd_run) from a sweep on
// the card.  Tensor maps are built only for what the walk reads by map.
//
// What bounds it on an H100 SXM: at M = 4096, mnist stage 0 (T=6, K=400,
// N=100) is 2*6*4096*400*100 = 1.97 GFLOP = 29 us at 67 TFLOP/s fp32,
// against 6*4*(4096*100 + 2*400*100 + 4096*400) = 51 MB = 15 us of HBM
// traffic: operations bound it.  A 4 x 4 tile issues 8 vector loads of
// shared memory per 64 fmaf at about 110 registers, three blocks of 5
// warps an SM (8 x 4 tiles took 160 registers and were slower); every
// column tile of 32 reads its row tile of d again from L2.  Measured times,
// beside the card's name and power limit, are in PERF.md (chip_smoke.py
// prints every tile's time beside the pick).

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "row_product.cuh"

// The tiles the launcher may pick: (index, TM, TC, NTC, NTM, BR, S), as
// ROW_PRODUCT_TILES: BM = TM NTM rows and BC = TC NTC columns of dx per
// block, BR lines a ring stage (dx_ring_walk only; dx_walk's stage is a
// whole row tile), S stages.  kernels/crossbar.py holds the same table
// (CROSSBAR_BWD_TILES) and picks an index.
#define CROSSBAR_BWD_TILES(X) \
  X(0, 4, 4, 8, 16, 32, 2) \
  X(1, 4, 4, 8, 16, 32, 3) \
  X(2, 4, 4, 8, 8, 32, 3)

namespace {

using row_product::Tile;

template <class C, typename TD, bool kRing>
__global__ void __launch_bounds__(C::THREADS)
crossbar_bwd(const TD* __restrict__ d, const float* __restrict__ scale,
             const float* __restrict__ gp, const float* __restrict__ gm,
             float* __restrict__ dx, int M, int K, int N, int run,
             const __grid_constant__ row_product::DxMaps maps) {
  extern __shared__ __align__(128) char smem[];
  const int t = blockIdx.z;
  const size_t g_off = static_cast<size_t>(t) * K * N;
  const float s = std::is_same<TD, float>::value ? 1.f : *scale;
  d += static_cast<size_t>(t) * M * N;
  dx += static_cast<size_t>(t) * M * K;
  const int k0 = blockIdx.x * C::BC;
  if constexpr (kRing) {
    row_product::dx_ring_walk<C, TD>(d, s, gp + g_off, gm + g_off, dx, M, K,
                                     N, t, blockIdx.y * C::BM, k0, maps,
                                     smem);
  } else {
    const int m_tiles = (M + C::BM - 1) / C::BM;
    const int mt0 = blockIdx.y * run;
    row_product::dx_walk<C, TD>(d, s, gp + g_off, gm + g_off, dx, M, K, N,
                                t, k0, mt0, min(run, m_tiles - mt0),
                                &maps.d, maps.tma & row_product::kTmaX,
                                smem);
  }
}

template <class C, typename TD, bool kRing>
int launch(const void* d, const float* scale, const float* gp,
           const float* gm, float* dx, int T, int M, int K, int N, int run,
           cudaStream_t stream) {
  constexpr int kBytes = sizeof(TD);
  constexpr bool kFloat = std::is_same<TD, float>::value;
  static unsigned long long devices = 0;
  // ask once for the most any launch of this instance takes (N = 128)
  const cudaError_t err = outer_product::allow_smem(
      crossbar_bwd<C, TD, kRing>,
      kRing ? row_product::dxr_smem_bytes<C>(kBytes)
            : row_product::dx_smem_bytes<C>(128, kBytes),
      devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_product::DxMaps maps{};
  const long long d_rows = static_cast<long long>(T) * M;
  const int m_tiles = (M + C::BM - 1) / C::BM;
  dim3 grid((K + C::BC - 1) / C::BC, m_tiles, T);
  int smem;
  if constexpr (kRing) {
    smem = row_product::dxr_smem_bytes<C>(kBytes);
    if (kFloat && outer_product::tensor_map(&maps.d, d, d_rows, N, C::BM,
                                            C::AP))
      maps.tma |= row_product::kTmaX;
    const long long g_rows = static_cast<long long>(T) * K;
    if (outer_product::tensor_map(&maps.gp, gp, g_rows, N, C::BC, C::AP) &&
        outer_product::tensor_map(&maps.gm, gm, g_rows, N, C::BC, C::AP))
      maps.tma |= row_product::kTmaG;
  } else {
    smem = row_product::dx_smem_bytes<C>(N, kBytes);
    grid.y = (m_tiles + run - 1) / run;
    if (kFloat && outer_product::tensor_map(&maps.d, d, d_rows, N, C::BM,
                                            row_product::dx_pitch(N)))
      maps.tma |= row_product::kTmaX;
  }
  crossbar_bwd<C, TD, kRing><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const TD*>(d), scale, gp, gm, dx, M, K, N, run, maps);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_kind(int d_kind, const void* d, const float* scale,
                const float* gp, const float* gm, float* dx, int T, int M,
                int K, int N, int run, cudaStream_t st) {
  const bool ring = N > 128;
  switch (d_kind) {
    case 0:
      return ring ? launch<C, float, true>(d, scale, gp, gm, dx, T, M, K, N,
                                           run, st)
                  : launch<C, float, false>(d, scale, gp, gm, dx, T, M, K,
                                            N, run, st);
    case 1:
      return ring ? launch<C, int8_t, true>(d, scale, gp, gm, dx, T, M, K,
                                            N, run, st)
                  : launch<C, int8_t, false>(d, scale, gp, gm, dx, T, M, K,
                                             N, run, st);
    case 2:
      return ring ? launch<C, int32_t, true>(d, scale, gp, gm, dx, T, M, K,
                                             N, run, st)
                  : launch<C, int32_t, false>(d, scale, gp, gm, dx, T, M, K,
                                              N, run, st);
    default:
      return -1;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream, or the stream a CUDA graph
// captures: the tensor maps are launch parameters).  `dy_kind` is 0 for
// fp32 values (scale unused), 1 for int8 codes and 2 for int32 codes, both
// dequantized with *scale.  `tile` indexes CROSSBAR_BWD_TILES; `run` is the
// number of consecutive row tiles a block walks where N <= 128 (ignored
// above).  Returns cudaGetLastError() after the launch: 0 on success, -1
// for an unknown dy_kind or tile, -2 for run < 1.  The caller checks
// shapes, types and contiguity and keeps the grid within CUDA's limits.
extern "C" int crossbar_bwd_launch(const void* dy, int dy_kind,
                                   const float* scale, const float* gp,
                                   const float* gm, float* dx, int T, int M,
                                   int K, int N, int tile, int run,
                                   void* stream) {
  if (run < 1) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define CROSSBAR_BWD_CASE(i, tm, tc, ntc, ntm, br, s)                       \
    case i:                                                                 \
      return launch_kind<Tile<tm, tc, ntc, ntm, br, s>>(                    \
          dy_kind, dy, scale, gp, gm, dx, T, M, K, N, run, st);
    CROSSBAR_BWD_TILES(CROSSBAR_BWD_CASE)
#undef CROSSBAR_BWD_CASE
    default: return -1;
  }
}
