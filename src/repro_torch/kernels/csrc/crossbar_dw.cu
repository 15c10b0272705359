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
//   d = float(code) * scale is formed before the product, as the TPU kernel
//   does.
//
// Design: the TPU kernel accumulated over a sequential batch grid axis;
// here one block per (n-tile, k-tile, core) walks the whole batch in
// ascending order (outer_product.cuh: a ring of batch stages that a
// producer warp fills, x and fp32 d as tensor-memory-accelerator boxes and
// int8 codes as 16-byte cp.async windows that it dequantizes in shared
// memory; compute warps with 4 x 4, 4 x 2 or 2 x 2 register tiles of fmaf
// sums), then stores its tile.  Every output is one thread's ascending-M
// fmaf chain from 0.f, the order of pulse_update.cu and of
// crossbar_train.cu's update blocks: no split-M, no atomics, the same bits
// run to run and for every tile.  The launcher takes the tile index the
// Python wrapper picked for the shape.  Build without --use_fast_math.
//
// What bounds it on an H100 SXM: at M = 4096, crossbar_apply's largest
// layer (K=784, N=300) is 2*4096*784*300 = 1.93 GFLOP = 28.8 us at
// 67 TFLOP/s fp32, against 4*4096*784 + 4096*300 + 4*784*300 = 15 MB =
// 4.5 us of HBM traffic: operations bound it.  On the CUDA cores the
// rate that binds first is shared memory feeding the registers (128 bytes
// a cycle an SM): a 4 x 4 tile reads 32 bytes for its 16 fmaf, half the
// fp32 rate, some 58 us for that layer.  The smaller layers (300x200 down
// to 100x10) have too few outputs to give every warp scheduler a warp:
// there one warp's walk of 4096 samples sets the time, above the chain
// floor of 4096 dependent fmaf (about 9 us); only a split batch would go
// below it.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "outer_product.cuh"

namespace {

using outer_product::Tile;

template <class C, typename TD>
__global__ void __launch_bounds__(C::THREADS)
crossbar_dw(const float* __restrict__ x, const TD* __restrict__ dy,
            const float* __restrict__ scale, float* __restrict__ dw,
            int M, int K, int N,
            const __grid_constant__ outer_product::Operands ops) {
  extern __shared__ __align__(128) char smem[];
  const size_t t = blockIdx.z;
  x += t * static_cast<size_t>(M) * K;
  dy += t * static_cast<size_t>(M) * N;
  dw += t * static_cast<size_t>(K) * N;
  const float s = std::is_same<TD, float>::value ? 1.f : *scale;
  const int k0 = blockIdx.y * C::BK;
  const int n0 = blockIdx.x * C::BN;

  float acc[C::TK][C::TN];
  outer_product::batch_walk<C, TD>(x, dy, s, M, K, N, blockIdx.z, k0, n0,
                                   ops, smem, acc);
  if (threadIdx.x >= C::COMPUTE) return;   // the producer warp

  const int k = k0 + outer_product::tile_k<C>();
  const int n = n0 + outer_product::tile_n<C>();
#pragma unroll
  for (int i = 0; i < C::TK; ++i) {
    if (k + i >= K) break;
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      if (n + j < N) dw[static_cast<size_t>(k + i) * N + n + j] = acc[i][j];
  }
}

template <class C, typename TD>
int launch(const float* x, const void* dy, const float* scale, float* dw,
           int T, int M, int K, int N, cudaStream_t stream) {
  constexpr int smem = outer_product::smem_bytes<C, TD>();
  static unsigned long long devices = 0;
  const cudaError_t err =
      outer_product::allow_smem(crossbar_dw<C, TD>, smem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + C::BN - 1) / C::BN, (K + C::BK - 1) / C::BK, T);
  crossbar_dw<C, TD><<<grid, C::THREADS, smem, stream>>>(
      x, static_cast<const TD*>(dy), scale, dw, M, K, N,
      outer_product::operands<C>(x, dy, std::is_same<TD, float>::value, T,
                                 M, K, N));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD>
int launch_tile(int tile, const float* x, const void* dy, const float* scale,
                float* dw, int T, int M, int K, int N, cudaStream_t stream) {
  switch (tile) {
#define OUTER_PRODUCT_CASE(i, tk, tn, wk, wn, bm, s)                     \
    case i:                                                              \
      return launch<Tile<tk, tn, wk, wn, bm, s>, TD>(x, dy, scale, dw, T, \
                                                     M, K, N, stream);
    OUTER_PRODUCT_TILES(OUTER_PRODUCT_CASE)
#undef OUTER_PRODUCT_CASE
    default: return -1;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  `dy_kind` is 0 for fp32
// values (scale unused), 1 for int8 codes and 2 for int32 codes, both
// dequantized with *scale; `tile` indexes OUTER_PRODUCT_TILES.  Returns
// cudaGetLastError() after the launch: 0 on success, -1 for an unknown
// dy_kind or tile.  The caller checks shapes, types and contiguity and
// keeps T and the k-tiles within the grid's 65535 limit.
extern "C" int crossbar_dw_launch(const float* x, const void* dy,
                                  int dy_kind, const float* scale, float* dw,
                                  int T, int M, int K, int N, int tile,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dy_kind) {
    case 0: return launch_tile<float>(tile, x, dy, scale, dw, T, M, K, N, st);
    case 1: return launch_tile<int8_t>(tile, x, dy, scale, dw, T, M, K, N, st);
    case 2: return launch_tile<int32_t>(tile, x, dy, scale, dw, T, M, K, N,
                                        st);
    default: return -1;
  }
}
