// Fused per-stage training kernel for Hopper (sm_90a), fp32 on the CUDA
// cores: the compiled step's per-stage body.
//
// Replaces the TPU kernel repro/kernels/crossbar.py:crossbar_train_kernel
// (body _train_kernel), which repro/kernels/ops.py:_train_stacked_call
// vmaps over the core stack.  Here one launch covers the core stack, so it
// is the backward and update phases of every core of a pipeline stage (the
// chip axis of a farm is folded into the stack by the Python wrapper).
//
// For each core t, with w = gp[t] - gm[t] and u = max_dw / levels:
//   y[t]   = x[t] @ w                       (only when compute_y)
//   dx[t]  = d[t] @ w^T                     (paper Eq. 7)
//   acc    = x[t]^T @ d[t]                  (batch-summed outer product)
//   c      = clip(rint(2 lr * acc / u), -levels, levels)   (pulse count)
//   gp'[t] = clip(gp[t] + c*u/2, 0, w_max), gm'[t] = clip(gm[t] - c*u/2, ..)
//   x (T, M, K) fp32; d (T, M, N) as fp32 values, or as int8 / int32
//   sign-magnitude error codes with one fp32 scale, dequantized as
//   __fmul_rn(float(code), scale) in shared memory before the product;
//   gp/gm and gp'/gm' (T, K, N); y (T, M, N); dx (T, M, K).  All row-major
//   and contiguous; N <= 128.  lr is one fp32 value in device memory (a
//   CUDA graph replays the same launch under a new learning rate); 2 lr is
//   formed in fp32 here, which is exact, so it equals the host-rounded
//   fp32(2 lr) of pulse_update.cu.  u is rounded once to fp32 on the host.
//
// Determinism is the contract: every output is one thread's fmaf chain in
// the order of the standalone kernel it replaces, so this kernel equals the
// four-call sequence (crossbar_fwd without activation, crossbar_bwd,
// pulse_update on the dequantized d) bit for bit:
//   * acc ascending M: the update blocks run outer_product.cuh's batch
//     walk, the template pulse_update.cu instantiates, then its epilogue
//     (__fdiv_rn, rintf, clip, _rn intrinsics so nvcc contracts nothing
//     into FMAs);
//   * dx ascending N, and y ascending K: the dx and y blocks run
//     row_product.cuh's walks, whose chains are crossbar_bwd.cu's and
//     crossbar_fwd.cu's (lines past N or K skipped, never added as 0 * 0).
// No split reductions, no atomics.  Build without --use_fast_math.
//
// Design: one launch holds three kinds of blocks on a one-dimensional grid:
// the update blocks of every core first, then the dx blocks, then the y
// blocks, so the long update blocks (each walks the whole batch) are
// dispatched before the short ones that fill in around them.  A launch has
// one block size: the update walk's tile (outer_product_tile picks it by
// shape) sets the compute threads, and the dx and y blocks use as many
// (row_product::TrainTile: 4 x 4 register tiles, a warp of 8 column groups
// by 4 row groups), plus the producer warp every kind has.  An update block
// owns a BK x BN tile of acc and walks the batch through its ring; a dx
// block forms 32 columns of w, transposed, once, then walks a run of row
// tiles of d through its ring, each tile's all N lines in one stage; a y
// block is the forward walk on one tile of y.  The dynamic shared memory is
// the largest kind's.  dx and y blocks read gp/gm while update blocks
// write, so g+'/g-' always go to separate outputs (the wrapper copies them
// into place when asked to update in place).  A dx block walks a run of up
// to 8 row tiles (the wrapper splits a core's row tiles evenly), so forming
// its columns of w and filling its ring are paid once a run.
//
// What bounds it on an H100 SXM: one mnist_class step at M = 4096 (ten
// cores of 400 x 100 over four launches, compute_y off) is 4*M*K*N*10 =
// 6.55 GFLOP = 0.098 ms at 67 TFLOP/s fp32, against ~155 MB = 0.046 ms of
// HBM traffic: operations bound it.  The update half is a walk of M
// dependent fmaf per cell, which a stage of one or two cores cannot spread
// over every SM (pulse_update.cu has the same limit); the dx half is a
// register-tiled product of short chains (N = 100), fed by the ring.
// Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "outer_product.cuh"
#include "row_product.cuh"

namespace {

using outer_product::Tile;

// The operands of every block kind: the update walk's maps of x and fp32 d
// in its boxes, the dx walk's map of fp32 d in boxes of (BM, pitch), and
// the y walk's maps of x, g+ and g-.
struct TrainMaps {
  outer_product::Operands update;
  CUtensorMap dx_d;
  row_product::FwdMaps y;
  int tma_dx;
};

// Dynamic shared memory of the launch: the largest kind's.
template <class U, typename TD>
int train_smem(int N, int compute_y) {
  using R = row_product::TrainTile<U::COMPUTE>;
  int bytes = outer_product::smem_bytes<U, TD>();
  const int dx_bytes = row_product::dx_smem_bytes<R>(N, sizeof(TD));
  if (dx_bytes > bytes) bytes = dx_bytes;
  if (compute_y && row_product::fwd_smem_bytes<R>() > bytes)
    bytes = row_product::fwd_smem_bytes<R>();
  return bytes;
}

template <class U, typename TD>
__global__ void __launch_bounds__(U::THREADS)
crossbar_train(const float* gp, const float* gm, const float* __restrict__ x,
               const TD* __restrict__ d, const float* __restrict__ scale,
               const float* __restrict__ lr, float* __restrict__ y,
               float* __restrict__ dx, float* __restrict__ gp_out,
               float* __restrict__ gm_out, int T, int M, int K, int N,
               int compute_y, int dx_run, float unit, float levels,
               float w_max, const __grid_constant__ TrainMaps maps) {
  using R = row_product::TrainTile<U::COMPUTE>;
  static_assert(R::THREADS == U::THREADS, "one block size for every kind");
  extern __shared__ __align__(128) char smem[];
  const int upd_n = (N + U::BN - 1) / U::BN;
  const int n_upd = (K + U::BK - 1) / U::BK * upd_n;
  const int dx_k = (K + R::BC - 1) / R::BC;
  const int m_tiles = (M + R::BM - 1) / R::BM;
  const int n_dx = dx_k * ((m_tiles + dx_run - 1) / dx_run);
  const int y_n = (N + R::BC - 1) / R::BC;
  const int n_y = y_n * m_tiles;
  const float s = std::is_same<TD, float>::value ? 1.f : *scale;
  long long b = blockIdx.x;
  int role = 0, per = n_upd;
  if (b >= static_cast<long long>(T) * n_upd) {
    b -= static_cast<long long>(T) * n_upd;
    role = 1;
    per = n_dx;
    if (b >= static_cast<long long>(T) * n_dx) {
      b -= static_cast<long long>(T) * n_dx;
      role = 2;
      per = n_y;
      if (!compute_y) return;
    }
  }
  const int t = static_cast<int>(b / per);
  const int tile = static_cast<int>(b % per);
  const size_t g_off = static_cast<size_t>(t) * K * N;
  gp += g_off;
  gm += g_off;
  x += static_cast<size_t>(t) * M * K;
  d += static_cast<size_t>(t) * M * N;
  if (role == 0) {   // the update: outer_product's walk, pulse's epilogue
    const int k0 = tile / upd_n * U::BK;
    const int n0 = tile % upd_n * U::BN;
    float acc[U::TK][U::TN];
    outer_product::batch_walk<U, TD>(x, d, s, M, K, N, t, k0, n0,
                                     maps.update, smem, acc);
    if (threadIdx.x >= U::COMPUTE) return;   // the producer warp
    const float two_lr = __fmul_rn(2.f, *lr);
    gp_out += g_off;
    gm_out += g_off;
    const int k = k0 + outer_product::tile_k<U>();
    const int n = n0 + outer_product::tile_n<U>();
#pragma unroll
    for (int i = 0; i < U::TK; ++i) {
      if (k + i >= K) break;
#pragma unroll
      for (int j = 0; j < U::TN; ++j) {
        if (n + j >= N) continue;
        const size_t o = static_cast<size_t>(k + i) * N + n + j;
        float c = rintf(__fdiv_rn(__fmul_rn(two_lr, acc[i][j]), unit));
        c = fminf(fmaxf(c, -levels), levels);
        const float half = __fmul_rn(0.5f, __fmul_rn(c, unit));
        gp_out[o] = fminf(fmaxf(__fadd_rn(gp[o], half), 0.f), w_max);
        gm_out[o] = fminf(fmaxf(__fsub_rn(gm[o], half), 0.f), w_max);
      }
    }
  } else if (role == 1) {   // dx: a run of row tiles of 32 columns
    const int mt0 = tile / dx_k * dx_run;
    row_product::dx_walk<R, TD>(d, s, gp, gm,
                                dx + static_cast<size_t>(t) * M * K, M, K,
                                N, t, tile % dx_k * R::BC, mt0,
                                min(dx_run, m_tiles - mt0), &maps.dx_d,
                                maps.tma_dx != 0, smem);
  } else {   // y: the forward walk without activation and ADC
    const int m0 = tile / y_n * R::BM, c0 = tile % y_n * R::BC;
    float acc[R::TM][R::TC];
    row_product::fwd_walk<R>(x, gp, gm, M, K, N, t, m0, c0, maps.y, smem,
                             acc);
    if (threadIdx.x >= R::ACTIVE) return;
    y += static_cast<size_t>(t) * M * N;
    const int mt = m0 + row_product::tile_m<R>();
    const int ct = c0 + row_product::tile_c<R>();
#pragma unroll
    for (int i = 0; i < R::TM; ++i) {
      const int m = mt + R::NTM * i;
      if (m >= M) break;
#pragma unroll
      for (int j = 0; j < R::TC; ++j)
        if (ct + j < N) y[static_cast<size_t>(m) * N + ct + j] = acc[i][j];
    }
  }
}

template <class U, typename TD>
int launch(const float* gp, const float* gm, const float* x, const void* d,
           const float* scale, const float* lr, float* y, float* dx,
           float* gp_out, float* gm_out, int T, int M, int K, int N,
           int compute_y, int dx_run, float unit, float levels, float w_max,
           cudaStream_t stream) {
  using R = row_product::TrainTile<U::COMPUTE>;
  static unsigned long long devices = 0;
  // ask once for the most any launch of this instance takes (N = 128)
  const cudaError_t err = outer_product::allow_smem(
      crossbar_train<U, TD>, train_smem<U, TD>(128, 1), devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (M + R::BM - 1) / R::BM;
  long long per_core =
      static_cast<long long>((K + U::BK - 1) / U::BK) * ((N + U::BN - 1)
                                                         / U::BN)
      + static_cast<long long>((K + R::BC - 1) / R::BC)
        * ((m_tiles + dx_run - 1) / dx_run);
  if (compute_y) per_core += static_cast<long long>((N + R::BC - 1) / R::BC)
                             * m_tiles;
  if (per_core * T > 2147483647LL) return -3;
  constexpr bool kFloat = std::is_same<TD, float>::value;
  const TD* dt = static_cast<const TD*>(d);
  TrainMaps maps{};
  maps.update = outer_product::operands<U>(x, d, kFloat, T, M, K, N);
  const int P = row_product::dx_pitch(N);
  maps.tma_dx = kFloat && outer_product::tensor_map(
      &maps.dx_d, d, static_cast<long long>(T) * M, N, R::BM, P);
  if (compute_y) maps.y = row_product::fwd_maps<R>(x, gp, gm, T, M, K, N);
  crossbar_train<U, TD>
      <<<static_cast<unsigned>(per_core * T), U::THREADS,
         train_smem<U, TD>(N, compute_y), stream>>>(
          gp, gm, x, dt, scale, lr, y, dx, gp_out, gm_out, T, M, K, N,
          compute_y, dx_run, unit, levels, w_max, maps);
  return static_cast<int>(cudaGetLastError());
}

template <class U>
int launch_kind(int d_kind, const float* gp, const float* gm, const float* x,
                const void* d, const float* scale, const float* lr, float* y,
                float* dx, float* gp_out, float* gm_out, int T, int M, int K,
                int N, int compute_y, int dx_run, float unit, float levels,
                float w_max, cudaStream_t st) {
  switch (d_kind) {
    case 0:
      return launch<U, float>(gp, gm, x, d, scale, lr, y, dx, gp_out, gm_out,
                              T, M, K, N, compute_y, dx_run, unit, levels,
                              w_max, st);
    case 1:
      return launch<U, int8_t>(gp, gm, x, d, scale, lr, y, dx, gp_out,
                               gm_out, T, M, K, N, compute_y, dx_run, unit,
                               levels, w_max, st);
    case 2:
      return launch<U, int32_t>(gp, gm, x, d, scale, lr, y, dx, gp_out,
                                gm_out, T, M, K, N, compute_y, dx_run, unit,
                                levels, w_max, st);
    default:
      return -1;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream, or the stream a CUDA graph
// captures: the tensor maps are launch parameters).  `d_kind` is 0 for
// fp32 values (scale unused), 1 for int8 codes and 2 for int32 codes, both
// dequantized with *scale.  `tile` indexes OUTER_PRODUCT_TILES (the update
// walk's tile, which sets the block size); `dx_run` is the number of
// consecutive row tiles a dx block walks.  `y` is written only when
// compute_y.  gp_out/gm_out must not overlap gp/gm: dx and y blocks read
// the old conductances while update blocks write the new.  Returns
// cudaGetLastError() after the launch: 0 on success, -1 for an unknown
// d_kind or tile, -2 for N > 128 or dx_run < 1, -3 for a grid past 2^31 -
// 1 blocks.  The caller checks shapes, types and contiguity.
extern "C" int crossbar_train_launch(const float* gp, const float* gm,
                                     const float* x, const void* d,
                                     int d_kind, const float* scale,
                                     const float* lr, float* y, float* dx,
                                     float* gp_out, float* gm_out, int T,
                                     int M, int K, int N, int compute_y,
                                     int tile, int dx_run, float unit,
                                     float levels, float w_max,
                                     void* stream) {
  if (N > 128 || dx_run < 1) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define OUTER_PRODUCT_CASE(i, tk, tn, wk, wn, bm, s)                        \
    case i:                                                                 \
      return launch_kind<Tile<tk, tn, wk, wn, bm, s>>(                      \
          d_kind, gp, gm, x, d, scale, lr, y, dx, gp_out, gm_out, T, M, K,  \
          N, compute_y, dx_run, unit, levels, w_max, st);
    OUTER_PRODUCT_TILES(OUTER_PRODUCT_CASE)
#undef OUTER_PRODUCT_CASE
    default: return -1;
  }
}
