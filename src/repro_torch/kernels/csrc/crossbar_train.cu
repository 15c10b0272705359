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
//   float(code) * scale while the element enters shared memory or a
//   register; gp/gm and gp'/gm' (T, K, N); y (T, M, N); dx (T, M, K).  All
//   row-major and contiguous.  lr is one fp32 value in device memory (a
//   CUDA graph replays the same launch under a new learning rate); 2 lr is
//   formed in fp32 here, which is exact, so it equals the host-rounded
//   fp32(2 lr) of pulse_update.cu.  u is rounded once to fp32 on the host.
//
// Determinism is the contract: every output is one thread's fmaf chain in
// the order of the standalone kernel it replaces, so this kernel equals the
// four-call sequence (crossbar_fwd without activation, crossbar_bwd,
// pulse_update on the dequantized d) bit for bit:
//   * dx ascending N in stages of 16 columns with zero padding: the dx
//     blocks run crossbar_bwd.cu's tile code unchanged;
//   * acc ascending M in stages of 32 samples with zero padding, as
//     pulse_update.cu, then its epilogue (__fdiv_rn, rintf, clip, _rn
//     intrinsics so nvcc contracts nothing into FMAs);
//   * y ascending K in stages of 16 lines with zero padding: the y blocks
//     run crossbar_fwd.cu's tile code unchanged.
// No split reductions, no atomics.  Build without --use_fast_math.
//
// Design: one launch holds three kinds of blocks on a one-dimensional grid:
// the update blocks of every core first, then the dx blocks, then the y
// blocks, so the long update blocks are dispatched before the short tiles
// that fill in around them.  An update block owns UBK = 8 fan-in lines of
// one core and all of its N <= 128 columns; it walks the batch in stages
// of 32 samples, each stage's x and d loaded into registers while the
// previous stage computes, and every thread adds the stage's outer
// products to 4 cells of acc (one column, 4 lines: per sample one
// broadcast vector load of x and one load of d), then applies the pulse
// epilogue to its cells.  A dx block owns a 64 x 64 tile of dx and reads
// all of N; a y block (compute_y) a 64 x 64 tile of y and all of K.  dx
// and y blocks read gp/gm while update blocks run, so g+'/g-' always go to
// separate outputs (the wrapper copies them into place when asked to
// update in place).  Splitting dx from the update gives the dx work M/64
// times more blocks than the update's K/8, which matters where a stage has
// only one or two cores.  At most 128 registers a thread, so two blocks
// share an SM.
//
// What bounds it on an H100 SXM: one mnist_class step at M = 4096 (ten
// cores of 400 x 100 over four launches, compute_y off) is 4*M*K*N*10 =
// 6.55 GFLOP = 0.098 ms at 67 TFLOP/s fp32, against ~155 MB = 0.046 ms of
// HBM traffic: operations bound it.  This simple design is far from that:
// it runs on the CUDA cores, limited by shared-memory reads, and the
// update of a stage of T <= 2 cores runs on only 50-100 blocks, each
// walking the whole batch.  Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

// ---- update blocks: the outer product and the pulse update ---------------
constexpr int UBK = 8;        // fan-in lines per update block
constexpr int NMAX = 128;     // columns an update block holds (N <= NMAX)
constexpr int BMC = 32;       // samples per shared-memory stage
constexpr int XPT = BMC * UBK / THREADS;    // x elements per thread/stage
constexpr int DPT = BMC * NMAX / THREADS;   // d elements per thread/stage

// ---- dx blocks: crossbar_bwd.cu's tiling ---------------------------------
constexpr int DBM = 64;       // samples per block
constexpr int DBK = 64;       // fan-in lines per block
constexpr int DBN = 16;       // neurons per shared-memory stage
constexpr int DTM = DBM / 16;
constexpr int DTK = DBK / 16;

// ---- y blocks (compute_y): crossbar_fwd.cu's tiling ----------------------
constexpr int FBM = 64;       // samples per block
constexpr int FBN = 64;       // neurons per block
constexpr int FBK = 16;       // fan-in lines per shared-memory stage
constexpr int FTM = FBM / 16;
constexpr int FTN = FBN / 16;

constexpr int SMEM_UPDATE = BMC * UBK + BMC * NMAX;
constexpr int SMEM_DX = DBN * (DBM + 1) + DBN * (DBK + 1);
constexpr int SMEM_Y = FBK * (FBM + 1) + FBK * FBN;
constexpr int SMEM_FLOATS = SMEM_UPDATE > SMEM_DX
                                ? (SMEM_UPDATE > SMEM_Y ? SMEM_UPDATE : SMEM_Y)
                                : (SMEM_DX > SMEM_Y ? SMEM_DX : SMEM_Y);

static_assert(THREADS == (UBK / 4) * NMAX, "update block thread map");
static_assert(XPT * THREADS == BMC * UBK && DPT * THREADS == BMC * NMAX,
              "stage loads");

template <typename TIn, bool kDequant>
__device__ __forceinline__ float load_d(const TIn* d, size_t i, float s) {
  float v = static_cast<float>(d[i]);
  if (kDequant) v = __fmul_rn(v, s);
  return v;
}

// One batch stage's x (this block's lines) and d (dequantized) into
// registers, every load independent of the others so all are in flight at
// once; the caller issues it before computing on the previous stage.
template <typename TIn, bool kDequant>
__device__ __forceinline__ void fetch_stage(
    float (&xr)[XPT], float (&dr)[DPT], const float* __restrict__ x,
    const TIn* __restrict__ d, float s, int m0, int k0, int M, int K,
    int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const int e = tid + i * THREADS;
    const int row = m0 + e / UBK, col = k0 + e % UBK;
    xr[i] = (row < M && col < K) ? x[static_cast<size_t>(row) * K + col]
                                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int e = tid + i * THREADS;
    const int row = m0 + e / NMAX, n = e % NMAX;
    dr[i] = (row < M && n < N)
                ? load_d<TIn, kDequant>(d, static_cast<size_t>(row) * N + n,
                                        s)
                : 0.f;
  }
}

template <typename TIn, bool kDequant>
__device__ void update_tile(const float* gp, const float* gm,
                            const float* __restrict__ x,
                            const TIn* __restrict__ d, float s,
                            float two_lr, float* gp_out, float* gm_out,
                            int M, int K, int N, float unit, float levels,
                            float w_max, int k0, float* smem) {
  float (*xs)[UBK] = reinterpret_cast<float (*)[UBK]>(smem);
  float (*ds)[NMAX] = reinterpret_cast<float (*)[NMAX]>(smem + BMC * UBK);

  // acc: column an, lines 4 ak .. 4 ak + 3 (a warp shares its lines, so the
  // x loads broadcast and the d loads are one row's consecutive words)
  const int tid = threadIdx.x;
  const int an = tid % NMAX;
  const int ak = tid / NMAX;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  float xr[XPT], dr[DPT];
  fetch_stage<TIn, kDequant>(xr, dr, x, d, s, 0, k0, M, K, N);
  for (int m0 = 0; m0 < M; m0 += BMC) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      xs[e / UBK][e % UBK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int e = tid + i * THREADS;
      ds[e / NMAX][e % NMAX] = dr[i];
    }
    __syncthreads();
    if (m0 + BMC < M)   // the next stage's loads overlap this stage's math
      fetch_stage<TIn, kDequant>(xr, dr, x, d, s, m0 + BMC, k0, M, K, N);
    // pulse_update.cu's stages of 32 samples, zero padding included
#pragma unroll 4
    for (int mm = 0; mm < BMC; ++mm) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[mm][4 * ak]);
      const float b = ds[mm][an];
      acc[0] = fmaf(a.x, b, acc[0]);
      acc[1] = fmaf(a.y, b, acc[1]);
      acc[2] = fmaf(a.z, b, acc[2]);
      acc[3] = fmaf(a.w, b, acc[3]);
    }
    __syncthreads();
  }

  // pulse epilogue, as pulse_update.cu
  if (an >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ak + i;
    if (k >= K) break;
    const size_t o = static_cast<size_t>(k) * N + an;
    float c = rintf(__fdiv_rn(__fmul_rn(two_lr, acc[i]), unit));
    c = fminf(fmaxf(c, -levels), levels);
    const float half = __fmul_rn(0.5f, __fmul_rn(c, unit));
    gp_out[o] = fminf(fmaxf(__fadd_rn(gp[o], half), 0.f), w_max);
    gm_out[o] = fminf(fmaxf(__fsub_rn(gm[o], half), 0.f), w_max);
  }
}

// crossbar_bwd.cu's block, on the tile (m0, k0)
template <typename TIn, bool kDequant>
__device__ void dx_tile(const TIn* __restrict__ dy, float s,
                        const float* gp, const float* gm,
                        float* __restrict__ dx, int M, int K, int N, int m0,
                        int k0, float* smem) {
  float (*ds)[DBM + 1] = reinterpret_cast<float (*)[DBM + 1]>(smem);
  float (*ws)[DBK + 1] =
      reinterpret_cast<float (*)[DBK + 1]>(smem + DBN * (DBM + 1));

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[DTM][DTK];
#pragma unroll
  for (int i = 0; i < DTM; ++i)
#pragma unroll
    for (int j = 0; j < DTK; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += DBN) {
#pragma unroll
    for (int e = tid; e < DBM * DBN; e += THREADS) {
      const int mm = e / DBN, nn = e % DBN;
      const int row = m0 + mm, col = n0 + nn;
      ds[nn][mm] = (row < M && col < N)
                       ? load_d<TIn, kDequant>(
                             dy, static_cast<size_t>(row) * N + col, s)
                       : 0.f;
    }
#pragma unroll
    for (int e = tid; e < DBK * DBN; e += THREADS) {
      const int kk = e / DBN, nn = e % DBN;
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
    for (int nn = 0; nn < DBN; ++nn) {
      float a[DTM], b[DTK];
#pragma unroll
      for (int i = 0; i < DTM; ++i) a[i] = ds[nn][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DTK; ++j) b[j] = ws[nn][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < DTM; ++i)
#pragma unroll
        for (int j = 0; j < DTK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < DTK; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) dx[static_cast<size_t>(m) * K + k] = acc[i][j];
    }
  }
}

// crossbar_fwd.cu's block without activation and ADC, on the tile (m0, n0)
__device__ void y_tile(const float* __restrict__ x, const float* gp,
                       const float* gm, float* __restrict__ y, int M, int K,
                       int N, int m0, int n0, float* smem) {
  float (*xs)[FBM + 1] = reinterpret_cast<float (*)[FBM + 1]>(smem);
  float (*ws)[FBN] =
      reinterpret_cast<float (*)[FBN]>(smem + FBK * (FBM + 1));

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int e = tid; e < FBM * FBK; e += THREADS) {
      const int mm = e / FBK, kk = e % FBK;
      const int row = m0 + mm, col = k0 + kk;
      xs[kk][mm] = (row < M && col < K)
                       ? x[static_cast<size_t>(row) * K + col] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < FBK * FBN; e += THREADS) {
      const int kk = e / FBN, nn = e % FBN;
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
    for (int kk = 0; kk < FBK; ++kk) {
      float a[FTM], b[FTN];
#pragma unroll
      for (int i = 0; i < FTM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < FTN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < FTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// The grid is one-dimensional: first the update blocks of every core, then
// the dx blocks, then the y blocks, so the long update blocks (each walks
// the whole batch) are dispatched before the short tiles that fill in
// around them.  At most 128 registers a thread: two blocks share an SM.
template <typename TIn, bool kDequant>
__global__ void __launch_bounds__(THREADS, 2)
crossbar_train(const float* gp, const float* gm, const float* __restrict__ x,
               const TIn* __restrict__ d, const float* __restrict__ scale,
               const float* __restrict__ lr, float* __restrict__ y,
               float* __restrict__ dx, float* __restrict__ gp_out,
               float* __restrict__ gm_out, int T, int M, int K, int N,
               int compute_y, float unit, float levels, float w_max) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int n_upd = (K + UBK - 1) / UBK;
  const int dx_k_tiles = (K + DBK - 1) / DBK;
  const int n_dx = dx_k_tiles * ((M + DBM - 1) / DBM);
  const int n_y = ((N + FBN - 1) / FBN) * ((M + FBM - 1) / FBM);
  const float s = kDequant ? *scale : 1.f;
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
  const size_t t = b / per;
  const int tile = static_cast<int>(b % per);
  const size_t g_off = t * static_cast<size_t>(K) * N;
  gp += g_off;
  gm += g_off;
  x += t * static_cast<size_t>(M) * K;
  d += t * static_cast<size_t>(M) * N;
  if (role == 0) {
    update_tile<TIn, kDequant>(gp, gm, x, d, s, __fmul_rn(2.f, *lr),
                               gp_out + g_off, gm_out + g_off, M, K, N, unit,
                               levels, w_max, tile * UBK, smem);
  } else if (role == 1) {
    dx_tile<TIn, kDequant>(d, s, gp, gm, dx + t * static_cast<size_t>(M) * K,
                           M, K, N, (tile / dx_k_tiles) * DBM,
                           (tile % dx_k_tiles) * DBK, smem);
  } else {
    const int ntn = (N + FBN - 1) / FBN;
    y_tile(x, gp, gm, y + t * static_cast<size_t>(M) * N, M, K, N,
           (tile / ntn) * FBM, (tile % ntn) * FBN, smem);
  }
}

template <typename TIn, bool kDequant>
int launch(const float* gp, const float* gm, const float* x, const void* d,
           const float* scale, const float* lr, float* y, float* dx,
           float* gp_out, float* gm_out, int T, int M, int K, int N,
           int compute_y, float unit, float levels, float w_max,
           cudaStream_t stream) {
  long long per_core = (K + UBK - 1) / UBK
                       + ((K + DBK - 1) / DBK) * ((M + DBM - 1) / DBM);
  if (compute_y) per_core += ((N + FBN - 1) / FBN) * ((M + FBM - 1) / FBM);
  if (per_core * T > 2147483647LL) return -3;
  crossbar_train<TIn, kDequant>
      <<<static_cast<unsigned>(per_core * T), THREADS, 0, stream>>>(
          gp, gm, x, static_cast<const TIn*>(d), scale, lr, y, dx, gp_out,
          gm_out, T, M, K, N, compute_y, unit, levels, w_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream, or the stream a CUDA graph
// captures).  `d_kind` is 0 for fp32 values (scale unused), 1 for int8 codes
// and 2 for int32 codes, both dequantized with *scale.  `y` is written only
// when compute_y.  gp_out/gm_out must not overlap gp/gm: dx and y blocks
// read the old conductances while update blocks write the new.  Returns
// cudaGetLastError() after the launch: 0 on success, -1 for an unknown
// d_kind, -2 for N > 128, -3 for a grid past 2^31 - 1 blocks.  The caller
// checks shapes, types and contiguity.
extern "C" int crossbar_train_launch(const float* gp, const float* gm,
                                     const float* x, const void* d,
                                     int d_kind, const float* scale,
                                     const float* lr, float* y, float* dx,
                                     float* gp_out, float* gm_out, int T,
                                     int M, int K, int N, int compute_y,
                                     float unit, float levels, float w_max,
                                     void* stream) {
  if (N > NMAX) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d_kind) {
    case 0:
      return launch<float, false>(gp, gm, x, d, scale, lr, y, dx, gp_out,
                                  gm_out, T, M, K, N, compute_y, unit,
                                  levels, w_max, st);
    case 1:
      return launch<int8_t, true>(gp, gm, x, d, scale, lr, y, dx, gp_out,
                                  gm_out, T, M, K, N, compute_y, unit,
                                  levels, w_max, st);
    case 2:
      return launch<int32_t, true>(gp, gm, x, d, scale, lr, y, dx, gp_out,
                                   gm_out, T, M, K, N, compute_y, unit,
                                   levels, w_max, st);
    default:
      return -1;
  }
}
