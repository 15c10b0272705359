// The row product P = A @ B of one core, for Hopper (sm_90a), fp32 on the
// CUDA cores: the forward product y = x @ w of crossbar_fwd.cu and of the
// fused kernel's y blocks, and the error product dx = d @ w^T of
// crossbar_bwd.cu and of the fused kernel's dx blocks, with w = gp - gm
// formed in shared memory.  No
// PyTorch headers: the sources that include it build with nvcc into a
// plain C library.
//
// The summation order is the contract.  Every output is one thread's
// fmaf(a, b, acc) chain over the reduction index r = 0, 1, ..., R-1 (K for
// y, N for dx), starting from 0.f; w = __fsub_rn(gp, gm) is formed in fp32
// before the product and error codes are dequantized as
// __fmul_rn(float(code), scale).  That is the chain of crossbar_fwd.cu's
// and crossbar_bwd.cu's first 64 x 64 tiles, so every tile below, the
// standalone forward and error product and the fused kernel's y and dx
// blocks give the same bits.  Lines past R are skipped instead of added as 0 * 0 (a chain from
// +0 never yields -0, so adding +0 would change no bit).
//
// Design.  A block owns a BM x BC tile of the output of one core.  Its
// compute threads are NTC along the output's columns by NTM along its rows;
// thread (tc, tm) holds a TM x TC register tile of sums: rows tm + NTM i
// (i < TM) and columns TC tc .. TC tc + TC - 1.  A warp holds 8 column
// groups by 4 row groups, or, where NTC is no multiple of 8 (25 groups
// cover N = 100), runs along the rows first: either way it reads at most
// 8 rows of A and 8 vectors of B at once, one pass of the banks each.
// A arrives row-major
// ([m][r]) and is read along r, four lines at a time, as one 16-byte
// vector load per row; B is kept [r][c] and read as one TC-wide vector per
// line.  A's rows sit at a pitch of 4 (mod 8) words, so the rows a warp
// reads at once fall in distinct banks without swizzling (the tensor-map box
// is 4 lines wider than a stage; the extra lines are never summed).  The
// loads of the next four lines are issued before the current ones' fmaf.
//   * forward (fwd_walk): x and g+/g- stream through a ring of S stages of
//     BR fan-in lines, filled by a producer warp: x as one tensor-map box
//     per stage, counted on the stage's `full` mbarrier; g+ and g- as one
//     box each, counted on `landed`, after which the producer forms w in
//     place of g+ and arrives on `full`, so compute warps read one operand.
//     Compute warps release a slot on `empty`; no block barrier in the loop.
//   * error (dx_walk): the block's BC columns of w, over all N <= 128, are
//     formed once, transposed into B ([n][k]), by every thread; then the
//     block walks a run of consecutive BM-row tiles of d, one ring stage
//     per tile holding all N lines, so the copies of the next tiles are in
//     flight while one is summed and stored.  fp32 d arrives as tensor-map
//     boxes; int8 codes as 16-byte cp.async windows that the producer
//     dequantizes; int32 codes and operands no map can describe as 4-byte
//     cp.async copies.  Each tile is made ready as soon as its copies land.
//   * error over any N (dx_ring_walk): the forward's ring with N in the
//     place of K; the producer forms each stage's lines of w^T from g+ and
//     g- boxes (rows of K), so B keeps the forward's layout.
//   Sums leave as one 16-byte store per row where the row allows it.
//
// What bounds it on an H100 SXM: the fp32 rate, 67 TFLOP/s, without TF32.
// A TM x TC tile issues TM + TC vector loads per 4 TM TC fmaf; shared
// memory then feeds the registers at up to 128 bytes a cycle, which a warp
// of 8 TC-wide column groups and 4 row groups uses fully in one access.
// Where a stage of one core has few outputs (T = 1: 409,600 at M = 4096,
// N = 100), small tiles keep several warps on every SM; the launcher picks
// the tile by shape.  Reading g+ and g- for every row tile of a core costs
// 2 BR BC words of L2 traffic per BM BC BR fmaf, so tall tiles pay less.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "outer_product.cuh"

namespace row_product {

using outer_product::commit;
using outer_product::copy16;
using outer_product::copy4;
using outer_product::load_vec;
using outer_product::mbar_arrive;
using outer_product::mbar_expect;
using outer_product::mbar_init;
using outer_product::mbar_wait;
using outer_product::tma_load;

// The tiles crossbar_fwd.cu's launcher may pick: (index, TM, TC, NTC, NTM,
// BR, S).  BM = TM NTM rows and BC = TC NTC columns per block, NTC NTM
// compute threads (rounded up to whole warps) and a producer warp, BR
// fan-in lines per stage, S stages in the ring.  kernels/crossbar.py holds
// the same table (ROW_PRODUCT_TILES) and picks an index.
#define ROW_PRODUCT_TILES(X) \
  X(0, 8, 4, 25, 6, 32, 3) \
  X(1, 8, 4, 25, 8, 32, 3) \
  X(2, 4, 4, 8, 16, 32, 4) \
  X(3, 4, 4, 4, 16, 32, 4)

template <int TM_, int TC_, int NTC_, int NTM_, int BR_, int S_>
struct Tile {
  static constexpr int TM = TM_, TC = TC_, NTC = NTC_, NTM = NTM_;
  static constexpr int BR = BR_, S = S_;
  static constexpr int BM = TM_ * NTM_, BC = TC_ * NTC_;
  static constexpr int ACTIVE = NTC_ * NTM_;               // threads that sum
  static constexpr int COMPUTE = (ACTIVE + 31) / 32 * 32;  // their warps
  static constexpr int THREADS = COMPUTE + 32;             // and a producer
  static constexpr int AP = BR_ + 4;   // A's pitch in words: 4 (mod 8)
  // lanes run along M first unless 8 column groups fill a warp's row, so
  // a warp reads few distinct rows of A and few vectors of B at once
  static constexpr bool MFAST = NTC_ % 8 != 0;
  static_assert(BR_ % 8 == 0 && BC % 4 == 0 && (TC_ == 2 || TC_ == 4),
                "a stage is whole 4-line groups at a bank-spreading pitch");
};

// The fused kernel's dx and y blocks: 4 x 4 register tiles, a warp of 8
// column groups by 4 row groups, as many threads as the update walk.
template <int COMPUTE>
using TrainTile = Tile<4, 4, 8, COMPUTE / 8, 32, 3>;

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Arrive on a barrier's current phase and expect `bytes` of tensor copies
// on it, in one step.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(outer_product::smem_addr(bar)), "r"(bytes)
               : "memory");
}

// ---- forward: shared memory ----------------------------------------------

// One ring stage: A (BM x AP words), g+ (becomes w) and g- (BR x BC each).
template <class C>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return round128(4 * C::BM * C::AP) + 2 * round128(4 * C::BR * C::BC);
}

template <class C>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return C::S * fwd_stage_bytes<C>() + 24 * C::S;   // three mbarriers a slot
}

// How the forward reaches its operands: 2-D tensor maps of x (T M, K) and
// of g+ and g- (T K, N), each used where `tma` has its bit.
struct FwdMaps {
  CUtensorMap x, gp, gm;
  int tma;
};
constexpr int kTmaX = 1, kTmaG = 2;

// w = gp - gm over `n4` vectors of 4, in place of gp, by the producer lanes
__device__ __forceinline__ void form_w(float* gp, const float* gm, int n4,
                                       int lane) {
  for (int e = lane; e < n4; e += 32) {
    const float4 p = reinterpret_cast<const float4*>(gp)[e];
    const float4 q = reinterpret_cast<const float4*>(gm)[e];
    reinterpret_cast<float4*>(gp)[e] =
        make_float4(__fsub_rn(p.x, q.x), __fsub_rn(p.y, q.y),
                    __fsub_rn(p.z, q.z), __fsub_rn(p.w, q.w));
  }
}

// Sum 4 lines: a[i][u] is row i's value of line u, b[u][j] line u's value
// of column j; every output takes its 4 lines in ascending order.
template <class C>
__device__ __forceinline__ void fma4(const float (&a)[C::TM][4],
                                     const float (&b)[4][C::TC],
                                     float (&acc)[C::TM][C::TC]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TC; ++j)
        acc[i][j] = fmaf(a[i][u], b[u][j], acc[i][j]);
}

// Load the 4-line group starting at line r: A at `as` (a thread's first
// row; its rows `ars` words apart), B at `bs` (its first column; lines `bp`
// words apart).
template <class C>
__device__ __forceinline__ void load4(float (&a)[C::TM][4],
                                      float (&b)[4][C::TC], const float* as,
                                      int ars, const float* bs, int bp,
                                      int r) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i) load_vec<4>(a[i], as + i * ars + r);
#pragma unroll
  for (int u = 0; u < 4; ++u) load_vec<C::TC>(b[u], bs + (r + u) * bp);
}

// Sum `lines` lines (any count), 4 at a time with the next group's loads
// in flight, then one at a time.
template <class C>
__device__ __forceinline__ void sum_lines(const float* as, int ars,
                                          const float* bs, int bp, int lines,
                                          float (&acc)[C::TM][C::TC]) {
  const int groups = lines / 4;
  float a0[C::TM][4], b0[4][C::TC], a1[C::TM][4], b1[4][C::TC];
  int g = 0;
  if (groups > 0) load4<C>(a0, b0, as, ars, bs, bp, 0);
  for (; g + 2 <= groups; g += 2) {
    load4<C>(a1, b1, as, ars, bs, bp, 4 * g + 4);
    fma4<C>(a0, b0, acc);
    if (g + 2 < groups) load4<C>(a0, b0, as, ars, bs, bp, 4 * g + 8);
    fma4<C>(a1, b1, acc);
  }
  if (g < groups) fma4<C>(a0, b0, acc);
  for (int r = 4 * groups; r < lines; ++r) {
    float b[C::TC];
    load_vec<C::TC>(b, bs + r * bp);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const float a = as[i * ars + r];
#pragma unroll
      for (int j = 0; j < C::TC; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// A full forward stage of BR lines, fully unrolled: every shared address
// is a constant offset from the thread's bases.
template <class C>
__device__ __forceinline__ void sum_stage(const float* as, const float* bs,
                                          float (&acc)[C::TM][C::TC]) {
  constexpr int G = C::BR / 4;
  constexpr int ARS = C::NTM * C::AP;
  float a[2][C::TM][4], b[2][4][C::TC];
  load4<C>(a[0], b[0], as, ARS, bs, C::BC, 0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g + 1 < G) load4<C>(a[(g + 1) & 1], b[(g + 1) & 1], as, ARS, bs,
                            C::BC, 4 * g + 4);
    fma4<C>(a[g & 1], b[g & 1], acc);
  }
}

// A compute thread's first row and first column inside the block tile, and
// whether it sums at all (the last warp may hold idle lanes).
template <class C>
__device__ __forceinline__ int tile_m() {
  const int tid = threadIdx.x;
  return C::MFAST ? tid % C::NTM : tid / C::NTC;
}

template <class C>
__device__ __forceinline__ int tile_c() {
  const int tid = threadIdx.x;
  return (C::MFAST ? tid / C::NTM : tid % C::NTC) * C::TC;
}

template <class C>
__device__ __forceinline__ bool active() {
  return threadIdx.x < C::ACTIVE;
}

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::TM][C::TC]) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TC; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = sum over k ascending of x[m0 + tile_m + NTM i][k] *
// w[k][c0 + tile_c + j] for core t, in every active compute thread: x
// (M, K), gp and gm (K, N) are that core's, rows t M .. and t K .. of the
// tensor maps.  `smem` holds fwd_smem_bytes<C>().  Every thread of the
// block calls it; the producer warp's acc stays 0.
//
// Each slot of the ring has three mbarriers.  `landed` completes when the
// slot's g+ and g- boxes have landed (the producer arrives as it issues
// them, expecting their bytes): the producer waits on it, forms w and
// arrives on `full`, which also counts the x box; `empty` completes when
// every compute warp has arrived, done with the slot.
template <class C>
__device__ __forceinline__ void fwd_walk(const float* __restrict__ x,
                                         const float* __restrict__ gp,
                                         const float* __restrict__ gm, int M,
                                         int K, int N, int t, int m0, int c0,
                                         const FwdMaps& maps, char* smem,
                                         float (&acc)[C::TM][C::TC]) {
  constexpr int SB = fwd_stage_bytes<C>();
  constexpr int A_BYTES = round128(4 * C::BM * C::AP);
  constexpr int G_BYTES = round128(4 * C::BR * C::BC);
  constexpr int WARPS = C::COMPUTE / 32;
  const bool tma_x = maps.tma & kTmaX;
  const bool tma_g = maps.tma & kTmaG;
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + C::S * SB);
  uint64_t* full = landed + C::S;
  uint64_t* empty = full + C::S;
  const int lane = threadIdx.x % 32;
  const int stages = (K + C::BR - 1) / C::BR;
  zero<C>(acc);
  if (threadIdx.x == C::COMPUTE) {
#pragma unroll
    for (int s = 0; s < C::S; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto lines_of = [&](int st) { return min(C::BR, K - st * C::BR); };

  if (threadIdx.x >= C::COMPUTE) {   // the producer warp
    auto issue = [&](int st) {
      char* slot = smem + (st % C::S) * SB;
      float* as = reinterpret_cast<float*>(slot);
      float* ps = reinterpret_cast<float*>(slot + A_BYTES);
      float* ns = reinterpret_cast<float*>(slot + A_BYTES + G_BYTES);
      const int k0 = st * C::BR, lines = lines_of(st);
      if (lane == 0) {
        if (tma_g) {
          mbar_arrive_expect(&landed[st % C::S], 2 * 4 * C::BR * C::BC);
          tma_load(ps, &maps.gp, c0, t * K + k0, &landed[st % C::S]);
          tma_load(ns, &maps.gm, c0, t * K + k0, &landed[st % C::S]);
        }
        if (tma_x) {
          mbar_expect(&full[st % C::S], 4 * C::BM * C::AP);
          tma_load(as, &maps.x, k0, t * M + m0, &full[st % C::S]);
        }
      }
      if (!tma_x) {
        const int rows = min(C::BM, M - m0);
        for (int e = lane; e < rows * lines; e += 32) {
          const int r = e / lines, c = e % lines;
          copy4(as + r * C::AP + c,
                x + static_cast<size_t>(m0 + r) * K + k0 + c);
        }
      }
      if (!tma_g) {
        const int cols = min(C::BC, N - c0);
        for (int e = lane; e < lines * cols; e += 32) {
          const int r = e / cols, c = e % cols;
          const size_t o = static_cast<size_t>(k0 + r) * N + c0 + c;
          copy4(ps + r * C::BC + c, gp + o);
          copy4(ns + r * C::BC + c, gm + o);
        }
      }
      commit();
    };
    auto ready = [&](int st) {
      char* slot = smem + (st % C::S) * SB;
      if (tma_g) mbar_wait(&landed[st % C::S], (st / C::S) & 1);
      form_w(reinterpret_cast<float*>(slot + A_BYTES),
             reinterpret_cast<const float*>(slot + A_BYTES + G_BYTES),
             lines_of(st) * C::BC / 4, lane);
      // the next boxes into this slot come through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st % C::S]);
    };
    for (int st = 0; st < stages; ++st) {
      if (st >= C::S) mbar_wait(&empty[st % C::S], (st / C::S + 1) & 1);
      issue(st);
      if (st > 0) {
        outer_product::wait_pending<1>();   // all but stage st's copies
        ready(st - 1);
      }
    }
    outer_product::wait_pending<0>();
    ready(stages - 1);
    return;
  }

  const bool on = active<C>();
  const int a_off = tile_m<C>() * C::AP;
  const int b_off = A_BYTES / 4 + tile_c<C>();
  for (int st = 0; st < stages; ++st) {
    mbar_wait(&full[st % C::S], (st / C::S) & 1);
    const float* base = reinterpret_cast<const float*>(smem + (st % C::S)
                                                       * SB);
    const int lines = lines_of(st);
    if (on) {
      if (lines == C::BR)
        sum_stage<C>(base + a_off, base + b_off, acc);
      else
        sum_lines<C>(base + a_off, C::NTM * C::AP, base + b_off, C::BC,
                     lines, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % C::S]);
  }
}

// ---- error product: shared memory ------------------------------------------

// A's pitch for a stage that holds all N lines: the least P >= N with P a
// multiple of 4 and P / 4 odd (4 mod 8 words: the rows a warp reads at
// once fall in distinct banks).
__host__ __device__ constexpr int dx_pitch(int N) {
  return (N + 3) / 4 % 2 ? (N + 3) / 4 * 4 : (N + 3) / 4 * 4 + 4;
}

// bytes of one row of int8 codes: N codes starting anywhere in an aligned
// 16-byte window, plus the next windows
__host__ __device__ constexpr int dx_code_row(int N) {
  return (dx_pitch(N) + 15) / 16 * 16 + 16;
}

// One ring stage: A (BM x P words) and, for int8 codes, their raw bytes.
template <class C>
__host__ __device__ constexpr int dx_stage_bytes(int N, int d_bytes) {
  return round128(4 * C::BM * dx_pitch(N)) +
         (d_bytes == 1 ? round128(C::BM * dx_code_row(N)) : 0);
}

// B (N x (BC + 4) words: w's BC columns, transposed), then the ring, then
// two mbarriers a slot.
template <class C>
__host__ __device__ constexpr int dx_b_bytes(int N) {
  return round128(4 * N * (C::BC + 4));
}

template <class C>
__host__ __device__ constexpr int dx_smem_bytes(int N, int d_bytes) {
  return dx_b_bytes<C>(N) + C::S * dx_stage_bytes<C>(N, d_bytes) + 16 * C::S;
}

// The int8 codes of `rows` rows of `count` codes each (row r from src + r *
// ld) as the aligned 16-byte windows that hold them, by the 32 producer
// lanes: row r lands at raw + r * RB, its first code at byte (address &
// 15).  A window holding a wanted byte lies in one aligned 16 bytes, so it
// never crosses a page; its other bytes are never used.
__device__ __forceinline__ void copy_code_windows(unsigned char* raw, int RB,
                                                  const int8_t* src, int ld,
                                                  int count, int rows,
                                                  int lane) {
  const int cpr = RB / 16;
  for (int e = lane; e < rows * cpr; e += 32) {
    const int r = e / cpr, c = e % cpr;
    const int8_t* a = src + static_cast<size_t>(r) * ld;
    const int8_t* w = reinterpret_cast<const int8_t*>(
        reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15)) + 16 * c;
    if (w < a + count) copy16(raw + r * RB + 16 * c, w);
  }
}

// Dequantize landed int8 codes (`rows` rows of `count` codes, row r from
// src + r * ld, landed by copy_code_windows at raw + r * RB) into A (row
// pitch P words), 4 codes a thread per step, each as
// __fmul_rn(float(code), scale), by `threads` threads of which this is
// number `first` (the producer's 32 lanes, or every compute thread).
// Lines past `count` get whatever the windows held; they are never
// summed.
__device__ __forceinline__ void dequant_rows(float* as, int P,
                                             const unsigned char* raw,
                                             int RB, const int8_t* src,
                                             int ld, int count, int rows,
                                             float scale, int first,
                                             int threads = 32) {
  const int qpr = (count + 3) / 4;
#pragma unroll 1
  for (int e = first; e < rows * qpr; e += threads) {
    const int r = e / qpr, c = 4 * (e % qpr);
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(
                        src + static_cast<size_t>(r) * ld) & 15) + c;
    const unsigned* w =
        reinterpret_cast<const unsigned*>(raw + r * RB) + off / 4;
    const unsigned q = __byte_perm(w[0], w[1], 0x3210 + 0x1111 * (off & 3))
                       ^ 0x80808080u;
    float4 v;
    v.x = __fmul_rn(outer_product::code_value(q, 0), scale);
    v.y = __fmul_rn(outer_product::code_value(q, 1), scale);
    v.z = __fmul_rn(outer_product::code_value(q, 2), scale);
    v.w = __fmul_rn(outer_product::code_value(q, 3), scale);
    *reinterpret_cast<float4*>(as + r * P + c) = v;
  }
}

// Store a compute thread's TM x TC sums at rows m0 + tile_m + NTM i and
// columns c0 + tile_c + j of a row-major (M, ld) matrix: one 16-byte store
// a row where the row's TC = 4 columns lie inside and aligned (`vec`: out
// 16-byte aligned and ld a multiple of 4), else one value at a time.
template <class C>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[C::TM][C::TC],
                                           int M, int ld, int m0, int c0,
                                           bool vec) {
  const int c = c0 + tile_c<C>();
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + tile_m<C>() + C::NTM * i;
    if (m >= M) break;
    float* row = out + static_cast<size_t>(m) * ld + c;
    if constexpr (C::TC == 4) {
      if (vec && c + 4 <= ld) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < C::TC; ++j)
      if (c + j < ld) row[j] = acc[i][j];
  }
}

// dx[m][k] = sum over n ascending of d[m][n] * w[k][n] for core t, for the
// block's columns k0 .. k0 + BC - 1 and its `tiles` consecutive row tiles
// from row tile mt0, stored as each tile is done: d (M, N) as TD (float,
// or int8 / int32 codes dequantized with `scale`), gp, gm (K, N) and dx
// (M, K) are that core's; `dmap` is the tensor map of fp32 d (T M, N) in
// boxes of (BM, P), used where `tma_d`.  `smem` holds dx_smem_bytes<C>(N,
// sizeof(TD)).  Every thread of the block calls it.
template <class C, typename TD>
__device__ __forceinline__ void dx_walk(const TD* __restrict__ d,
                                        float scale,
                                        const float* __restrict__ gp,
                                        const float* __restrict__ gm,
                                        float* __restrict__ dx, int M, int K,
                                        int N, int t, int k0, int mt0,
                                        int tiles, const CUtensorMap* dmap,
                                        bool tma_d, char* smem) {
  constexpr int BP = C::BC + 4;   // B's pitch in words
  constexpr int WARPS = C::COMPUTE / 32;
  constexpr bool kBytes = sizeof(TD) == 1;
  constexpr bool kInt32 = !kBytes && !std::is_same<TD, float>::value;
  const int P = dx_pitch(N);
  const int RB = dx_code_row(N);
  const int SB = dx_stage_bytes<C>(N, sizeof(TD));
  const int A_BYTES = round128(4 * C::BM * P);
  float* bsm = reinterpret_cast<float*>(smem);
  char* ring = smem + dx_b_bytes<C>(N);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::S * SB);
  uint64_t* empty = full + C::S;
  const int lane = threadIdx.x % 32;
  tma_d = tma_d && std::is_same<TD, float>::value;

  if (threadIdx.x == C::COMPUTE) {
#pragma unroll
    for (int s = 0; s < C::S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // B[n][kk] = w[k0 + kk][n], read along n (coalesced), by every thread,
  // U elements a thread at a time so that their loads are in flight
  // together (columns past K hold 0 - 0 = +0, never stored)
  constexpr int U = 8;
  for (int e0 = threadIdx.x; e0 < C::BC * N; e0 += U * C::THREADS) {
    float p[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * C::THREADS, kk = e / N;
      p[u] = q[u] = 0.f;
      if (e < C::BC * N && k0 + kk < K) {
        const size_t o = static_cast<size_t>(k0 + kk) * N + e % N;
        p[u] = gp[o];
        q[u] = gm[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * C::THREADS;
      if (e < C::BC * N) bsm[(e % N) * BP + e / N] = __fsub_rn(p[u], q[u]);
    }
  }
  __syncthreads();

  auto slot = [&](int j) { return ring + (j % C::S) * SB; };
  auto rows_of = [&](int j) { return min(C::BM, M - (mt0 + j) * C::BM); };

  if (threadIdx.x >= C::COMPUTE) {   // the producer warp
    auto issue = [&](int j) {
      float* as = reinterpret_cast<float*>(slot(j));
      const int m0 = (mt0 + j) * C::BM, rows = rows_of(j);
      const TD* dg = d + static_cast<size_t>(m0) * N;
      if (tma_d) {
        if (lane == 0) {
          mbar_expect(&full[j % C::S], 4 * C::BM * P);
          tma_load(as, dmap, 0, t * M + m0, &full[j % C::S]);
        }
      } else if constexpr (kBytes) {
        copy_code_windows(
            reinterpret_cast<unsigned char*>(slot(j) + A_BYTES), RB,
            reinterpret_cast<const int8_t*>(dg), N, N, rows, lane);
      } else {
        for (int e = lane; e < rows * N; e += 32) {
          const int r = e / N, c = e % N;
          copy4(as + r * P + c, dg + static_cast<size_t>(r) * N + c);
        }
      }
      commit();
    };
    auto ready = [&](int j) {
      float* as = reinterpret_cast<float*>(slot(j));
      const int rows = rows_of(j);
      __syncwarp();   // every lane's copies of the tile have landed
      if constexpr (kBytes) {
        dequant_rows(as, P,
                     reinterpret_cast<const unsigned char*>(slot(j) + A_BYTES),
                     RB, reinterpret_cast<const int8_t*>(d) +
                         static_cast<size_t>((mt0 + j) * C::BM) * N,
                     N, N, rows, scale, lane);
      } else if constexpr (kInt32) {
        for (int e = lane; e < rows * N; e += 32) {
          const int r = e / N, c = e % N;
          as[r * P + c] = __fmul_rn(
              static_cast<float>(__float_as_int(as[r * P + c])), scale);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[j % C::S]);
    };
    // a tile is one long stage: ready it as soon as its own copies land
    // (at once for a tensor-map box), so it never waits for the slot of
    // the tile after it to empty
    for (int j = 0; j < tiles; ++j) {
      if (j >= C::S) mbar_wait(&empty[j % C::S], (j / C::S + 1) & 1);
      issue(j);
      outer_product::wait_pending<0>();
      ready(j);
    }
    return;
  }

  const bool on = active<C>();
  const int tm = tile_m<C>(), tc = tile_c<C>();
  const float* bs = bsm + tc;
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  for (int j = 0; j < tiles; ++j) {
    mbar_wait(&full[j % C::S], (j / C::S) & 1);
    float acc[C::TM][C::TC];
    zero<C>(acc);
    if (on) {
      const float* as = reinterpret_cast<const float*>(slot(j)) + tm * P;
      sum_lines<C>(as, C::NTM * P, bs, BP, N, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % C::S]);
    if (on) store_tile<C>(dx, acc, M, K, (mt0 + j) * C::BM, k0, vec);
  }
}

// ---- error product over a ring of N stages (any N) ------------------------

// How the ring walk reaches its operands: 2-D tensor maps of fp32 d (T M,
// N) in boxes of (BM, AP) and of g+ and g- (T K, N) in boxes of (BC, AP),
// each used where `tma` has its bit (kTmaX for d, kTmaG for both g).
struct DxMaps {
  CUtensorMap d, gp, gm;
  int tma;
};

// bytes of one row of int8 codes in a ring stage: BR codes starting
// anywhere in an aligned 16-byte window, plus the next windows
template <class C>
__host__ __device__ constexpr int dxr_code_row() {
  return (C::BR + 15) / 16 * 16 + 16;
}

// One ring stage: A (BM x AP words of d), B (BR x BC words: the stage's
// lines of w^T), the g+ and g- boxes (BC x AP words each) and, for int8
// codes, their raw bytes.
template <class C>
__host__ __device__ constexpr int dxr_stage_bytes(int d_bytes) {
  return round128(4 * C::BM * C::AP) + round128(4 * C::BR * C::BC) +
         2 * round128(4 * C::BC * C::AP) +
         (d_bytes == 1 ? round128(C::BM * dxr_code_row<C>()) : 0);
}

template <class C>
__host__ __device__ constexpr int dxr_smem_bytes(int d_bytes) {
  return C::S * dxr_stage_bytes<C>(d_bytes) + 24 * C::S;   // 3 mbarriers
}

// B[n][kk] = g+[kk][n] - g-[kk][n] for a stage's `lines` lines (rounded up
// to whole 4-line groups; the extra lines of B are never summed), from the
// g boxes (BC rows of AP words), by the producer lanes: a lane reads 4
// lines of one row as a vector (8 lanes, 8 rows at a pitch of 4 mod 8
// words: distinct banks) and stores them down a column of B (consecutive
// lanes, consecutive columns).
template <class C>
__device__ __forceinline__ void form_wt(float* bs, const float* ps,
                                        const float* ns, int lines,
                                        int lane) {
  const int groups = (lines + 3) / 4;
#pragma unroll 1
  for (int e = lane; e < groups * C::BC; e += 32) {
    const int kk = e % C::BC, q = 4 * (e / C::BC);
    const float4 p = *reinterpret_cast<const float4*>(ps + kk * C::AP + q);
    const float4 m = *reinterpret_cast<const float4*>(ns + kk * C::AP + q);
    float* b = bs + q * C::BC + kk;
    b[0] = __fsub_rn(p.x, m.x);
    b[C::BC] = __fsub_rn(p.y, m.y);
    b[2 * C::BC] = __fsub_rn(p.z, m.z);
    b[3 * C::BC] = __fsub_rn(p.w, m.w);
  }
}

// dx[m][k] = sum over n ascending of d[m][n] * w[k][n] for core t, for the
// block's BM x BC tile at rows m0.. and columns k0.., stored when done: d
// (M, N) as TD (float, or int8 / int32 codes dequantized with `scale`), gp,
// gm (K, N) and dx (M, K) are that core's.  Any N: the walk rings N in
// stages of BR lines, as fwd_walk rings K.  The producer lands a stage's d
// rows and its BC rows of g+ and g-, forms the stage's lines of w^T into B
// (and dequantizes int32 codes in A), so the compute warps read the
// forward's layout (A [m][n] at pitch AP, B [n][k] at pitch BC) and sum
// with its loops.  int8 codes are dequantized into A by the compute
// threads, each a share, behind a barrier of theirs: a stage is short, and
// one producer warp dequantizing every stage held the walk back.  `smem`
// holds dxr_smem_bytes<C>(sizeof(TD)).  Every thread of the block calls it.
//
// Each slot has fwd_walk's three mbarriers: `landed` (the g boxes, which
// the producer waits on before it forms B), `full` (d's box and the
// producer's arrival once B and the copies are ready) and `empty`.
template <class C, typename TD>
__device__ __forceinline__ void dx_ring_walk(const TD* __restrict__ d,
                                             float scale,
                                             const float* __restrict__ gp,
                                             const float* __restrict__ gm,
                                             float* __restrict__ dx, int M,
                                             int K, int N, int t, int m0,
                                             int k0, const DxMaps& maps,
                                             char* smem) {
  constexpr int RB = dxr_code_row<C>();
  constexpr int A_BYTES = round128(4 * C::BM * C::AP);
  constexpr int B_BYTES = round128(4 * C::BR * C::BC);
  constexpr int G_BYTES = round128(4 * C::BC * C::AP);
  constexpr int SB = dxr_stage_bytes<C>(sizeof(TD));
  constexpr int WARPS = C::COMPUTE / 32;
  constexpr bool kFloat = std::is_same<TD, float>::value;
  constexpr bool kBytes = sizeof(TD) == 1;
  constexpr bool kInt32 = !kBytes && !kFloat;
  const bool tma_d = kFloat && (maps.tma & kTmaX);
  const bool tma_g = maps.tma & kTmaG;
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + C::S * SB);
  uint64_t* full = landed + C::S;
  uint64_t* empty = full + C::S;
  const int lane = threadIdx.x % 32;
  const int stages = (N + C::BR - 1) / C::BR;
  const int rows = min(C::BM, M - m0);
  if (threadIdx.x == C::COMPUTE) {
#pragma unroll
    for (int s = 0; s < C::S; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto slot = [&](int st) { return smem + (st % C::S) * SB; };
  auto lines_of = [&](int st) { return min(C::BR, N - st * C::BR); };

  if (threadIdx.x >= C::COMPUTE) {   // the producer warp
    auto issue = [&](int st) {
      float* as = reinterpret_cast<float*>(slot(st));
      float* ps = reinterpret_cast<float*>(slot(st) + A_BYTES + B_BYTES);
      float* ns = ps + G_BYTES / 4;
      const int n0 = st * C::BR, lines = lines_of(st);
      if (lane == 0) {
        if (tma_g) {
          mbar_arrive_expect(&landed[st % C::S], 2 * 4 * C::BC * C::AP);
          tma_load(ps, &maps.gp, n0, t * K + k0, &landed[st % C::S]);
          tma_load(ns, &maps.gm, n0, t * K + k0, &landed[st % C::S]);
        }
        if (tma_d) {
          mbar_expect(&full[st % C::S], 4 * C::BM * C::AP);
          tma_load(as, &maps.d, n0, t * M + m0, &full[st % C::S]);
        }
      }
      const TD* dg = d + static_cast<size_t>(m0) * N + n0;
      if constexpr (kBytes) {
        copy_code_windows(reinterpret_cast<unsigned char*>(
                              slot(st) + A_BYTES + B_BYTES + 2 * G_BYTES),
                          RB, dg, N, lines, rows, lane);
      } else if (!tma_d) {
        for (int e = lane; e < rows * lines; e += 32) {
          const int r = e / lines, c = e % lines;
          copy4(as + r * C::AP + c, dg + static_cast<size_t>(r) * N + c);
        }
      }
      if (!tma_g) {
        const int cols = min(C::BC, K - k0);
        for (int e = lane; e < cols * lines; e += 32) {
          const int r = e / lines, c = e % lines;
          const size_t o = static_cast<size_t>(k0 + r) * N + n0 + c;
          copy4(ps + r * C::AP + c, gp + o);
          copy4(ns + r * C::AP + c, gm + o);
        }
      }
      commit();
    };
    auto ready = [&](int st) {
      float* as = reinterpret_cast<float*>(slot(st));
      const float* ps =
          reinterpret_cast<const float*>(slot(st) + A_BYTES + B_BYTES);
      const int lines = lines_of(st);
      if (tma_g) mbar_wait(&landed[st % C::S], (st / C::S) & 1);
      __syncwarp();   // every lane's copies of the stage have landed
      form_wt<C>(reinterpret_cast<float*>(slot(st) + A_BYTES), ps,
                 ps + G_BYTES / 4, lines, lane);
      if constexpr (kInt32) {
        for (int e = lane; e < rows * lines; e += 32) {
          const int r = e / lines, c = e % lines;
          as[r * C::AP + c] = __fmul_rn(
              static_cast<float>(__float_as_int(as[r * C::AP + c])), scale);
        }
      }
      // the next boxes into this slot come through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st % C::S]);
    };
    for (int st = 0; st < stages; ++st) {
      if (st >= C::S) mbar_wait(&empty[st % C::S], (st / C::S + 1) & 1);
      issue(st);
      if (st > 0) {
        outer_product::wait_pending<1>();   // all but stage st's copies
        ready(st - 1);
      }
    }
    outer_product::wait_pending<0>();
    ready(stages - 1);
    return;
  }

  const bool on = active<C>();
  const int a_off = tile_m<C>() * C::AP;
  const int b_off = A_BYTES / 4 + tile_c<C>();
  float acc[C::TM][C::TC];
  zero<C>(acc);
  for (int st = 0; st < stages; ++st) {
    mbar_wait(&full[st % C::S], (st / C::S) & 1);
    if constexpr (kBytes) {   // every compute thread dequantizes a share
      const unsigned char* raw = reinterpret_cast<const unsigned char*>(
          slot(st) + A_BYTES + B_BYTES + 2 * G_BYTES);
      const int8_t* src = d + static_cast<size_t>(m0) * N + st * C::BR;
      dequant_rows(reinterpret_cast<float*>(slot(st)), C::AP, raw, RB, src,
                   N, lines_of(st), rows, scale, threadIdx.x, C::COMPUTE);
      // the compute threads only: the producer is not at this barrier
      asm volatile("bar.sync 1, %0;\n" :: "r"(C::COMPUTE) : "memory");
    }
    const float* base = reinterpret_cast<const float*>(slot(st));
    // not sum_stage: its full unroll costs some 50 registers a thread here
    if (on)
      sum_lines<C>(base + a_off, C::NTM * C::AP, base + b_off, C::BC,
                   lines_of(st), acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % C::S]);
  }
  if (on)
    store_tile<C>(dx, acc, M, K, m0, k0,
                  K % 4 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0);
}

// ---- host side -------------------------------------------------------------

// The forward's operands over T cores: x (T M, K) in boxes of (BM, AP),
// g+ and g- (T K, N) in boxes of (BR, BC), each by tensor map where one can
// read it (both g maps or neither).
template <class C>
inline FwdMaps fwd_maps(const float* x, const float* gp, const float* gm,
                        int T, int M, int K, int N) {
  FwdMaps maps{};
  if (outer_product::tensor_map(&maps.x, x, static_cast<long long>(T) * M,
                                K, C::BM, C::AP))
    maps.tma |= kTmaX;
  const long long rows = static_cast<long long>(T) * K;
  if (outer_product::tensor_map(&maps.gp, gp, rows, N, C::BR, C::BC) &&
      outer_product::tensor_map(&maps.gm, gm, rows, N, C::BR, C::BC))
    maps.tma |= kTmaG;
  return maps;
}

}  // namespace row_product
