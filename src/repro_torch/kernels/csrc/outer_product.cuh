// The batch-summed outer product acc = x^T @ d of one core, for Hopper
// (sm_90a), fp32 on the CUDA cores: the product that crossbar_dw.cu stores
// and pulse_update.cu turns into a pulse update.  Both kernels instantiate
// the walk below, so their sums cannot drift apart.  No PyTorch headers:
// the sources that include it build with nvcc into a plain C library.
//
// The summation order is the contract.  Every output cell is one thread's
// fmaf(x, d, acc) chain over the samples m = 0, 1, ..., M-1, starting from
// 0.f; error codes are dequantized as __fmul_rn(float(code), scale) before
// the product.  That is the order of crossbar_train.cu's update blocks, so
// the fused kernel equals the four-call sequence bit for bit.  Rows past M
// are skipped instead of added as 0 * 0: the chain starts at +0 and an
// fmaf from +0 never yields -0, so adding +0 would change no bit.
//
// Design.  A block owns a BK x BN tile of the output of one core and walks
// the whole batch itself, BM samples a stage, through a ring of S stages in
// shared memory.  Its last warp is a producer: it keeps the next S - 1
// stages in flight and prepares each before it is summed, so the compute
// warps never wait on device memory or copy anything themselves.
//   * x (T M, K) and fp32 d (T M, N) arrive as one tensor-memory-accelerator
//     box per stage each (a 2-D tensor map; one instruction, counted on the
//     stage's mbarrier).  A matrix no map can describe (a base not 16-byte
//     aligned, a row not a multiple of 16 bytes) arrives as 4-byte cp.async
//     copies instead.
//   * int8 codes arrive as bytes, 16 to a copy (cp.async), through 16-byte
//     windows aligned on the absolute address, since a row of N codes
//     starts anywhere; the producer then reads them from shared memory, 4
//     at a time, into registers, dequantizes them there and stores fp32 d
//     for the product.  int32 codes arrive as 4-byte copies and are
//     dequantized in place.
// Each compute warp is 8 lanes along K by 4 along N; each thread holds a
// TK x TN register tile of sums and reads, per sample, TK values of x and
// TN of d as one vector load each (LDS.64 / LDS.128), the loads of the
// next few samples issued before the current ones' fmaf.  A block is WK x
// WN compute warps and the producer.  The launcher picks the tile by shape
// (the order does not depend on it).
//
// What bounds it on an H100 SXM: shared memory delivers 128 bytes a cycle
// to an SM's registers, and a TK x TN tile needs 4 (TK + TN) bytes for its
// TK TN fmaf: a 4 x 4 tile reaches half the fp32 rate (67 TFLOP/s), a 2 x 2
// tile a quarter.  Large tiles leave few warps where the output is small,
// so the launcher weighs the two.  Below some hundred thousand outputs the
// dependent chain of M fmaf per cell, about 4 cycles each, is the floor:
// some 16 k cycles, about 9 us, at M = 4096 whatever the tile.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace outer_product {

// The tiles a launcher may pick: (index, TK, TN, WK, WN, BM, S).  BK =
// 8 TK WK fan-in lines and BN = 4 TN WN columns per block, 32 WK WN compute
// threads and a producer warp, BM samples per stage, S stages in the ring.
// kernels/crossbar.py holds the same table (OUTER_PRODUCT_TILES) and picks
// an index.
#define OUTER_PRODUCT_TILES(X) \
  X(0, 4, 4, 5, 1, 32, 4) \
  X(1, 4, 2, 1, 4, 64, 4) \
  X(2, 4, 2, 3, 1, 64, 4) \
  X(3, 2, 2, 3, 1, 64, 4) \
  X(4, 4, 2, 1, 4, 32, 4)

template <int TK_, int TN_, int WK_, int WN_, int BM_, int S_>
struct Tile {
  static constexpr int TK = TK_, TN = TN_, BM = BM_, S = S_;
  static constexpr int WN = WN_;
  static constexpr int COMPUTE = 32 * WK_ * WN_;   // threads that sum
  static constexpr int THREADS = COMPUTE + 32;     // and the producer warp
  static constexpr int BK = 8 * TK_ * WK_;
  static constexpr int BN = 4 * TN_ * WN_;
  // bytes of one row of int8 codes in shared memory: BN codes starting
  // anywhere in an aligned 16-byte window, plus the next window
  static constexpr int RB = (BN + 15) / 16 * 16 + 16;
};

// Shared-memory bytes of one ring stage, a multiple of 128 (the alignment
// of a tensor-map box): x (BM x BK fp32), d (BM x BN fp32) and, for int8
// codes, the raw bytes (BM x RB).
template <class C, typename TD>
__host__ __device__ constexpr int stage_bytes() {
  return (4 * C::BM * (C::BK + C::BN)
          + (sizeof(TD) == 1 ? C::BM * C::RB : 0) + 127) / 128 * 128;
}

// Dynamic shared memory of a block: the ring, then two mbarriers a stage.
template <class C, typename TD>
__host__ __device__ constexpr int smem_bytes() {
  return C::S * stage_bytes<C, TD>() + 16 * C::S;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count));
}

// Expect `bytes` of tensor copies on a barrier's current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=: mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One box of a 2-D tensor map (column c, row r) into shared memory, counted
// on `bar` when it has landed.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c), "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// 4-byte copies of a W-wide slice of `rows` rows (columns c0 .. c0 + W - 1
// of a row-major matrix of leading dimension ld) into rows of W, by the 32
// producer lanes: the path of a matrix no tensor map can read.
template <int W, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int ld,
                                          int c0, int rows, int lane) {
  for (int e = lane; e < rows * W; e += 32) {
    const int r = e / W, c = e % W;
    if (c0 + c < ld)
      copy4(dst + r * W + c, src + static_cast<size_t>(r) * ld + c0 + c);
  }
}

// The int8 codes of `rows` rows (columns c0 .. c0 + BN - 1) as the aligned
// 16-byte windows that hold them, by the 32 producer lanes: row r lands at
// raw + r * RB, its first code at byte (address & 15).  A window holding a
// wanted byte lies in one aligned 16 bytes, so it never crosses a page; its
// other bytes are never used.  A full stage (kFull: rows == BM) unrolls.
template <class C, bool kFull>
__device__ __forceinline__ void copy_code_rows(unsigned char* raw,
                                               const int8_t* src, int ld,
                                               int c0, int rows, int lane) {
  constexpr int CPR = C::RB / 16;
  const int need = min(C::BN, ld - c0);
  const int n = kFull ? C::BM * CPR : rows * CPR;
#pragma unroll
  for (int i = 0; i < (kFull ? (C::BM * CPR + 31) / 32 : 1); ++i) {
    for (int e = lane + 32 * i; e < n; e += kFull ? n : 32) {
      const int r = e / CPR, c = e % CPR;
      const int8_t* a = src + static_cast<size_t>(r) * ld + c0;
      const int8_t* w = reinterpret_cast<const int8_t*>(
          reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15)) + 16 * c;
      if (w < a + need) copy16(raw + r * C::RB + 16 * c, w);
    }
  }
}

// float(code) for the signed byte `byte` of q ^ 0x80808080: 2^23 + code +
// 128 as bits, less 2^23 + 128, exactly (the value static_cast<float> of
// the code gives, without the conversion unit).
__device__ __forceinline__ float code_value(unsigned biased, int byte) {
  return __fsub_rn(__int_as_float(__byte_perm(biased, 0x4b000000u,
                                              0x7650 + byte)),
                   8388736.f);
}

// Dequantize a landed stage of int8 codes into fp32 d, by the 32 producer
// lanes: 4 codes a lane (two aligned 32-bit shared loads and a byte
// permute), each as __fmul_rn(float(code), scale).  Columns past the row's
// end hold whatever the window held; they only feed outputs that are never
// stored.  A full stage (kFull) unrolls.
template <class C, bool kFull>
__device__ __forceinline__ void dequant_codes(float* ds,
                                              const unsigned char* raw,
                                              const int8_t* src, int ld,
                                              int c0, int rows, float scale,
                                              int lane) {
  constexpr int QPR = C::BN / 4;
  const int off0 = static_cast<int>(reinterpret_cast<uintptr_t>(src + c0)
                                    & 15);
  const int n = kFull ? C::BM * QPR : rows * QPR;
#pragma unroll
  for (int i = 0; i < (kFull ? (C::BM * QPR + 31) / 32 : 1); ++i) {
    for (int e = lane + 32 * i; e < n; e += kFull ? n : 32) {
      const int r = e / QPR, c = 4 * (e % QPR);
      const int off = ((off0 + r * ld) & 15) + c;
      const unsigned* w =
          reinterpret_cast<const unsigned*>(raw + r * C::RB) + off / 4;
      const unsigned q = __byte_perm(w[0], w[1], 0x3210 + 0x1111 * (off & 3))
                         ^ 0x80808080u;
      float4 v;
      v.x = __fmul_rn(code_value(q, 0), scale);
      v.y = __fmul_rn(code_value(q, 1), scale);
      v.z = __fmul_rn(code_value(q, 2), scale);
      v.w = __fmul_rn(code_value(q, 3), scale);
      *reinterpret_cast<float4*>(ds + r * C::BN + c) = v;
    }
  }
}

// Dequantize a landed stage of int32 codes in place, by the producer lanes.
template <class C>
__device__ __forceinline__ void dequant_in_place(float* ds, int rows,
                                                 float scale, int lane) {
  for (int e = lane; e < rows * C::BN; e += 32) {
    const int code = __float_as_int(ds[e]);
    ds[e] = __fmul_rn(static_cast<float>(code), scale);
  }
}

template <int L>
__device__ __forceinline__ void load_vec(float (&v)[L], const float* p) {
  if constexpr (L == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(L == 2, "thread tiles are 2 or 4 wide");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <class C>
__device__ __forceinline__ void add_sample(const float* xs, const float* ds,
                                           float (&acc)[C::TK][C::TN]) {
  float a[C::TK], b[C::TN];
  load_vec<C::TK>(a, xs);
  load_vec<C::TN>(b, ds);
#pragma unroll
  for (int i = 0; i < C::TK; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Sum a full stage of C::BM samples, U at a time, in ascending order: the
// shared loads of the next U samples are issued before this batch's fmaf,
// so their latency (some 30 cycles) hides behind U (TK TN + 2) issue
// cycles instead of stalling every sample.  Fully unrolled: every shared
// address is a constant offset.
template <class C>
__device__ __forceinline__ void add_stage(const float* xs, const float* ds,
                                          float (&acc)[C::TK][C::TN]) {
  constexpr int U = C::TK * C::TN >= 8 ? 4 : 8;
  static_assert(C::BM % U == 0, "a stage is whole batches");
  float a[2][U][C::TK], b[2][U][C::TN];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    load_vec<C::TK>(a[0][u], xs + u * C::BK);
    load_vec<C::TN>(b[0][u], ds + u * C::BN);
  }
#pragma unroll
  for (int c = 0; c < C::BM / U; ++c) {
    if (c + 1 < C::BM / U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_vec<C::TK>(a[(c + 1) & 1][u], xs + ((c + 1) * U + u) * C::BK);
        load_vec<C::TN>(b[(c + 1) & 1][u], ds + ((c + 1) * U + u) * C::BN);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < C::TK; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(a[c & 1][u][i], b[c & 1][u][j], acc[i][j]);
  }
}

// A compute thread's first fan-in line and first column inside the block
// tile (the producer warp owns none).
template <class C>
__device__ __forceinline__ int tile_k() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / C::WN * 8 + lane / 4) * C::TK;
}

template <class C>
__device__ __forceinline__ int tile_n() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % C::WN * 4 + lane % 4) * C::TN;
}

// How a launch reaches its operands: 2-D tensor maps of x (T M, K) and of
// d (T M, N) for the tensor-memory accelerator, each used where `tma` has
// its bit (kTmaX, kTmaD) and ignored otherwise.
struct Operands {
  CUtensorMap xmap, dmap;
  int tma;
};
constexpr int kTmaX = 1, kTmaD = 2;

// acc[i][j] = sum over m ascending of x[m][k0 + tile_k + i] *
// d[m][n0 + tile_n + j] for core t, in every compute thread: x (M, K) fp32
// and d (M, N) as TD (float, or int8 / int32 codes dequantized with
// `scale`) are that core's rows, rows t M .. t M + M - 1 of the tensor
// maps.  `smem` holds smem_bytes<C, TD>().  Every thread of the block calls
// it; the producer warp's acc stays 0.
//
// Each slot of the ring has two mbarriers.  `full` completes when the
// slot's stage is ready to sum: its tensor-map bytes have landed and the
// producer has arrived, after its own copies landed and its codes were
// dequantized.  `empty` completes when every compute warp has arrived,
// done with the slot.  The producer issues stage st once stage st - S has
// emptied the slot, and readies stage st - 1 while stage st is in flight;
// the compute warps wait on `full` only, so neither side waits on the other
// while the ring has room.
template <class C, typename TD>
__device__ __forceinline__ void batch_walk(const float* __restrict__ x,
                                           const TD* __restrict__ d,
                                           float scale, int M, int K, int N,
                                           int t, int k0, int n0,
                                           const Operands& ops, char* smem,
                                           float (&acc)[C::TK][C::TN]) {
  constexpr int SB = stage_bytes<C, TD>();
  constexpr int WARPS = C::COMPUTE / 32;
  constexpr bool kBytes = sizeof(TD) == 1;
  constexpr bool kInt32 = !kBytes && !std::is_same<TD, float>::value;
  const bool tma_x = ops.tma & kTmaX;
  const bool tma_d = std::is_same<TD, float>::value && (ops.tma & kTmaD);
  const unsigned tma_bytes = 4 * C::BM * ((tma_x ? C::BK : 0)
                                          + (tma_d ? C::BN : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::S * SB);
  uint64_t* empty = full + C::S;
  const int lane = threadIdx.x % 32;
  const int stages = (M + C::BM - 1) / C::BM;
#pragma unroll
  for (int i = 0; i < C::TK; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  if (threadIdx.x == C::COMPUTE) {
#pragma unroll
    for (int s = 0; s < C::S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto slot = [&](int st) { return smem + (st % C::S) * SB; };
  auto rows_of = [&](int st) { return min(C::BM, M - st * C::BM); };

  if (threadIdx.x >= C::COMPUTE) {   // the producer warp
    // stage st's copies: tensor-map boxes counted on full, the rest one
    // cp.async group
    auto issue = [&](int st) {
      float* xs = reinterpret_cast<float*>(slot(st));
      float* ds = xs + C::BM * C::BK;
      const int m0 = st * C::BM, rows = rows_of(st);
      if (tma_bytes != 0 && lane == 0) {
        uint64_t* bar = &full[st % C::S];
        mbar_expect(bar, tma_bytes);
        if (tma_x) tma_load(xs, &ops.xmap, k0, t * M + m0, bar);
        if (tma_d) tma_load(ds, &ops.dmap, n0, t * M + m0, bar);
      }
      if (!tma_x)
        copy_rows<C::BK>(xs, x + static_cast<size_t>(m0) * K, K, k0, rows,
                         lane);
      const TD* dg = d + static_cast<size_t>(m0) * N;
      if constexpr (kBytes) {
        unsigned char* raw = reinterpret_cast<unsigned char*>(
            ds + C::BM * C::BN);
        if (rows == C::BM)
          copy_code_rows<C, true>(raw, dg, N, n0, rows, lane);
        else
          copy_code_rows<C, false>(raw, dg, N, n0, rows, lane);
      } else {
        if (!tma_d)
          copy_rows<C::BN>(reinterpret_cast<TD*>(ds), dg, N, n0, rows, lane);
      }
      commit();
    };
    // stage st's copies landed: dequantize its codes, then arrive on full
    auto ready = [&](int st) {
      float* ds = reinterpret_cast<float*>(slot(st)) + C::BM * C::BK;
      if constexpr (kBytes) {
        const unsigned char* raw = reinterpret_cast<const unsigned char*>(
            ds + C::BM * C::BN);
        const int8_t* src = reinterpret_cast<const int8_t*>(d)
                            + static_cast<size_t>(st * C::BM) * N;
        const int rows = rows_of(st);
        if (rows == C::BM)
          dequant_codes<C, true>(ds, raw, src, N, n0, rows, scale, lane);
        else
          dequant_codes<C, false>(ds, raw, src, N, n0, rows, scale, lane);
      } else if constexpr (kInt32) {
        dequant_in_place<C>(ds, rows_of(st), scale, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st % C::S]);
    };
    for (int st = 0; st < stages; ++st) {
      if (st >= C::S) mbar_wait(&empty[st % C::S], (st / C::S + 1) & 1);
      issue(st);
      if (st > 0) {
        wait_pending<1>();   // all but stage st's copies landed
        ready(st - 1);
      }
    }
    wait_pending<0>();
    ready(stages - 1);
    return;
  }

  const float* xs0 = reinterpret_cast<const float*>(smem) + tile_k<C>();
  const float* ds0 = reinterpret_cast<const float*>(smem) + C::BM * C::BK
                     + tile_n<C>();
  for (int st = 0; st < stages; ++st) {
    mbar_wait(&full[st % C::S], (st / C::S) & 1);
    const float* xs = xs0 + (st % C::S) * (SB / 4);
    const float* ds = ds0 + (st % C::S) * (SB / 4);
    const int rows = rows_of(st);
    if (rows == C::BM) {
      add_stage<C>(xs, ds, acc);
    } else {
      for (int mm = 0; mm < rows; ++mm)
        add_sample<C>(xs + mm * C::BK, ds + mm * C::BN, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % C::S]);
  }
}

// ---- host side -------------------------------------------------------------

// Fill `map` with a 2-D tensor map of a row-major (rows, cols) matrix of
// 4-byte elements at `base`, read in boxes of box_rows x box_cols (columns
// and rows past the end read as zeros).  Returns false, leaving `map`
// unused, where the accelerator cannot read the matrix: a base not 16-byte
// aligned or a row not a multiple of 16 bytes.
inline bool tensor_map(CUtensorMap* map, const void* base, long long rows,
                       int cols, int box_rows, int box_cols) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      cols % 4 != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands of a launch over T cores: x (T M, K) by tensor map where
// one can read it, d (T M, N) too where `d_map` (fp32 values).
template <class C>
inline Operands operands(const float* x, const void* d, bool d_map, int T,
                         int M, int K, int N) {
  Operands ops{};
  const long long rows = static_cast<long long>(T) * M;
  if (tensor_map(&ops.xmap, x, rows, K, C::BM, C::BK)) ops.tma |= kTmaX;
  if (d_map && tensor_map(&ops.dmap, d, rows, N, C::BM, C::BN))
    ops.tma |= kTmaD;
  return ops;
}

// Let `kernel` use `bytes` of dynamic shared memory: above 48 KB a kernel
// must ask, once on each device, before it launches.  `devices` is the
// caller's record of the devices already asked (one static per kernel
// instance), so a launch captured into a CUDA graph makes no such call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes,
                              unsigned long long& devices) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (devices >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) devices |= 1ull << dev;
  return err;
}

}  // namespace outer_product
