// Flash attention (forward, online softmax) for Hopper (sm_90a), bf16
// operands on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel) for bf16 operands, and
// computes, as a template parameter selects, either its function or that
// of the reference layer's chunked_attention (repro/layers/attention.py,
// _online_update), the LM prefill's.
//
//   q (B, Sq, H, hd), k and v (B, Skv, K, hd) bf16, each row of hd values
//   contiguous and 16-byte aligned, rows and heads at any 16-byte multiple
//   stride (the wrapper copies a view that breaks this); out (B, Sq, H, hd)
//   contiguous bf16.  Query head h reads kv head h / (H / K), so nothing
//   is broadcast.  hd is 16, 32, 64, 128 or 256.
//
// What it computes: s = q . k by wgmma (bf16 operands, fp32 accumulation),
// then s * scale in fp32; when causal, s = -1e30 where key index > query
// index, both counted from 0; with a window w (RecurrentGemma's local
// layers; CHUNKED only, the wrapper's rule), also where key index <= query
// index - w (the reference's _block_mask); running max m and sum l in fp32
// registers,
// p = expf(s - m) (no fast math), acc += p . v by a second wgmma into fp32;
// out = acc / max(l, 1e-30) rounded to nearest into bf16.
//   CHUNKED (chunked_attention's function): p is rounded to bf16 (nearest)
//   before p . v, as the reference rounds p to v's dtype.  Its chunks are
//   512 keys and this kernel's tiles 64, so p is rounded against another
//   running max: the two may differ by one bf16 rounding of each p.
//   !CHUNKED (the Pallas function): p stays fp32 in effect: p . v runs as
//   p_hi . v + p_mid . v + p_lo . v into one accumulator, p_hi = bf16(p),
//   p_mid = bf16(p - p_hi), p_lo = bf16(p - p_hi - p_mid) (each difference
//   exact in fp32), which holds p to 24 significant bits.  Two terms (16
//   bits) are not enough: where the output cancels to |o| ~ 3e-5 beside
//   sum_j p_j |v_j| / l ~ 1, their 2^-18 relative error per p left one
//   output of qwen2-0.5b's prefill shape 1.5e-6 from the plain version, past
//   the one-bf16-step + 1e-6 bar.  The scale multiplies the product here
//   too; with bf16 operands that differs from the Pallas body's pre-scaled
//   fp32 q only by the rounding of that one multiply.
//
// Schedule: one block of two warpgroups (256 threads) per (128-query
// tile, head h, batch b), heaviest causal tiles first; each warpgroup owns
// 64 queries and both read the same key tiles, which halves the k and v
// traffic per query.  The block walks 64-key tiles in ascending order up
// to the diagonal when causal (a warpgroup skips the tiles wholly past its
// own last query, exactly: there p = 0 and corr = 1): no split over keys
// and no atomics, so the result does not depend on the launch.  With a
// window the block starts at the tile holding its first query's first
// visible key, q0 - w + 1, and each warpgroup skips the tiles wholly below
// its own first query's band, qw - w + 1.  That is exact: every query sees
// its own key, and a tile a row meets before its first visible key (all
// -1e30, so m stays -1e30 and p = 1) is wiped by corr = exp(-1e30 - m) = 0
// when that key arrives, as the reference's banded schedule.  A window of
// Sq or more masks nothing and starts at tile 0: the causal kernel, bit
// for bit.  Loads are
// cp.async 16-byte copies, double-buffered: tile t + 1's k and v are in
// flight while tile t is computed.  Ragged Sq and Skv are masked, not
// padded: rows past Skv are copied as zeros (so their v rows are zero) and
// their keys score -1e30 (p = 0 exactly); queries past Sq are computed on
// zero rows and not stored.
//
// Shared memory holds each 64-row tile in wgmma's no-swizzle layout: core
// matrices of 8 rows x 16 bytes (128 contiguous bytes), 8-row groups 128
// bytes apart and 8-column groups 1024 bytes apart.  q and k are read
// K-major (hd contiguous) by the first product; the same v layout is read
// MN-major (the transpose bit) by the second, so nothing is transposed in
// memory.  Two q tiles + 2 stages of k and v: 768 hd bytes (48 KB at
// hd 64, 96 KB at hd 128, 192 KB at hd 256, opted in above 48 KB).  The S
// accumulator's register layout is the A fragment's of the second product,
// so p goes from registers to the tensor cores without touching shared
// memory.  At hd 256 the o accumulator is 128 fp32 registers a thread
// beside S's 32, and p . v is one m64n256k16 wgmma a k-step; chip_smoke.py
// prints each instance's registers and spills.
//
// What bounds it on an H100 SXM: a causal call does 2 B H hd sum_i min(i +
// 1, Skv) FLOPs in each product (sum_i min(i + 1, w) with a window w) and
// one exp per visible (query, key) pair.
// At qwen2-0.5b's prefill shape (B = 4, S = 2048, H = 14, hd = 64) that is
// 15.0 GFLOP per product, 0.030 ms at the 989 TFLOP/s bf16 peak for both
// (0.061 ms for the Pallas function's four), and 117 M exponentials,
// ~0.03 ms on the special-function units; its 33.5 MB of q, k, v and out
// take 0.010 ms.  So the products and the exponentials bound it together.
// This first tensor-core design has no warp specialisation and no
// overlap of one tile's softmax with the next tile's products (each
// warpgroup waits on its wgmma).  On the card its time follows the k and v
// copies more than either product or the softmax, so two warpgroups share
// each key tile and the copies go through L1.  TMA loads issued by a
// producer warp, overlapping the copies with both products, are its next
// step.  Measured times, beside the card's name and power limit, are in
// PERF.md (chip_smoke.py prints them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // queries per warpgroup (one wgmma M)
constexpr int BK = 64;          // keys per tile (the first product's N)
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;       // k and v tiles held: STAGES - 1 in flight

constexpr int WGS = 2;          // warpgroups per block, on the same keys
constexpr int THREADS = WGS * WG_THREADS;
constexpr float NEG_INF = -1e30f;
constexpr uint32_t ROW_GROUP = 128;     // bytes between 8-row groups
constexpr uint32_t COL_GROUP = 1024;    // bytes between 8-column groups

struct Strides {                 // element strides of q, k, v: (b, s, h, d)
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared, through L1 (the blocks of
// one kv head's query heads read the same rows); src_bytes = 0 writes
// zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N groups have landed (in this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses to r across the asynchronous
// wgmma that reads and writes it
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading
// byte offset (between core matrices along K) and stride byte offset
// (between core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
      | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
      | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// x rounded to the nearest bf16, widened back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64 x n64, fp32) (+)= a (m64 x k16) . b (k16 x n64), a and b
// from shared memory (descriptors), both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n16, fp32) += a (m64 x k16, bf16 registers) . b (k16 x n16),
// b from shared memory read MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n32, fp32) += a (m64 x k16, bf16 registers) . b (k16 x n32),
// b from shared memory read MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64, fp32) += a (m64 x k16, bf16 registers) . b (k16 x n64),
// b from shared memory read MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, fp32) += a (m64 x k16, bf16 registers) . b (k16 x n128),
// b from shared memory read MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n256, fp32) += a (m64 x k16, bf16 registers) . b (k16 x n256),
// b from shared memory read MN-major (the transpose bit).  d[0 .. 63]
// hold columns 0 .. 127 and d[64 .. 127] columns 128 .. 255, each half
// in the n128 instruction's layout.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Copy rows row0 .. row0 + 63 (hd bf16 each, `stride` elements apart) of
// `src` into the no-swizzle tile at `dst`; rows at or past `rows` become
// zeros.  Eight neighbouring threads fill one core matrix (128 contiguous
// bytes of shared memory) from one 16-byte column of eight rows.
template <int HD, int NT>      // NT threads, tid in [0, NT), share the copy
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows, int tid) {
  constexpr int PIECES = BQ * HD / 8;          // 16-byte pieces per tile
#pragma unroll
  for (int i = 0; i < (PIECES + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (PIECES % NT != 0 && e >= PIECES) break;
    const int r8 = e & 7, c = (e >> 3) % (HD / 8), g = e / HD;
    const int row = row0 + 8 * g + r8;
    const bool in = row < rows;
    const bf16* from = src + (in ? row * stride + 8 * c : 0);
    cp_async16(dst + c * COL_GROUP + g * ROW_GROUP + r8 * 16, from,
               in ? 16 : 0);
  }
}

template <int HD, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
flash_tc_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int H,
             int group, int Sq, int Skv, float scale, int causal,
             int window, Strides st) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr uint32_t TILE = BQ * HD * 2;       // bytes of one 64-row tile
  constexpr int KSTEPS = HD / 16;              // k16 steps of q . k
  constexpr int PSTEPS = BK / 16;              // k16 steps of p . v
  const uint32_t q_s = smem_addr(smem);        // one q tile per warpgroup
  const uint32_t kv_s = q_s + WGS * TILE;      // stage s: k, then v

  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int warp = (tid / 32) % 4, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WGS * BQ;   // the block's
  const int qw = q0 + wg * BQ;                 // this warpgroup's queries
  const int h = blockIdx.y, b = blockIdx.z, kh = h / group;
  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* kb = k + b * st.k[0] + kh * st.k[2];
  const bf16* vb = v + b * st.v[0] + kh * st.v[2];

  // keys the block's queries can see: up to its last query's index, and
  // with a window from its first query's first visible key
  int kend = Skv;
  if (causal) kend = min(Skv, min(q0 + WGS * BQ, Sq));
  const int t0 = window ? max(0, q0 - window + 1) / BK : 0;
  const int tiles = (kend + BK - 1) / BK;

  // copy groups: q with the first tile, then one group per key tile;
  // tile t sits in stage (t - t0) % STAGES
  load_tile<HD, WG_THREADS>(q_s + wg * TILE, qb, st.q[1], qw, Sq,
                            tid % WG_THREADS);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t0 + i < tiles) {
      load_tile<HD, THREADS>(kv_s + i * 2 * TILE, kb, st.k[1],
                             (t0 + i) * BK, Skv, tid);
      load_tile<HD, THREADS>(kv_s + (i * 2 + 1) * TILE, vb, st.v[1],
                             (t0 + i) * BK, Skv, tid);
    }
    cp_async_commit();
  }

  // this thread's rows of the tile: r0 and r0 + 8; its columns of each
  // 8-column group: c0 and c0 + 1 (wgmma's accumulator layout)
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float o[HD / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int t = t0; t < tiles; ++t) {
    const int k0 = t * BK;
    const uint32_t k_s = kv_s + ((t - t0) % STAGES) * 2 * TILE;
    const uint32_t v_s = k_s + TILE;
    const int ahead = t + STAGES - 1;          // into the stage read at t - 1
    if (ahead < tiles) {
      const uint32_t nk = kv_s + ((ahead - t0) % STAGES) * 2 * TILE;
      load_tile<HD, THREADS>(nk, kb, st.k[1], ahead * BK, Skv, tid);
      load_tile<HD, THREADS>(nk + TILE, vb, st.v[1], ahead * BK, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();              // tile t (and q) in shared memory

    // a causal warpgroup skips tiles wholly past its last query (exact:
    // there p = 0 and corr = 1), a windowed one the tiles wholly below its
    // first query's band (exact: see the head); it still meets the block's
    // barriers
    if ((!causal || k0 <= qw + BQ - 1)
        && (!window || k0 + BK - 1 > qw - window)) {
      // s = q . k^T: 64 x 64, fp32
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_operand(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        wgmma_ss_n64(s, make_desc(q_s + wg * TILE + ks * 2 * COL_GROUP,
                                  COL_GROUP, ROW_GROUP),
                     make_desc(k_s + ks * 2 * COL_GROUP, COL_GROUP,
                               ROW_GROUP), ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(s);

      // scale, mask, online max and sum; s becomes p
      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw)
          || (window && k0 <= qw + BQ - 1 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[4 * j + e], scale);
          if (edge) {
            const int kj = k0 + 8 * j + c0 + (e & 1);
            const int qi = qw + r0 + 8 * (e >> 1);
            if (kj >= Skv || (causal && kj > qi)
                || (window && kj <= qi - window))
              x = NEG_INF;
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[4 * j + e] - mx[e >> 1]);
          s[4 * j + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum[i]);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        o[i] = __fmul_rn(o[i], corr[(i >> 1) & 1]);

      // p as the A fragments of p . v: k-step kk holds keys 16 kk .. + 15,
      // which are accumulator registers 8 kk .. 8 kk + 7
      uint32_t ph[PSTEPS][4], pm[PSTEPS][4], pl[PSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
          ph[kk][r] = pack_bf16(x0, x1);
          if (!CHUNKED) {
            const float e0 = x0 - round_bf16(x0), e1 = x1 - round_bf16(x1);
            pm[kk][r] = pack_bf16(e0, e1);
            pl[kk][r] = pack_bf16(e0 - round_bf16(e0), e1 - round_bf16(e1));
          }
        }

      // o += p . v: v read MN-major (hd contiguous), 16 keys per k-step
      fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk) {
        const uint64_t dv = make_desc(v_s + kk * 2 * ROW_GROUP, ROW_GROUP,
                                      COL_GROUP);
        wgmma_rs<HD>(o, ph[kk], dv);
        if (!CHUNKED) {
          wgmma_rs<HD>(o, pm[kk], dv);
          wgmma_rs<HD>(o, pl[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(o);
    }
    __syncthreads();              // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + r0 + 8 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* row = out + ((static_cast<long long>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * i], den),
                                __fdiv_rn(o[4 * j + 2 * i + 1], den));
  }
}

template <int HD, bool CHUNKED>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, float scale, int causal,
           int window, const Strides& st, cudaStream_t stream) {
  const int smem = (WGS + 2 * STAGES) * BQ * HD * 2;   // q tiles + stages
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_fwd<HD, CHUNKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + WGS * BQ - 1) / (WGS * BQ), H, B);
  flash_tc_fwd<HD, CHUNKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, H / K, Sq,
      Skv, scale, causal, window, st);
  return static_cast<int>(cudaGetLastError());
}

template <bool CHUNKED>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int hd, float scale, int causal,
              int window, const Strides& st, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv,
                                        scale, causal, window, st, stream);
    case 32: return launch<32, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv,
                                        scale, causal, window, st, stream);
    case 64: return launch<64, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv,
                                        scale, causal, window, st, stream);
    case 128: return launch<128, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv,
                                          scale, causal, window, st, stream);
    case 256: return launch<256, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv,
                                          scale, causal, window, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  q, k, v and out are
// bf16; chunked selects chunked_attention's function (1) or the Pallas
// kernel's (0); window: 0 for none, else w >= 1 (chunked only, Sq <= Skv);
// strides: 12 element strides, q's (b, s, h, d) then k's
// and v's, each d stride 1 and the others multiples of 8, with 16-byte
// aligned pointers.  Returns the first CUDA error of the shared-memory
// opt-in or the launch: 0 on success, cudaErrorInvalidValue for an hd,
// stride or window it does not take.  The caller checks devices, types and
// shapes and keeps H % K == 0, B and H <= 65535.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out,
                                         int B, int H, int K, int Sq,
                                         int Skv, int hd, float scale,
                                         int causal, int chunked, int window,
                                         const long long* strides,
                                         void* stream) {
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  if (st.q[3] != 1 || st.k[3] != 1 || st.v[3] != 1 || window < 0
      || (window && (!chunked || Sq > Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked)
    return launch_hd<true>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                           causal, window, st, s);
  return launch_hd<false>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                          0, st, s);
}
