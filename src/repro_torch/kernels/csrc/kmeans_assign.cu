// k-means assignment kernel for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/kmeans.py:kmeans_assign_kernel
// (body _assign_kernel), the digital clustering core of the paper's Fig. 13:
// for each sample, the Manhattan distance to every center and the index of
// the nearest one.
//
//   x (n, d), c (k, d) fp32, row-major and contiguous; out (n,) int32;
//   out[i] = argmin_j sum_t |x[i, t] - c[j, t]|, ties to the lowest j.
//
// The distance chain is the contract: each distance is one thread's chain
// acc = __fadd_rn(acc, fabsf(__fsub_rn(x, c))) over t = 0, 1, ..., d - 1
// from 0.f (kernels/kmeans.py: kmeans_assign_chain is the same chain in
// plain PyTorch), and the argmin keeps a strict '<' over ascending j.
// Where the centers of a sample are split over threads, their (distance,
// j) pairs combine lexicographically, so an exact tie still goes to the
// lowest j and every tile gives the same assignment.  Features past d are
// padded with zeros in shared memory: |0 - 0| = +0 added to a chain that
// starts at +0 and adds no negative value changes no bit.  No atomics, no
// split across blocks.  Build without --use_fast_math; the _rn intrinsics
// keep nvcc from reassociating the chains.
//
// Design: one instance per tile of KMEANS_TILES.  A block owns BS = TS NS
// samples and walks the centers BK = TJ NJ at a time (one pass where k <=
// BK); each pass streams the feature axis in chunks of DC = 32 through two
// shared-memory buffers (cp.async, 16 bytes a copy where rows allow, the
// next chunk in flight while one is summed), rows at a pitch of DC + 4
// words (4 mod 8: eight rows read at once fall in distinct banks).  Thread
// (ts, tj) holds a TS x TJ register tile of chains, samples ts + NS v and
// centers tj + NJ g: per 4 features it reads TS + TJ 16-byte vectors for
// 8 TS TJ adds, so shared memory stays far below the add rate.  The NJ
// threads of a sample group are consecutive lanes of one warp and combine
// their running minima by shuffles.  Small n takes small blocks, so the
// clustering path's 2048 samples still reach most SMs.
//
// What bounds it on an H100 SXM: 2 n k d operations (a subtract and an add
// with |.| as an operand modifier) at 33.5 T fp32 instructions/s against
// 4 (n d + k d + n) bytes at 3.35 TB/s.  At the TPU tile limit (k = d =
// 128) operations bound it: 2.1 G instructions, 64 us at n = 65536.  At
// the clustering path's shapes (d = 20, k = 10) bytes bound it, and at
// n = 2048 the launch itself dominates.  Measured times, beside the card's
// name and power limit, are in PERF.md (chip_smoke.py prints every tile's
// time beside the pick).

#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

// The tiles the launcher may pick: (index, TS, TJ, NS, NJ): TS x TJ chains
// a thread, NS x NJ threads a block (NJ consecutive lanes share samples),
// BS = TS NS samples a block, BK = TJ NJ centers a pass.
// kernels/kmeans.py holds the same table (KMEANS_TILES) and picks an index.
#define KMEANS_TILES(X) \
  X(0, 4, 8, 16, 16) \
  X(1, 4, 8, 32, 4) \
  X(2, 4, 4, 16, 16) \
  X(3, 1, 4, 16, 4) \
  X(4, 2, 4, 64, 4)

namespace {

constexpr int DC = 32;       // features a chunk
constexpr int XP = DC + 4;   // row pitch in shared memory, words

template <int TS_, int TJ_, int NS_, int NJ_>
struct KTile {
  static constexpr int TS = TS_, TJ = TJ_, NS = NS_, NJ = NJ_;
  static constexpr int THREADS = NS_ * NJ_;
  static constexpr int BS = TS_ * NS_, BK = TJ_ * NJ_;
  static constexpr int STAGE = (BS + BK) * XP;   // words of one buffer
  static_assert(THREADS % 32 == 0 && 32 % NJ_ == 0 && THREADS <= 1024,
                "whole warps; a sample group inside one warp");
};

template <class C>
constexpr int smem_bytes() {
  return 2 * C::STAGE * 4;
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

// Columns [0, dc) of `rows` rows of a row-major matrix of leading
// dimension ld, from src, into rows of XP words at dst, by every thread;
// columns [dc, dc4) become zeros.  `vec`: rows and src are 16-byte
// aligned and dc is a multiple of 4.
template <int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int ld, int rows, int dc, int dc4,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int q = dc / 4;
    for (int e = tid; e < rows * q; e += THREADS) {
      const int r = e / q, c = 4 * (e % q);
      copy16(dst + r * XP + c, src + static_cast<size_t>(r) * ld + c);
    }
  } else {
    for (int e = tid; e < rows * dc; e += THREADS) {
      const int r = e / dc, c = e % dc;
      copy4(dst + r * XP + c, src + static_cast<size_t>(r) * ld + c);
    }
    const int pad = dc4 - dc;
    for (int e = tid; e < rows * pad; e += THREADS)
      dst[(e / pad) * XP + dc + e % pad] = 0.f;
  }
}

// Features t .. t + 3 of every chain of the thread, ascending: xs and cs
// point at its first sample and first center (rows NS and NJ apart).
template <class C>
__device__ __forceinline__ void add4(const float* xs, const float* cs, int t,
                                     float (&acc)[C::TS][C::TJ]) {
  float4 xv[C::TS];
#pragma unroll
  for (int v = 0; v < C::TS; ++v)
    xv[v] = *reinterpret_cast<const float4*>(xs + v * C::NS * XP + t);
#pragma unroll
  for (int g = 0; g < C::TJ; ++g) {
    const float4 cv =
        *reinterpret_cast<const float4*>(cs + g * C::NJ * XP + t);
#pragma unroll
    for (int v = 0; v < C::TS; ++v) {
      float a = acc[v][g];
      a = __fadd_rn(a, fabsf(__fsub_rn(xv[v].x, cv.x)));
      a = __fadd_rn(a, fabsf(__fsub_rn(xv[v].y, cv.y)));
      a = __fadd_rn(a, fabsf(__fsub_rn(xv[v].z, cv.z)));
      a = __fadd_rn(a, fabsf(__fsub_rn(xv[v].w, cv.w)));
      acc[v][g] = a;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
kmeans_assign(const float* __restrict__ x, const float* __restrict__ c,
              int* __restrict__ out, int n, int d, int k, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tj = tid % C::NJ, ts = tid / C::NJ;
  const long long i0 = static_cast<long long>(blockIdx.x) * C::BS;
  const int rows = static_cast<int>(min(static_cast<long long>(C::BS),
                                        static_cast<long long>(n) - i0));
  const int chunks = (d + DC - 1) / DC;
  const int stages = chunks * ((k + C::BK - 1) / C::BK);
  const float* xb = x + i0 * d;

  // stage s: center pass s / chunks, feature chunk s % chunks
  auto load = [&](int s) {
    float* xs = smem + (s & 1) * C::STAGE;
    float* cs = xs + C::BS * XP;
    const int j0 = s / chunks * C::BK, t0 = s % chunks * DC;
    const int dc = min(DC, d - t0), dc4 = (dc + 3) & ~3;
    load_rows<C::THREADS>(xs, xb + t0, d, rows, dc, dc4, vec);
    load_rows<C::THREADS>(cs, c + static_cast<size_t>(j0) * d + t0, d,
                          min(C::BK, k - j0), dc, dc4, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float best[C::TS];
  int best_j[C::TS];
#pragma unroll
  for (int v = 0; v < C::TS; ++v) {
    best[v] = INFINITY;
    best_j[v] = tj;   // the lowest center this thread holds
  }
  float acc[C::TS][C::TJ];
  load(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      load(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int chunk = s % chunks;
    if (chunk == 0) {
#pragma unroll
      for (int v = 0; v < C::TS; ++v)
#pragma unroll
        for (int g = 0; g < C::TJ; ++g) acc[v][g] = 0.f;
    }
    const float* xs = smem + (s & 1) * C::STAGE + ts * XP;
    const float* cs = smem + (s & 1) * C::STAGE + (C::BS + tj) * XP;
    const int dc4 = (min(DC, d - chunk * DC) + 3) & ~3;
    if (dc4 == DC) {
#pragma unroll
      for (int t = 0; t < DC; t += 4) add4<C>(xs, cs, t, acc);
    } else {
      for (int t = 0; t < dc4; t += 4) add4<C>(xs, cs, t, acc);
    }
    if (chunk == chunks - 1) {   // this pass's centers, ascending j
      const int j0 = s / chunks * C::BK;
#pragma unroll
      for (int g = 0; g < C::TJ; ++g) {
        const int j = j0 + tj + C::NJ * g;
#pragma unroll
        for (int v = 0; v < C::TS; ++v) {
          if (j < k && acc[v][g] < best[v]) {
            best[v] = acc[v][g];
            best_j[v] = j;
          }
        }
      }
    }
    __syncthreads();   // the buffer is free for stage s + 2
  }

  // the NJ lanes of a sample group: lexicographic minimum of (best, j)
#pragma unroll
  for (int v = 0; v < C::TS; ++v) {
#pragma unroll
    for (int off = C::NJ / 2; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[v], off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j[v], off);
      if (ob < best[v] || (ob == best[v] && oj < best_j[v])) {
        best[v] = ob;
        best_j[v] = oj;
      }
    }
    const int r = ts + C::NS * v;
    if (tj == 0 && r < rows) out[i0 + r] = best_j[v];
  }
}

template <class C>
int launch(const float* x, const float* c, int* out, int n, int d, int k,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<C>();
  static unsigned long long devices = 0;
  if (smem > 48 * 1024) {   // once on each device, as allow_smem does
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!(devices >> dev & 1ull)) {
      err = cudaFuncSetAttribute(kmeans_assign<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      devices |= 1ull << dev;
    }
  }
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(n) + C::BS - 1) / C::BS);
  kmeans_assign<C><<<blocks, C::THREADS, smem, stream>>>(x, c, out, n, d, k,
                                                          vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); `tile` indexes
// KMEANS_TILES.  Returns the first CUDA error of the shared-memory opt-in
// or the launch: 0 on success, -1 for an unknown tile.  The caller checks
// devices, types, shapes and contiguity and keeps 1 <= k, d <= 128 and
// 1 <= n with the grid within CUDA's limit.
extern "C" int kmeans_assign_launch(const float* x, const float* c, int* out,
                                    int n, int d, int k, int tile,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define KMEANS_CASE(i, ts, tj, ns, nj) \
    case i: return launch<KTile<ts, tj, ns, nj>>(x, c, out, n, d, k, st);
    KMEANS_TILES(KMEANS_CASE)
#undef KMEANS_CASE
    default: return -1;
  }
}
