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
// Design: one block of BN = 128 threads per 128 samples; each thread owns
// one sample.  The block stages all k x d centers once in shared memory,
// transposed and padded to a multiple of KC centers with zeros (cs[t][j]),
// and its tile of samples (rows of stride d | 1, an odd stride, so the 32
// threads of a warp reading their own rows hit 32 different banks).  The
// tile is one contiguous run of x, read with 16-byte loads when x is
// 16-byte aligned.  The thread then walks the centers KC at a time: one
// ascending-t chain of |x - c| adds per center (KC chains in registers, so
// each sample element is read from shared memory once per KC centers and
// the centers are broadcast reads), and keeps the running minimum over j
// ascending with a strict '<', so an exact tie goes to the lowest index as
// in jnp.argmin.  The ragged tail of n is masked, nothing is padded; there
// are no atomics and no split across blocks, so the result does not depend
// on the launch.  The reference sums over d in XLA's order, so distances
// may differ in the last bits and an argmin may differ only where two
// centers are that nearly equidistant.  Build without --use_fast_math;
// the _rn intrinsics keep nvcc from reassociating the chains.
//
// What bounds it on an H100 SXM: 2 n k d operations (a subtract and an add
// with |.| as an operand modifier) at 33.5 T fp32 instructions/s against
// 4 (n d + k d + n) bytes at 3.35 TB/s.  At the clustering path's shapes
// (d = 20, k = 10) that is 10 operations per 4-byte sample element: bytes
// bound it, and at n = 2048 the launch itself dominates.  At the TPU tile
// limit (k = d = 128) operations bound it.  Shared memory holds at most
// 128 x 128 x 4 = 64 KB of centers and 128 x 129 x 4 = 66 KB of samples,
// so the launch opts in to dynamic shared memory above 48 KB.  Measured
// times, beside the card's name and power limit, are in PERF.md
// (chip_smoke.py prints them).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BN = 128;  // samples per block = threads per block
constexpr int KC = 8;    // centers whose chains one thread keeps at a time

__global__ void __launch_bounds__(BN)
kmeans_assign(const float* __restrict__ x, const float* __restrict__ c,
              int* __restrict__ out, int n, int d, int k, int kp,
              int vec) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;              // (d, kp): cs[t * kp + j] = c[j, t]
  float* xs = smem + d * kp;     // (BN, d | 1): this block's samples
  const int xstride = d | 1;
  const int tid = threadIdx.x;

  for (int e = tid; e < d * kp; e += BN) {
    const int t = e / kp, j = e % kp;
    cs[e] = j < k ? c[static_cast<size_t>(j) * d + t] : 0.f;
  }
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BN;
  const long long left =
      static_cast<long long>(n) - static_cast<long long>(row0);
  const int rows = left < BN ? static_cast<int>(left) : BN;
  const float* xt = x + row0 * d;
  const int count = rows * d;
  int done = 0;
  if (vec) {  // row0 * d * 4 is a multiple of 16, so the tile is aligned
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    for (int e4 = tid; e4 < count / 4; e4 += BN) {
      const float4 v = x4[e4];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * e4 + u;
        xs[(e / d) * xstride + e % d] = vals[u];
      }
    }
    done = count / 4 * 4;
  }
  for (int e = done + tid; e < count; e += BN)
    xs[(e / d) * xstride + e % d] = xt[e];
  __syncthreads();

  if (tid >= rows) return;
  const float* xi = xs + tid * xstride;
  float best = INFINITY;
  int best_j = 0;
  for (int j0 = 0; j0 < k; j0 += KC) {
    float acc[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u) acc[u] = 0.f;
    for (int t = 0; t < d; ++t) {
      const float xv = xi[t];
      const float4 c0 = *reinterpret_cast<const float4*>(cs + t * kp + j0);
      const float4 c1 =
          *reinterpret_cast<const float4*>(cs + t * kp + j0 + 4);
      const float cv[KC] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int u = 0; u < KC; ++u)
        acc[u] = __fadd_rn(acc[u], fabsf(__fsub_rn(xv, cv[u])));
    }
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      if (j0 + u < k && acc[u] < best) {
        best = acc[u];
        best_j = j0 + u;
      }
    }
  }
  out[row0 + tid] = best_j;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Returns the first CUDA
// error of the shared-memory opt-in or the launch: 0 on success.  The
// caller checks devices, types, shapes and contiguity and keeps
// 1 <= k, d <= 128 and n >= 1.
extern "C" int kmeans_assign_launch(const float* x, const float* c, int* out,
                                    int n, int d, int k, void* stream) {
  const int kp = (k + KC - 1) / KC * KC;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d) * kp + BN * (d | 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(n) + BN - 1) / BN);
  kmeans_assign<<<blocks, BN, smem, static_cast<cudaStream_t>(stream)>>>(
      x, c, out, n, d, k, kp, vec);
  return static_cast<int>(cudaGetLastError());
}
