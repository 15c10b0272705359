// Flash attention (forward, online softmax) for Hopper (sm_90a), fp32 on
// the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel): causal or full softmax
// attention that never writes the (Sq, Skv) score matrix to device memory.
//
//   q (B, Sq, H, hd), k and v (B, Skv, K, hd), fp32 or bf16 (all three
//   alike), read through their element strides; out (B, Sq, H, hd)
//   contiguous, in q's dtype.  Query head h reads kv head h / (H / K)
//   (jnp.repeat's order), so nothing is broadcast or copied.
//
// What it computes, as the Pallas body does: q is widened to fp32 and
// multiplied by `scale` before the product; s = q . k in fp32; when causal,
// s = -1e30 where key index > query index, both counted from 0 (right for
// prefill, where Sq == Skv); running max m, sum l and accumulator acc in
// fp32, p = exp(s - m) in fp32, acc += p . v in fp32; out = acc / max(l,
// 1e-30) rounded to nearest into q's dtype.  expf and IEEE division; built
// without --use_fast_math.
//
// Schedule: one block of 256 threads per (query tile of BQ = 64, head h,
// batch b).  The block stages its scaled query tile in shared memory once,
// then walks key tiles of BK = 64 in ascending order, stopping at the
// diagonal when causal.  Per key tile it stages k and v, computes the
// 64 x 64 scores (each thread a 4 x 4 micro-tile: rows ty + 16a, keys
// tx + 16b, one ascending-d fmaf chain each), masks them, updates the
// running max and sum of its four rows (shuffles across the 16 threads that
// share a row), writes p to shared memory and adds p . v into its 4 x hd/16
// accumulators (columns tx + 16c, one ascending-key fmaf chain per tile).
// Ragged Sq and Skv are masked, not padded: keys past Skv score -1e30 like
// masked ones (so p = 0 exactly) and their v rows are zero; queries past Sq
// are computed and not stored.  No split over keys and no atomics, so the
// result does not depend on the launch.  hd <= 128 (the wrapper raises
// above); the accumulator width is a template parameter (hd/16 rounded up
// to 1, 2, 4 or 8).  Shared memory: (BQ + BK) (hd | 1) + BK 16 ceil(hd/16)
// + BQ (BK + 16) floats = 69.6 KB at hd = 64, 118 KB at hd = 128, so the
// launch opts in to dynamic shared memory above 48 KB.  Odd row strides keep
// the 16 key rows a warp reads in one step in 16 banks; p's row stride of
// BK + 16 puts a warp's two rows in opposite bank halves.
//
// What bounds it on an H100 SXM: a causal call does 4 B H hd sum_i min(i+1,
// Skv) FLOPs (two products) against 67 TFLOP/s fp32 outside the tensor
// cores; its bytes (q, k, v read once, out written once) are tiny beside
// that, so operations bound it (qwen2-0.5b prefill at B = 4, S = 2048,
// H = 14, hd = 64: 30 GFLOP, 0.45 ms).  This SIMT design issues one shared
// memory load per two FMAs, so shared-memory bandwidth holds it well under
// the fp32 peak; the tile past the diagonal is computed in full and masked.
// The next step is a tensor-core design: wgmma on bf16 q and k tiles loaded
// by TMA, p rounded to bf16 for a second wgmma, warp-specialized producers
// (FlashAttention-3's shape), against the 989 TFLOP/s bf16 peak.  Measured
// times, beside the card's name and power limit, are in PERF.md
// (chip_smoke.py prints them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty picks rows, tx keys/columns
constexpr int TR = BQ / 16;     // rows per thread (ty + 16 a)
constexpr int TC = BK / 16;     // keys per thread in the score tile
constexpr int PSTRIDE = BK + 16;
constexpr float NEG_INF = -1e30f;

struct Strides {                 // element strides of q, k, v: (b, s, h, d)
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DC>   // DC: accumulator columns per thread
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int group,
          int Sq, int Skv, int hd, float scale, int causal, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int rs = hd | 1;                 // odd row stride of q and k tiles
  constexpr int VS = 16 * DC;            // row stride of the v tile
  float* qs = smem;                      // (BQ, rs): scaled queries
  float* ks = qs + BQ * rs;              // (BK, rs)
  float* vs = ks + BK * rs;              // (BK, VS), zero past hd and Skv
  float* ps = vs + BK * VS;              // (BQ, PSTRIDE): p of this tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / group;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + kh * st.k[2];
  const T* vb = v + b * st.v[0] + kh * st.v[2];

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int i = e / hd, d = e % hd;
    const float x = q0 + i < Sq
        ? to_f32(qb[(q0 + i) * st.q[1] + d * st.q[3]]) : 0.f;
    qs[i * rs + d] = __fmul_rn(x, scale);
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // keys this tile of queries can see: up to the last query's index
  int kend = Skv;
  if (causal) kend = min(Skv, min(q0 + BQ, Sq));
  const int tiles = (kend + BK - 1) / BK;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int j = e / hd, d = e % hd;
      ks[j * rs + d] = k0 + j < Skv
          ? to_f32(kb[(k0 + j) * st.k[1] + d * st.k[3]]) : 0.f;
    }
    for (int e = tid; e < BK * VS; e += THREADS) {
      const int j = e / VS, d = e % VS;
      vs[e] = (k0 + j < Skv && d < hd)
          ? to_f32(vb[(k0 + j) * st.v[1] + d * st.v[3]]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[a][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int a = 0; a < TR; ++a) qv[a] = qs[(ty + 16 * a) * rs + d];
#pragma unroll
      for (int c = 0; c < TC; ++c) kv[c] = ks[(tx + 16 * c) * rs + d];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int c = 0; c < TC; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int qi = q0 + ty + 16 * a;
      float mx = m[a];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int kj = k0 + tx + 16 * c;
        if (kj >= Skv || (causal && kj > qi)) s[a][c] = NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[a] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float p = expf(s[a][c] - mx);
        ps[(ty + 16 * a) * PSTRIDE + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = fmaf(l[a], corr, sum);
      m[a] = mx;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] = __fmul_rn(acc[a][c], corr);
    }
    __syncthreads();

    const int jn = min(BK, kend - k0);   // keys past kend have p = 0
    for (int j = 0; j < jn; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * VS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float p = ps[(ty + 16 * a) * PSTRIDE + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[a], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) store(o + d, __fdiv_rn(acc[a][c], den));
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int hd, float scale, int causal,
           const Strides& st, cudaStream_t stream) {
  const int rs = hd | 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ + BK) * rs + BK * 16 * DC + BQ * PSTRIDE);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, H / K, Sq, Skv, hd,
      scale, causal, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int hd, float scale, int causal,
              const Strides& st, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 1>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                        st, stream);
  if (hd <= 32)
    return launch<T, 2>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                        st, stream);
  if (hd <= 64)
    return launch<T, 4>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                        st, stream);
  return launch<T, 8>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal, st,
                      stream);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  dtype 0 = fp32, 1 = bf16
// (q, k, v and out alike); strides: 12 element strides, q's (b, s, h, d)
// then k's and v's.  Returns the first CUDA error of the shared-memory
// opt-in or the launch: 0 on success.  The caller checks devices, types and
// shapes and keeps 1 <= hd <= 128, H % K == 0, B and H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int H, int K, int Sq, int Skv,
                                      int hd, float scale, int causal,
                                      const long long* strides,
                                      void* stream) {
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dc<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Skv, hd,
                                    scale, causal, st, s);
  return launch_dc<float>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                          st, s);
}
