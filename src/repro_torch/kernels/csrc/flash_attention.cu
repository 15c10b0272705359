// Flash attention (forward, online softmax) for Hopper (sm_90a), fp32 on
// the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel) for fp32 operands: causal or
// full softmax attention that never writes the (Sq, Skv) score matrix to
// device memory.  bf16 operands go to the tensor-core kernel
// (flash_attention_tc.cu).
//
//   q (B, Sq, H, hd), k and v (B, Skv, K, hd) fp32, read through their
//   element strides; out (B, Sq, H, hd) contiguous fp32.  Query head h
//   reads kv head h / (H / K) (jnp.repeat's order), so nothing is
//   broadcast or copied.
//
// What it computes, as a template parameter selects:
//   !CHUNKED (the Pallas body): q widened to fp32 and multiplied by `scale`
//   before the product; s = q . k in fp32;
//   CHUNKED (the reference layer's chunked_attention): s = (q . k) * scale,
//   scaled after the product; its rounding of p to the operands' dtype
//   before p . v is a no-op in fp32, so the two functions differ only by
//   where the scale's rounding falls.
// Then, in both: when causal, s = -1e30 where key index > query index,
// both counted from 0 (right for prefill, where Sq == Skv); with a window
// w (CHUNKED only, the wrapper's rule), also where key index <= query
// index - w (RecurrentGemma's local layers, the reference's _block_mask);
// running max m,
// sum l and accumulator acc in fp32, p = exp(s - m), acc += p . v in fp32;
// out = acc / max(l, 1e-30).  expf and IEEE division; built without
// --use_fast_math.
//
// Schedule: one block of 256 threads per (query tile of BQ = 64, head h,
// batch b).  The block stages its query tile in shared memory once,
// then walks key tiles of BK = 64 in ascending order, stopping at the
// diagonal when causal and, with a window, starting at the tile that holds
// its first query's first visible key, q0 - w + 1.  That is exact: every
// query sees its own key, and a tile a row meets before its first visible
// key (all -1e30: m stays -1e30, p = 1) is wiped by corr = exp(-1e30 - m)
// = 0 when that key arrives, as the reference's banded schedule; a window
// of Sq or more masks nothing and starts at tile 0, the causal kernel bit
// for bit.  Per key tile it stages k and v, computes the
// 64 x 64 scores (each thread a 4 x 4 micro-tile: rows ty + 16a, keys
// tx + 16b, one ascending-d fmaf chain each), masks them, updates the
// running max and sum of its four rows (shuffles across the 16 threads that
// share a row), writes p to shared memory and adds p . v into its 4 x hd/16
// accumulators (columns tx + 16c, one ascending-key fmaf chain per tile).
// Ragged Sq and Skv are masked, not padded: keys past Skv score -1e30 like
// masked ones (so p = 0 exactly) and their v rows are zero; queries past Sq
// are computed and not stored.  No split over keys and no atomics, so the
// result does not depend on the launch.  hd <= 256 (the wrapper raises
// above); the accumulator width is a template parameter (hd/16 rounded up
// to 1, 2, 4, 8 or 16: at hd 256, 4 x 16 fp32 accumulators a thread).
// Shared memory: (BQ + BK) (hd | 1) + BK 16 ceil(hd/16) + BQ (BK + 16)
// floats = 69.6 KB at hd = 64, 118 KB at hd = 128, 218 KB at hd = 256, so
// the launch opts in to dynamic shared memory above 48 KB.  Odd row strides keep
// the 16 key rows a warp reads in one step in 16 banks; p's row stride of
// BK + 16 puts a warp's two rows in opposite bank halves.
//
// What bounds it on an H100 SXM: fp32 operands have no tensor-core route
// (TF32 stays off), so a causal call's 4 B H hd sum_i min(i+1, Skv) FLOPs
// (two products) meet the 67 TFLOP/s fp32 peak outside the tensor cores;
// its bytes (q, k, v read once, out written once) are small beside that,
// so operations bound it (qwen2-0.5b prefill at B = 4, S = 2048, H = 14,
// hd = 64: 30 GFLOP, 0.45 ms).  This design issues one shared-memory load
// per two FMAs, so shared-memory bandwidth holds it well under the fp32
// peak, and the tile past the diagonal is computed in full and masked.
// Register-blocked micro-tiles with more FMAs per load are its next step.
// Measured times, beside the card's name and power limit, are in PERF.md
// (chip_smoke.py prints them).

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

// DC: accumulator columns per thread; CHUNKED: chunked_attention's function
template <int DC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H,
          int group, int Sq, int Skv, int hd, float scale, int causal,
          int window, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int rs = hd | 1;                 // odd row stride of q and k tiles
  constexpr int VS = 16 * DC;            // row stride of the v tile
  float* qs = smem;                      // (BQ, rs): (scaled) queries
  float* ks = qs + BQ * rs;              // (BK, rs)
  float* vs = ks + BK * rs;              // (BK, VS), zero past hd and Skv
  float* ps = vs + BK * VS;              // (BQ, PSTRIDE): p of this tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / group;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + kh * st.k[2];
  const float* vb = v + b * st.v[0] + kh * st.v[2];

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int i = e / hd, d = e % hd;
    const float x = q0 + i < Sq
        ? qb[(q0 + i) * st.q[1] + d * st.q[3]] : 0.f;
    qs[i * rs + d] = CHUNKED ? x : __fmul_rn(x, scale);
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // keys this tile of queries can see: up to the last query's index, and
  // with a window from the first query's first visible key
  int kend = Skv;
  if (causal) kend = min(Skv, min(q0 + BQ, Sq));
  const int t0 = window ? max(0, q0 - window + 1) / BK : 0;
  const int tiles = (kend + BK - 1) / BK;

  for (int t = t0; t < tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int j = e / hd, d = e % hd;
      ks[j * rs + d] = k0 + j < Skv
          ? kb[(k0 + j) * st.k[1] + d * st.k[3]] : 0.f;
    }
    for (int e = tid; e < BK * VS; e += THREADS) {
      const int j = e / VS, d = e % VS;
      vs[e] = (k0 + j < Skv && d < hd)
          ? vb[(k0 + j) * st.v[1] + d * st.v[3]] : 0.f;
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
        if (CHUNKED) s[a][c] = __fmul_rn(s[a][c], scale);
        if (kj >= Skv || (causal && kj > qi)
            || (window && kj <= qi - window))
          s[a][c] = NEG_INF;
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
    float* o = out + ((static_cast<long long>(b) * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = __fdiv_rn(acc[a][c], den);
    }
  }
}

template <int DC, bool CHUNKED>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int hd, float scale, int causal,
           int window, const Strides& st, cudaStream_t stream) {
  const int rs = hd | 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ + BK) * rs + BK * 16 * DC + BQ * PSTRIDE);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DC, CHUNKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<DC, CHUNKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, H / K, Sq,
      Skv, hd, scale, causal, window, st);
  return static_cast<int>(cudaGetLastError());
}

template <bool CHUNKED>
int launch_dc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int hd, float scale, int causal,
              int window, const Strides& st, cudaStream_t stream) {
  if (hd <= 16)
    return launch<1, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                              causal, window, st, stream);
  if (hd <= 32)
    return launch<2, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                              causal, window, st, stream);
  if (hd <= 64)
    return launch<4, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                              causal, window, st, stream);
  if (hd <= 128)
    return launch<8, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                              causal, window, st, stream);
  return launch<16, CHUNKED>(q, k, v, out, B, H, K, Sq, Skv, hd, scale,
                             causal, window, st, stream);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  q, k, v and out are
// fp32; chunked selects chunked_attention's function (1) or the Pallas
// kernel's (0); window: 0 for none, else w >= 1 (chunked only, Sq <= Skv);
// strides: 12 element strides, q's (b, s, h, d) then k's
// and v's.  Returns the first CUDA error of the shared-memory opt-in or
// the launch: 0 on success, cudaErrorInvalidValue for an hd or window it
// does not take.  The caller checks devices, types and shapes and keeps
// H % K == 0, B and H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      int B, int H, int K, int Sq, int Skv,
                                      int hd, float scale, int causal,
                                      int chunked, int window,
                                      const long long* strides,
                                      void* stream) {
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  if (hd < 1 || hd > 256 || window < 0
      || (window && (!chunked || Sq > Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked)
    return launch_dc<true>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                           window, st, s);
  return launch_dc<false>(q, k, v, out, B, H, K, Sq, Skv, hd, scale, causal,
                          0, st, s);
}
