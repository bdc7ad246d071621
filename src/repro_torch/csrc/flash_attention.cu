// Causal / local-window / bidirectional GQA attention forward for Hopper
// (sm_90a): the full-sequence attention of the LM decoder (impl="flash").
//
// Replaces: the Pallas TPU kernel `flash_attention` / `_kernel` of
//   src/repro/kernels/flash_attention.py (grid (B, Hq, Sq/BQ, Sk/BK), 512 x
//   512 VMEM blocks, the key axis sequential with m, l and acc carried in
//   VMEM scratch; no VJP).
//
// Computes what `_kernel` computes: q scaled in float32 before the
//   product, scores, m, l and acc in float32, the mask at
//   qpos = i + (Sk - Sq), p = exp(s - m) zeroed where masked,
//   acc = acc * alpha + p @ v, out = acc / max(l, 1e-9) in q's dtype.  A row
//   that sees no key gives exact zeros.  No logit soft cap (the reference's
//   flash path has none).
//
// What bounds it on this card: arithmetic.  A causal llama3.2-3b layer at
//   B = 2, S = 4096 does 4 * B * Hq * (S^2 / 2) * Dh = 2.06e11 flops against
//   117 MB of q, k, v and out: 1,760 flops a byte, far above the card's
//   ridge.  Here the products run in float32 on the CUDA cores (67 TFLOP/s
//   peak), as the reference's float32 dots do; the bf16 tensor cores would
//   not reproduce a float32 product of a float32-scaled q (ROADMAP Queue 2
//   records that numerics question for the tensor-core version).
//
// Design (simple and right first; no wgmma, TMA or pipelining):
//   * One thread block of 256 threads per (64-row query tile, query head,
//     batch).  The TPU grid's sequential key axis is a loop inside the
//     block over the 64-key tiles that intersect the causal / window band
//     of the tile's rows; tiles outside it are skipped (they would leave m,
//     l and acc exactly unchanged).  Blocks own disjoint outputs: no
//     atomics, and the output is deterministic.
//   * q (pre-scaled), the K tile (both transposed, d-major) and p
//     (transposed) are staged in shared memory as float32; the V tile
//     (row-major) reuses the K tile's buffer once the scores are done, so a
//     Dh = 128 block needs 87,040 B and two blocks fit on an SM.
//   * Thread (ty, tx) of a 16 x 16 grid owns scores of rows 4ty..4ty+3 and
//     keys 4tx..4tx+3 (float4 reads of both operands per d), and the
//     accumulator of the same four rows at columns tx + 16c.  The 16 threads
//     of a row group are 16 consecutive lanes of one warp: the row max and
//     row sum are xor-shuffle reductions, and every one of them holds the
//     rows' m and l.
//   * The new tile's p @ v is summed apart and then added to acc * alpha,
//     in the reference's order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPad = 4;  // keeps float4 alignment, spreads banks
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// reductions over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)Dh * (kBQ + kPad) + (size_t)Dh * (kBK + kPad) +
                          (size_t)kBK * (kBQ + kPad));
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // [B, Hq, Sq, Dh]
    const T* __restrict__ k,  // [B, Hkv, Sk, Dh]
    const T* __restrict__ v,  // [B, Hkv, Sk, Dh]
    T* __restrict__ out,      // [B, Hq, Sq, Dh]
    int Hq, int Hkv, int Sq, int Sk, int causal, int has_window, int window, float scale) {
  constexpr int kLdQ = kBQ + kPad;       // qs [Dh][kLdQ], ps [kBK][kLdQ]
  constexpr int kLdK = kBK + kPad;       // ks [Dh][kLdK]; vs [kBK][Dh] in the same buffer
  constexpr int kCols = (Dh + 15) / 16;  // accumulator columns per thread
  static_assert(kBK * Dh <= Dh * kLdK, "the V tile must fit in the K tile's buffer");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kv = qs + Dh * kLdQ;
  float* ps = kv + Dh * kLdK;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int off = Sk - Sq;  // aligns the last query with the last key
  const T* qb = q + ((size_t)b * Hq + h) * Sq * Dh;
  const T* kb = k + ((size_t)b * Hkv + kvh) * Sk * Dh;
  const T* vb = v + ((size_t)b * Hkv + kvh) * Sk * Dh;
  T* ob = out + ((size_t)b * Hq + h) * Sq * Dh;

  for (int idx = tid; idx < kBQ * Dh; idx += kThreads) {
    const int i = idx / Dh, d = idx % Dh;
    qs[d * kLdQ + i] = (i0 + i < Sq) ? to_f32(qb[(size_t)(i0 + i) * Dh + d]) * scale : 0.f;
  }

  // the keys the tile's rows can see: [k_begin, k_end)
  const int q_lo = i0 + off;
  const int q_hi = min(i0 + kBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = has_window ? max(0, q_lo - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kBK;
    for (int idx = tid; idx < kBK * Dh; idx += kThreads) {
      const int j = idx / Dh, d = idx % Dh;
      kv[d * kLdK + j] = (j0 + j < Sk) ? to_f32(kb[(size_t)(j0 + j) * Dh + d]) : 0.f;
    }
    __syncthreads();  // q (first tile) and the K tile are in shared memory

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kLdQ + ty * 4);
      const float4 e = *reinterpret_cast<const float4*>(kv + d * kLdK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], ev[c], s[r][c]);
    }

    // mask, then the online softmax step; s becomes p
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = i0 + ty * 4 + r + off;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = j0 + tx * 4 + c;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        live[c] = ok;
        if (!ok) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      alpha[r] = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = live[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += s[r][c];
      }
      l[r] = l[r] * alpha[r] + group_sum(sum);
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx * 4 + c) * kLdQ + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();  // every read of the K tile is done; p is in shared memory

    for (int idx = tid; idx < kBK * Dh; idx += kThreads) {
      const int j = idx / Dh, d = idx % Dh;
      kv[idx] = (j0 + j < Sk) ? to_f32(vb[(size_t)(j0 + j) * Dh + d]) : 0.f;
    }
    __syncthreads();  // the V tile is in shared memory

    float pv[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pv[r][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(ps + j * kLdQ + ty * 4);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (Dh % 16 == 0 || col < Dh) {
          const float x = kv[j * Dh + col];
          pv[0][c] = fmaf(pp.x, x, pv[0][c]);
          pv[1][c] = fmaf(pp.y, x, pv[1][c]);
          pv[2][c] = fmaf(pp.z, x, pv[2][c]);
          pv[3][c] = fmaf(pp.w, x, pv[3][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = acc[r][c] * alpha[r] + pv[r][c];
    __syncthreads();  // the next tile overwrites kv and ps
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-9f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (Dh % 16 == 0 || col < Dh) store(ob + (size_t)i * Dh + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int Dh>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Sk, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, Dh><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, Sq, Sk, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int Sq, int Sk, int Dh, int causal, int has_window, int window, float scale,
             cudaStream_t s) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale, s);
    case 16:
      return launch<T, 16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int Dh, int causal,
                                   int has_window, int window, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hq < 1 || Hkv < 1 || Sq < 1 || Sk < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, causal, has_window,
                                   window, scale, s);
  return dispatch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, causal, has_window, window,
                         scale, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
