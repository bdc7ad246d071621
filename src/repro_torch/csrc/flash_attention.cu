// Causal / local-window / bidirectional GQA attention forward for Hopper
// (sm_90a): the full-sequence attention of the LM decoder (impl="flash").
//
// Replaces: the Pallas TPU kernel `flash_attention` / `_kernel` of
//   src/repro/kernels/flash_attention.py (grid (B, Hq, Sq/BQ, Sk/BK), 512 x
//   512 VMEM blocks, the key axis sequential with m, l and acc carried in
//   VMEM scratch; no VJP).
//
// Computes what `_kernel` computes: scores, m, l and acc in float32, the
//   mask at qpos = i + (Sk - Sq), p = exp(s - m) zeroed where masked,
//   acc = acc * alpha + p @ v, out = acc / max(l, 1e-9) in q's dtype.  A row
//   that sees no key gives exact zeros.  No logit soft cap (the reference's
//   flash path has none).
//
// Two routes.  The wrapper (kernels/flash_attention.py: route) picks one from
// the operands' dtype and head width before the launch; neither stands in
// for the other when it fails.
//
// Route "wgmma" (flash_attention_wgmma_fwd): bf16 operands, Dh in {64, 128}.
//   What bounds it on this card: tensor-core operations.  llama3.2-3b's layer
//   (B = 2, 24/8 heads of 128, S = 4096, causal) needs 6 * Dh flops a visible
//   (query, key) pair, 2 Dh for q.k and 4 Dh for the two halves of p.v below:
//   3.09e11 flops, 0.31 ms at 989 TFLOP/s, against 134 MB of q, k, v and out,
//   0.04 ms at 3.35 TB/s.
//   Numerics, the reference's float32 contract:
//   * S = q k^T from the unscaled bf16 q and k.  A bf16 x bf16 product is
//     exact in float32 and wgmma sums in float32, so S is the reference's
//     float32 dot up to summation order.  The scale (with log2 e folded in,
//     for exp2) multiplies the float32 score after the product: one float32
//     rounding away from the reference's scaled q.
//   * m, l, alpha and p are float32; l sums the float32 p.
//   * p @ v: p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi), two
//     tensor-core products on the same V tile.  p keeps about 16 significant
//     bits, where a single bf16 p would lose up to 2^-9 of each weight.  It
//     costs 1.5x the tensor-core work of a bf16-p kernel.
//   Design (FlashAttention-3's forward shape, simplified: no intra-warpgroup
//   overlap of softmax and products, no ping-pong between warpgroups):
//   * One block of 384 threads per (128-row query tile, query head, batch),
//     the tiles with the longest causal rows first (blockIdx.z reversed), so
//     the last wave is short.  Query head h reads KV head h / (Hq / Hkv).
//   * Warpgroup 0 produces: after `setmaxnreg` hands its registers to the
//     consumers (24 / 240 a thread), one thread loads Q once and the K and V
//     tiles (128 keys) by TMA into a ring of 2 stages, K and V behind
//     separate full mbarriers (S can start before V lands) and one empty
//     mbarrier a stage.  Warpgroups 1 and 2 consume, 64 query rows each.
//   * TMA boxes are 64 columns (a box's inner dimension is at most the
//     128-byte swizzle span): a Dh = 128 row is two boxes, and the wgmma
//     descriptors walk them.  The tensor maps are 3-D over [B*H, S, Dh], so a
//     ragged last tile is zero-filled inside its own head.  A key past Sk
//     reads as zero and gives s = 0, so every tile that reaches past Sk takes
//     the mask.
//   * S: wgmma m64n128k16, A (Q) and B (K) K-major in shared memory.  O:
//     wgmma m64n{Dh}k16, A (p_hi, then p_lo) from registers, already in S's
//     accumulator layout (no shuffle), B (V) in shared memory as stored,
//     [keys][Dh], through the descriptor's transpose bit.
//   * A tile inside every row's band of the warpgroup skips the mask; the
//     diagonal, window-edge and ragged ones apply it.  Masked scores are
//     -inf, so p = exp2(-inf - m) = 0 exactly, and m starts at -1e30 as the
//     reference's does.  O is rescaled by alpha before the tile's products
//     accumulate into it.
//   * Blocks own disjoint outputs, key tiles go in a fixed order, and there
//     are no atomics and no split over keys: the output is bitwise repeatable.
//   * The tensor maps are built on the host at each launch
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//     library needs no -lcuda) and passed as __grid_constant__ parameters.
//   * An mbarrier wait that lasts seconds is a lost arrival, never a slow
//     tile: it traps, so the launch fails instead of hanging the card.
//
// Route "cuda_cores" (flash_attention_fwd): float32 operands, and bf16 at
//   Dh in {8, 16, 32, 256}.  q is scaled in float32 before the product, as
//   the reference does, and every product is a float32 FMA.
//   What bounds it: arithmetic on the CUDA cores (67 TFLOP/s float32): the
//   layer above at 4 * Dh flops a visible pair is 2.06e11 flops, 3.08 ms.
//   Design (simple and right first; no wgmma, TMA or pipelining):
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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ===========================================================================
// Route "wgmma": bf16 operands, Dh in {64, 128}
// ===========================================================================
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kBK = 128;       // keys a tile
constexpr int kStages = 2;     // depth of the K / V ring
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kSpan = 128;     // bytes of one swizzled row of a box: 64 bf16 columns
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 <= 65,536
constexpr float kNegBig = -1e30f;                        // m's start, the reference's NEG_INF

// Dynamic shared memory of one block: Q [Dh/64][kBQ][64], then kStages K
// tiles and kStages V tiles [Dh/64][kBK][64] (bf16, 128-byte swizzled, each
// on a 1,024-byte boundary), then the mbarriers; 1,024 B of slack align the
// base.  kernels/flash_attention.py:smem_bytes mirrors it.
template <int Dh>
struct Layout {
  static constexpr int kHalves = Dh / 64;
  static constexpr int kQBytes = kBQ * Dh * 2;
  static constexpr int kTileBytes = kBK * Dh * 2;  // one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 3 * kStages);
  static constexpr int kBytes = kQBytes + 2 * kStages * kTileBytes + kBarBytes + 1024;
};

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return (uint32_t)__bfloat16_as_ushort(x.x) | ((uint32_t)__bfloat16_as_ushort(x.y) << 16);
}

// d[0:64] (+)= A . B: A [64 x 16] and B [128 x 16], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[0:64] += A . B: A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma_ss), B [16 x 128] MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:32] += A . B: A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma_ss), B [16 x 64] MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // q [B*Hq, Sq, Dh], boxes of 64 x kBQ
    const __grid_constant__ CUtensorMap tm_k,  // k [B*Hkv, Sk, Dh], boxes of 64 x kBK
    const __grid_constant__ CUtensorMap tm_v,  // v like k
    __nv_bfloat16* __restrict__ out,           // [B, Hq, Sq, Dh]
    int Hq, int Hkv, int Sq, int Sk, int causal, int has_window, int window, float scale_log2) {
  using L = Layout<Dh>;
  constexpr int kSplit = kBK / 16;  // k16 steps of p @ v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + L::kQBytes;  // stage s at + s * kTileBytes
  const uint32_t sV = sK + kStages * L::kTileBytes;
  const uint32_t bar_q = sV + kStages * L::kTileBytes;
  const uint32_t bar_k = bar_q + 8;               // full: K of stage s at + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;     // full: V of stage s
  const uint32_t bar_e = bar_v + 8 * kStages;     // empty: stage s consumed

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // the longest causal rows first
  const int off = Sk - Sq;                            // aligns the last query with the last key
  // the key tiles the block's rows can see
  const int q_lo = i0 + off;
  const int q_hi = min(i0 + kBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = has_window ? max(0, q_lo - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; it never rejoins the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int q_head = b * Hq + h, kv_head = b * Hkv + h / (Hq / Hkv);
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_3d(sQ + c * kBQ * kSpan, &tm_q, bar_q, 64 * c, i0, q_head);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        mbar_wait(bar_e + 8 * s, ((n / kStages) & 1) ^ 1);  // the first round passes at once
        const int j0 = (t_begin + n) * kBK;
        mbar_expect_tx(bar_k + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          tma_load_3d(sK + s * L::kTileBytes + c * kBK * kSpan, &tm_k, bar_k + 8 * s, 64 * c, j0,
                      kv_head);
        mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          tma_load_3d(sV + s * L::kTileBytes + c * kBK * kSpan, &tm_v, bar_v + 8 * s, 64 * c, j0,
                      kv_head);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128;  // which 64 rows of the tile
  const int warp = (ct / 32) % 4, lane = ct % 32;
  const int g = lane / 4, t4 = lane % 4;
  // accumulator layout: register i holds row g + 8 ((i >> 1) & 1) of the
  // warp's 16, column 8 (i >> 2) + 2 t4 + (i & 1)
  const int r0 = i0 + wg * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = r0 + off, qpos1 = r0 + 8 + off;
  const int w_lo = i0 + wg * 64 + off;  // positions of the warpgroup's first and last rows
  const int w_hi = w_lo + 63;
  const uint32_t sQw = sQ + wg * 64 * kSpan;

  float o[Dh / 2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) o[i] = 0.f;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
  const float neg_inf = __int_as_float(0xff800000);

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    const uint32_t parity = (n / kStages) & 1;
    const int j0 = (t_begin + n) * kBK;

    // S = Q K^T, float32
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    mbar_wait(bar_k + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // byte offset inside the 128-byte row
      const uint64_t da = desc(sQw + (kk / 4) * kBQ * kSpan + col, 16, 1024);
      const uint64_t db = desc(sK + s * L::kTileBytes + (kk / 4) * kBK * kSpan + col, 16, 1024);
      wgmma_ss_m64n128k16(sc, da, db, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale (log2 domain) and mask; a tile inside the band of all 64 rows skips the mask
    const bool need_mask = j0 + kBK > Sk || (causal && j0 + kBK - 1 > w_lo) ||
                           (has_window && j0 <= w_hi - window);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kpos = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (!has_window || kpos > qpos - window);
        sc[i] = ok ? sc[i] * scale_log2 : neg_inf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale_log2;
    }

    // online softmax step in float32; a row's 4 threads are lanes 4g..4g+3
    float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const float p = exp2f(sc[i] - ((i & 2) ? mn1 : mn0));
      sc[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

    // p = p_hi + p_lo in bf16, already in the A-operand layout: for key step
    // kk, A register r holds S registers 8 kk + 2 r and 8 kk + 2 r + 1
    uint32_t p_hi[kSplit][4], p_lo[kSplit][4];
#pragma unroll
    for (int kk = 0; kk < kSplit; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][r] = pack_bf16(hi);
        p_lo[kk][r] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }

    // O += p_hi V + p_lo V; V [keys][Dh] is N-major: LBO steps 64 columns, SBO 8 keys
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_wait(bar_v + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSplit; ++kk) {
      const uint64_t db = desc(sV + s * L::kTileBytes + kk * 16 * kSpan, kBK * kSpan, 8 * kSpan);
      wgmma_rs(o, p_hi[kk], db);
      wgmma_rs(o, p_lo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-9f), d1 = fmaxf(l1, 1e-9f);
  __nv_bfloat16* ob = out + (size_t)(b * Hq + h) * Sq * Dh;
#pragma unroll
  for (int i = 0; i < Dh / 2; i += 2) {
    const int row = (i & 2) ? r0 + 8 : r0;
    const float den = (i & 2) ? d1 : d0;
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * Dh + 8 * (i >> 2) + 2 * t4) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
  }
}

// A [heads, S, Dh] bf16 tensor in boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle; rows past S read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int heads, int S, int Dh, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 2, (cuuint64_t)S * Dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int Dh>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Sk, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B * Hq, Sq, Dh, kBQ);
  if (err == 0) err = tensor_map(&mk, k, B * Hkv, Sk, Dh, kBK);
  if (err == 0) err = tensor_map(&mv, v, B * Hkv, Sk, Dh, kBK);
  if (err != 0) return err;
  constexpr int smem = Layout<Dh>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<Dh>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + kBQ - 1) / kBQ);
  flash_attention_wgmma_kernel<Dh><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Sk, causal, has_window, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
                                         int causal, int has_window, int window, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hq < 1 || Hkv < 1 || Sq < 1 || Sk < 1 || Hq % Hkv != 0 || B > 65535 ||
      (Sq + tc::kBQ - 1) / tc::kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 64:
      return tc::launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale, s);
    case 128:
      return tc::launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, has_window, window, scale,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }
