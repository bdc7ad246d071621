// Edge-walking helpers of the multigraph NA kernels #1 and #2
// (seg_gat_agg_multigraph.cu, seg_gat_agg_multigraph_bwd.cu).
//
// A warp owns one row of H*Dh floats (a dst row, or a src vertex in #2's
// pass B), all heads.  Its lanes own the columns in NK groups of V
// consecutive floats: group t of lane L starts at column V * (L + 32 t),
// so a warp reads a row in 32 * V-float coalesced pieces.  V = 4 (float4
// loads) when Dh % 4 == 0, so that a group lies in one head; V = 1
// otherwise.  Lane h < H holds head h's scalars (softmax statistics,
// lse, delta, gradients of theta); a lane gets the value of a group's
// head with one shuffle.
//
// A mask row (B bytes, one per src j of a B x B slot mask) is read as a
// bit set of kMaskWords words: bit j set when byte j is nonzero.  The
// warps visit the set bits only, in ascending j.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_na {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;                  // warps per block of every kernel here
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlock = 128;             // largest B
constexpr int kMaskWords = kMaxBlock / 32; // words of a mask row's bit set
constexpr unsigned kFull = 0xffffffffu;

// The head of each of the lane's groups (0 for a group past the row's end).
template <int V, int NK>
__device__ __forceinline__ void group_heads(int lane, int HDh, int Dh, int (&head)[NK]) {
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int c = V * (lane + 32 * t);
    head[t] = c < HDh ? c / Dh : 0;
  }
}

// x = the lane's columns of `row` (H*Dh floats, 16-byte aligned when V = 4);
// columns past the row's end read as 0.
template <int V, int NK>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int lane, int HDh,
                                         float (&x)[NK][V]) {
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int c = V * (lane + 32 * t);
    if (c < HDh) {
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
        x[t][0] = q.x;
        x[t][1] = q.y;
        x[t][2] = q.z;
        x[t][3] = q.w;
      } else {
        x[t][0] = __ldg(row + c);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[t][v] = 0.f;
    }
  }
}

template <int V, int NK>
__device__ __forceinline__ void store_row(float* __restrict__ row, int lane, int HDh,
                                          const float (&x)[NK][V]) {
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int c = V * (lane + 32 * t);
    if (c < HDh) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(row + c) = make_float4(x[t][0], x[t][1], x[t][2], x[t][3]);
      } else {
        row[c] = x[t][0];
      }
    }
  }
}

// The set bits of a mask row of B bytes (B a multiple of 8, the row
// 8-byte aligned): bit j of the set is byte j != 0.
__device__ __forceinline__ void row_bits(const uint8_t* __restrict__ m, int B,
                                         uint32_t (&bits)[kMaskWords]) {
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) bits[k] = 0u;
  const uint2* w = reinterpret_cast<const uint2*>(m);
#pragma unroll
  for (int q = 0; q < kMaxBlock / 8; ++q) {
    if (8 * q < B) {
      const uint2 x = __ldg(w + q);
      const uint32_t lo = __vcmpne4(x.x, 0u), hi = __vcmpne4(x.y, 0u);  // 0xff a set byte
      const uint32_t b8 = (lo & 1u) | ((lo >> 7) & 2u) | ((lo >> 14) & 4u) | ((lo >> 21) & 8u)
                          | (((hi & 1u) | ((hi >> 7) & 2u) | ((hi >> 14) & 4u) | ((hi >> 21) & 8u)) << 4);
      bits[q / 4] |= b8 << (8 * (q % 4));
    }
  }
}

__device__ __forceinline__ bool any_bit(const uint32_t (&bits)[kMaskWords]) {
  uint32_t a = 0u;
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) a |= bits[k];
  return a != 0u;
}

// body(j) for every set bit j, in ascending j.  `bits` is the same in
// every lane, so the loop is warp-uniform.
template <typename Body>
__device__ __forceinline__ void for_each_bit(const uint32_t (&bits)[kMaskWords], Body&& body) {
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) {
    uint32_t word = bits[k];
    while (word != 0u) {
      const int j = 32 * k + __ffs(word) - 1;
      word &= word - 1u;
      body(j);
    }
  }
}

}  // namespace edge_na
