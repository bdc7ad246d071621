// Edge-walking helpers of the NA kernels #1, #2 and #5
// (seg_gat_agg_multigraph.cu, seg_gat_agg_multigraph_bwd.cu,
// seg_gat_agg.cu), and the forward walk #1 and #5 share (aggregate_row).
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

#include <type_traits>

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


// One dst row's GAT NA over its block row, all heads, by one warp: the
// forward of #1 (a unit row) and of #5 (a dst row of one graph).
//
// The warp walks the row's W slots 32 at a time: lane k reads slot
// w0 + k's column and, for a live slot (col >= 0) only, its mask row as a
// bit set; a ballot keeps the slots whose row has a set bit.  Padding
// slots are skipped even where their masks hold set bits.  Per kept slot,
// in ascending w, the online-softmax step of online_softmax_na.cuh
// restricted to the set j, in ascending j: m_blk over the set j, then
// sc = exp(m_old - m_new), l = l*sc + sum of p_j in j order, and per column
// s = fmaf chain of p_j * h_src[col*B + j, c] from 0 in j order,
// acc = acc*sc + s.  A masked entry adds exactly 0 there and a (row, slot)
// with no set entry leaves m, l and acc as they are (sc = 1), so the row
// gets the bits of that dense step over whole B x B blocks.  Writes
// out_row = acc / max(l, 1e-9) (exact zeros for a row with no live edge),
// lse_row[h] = m + log l where lse_row is not null, and adds the set
// entries visited to *visits where visits is not null.
template <int V, int NK>
__device__ __forceinline__ void aggregate_row(
    const int* __restrict__ col_row,       // [W] the row's src block columns, -1 padding
    const uint8_t* __restrict__ mask_row,  // the row's mask row in slot 0; slot w's at w*B*B
    const float* __restrict__ theta_src,   // [ns_pad, H] of the row's graph
    const float* __restrict__ h_src,       // [ns_pad, H, Dh]
    float td, float bh,                    // lane h: theta_dst and edge bias of head h
    float* __restrict__ out_row,           // [H*Dh]
    float* __restrict__ lse_row,           // [H], or null
    int* __restrict__ visits,              // [1], or null
    int W, int B, int H, int Dh, float slope) {
  const int lane = threadIdx.x & 31;
  const int HDh = H * Dh;
  const int hl = lane < H ? lane : 0;  // lanes past H compute head 0's values, unused
  const float* ths = theta_src + hl;
  int head[NK];
  group_heads<V, NK>(lane, HDh, Dh, head);

  float m = kNegInf, l = 0.f;
  float acc[NK][V];
#pragma unroll
  for (int t = 0; t < NK; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
  int visited = 0;

  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    const int c = w < W ? col_row[w] : -1;
    uint32_t bits[kMaskWords];
    if (c >= 0) {
      row_bits(mask_row + (size_t)w * B * B, B, bits);
    } else {
#pragma unroll
      for (int k = 0; k < kMaskWords; ++k) bits[k] = 0u;  // padding: never read its mask
    }
    unsigned kept = __ballot_sync(kFull, any_bit(bits));
    while (kept != 0u) {  // kept slots in ascending w
      const int from = __ffs(kept) - 1;
      kept &= kept - 1u;
      const int cb = __shfl_sync(kFull, c, from);
      uint32_t set[kMaskWords];
#pragma unroll
      for (int k = 0; k < kMaskWords; ++k) set[k] = __shfl_sync(kFull, bits[k], from);
      const float* ths_c = ths + (size_t)cb * B * H;
      const float* hs_c = h_src + (size_t)cb * B * HDh;

      float m_blk = kNegInf;
      for_each_bit(set, [&](int j) {
        const float pre = td + ths_c[j * H] + bh;
        const float lg = pre >= 0.f ? pre : slope * pre;
        m_blk = fmaxf(m_blk, lg);
      });
      const float m_new = fmaxf(m, m_blk);
      const float sc = expf(m - m_new);
      float sum = 0.f;
      float s[NK][V];
#pragma unroll
      for (int t = 0; t < NK; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) s[t][v] = 0.f;
      for_each_bit(set, [&](int j) {
        float hv[NK][V];
        load_row<V, NK>(hs_c + (size_t)j * HDh, lane, HDh, hv);
        const float pre = td + ths_c[j * H] + bh;
        const float lg = pre >= 0.f ? pre : slope * pre;
        const float pj = expf(lg - m_new);
        sum += pj;
#pragma unroll
        for (int t = 0; t < NK; ++t) {
          const float pt = __shfl_sync(kFull, pj, head[t]);
#pragma unroll
          for (int v = 0; v < V; ++v) s[t][v] = fmaf(pt, hv[t][v], s[t][v]);
        }
        ++visited;
      });
      l = l * sc + sum;
      m = m_new;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const float st = __shfl_sync(kFull, sc, head[t]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[t][v] = acc[t][v] * st + s[t][v];
      }
    }
  }

  float o[NK][V];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const float lt = __shfl_sync(kFull, l, head[t]);
#pragma unroll
    for (int v = 0; v < V; ++v) o[t][v] = acc[t][v] / fmaxf(lt, 1e-9f);
  }
  store_row<V, NK>(out_row, lane, HDh, o);
  if (lse_row != nullptr && lane < H) lse_row[lane] = m + logf(fmaxf(l, 1e-30f));
  if (visits != nullptr && lane == 0) atomicAdd(visits, visited);
}

// The prior layers of a joint NA call (Simple-HGN's residual attention,
// seg_gat_agg_multigraph.cu and _bwd.cu): layer k's attention on edge
// (i <- j, relation r) is p^k = exp(LeakyReLU(theta_dst[k, i] + theta_src[k, j]
// + bias[k, r]) - lse[k, i]), per head, recomputed where an edge is visited,
// and alpha = sum over k < K of coef[k] * p^k.
constexpr int kMaxPriors = 4;

struct Priors {
  const float* theta_src;  // [K, ns, H]
  const float* theta_dst;  // [K, nd, H]
  const float* bias;       // [K, R, H]
  const float* lse;        // [K, nd, H]
  float coef[kMaxPriors];
  int K;
};

// Lane h's prior-layer scalars of dst row r: theta_dst and lse of each layer.
__device__ __forceinline__ void prior_row(const Priors& pr, size_t r, int nd, int H, int hl,
                                          float (&tdk)[kMaxPriors], float (&lsk)[kMaxPriors]) {
#pragma unroll
  for (int k = 0; k < kMaxPriors; ++k) {
    if (k < pr.K) {
      const size_t at = ((size_t)k * nd + r) * H + hl;
      tdk[k] = pr.theta_dst[at];
      lsk[k] = pr.lse[at];
    }
  }
}

// alpha of head hl on the edge from src vertex s under relation rel.
__device__ __forceinline__ float prior_alpha(const Priors& pr, int s, int rel, int ns, int R,
                                             int H, int hl, const float (&tdk)[kMaxPriors],
                                             const float (&lsk)[kMaxPriors], float slope) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPriors; ++k) {
    if (k < pr.K) {
      const float pre = tdk[k] + pr.theta_src[((size_t)k * ns + s) * H + hl]
                        + pr.bias[((size_t)k * R + rel) * H + hl];
      const float lg = pre >= 0.f ? pre : slope * pre;
      a = fmaf(pr.coef[k], expf(lg - lsk[k]), a);
    }
  }
  return a;
}

// launch(V, NK) for the instantiation a row of H*Dh floats takes, as
// std::integral_constant values (kernels/seg_gat_agg_multigraph.py:
// lane_groups): V = 4 when Dh % 4 == 0, else 1, and NK in {1, 2, 4, 8}
// the fewest groups a lane that cover the row.  Returns launch's code, or
// cudaErrorInvalidValue where a row needs more than 8 groups a lane.
template <typename Launch>
int with_lane_groups(int H, int Dh, Launch&& launch) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Four = std::integral_constant<int, 4>;
  using Eight = std::integral_constant<int, 8>;
  const int V = Dh % 4 == 0 ? 4 : 1;
  const int groups = (H * Dh + 32 * V - 1) / (32 * V);  // groups a lane owns
  if (V == 4) {
    if (groups <= 1) return launch(Four{}, One{});
    if (groups <= 2) return launch(Four{}, Two{});
    if (groups <= 4) return launch(Four{}, Four{});
    if (groups <= 8) return launch(Four{}, Eight{});
  } else {
    if (groups <= 1) return launch(One{}, One{});
    if (groups <= 2) return launch(One{}, Two{});
    if (groups <= 4) return launch(One{}, Four{});
    if (groups <= 8) return launch(One{}, Eight{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace edge_na
