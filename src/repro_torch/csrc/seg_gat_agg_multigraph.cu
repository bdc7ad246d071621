// Multi-graph fused NA forward for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `_fwd_call` of
//   src/repro/kernels/seg_gat_agg_multigraph.py (grid (H, U, W), online
//   softmax carried in VMEM scratch across the sequential W axis, dense
//   B x B work on every slot).
//
// What bounds it on this card: the bytes of the edges.  A semantic graph's
//   B x B blocks are sparse (0.84% of the mask entries of live slots are
//   set on full IMDB at B = 16: ≈ 2 edges a live (slot, row)), so the work
//   is one h_src row (H*Dh floats, 2 KB at HAN's width) and H logits per
//   set entry, plus one B-byte mask row per live (slot, dst row).  The
//   h_src rows a unit reads are shared by many units and mostly served
//   from L2; the function's bound is its unique bytes.
//
// Design:
//   * One warp per (unit, dst row i), all heads; the lanes own columns of
//     H*Dh (edge_na.cuh), lane h < H the row's softmax statistics m, l of
//     head h.  Units are disjoint in their output rows: no atomics, and
//     out and lse are written once.
//   * The row's walk is edge_na.cuh's aggregate_row, which #5
//     (seg_gat_agg.cu) runs too: the warp reads 32 slots' mask rows i at
//     a time as bit sets, a ballot keeps the live slots with a set bit,
//     and it visits only those set entries, in ascending (w, j), with the
//     sums in the order and expressions of online_softmax_na.cuh's dense
//     step.  So the output has the bits of that step over whole B x B
//     blocks, and #5 == #1 at G = 1 holds by construction (chip_smoke.py
//     checks it bit for bit).
//   * No host-built index: the serving engine's unit tables change every
//     step.  Any B in {8, 16, 32, 64, 128}; H <= 32.
#include "edge_na.cuh"

namespace {

using namespace edge_na;

template <int V, int NK>
__global__ void __launch_bounds__(kThreads) multigraph_fwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
    const int* __restrict__ graph_id,     // [U]
    const int* __restrict__ dst_row,      // [U]
    const uint8_t* __restrict__ masks,    // [U, W, B, B]
    const float* __restrict__ theta_src,  // [G, ns_pad, H]
    const float* __restrict__ theta_dst,  // [G, nd_pad, H]
    const float* __restrict__ h_src,      // [ns_pad, H, Dh]
    const float* __restrict__ edge_bias,  // [G, H]
    float* __restrict__ out,              // [U*B, H, Dh]
    float* __restrict__ lse,              // [U*B, H]
    int* __restrict__ visits,             // [1] set entries visited, or null
    int U, int W, int B, int ns_pad, int nd_pad, int H, int Dh, float slope) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);  // unit row u*B + i
  if (r >= U * B) return;  // warp-uniform
  const int u = r / B, i = r % B;
  const int g = graph_id[u];
  const int hl = lane < H ? lane : 0;
  aggregate_row<V, NK>(
      col_index + (size_t)u * W, masks + (size_t)u * W * B * B + (size_t)i * B,
      theta_src + (size_t)g * ns_pad * H, h_src,
      theta_dst[((size_t)g * nd_pad + (size_t)dst_row[u] * B + i) * H + hl], edge_bias[g * H + hl],
      out + (size_t)r * H * Dh, lse + (size_t)r * H, visits, W, B, H, Dh, slope);
}

template <int V, int NK>
int launch(const int* col_index, const int* graph_id, const int* dst_row, const uint8_t* masks,
           const float* theta_src, const float* theta_dst, const float* h_src,
           const float* edge_bias, float* out, float* lse, int* visits, int U, int W, int B,
           int ns_pad, int nd_pad, int H, int Dh, float slope, cudaStream_t stream) {
  const long long rows = (long long)U * B;
  if (rows > 0) {
    const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
    multigraph_fwd_kernel<V, NK><<<grid, kThreads, 0, stream>>>(
        col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias, out, lse,
        visits, U, W, B, ns_pad, nd_pad, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [U*B, H, Dh] and lse [U*B, H] on `stream`; `visits` (nullable) gains
// the number of set entries the warps visited.  H*Dh floats a row must be
// 16-byte aligned when Dh % 4 == 0 (the wrapper sees to it).
extern "C" int seg_gat_agg_multigraph_fwd(
    const int* col_index, const int* graph_id, const int* dst_row, const uint8_t* masks,
    const float* theta_src, const float* theta_dst, const float* h_src,
    const float* edge_bias, float* out, float* lse, int* visits,
    int U, int W, int B, int ns_pad, int nd_pad, int H, int Dh, float slope,
    void* stream) {
  if (B % 8 != 0 || B > kMaxBlock || H < 1 || H > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lane_groups(H, Dh, [&](auto v, auto nk) {
    return launch<decltype(v)::value, decltype(nk)::value>(
        col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias, out, lse,
        visits, U, W, B, ns_pad, nd_pad, H, Dh, slope, s);
  });
}

namespace {

using namespace edge_na;

// ---- The joint NA: one softmax over every relation into a row ------------
//
// Simple-HGN's layer (Lv et al., KDD'21): the vertices of every type in one
// table, and a unit per dst block holding the slots of every relation into
// it, ragged: unit u's slots are [unit_off[u], unit_off[u+1]), slot s a
// (relation slot_rel[s], src block slot_col[s]) with its B x B mask.  The
// row's walk is aggregate_row's (slots 32 at a time, a ballot of those with
// a set bit, the set entries in ascending (slot, j), the online softmax of
// online_softmax_na.cuh) with the edge bias of each slot's relation, so the
// softmax and lse span every relation into the row.  kPrior adds the
// residual attention of the prior layers: per visited edge, alpha =
// sum_k coef[k] p^k (edge_na.cuh: prior_alpha) and pa += alpha * h_src[j]
// beside the softmax's accumulator; the row's output is then
// (1 - beta) * softmax part + beta * pa, and `soft` (where not null) gets
// the softmax part, which the backward's delta reads.  Without kPrior the
// output is the softmax part.  The existing kernel above is left as it was:
// the joint walk is its own function, so the per-graph callers' code and
// bits do not move.
template <int V, int NK, bool kPrior>
__global__ void __launch_bounds__(kThreads) multigraph_fwd_kernel_joint(
    const int* __restrict__ unit_off,     // [U + 1]
    const int* __restrict__ slot_col,     // [S]
    const int* __restrict__ slot_rel,     // [S]
    const uint8_t* __restrict__ masks,    // [S, B, B]
    const float* __restrict__ theta_src,  // [ns, H]
    const float* __restrict__ theta_dst,  // [nd, H]
    const float* __restrict__ h_src,      // [ns, H, Dh]
    const float* __restrict__ edge_bias,  // [R, H]
    const Priors pr, float beta,
    float* __restrict__ out,              // [U*B, H, Dh]
    float* __restrict__ lse,              // [U*B, H]
    float* __restrict__ soft,             // [U*B, H, Dh], or null
    int U, int B, int ns, int nd, int R, int H, int Dh, float slope) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);  // dst row u*B + i
  if (r >= U * B) return;  // warp-uniform
  const int u = r / B, i = r % B;
  const int HDh = H * Dh;
  const int hl = lane < H ? lane : 0;  // lanes past H compute head 0's values, unused
  const float* ths = theta_src + hl;
  const float td = theta_dst[(size_t)r * H + hl];
  int head[NK];
  group_heads<V, NK>(lane, HDh, Dh, head);
  const int s0 = unit_off[u];
  const int W = unit_off[u + 1] - s0;
  const int* col_row = slot_col + s0;
  const int* rel_row = slot_rel + s0;
  const uint8_t* mask_row = masks + (size_t)s0 * B * B + (size_t)i * B;
  float tdk[kMaxPriors], lsk[kMaxPriors];
  if constexpr (kPrior) prior_row(pr, (size_t)r, nd, H, hl, tdk, lsk);

  float m = kNegInf, l = 0.f;
  float acc[NK][V], pa[NK][V];
#pragma unroll
  for (int t = 0; t < NK; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = pa[t][v] = 0.f;

  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    const int c = w < W ? col_row[w] : -1;
    const int rel = w < W ? rel_row[w] : 0;
    uint32_t bits[kMaskWords];
    if (c >= 0) {
      row_bits(mask_row + (size_t)w * B * B, B, bits);
    } else {
#pragma unroll
      for (int k = 0; k < kMaskWords; ++k) bits[k] = 0u;
    }
    unsigned kept = __ballot_sync(kFull, any_bit(bits));
    while (kept != 0u) {  // kept slots in ascending w
      const int from = __ffs(kept) - 1;
      kept &= kept - 1u;
      const int cb = __shfl_sync(kFull, c, from);
      const int rb = __shfl_sync(kFull, rel, from);
      uint32_t set[kMaskWords];
#pragma unroll
      for (int k = 0; k < kMaskWords; ++k) set[k] = __shfl_sync(kFull, bits[k], from);
      const float bh = edge_bias[rb * H + hl];
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
        if constexpr (kPrior) {
          const float a = prior_alpha(pr, cb * B + j, rb, ns, R, H, hl, tdk, lsk, slope);
#pragma unroll
          for (int t = 0; t < NK; ++t) {
            const float at = __shfl_sync(kFull, a, head[t]);
#pragma unroll
            for (int v = 0; v < V; ++v) pa[t][v] = fmaf(at, hv[t][v], pa[t][v]);
          }
        }
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
  float* out_row = out + (size_t)r * HDh;
  if constexpr (kPrior) {
    if (soft != nullptr) store_row<V, NK>(soft + (size_t)r * HDh, lane, HDh, o);
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) o[t][v] = fmaf(1.f - beta, o[t][v], beta * pa[t][v]);
  }
  store_row<V, NK>(out_row, lane, HDh, o);
  if (lane < H) lse[(size_t)r * H + lane] = m + logf(fmaxf(l, 1e-30f));
}

template <int V, int NK, bool kPrior>
int launch_joint(const int* unit_off, const int* slot_col, const int* slot_rel,
                 const uint8_t* masks, const float* theta_src, const float* theta_dst,
                 const float* h_src, const float* edge_bias, const Priors& pr, float beta,
                 float* out, float* lse, float* soft, int U, int B, int ns, int nd, int R, int H,
                 int Dh, float slope, cudaStream_t stream) {
  const long long rows = (long long)U * B;
  if (rows > 0) {
    const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
    multigraph_fwd_kernel_joint<V, NK, kPrior><<<grid, kThreads, 0, stream>>>(
        unit_off, slot_col, slot_rel, masks, theta_src, theta_dst, h_src, edge_bias, pr, beta,
        out, lse, soft, U, B, ns, nd, R, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The joint NA of U dst blocks on `stream`: out [U*B, H, Dh], lse [U*B, H],
// and with K > 0 prior layers (arrays of K entries, coef on the host) soft
// [U*B, H, Dh] where not null.  K <= kMaxPriors.  Rows of H*Dh floats must
// be 16-byte aligned when Dh % 4 == 0 (the wrapper sees to it).
extern "C" int seg_gat_agg_multigraph_joint_fwd(
    const int* unit_off, const int* slot_col, const int* slot_rel, const uint8_t* masks,
    const float* theta_src, const float* theta_dst, const float* h_src, const float* edge_bias,
    const float* prior_theta_src, const float* prior_theta_dst, const float* prior_bias,
    const float* prior_lse, const float* prior_coef, int K, float beta,
    float* out, float* lse, float* soft,
    int U, int B, int ns, int nd, int R, int H, int Dh, float slope, void* stream) {
  if (B % 8 != 0 || B > kMaxBlock || H < 1 || H > 32 || K < 0 || K > kMaxPriors) {
    return (int)cudaErrorInvalidValue;
  }
  Priors pr{prior_theta_src, prior_theta_dst, prior_bias, prior_lse, {0.f, 0.f, 0.f, 0.f}, K};
  for (int k = 0; k < K; ++k) pr.coef[k] = prior_coef[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lane_groups(H, Dh, [&](auto v, auto nk) {
    constexpr int kV = decltype(v)::value, kNK = decltype(nk)::value;
    return K > 0 ? launch_joint<kV, kNK, true>(unit_off, slot_col, slot_rel, masks, theta_src,
                                               theta_dst, h_src, edge_bias, pr, beta, out, lse,
                                               soft, U, B, ns, nd, R, H, Dh, slope, s)
                 : launch_joint<kV, kNK, false>(unit_off, slot_col, slot_rel, masks, theta_src,
                                                theta_dst, h_src, edge_bias, pr, beta, out, lse,
                                                soft, U, B, ns, nd, R, H, Dh, slope, s);
  });
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
