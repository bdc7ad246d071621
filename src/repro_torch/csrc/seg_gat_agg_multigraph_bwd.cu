// Multi-graph NA backward for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` / `_bwd_call` of
//   src/repro/kernels/seg_gat_agg_multigraph.py (grid (H, U, W), d_theta_dst
//   carried in VMEM scratch across the sequential W axis, a dense partial
//   written for every (unit, slot), padding included), and the segment sums
//   of `_multigraph_bwd` that scatter those partials.
//
// What bounds it on this card: the bytes of the edges.  Per set mask entry
//   (an edge e: unit u, dst row i, src vertex s) and head the backward
//   recomputes p from lse and does two length-Dh dot products; under 1% of
//   the mask entries of live slots are set at HAN's shape, so the work and
//   the traffic follow the E edges: one h_src row and one g_out row (H*Dh
//   floats each, mostly from L2) an edge and pass.
//
// Design: two passes over the edges, both on `stream`, no atomics, each
//   output row written once, so the gradients are bitwise repeatable for
//   a fixed topology.  The host builds the edge index once per topology
//   (kernels/seg_gat_agg_multigraph.py: edge_index):
//   * edges are numbered dst-major, in the forward's order: by (unit u,
//     dst row i, slot w, src j); row_off[u*B + i] is where row (u, i)'s
//     edges start and e_src[e] = col[u, w]*B + j is edge e's src vertex;
//   * src_off / src_edge / src_row are the src-major CSR: the edges sorted
//     by (src vertex s, graph, unit, slot, i), one segment a (s, graph);
//   * gdst_off / gdst_items list the units of each (graph, dst block), in
//     unit order.
//   Pass A, one warp per (graph g, dst vertex row), all heads (the lanes
//     own columns of H*Dh as in edge_na.cuh, lane h head h's scalars):
//     for each unit of (g, row's block) in gdst order, with that unit row's
//     g_out, lse and delta in registers, for each of its edges in dst-major
//     order: pre = theta_dst + theta_src[s] + bias, p = exp(LeakyReLU(pre) -
//     lse), dp_h = <g_out, h_src[s]> per head (each lane's per-group dot,
//     then lane h sums its head's groups in column order through shared
//     memory), dpre = LeakyReLU'(pre) * p * (dp - delta); it writes p and
//     dpre to the edge arrays [E, H] and sums dpre into d_theta_dst[g, row]
//     in that order.  The next edge's src index, theta_src and h_src row
//     are loaded while an edge is reduced (two dependent L2 round trips an
//     edge, in flight for two edges at a time).
//   Pass B, one warp per src vertex s: for each graph g in order, over
//     the edges of segment (s, g) in CSR order, d_h_src[s] += p_e[h(c)] *
//     g_out[u*B + i, c] (one sum over every graph) and d_theta_src[g, s]
//     = sum of dpre_e.  Scratch is the two edge arrays, O(E*H); no
//     per-(unit, slot) buffer.
#include "edge_na.cuh"

namespace {

using namespace edge_na;

template <int V, int NK>
__global__ void __launch_bounds__(kThreads) edge_pass_a(
    const int* __restrict__ gdst_off,     // [G*nd_pad/B + 1]
    const int* __restrict__ gdst_items,   // [U]
    const int* __restrict__ row_off,      // [U*B + 1]
    const int* __restrict__ e_src,        // [E]
    const float* __restrict__ theta_src,  // [G, ns_pad, H]
    const float* __restrict__ theta_dst,  // [G, nd_pad, H]
    const float* __restrict__ h_src,      // [ns_pad, H, Dh]
    const float* __restrict__ edge_bias,  // [G, H]
    const float* __restrict__ g_out,      // [U*B, H, Dh]
    const float* __restrict__ lse,        // [U*B, H]
    const float* __restrict__ delta,      // [U*B, H]
    float* __restrict__ p_e,              // [E, H]
    float* __restrict__ dpre_e,           // [E, H]
    float* __restrict__ d_theta_dst,      // [G, nd_pad, H]
    int G, int B, int ns_pad, int nd_pad, int H, int Dh, float slope) {
  // per warp: the lane groups' dot products, group q at q + head(q) (a gap
  // a head, so lane h's reads of its head's run hit distinct banks)
  __shared__ float red[kWarps][32 * NK + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;  // g * nd_pad + dst vertex
  if (k >= G * nd_pad) return;  // warp-uniform
  const int g = k / nd_pad, rr = k % nd_pad;
  const int blk = rr / B, i = rr % B;
  const int HDh = H * Dh;
  const int hl = lane < H ? lane : 0;
  const int per_head = Dh / V;  // groups of one head
  const float* ths_g = theta_src + (size_t)g * ns_pad * H + hl;
  const float td = theta_dst[(size_t)k * H + hl];
  const float bh = edge_bias[g * H + hl];
  int head[NK];
  group_heads<V, NK>(lane, HDh, Dh, head);
  float* red_w = red[warp];
  const float* run = red_w + hl * (per_head + 1);  // lane h's head: per_head values

  float dthd = 0.f;
  const int q1 = gdst_off[g * (nd_pad / B) + blk + 1];
  for (int q = gdst_off[g * (nd_pad / B) + blk]; q < q1; ++q) {
    const int R = gdst_items[q] * B + i;  // the unit's row
    float go[NK][V];
    load_row<V, NK>(g_out + (size_t)R * HDh, lane, HDh, go);
    const float ls = lse[(size_t)R * H + hl];
    const float dl = delta[(size_t)R * H + hl];
    const int e0 = row_off[R], e1 = row_off[R + 1];
    if (e0 == e1) continue;  // warp-uniform
    // the next edge's src row and theta_src are loaded while this edge is
    // reduced, so a warp has two dependent L2 round trips in flight
    int s = e_src[e0];
    float ths = ths_g[(size_t)s * H];
    float hv[NK][V];
    load_row<V, NK>(h_src + (size_t)s * HDh, lane, HDh, hv);
    for (int e = e0; e < e1; ++e) {
      int s_next = s;
      float ths_next = ths;
      float hn[NK][V];
      if (e + 1 < e1) {  // warp-uniform
        s_next = e_src[e + 1];
        ths_next = ths_g[(size_t)s_next * H];
        load_row<V, NK>(h_src + (size_t)s_next * HDh, lane, HDh, hn);
      }
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) part = fmaf(go[t][v], hv[t][v], part);
        const int grp = lane + 32 * t;
        if (V * grp < HDh) red_w[grp + head[t]] = part;
      }
      __syncwarp();
      if (lane < H) {
        float dp = 0.f;
        for (int n = 0; n < per_head; ++n) dp += run[n];
        const float pre = td + ths + bh;
        const float lg = pre >= 0.f ? pre : slope * pre;
        const float p = expf(lg - ls);
        const float dlg = p * (dp - dl);
        const float dpr = pre >= 0.f ? dlg : slope * dlg;
        dthd += dpr;
        p_e[(size_t)e * H + lane] = p;
        dpre_e[(size_t)e * H + lane] = dpr;
      }
      __syncwarp();  // red is read before the next edge writes it
      s = s_next;
      ths = ths_next;
#pragma unroll
      for (int t = 0; t < NK; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) hv[t][v] = hn[t][v];
    }
  }
  if (lane < H) d_theta_dst[(size_t)k * H + lane] = dthd;
}

template <int V, int NK>
__global__ void __launch_bounds__(kThreads) edge_pass_b(
    const int* __restrict__ src_off,    // [ns_pad*G + 1]
    const int* __restrict__ src_edge,   // [E]  dst-major edge number
    const int* __restrict__ src_row,    // [E]  the edge's unit row u*B + i
    const float* __restrict__ p_e,      // [E, H]
    const float* __restrict__ dpre_e,   // [E, H]
    const float* __restrict__ g_out,    // [U*B, H, Dh]
    float* __restrict__ d_h_src,        // [ns_pad, H, Dh]
    float* __restrict__ d_theta_src,    // [G, ns_pad, H]
    int G, int ns_pad, int H, int Dh) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= ns_pad) return;  // warp-uniform
  const int HDh = H * Dh;
  const int hl = lane < H ? lane : 0;
  int head[NK];
  group_heads<V, NK>(lane, HDh, Dh, head);
  float acc[NK][V];
#pragma unroll
  for (int t = 0; t < NK; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  const int* off = src_off + (size_t)s * G;
  int q = off[0];
  for (int g = 0; g < G; ++g) {
    const int q1 = off[g + 1];
    float dths = 0.f;
    for (; q < q1; ++q) {
      const int e = src_edge[q];
      float go[NK][V];
      load_row<V, NK>(g_out + (size_t)src_row[q] * HDh, lane, HDh, go);
      const float p = p_e[(size_t)e * H + hl];
      dths += dpre_e[(size_t)e * H + hl];
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const float pt = __shfl_sync(kFull, p, head[t]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[t][v] = fmaf(pt, go[t][v], acc[t][v]);
      }
    }
    if (lane < H) d_theta_src[((size_t)g * ns_pad + s) * H + lane] = dths;
  }
  store_row<V, NK>(d_h_src + (size_t)s * HDh, lane, HDh, acc);
}

template <int V, int NK>
int launch(const int* gdst_off, const int* gdst_items, const int* row_off, const int* e_src,
           const int* src_off, const int* src_edge, const int* src_row,
           const float* theta_src, const float* theta_dst, const float* h_src,
           const float* edge_bias, const float* g_out, const float* lse, const float* delta,
           float* p_e, float* dpre_e, float* d_h_src, float* d_theta_src, float* d_theta_dst,
           int G, int B, int ns_pad, int nd_pad, int H, int Dh, float slope,
           cudaStream_t stream) {
  const long long rows_a = (long long)G * nd_pad;
  if (rows_a > 0) {
    edge_pass_a<V, NK><<<(unsigned)((rows_a + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        gdst_off, gdst_items, row_off, e_src, theta_src, theta_dst, h_src, edge_bias, g_out,
        lse, delta, p_e, dpre_e, d_theta_dst, G, B, ns_pad, nd_pad, H, Dh, slope);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (ns_pad > 0) {
    edge_pass_b<V, NK><<<(unsigned)((ns_pad + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        src_off, src_edge, src_row, p_e, dpre_e, g_out, d_h_src, d_theta_src, G, ns_pad, H, Dh);
  }
  return (int)cudaGetLastError();
}

// Pass A of the joint NA (seg_gat_agg_multigraph.cu:
// multigraph_fwd_kernel_joint), one warp per dst row r over its edges
// [row_off[r], row_off[r+1]) in dst-major order, each with its src vertex
// e_src[e] and relation e_rel[e]: pre = theta_dst[r] + theta_src[s] +
// bias[rel], p = exp(LeakyReLU(pre) - lse), dp_h = gs * <g_out, h_src[s]>
// per head (the dot as edge_pass_a sums it), dpre = LeakyReLU'(pre) * p *
// (dp - delta), with gs = 1 - beta where the call has prior layers (the
// softmax part's share of the output) and delta = gs * <g_out, softmax
// part>.  It writes dpre and the edge's coefficient of h_src's gradient,
// p, or with prior layers (1 - beta) p + beta alpha (alpha recomputed as
// the forward does; it carries no gradient: the prior attention is
// detached), and sums dpre into d_theta_dst[r] in edge order.  Pass B is
// edge_pass_b with a "graph" a relation: its src-major CSR has a segment a
// (src vertex, relation), so d_theta_src comes out a relation and the
// caller's sums over it give theta_src's and each relation's bias's
// gradient in a fixed order.
template <int V, int NK, bool kPrior>
__global__ void __launch_bounds__(kThreads) edge_pass_a_joint(
    const int* __restrict__ row_off,      // [rows + 1]
    const int* __restrict__ e_src,        // [E]
    const int* __restrict__ e_rel,        // [E]
    const float* __restrict__ theta_src,  // [ns, H]
    const float* __restrict__ theta_dst,  // [nd, H]
    const float* __restrict__ h_src,      // [ns, H, Dh]
    const float* __restrict__ edge_bias,  // [R, H]
    const Priors pr, float beta,
    const float* __restrict__ g_out,      // [rows, H, Dh]
    const float* __restrict__ lse,        // [rows, H]
    const float* __restrict__ delta,      // [rows, H]
    float* __restrict__ p_e,              // [E, H]
    float* __restrict__ dpre_e,           // [E, H]
    float* __restrict__ d_theta_dst,      // [rows, H]
    int rows, int ns, int nd, int R, int H, int Dh, float slope) {
  __shared__ float red[kWarps][32 * NK + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;  // warp-uniform
  const int HDh = H * Dh;
  const int hl = lane < H ? lane : 0;
  const int per_head = Dh / V;
  int head[NK];
  group_heads<V, NK>(lane, HDh, Dh, head);
  float* red_w = red[warp];
  const float* run = red_w + hl * (per_head + 1);
  const float td = theta_dst[(size_t)r * H + hl];
  const float ls = lse[(size_t)r * H + hl];
  const float dl = delta[(size_t)r * H + hl];
  float tdk[kMaxPriors], lsk[kMaxPriors];
  if constexpr (kPrior) prior_row(pr, (size_t)r, nd, H, hl, tdk, lsk);
  float go[NK][V];
  load_row<V, NK>(g_out + (size_t)r * HDh, lane, HDh, go);

  float dthd = 0.f;
  const int e0 = row_off[r], e1 = row_off[r + 1];
  if (e0 < e1) {  // warp-uniform
    // the next edge's src row is loaded while this edge is reduced
    int s = e_src[e0];
    float hv[NK][V];
    load_row<V, NK>(h_src + (size_t)s * HDh, lane, HDh, hv);
    for (int e = e0; e < e1; ++e) {
      int s_next = s;
      float hn[NK][V];
      if (e + 1 < e1) {  // warp-uniform
        s_next = e_src[e + 1];
        load_row<V, NK>(h_src + (size_t)s_next * HDh, lane, HDh, hn);
      }
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) part = fmaf(go[t][v], hv[t][v], part);
        const int grp = lane + 32 * t;
        if (V * grp < HDh) red_w[grp + head[t]] = part;
      }
      __syncwarp();
      if (lane < H) {
        float dp = 0.f;
        for (int n = 0; n < per_head; ++n) dp += run[n];
        if constexpr (kPrior) dp *= 1.f - beta;
        const int rel = e_rel[e];
        const float pre = td + theta_src[(size_t)s * H + lane] + edge_bias[rel * H + lane];
        const float lg = pre >= 0.f ? pre : slope * pre;
        const float p = expf(lg - ls);
        const float dlg = p * (dp - dl);
        const float dpr = pre >= 0.f ? dlg : slope * dlg;
        dthd += dpr;
        float coeff = p;
        if constexpr (kPrior) {
          const float a = prior_alpha(pr, s, rel, ns, R, H, lane, tdk, lsk, slope);
          coeff = fmaf(1.f - beta, p, beta * a);
        }
        p_e[(size_t)e * H + lane] = coeff;
        dpre_e[(size_t)e * H + lane] = dpr;
      }
      __syncwarp();  // red is read before the next edge writes it
      s = s_next;
#pragma unroll
      for (int t = 0; t < NK; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) hv[t][v] = hn[t][v];
    }
  }
  if (lane < H) d_theta_dst[(size_t)r * H + lane] = dthd;
}

template <int V, int NK, bool kPrior>
int launch_joint(const int* row_off, const int* e_src, const int* e_rel, const int* src_off,
                 const int* src_edge, const int* src_row, const float* theta_src,
                 const float* theta_dst, const float* h_src, const float* edge_bias,
                 const Priors& pr, float beta, const float* g_out, const float* lse,
                 const float* delta, float* p_e, float* dpre_e, float* d_h_src,
                 float* d_theta_src, float* d_theta_dst, int rows, int ns, int nd, int R, int H,
                 int Dh, float slope, cudaStream_t stream) {
  if (rows > 0) {
    edge_pass_a_joint<V, NK, kPrior><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                       stream>>>(
        row_off, e_src, e_rel, theta_src, theta_dst, h_src, edge_bias, pr, beta, g_out, lse,
        delta, p_e, dpre_e, d_theta_dst, rows, ns, nd, R, H, Dh, slope);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (ns > 0) {
    edge_pass_b<V, NK><<<(unsigned)((ns + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        src_off, src_edge, src_row, p_e, dpre_e, g_out, d_h_src, d_theta_src, R, ns, H, Dh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pass A then pass B on `stream`: d_h_src [ns_pad, H, Dh], d_theta_src
// [G, ns_pad, H] and d_theta_dst [G, nd_pad, H], each written whole;
// p_e and dpre_e [E, H] are the passes' scratch.  Rows of H*Dh floats must be
// 16-byte aligned when Dh % 4 == 0 (the wrapper sees to it).
extern "C" int seg_gat_agg_multigraph_bwd(
    const int* gdst_off, const int* gdst_items, const int* row_off, const int* e_src,
    const int* src_off, const int* src_edge, const int* src_row,
    const float* theta_src, const float* theta_dst, const float* h_src,
    const float* edge_bias, const float* g_out, const float* lse, const float* delta,
    float* p_e, float* dpre_e, float* d_h_src, float* d_theta_src, float* d_theta_dst,
    int G, int B, int ns_pad, int nd_pad, int H, int Dh, float slope,
    void* stream) {
  if (B % 8 != 0 || B > kMaxBlock || H < 1 || H > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lane_groups(H, Dh, [&](auto v, auto nk) {
    return launch<decltype(v)::value, decltype(nk)::value>(
        gdst_off, gdst_items, row_off, e_src, src_off, src_edge, src_row, theta_src, theta_dst,
        h_src, edge_bias, g_out, lse, delta, p_e, dpre_e, d_h_src, d_theta_src, d_theta_dst, G,
        B, ns_pad, nd_pad, H, Dh, slope, s);
  });
}

// The joint NA's backward on `stream`: pass A over `rows` dst rows, then
// pass B with a segment a (src vertex, relation): d_h_src [ns, H, Dh],
// d_theta_src [R, ns, H] (a relation's share) and d_theta_dst [rows, H],
// each written whole; p_e and dpre_e [E, H] are the passes' scratch.  With
// K > 0 prior layers (coef on the host) g_out is scaled by 1 - beta in the
// softmax's terms and h_src's gradient takes the prior attention's share.
extern "C" int seg_gat_agg_multigraph_joint_bwd(
    const int* row_off, const int* e_src, const int* e_rel, const int* src_off,
    const int* src_edge, const int* src_row, const float* theta_src, const float* theta_dst,
    const float* h_src, const float* edge_bias, const float* prior_theta_src,
    const float* prior_theta_dst, const float* prior_bias, const float* prior_lse,
    const float* prior_coef, int K, float beta, const float* g_out, const float* lse,
    const float* delta, float* p_e, float* dpre_e, float* d_h_src, float* d_theta_src,
    float* d_theta_dst, int rows, int ns, int nd, int R, int H, int Dh, float slope,
    void* stream) {
  if (H < 1 || H > 32 || K < 0 || K > kMaxPriors) return (int)cudaErrorInvalidValue;
  Priors pr{prior_theta_src, prior_theta_dst, prior_bias, prior_lse, {0.f, 0.f, 0.f, 0.f}, K};
  for (int k = 0; k < K; ++k) pr.coef[k] = prior_coef[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lane_groups(H, Dh, [&](auto v, auto nk) {
    constexpr int kV = decltype(v)::value, kNK = decltype(nk)::value;
    return K > 0
        ? launch_joint<kV, kNK, true>(row_off, e_src, e_rel, src_off, src_edge, src_row,
                                      theta_src, theta_dst, h_src, edge_bias, pr, beta, g_out,
                                      lse, delta, p_e, dpre_e, d_h_src, d_theta_src, d_theta_dst,
                                      rows, ns, nd, R, H, Dh, slope, s)
        : launch_joint<kV, kNK, false>(row_off, e_src, e_rel, src_off, src_edge, src_row,
                                       theta_src, theta_dst, h_src, edge_bias, pr, beta, g_out,
                                       lse, delta, p_e, dpre_e, d_h_src, d_theta_src,
                                       d_theta_dst, rows, ns, nd, R, H, Dh, slope, s);
  });
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
