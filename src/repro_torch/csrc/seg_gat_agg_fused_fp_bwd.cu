// Fused FP+NA backward (stage-fusion megakernel) for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` / `_bwd_call` of
//   src/repro/kernels/seg_gat_agg_fused_fp.py (grid (U, W), the projections
//   recomputed per (unit, slot), a dense projection-space partial written
//   for every (unit, slot), padding included), and the segment sums of
//   `_fused_bwd` that scatter those partials per weight table and per graph.
//
// What bounds it on this card: as in the forward (seg_gat_agg_fused_fp.cu),
//   the recomputed projection, 2*B*Din*H*Dh flops for each (table, block) a
//   live unit reads (17.7 Gflop at HAN's full-IMDB shape), beside the NA
//   backward and the partials: one B x H*Dh tile per live slot and per unit
//   (32 KB each at B=16, H*Dh=512), written and reduced, are the largest
//   memory traffic.
//
// Design: on the caller's stream (one call, one counted launch):
//   * Phase P (fused_fp_project.cuh) recomputes h = x W[t] + b[t] once for
//     each listed (table, 128-row tile) into the workspace h [T, n_pad, C],
//     as the forward does (the residuals are out and lse, as in the
//     reference), so no tile is projected per slot.
//   * Pass 1, one thread block per work unit, all heads together.  The
//     unit's dst tile passes through shared memory once for theta_dst (the
//     end of the sweep reads it again from L2 for d_a_dst, so that two B x
//     H*Dh tiles, not three, hold shared memory: two blocks an SM at B=16,
//     H*Dh=512); g_out, lse and delta stay there for the sweep.  Per live
//     slot the src tile is copied in, theta_src taken from it, p and dpre
//     recomputed, and the slot's projection-space gradient dhs = p^T g_out
//     + dths (x) a_src written for that slot only (the host numbers the live
//     slots, `pair_of`).  d_theta_dst and the unit's d_a_src partial
//     accumulate in shared memory; at the end of the sweep the unit writes
//     d_theta_dst, its d_a_src and d_a_dst partials and its rank-1 dst-side
//     gradient dhd = d_theta_dst (x) a_dst, the last into row P + u of the
//     same partial buffer as the slots.  A unit with no live slot reads no
//     tile (its dst tile may not be projected) and writes zeros.
//   * Pass 2, the scatters, as segmented sums in a fixed order over CSRs the
//     host builds: dh_t [T, N_pad, H*Dh] by (weight table, block) over the
//     slots and units together; d_a_src, d_a_dst and the per-unit
//     d_theta_dst by graph over the units.  No atomics, so the gradients are
//     bitwise repeatable for a fixed topology.  The chain through
//     h = x W[t] + b[t] (dW, db, dx) is two plain products left to the
//     caller.
#include "fused_fp_project.cuh"
#include "na_backward.cuh"
#include "online_softmax_na.cuh"

namespace {

using online_softmax_na::kThreads;
using namespace na_backward;
using fused_fp_project::load_tile;
using fused_fp_project::unit_is_live;
using fused_fp_tile::tile_coefficients;

template <int B>
__global__ void __launch_bounds__(kThreads) fused_fp_bwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
    const int* __restrict__ pair_of,      // [U, W]  live-slot number, -1 for padding
    const int* __restrict__ graph_id,     // [U]
    const int* __restrict__ dst_row,      // [U]
    const int* __restrict__ wsel,         // [G]
    const uint8_t* __restrict__ masks,    // [U, W, B, B]
    const float* __restrict__ proj,       // [T, n_pad, H*Dh]  phase P's projection
    const float* __restrict__ a_src,      // [G, H, Dh]
    const float* __restrict__ a_dst,      // [G, H, Dh]
    const float* __restrict__ edge_bias,  // [G, H]
    const float* __restrict__ g_out,      // [U*B, H*Dh]
    const float* __restrict__ lse,        // [U*B, H]
    const float* __restrict__ delta,      // [U*B, H]
    float* __restrict__ dh_part,          // [P + U, B, H*Dh]  slots, then units
    float* __restrict__ dthd_units,       // [U, B*H]
    float* __restrict__ das_units,        // [U, H*Dh]
    float* __restrict__ dad_units,        // [U, H*Dh]
    int W, int P, int n_pad, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* tile_s = smem;                // [B, HDh]  projected dst, then src, tile
  float* gout_s = tile_s + B * HDh;    // [B, HDh]
  float* p_s = gout_s + B * HDh;       // [H, B, B]
  float* dpre_s = p_s + H * B * B;     // [H, B, B]
  float* das_s = dpre_s + H * B * B;   // [HDh]
  float* thd_s = das_s + HDh;          // [B, H]
  float* ths_s = thd_s + B * H;        // [B, H]
  float* lse_s = ths_s + B * H;        // [B, H]
  float* delta_s = lse_s + B * H;      // [B, H]
  float* dthd_s = delta_s + B * H;     // [B, H]
  float* dths_s = dthd_s + B * H;      // [B, H]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(dths_s + B * H);  // [B, B]

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = graph_id[u];
  const float* ht = proj + (size_t)wsel[g] * n_pad * HDh;
  const float* hd_g = ht + (size_t)dst_row[u] * B * HDh;  // the dst tile, projected
  const float* as_g = a_src + (size_t)g * HDh;
  const float* ad_g = a_dst + (size_t)g * HDh;
  const float* bias = edge_bias + g * H;

  for (int k = tid; k < B * HDh; k += kThreads) gout_s[k] = g_out[(size_t)u * B * HDh + k];
  for (int k = tid; k < HDh; k += kThreads) das_s[k] = 0.f;
  for (int k = tid; k < B * H; k += kThreads) {
    lse_s[k] = lse[(size_t)u * B * H + k];
    delta_s[k] = delta[(size_t)u * B * H + k];
    dthd_s[k] = 0.f;
  }
  // A unit with no live slot reads no tile: its dst tile may not be projected
  const bool live = unit_is_live(col_index, u, W);
  if (live) {  // theta_dst, once
    load_tile<B>(hd_g, HDh, tile_s);
    __syncthreads();
    tile_coefficients<B>(tile_s, ad_g, H, Dh, thd_s);
  }
  __syncthreads();

  for (int w_ = 0; w_ < W; ++w_) {
    const int c = col_index[(size_t)u * W + w_];
    if (c < 0) continue;  // padding slot: no partial, contributes nothing
    const size_t pr = (size_t)pair_of[(size_t)u * W + w_];
    const uint8_t* mk = masks + ((size_t)u * W + w_) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    load_tile<B>(ht + (size_t)c * B * HDh, HDh, tile_s);
    __syncthreads();
    tile_coefficients<B>(tile_s, as_g, H, Dh, ths_s);
    __syncthreads();
    slot_backward<B>(thd_s, ths_s, lse_s, delta_s, mask_s, bias, H, Dh, slope,
                     gout_s, tile_s, p_s, dpre_s, dthd_s, dths_s);
    slot_src_grad<B>(p_s, dths_s, gout_s, tile_s, as_g, H, Dh,
                     dh_part + pr * B * HDh, das_s);
    __syncthreads();  // the slot's scratch is consumed before the next is staged
  }

  float* dhd = dh_part + ((size_t)P + u) * B * HDh;
  for (int k = tid; k < B * H; k += kThreads) dthd_units[(size_t)u * B * H + k] = dthd_s[k];
  for (int c = tid; c < HDh; c += kThreads) {
    const int h = c / Dh;
    const float ac = ad_g[c];
    float dad = 0.f;
    for (int i = 0; i < B; ++i) {
      const float di = dthd_s[i * H + h];
      if (live) dad = fmaf(di, hd_g[(size_t)i * HDh + c], dad);
      dhd[(size_t)i * HDh + c] = di * ac;  // theta_dst = hd . a_dst: rank 1
    }
    das_units[(size_t)u * HDh + c] = das_s[c];
    dad_units[(size_t)u * HDh + c] = dad;
  }
}

template <int B>
int launch(const int* col_index, const int* pair_of, const int* graph_id, const int* dst_row,
           const int* wsel, const uint8_t* masks, const float* x, const float* w,
           const float* b, const float* a_src, const float* a_dst, const float* edge_bias,
           const float* g_out, const float* lse, const float* delta, const int* tiles, float* h,
           float* wt, float* partial, float* chains, int* tickets, float* dh_part,
           float* dthd_units, float* das_units, float* dad_units, int U, int W, int P, int T,
           int n_pad, int Din, int H, int Dh, int L, int row_tiles, int route, int splits,
           float slope, cudaStream_t stream) {
  int err = fused_fp_project::project<B>(route, x, w, b, tiles, L, row_tiles, h, wt, partial,
                                         chains, tickets, T, n_pad, Din, H * Dh, splits, stream);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * (2 * (size_t)B * H * Dh + 2 * (size_t)H * B * B +
                                       (size_t)H * Dh + 6 * (size_t)B * H) +
                      B * B;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_fp_bwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (U > 0) {
    fused_fp_bwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, pair_of, graph_id, dst_row, wsel, masks, h, a_src, a_dst, edge_bias, g_out,
        lse, delta, dh_part, dthd_units, das_units, dad_units, W, P, n_pad, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Phase P, pass 1 and the four reductions of pass 2, all on `stream`
// (tiles, h and phase P's scratch as in seg_gat_agg_fused_fp_fwd):
//   dh_t   [T*n_pad/B, B*H*Dh] from dh_part    over (tab_off, tab_items)
//   d_a_src [G, H*Dh]          from das_units  over (graph_off, graph_items)
//   d_a_dst [G, H*Dh]          from dad_units  over (graph_off, graph_items)
//   dthd_g  [G, B*H]           from dthd_units over (graph_off, graph_items)
extern "C" int seg_gat_agg_fused_fp_bwd(
    const int* col_index, const int* pair_of, const int* graph_id, const int* dst_row,
    const int* wsel, const uint8_t* masks, const float* x, const float* w, const float* b,
    const float* a_src, const float* a_dst, const float* edge_bias,
    const float* g_out, const float* lse, const float* delta, const int* tiles, float* h,
    float* wt, float* partial, float* chains, int* tickets,
    float* dh_part, float* dthd_units, float* das_units, float* dad_units,
    const int* tab_off, const int* tab_items, const int* graph_off, const int* graph_items,
    float* dh_t, float* d_a_src, float* d_a_dst, float* dthd_g,
    int U, int W, int P, int B, int G, int T, int n_pad, int Din, int H, int Dh, int L,
    int row_tiles, int route, int splits, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (B) {
    case 8:
      err = launch<8>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                      edge_bias, g_out, lse, delta, tiles, h, wt, partial, chains, tickets,
                      dh_part, dthd_units, das_units, dad_units, U, W, P, T, n_pad, Din, H, Dh, L,
                      row_tiles, route, splits, slope, s);
      break;
    case 16:
      err = launch<16>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                       edge_bias, g_out, lse, delta, tiles, h, wt, partial, chains, tickets,
                       dh_part, dthd_units, das_units, dad_units, U, W, P, T, n_pad, Din, H, Dh,
                       L, row_tiles, route, splits, slope, s);
      break;
    case 32:
      err = launch<32>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                       edge_bias, g_out, lse, delta, tiles, h, wt, partial, chains, tickets,
                       dh_part, dthd_units, das_units, dad_units, U, W, P, T, n_pad, Din, H, Dh,
                       L, row_tiles, route, splits, slope, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int HDh = H * Dh;
  err = segment_sum(dh_part, tab_off, tab_items, dh_t, T * (n_pad / B), B * HDh, s);
  if (err != 0) return err;
  err = segment_sum(das_units, graph_off, graph_items, d_a_src, G, HDh, s);
  if (err != 0) return err;
  err = segment_sum(dad_units, graph_off, graph_items, d_a_dst, G, HDh, s);
  if (err != 0) return err;
  return segment_sum(dthd_units, graph_off, graph_items, dthd_g, G, B * H, s);
}

extern "C" const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }
