// Fused FP+NA backward (stage-fusion megakernel) for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` / `_bwd_call` of
//   src/repro/kernels/seg_gat_agg_fused_fp.py (grid (U, W), the projections
//   recomputed, a dense projection-space partial written for every
//   (unit, slot), padding included), and the segment sums of `_fused_bwd`
//   that scatter those partials per weight table and per graph.
//
// What bounds it on this card: arithmetic in the recomputed projection, as
//   in the forward (seg_gat_agg_fused_fp.cu): every live (unit, slot)
//   re-projects its raw B x Din src tile, 2*B*Din*H*Dh flops (57 Mflop at
//   B=16, Din=3489, H*Dh=512), and every unit its dst tile.  The NA
//   backward of a slot (na_backward.cuh) is Din/B = 218x smaller.  The
//   partials (one B x H*Dh tile per live slot and per unit, 32 KB each at
//   that shape) and their reduction are the largest memory traffic.
//
// Design:
//   * Pass 1, one thread block per work unit, all heads together.  The
//     unit's dst tile is projected once (fused_fp_tile.cuh) and kept in
//     shared memory with theta_dst; g_out, lse and delta stay there for the
//     sweep.  Per live slot the src tile is projected on chip, theta_src
//     taken from it, p and dpre recomputed, and the slot's projection-space
//     gradient dhs = p^T g_out + dths (x) a_src written for that slot only
//     (the host numbers the live slots, `pair_of`).  d_theta_dst and the
//     unit's d_a_src partial accumulate in shared memory; at the end of the
//     sweep the unit writes d_theta_dst, its d_a_src and d_a_dst partials
//     and its rank-1 dst-side gradient dhd = d_theta_dst (x) a_dst, the last
//     into row P + u of the same partial buffer as the slots.
//   * Pass 2, the scatters, as segmented sums in a fixed order over CSRs the
//     host builds: dh_t [T, N_pad, H*Dh] by (weight table, block) over the
//     slots and units together; d_a_src, d_a_dst and the per-unit
//     d_theta_dst by graph over the units.  No atomics, so the gradients are
//     bitwise repeatable for a fixed topology.  The chain through
//     h = x W[t] + b[t] (dW, db, dx) is two plain products left to the
//     caller.
//   * No wgmma, TMA or pipelining yet: simple and right first.
#include "fused_fp_tile.cuh"
#include "na_backward.cuh"
#include "online_softmax_na.cuh"

namespace {

using online_softmax_na::kThreads;
using namespace fused_fp_tile;
using namespace na_backward;

template <int B>
__global__ void __launch_bounds__(kThreads) fused_fp_bwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
    const int* __restrict__ pair_of,      // [U, W]  live-slot number, -1 for padding
    const int* __restrict__ graph_id,     // [U]
    const int* __restrict__ dst_row,      // [U]
    const int* __restrict__ wsel,         // [G]
    const uint8_t* __restrict__ masks,    // [U, W, B, B]
    const float* __restrict__ x,          // [n_pad, Din]
    const float* __restrict__ w,          // [T, Din, H*Dh]
    const float* __restrict__ b,          // [T, H*Dh]
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
    int W, int P, int Din, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* hd_s = smem;                  // [B, HDh]  projected dst tile
  float* tile_s = hd_s + B * HDh;      // [B, HDh]  projected src tile of the slot
  float* gout_s = tile_s + B * HDh;    // [B, HDh]
  float* p_s = gout_s + B * HDh;       // [H, B, B]
  float* dpre_s = p_s + H * B * B;     // [H, B, B]
  float* xs = dpre_s + H * B * B;      // [kTile, B]
  float* das_s = xs + kTile * B;       // [HDh]
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
  const int t = wsel[g];
  const float* Wt = w + (size_t)t * Din * HDh;
  const float* bt = b + (size_t)t * HDh;
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
  // FP of the unit's dst tile, once; kept for d_a_dst
  project_tile<B>(x, (size_t)dst_row[u] * B, Din, Wt, bt, HDh, xs, hd_s);
  tile_coefficients<B>(hd_s, ad_g, H, Dh, thd_s);
  __syncthreads();

  for (int w_ = 0; w_ < W; ++w_) {
    const int c = col_index[(size_t)u * W + w_];
    if (c < 0) continue;  // padding slot: no partial, contributes nothing
    const size_t pr = (size_t)pair_of[(size_t)u * W + w_];
    const uint8_t* mk = masks + ((size_t)u * W + w_) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    // recompute the FP of the src tile on chip, then its coefficients
    project_tile<B>(x, (size_t)c * B, Din, Wt, bt, HDh, xs, tile_s);
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
      dad = fmaf(di, hd_s[i * HDh + c], dad);
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
           const float* g_out, const float* lse, const float* delta, float* dh_part,
           float* dthd_units, float* das_units, float* dad_units,
           int U, int W, int P, int Din, int H, int Dh, float slope, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)B * H * Dh + 2 * (size_t)H * B * B +
                                       (size_t)kTile * B + (size_t)H * Dh + 6 * (size_t)B * H) +
                      B * B;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fp_bwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (U > 0) {
    fused_fp_bwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
        g_out, lse, delta, dh_part, dthd_units, das_units, dad_units, W, P, Din, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 and the four reductions of pass 2, all on `stream`:
//   dh_t   [T*n_pad/B, B*H*Dh] from dh_part    over (tab_off, tab_items)
//   d_a_src [G, H*Dh]          from das_units  over (graph_off, graph_items)
//   d_a_dst [G, H*Dh]          from dad_units  over (graph_off, graph_items)
//   dthd_g  [G, B*H]           from dthd_units over (graph_off, graph_items)
extern "C" int seg_gat_agg_fused_fp_bwd(
    const int* col_index, const int* pair_of, const int* graph_id, const int* dst_row,
    const int* wsel, const uint8_t* masks, const float* x, const float* w, const float* b,
    const float* a_src, const float* a_dst, const float* edge_bias,
    const float* g_out, const float* lse, const float* delta,
    float* dh_part, float* dthd_units, float* das_units, float* dad_units,
    const int* tab_off, const int* tab_items, const int* graph_off, const int* graph_items,
    float* dh_t, float* d_a_src, float* d_a_dst, float* dthd_g,
    int U, int W, int P, int B, int G, int T, int n_pad, int Din, int H, int Dh, float slope,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (B) {
    case 8:
      err = launch<8>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                      edge_bias, g_out, lse, delta, dh_part, dthd_units, das_units, dad_units,
                      U, W, P, Din, H, Dh, slope, s);
      break;
    case 16:
      err = launch<16>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                       edge_bias, g_out, lse, delta, dh_part, dthd_units, das_units, dad_units,
                       U, W, P, Din, H, Dh, slope, s);
      break;
    case 32:
      err = launch<32>(col_index, pair_of, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                       edge_bias, g_out, lse, delta, dh_part, dthd_units, das_units, dad_units,
                       U, W, P, Din, H, Dh, slope, s);
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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
