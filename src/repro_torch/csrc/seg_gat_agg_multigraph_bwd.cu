// Multi-graph NA backward for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` / `_bwd_call` of
//   src/repro/kernels/seg_gat_agg_multigraph.py (grid (H, U, W), d_theta_dst
//   carried in VMEM scratch across the sequential W axis, a dense partial
//   written for every (unit, slot), padding included), and the segment sums
//   of `_multigraph_bwd` that scatter those partials.
//
// What bounds it on this card: arithmetic.  Each live (unit, slot) and head
//   recomputes p from lse (B*B exps) and does two B x B x Dh products
//   (dp = g_out . h_src^T and p^T . g_out), about 4*B*B*Dh + 10*B*B flops,
//   in float32 on the CUDA cores.  The partials it writes (one B x H*Dh
//   tile per live slot, 32 KB at B=16, H*Dh=512) and the reduction that
//   reads them back are the largest memory traffic.
//
// Design:
//   * Pass 1, one thread block per work unit, all heads together (as the
//     forward): the W axis is a loop inside the block, padding slots are
//     skipped.  The unit's g_out, theta_dst, lse and delta stay in shared
//     memory for the sweep; d_theta_dst is accumulated there and written
//     once per unit.  Per live slot the block stages the mask, theta_src and
//     the h_src tile, recomputes p and dpre (na_backward.cuh) and writes
//     d_theta_src [B, H] and d_h_src [B, H*Dh] partials for that slot only:
//     the host numbers the live slots (`pair_of`), so padding costs no
//     memory (the dense layout of the TPU kernel would be 9.2 GB at the
//     training shape, the live one 2.4 GB).
//   * Pass 2, the scatters, as segmented sums in a fixed order over CSRs
//     the host builds by (key, unit, slot): d_h_src by src block (shared by
//     every graph), d_theta_src by (graph, src block), d_theta_dst by
//     (graph, dst block) over the units.  No atomics anywhere, so the
//     gradients are bitwise repeatable for a fixed topology.
//   * No wgmma, TMA or pipelining yet: simple and right first.
#include "na_backward.cuh"
#include "online_softmax_na.cuh"

namespace {

using online_softmax_na::kThreads;
using namespace na_backward;

template <int B>
__global__ void __launch_bounds__(kThreads) multigraph_bwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
    const int* __restrict__ pair_of,      // [U, W]  live-slot number, -1 for padding
    const int* __restrict__ graph_id,     // [U]
    const int* __restrict__ dst_row,      // [U]
    const uint8_t* __restrict__ masks,    // [U, W, B, B]
    const float* __restrict__ theta_src,  // [G, ns_pad, H]
    const float* __restrict__ theta_dst,  // [G, nd_pad, H]
    const float* __restrict__ h_src,      // [ns_pad, H, Dh]
    const float* __restrict__ edge_bias,  // [G, H]
    const float* __restrict__ g_out,      // [U*B, H, Dh]
    const float* __restrict__ lse,        // [U*B, H]
    const float* __restrict__ delta,      // [U*B, H]
    float* __restrict__ dths_part,        // [P, B, H]
    float* __restrict__ dhs_part,         // [P, B, H*Dh]
    float* __restrict__ dthd_units,       // [U*B, H]
    int W, int ns_pad, int nd_pad, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* gout_s = smem;                // [B, HDh]
  float* src_s = gout_s + B * HDh;     // [B, HDh]
  float* p_s = src_s + B * HDh;        // [H, B, B]
  float* dpre_s = p_s + H * B * B;     // [H, B, B]
  float* thd_s = dpre_s + H * B * B;   // [B, H]
  float* ths_s = thd_s + B * H;        // [B, H]
  float* lse_s = ths_s + B * H;        // [B, H]
  float* delta_s = lse_s + B * H;      // [B, H]
  float* dthd_s = delta_s + B * H;     // [B, H]
  float* dths_s = dthd_s + B * H;      // [B, H]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(dths_s + B * H);  // [B, B]

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = graph_id[u];
  const float* ths_g = theta_src + (size_t)g * ns_pad * H;
  const float* thd_u = theta_dst + ((size_t)g * nd_pad + (size_t)dst_row[u] * B) * H;
  const float* bias = edge_bias + g * H;

  for (int k = tid; k < B * HDh; k += kThreads) gout_s[k] = g_out[(size_t)u * B * HDh + k];
  for (int k = tid; k < B * H; k += kThreads) {
    thd_s[k] = thd_u[k];
    lse_s[k] = lse[(size_t)u * B * H + k];
    delta_s[k] = delta[(size_t)u * B * H + k];
    dthd_s[k] = 0.f;
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int c = col_index[(size_t)u * W + w];
    if (c < 0) continue;  // padding slot: no partial, contributes nothing
    const size_t pr = (size_t)pair_of[(size_t)u * W + w];
    const uint8_t* mk = masks + ((size_t)u * W + w) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    for (int k = tid; k < B * H; k += kThreads) ths_s[k] = ths_g[(size_t)c * B * H + k];
    const float* hs = h_src + (size_t)c * B * HDh;
    for (int k = tid; k < B * HDh; k += kThreads) src_s[k] = hs[k];
    __syncthreads();
    slot_backward<B>(thd_s, ths_s, lse_s, delta_s, mask_s, bias, H, Dh, slope,
                     gout_s, src_s, p_s, dpre_s, dthd_s, dths_s);
    for (int k = tid; k < B * H; k += kThreads) dths_part[pr * B * H + k] = dths_s[k];
    slot_src_grad<B>(p_s, dths_s, gout_s, src_s, nullptr, H, Dh,
                     dhs_part + pr * B * HDh, nullptr);
    __syncthreads();  // the slot's scratch is consumed before the next is staged
  }
  for (int k = tid; k < B * H; k += kThreads) dthd_units[(size_t)u * B * H + k] = dthd_s[k];
}

template <int B>
int launch(const int* col_index, const int* pair_of, const int* graph_id, const int* dst_row,
           const uint8_t* masks, const float* theta_src, const float* theta_dst,
           const float* h_src, const float* edge_bias, const float* g_out, const float* lse,
           const float* delta, float* dths_part, float* dhs_part, float* dthd_units,
           int U, int W, int ns_pad, int nd_pad, int H, int Dh, float slope,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)B * H * Dh + 2 * (size_t)H * B * B +
                                       6 * (size_t)B * H) + B * B;
  cudaError_t err = cudaFuncSetAttribute(
      multigraph_bwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (U > 0) {
    multigraph_bwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, pair_of, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
        g_out, lse, delta, dths_part, dhs_part, dthd_units, W, ns_pad, nd_pad, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 and the three reductions of pass 2, all on `stream`:
//   d_h_src     [ns_pad/B, B*H*Dh]  from dhs_part   over (src_off, src_items)
//   d_theta_src [G*ns_pad/B, B*H]   from dths_part  over (gsrc_off, gsrc_items)
//   d_theta_dst [G*nd_pad/B, B*H]   from dthd_units over (gdst_off, gdst_items)
extern "C" int seg_gat_agg_multigraph_bwd(
    const int* col_index, const int* pair_of, const int* graph_id, const int* dst_row,
    const uint8_t* masks, const float* theta_src, const float* theta_dst, const float* h_src,
    const float* edge_bias, const float* g_out, const float* lse, const float* delta,
    float* dths_part, float* dhs_part, float* dthd_units,
    const int* src_off, const int* src_items, const int* gsrc_off, const int* gsrc_items,
    const int* gdst_off, const int* gdst_items,
    float* d_h_src, float* d_theta_src, float* d_theta_dst,
    int U, int W, int B, int G, int ns_pad, int nd_pad, int H, int Dh, float slope,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (B) {
    case 8:
      err = launch<8>(col_index, pair_of, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                      edge_bias, g_out, lse, delta, dths_part, dhs_part, dthd_units,
                      U, W, ns_pad, nd_pad, H, Dh, slope, s);
      break;
    case 16:
      err = launch<16>(col_index, pair_of, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                       edge_bias, g_out, lse, delta, dths_part, dhs_part, dthd_units,
                       U, W, ns_pad, nd_pad, H, Dh, slope, s);
      break;
    case 32:
      err = launch<32>(col_index, pair_of, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                       edge_bias, g_out, lse, delta, dths_part, dhs_part, dthd_units,
                       U, W, ns_pad, nd_pad, H, Dh, slope, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int nblk_s = ns_pad / B, nblk_d = nd_pad / B;
  err = segment_sum(dhs_part, src_off, src_items, d_h_src, nblk_s, B * H * Dh, s);
  if (err != 0) return err;
  err = segment_sum(dths_part, gsrc_off, gsrc_items, d_theta_src, G * nblk_s, B * H, s);
  if (err != 0) return err;
  return segment_sum(dthd_units, gdst_off, gdst_items, d_theta_dst, G * nblk_d, B * H, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
