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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
