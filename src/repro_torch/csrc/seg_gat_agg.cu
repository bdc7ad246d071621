// Single-graph block-CSR online-softmax NA forward for Hopper (sm_90a),
// float32: the per-graph KERNEL backend of R-GAT and S-HGN.
//
// Replaces: the Pallas TPU kernel `seg_gat_agg` / `_kernel` of
//   src/repro/kernels/seg_gat_agg.py (grid (H, R, W), one head of one
//   dst-block row per step, online softmax carried in VMEM scratch across
//   the sequential W axis, dense B x B work on every slot; no VJP).
//
// What bounds it on this card: the bytes of the edges.  A relation graph's
//   B x B blocks are sparse (on full IMDB at B = 16, ≈ 2 of a live slot's
//   256 mask entries are set), so the work is one h_src row (H*Dh floats,
//   1 KB at R-GAT's width) and H logits per set entry, plus one B-byte
//   mask row per live (slot, dst row).  The h_src rows are shared by many
//   dst rows and mostly served from L2; the function's bound is its unique
//   bytes.
//
// Design: the edge walk of the multigraph forward #1 at one graph.
//   * One warp per dst row r*B + i, all heads; the lanes own columns of
//     H*Dh, lane h < H head h's softmax statistics m, l (edge_na.cuh).
//     Rows are disjoint: no atomics, and out is written once.  Nothing is
//     sized by B: any B in {8, 16, 32, 64, 128}; H <= 32, H*Dh <= 1024.
//   * The row is edge_na.cuh's aggregate_row, the walk #1 runs per unit
//     row: lanes read 32 slots' mask rows i as bit sets (live slots only:
//     padding slots are skipped whatever their masks hold), a ballot keeps
//     the slots with a set bit, and the warp visits only those set
//     entries, in ascending (w, j), with #1's sums in #1's order.  A row
//     with no live edge gives exact zeros.  #5 == #1 at G = 1 bit for bit
//     by construction (chip_smoke.py checks it).
//   * No shared memory, no barrier, no host-built index.  It keeps no lse:
//     the TPU kernel has no backward.
//   * __launch_bounds__(256, 1): without a minimum of blocks ptxas (CUDA
//     12.9) trades registers for occupancy and spills 16-40 bytes in four
//     of the eight builds, R-GAT's <4, 2> among them (48 registers); with
//     it none spills (<4, 2>: 72 registers) and R-GAT's layer runs no
//     slower (PERF.md §6).  chip_smoke.py fails on a spill here.
#include "edge_na.cuh"

namespace {

using namespace edge_na;

template <int V, int NK>
__global__ void __launch_bounds__(kThreads, 1) seg_gat_agg_kernel(
    const int* __restrict__ col_index,    // [R, W]
    const uint8_t* __restrict__ masks,    // [R, W, B, B]
    const float* __restrict__ theta_src,  // [ns_pad, H]
    const float* __restrict__ theta_dst,  // [R*B, H]
    const float* __restrict__ h_src,      // [ns_pad, H, Dh]
    const float* __restrict__ edge_bias,  // [H]
    float* __restrict__ out,              // [R*B, H, Dh]
    int* __restrict__ visits,             // [1] set entries visited, or null
    int R, int W, int B, int H, int Dh, float slope) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);  // dst row rb*B + i
  if (r >= R * B) return;  // warp-uniform
  const int rb = r / B, i = r % B;
  const int hl = lane < H ? lane : 0;
  aggregate_row<V, NK>(
      col_index + (size_t)rb * W, masks + (size_t)rb * W * B * B + (size_t)i * B, theta_src,
      h_src, theta_dst[(size_t)r * H + hl], edge_bias[hl], out + (size_t)r * H * Dh, nullptr,
      visits, W, B, H, Dh, slope);
}

template <int V, int NK>
int launch(const int* col_index, const uint8_t* masks, const float* theta_src,
           const float* theta_dst, const float* h_src, const float* edge_bias, float* out,
           int* visits, int R, int W, int B, int H, int Dh, float slope, cudaStream_t stream) {
  const long long rows = (long long)R * B;
  if (rows > 0) {
    const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
    seg_gat_agg_kernel<V, NK><<<grid, kThreads, 0, stream>>>(
        col_index, masks, theta_src, theta_dst, h_src, edge_bias, out, visits, R, W, B, H, Dh,
        slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [R*B, H, Dh] on `stream`; `visits` (nullable) gains the number of set
// entries the warps visited.  H*Dh floats a row must be 16-byte aligned when
// Dh % 4 == 0, and each B-byte mask row 8-byte aligned (the wrapper sees to
// it).
extern "C" int seg_gat_agg_fwd(
    const int* col_index, const uint8_t* masks, const float* theta_src,
    const float* theta_dst, const float* h_src, const float* edge_bias, float* out, int* visits,
    int R, int W, int B, int H, int Dh, float slope, void* stream) {
  if (B % 8 != 0 || B > kMaxBlock || H < 1 || H > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lane_groups(H, Dh, [&](auto v, auto nk) {
    return launch<decltype(v)::value, decltype(nk)::value>(
        col_index, masks, theta_src, theta_dst, h_src, edge_bias, out, visits, R, W, B, H, Dh,
        slope, s);
  });
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
