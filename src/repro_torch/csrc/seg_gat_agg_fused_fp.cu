// Fused FP+NA forward (stage-fusion megakernel) for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `_fwd_call` of
//   src/repro/kernels/seg_gat_agg_fused_fp.py (grid (U, W); the whole
//   (Din, H*Dh) weight table rides in VMEM as one block; the dst tile of a
//   unit and the src tile of every (unit, slot) are projected where they
//   are used).
//
// Computes what `_fwd_call` computes, not its block structure: per work
//   unit the online-softmax GAT aggregate of its src tiles h = x W[t] + b[t]
//   (t = wsel[graph]) with theta = <h, a> taken from the float32 h, and lse.
//
// What bounds it on this card: the projection.  The function needs each
//   (weight table, block) that a live unit reads projected once, 2*B*Din*C
//   flops a block (57 Mflop at B=16, Din=3489, C=H*Dh=512: 17.7 Gflop for
//   HAN's 309 blocks of full IMDB); the NA is the multigraph kernel's work.
//   The TPU kernel projects a src tile again for every live slot (~240
//   slots read each block at that shape): on the TPU that kept h in VMEM.
//   Here that order costs ~4.3 Tflop, so this design projects once:
//
// Design: two kernels of this library, back to back on the caller's stream
//   (one call, one counted launch):
//   * Phase P (fused_fp_project.cuh): every listed (table, 128-row tile) is
//     projected once into a workspace h [T, n_pad, C] in device memory, on
//     the tensor cores by split TF32 (kernel #6's product) or, for widths
//     that route cannot take, on the CUDA cores.  The list (from the
//     topology, by the host) holds exactly the tiles live units read.
//     Projected features go to device memory, where the TPU kernel keeps
//     them in VMEM: a src tile is read by ~240 units spread over all SMs,
//     and shared memory is private to a block; h (10.1 MB at the shape
//     above) is written once and read from the 50 MB L2.
//   * Phase A, one thread block per work unit, all heads together; units
//     are disjoint in their output rows, so there are no atomics and the
//     output is deterministic.  The TPU grid's sequential W axis is a loop
//     inside the block; padding slots (col < 0) are skipped, which computes
//     exactly what the TPU kernel does with them.  The unit's dst tile is
//     copied from h once (cp.async) and theta_dst kept in shared memory;
//     per live slot the src tile is copied in, theta_src taken from it, then
//     the online-softmax step of online_softmax_na.cuh runs on it.  A unit
//     with no live slot reads nothing (its tiles may not be projected) and
//     finishes at zero.
//   * Shared memory of phase A: acc and the tile (B*C floats each), the
//     probabilities (H*B*B) and the per-row state; 73 KB at B=16, C=512.
#include "fused_fp_project.cuh"
#include "online_softmax_na.cuh"

namespace {

using namespace online_softmax_na;
using fused_fp_project::load_tile;
using fused_fp_project::unit_is_live;
using fused_fp_tile::tile_coefficients;

template <int B>
__global__ void __launch_bounds__(kThreads) fused_fp_fwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
    const int* __restrict__ graph_id,     // [U]
    const int* __restrict__ dst_row,      // [U]
    const int* __restrict__ wsel,         // [G]
    const uint8_t* __restrict__ masks,    // [U, W, B, B]
    const float* __restrict__ proj,       // [T, n_pad, H*Dh]  phase P's projection
    const float* __restrict__ a_src,      // [G, H, Dh]
    const float* __restrict__ a_dst,      // [G, H, Dh]
    const float* __restrict__ edge_bias,  // [G, H]
    float* __restrict__ out,              // [U*B, H*Dh]
    float* __restrict__ lse,              // [U*B, H]
    int W, int n_pad, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* acc = smem;                  // [B, HDh]
  float* tile = acc + B * HDh;        // [B, HDh] projected dst, then src, tile
  float* p_s = tile + B * HDh;        // [H, B(dst), B(src)]
  float* thd_s = p_s + H * B * B;     // [B, H]
  float* ths_s = thd_s + B * H;       // [B, H]
  float* m_s = ths_s + B * H;         // [B, H]
  float* l_s = m_s + B * H;           // [B, H]
  float* scale_s = l_s + B * H;       // [H, B]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(scale_s + B * H);  // [B, B]

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = graph_id[u];
  const float* ht = proj + (size_t)wsel[g] * n_pad * HDh;

  for (int k = tid; k < B * HDh; k += kThreads) acc[k] = 0.f;
  for (int k = tid; k < B * H; k += kThreads) {
    m_s[k] = kNegInf;
    l_s[k] = 0.f;
  }
  if (unit_is_live(col_index, u, W)) {  // the dst tile, once; theta_dst stays on chip
    load_tile<B>(ht + (size_t)dst_row[u] * B * HDh, HDh, tile);
    __syncthreads();
    tile_coefficients<B>(tile, a_dst + (size_t)g * HDh, H, Dh, thd_s);
  }
  __syncthreads();

  for (int w_ = 0; w_ < W; ++w_) {
    const int c = col_index[(size_t)u * W + w_];
    if (c < 0) continue;  // padding slot: contributes exact zeros
    const uint8_t* mk = masks + ((size_t)u * W + w_) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    load_tile<B>(ht + (size_t)c * B * HDh, HDh, tile);
    __syncthreads();
    tile_coefficients<B>(tile, a_src + (size_t)g * HDh, H, Dh, ths_s);
    __syncthreads();
    softmax_update<B>(thd_s, ths_s, mask_s, edge_bias + g * H, H, slope, m_s, l_s, p_s, scale_s);
    __syncthreads();
    accumulate<B>(tile, HDh, Dh, p_s, scale_s, acc);
    __syncthreads();
  }
  finalize<B>(acc, m_s, l_s, H, Dh, out + (size_t)u * B * HDh, lse + (size_t)u * B * H);
}

template <int B>
int launch(const int* col_index, const int* graph_id, const int* dst_row, const int* wsel,
           const uint8_t* masks, const float* x, const float* w, const float* b,
           const float* a_src, const float* a_dst, const float* edge_bias, const int* tiles,
           float* h, float* wt, float* partial, float* chains, int* tickets, float* out,
           float* lse, int U, int W, int T, int n_pad, int Din, int H, int Dh, int L,
           int row_tiles, int route, int splits, float slope, cudaStream_t stream) {
  int err = fused_fp_project::project<B>(route, x, w, b, tiles, L, row_tiles, h, wt, partial,
                                         chains, tickets, T, n_pad, Din, H * Dh, splits, stream);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * (2 * (size_t)B * H * Dh + (size_t)H * B * B + 5 * B * H) +
                      B * B;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_fp_fwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (U > 0) {
    fused_fp_fwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, graph_id, dst_row, wsel, masks, h, a_src, a_dst, edge_bias, out, lse, W, n_pad,
        H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Phase P, then phase A, on `stream`.  tiles [L]: the listed row tiles, t *
// row_tiles + r (row_tiles = ceil(n_pad / 128)); h: T * n_pad * H * Dh
// floats of workspace; wt, partial, chains, tickets: phase P's scratch
// (fused_fp_project.cuh: project).  route: 0 tensor cores, 1 CUDA cores.
extern "C" int seg_gat_agg_fused_fp_fwd(
    const int* col_index, const int* graph_id, const int* dst_row, const int* wsel,
    const uint8_t* masks, const float* x, const float* w, const float* b,
    const float* a_src, const float* a_dst, const float* edge_bias, const int* tiles,
    float* h, float* wt, float* partial, float* chains, int* tickets, float* out, float* lse,
    int U, int W, int B, int T, int n_pad, int Din, int H, int Dh, int L, int row_tiles,
    int route, int splits, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 8:
      return launch<8>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
                       tiles, h, wt, partial, chains, tickets, out, lse, U, W, T, n_pad, Din, H,
                       Dh, L, row_tiles, route, splits, slope, s);
    case 16:
      return launch<16>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                        edge_bias, tiles, h, wt, partial, chains, tickets, out, lse, U, W, T,
                        n_pad, Din, H, Dh, L, row_tiles, route, splits, slope, s);
    case 32:
      return launch<32>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                        edge_bias, tiles, h, wt, partial, chains, tickets, out, lse, U, W, T,
                        n_pad, Din, H, Dh, L, row_tiles, route, splits, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }
