// Fused FP+NA forward (stage-fusion megakernel) for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `_fwd_call` of
//   src/repro/kernels/seg_gat_agg_fused_fp.py (grid (U, W); the whole
//   (Din, H*Dh) weight table rides in VMEM as one block).
//
// What bounds it on this card: arithmetic in the projection.  Every live
//   (unit, slot) projects a raw B x Din tile through a Din x (H*Dh) table,
//   2*B*Din*H*Dh flops (57 Mflop at B=16, Din=3489, H*Dh=512), in float32
//   on the CUDA cores (no TF32: the port is held to float32 tolerances).
//   The NA part of a slot is the multigraph kernel's, Din/B = 218x
//   smaller at that shape.  The weight table (7.1 MB at that shape) is
//   re-read for every slot; it fits in the 50 MB L2, so those reads are L2
//   traffic, 8 flops per byte read at B=16.
//
// Design:
//   * The table does not fit in shared memory (227 KB a block, against
//     7.1 MB), so the projection is K-tiled (fused_fp_tile.cuh).
//   * One thread block per work unit, all heads together; units are
//     disjoint in their output rows, so there are no atomics and the
//     output is deterministic.  The TPU grid's sequential W axis is a loop
//     inside the block; padding slots (col < 0) are skipped, which computes
//     exactly what the TPU kernel does with them.
//   * The unit's dst tile is projected once, theta_dst kept in shared
//     memory.  Each live slot's projected src tile (B x H*Dh) stays in
//     shared memory: theta_src is taken from it, then the online-softmax
//     step of online_softmax_na.cuh runs on it.  Projected features never
//     go to device memory.
//   * Shared memory: acc and the projected tile (B*H*Dh floats each), the
//     probabilities (H*B*B), the x tile (kTile*B) and the per-row state;
//     78 KB at B=16, H*Dh=512, above the 48 KB default, so the launcher
//     raises the dynamic shared-memory limit of the kernel first.
//   * No wgmma, TMA or pipelining yet: simple and right first.
#include "fused_fp_tile.cuh"
#include "online_softmax_na.cuh"

namespace {

using namespace online_softmax_na;
using namespace fused_fp_tile;

template <int B>
__global__ void __launch_bounds__(kThreads) fused_fp_fwd_kernel(
    const int* __restrict__ col_index,    // [U, W]
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
    float* __restrict__ out,              // [U*B, H*Dh]
    float* __restrict__ lse,              // [U*B, H]
    int W, int Din, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* acc = smem;                  // [B, HDh]
  float* tile = acc + B * HDh;        // [B, HDh] projected dst, then src, tile
  float* p_s = tile + B * HDh;        // [H, B(dst), B(src)]
  float* xs = p_s + H * B * B;        // [kTile, B]
  float* thd_s = xs + kTile * B;      // [B, H]
  float* ths_s = thd_s + B * H;       // [B, H]
  float* m_s = ths_s + B * H;         // [B, H]
  float* l_s = m_s + B * H;           // [B, H]
  float* scale_s = l_s + B * H;       // [H, B]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(scale_s + B * H);  // [B, B]

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = graph_id[u];
  const int t = wsel[g];
  const float* Wt = w + (size_t)t * Din * HDh;
  const float* bt = b + (size_t)t * HDh;

  for (int k = tid; k < B * HDh; k += kThreads) acc[k] = 0.f;
  for (int k = tid; k < B * H; k += kThreads) {
    m_s[k] = kNegInf;
    l_s[k] = 0.f;
  }
  // FP of the unit's dst tile, once; theta_dst stays on chip for the sweep
  project_tile<B>(x, (size_t)dst_row[u] * B, Din, Wt, bt, HDh, xs, tile);
  tile_coefficients<B>(tile, a_dst + (size_t)g * HDh, H, Dh, thd_s);
  __syncthreads();

  for (int w_ = 0; w_ < W; ++w_) {
    const int c = col_index[(size_t)u * W + w_];
    if (c < 0) continue;  // padding slot: contributes exact zeros
    const uint8_t* mk = masks + ((size_t)u * W + w_) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    // FP of the src tile, on chip, then its coefficients
    project_tile<B>(x, (size_t)c * B, Din, Wt, bt, HDh, xs, tile);
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
           const float* a_src, const float* a_dst, const float* edge_bias,
           float* out, float* lse, int U, int W, int Din, int H, int Dh, float slope,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)B * H * Dh + (size_t)H * B * B +
                                       (size_t)kTile * B + 5 * B * H) + B * B;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fp_fwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (U > 0) {
    fused_fp_fwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
        out, lse, W, Din, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_gat_agg_fused_fp_fwd(
    const int* col_index, const int* graph_id, const int* dst_row, const int* wsel,
    const uint8_t* masks, const float* x, const float* w, const float* b,
    const float* a_src, const float* a_dst, const float* edge_bias,
    float* out, float* lse,
    int U, int W, int B, int Din, int H, int Dh, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 8:
      return launch<8>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                       edge_bias, out, lse, U, W, Din, H, Dh, slope, s);
    case 16:
      return launch<16>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                        edge_bias, out, lse, U, W, Din, H, Dh, slope, s);
    case 32:
      return launch<32>(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                        edge_bias, out, lse, U, W, Din, H, Dh, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
