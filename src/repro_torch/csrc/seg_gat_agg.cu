// Single-graph block-CSR online-softmax NA forward for Hopper (sm_90a),
// float32: the per-graph KERNEL backend of R-GAT and S-HGN.
//
// Replaces: the Pallas TPU kernel `seg_gat_agg` / `_kernel` of
//   src/repro/kernels/seg_gat_agg.py (grid (H, R, W), one head of one
//   dst-block row per step, online softmax carried in VMEM scratch across
//   the sequential W axis; no VJP).
//
// What bounds it on this card: arithmetic.  Each live (row, slot) does
//   B*B logits with an exp each per head and a B x B by B x Dh product per
//   head, 2*B*B*Dh flops, in float32 on the CUDA cores (no TF32: the port
//   is held to float32 tolerances).  A slot reads a B x B mask, B src
//   coefficients and one B x Dh tile of h_src per head; the tiles of one
//   src block are shared by every row that names it and mostly come from
//   L2.
//
// Design:
//   * One thread block per (dst-block row, head).  Relation graphs of low
//     cardinality have few rows (PS in ACM has 4), so blocks over rows
//     alone would leave most of the 132 SMs idle; the head axis multiplies
//     the blocks by H.  Blocks own disjoint (rows, head) outputs: no
//     atomics, and the output is deterministic.
//   * The TPU grid's sequential W axis is a loop inside the block; padding
//     slots (col < 0) are skipped, which computes exactly what the TPU
//     kernel does with them (p = 0, scale 1).
//   * Per live slot the block stages the mask, the slot's B src
//     coefficients and its B x Dh src tile of this head in shared memory;
//     the softmax statistics are online_softmax_na.cuh's softmax_update on
//     a one-head view, then every thread owns (row, column) pairs of the
//     B x Dh accumulator.  The arithmetic (the order of every sum, the
//     exp, the final division) is the multigraph kernel's, so a graph run
//     through this kernel and through seg_gat_agg_multigraph.cu at G = 1
//     gives the same bits.
//   * m, l and acc stay on chip in float32 for the whole sweep; out is
//     written once.  It keeps no lse: the TPU kernel has no backward.
//   * No wgmma, TMA or pipelining yet: simple and right first.
#include "online_softmax_na.cuh"

namespace {

using namespace online_softmax_na;

template <int B>
__global__ void __launch_bounds__(kThreads) seg_gat_agg_kernel(
    const int* __restrict__ col_index,    // [R, W]
    const uint8_t* __restrict__ masks,    // [R, W, B, B]
    const float* __restrict__ theta_src,  // [ns_pad, H]
    const float* __restrict__ theta_dst,  // [R*B, H]
    const float* __restrict__ h_src,      // [ns_pad, H, Dh]
    const float* __restrict__ edge_bias,  // [H]
    float* __restrict__ out,              // [R*B, H, Dh]
    int W, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                  // [B, Dh]
  float* hs_s = acc + B * Dh;         // [B, Dh]   the slot's src tile, this head
  float* p_s = hs_s + B * Dh;         // [B(dst), B(src)]
  float* thd_s = p_s + B * B;         // [B]
  float* ths_s = thd_s + B;           // [B]
  float* m_s = ths_s + B;             // [B]
  float* l_s = m_s + B;               // [B]
  float* scale_s = l_s + B;           // [B]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(scale_s + B);  // [B, B]

  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int BDh = B * Dh;

  for (int k = tid; k < BDh; k += kThreads) acc[k] = 0.f;
  for (int i = tid; i < B; i += kThreads) {
    thd_s[i] = theta_dst[((size_t)r * B + i) * H + h];
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int c = col_index[(size_t)r * W + w];
    if (c < 0) continue;  // padding slot: contributes exact zeros
    const uint8_t* mk = masks + ((size_t)r * W + w) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    for (int j = tid; j < B; j += kThreads) ths_s[j] = theta_src[((size_t)c * B + j) * H + h];
    for (int k = tid; k < BDh; k += kThreads) {
      const int j = k / Dh, d = k % Dh;
      hs_s[k] = h_src[(((size_t)c * B + j) * H + h) * Dh + d];
    }
    __syncthreads();
    // one-head view: thd/ths [B, 1], bias [1], p [1, B, B], scale [1, B]
    softmax_update<B>(thd_s, ths_s, mask_s, edge_bias + h, 1, slope, m_s, l_s, p_s, scale_s);
    __syncthreads();
    for (int k = tid; k < BDh; k += kThreads) {
      const int i = k / Dh, d = k % Dh;
      const float4* pr = reinterpret_cast<const float4*>(p_s + i * B);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < B / 4; ++q) {
        const float4 pv = pr[q];
        s = fmaf(pv.x, hs_s[(4 * q + 0) * Dh + d], s);
        s = fmaf(pv.y, hs_s[(4 * q + 1) * Dh + d], s);
        s = fmaf(pv.z, hs_s[(4 * q + 2) * Dh + d], s);
        s = fmaf(pv.w, hs_s[(4 * q + 3) * Dh + d], s);
      }
      acc[k] = acc[k] * scale_s[i] + s;
    }
    __syncthreads();
  }
  for (int k = tid; k < BDh; k += kThreads) {
    const int i = k / Dh, d = k % Dh;
    out[(((size_t)r * B + i) * H + h) * Dh + d] = acc[k] / fmaxf(l_s[i], 1e-9f);
  }
}

template <int B>
int launch(const int* col_index, const uint8_t* masks, const float* theta_src,
           const float* theta_dst, const float* h_src, const float* edge_bias, float* out,
           int R, int W, int H, int Dh, float slope, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)B * Dh + (size_t)B * B + 5 * B) + B * B;
  cudaError_t err = cudaFuncSetAttribute(
      seg_gat_agg_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (R > 0 && H > 0) {
    seg_gat_agg_kernel<B><<<dim3(R, H), kThreads, smem, stream>>>(
        col_index, masks, theta_src, theta_dst, h_src, edge_bias, out, W, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_gat_agg_fwd(
    const int* col_index, const uint8_t* masks, const float* theta_src,
    const float* theta_dst, const float* h_src, const float* edge_bias, float* out,
    int R, int W, int B, int H, int Dh, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 8:
      return launch<8>(col_index, masks, theta_src, theta_dst, h_src, edge_bias, out,
                       R, W, H, Dh, slope, s);
    case 16:
      return launch<16>(col_index, masks, theta_src, theta_dst, h_src, edge_bias, out,
                        R, W, H, Dh, slope, s);
    case 32:
      return launch<32>(col_index, masks, theta_src, theta_dst, h_src, edge_bias, out,
                        R, W, H, Dh, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
