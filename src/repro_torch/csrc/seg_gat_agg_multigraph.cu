// Multi-graph fused NA forward for Hopper (sm_90a), float32.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `_fwd_call` of
//   src/repro/kernels/seg_gat_agg_multigraph.py (grid (H, U, W), online
//   softmax carried in VMEM scratch across the sequential W axis).
//
// What bounds it on this card: arithmetic.  Each live (unit, slot) does
//   B*B*H logits with an exp each and a B x B by B x (H*Dh) product,
//   2*B*B*H*Dh flops, in float32 on the CUDA cores (no TF32: the port is
//   held to float32 tolerances).  The bytes are small beside that: a slot
//   reads a B x B mask, B*H src coefficients and one B x (H*Dh) tile of
//   h_src, which is contiguous and shared by every unit that names the
//   same src block, so it is mostly served from L2.
//
// Design:
//   * One thread block per work unit, all heads together.  Units are
//     disjoint in their output rows, so blocks never meet: no atomics, and
//     the output is deterministic.  The TPU grid's sequential W axis is a
//     loop inside the block; padding slots (col < 0) are skipped, which
//     computes exactly what the TPU kernel does with them (p = 0, scale 1).
//   * Per live slot the block stages the mask and theta_src in shared
//     memory, then runs the online-softmax step of online_softmax_na.cuh
//     straight on the slot's h_src tile in global memory.
//   * m, l and acc stay on chip in float32 for the whole sweep; out and lse
//     are written once.
//   * No wgmma, TMA or pipelining yet: simple and right first.
#include "online_softmax_na.cuh"

namespace {

using namespace online_softmax_na;

template <int B>
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
    int W, int ns_pad, int nd_pad, int H, int Dh, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int HDh = H * Dh;
  float* acc = smem;                  // [B, HDh]
  float* p_s = acc + B * HDh;         // [H, B(dst), B(src)]
  float* thd_s = p_s + H * B * B;     // [B, H]
  float* ths_s = thd_s + B * H;       // [B, H]
  float* m_s = ths_s + B * H;         // [B, H]
  float* l_s = m_s + B * H;           // [B, H]
  float* scale_s = l_s + B * H;       // [H, B]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(scale_s + B * H);  // [B, B]

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = graph_id[u];
  const float* ths_g = theta_src + (size_t)g * ns_pad * H;
  const float* thd_u = theta_dst + ((size_t)g * nd_pad + (size_t)dst_row[u] * B) * H;

  for (int k = tid; k < B * HDh; k += kThreads) acc[k] = 0.f;
  for (int k = tid; k < B * H; k += kThreads) {
    thd_s[k] = thd_u[k];
    m_s[k] = kNegInf;
    l_s[k] = 0.f;
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int c = col_index[(size_t)u * W + w];
    if (c < 0) continue;  // padding slot: contributes exact zeros
    const uint8_t* mk = masks + ((size_t)u * W + w) * B * B;
    for (int k = tid; k < B * B; k += kThreads) mask_s[k] = mk[k];
    for (int k = tid; k < B * H; k += kThreads) ths_s[k] = ths_g[(size_t)c * B * H + k];
    __syncthreads();
    softmax_update<B>(thd_s, ths_s, mask_s, edge_bias + g * H, H, slope, m_s, l_s, p_s, scale_s);
    __syncthreads();
    accumulate<B>(h_src + (size_t)c * B * HDh, HDh, Dh, p_s, scale_s, acc);
    __syncthreads();
  }
  finalize<B>(acc, m_s, l_s, H, Dh, out + (size_t)u * B * HDh, lse + (size_t)u * B * H);
}

template <int B>
int launch(const int* col_index, const int* graph_id, const int* dst_row,
           const uint8_t* masks, const float* theta_src, const float* theta_dst,
           const float* h_src, const float* edge_bias, float* out, float* lse,
           int U, int W, int ns_pad, int nd_pad, int H, int Dh, float slope,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)B * H * Dh + (size_t)H * B * B + 5 * B * H) + B * B;
  cudaError_t err = cudaFuncSetAttribute(
      multigraph_fwd_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (U > 0) {
    multigraph_fwd_kernel<B><<<U, kThreads, smem, stream>>>(
        col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
        out, lse, W, ns_pad, nd_pad, H, Dh, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_gat_agg_multigraph_fwd(
    const int* col_index, const int* graph_id, const int* dst_row, const uint8_t* masks,
    const float* theta_src, const float* theta_dst, const float* h_src,
    const float* edge_bias, float* out, float* lse,
    int U, int W, int B, int ns_pad, int nd_pad, int H, int Dh, float slope,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 8:
      return launch<8>(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                       edge_bias, out, lse, U, W, ns_pad, nd_pad, H, Dh, slope, s);
    case 16:
      return launch<16>(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                        edge_bias, out, lse, U, W, ns_pad, nd_pad, H, Dh, slope, s);
    case 32:
      return launch<32>(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                        edge_bias, out, lse, U, W, ns_pad, nd_pad, H, Dh, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
