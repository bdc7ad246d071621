// The online-softmax NA step of the fused-FP forward #3
// (seg_gat_agg_fused_fp.cu; its backward #4 takes the constants); the edge
// walk of #1 and #5 (edge_na.cuh) keeps its sums' order and expressions.
//
// A thread block owns one work unit: B dst rows, all H heads.  Its
// on-chip state, in shared memory and float32 for the whole sweep over
// the unit's src block slots:
//   m, l      [B, H]      running max and sum of the softmax
//   acc       [B, H*Dh]   running weighted sum of src features
// and, per live slot, the scratch written by softmax_update:
//   p         [H, B, B]   the slot's probabilities
//   scale     [H, B]      exp(m_old - m_new), the rescale of acc and l
//
// logit[i, j, h] = LeakyReLU(theta_dst[i, h] + theta_src[j, h] + bias[h]),
// masked by mask[i, j]; masked entries are -1e30 and get p = 0, so a row
// with no live edge keeps m = -1e30, l = 0, acc = 0 and finishes at 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace online_softmax_na {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // threads per block of both kernels

// One live slot's softmax statistics: one thread per (dst row i, head h).
// Reads thd, ths [B, H], mask [B, B] (bytes) and bias [H]; updates m, l and
// writes p and scale.  The caller puts a barrier before and after.
template <int B>
__device__ void softmax_update(const float* thd, const float* ths, const uint8_t* mask,
                               const float* __restrict__ bias, int H, float slope,
                               float* m, float* l, float* p, float* scale) {
  for (int k = threadIdx.x; k < B * H; k += kThreads) {
    const int i = k / H, h = k % H;
    const float td = thd[k];
    const float bh = bias[h];
    float logit[B];
    float m_blk = kNegInf;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const float pre = td + ths[j * H + h] + bh;
      const float lg = pre >= 0.f ? pre : slope * pre;
      logit[j] = mask[i * B + j] ? lg : kNegInf;
      m_blk = fmaxf(m_blk, logit[j]);
    }
    const float m_prev = m[k];
    const float m_new = fmaxf(m_prev, m_blk);
    const float sc = expf(m_prev - m_new);
    float sum = 0.f;
    float* prow = p + ((size_t)h * B + i) * B;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const float pj = mask[i * B + j] ? expf(logit[j] - m_new) : 0.f;
      prow[j] = pj;
      sum += pj;
    }
    l[k] = l[k] * sc + sum;
    m[k] = m_new;
    scale[h * B + i] = sc;
  }
}

// acc[i, c] = acc[i, c] * scale[h, i] + sum_j p[h, i, j] * src[j, c] for
// every column c = (h, d) of H*Dh, with src a B x HDh tile (row stride
// HDh) in global or shared memory.  Each thread owns whole columns: it
// loads the B values of its column into registers (coalesced across the
// warp) and reads p as a broadcast (a warp shares one head when Dh >= 32).
// The caller puts a barrier before and after.
template <int B>
__device__ void accumulate(const float* src, int HDh, int Dh, const float* p,
                           const float* scale, float* acc) {
  for (int c = threadIdx.x; c < HDh; c += kThreads) {
    const int h = c / Dh;
    float hv[B];
#pragma unroll
    for (int j = 0; j < B; ++j) hv[j] = src[(size_t)j * HDh + c];
    const float* ph = p + (size_t)h * B * B;
    for (int i = 0; i < B; ++i) {
      const float4* pr = reinterpret_cast<const float4*>(ph + i * B);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < B / 4; ++q) {
        const float4 pv = pr[q];
        s = fmaf(pv.x, hv[4 * q + 0], s);
        s = fmaf(pv.y, hv[4 * q + 1], s);
        s = fmaf(pv.z, hv[4 * q + 2], s);
        s = fmaf(pv.w, hv[4 * q + 3], s);
      }
      acc[i * HDh + c] = acc[i * HDh + c] * scale[h * B + i] + s;
    }
  }
}

// out [B, H*Dh] = acc / max(l, 1e-9) and lse [B, H] = m + log(max(l, 1e-30))
// for the unit's rows.  The caller puts a barrier before.
template <int B>
__device__ void finalize(const float* acc, const float* m, const float* l, int H, int Dh,
                         float* __restrict__ out, float* __restrict__ lse) {
  const int HDh = H * Dh;
  for (int k = threadIdx.x; k < B * HDh; k += kThreads) {
    const int i = k / HDh, h = (k % HDh) / Dh;
    out[k] = acc[k] / fmaxf(l[i * H + h], 1e-9f);
  }
  for (int k = threadIdx.x; k < B * H; k += kThreads) {
    lse[k] = m[k] + logf(fmaxf(l[k], 1e-30f));
  }
}

}  // namespace online_softmax_na
