// The recompute-p NA backward shared by the multigraph and fused-FP backward
// kernels (seg_gat_agg_multigraph_bwd.cu, seg_gat_agg_fused_fp_bwd.cu), and
// the deterministic segmented sum that reduces their per-slot partials.
//
// A thread block owns one work unit: B dst rows, all H heads.  For each live
// slot it recomputes, from the forward's lse residual,
//   pre[i, j, h] = theta_dst[i, h] + theta_src[j, h] + bias[h]
//   p[h, i, j]   = mask[i, j] ? exp(LeakyReLU(pre) - lse[i, h]) : 0
//   dp[h, i, j]  = <g_out[i, h, :], src[j, h, :]>
//   dpre[h,i,j]  = LeakyReLU'(pre) * p * (dp - delta[i, h])   (softmax backward)
// with delta = sum_d g_out * out, computed outside the kernel.  A masked
// entry has p = 0 and dpre = 0 whatever lse is, so padding slots and rows
// with no live edge (lse ~ -1e30) give exact zeros.
#pragma once

#include "online_softmax_na.cuh"

namespace na_backward {

using online_softmax_na::kThreads;

// One live slot.  Reads from shared memory thd, ths, lse, delta [B, H],
// mask [B, B] (bytes), gout and src [B, H*Dh]; bias [H] from global memory.
// Writes p and dpre [H, B(dst), B(src)], adds the row sums of dpre into
// dthd [B, H] and writes its column sums into dths [B(src), H].  The caller
// puts a barrier before; this ends with one.
template <int B>
__device__ void slot_backward(const float* thd, const float* ths, const float* lse,
                              const float* delta, const uint8_t* mask,
                              const float* __restrict__ bias, int H, int Dh, float slope,
                              const float* gout, const float* src,
                              float* p, float* dpre, float* dthd, float* dths) {
  const int HDh = H * Dh;
  // one thread per (h, i, j); j is fastest, and each thread starts its dot
  // product at d = j mod Dh so that the threads of a warp read src rows
  // (stride H*Dh) from different banks
  for (int k = threadIdx.x; k < H * B * B; k += kThreads) {
    const int h = k / (B * B), i = (k / B) % B, j = k % B;
    float pij = 0.f, dpr = 0.f;
    if (mask[i * B + j]) {
      const float pre = thd[i * H + h] + ths[j * H + h] + bias[h];
      const float lg = pre >= 0.f ? pre : slope * pre;
      pij = expf(lg - lse[i * H + h]);
      const float* gr = gout + i * HDh + h * Dh;
      const float* sr = src + j * HDh + h * Dh;
      float dp = 0.f;
      int d = j % Dh;
      for (int n = 0; n < Dh; ++n) {
        dp = fmaf(gr[d], sr[d], dp);
        d = (d + 1 == Dh) ? 0 : d + 1;
      }
      const float dl = pij * (dp - delta[i * H + h]);
      dpr = pre >= 0.f ? dl : slope * dl;
    }
    p[k] = pij;
    dpre[k] = dpr;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < B * H; k += kThreads) {
    const int r = k / H, h = k % H;
    const float* dh = dpre + h * B * B;
    float row = 0.f, col = 0.f;
#pragma unroll
    for (int t = 0; t < B; ++t) {
      row += dh[r * B + t];
      col += dh[t * B + r];
    }
    dthd[k] += row;  // dst row r
    dths[k] = col;   // src row r
  }
  __syncthreads();
}

// The slot's src-side gradient, one thread per column c = (h, d) of H*Dh:
//   out[j, c] = sum_i p[h, i, j] * gout[i, c]  (+ dths[j, h] * a[c] if a)
// written to out [B, H*Dh] in global memory (coalesced across the warp; p is
// read as a broadcast).  With a (the fused kernel's a_src row), also
//   da[c] += sum_j dths[j, h] * src[j, c]
// in shared memory, each column owned by one thread.  Reads p, dths, gout,
// src after the barrier that ends slot_backward.
template <int B>
__device__ void slot_src_grad(const float* p, const float* dths, const float* gout,
                              const float* src, const float* __restrict__ a, int H, int Dh,
                              float* __restrict__ out, float* da) {
  const int HDh = H * Dh;
  for (int c = threadIdx.x; c < HDh; c += kThreads) {
    const int h = c / Dh;
    float gv[B];
#pragma unroll
    for (int i = 0; i < B; ++i) gv[i] = gout[i * HDh + c];
    const float* ph = p + h * B * B;
    const float ac = a != nullptr ? a[c] : 0.f;
    float dac = 0.f;
    for (int j = 0; j < B; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < B; ++i) s = fmaf(ph[i * B + j], gv[i], s);
      if (a != nullptr) {
        const float dj = dths[j * H + h];
        s = fmaf(dj, ac, s);
        dac = fmaf(dj, src[j * HDh + c], dac);
      }
      out[(size_t)j * HDh + c] = s;
    }
    if (a != nullptr) da[c] += dac;
  }
}

// out[k, f] = sum over q in [offsets[k], offsets[k+1]) of part[items[q], f],
// the items in the order given (the host sorts them by (key, unit, slot)):
// a fixed order, no atomics, so the result is bitwise repeatable.  A key
// with no items gets exact zeros.  Grid (K, ceil(F / kThreads)).
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ part, const int* __restrict__ offsets,
    const int* __restrict__ items, float* __restrict__ out, int F) {
  const int k = blockIdx.x;
  const int f = blockIdx.y * kThreads + threadIdx.x;
  if (f >= F) return;
  float s = 0.f;
  const int q1 = offsets[k + 1];
  for (int q = offsets[k]; q < q1; ++q) s += part[(size_t)items[q] * F + f];
  out[(size_t)k * F + f] = s;
}

inline int segment_sum(const float* part, const int* offsets, const int* items, float* out,
                       int K, int F, cudaStream_t stream) {
  if (K > 0 && F > 0) {
    const dim3 grid(K, (F + kThreads - 1) / kThreads);
    segment_sum_kernel<<<grid, kThreads, 0, stream>>>(part, offsets, items, out, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace na_backward
