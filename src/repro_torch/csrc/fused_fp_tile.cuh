// The CUDA-core projection and the tile coefficients of the fused-FP
// forward and backward kernels (seg_gat_agg_fused_fp.cu,
// seg_gat_agg_fused_fp_bwd.cu): a B x Din tile of raw features projected
// through one weight table (the CUDA-core route of their projection phase,
// fused_fp_project.cuh), and the attention coefficients of a projected tile.
//
// The table does not fit in shared memory (7.1 MB at Din=3489, H*Dh=512,
// against 227 KB a block), so the projection is K-tiled: x rows stream
// through shared memory kTile columns of Din at a time (stored k-major, so
// a thread reads the B rows of one k as broadcast float4s), each thread
// owns one output column per pass, reads W[k, col] straight from global
// memory (coalesced across the warp, each value used for all B rows) and
// keeps B float32 sums in registers.  A Din that is not a multiple of the
// tile is zero-filled at the edge.
#pragma once

#include "online_softmax_na.cuh"

namespace fused_fp_tile {

using online_softmax_na::kThreads;

constexpr int kTile = 32;

// dst[i, c] = sum_k x[row0 + i, k] * Wt[k, c] + bt[c] for i < B, c < HDh.
// xs is kTile*B floats of shared scratch.  Called by the whole block; ends
// with a barrier.
template <int B>
__device__ void project_tile(const float* __restrict__ x, size_t row0, int Din,
                             const float* __restrict__ Wt, const float* __restrict__ bt,
                             int HDh, float* xs, float* dst) {
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < HDh; c0 += kThreads) {
    const int c = c0 + tid;
    float acc[B];
#pragma unroll
    for (int i = 0; i < B; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < Din; k0 += kTile) {
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < B * kTile; idx += kThreads) {
        const int i = idx / kTile, k = idx % kTile;
        xs[k * B + i] = (k0 + k < Din) ? x[(row0 + i) * Din + k0 + k] : 0.f;
      }
      __syncthreads();
      if (c < HDh) {
        const int kn = min(kTile, Din - k0);
        const float* wk = Wt + (size_t)k0 * HDh + c;
        for (int k = 0; k < kn; ++k) {
          const float wv = wk[(size_t)k * HDh];
          const float4* xr = reinterpret_cast<const float4*>(xs + k * B);
#pragma unroll
          for (int q = 0; q < B / 4; ++q) {
            const float4 xv = xr[q];
            acc[4 * q + 0] = fmaf(xv.x, wv, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv.y, wv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv.z, wv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv.w, wv, acc[4 * q + 3]);
          }
        }
      }
    }
    if (c < HDh) {
      const float bc = bt[c];
#pragma unroll
      for (int i = 0; i < B; ++i) dst[i * HDh + c] = acc[i] + bc;
    }
  }
  __syncthreads();
}

// theta[r, h] = <tile[r, h*Dh : (h+1)*Dh], a[h]> for r < B, h < H, the
// tile in shared memory.  Each thread starts its dot product at d = k mod
// Dh (a fixed order per (r, h)), so that the threads of a warp, whose rows
// lie H*Dh apart, read from different banks.
template <int B>
__device__ void tile_coefficients(const float* tile, const float* __restrict__ a,
                                  int H, int Dh, float* theta) {
  for (int k = threadIdx.x; k < B * H; k += kThreads) {
    const int r = k / H, h = k % H;
    const float* t = tile + (size_t)r * H * Dh + h * Dh;
    const float* av = a + h * Dh;
    float s = 0.f;
    int d = k % Dh;
    for (int n = 0; n < Dh; ++n) {
      s = fmaf(t[d], av[d], s);
      d = (d + 1 == Dh) ? 0 : d + 1;
    }
    theta[k] = s;
  }
}

}  // namespace fused_fp_tile
