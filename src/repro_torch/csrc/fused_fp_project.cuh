// Phase P of the fused FP+NA kernels #3 and #4 (seg_gat_agg_fused_fp.cu,
// seg_gat_agg_fused_fp_bwd.cu): the projection, once.
//
//   h[t, rows] = x[rows] . w[t] + b[t]    in float32, into h [T, n_pad, C]
//
// for each row tile (t, r) of a list the host builds from the topology: the
// 128-row tiles that hold a block some live unit reads through table t (a
// src column or its dst row).  Each listed tile is projected exactly once,
// each of its rows written once; rows of tiles not listed stay undefined
// and no unit reads them.  Phase A (the NA sweep) then copies its B x C
// tiles from h, which at HAN's full-IMDB shape (10.1 MB) sits in the 50 MB
// L2: a src tile is read by ~240 units spread over every SM, and L2 is the
// on-chip level all SMs share.
//
// Two routes, picked by the wrapper (kernels/seg_gat_agg_fused_fp.py:
// route) before the launch, neither a fallback of the other:
//   * kRouteWgmma: split TF32 on the tensor cores, split_tf32_gemm.cuh's
//     gemm_tile (kernel #6's product) over a grid of (listed tile, 256-column
//     tile, K slice); the epilogue adds b[t] and writes h as float4 rows.  No
//     theta epilogue: theta is per graph, and phase A takes it from the tile.
//     x goes in by 4-byte cp.async where its rows are not 16-byte aligned
//     (HAN's Din = 3,489).  Needs C % 8 == 0.
//   * kRouteCudaCores: float32 FMAs on the CUDA cores, fused_fp_tile.cuh's
//     project_tile run on each B-row block of a listed tile, one thread
//     block a tile.  Takes any C (the tiny widths of the tests).
#pragma once

#include "fused_fp_tile.cuh"
#include "split_tf32_gemm.cuh"

namespace fused_fp_project {

constexpr int kRowTile = split_tf32::kBM;  // rows of x a listed tile covers: 128
constexpr int kRouteWgmma = 0, kRouteCudaCores = 1;

template <bool kVec>
__global__ void __launch_bounds__(split_tf32::kThreads, 1) project_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_w,  // w^T split [2][T * C][Kp], boxes 16 x 256 x 2
    const float* __restrict__ x,               // [n_pad, K]
    const float* __restrict__ b,               // [T, C]
    const int* __restrict__ tiles,             // [L]  t * row_tiles + r, one a block row
    float* __restrict__ h,                     // [T, n_pad, C]
    float* __restrict__ partial,               // [S, L * 128, C] when S > 1
    float* __restrict__ chains,                // [S, max chains a slice - 1, L * 128, C]
    int* __restrict__ tickets,                 // [L * column tiles] when S > 1
    int n_pad, int K, int C, int row_tiles, int splits) {
  using namespace split_tf32;
  extern __shared__ uint8_t smem_raw[];
  const int id = tiles[blockIdx.x];
  const int t = id / row_tiles, row0 = (id % row_tiles) * kBM, c0 = blockIdx.y * kBN;
  const TileArgs args{row0, n_pad, K, C, c0, t * C + c0, (int)blockIdx.x * kBM,
                      (int)gridDim.x * kBM, (int)blockIdx.z, splits};
  // the producer holds this tile's origin (from `tiles`, not blockIdx) in
  // registers: 56 a producer thread, 224 a consumer
  const float* hs = gemm_tile<kVec, 56, 224>(smem_raw, &tm_w, x, args, partial, chains,
                                             tickets + blockIdx.x * gridDim.y + blockIdx.y);
  if (hs == nullptr) return;
  // h = acc + b[t] in float32, out as float4 rows (each thread its column quad);
  // the tile's origin read again, so that it is not held through the K loop
  const int id2 = *reinterpret_cast<const volatile int*>(tiles + blockIdx.x);
  const int t2 = id2 / row_tiles, r0 = (id2 % row_tiles) * kBM;
  const int ct = threadIdx.x;
  const int rows = min(kBM, n_pad - r0), cols = min(kBN, C - c0);
  const int c4 = 4 * (ct % 64);
  if (c4 >= cols) return;  // cols is a multiple of 8: a quad is in or out
  const float* bt = b + (size_t)t2 * C + c0 + c4;
  const float b0 = bt[0], b1 = bt[1], b2 = bt[2], b3 = bt[3];
  float* ht = h + ((size_t)t2 * n_pad + r0) * C + c0 + c4;
  for (int m = ct / 64; m < rows; m += kConsumers / 64) {
    const float* v = hs + m * kHPitch + c4;
    *reinterpret_cast<float4*>(ht + (size_t)m * C) =
        make_float4(v[0] + b0, v[1] + b1, v[2] + b2, v[3] + b3);
  }
}

template <int B>
__global__ void __launch_bounds__(fused_fp_tile::kThreads) project_cuda_cores_kernel(
    const float* __restrict__ x,    // [n_pad, K]
    const float* __restrict__ w,    // [T, K, C]
    const float* __restrict__ b,    // [T, C]
    const int* __restrict__ tiles,  // [L]  t * row_tiles + r, one a block
    float* __restrict__ h,          // [T, n_pad, C]
    int n_pad, int K, int C, int row_tiles) {
  __shared__ __align__(16) float xs[fused_fp_tile::kTile * B];
  const int id = tiles[blockIdx.x];
  const int t = id / row_tiles, row0 = (id % row_tiles) * kRowTile;
  const float* wt = w + (size_t)t * K * C;
  const float* bt = b + (size_t)t * C;
  const int row1 = min(row0 + kRowTile, n_pad);  // n_pad is a multiple of B
  for (int r = row0; r < row1; r += B)
    fused_fp_tile::project_tile<B>(x, (size_t)r, K, wt, bt, C, xs, h + ((size_t)t * n_pad + r) * C);
}

// Phase P on `stream`.  wt: 2 * T * C * Kp floats (Kp = K rounded up to 4)
// for w's split; partial: S * L * 128 * C floats and tickets L * ceil(C /
// 256) ints when splits > 1; chains: S * M * L * 128 * C floats, M =
// (ceil(K tiles / S) - 1) / kChainTiles (all unused on the CUDA-core
// route).  0 or the first error.
template <int B>
int project(int route, const float* x, const float* w, const float* b, const int* tiles,
            int L, int row_tiles, float* h, float* wt, float* partial, float* chains,
            int* tickets, int T, int n_pad, int K, int C, int splits, cudaStream_t s) {
  namespace st = split_tf32;
  if (L == 0) return 0;
  if (route == kRouteCudaCores) {
    project_cuda_cores_kernel<B><<<L, fused_fp_tile::kThreads, 0, s>>>(x, w, b, tiles, h, n_pad,
                                                                       K, C, row_tiles);
    return (int)cudaGetLastError();
  }
  const int k_tiles = (K + st::kBK - 1) / st::kBK;
  const int col_tiles = (C + st::kBN - 1) / st::kBN;
  if (route != kRouteWgmma || C % 8 != 0 || splits < 1 || splits > k_tiles || col_tiles > 65535 ||
      splits > 65535 || (K + 31) / 32 > 65535 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const int Kp = (K + 3) & ~3;
  const int n_tickets = splits > 1 ? L * col_tiles : 0;
  st::split_transpose_w<<<dim3((C + 31) / 32, (K + 31) / 32, T), dim3(32, 8), 0, s>>>(
      w, wt, tickets, n_tickets, K, C, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  const int err = st::encode_w_map(&map, wt, T, K, C);
  if (err != 0) return err;
  const dim3 grid(L, col_tiles, splits);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = vec ? project_wgmma_kernel<true> : project_wgmma_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, st::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, st::kThreads, st::kSmemBytes, s>>>(map, x, b, tiles, h, partial, chains, tickets,
                                                     n_pad, K, C, row_tiles, splits);
  return (int)cudaGetLastError();
}

// dst [B, C] in shared memory <- src [B, C] (rows contiguous) in device
// memory: 16-byte cp.async where C % 4 == 0 (src and dst then 16-byte
// aligned), else 4-byte.  Waits for its own copies; the caller puts a
// barrier after.
template <int B>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int C, float* dst) {
  const int n = B * C;
  if ((C & 3) == 0) {
    for (int k = 4 * threadIdx.x; k < n; k += 4 * fused_fp_tile::kThreads)
      split_tf32::cp_async16(hopper::smem_u32(dst + k), src + k, 16);
  } else {
    for (int k = threadIdx.x; k < n; k += fused_fp_tile::kThreads)
      split_tf32::cp_async4(hopper::smem_u32(dst + k), src + k, 4);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Whether unit u has a live slot: only then did phase P project its tiles.
__device__ __forceinline__ bool unit_is_live(const int* __restrict__ col_index, int u, int W) {
  for (int w = 0; w < W; ++w)
    if (col_index[(size_t)u * W + w] >= 0) return true;
  return false;
}

}  // namespace fused_fp_project
