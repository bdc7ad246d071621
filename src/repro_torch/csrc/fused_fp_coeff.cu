// Feature projection fused with the attention coefficients for Hopper
// (sm_90a): the FP+θ stage of R-GAT's and S-HGN's per-relation attention
// on the KERNEL backend (paper Alg. 2 lines 7-8, §4.1.1 (1)).
//
// Replaces: the Pallas TPU kernel `fused_fp_coeff` / `_kernel` of
//   src/repro/kernels/fused_fp_coeff.py (grid (N/BN, Din/BK), the K axis
//   sequential with an f32 VMEM accumulator; the last K step adds the bias,
//   emits h and both coefficient vectors while the tile is VMEM-resident;
//   no VJP).
//
// Computes what `_kernel` computes, not its block structure:
//   acc[n, c] = sum_k x[n, k] * w[k, c] in float32, h = acc + b in float32,
//   theta_src[n, hd] = sum_d h[n, hd*Dh + d] * a_src[hd, d] and theta_dst
//   likewise, both from the float32 h; then h is written in x's dtype
//   (float32 or bfloat16; the thetas are float32).
//
// Two routes.  The wrapper (kernels/fused_fp_coeff.py: route) picks one from
// the dtype before the launch; neither stands in for the other when it fails.
//
// Route "wgmma" (fused_fp_coeff_wgmma_fwd): float32 operands, every Dh.
//   What bounds it on this card: R-GAT's layer-0 projection of IMDB's actors
//   (6,124 x 3,341 -> 256) is 2*N*Din*C = 1.05e10 flops against 92 MB of
//   operands: 0.021 ms at the TF32 tensor-core peak (495 TFLOP/s), 0.027 ms
//   at 3.35 TB/s, so the bytes bound the function.  This design does three
//   products (below), 0.064 ms of tensor-core work.
//   Numerics: float32 products on tensor cores by split TF32.  Each operand
//   is cut into v = hi + lo with hi = cvt.rna.tf32(v) and lo =
//   cvt.rna.tf32(v - hi): lo is rounded as well, so the card's tensor core,
//   which ignores the low 13 mantissa bits of a .tf32 operand, sees exactly
//   the values the CPU emulation (tensor_core_emulation) uses.  Three
//   products, x_hi w_hi + x_hi w_lo + x_lo w_hi, go into one float32
//   accumulator in that order each k8 step; the dropped x_lo w_lo and the
//   rounding of lo are each below 2^-22 |x||w|.  The wrapper's limit
//   SPLIT_ERROR_MAX on max |h - h64| / (|x||w| + |b|) tells this from one
//   TF32 product.  What remains on the card is the tensor core's own
//   float32 accumulation, which is not round-to-nearest: its error grows
//   with the number of K steps one accumulator takes.  So an accumulator
//   runs at most kChainTiles K tiles (1,024 of K): then its sum goes to a
//   slot in device memory and it restarts from zero, and the epilogue adds
//   the chains' sums to the last one in order, rounded to nearest.
//   Design (the product, through the chain and split-K sums, is
//   split_tf32_gemm.cuh's gemm_tile, shared with the projection phase of
//   the fused FP+NA kernels #3 and #4; this file holds its epilogue):
//   * A block of 384 threads owns 128 rows and 256 columns (a whole number
//     of heads, all of C = 256): warpgroups 0 and 1 each run m64n256k8 on
//     64 of the rows, so each x tile is read once; warpgroup 2 loads and
//     splits (40 registers a thread after setmaxnreg, the consumers 232).
//   * w^T, split: a first kernel of this library (split_transpose_w) writes
//     w^T's hi and lo parts [2][C][Kp] (Kp = K rounded up to 4, so rows are
//     16-byte aligned) once per call.  tf32 wgmma takes B K-major only (the
//     transpose bit exists for 16-bit types), and the split happens once per
//     weight instead of once per row tile.
//   * x is A, from shared memory, split by the producer: x_hi and x_lo
//     [128][16] sit in the stage beside w^T's, K-major with the 64-byte
//     swizzle.  A from registers would cost the consumers 16 registers
//     beside the 128 of the accumulator, and ptxas then serialised every
//     wgmma (warning C7512) at this kernel's 168-register allocation; from
//     shared memory, one K tile's products stay in flight while the next
//     tile's are issued (wgmma.wait_group 1).
//   * A ring of 4 stages of 16-deep K tiles (w^T hi, w^T lo, x hi, x lo;
//     48 KB): w^T by one TMA (64-byte swizzle, zero-filled past K and C).
//     Layer 0's x rows (3,341 or 3,489 floats) are not 16-byte aligned and
//     TMA cannot describe them, so raw x comes in by cp.async into 4 raw
//     tiles of its own, 3 tiles ahead of the split: 4 bytes at a time where
//     the pitch is unaligned, else 16, zero-filled past Din and N.  The
//     producer splits the raw tile into the stage (fence.proxy.async), and
//     its 128 arrivals and the TMA's transaction count complete the stage.
//     x is neither padded nor copied in device memory.
//   * Split-K for launches with few row tiles: the wrapper's split_k picks S
//     from (N, Din, C) alone; block z sums K tiles [z T / S, (z+1) T / S).
//     Each block writes its float32 partial to a workspace and takes a
//     ticket; the last block of a tile sums the partials in slice order
//     0..S-1 and runs the epilogue.  No atomics touch h, and the ticket
//     counters are zeroed by split_transpose_w in the same stream.
//   * Epilogue through shared memory: once both warpgroups are done with
//     the ring, the accumulators go to an h tile [128][257] that reuses it
//     (so the epilogue holds no accumulator registers); the stored chains'
//     sums, the split-K sum, the bias, then theta per (row, head, side) in d
//     order from the float32 h, then h out as float4 rows.  (A theta taken
//     in registers by quad shuffles kept the accumulator live through the
//     epilogue, and ptxas spilled it.)
//   * ptxas warns (C7515) that reading the accumulator for a chain's store
//     inside the K loop serialises wgmma instructions; a build without the
//     chain stores ran only a few percent faster.
//   * Every sum runs in a fixed order: the output is bitwise repeatable.
//   * An mbarrier wait that lasts seconds traps, so a lost arrival fails the
//     launch instead of hanging the card.
//
// Route "cuda_cores" (fused_fp_coeff_fwd): bf16 operands (and float32 when
//   asked for by name, to hold it against the plain version).  The products
//   run in float32 on the CUDA cores (67 TFLOP/s peak: 0.157 ms at the actor
//   shape above).
//   Design (simple and right first; no wgmma, TMA or pipelining):
//   * A shared-memory tiled SGEMM with register blocking.  A block of 256
//     threads owns 64 rows and BN = max(64, Dh) columns: a whole number of
//     heads, so it finishes theta for its rows and heads on chip.  No other
//     block writes those (row, head) pairs: no atomics.  Every sum runs in
//     a fixed order, so the results are bitwise repeatable.
//   * The K axis (the TPU grid's sequential axis) is a loop inside the
//     block over 32-deep tiles.  The x tile is stored k-major (transposed)
//     so that a thread reads its 4 rows as one float4; the w tile is
//     row-major and a thread reads its 4 or 8 columns as float4s.  Thread
//     (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and columns
//     TN*tx..TN*tx+TN-1 (TN = BN / 16).
//   * Any N >= 1 and Din >= 1: the tile loads are bounds-checked and
//     zero-filled, the stores bounds-checked.  x and w are read with scalar
//     loads (consecutive threads on consecutive addresses) and converted to
//     float32 on the way into shared memory.
//   * Epilogue: acc + b goes to a padded float32 tile in shared memory
//     (reusing the GEMM tiles' space); one thread per (row, head, side)
//     takes theta from it in d order, then the tile is written out
//     coalesced in x's dtype.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_tf32_gemm.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBM = 64;        // rows of x a block owns
constexpr int kBK = 32;        // depth of one K step
constexpr int kTM = kBM / 16;  // rows a thread owns
constexpr int kPadX = 4;       // x tile [kBK][kBM + 4]: float4 reads stay aligned
constexpr int kMaxRowTiles = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int Dh>
struct Tile {
  static constexpr int BN = Dh >= 64 ? Dh : 64;  // columns: a whole number of heads
  static constexpr int HB = BN / Dh;             // heads a block owns
  static constexpr int TN = BN / 16;             // columns a thread owns
  static constexpr int XS = kBK * (kBM + kPadX); // x tile, k-major
  static constexpr int WS = kBK * BN;            // w tile, row-major
  static constexpr int HS = kBM * (BN + 1);      // epilogue h tile (odd stride: no bank conflicts)
  static constexpr int floats = XS + WS > HS ? XS + WS : HS;
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads) fused_fp_coeff_kernel(
    const T* __restrict__ x,        // [N, K]
    const T* __restrict__ w,        // [K, H*Dh]
    const T* __restrict__ b,        // [H*Dh]
    const T* __restrict__ a_src,    // [H, Dh]
    const T* __restrict__ a_dst,    // [H, Dh]
    T* __restrict__ h,              // [N, H*Dh]
    float* __restrict__ theta_src,  // [N, H]
    float* __restrict__ theta_dst,  // [N, H]
    int N, int K, int H) {
  using L = Tile<Dh>;
  constexpr int BN = L::BN, TN = L::TN;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;         // [kBK][kBM + kPadX]
  float* ws = smem + L::XS; // [kBK][BN]
  float* hs = smem;         // [kBM][BN + 1], once the K loop is done

  const int C = H * Dh;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, k = e % kBK;
      const int r = row0 + m, kk = k0 + k;
      xs[k * (kBM + kPadX) + m] = (r < N && kk < K) ? to_f32(x[(size_t)r * K + kk]) : 0.f;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int kk = k0 + k, c = col0 + n;
      ws[k * BN + n] = (kk < K && c < C) ? to_f32(w[(size_t)kk * C + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(xs + k * (kBM + kPadX) + ty * kTM);
      const float a[kTM] = {av.x, av.y, av.z, av.w};
      float bv[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(ws + k * BN + tx * TN + 4 * q);
        bv[4 * q + 0] = t.x;
        bv[4 * q + 1] = t.y;
        bv[4 * q + 2] = t.z;
        bv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // h = acc + b in float32, staged in shared memory (the K loop's last
  // barrier has passed: every thread is done with the GEMM tiles)
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = tx * TN + j, c = col0 + n;
    const float bias = c < C ? to_f32(b[c]) : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) hs[(ty * kTM + i) * (BN + 1) + n] = acc[i][j] + bias;
  }
  __syncthreads();

  // theta from the float32 h: one thread per (row, head, side), d in order
  const int head0 = col0 / Dh;
  for (int p = tid; p < 2 * L::HB * kBM; p += kThreads) {
    const int m = p % kBM, hl = (p / kBM) % L::HB, side = p / (kBM * L::HB);
    const int r = row0 + m, head = head0 + hl;
    if (r >= N || head >= H) continue;
    const T* a = (side ? a_dst : a_src) + (size_t)head * Dh;
    const float* hr = hs + m * (BN + 1) + hl * Dh;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) s = fmaf(hr[d], to_f32(a[d]), s);
    (side ? theta_dst : theta_src)[(size_t)r * H + head] = s;
  }

  // h in x's dtype, consecutive threads on consecutive columns
  for (int e = tid; e < kBM * BN; e += kThreads) {
    const int m = e / BN, n = e % BN;
    const int r = row0 + m, c = col0 + n;
    if (r < N && c < C) store(h + (size_t)r * C + c, hs[m * (BN + 1) + n]);
  }
}

template <typename T, int Dh>
int launch(const void* x, const void* w, const void* b, const void* a_src, const void* a_dst,
           void* h, float* theta_src, float* theta_dst, int N, int K, int H,
           cudaStream_t stream) {
  using L = Tile<Dh>;
  const size_t smem = sizeof(float) * L::floats;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fp_coeff_kernel<T, Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * Dh + L::BN - 1) / L::BN, (N + kBM - 1) / kBM);
  fused_fp_coeff_kernel<T, Dh><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(a_src), static_cast<const T*>(a_dst), static_cast<T*>(h), theta_src,
      theta_dst, N, K, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, const void* a_src, const void* a_dst,
             void* h, float* theta_src, float* theta_dst, int N, int K, int H, int Dh,
             cudaStream_t s) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, s);
    case 16:
      return launch<T, 16>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, s);
    case 32:
      return launch<T, 32>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, s);
    case 64:
      return launch<T, 64>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, s);
    case 128:
      return launch<T, 128>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fused_fp_coeff_fwd(const void* x, const void* w, const void* b, const void* a_src,
                                  const void* a_dst, void* h, float* theta_src,
                                  float* theta_dst, int N, int K, int H, int Dh, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || K < 1 || H < 1 || (N + kBM - 1) / kBM > kMaxRowTiles)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, Dh,
                                   s);
  return dispatch<float>(x, w, b, a_src, a_dst, h, theta_src, theta_dst, N, K, H, Dh, s);
}


// ===========================================================================
// Route "wgmma": float32 operands, split TF32 on the tensor cores
// (split_tf32_gemm.cuh holds the product; this file its epilogue)
// ===========================================================================
namespace tc {

// using-declarations, not a using-directive: these hide the CUDA-core
// route's constants of the same names (kThreads, kBM) in this file
using split_tf32::consumer_sync;
using split_tf32::gemm_tile;
using split_tf32::kBM;
using split_tf32::kBN;
using split_tf32::kConsumers;
using split_tf32::kHPitch;
using split_tf32::kSmemBytes;
using split_tf32::kThreads;
using split_tf32::TileArgs;

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) fused_fp_coeff_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_w,  // w^T split [2][C][K], boxes 16 x 256 x 2
    const float* __restrict__ x,               // [N, K]
    const float* __restrict__ b,               // [C]
    const float* __restrict__ a_src,           // [H, Dh] = [C]
    const float* __restrict__ a_dst,           // [C]
    float* __restrict__ h,                     // [N, C]
    float* __restrict__ theta_src,             // [N, H]
    float* __restrict__ theta_dst,             // [N, H]
    float* __restrict__ partial,               // [S, N, C] when S > 1
    float* __restrict__ chains,                // [S, max chains a slice - 1, N, C]
    int* __restrict__ tickets,                 // [row tiles * column tiles] when S > 1
    int N, int K, int H, int Dh, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const int C = H * Dh;
  const int row0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;
  const TileArgs args{row0, N, K, C, c0, c0, row0, N, (int)blockIdx.z, splits};
  float* hs = gemm_tile<kVec>(smem_raw, &tm_w, x, args, partial, chains,
                              tickets + blockIdx.x * gridDim.y + blockIdx.y);
  if (hs == nullptr) return;

  // The epilogue, from the h tile in shared memory.  Each thread owns column
  // quad cq (columns 4 cq..4 cq + 3) of rows ct / 64, + 4, ...
  const int ct = threadIdx.x;
  const int rows = min(kBM, N - row0), cols = min(kBN, C - c0);
  const int c4 = 4 * (ct % 64);
  const bool mine = c4 < cols;  // cols is a multiple of 8: a quad is in or out
  // h = acc + b in float32
  if (mine) {
    const float b0 = b[c0 + c4], b1 = b[c0 + c4 + 1], b2 = b[c0 + c4 + 2], b3 = b[c0 + c4 + 3];
    for (int m = ct / 64; m < rows; m += kConsumers / 64) {
      float* t = hs + m * kHPitch + c4;
      t[0] += b0;
      t[1] += b1;
      t[2] += b2;
      t[3] += b3;
    }
  }
  consumer_sync();
  // theta from the float32 h: one thread per (row, head, side), d in order
  const int heads = cols / Dh, head0 = c0 / Dh;
  for (int q = ct; q < 2 * heads * rows; q += kConsumers) {
    const int m = q % rows, hl = (q / rows) % heads, side = q / (rows * heads);
    const float* a = (side ? a_dst : a_src) + (size_t)(head0 + hl) * Dh;
    const float* hr = hs + m * kHPitch + hl * Dh;
    float t = 0.f;
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) t = fmaf(hr[d], a[d], t);
    (side ? theta_dst : theta_src)[(size_t)(row0 + m) * H + head0 + hl] = t;
  }
  // h out as float4
  for (int m = ct / 64; m < rows && mine; m += kConsumers / 64) {
    const float* t = hs + m * kHPitch + c4;
    *reinterpret_cast<float4*>(h + (size_t)(row0 + m) * C + c0 + c4) =
        make_float4(t[0], t[1], t[2], t[3]);
  }
}

template <bool kVec>
int launch(const CUtensorMap& map, const float* x, const float* b, const float* a_src,
           const float* a_dst, float* h, float* theta_src, float* theta_dst, float* partial,
           float* chains, int* tickets, int N, int K, int H, int Dh, int splits, dim3 grid,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(fused_fp_coeff_wgmma_kernel<kVec>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  fused_fp_coeff_wgmma_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      map, x, b, a_src, a_dst, h, theta_src, theta_dst, partial, chains, tickets, N, K, H, Dh,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The tensor-core route: wt is scratch for w^T's hi and lo parts, 2 * C * Kp
// floats (Kp = K rounded up to 4); partial is S * N * C floats and tickets
// one int per (row tile, column tile) when splits > 1; chains holds S * M *
// N * C floats, M = (ceil(K tiles / S) - 1) / kChainTiles chain sums a slice
// stores before its last.  Two launches on `stream`: the split of w, then
// the product.
extern "C" int fused_fp_coeff_wgmma_fwd(const float* x, const float* w, const float* b,
                                        const float* a_src, const float* a_dst, float* h,
                                        float* theta_src, float* theta_dst, float* wt,
                                        float* partial, float* chains, int* tickets, int N, int K,
                                        int H, int Dh, int splits, void* stream) {
  namespace st = split_tf32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * Dh;
  const int k_tiles = (K + st::kBK - 1) / st::kBK;
  if (N < 1 || K < 1 || H < 1 || Dh < 8 || st::kBN % Dh != 0 || splits < 1 || splits > k_tiles ||
      (C + st::kBN - 1) / st::kBN > 65535 || splits > 65535 || (K + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const int Kp = (K + 3) & ~3;
  const dim3 grid((N + st::kBM - 1) / st::kBM, (C + st::kBN - 1) / st::kBN, splits);
  const int n_tickets = splits > 1 ? (int)(grid.x * grid.y) : 0;
  st::split_transpose_w<<<dim3((C + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, s>>>(
      w, wt, tickets, n_tickets, K, C, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  const int err = st::encode_w_map(&map, wt, 1, K, C);
  if (err != 0) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? tc::launch<true>(map, x, b, a_src, a_dst, h, theta_src, theta_dst, partial, chains,
                                tickets, N, K, H, Dh, splits, grid, s)
             : tc::launch<false>(map, x, b, a_src, a_dst, h, theta_src, theta_dst, partial,
                                 chains, tickets, N, K, H, Dh, splits, grid, s);
}

extern "C" const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }
