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
//   Design:
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

#include "hopper.cuh"

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
// ===========================================================================
namespace tc {

using namespace hopper;

constexpr int kBM = 128;       // rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;       // columns a block: wgmma's widest N, whole heads
constexpr int kBK = 16;        // depth of a stage: 64 bytes of float32, the swizzle span
constexpr int kStages = 4;     // depth of the ring the consumers read
constexpr int kRaw = 4;        // raw x tiles the producer keeps in flight
constexpr int kConsumers = 256;                   // warpgroups 0 and 1 compute
constexpr int kProducers = 128;                   // and warpgroup 2 loads and splits
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65,536
constexpr int kWTileBytes = kBN * kBK * 4;  // w^T hi or lo, [256][16], 64-byte swizzle
constexpr int kATileBytes = kBM * kBK * 4;  // x hi or lo, [128][16], 64-byte swizzle
constexpr int kStageBytes = 2 * kWTileBytes + 2 * kATileBytes;  // w hi, w lo, x hi, x lo
constexpr int kRawBytes = kBM * kBK * 4;    // a raw x tile [128][16] as cp.async leaves it
constexpr int kSmemBytes = kStages * kStageBytes + kRaw * kRawBytes + 8 * 2 * kStages + 16 + 1024;
constexpr int kHPitch = kBN + 1;            // epilogue h tile row: odd, no bank conflicts
constexpr int kChainTiles = 64;             // K tiles one accumulator chain runs (1,024 of K)
static_assert(kBM * kHPitch * 4 <= kStages * kStageBytes, "the h tile must fit the ring");
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");
constexpr int kTransposeTile = 32;

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// w [K][C] -> wt [2][C][Kp]: hi = tf32(w), lo = tf32(w - hi), transposed;
// block (0, 0) also zeroes the split-K tickets of the launch that follows.
__global__ void split_transpose_w(const float* __restrict__ w, float* __restrict__ wt,
                                  int* __restrict__ tickets, int n_tickets, int K, int C, int Kp) {
  __shared__ float tile[kTransposeTile][kTransposeTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int c0 = blockIdx.x * kTransposeTile, k0 = blockIdx.y * kTransposeTile;
  for (int r = ty; r < kTransposeTile; r += 8) {
    const int k = k0 + r, c = c0 + tx;
    tile[r][tx] = (k < K && c < C) ? w[(size_t)k * C + c] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < kTransposeTile; r += 8) {
    const int c = c0 + r, k = k0 + tx;
    if (c < C && k < K) {
      const float v = tile[tx][r];
      const uint32_t hi = tf32_rna(v);
      wt[(size_t)c * Kp + k] = __uint_as_float(hi);
      wt[((size_t)C + c) * Kp + k] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = ty * 32 + tx; i < n_tickets; i += 256) tickets[i] = 0;
}

// wgmma shared-memory descriptor, 64-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 8 * kBK * 4;  // 8 rows of 64 bytes
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// d[0:128] (+)= A . B, m64n256k8 in TF32 with float32 sums: A [64 x 8] and
// B [256 x 8] both K-major in shared memory, 64-byte swizzle; d = A . B
// when `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32_m64n256k8(float (&d)[128], uint64_t desc_a,
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void wgmma_wait_1() {  // all but the newest group have completed
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the consumer threads only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// kVec: x's rows are 16-byte aligned (K % 4 == 0 and an aligned base), so
// x comes in by 16-byte copies; else by 4-byte ones.
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
  const uint32_t base = smem_u32(smem_raw);
  // stage s at sS + s * kStageBytes: w^T hi, w^T lo, x hi, x lo
  const uint32_t sS = (base + 1023u) & ~1023u;
  const uint32_t sR = sS + kStages * kStageBytes;  // raw x tile r at + r * kRawBytes
  const uint32_t bar_full = sR + kRaw * kRawBytes;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  volatile int* last = reinterpret_cast<volatile int*>(smem_raw + (bar_empty + 8 * kStages - base));

  const int C = H * Dh;
  const int row0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN, slice = blockIdx.z;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = (int)((long long)slice * k_tiles / splits);
  const int n_tiles = (int)((long long)(slice + 1) * k_tiles / splits) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, kProducers + 1);  // every producer thread, and the TMA
      mbar_init(bar_empty + 8 * s, kConsumers);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup; it never rejoins the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - kConsumers;
    // Each producer thread copies and splits the same 4 chunks of 4 floats
    // of every x tile (chunk q = pt + 128 i: row q / 4, columns 4 (q % 4)..),
    // so no thread reads another's copies and the producers never sync.
    constexpr int kChunks = kBM * kBK / 4 / kProducers;
    // raw x tile n into buffer n % kRaw, one cp.async group per tile (empty past the slice)
    auto load_raw = [&](int n) {
      if (n < n_tiles) {
        const uint32_t dst = sR + (n % kRaw) * kRawBytes;
        const int k0 = (kt0 + n) * kBK;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int q = pt + kProducers * i, r = q / 4, k = k0 + 4 * (q % 4), row = row0 + r;
          const float* src = x + (size_t)row * K + k;
          if (kVec) {
            const int bytes = row < N ? 4 * max(0, min(4, K - k)) : 0;
            cp_async16(dst + 16 * q, bytes ? src : x, bytes);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = row < N && k + j < K;
              cp_async4(dst + 16 * q + 4 * j, ok ? src + j : x, ok ? 4 : 0);
            }
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int n = 0; n < kRaw - 1; ++n) load_raw(n);
    for (int n = 0; n < n_tiles; ++n) {
      load_raw(n + kRaw - 1);  // into the buffer this thread split in iteration n - 1
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRaw - 1) : "memory");  // tile n landed
      const int s = n % kStages;
      mbar_wait(bar_empty + 8 * s, ((n / kStages) & 1) ^ 1);  // the first round passes at once
      const uint32_t stage = sS + s * kStageBytes;
      if (pt == 0) {
        mbar_expect_tx(bar_full + 8 * s, 2 * kWTileBytes);
        tma_load_3d(stage, &tm_w, bar_full + 8 * s, (kt0 + n) * kBK, c0, 0);
      }
      // split x into tf32 hi and lo, written K-major with the 64-byte swizzle
      // (16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)) the TMA uses
      const float4* raw =
          reinterpret_cast<const float4*>(smem_raw + (sR + (n % kRaw) * kRawBytes - base));
      float4* x_hi = reinterpret_cast<float4*>(smem_raw + (stage + 2 * kWTileBytes - base));
      float4* x_lo = x_hi + kATileBytes / 16;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int q = pt + kProducers * i, r = q / 4;
        const float4 v = raw[q];
        float4 hi, lo;
        hi.x = __uint_as_float(tf32_rna(v.x));
        hi.y = __uint_as_float(tf32_rna(v.y));
        hi.z = __uint_as_float(tf32_rna(v.z));
        hi.w = __uint_as_float(tf32_rna(v.w));
        lo.x = __uint_as_float(tf32_rna(v.x - hi.x));
        lo.y = __uint_as_float(tf32_rna(v.y - hi.y));
        lo.z = __uint_as_float(tf32_rna(v.z - hi.z));
        lo.w = __uint_as_float(tf32_rna(v.w - hi.w));
        const int at = 4 * r + ((q % 4) ^ ((r >> 1) & 3));
        x_hi[at] = hi;
        x_lo[at] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      mbar_arrive(bar_full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = threadIdx.x;
  const int wg = ct / 128;  // which 64 rows of the tile
  const int warp = (ct / 32) % 4, lane = ct % 32;
  const int g = lane / 4, t4 = lane % 4;
  // accumulator layout: register i holds row g + 8 ((i >> 1) & 1) of the
  // warp's 16, column 8 (i >> 2) + 2 t4 + (i & 1)
  const int xr = wg * 64 + warp * 16 + g;  // this thread's rows in the tile: xr and xr + 8

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // The tensor cores' float32 sums are not round-to-nearest, so the error
  // of one accumulator grows with its chain of K steps.  Every kChainTiles
  // tiles the chain ends: its sum goes to its own slot of `chains` and the
  // next chain's first product overwrites the accumulator (no other
  // instruction may write it while a wgmma is in flight); the epilogue adds
  // the chains in order to the last one.
  const int ra = row0 + xr, rb = ra + 8;  // this thread's rows: register i holds rb if i & 2
  const int max_chains = ((k_tiles + splits - 1) / splits - 1) / kChainTiles;  // stored a slice
  auto store_chain = [&](int q) {
    float* slot = chains + ((size_t)slice * max_chains + q) * N * C;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = (i & 2) ? rb : ra, col = c0 + 8 * (i >> 2) + 2 * t4;
      if (row < N && col < C)
        __stcg(reinterpret_cast<float2*>(slot + (size_t)row * C + col),
               make_float2(acc[i], acc[i + 1]));
    }
  };

  // Each k8 step: x_hi w_hi + x_hi w_lo + x_lo w_hi.  One tile's group stays
  // in flight while the next is issued; its stage is released when it is done.
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    mbar_wait(bar_full + 8 * s, (n / kStages) & 1);
    const uint32_t w_hi = sS + s * kStageBytes, w_lo = w_hi + kWTileBytes;
    const uint32_t x_hi = w_lo + kWTileBytes + wg * 64 * kBK * 4, x_lo = x_hi + kATileBytes;
    const int fresh = n % kChainTiles == 0;  // a chain starts: its first product overwrites
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // k8 steps: 32 bytes along the swizzled row
      wgmma_tf32_m64n256k8(acc, desc_sw64(x_hi + 32 * kk), desc_sw64(w_hi + 32 * kk),
                           kk > 0 || !fresh);
      wgmma_tf32_m64n256k8(acc, desc_sw64(x_hi + 32 * kk), desc_sw64(w_lo + 32 * kk), 1);
      wgmma_tf32_m64n256k8(acc, desc_sw64(x_lo + 32 * kk), desc_sw64(w_hi + 32 * kk), 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait_1();
    if (n > 0) mbar_arrive(bar_empty + 8 * ((n - 1) % kStages));
    if ((n + 1) % kChainTiles == 0 && n + 1 < n_tiles) {  // a chain ends
      wgmma_wait_all();
      fence_regs(acc);
      store_chain((n + 1) / kChainTiles - 1);
    }
  }
  wgmma_wait_all();
  fence_regs(acc);
  // Epilogue through shared memory: both warpgroups are done with the ring
  // (every stage they read has been consumed), so the h tile reuses it and
  // the accumulator leaves the registers at once.
  float* hs = reinterpret_cast<float*>(smem_raw + (sS - base));  // [kBM][kHPitch]
  consumer_sync();
#pragma unroll
  for (int i = 0; i < 128; ++i)
    hs[(xr + 8 * ((i >> 1) & 1)) * kHPitch + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];
  consumer_sync();

  // From here each thread owns column quad cq (columns 4 cq..4 cq + 3) of
  // rows ct / 64, + 4, ...: float4 traffic to device memory.
  const int rows = min(kBM, N - row0), cols = min(kBN, C - c0);
  const int c4 = 4 * (ct % 64);
  const bool mine = c4 < cols;  // cols is a multiple of 8: a quad is in or out
  const int n_chains = (n_tiles - 1) / kChainTiles;  // chains stored before the last
  // h tile = ((last chain + chain 0) + chain 1) + ...: one chain at a time,
  // so that a thread's loads of many rows are in flight together
  for (int z = 0; z < n_chains && mine; ++z) {
    const float* chain = chains + ((size_t)slice * max_chains + z) * N * C;
#pragma unroll 4
    for (int m = ct / 64; m < rows; m += kConsumers / 64) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(chain + (size_t)(row0 + m) * C + c0 + c4));
      float* t = hs + m * kHPitch + c4;
      t[0] += v.x;
      t[1] += v.y;
      t[2] += v.z;
      t[3] += v.w;
    }
  }
  if (splits > 1) {  // deterministic split-K: the tile's last block sums the slices in order
    for (int m = ct / 64; m < rows && mine; m += kConsumers / 64) {
      const float* t = hs + m * kHPitch + c4;
      __stcg(reinterpret_cast<float4*>(partial + ((size_t)slice * N + row0 + m) * C + c0 + c4),
             make_float4(t[0], t[1], t[2], t[3]));
    }
    __threadfence();
    consumer_sync();
    if (ct == 0) *last = atomicAdd(tickets + blockIdx.x * gridDim.y + blockIdx.y, 1) == splits - 1;
    consumer_sync();
    if (!*last) return;
    __threadfence();
    for (int m = ct / 64; m < rows && mine; m += kConsumers / 64) {
      float* t = hs + m * kHPitch + c4;
      const float4* p = reinterpret_cast<const float4*>(partial + (size_t)(row0 + m) * C + c0 + c4);
      const size_t slice_stride = (size_t)N * C / 4;
      float4 sum = slice == 0 ? make_float4(t[0], t[1], t[2], t[3]) : __ldcg(p);
      for (int z = 1; z < splits; ++z) {
        const float4 v = z == slice ? make_float4(t[0], t[1], t[2], t[3]) : __ldcg(p + z * slice_stride);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      t[0] = sum.x;
      t[1] = sum.y;
      t[2] = sum.z;
      t[3] = sum.w;
    }
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * Dh;
  const int k_tiles = (K + tc::kBK - 1) / tc::kBK;
  if (N < 1 || K < 1 || H < 1 || Dh < 8 || tc::kBN % Dh != 0 || splits < 1 || splits > k_tiles ||
      (C + tc::kBN - 1) / tc::kBN > 65535 || splits > 65535 || (K + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const int Kp = (K + 3) & ~3;
  const dim3 grid((N + tc::kBM - 1) / tc::kBM, (C + tc::kBN - 1) / tc::kBN, splits);
  const int n_tickets = splits > 1 ? (int)(grid.x * grid.y) : 0;
  tc::split_transpose_w<<<dim3((C + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, s>>>(
      w, wt, tickets, n_tickets, K, C, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)C, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)C * Kp * 4};
  const cuuint32_t box[3] = {tc::kBK, tc::kBN, 2};
  const int err = hopper::encode_3d(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wt, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? tc::launch<true>(map, x, b, a_src, a_dst, h, theta_src, theta_dst, partial, chains,
                                tickets, N, K, H, Dh, splits, grid, s)
             : tc::launch<false>(map, x, b, a_src, a_dst, h, theta_src, theta_dst, partial,
                                 chains, tickets, N, K, H, Dh, splits, grid, s);
}

extern "C" const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }
