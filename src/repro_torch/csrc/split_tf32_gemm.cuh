// The split-TF32 tensor-core product shared by kernel #6's wgmma route
// (fused_fp_coeff.cu) and the projection phase of the fused FP+NA kernels
// #3 and #4 (fused_fp_project.cuh): one 128 x 256 tile of x . w in float32
// on Hopper's tensor cores, left in shared memory for the caller's
// epilogue.
//
// Numerics: each operand is cut into v = hi + lo with hi = cvt.rna.tf32(v)
//   and lo = cvt.rna.tf32(v - hi), and three products x_hi w_hi + x_hi w_lo
//   + x_lo w_hi go into one float32 accumulator in that order each k8 step.
//   The tensor cores' own float32 sums are not round-to-nearest, so an
//   accumulator runs at most kChainTiles K tiles (1,024 of K): then its sum
//   goes to a slot in device memory and it restarts from zero, and the
//   stored chains are added in order to the last one.
//
// Design (fused_fp_coeff.cu's header says why each piece is there):
//   * A block of 384 threads owns 128 rows and 256 columns: warpgroups 0
//     and 1 each run m64n256k8 on 64 of the rows; warpgroup 2 loads and
//     splits (setmaxnreg: 40 registers a producer thread, 232 a consumer).
//   * w^T, split once a call by split_transpose_w into [2][T * C][Kp] (hi
//     of every table, then lo), comes in by TMA (64-byte swizzle); x by 4-
//     or 16-byte cp.async into raw tiles 3 ahead, split by the producer into
//     the stage.
//   * Split-K: block slice z of S sums K tiles [z T / S, (z+1) T / S),
//     writes its partial and takes a ticket; the tile's last block sums the
//     partials in slice order 0..S-1.  No atomics touch the result.
//   * Every sum runs in a fixed order: the result is bitwise repeatable.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace split_tf32 {

using namespace hopper;

constexpr int kBM = 128;       // rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;       // columns a block: wgmma's widest N
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

// w [T][K][C] -> wt [2][T * C][Kp]: hi = tf32(w), lo = tf32(w - hi),
// transposed, table t's columns at rows t * C..; grid z runs over the T
// tables.  Block (0, 0, 0) also zeroes the split-K tickets of the launch
// that follows.
__global__ void split_transpose_w(const float* __restrict__ w, float* __restrict__ wt,
                                  int* __restrict__ tickets, int n_tickets, int K, int C, int Kp) {
  __shared__ float tile[kTransposeTile][kTransposeTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int c0 = blockIdx.x * kTransposeTile, k0 = blockIdx.y * kTransposeTile;
  const size_t TC = (size_t)gridDim.z * C;  // rows of one of the hi and lo planes
  w += (size_t)blockIdx.z * K * C;
  wt += (size_t)blockIdx.z * C * Kp;
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
      wt[(TC + c) * Kp + k] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = ty * 32 + tx; i < n_tickets; i += 256) tickets[i] = 0;
}

// A 3-D tensor map over wt [2][T * C][Kp] (K, then table t's column c at t *
// C + c, then hi / lo), boxes 16 x 256 x 2; 0 or hopper::encode_3d's error.
inline int encode_w_map(CUtensorMap* map, const float* wt, int T, int K, int C) {
  const int Kp = (K + 3) & ~3;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)T * C, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)T * C * Kp * 4};
  const cuuint32_t box[3] = {kBK, kBN, 2};
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wt, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_64B);
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

// Where one block's tile lies.  x's rows row0..row0 + 127 (rows >= N are
// zero-filled) against columns c0..c0 + 255 of C, K deep; w^T's column c0
// is row wc0 of the tensor map (t * C + c0 for table t).  The chain sums
// and split-K partials address the tile as rows vrow0.. of vN rows (the
// same as row0 and N when every row tile of x has a block); a row tile's
// rows past N there are scratch that nothing reads.
struct TileArgs {
  int row0, N, K, C, c0, wc0, vrow0, vN, slice, splits;
};

// The block's product, summed over its chains and (split-K) over the
// slices.  Returns, to the consumer threads of the block that holds the
// whole sum, the h tile [kBM][kHPitch] in shared memory (bias not added);
// returns nullptr to the producer threads and to the consumers of a block
// whose slice another block finishes.  Rows past N and columns past C of
// the tile are not defined.  The consumers' next barrier is consumer_sync.
// kVec: x's rows are 16-byte aligned (K % 4 == 0 and an aligned base), so
// x comes in by 16-byte copies; else by 4-byte ones.  kPRegs / kCRegs: the
// producer's and the consumers' setmaxnreg (a caller whose tile origin is
// not a function of blockIdx holds it in registers, and gives the producer
// more).  After the K loop the consumers read only the workspace rows
// (vrow0, vN), so nothing else of `a` stays live through it.
template <bool kVec, int kPRegs = kProducerRegs, int kCRegs = kConsumerRegs>
__device__ __forceinline__ float* gemm_tile(uint8_t* smem_raw, const CUtensorMap* tm_w,
                                            const float* __restrict__ x, const TileArgs& a,
                                            float* __restrict__ partial,
                                            float* __restrict__ chains, int* ticket) {
  const uint32_t base = smem_u32(smem_raw);
  // stage s at sS + s * kStageBytes: w^T hi, w^T lo, x hi, x lo
  const uint32_t sS = (base + 1023u) & ~1023u;
  const uint32_t sR = sS + kStages * kStageBytes;  // raw x tile r at + r * kRawBytes
  const uint32_t bar_full = sR + kRaw * kRawBytes;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  volatile int* last = reinterpret_cast<volatile int*>(smem_raw + (bar_empty + 8 * kStages - base));

  const int N = a.N, K = a.K, C = a.C, row0 = a.row0, c0 = a.c0;
  const int slice = a.slice, splits = a.splits;
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
    static_assert(kProducers * kPRegs + kConsumers * kCRegs <= 65536, "the SM's registers");
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPRegs));
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
        tma_load_3d(stage, tm_w, bar_full + 8 * s, (kt0 + n) * kBK, a.wc0, 0);
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
    return nullptr;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kCRegs));
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
  // instruction may write it while a wgmma is in flight); the end adds the
  // chains in order to the last one.
  // this thread's rows in the workspaces: register i holds vb if i & 2
  const int va = a.vrow0 + xr, vb = va + 8;
  const int vN = a.vN;
  const int max_chains = ((k_tiles + splits - 1) / splits - 1) / kChainTiles;  // stored a slice
  auto store_chain = [&](int q) {
    float* slot = chains + ((size_t)slice * max_chains + q) * vN * C;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = (i & 2) ? vb : va, col = c0 + 8 * (i >> 2) + 2 * t4;
      if (row < vN && col < C)
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
  // Both warpgroups are done with the ring (every stage they read has been
  // consumed), so the h tile reuses it and the accumulator leaves the
  // registers at once.
  float* hs = reinterpret_cast<float*>(smem_raw + (sS - base));  // [kBM][kHPitch]
  consumer_sync();
#pragma unroll
  for (int i = 0; i < 128; ++i)
    hs[(xr + 8 * ((i >> 1) & 1)) * kHPitch + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];
  consumer_sync();

  // From here each thread owns column quad cq (columns 4 cq..4 cq + 3) of
  // rows ct / 64, + 4, ...: float4 traffic to device memory.
  const int vrow0 = a.vrow0;
  const int rows = min(kBM, vN - vrow0), cols = min(kBN, C - c0);
  const int c4 = 4 * (ct % 64);
  const bool mine = c4 < cols;  // cols is a multiple of 8: a quad is in or out
  const int n_chains = (n_tiles - 1) / kChainTiles;  // chains stored before the last
  // h tile = ((last chain + chain 0) + chain 1) + ...: one chain at a time,
  // so that a thread's loads of many rows are in flight together
  for (int z = 0; z < n_chains && mine; ++z) {
    const float* chain = chains + ((size_t)slice * max_chains + z) * vN * C;
#pragma unroll 4
    for (int m = ct / 64; m < rows; m += kConsumers / 64) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(chain + (size_t)(vrow0 + m) * C + c0 + c4));
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
      __stcg(reinterpret_cast<float4*>(partial + ((size_t)slice * vN + vrow0 + m) * C + c0 + c4),
             make_float4(t[0], t[1], t[2], t[3]));
    }
    __threadfence();
    consumer_sync();
    if (ct == 0) *last = atomicAdd(ticket, 1) == splits - 1;
    consumer_sync();
    if (!*last) return nullptr;
    __threadfence();
    for (int m = ct / 64; m < rows && mine; m += kConsumers / 64) {
      float* t = hs + m * kHPitch + c4;
      const float4* p = reinterpret_cast<const float4*>(partial + (size_t)(vrow0 + m) * C + c0 + c4);
      const size_t slice_stride = (size_t)vN * C / 4;
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
  return hs;
}

}  // namespace split_tf32
