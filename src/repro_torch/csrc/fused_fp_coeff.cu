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
// What bounds it on this card: arithmetic.  R-GAT's layer-0 projection of
//   IMDB's actors (6,124 x 3,341 -> 256) is 2*N*Din*H*Dh = 1.05e10 flops
//   against 92 MB of operands: 114 flops a byte, above the card's float32
//   ridge.  The products run in float32 on the CUDA cores (67 TFLOP/s
//   peak): TF32 would not keep the port's float32 tolerances.
//
// Design (simple and right first; no wgmma, TMA or pipelining):
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
//     zero-filled, the stores bounds-checked.  Rows of x have an odd stride
//     on real graphs (3,341 or 3,489 elements) and are not 16-byte aligned,
//     so x and w are read with scalar loads (consecutive threads on
//     consecutive addresses) and converted to float32 on the way into
//     shared memory.
//   * Epilogue: acc + b goes to a padded float32 tile in shared memory
//     (reusing the GEMM tiles' space); one thread per (row, head, side)
//     takes theta from it in d order, then the tile is written out
//     coalesced in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
