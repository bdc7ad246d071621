// AdamW over a whole parameter tree in two launches for Hopper (sm_90a):
// the unfactored update of optim/adamw.py with its global-norm clip.
//
// Replaces no TPU kernel.  The JAX package leaves the update to XLA, which
// fuses it into the jitted step; the port ran it eagerly, leaf by leaf, as
// about 17 elementwise launches a leaf plus a clone of every state leaf and
// a norm of three launches a leaf: ~1,730 launches an R-GAT step (66
// leaves), each a few microseconds on the card and 10-25 of Python on the
// host, after three scalar copies to the card that each waited for the
// backward to drain.  The card sat idle while the host enqueued them.
//
// What bounds it on this card: bytes.  An element is read from HBM as g,
// p or its float32 master, m and v, and written as p, m, v (and the
// master): 28 bytes in float32, ~2 M elements (52 MB) an R-GAT step,
// 0.016 ms at 3.35 TB/s.  Pass 2 reads g again, but a tree's gradient
// (R-GAT's 7.5 MB) stays in the 50 MB L2 between the two launches.  The
// work is a few flops an element.
//
// Design:
//   * The leaves' pointers, sizes and dtypes travel in the kernel's
//     parameter struct (a __grid_constant__, read through the constant
//     bank), not in a table copied to the card; the learning rate is read
//     through a device pointer, always.  A tree wider than kMaxLeaves is split into
//     groups by the wrapper, one launch pair a group, all the norm launches
//     before the update launches.  Nothing is copied from pageable memory
//     and nothing waits for the host.
//   * Both passes walk the same leaf-aligned chunk table: chunk b of a group
//     belongs to the last leaf whose first chunk is <= b (a binary search
//     over the struct).  One block a chunk.
//   * Pass 1 (adamw_norm_partials): a block writes its chunk's sum of
//     squares of g, float32, to its own slot, and marks the slot that opens
//     a leaf.  No atomics: the step is bitwise repeatable.  The lead group's
//     block 0 also writes count_out = count_in + 1 (in place when they are
//     one tensor).
//   * Pass 2 (adamw_update): every block reduces all the slots in one fixed
//     order, leaf by leaf in tree order as global_norm sums them (a leaf's
//     chunks in order, then the leaves one after another), derives the clip
//     scale and the bias corrections from count_out on the card, and
//     applies the reference's arithmetic to its chunk element by element,
//     each operation rounded as PyTorch's elementwise kernels round it
//     (the _rn intrinsics keep nvcc from contracting products into FMAs).
//     The lead group's block 0 writes the norm.
//   * Out of place or in place: the wrapper passes output pointers equal to
//     the inputs for the in-place step; each element is read and written by
//     one thread, so no scratch is needed beyond the slots.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // slots pass 2 stages in shared memory at a time

enum : long long { kParamBf16 = 1, kGradBf16 = 2, kMaster = 4 };

struct Leaf {  // 12 words, as kernels/fused_adamw.py packs them
  const void* p;
  const void* g;
  const void* m;
  const void* v;
  const float* master;  // null: the base is p
  void* p_out;
  void* m_out;
  void* v_out;
  float* master_out;
  long long n;            // elements
  long long first_chunk;  // the group's chunk index of its first chunk
  long long flags;        // kParamBf16 | kGradBf16 | kMaster
};
static_assert(sizeof(Leaf) == 12 * 8, "Leaf is 12 words");

struct Hyper {  // float32 as PyTorch takes a Python scalar: rounded from the double
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, clip;
};

// the widest parameter struct that fits Hopper's 32,764 bytes of kernel
// parameters (CUDA 12.1+)
constexpr int kMaxLeaves = 300;

struct Args {
  float* part;          // [n_slots] sums of squares, every group's chunks
  int* opens;           // [n_slots] 1 where the slot is its leaf's first chunk
  const int* count_in;
  int* count_out;
  const float* lr;
  float* gnorm;
  long long n_slots, slot0, chunk;
  int n_leaves, n_chunks, mom_bf16, lead;
  Hyper hp;
  Leaf leaves[kMaxLeaves];
};
static_assert(sizeof(Args) <= 32764, "the struct under 32,764 bytes");

__device__ __forceinline__ const Leaf& leaf_of(const Args& a, long long b) {
  int lo = 0, hi = a.n_leaves - 1;  // the last leaf whose first chunk is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.leaves[mid].first_chunk <= b) lo = mid; else hi = mid - 1;
  }
  return a.leaves[lo];
}

__device__ __forceinline__ float load(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float x, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(p)[i] = x;
}

// torch.clamp keeps a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__global__ void __launch_bounds__(kThreads) adamw_norm_partials(const __grid_constant__ Args a) {
  const long long b = blockIdx.x;
  if (a.lead && b == 0 && threadIdx.x == 0) *a.count_out = *a.count_in + 1;
  if (b >= a.n_chunks) return;
  const Leaf& L = leaf_of(a, b);
  const long long c = b - L.first_chunk, lo = c * a.chunk;
  const long long hi = min(lo + a.chunk, L.n);
  const bool gb = L.flags & kGradBf16;
  float acc = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float x = load(L.g, i, gb);
    acc = fmaf(x, x, acc);
  }
  __shared__ float red[kThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.part[a.slot0 + b] = red[0];
    a.opens[a.slot0 + b] = c == 0;
  }
}

__global__ void __launch_bounds__(kThreads) adamw_update(const __grid_constant__ Args a) {
  __shared__ float s_part[kTile];
  __shared__ int s_opens[kTile];
  __shared__ float s_norm;
  // the global norm: each leaf's chunks in order, then the leaves in order
  float total = 0.f, leaf = 0.f;  // thread 0's
  for (long long t0 = 0; t0 < a.n_slots; t0 += kTile) {
    const int n = (int)min((long long)kTile, a.n_slots - t0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_part[i] = a.part[t0 + i];
      s_opens[i] = a.opens[t0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        if (s_opens[i]) {
          total = __fadd_rn(total, leaf);
          leaf = 0.f;
        }
        leaf = __fadd_rn(leaf, s_part[i]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) s_norm = __fsqrt_rn(__fadd_rn(total, leaf));
  __syncthreads();
  const float norm = s_norm;
  const long long b = blockIdx.x;
  if (a.lead && b == 0 && threadIdx.x == 0) *a.gnorm = norm;
  if (b >= a.n_chunks) return;

  const Hyper& hp = a.hp;
  // scale = clamp(clip / clamp(norm, min=1e-9), max=1): PyTorch takes a
  // number over a tensor as reciprocal(tensor) * number
  const float scale = clamp_max(__fmul_rn(__frcp_rn(clamp_min(norm, 1e-9f)), hp.clip), 1.0f);
  const float cf = (float)*a.count_out;
  const float c1 = __fsub_rn(1.0f, powf(hp.b1, cf));
  const float c2 = __fsub_rn(1.0f, powf(hp.b2, cf));
  const float lr = *a.lr;

  const Leaf& L = leaf_of(a, b);
  const long long lo = (b - L.first_chunk) * a.chunk;
  const long long hi = min(lo + a.chunk, L.n);
  const bool pb = L.flags & kParamBf16, gb = L.flags & kGradBf16, master = L.flags & kMaster;
  const bool mb = a.mom_bf16;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    // optim/adamw.py's _adamw_leaf, operation by operation
    const float g = __fmul_rn(load(L.g, i, gb), scale);
    const float m = __fadd_rn(__fmul_rn(hp.b1, load(L.m, i, mb)), __fmul_rn(hp.one_minus_b1, g));
    const float v = __fadd_rn(__fmul_rn(hp.b2, load(L.v, i, mb)),
                              __fmul_rn(__fmul_rn(hp.one_minus_b2, g), g));
    const float mhat = __fdiv_rn(m, c1);
    const float vhat = __fdiv_rn(v, c2);
    const float base = master ? L.master[i] : load(L.p, i, pb);
    const float step = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hp.eps)),
                                 __fmul_rn(hp.weight_decay, base));
    const float next = __fsub_rn(base, __fmul_rn(lr, step));
    store(L.p_out, i, next, pb);
    store(L.m_out, i, m, mb);
    store(L.v_out, i, v, mb);
    if (master) L.master_out[i] = next;
  }
}

}  // namespace

// One launch of a group: pass 0 the norm partials, pass 1 the update.
// ``leaves``: n_leaves rows of 12 int64 words (struct Leaf); ``hyper``:
// b1, 1 - b1, b2, 1 - b2, eps, weight_decay, grad_clip (host floats);
// ``lr``: a float32 on the card.
extern "C" int fused_adamw_launch(int pass, const long long* leaves, int n_leaves, int n_chunks,
                                  long long chunk, long long slot0, long long n_slots, void* part,
                                  void* opens, const int* count_in, int* count_out,
                                  const float* lr, const float* hyper, float* gnorm,
                                  int mom_bf16, int lead, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_chunks < 0 || chunk < 1 || pass < 0 ||
      pass > 1 || lr == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  std::memset(&a, 0, sizeof(a));
  a.part = static_cast<float*>(part);
  a.opens = static_cast<int*>(opens);
  a.count_in = count_in;
  a.count_out = count_out;
  a.lr = lr;
  a.gnorm = gnorm;
  a.n_slots = n_slots;
  a.slot0 = slot0;
  a.chunk = chunk;
  a.n_leaves = n_leaves;
  a.n_chunks = n_chunks;
  a.mom_bf16 = mom_bf16;
  a.lead = lead;
  std::memcpy(&a.hp, hyper, sizeof(Hyper));
  std::memcpy(a.leaves, leaves, n_leaves * sizeof(Leaf));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks > 0 ? n_chunks : 1);
  if (pass == 0) adamw_norm_partials<<<grid, kThreads, 0, s>>>(a);
  else adamw_update<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int fused_adamw_max_leaves() { return kMaxLeaves; }

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
