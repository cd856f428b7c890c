// Oblivious-GBDT inference on Hopper (sm_90a): CARAT's candidate scoring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdt_infer/kernel.py
// (_gbdt_kernel, launched by gbdt_logits_pallas), which gathers split
// features with a one-hot matmul on the MXU and selects leaves with a
// dense (1-b, b) expansion: choices for a chip without fast gathers.
// Here a thread gathers directly.
//
// Two entry points:
//
// * gbdt_logits: one thread per (N, F) float32 row; the model (feat,
//   thr, leaf) is staged once per block in shared memory (67,200 bytes
//   at 400 trees of depth 5, so dynamic shared memory above 48 KB).
//   Output f32(base) + sum over trees.
// * gbdt_grid_logits: the factorized fleet path (the twin of the
//   reference's GridGBDTScorer._predict_numpy). One block per client:
//   its threads first evaluate the client half of every split into a
//   per-tree partial leaf index in shared memory, then one thread per
//   candidate adds the candidate's precomputed partial index, gathers
//   the leaf value and sums over the trees. Output (n, C) without base.
//
// What bounds them: neither does arithmetic worth counting (a compare
// per split, an add per tree). gbdt_logits reads each row once
// (88 bytes at F = 22) and does T*(2D+1) shared-memory loads of the model
// per row; gbdt_grid_logits reads a 4-byte candidate index and gathers
// one leaf per (client, candidate, tree) from a table that stays in
// L1/L2. So at fleet-sized batches both are bound by on-chip loads, not
// by device memory; at the 63 rows of one bootstrap pick gbdt_logits is
// one block, bound by one thread's chain of dependent loads over the
// trees. This first version keeps every thread independent and simple;
// spreading a row's trees over a warp is the next step (PERF.md).
//
// The contract is the order of the sum: NumPy's pairwise summation over
// the T float32 tree contributions of a row (pairwise_sum below), which
// makes both kernels bit-identical to ObliviousGBDT.decision_function.
// Build without --use_fast_math: the kernels only compare and add, so
// nothing can be reassociated or contracted.

#include <cuda_runtime.h>

namespace {

// NumPy's PW_BLOCKSIZE, and the most splits above it that pairwise_sum
// unrolls (kernel.py's MAX_PAIRWISE_LEVELS checks the tree count).
constexpr int kPwBlock = 128;
constexpr int kMaxLevels = 5;

// Sum of term(lo .. lo+n-1) for n <= 128, in NumPy's order. Kept out of
// line: pairwise_sum below reaches it from up to 2^kMaxLevels call sites,
// and inlining every copy made the build take minutes.
template <class Term>
__device__ __noinline__ float pairwise_block(const Term& term, int lo,
                                             int n) {
  if (n < 8) {
    float res = 0.0f;
    for (int i = 0; i < n; ++i) res += term(lo + i);
    return res;
  }
  float r0 = term(lo + 0), r1 = term(lo + 1), r2 = term(lo + 2),
        r3 = term(lo + 3), r4 = term(lo + 4), r5 = term(lo + 5),
        r6 = term(lo + 6), r7 = term(lo + 7);
  const int m = n - (n % 8);
  int i = 8;
  for (; i < m; i += 8) {
    r0 += term(lo + i + 0);
    r1 += term(lo + i + 1);
    r2 += term(lo + i + 2);
    r3 += term(lo + i + 3);
    r4 += term(lo + i + 4);
    r5 += term(lo + i + 5);
    r6 += term(lo + i + 6);
    r7 += term(lo + i + 7);
  }
  float res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
  for (; i < n; ++i) res += term(lo + i);
  return res;
}

// NumPy's recursion: above 128 elements, split at n/2 rounded down to a
// multiple of 8 and add the two halves' sums.
template <int LEVELS, class Term>
__device__ float pairwise_sum(const Term& term, int lo, int n) {
  if constexpr (LEVELS == 0) {
    return pairwise_block(term, lo, n);
  } else {
    if (n <= kPwBlock) return pairwise_block(term, lo, n);
    int n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum<LEVELS - 1>(term, lo, n2) +
           pairwise_sum<LEVELS - 1>(term, lo + n2, n - n2);
  }
}

// Contribution of tree t to one cross-product row; model in shared memory.
struct RowTerm {
  const float* x;     // this row, global
  const int* feat;    // (T, D)
  const float* thr;   // (T, D)
  const float* leaf;  // (T, 2^D)
  int depth;
  __device__ __forceinline__ float operator()(int t) const {
    const int* f = feat + t * depth;
    const float* th = thr + t * depth;
    int idx = 0;
    for (int l = 0; l < depth; ++l)  // level 0 ends up as the MSB
      idx = (idx << 1) | (__ldg(x + f[l]) > th[l] ? 1 : 0);
    return leaf[(t << depth) + idx];
  }
};

__global__ void gbdt_logits_kernel(const float* __restrict__ x, int n, int f,
                                   const int* __restrict__ feat,
                                   const float* __restrict__ thr,
                                   const float* __restrict__ leaf,
                                   int n_trees, int depth, float base,
                                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int td = n_trees * depth;
  const int tl = n_trees << depth;
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thr = reinterpret_cast<float*>(s_feat + td);
  float* s_leaf = s_thr + td;
  for (int i = threadIdx.x; i < td; i += blockDim.x) {
    s_feat[i] = feat[i];
    s_thr[i] = thr[i];
  }
  for (int i = threadIdx.x; i < tl; i += blockDim.x) s_leaf[i] = leaf[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const RowTerm term{x + static_cast<size_t>(row) * f, s_feat, s_thr, s_leaf,
                     depth};
  out[row] = base + pairwise_sum<kMaxLevels>(term, 0, n_trees);
}

// Contribution of tree t to one (client, candidate) pair.
struct GridTerm {
  const float* leaf;       // (T * 2^D,), global
  const int* idx_client;   // (T,), shared: client half of the leaf index
  const int* idx_theta;    // (T,), global: candidate half + tree offset
  __device__ __forceinline__ float operator()(int t) const {
    return __ldg(leaf + idx_client[t] + __ldg(idx_theta + t));
  }
};

__global__ void gbdt_grid_logits_kernel(const float* __restrict__ h, int f_h,
                                        const int* __restrict__ cfeat,
                                        const float* __restrict__ thr,
                                        const int* __restrict__ idx_theta,
                                        int n_cand,
                                        const float* __restrict__ leaf_flat,
                                        int n_trees, int depth,
                                        float* __restrict__ out) {
  extern __shared__ int s_idx[];
  const int row = blockIdx.x;
  const float* hrow = h + static_cast<size_t>(row) * f_h;
  for (int t = threadIdx.x; t < n_trees; t += blockDim.x) {
    int idx = 0;
    for (int l = 0; l < depth; ++l) {
      const int cf = cfeat[t * depth + l];  // -1: a candidate split
      idx = (idx << 1) |
            ((cf >= 0 && hrow[cf] > thr[t * depth + l]) ? 1 : 0);
    }
    s_idx[t] = idx;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cand; c += blockDim.x) {
    const GridTerm term{leaf_flat, s_idx,
                        idx_theta + static_cast<size_t>(c) * n_trees};
    out[static_cast<size_t>(row) * n_cand + c] =
        pairwise_sum<kMaxLevels>(term, 0, n_trees);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

int gbdt_max_levels() { return kMaxLevels; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int gbdt_logits_launch(const float* x, int n, int f, const int* feat,
                       const float* thr, const float* leaf, int n_trees,
                       int depth, float base, float* out, void* stream) {
  const size_t smem =
      static_cast<size_t>(n_trees) * depth * (sizeof(int) + sizeof(float)) +
      (static_cast<size_t>(n_trees) << depth) * sizeof(float);
  cudaError_t err = allow_smem(gbdt_logits_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  gbdt_logits_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, n, f, feat, thr, leaf, n_trees, depth, base, out);
  return static_cast<int>(cudaGetLastError());
}

int gbdt_grid_logits_launch(const float* h, int n, int f_h, const int* cfeat,
                            const float* thr, const int* idx_theta,
                            int n_cand, const float* leaf_flat, int n_trees,
                            int depth, float* out, void* stream) {
  const size_t smem = static_cast<size_t>(n_trees) * sizeof(int);
  cudaError_t err = allow_smem(gbdt_grid_logits_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gbdt_grid_logits_kernel<<<n, 64, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      h, f_h, cfeat, thr, idx_theta, n_cand, leaf_flat, n_trees, depth, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
