// Oblivious-GBDT inference on Hopper (sm_90a): CARAT's candidate scoring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdt_infer/kernel.py
// (_gbdt_kernel, launched by gbdt_logits_pallas), which gathers split
// features with a one-hot matmul on the MXU and selects leaves with a
// dense (1-b, b) expansion: choices for a chip without fast gathers.
// Here a warp gathers from shared memory, one tree at a time for 32
// lanes.
//
// The contract is the order of the sum: NumPy's pairwise summation over
// the T float32 tree contributions of a row, which makes both kernels
// bit-identical to ObliviousGBDT.decision_function. That order splits
// the trees into leaf blocks of at most 128 (halving above 128 at a
// multiple of 8); a block of >= 8 trees is summed by 8 accumulators over
// strided trees, combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then
// its tail in sequence; a block of < 8 is a fold from 0.0f; NumPy's
// reduction then adds the total to its identity 0.0. Every accumulator
// is an independent chain of at most 16 trees. kernel.py's pairwise_plan
// writes that decomposition as a small int32 table from the tree count
// alone, and both kernels follow it. Build without --use_fast_math: the
// kernels only compare and add, in that order.
//
// What bounds them: neither moves bytes or does arithmetic worth counting
// (a compare per split, an add per tree); the roofline bound of a
// bootstrap pick is 11 ns. What costs is on-chip loads: every tree of
// every row needs its D splits, D features and a leaf, each a dependent
// load, so a kernel is bound by the load chains' latency where it has
// little work and by the SM's shared-memory issue (one 128-byte
// wavefront a clock) where it has much.
//
// gbdt_logits: (N, F) rows -> f32(base) + sum over trees. A thread per
//   row through all T trees (the simple design) leaves the 63 rows of a
//   bootstrap pick to one block whose threads each walk a chain of ~200
//   trees of dependent loads. Instead a block takes a tile of 64 rows (2
//   per lane) and gives each of NumPy's chains to its own warp: 184 trees
//   are 16 chains of 11-12 trees on 16 warps. With lanes on rows and the
//   warp on one tree, a split is a broadcast, a feature read is a
//   conflict-free read of the tile staged transposed (x_s[f][row],
//   padded), and the leaf gather stays inside the tree's 2^D leaves (one
//   row of 32 banks at D = 5). The model is staged once per block, each
//   split as one 8-byte {feature offset, threshold} word; trees of depth
//   <= 8 run in kernels of their own depth, so a tree unrolls fully and
//   consecutive trees' loads overlap. A chain accumulates in registers
//   and stores one partial per row; after one barrier a thread per row
//   folds each leaf block's partials in registers, then the blocks on a
//   stack in the recursion's order. At fleet batches a persistent grid
//   walks the tiles, staging the next tile's rows under the fold; per
//   warp-tree 3D + 2 wavefronts (17 at D = 5) for 64 rows. Deep trees or
//   wide rows that do not fit in shared memory are read through L1.
//
// gbdt_grid_logits: the factorized fleet path (the twin of the
//   reference's GridGBDTScorer._predict_numpy): per (client, candidate)
//   the leaf index of tree t is a client half (evaluated here) plus the
//   candidate's precomputed half idx_theta[c][t] (which carries the
//   tree's offset into leaf_flat). A block per client with a thread per
//   candidate (the simple design) reads idx_theta[c][t] 736 bytes from
//   its neighbour's (a line per lane) and gathers leaves through L1.
//   Instead a persistent grid walks units of (4 x the block's candidate
//   groups) clients x (a chunk of up to 256 candidates). Each block stages
//   idx_theta transposed (idx_theta_s[t][c]: lanes on candidates read
//   consecutive words), the splits and the leaf table: once per block
//   where the whole model fits (the path's 184- and 223-tree models),
//   else one leaf block at a time (1000 trees: idx_theta alone is
//   252 KB). All lanes of a warp are on one tree, so the leaf gather
//   stays inside that tree's 32 leaves: 32 banks, no replay. A thread
//   takes one candidate of 4 clients, so each idx_theta_s load serves 4
//   pairs; the clients' halves are broadcasts, 4 trees a 16-byte load.
//   Per (client, candidate, tree): 1.5 shared-memory wavefronts per warp
//   and no device-memory traffic. Each thread keeps NumPy's 8
//   accumulators per leaf block and folds the block sums on a small
//   stack in shared memory, in the recursion's order; deep trees (leaves
//   too large to stage) gather through L1.
//
// Both grids are functions of the shapes alone (kernel.py's
// logits_geometry and grid_geometry; the launch lowers a persistent grid
// to what the build's registers let the SMs hold): no host read of
// device data, so either call can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// rows of x a gbdt_logits tile holds: 32 lanes x kRowsPerLane
constexpr int kRowsPerLane = 2;
constexpr int kTileRows = 32 * kRowsPerLane;
// padded row stride of the transposed tile x_s[f][row]
constexpr int kXStride = kTileRows + 1;
// threads of a gbdt_grid_logits block, and the clients each takes
constexpr int kGridThreads = 256;
constexpr int kGridClients = 4;
// how a gbdt_logits chain starts (kernel.py's CHAIN_*): from its first
// term, or storing every term in its own slot (a block's tail, added one
// by one when the slots fold); any other mode (CHAIN_FROM_ZERO, a leaf
// block of < 8 trees) starts from 0.0f
constexpr int kFromFirst = 0;
constexpr int kTerms = 2;
// depths with kernels of their own (kDepth), whose trees unroll fully so
// that consecutive trees' loads overlap; other depths take kDepth = 0
constexpr int kMaxFixedDepth = 8;

// shared-memory sections start 16-byte aligned: sizes in 4-byte words
// are rounded up to 4 (kernel.py's _pad4)
__host__ __device__ constexpr int pad4(int words) { return (words + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `words` 4-byte words from global `src` to shared `dst` by the whole
// block, issued without waiting (16 bytes a copy where both are aligned);
// the caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void copy_to_shared(void* dst, const void* src,
                                               int words) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if (((smem_addr(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    done = words & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * blockDim.x)
      cp_async16(d + 4 * i, s + 4 * i);
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x)
    cp_async4(d + 4 * i, s + 4 * i);
}

// Leaf index of one tree of depth D (kDepth, or `depth` where kDepth is
// 0): bit D-1-l is value(k, offset_l) > threshold_l, level 0 the MSB;
// split(l, offset, threshold) gives level l's split.
template <int kDepth, int kN, class Split, class Value>
__device__ __forceinline__ void tree_index(int depth, Split split,
                                           Value value, int (&idx)[kN]) {
  const int d = kDepth > 0 ? kDepth : depth;
#pragma unroll
  for (int k = 0; k < kN; ++k) idx[k] = 0;
#pragma unroll
  for (int l = 0; l < d; ++l) {
    int off;
    float th;
    split(l, off, th);
#pragma unroll
    for (int k = 0; k < kN; ++k)
      idx[k] = (idx[k] << 1) | (value(k, off) > th ? 1 : 0);
  }
}

// One tile's transposed rows into x_s (without waiting).
__device__ __forceinline__ void stage_rows(float* x_s, const float* x,
                                           int row0, int rows, int f) {
  const float* src = x + static_cast<size_t>(row0) * f;
  for (int i = threadIdx.x; i < rows * f; i += blockDim.x) {
    const int r = i / f;
    cp_async4(x_s + (i - r * f) * kXStride + r, src + i);
  }
}

// A load from shared memory, or through L1 from global memory.
template <bool kShared, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// NumPy's ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)).
__device__ __forceinline__ float combine8(const float (&r)[8]) {
  return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
}

// A persistent grid walks tiles of kTileRows rows; a tile's chains go to
// warps. kStageModel: the model staged once per block, each split as one
// 8-byte {feature offset into the row tile, threshold} word; else read
// through L1. kStageX: each tile's rows staged transposed, the next
// tile's copy issued under this one's fold; else read through L1.
template <int kDepth, bool kStageModel, bool kStageX>
__global__ void __launch_bounds__(1024)
    gbdt_logits_kernel(const float* __restrict__ x, int n, int f,
                       const int* __restrict__ feat,
                       const float* __restrict__ thr,
                       const float* __restrict__ leaf, int n_trees,
                       int depth, float base, const int* __restrict__ blocks,
                       int n_blocks, const int* __restrict__ chains,
                       int n_chains, int n_slots, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int d = kDepth > 0 ? kDepth : depth;
  float* slots = smem;                                     // [slot][row]
  float* x_s = slots + n_slots * kTileRows;                // [f][kXStride]
  int2* split_s = reinterpret_cast<int2*>(x_s + (kStageX ? pad4(f * kXStride)
                                                         : 0));  // [T][D]
  float* leaf_s = reinterpret_cast<float*>(split_s) + pad4(2 * n_trees * d);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x & 31;
  constexpr int kXMul = kStageX ? kXStride : 1;  // a feature's offset

  if constexpr (kStageModel) {
    copy_to_shared(leaf_s, leaf, n_trees << d);
#pragma unroll 4
    for (int i = threadIdx.x; i < n_trees * d; i += blockDim.x)
      split_s[i] = make_int2(__ldg(feat + i) * kXMul,
                             __float_as_int(__ldg(thr + i)));
  }
  int tile = blockIdx.x;
  if constexpr (kStageX) {
    if (tile < n_tiles)
      stage_rows(x_s, x, tile * kTileRows,
                 min(kTileRows, n - tile * kTileRows), f);
  }
  cp_async_wait_all();
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows;
    const int rows = min(kTileRows, n - row0);
    // lanes past `rows` compute on whatever the tile holds there (any
    // value gives an index inside the tree); their partials are never
    // read
    const float* xrow[kRowsPerLane];
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k)
      xrow[k] = x + static_cast<size_t>(row0 + min(lane + 32 * k,
                                                   rows - 1)) * f;
    auto value = [&](int k, int off) -> float {
      if constexpr (kStageX) {
        return x_s[off + lane + 32 * k];
      } else {
        return __ldg(xrow[k] + off);
      }
    };
    // leaf values of tree t for this lane's rows
    auto eval = [&](int t, float (&term)[kRowsPerLane]) {
      int idx[kRowsPerLane];
      const size_t at = static_cast<size_t>(t) * d;
      tree_index<kDepth>(
          d,
          [&](int l, int& off, float& th) {
            if constexpr (kStageModel) {
              const int2 sp = split_s[at + l];
              off = sp.x;
              th = __int_as_float(sp.y);
            } else {
              off = __ldg(feat + at + l) * kXMul;
              th = __ldg(thr + at + l);
            }
          },
          value, idx);
      const size_t lt = static_cast<size_t>(t) << d;
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k)
        term[k] =
            kStageModel ? leaf_s[lt + idx[k]] : __ldg(leaf + lt + idx[k]);
    };
    // one chain per warp at a time
    for (int c = threadIdx.x >> 5; c < n_chains; c += blockDim.x >> 5) {
      const int* ch = chains + 5 * c;
      const int first = __ldg(ch), count = __ldg(ch + 1),
                stride = __ldg(ch + 2), mode = __ldg(ch + 3),
                slot = __ldg(ch + 4);
      float term[kRowsPerLane];
      if (mode == kTerms) {
        for (int i = 0; i < count; ++i) {
          eval(first + i * stride, term);
#pragma unroll
          for (int k = 0; k < kRowsPerLane; ++k)
            slots[(slot + i) * kTileRows + lane + 32 * k] = term[k];
        }
        continue;
      }
      float acc[kRowsPerLane];
      int i = 0;
      if (mode == kFromFirst) {
        eval(first, acc);
        i = 1;
      } else {  // CHAIN_FROM_ZERO
#pragma unroll
        for (int k = 0; k < kRowsPerLane; ++k) acc[k] = 0.0f;
      }
#pragma unroll 4
      for (; i < count; ++i) {
        eval(first + i * stride, term);
#pragma unroll
        for (int k = 0; k < kRowsPerLane; ++k) acc[k] += term[k];
      }
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k)
        slots[slot * kTileRows + lane + 32 * k] = acc[k];
    }
    __syncthreads();
    if constexpr (kStageX) {  // x_s is free: fetch the next tile's rows
      const int next = tile + gridDim.x;
      if (next < n_tiles)
        stage_rows(x_s, x, next * kTileRows,
                   min(kTileRows, n - next * kTileRows), f);
    }
    // fold, a thread per row: each leaf block's 8 partials and its tail
    // (a block of < 8 trees is one chain, already folded from 0.0f), the
    // block sums on a stack merged in the plan's order. The stack lives
    // in slots 0.. (leaf block 0's, read before anything is pushed; the
    // plan's stack is never deeper than block 0 has slots). The sum ends
    // in slot 0, and NumPy's reduction adds it to its identity 0.0.
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      int sp = 0;
      for (int b = 0; b < n_blocks; ++b) {
        const int len = __ldg(blocks + 4 * b + 1);
        const float* sl = slots + __ldg(blocks + 4 * b + 2) * kTileRows + r;
        float res = sl[0];
        if (len >= 8) {
          float p[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) p[j] = sl[j * kTileRows];
          res = combine8(p);
          for (int i = 0; i < (len & 7); ++i) res += sl[(8 + i) * kTileRows];
        }
        slots[sp++ * kTileRows + r] = res;
        for (int m = __ldg(blocks + 4 * b + 3); m > 0; --m) {
          --sp;
          slots[(sp - 1) * kTileRows + r] += slots[sp * kTileRows + r];
        }
      }
      out[row0 + r] = base + (0.0f + slots[r]);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile's rows are in; the slots are free
  }
}

// NumPy's sums of one leaf block of `len` <= 128 trees for kC clients of
// one candidate: th walks idx_theta_s down the block's trees (row stride
// `stride`), si the first client's halves (the next client's
// `si_stride` further; 16-byte aligned: leaf blocks start at multiples
// of 8), leaves is the staged window or leaf_flat. Each idx_theta_s load
// serves the kC clients.
template <bool kStageLeaves, int kC>
__device__ __forceinline__ void grid_block_sums(const int* th, int stride,
                                                const int* si, int si_stride,
                                                const float* leaves, int len,
                                                float (&res)[kC]) {
  auto gather = [&](int i) { return ld<kStageLeaves>(leaves + i); };
  if (len < 8) {
#pragma unroll
    for (int j = 0; j < kC; ++j) res[j] = 0.0f;
    for (int t = 0; t < len; ++t) {
      const int tv = th[t * stride];
#pragma unroll
      for (int j = 0; j < kC; ++j)
        res[j] += gather(tv + si[j * si_stride + t]);
    }
    return;
  }
  // trees t .. t+7 into the 8 accumulators of each client (the first
  // eight start them)
  float r[kC][8];
  auto eight = [&](int t, bool first) {
    int tv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) tv[u] = th[(t + u) * stride];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int* sj = si + j * si_stride + t;
      const int4 s0 = *reinterpret_cast<const int4*>(sj);
      const int4 s1 = *reinterpret_cast<const int4*>(sj + 4);
      const int sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float v = gather(tv[u] + sv[u]);
        r[j][u] = first ? v : r[j][u] + v;
      }
    }
  };
  const int m = len - len % 8;
  eight(0, true);
  for (int t = 8; t < m; t += 8) eight(t, false);
#pragma unroll
  for (int j = 0; j < kC; ++j) res[j] = combine8(r[j]);
  for (int t = m; t < len; ++t) {
    const int tv = th[t * stride];
#pragma unroll
    for (int j = 0; j < kC; ++j) res[j] += gather(tv + si[j * si_stride + t]);
  }
}

// kResident: the whole model (idx_theta_s, the split features and
// thresholds, the leaves) is staged once per block; else one leaf block
// at a time. kStageLeaves: leaves in shared memory, else gathered
// through L1. A thread takes one candidate of kGridClients clients.
// kDepth: the trees' depth, or 0 (read from `depth`).
template <int kDepth, bool kResident, bool kStageLeaves>
__global__ void __launch_bounds__(kGridThreads)
    gbdt_grid_logits_kernel(const float* __restrict__ h, int n, int f_h,
                            const int* __restrict__ cfeat,
                            const float* __restrict__ thr,
                            const int* __restrict__ idx_theta, int n_cand,
                            const float* __restrict__ leaf_flat, int n_trees,
                            int depth, const int* __restrict__ blocks,
                            int n_blocks, int stack_depth, int cand_width,
                            int window, float* __restrict__ out) {
  constexpr int kC = kGridClients;
  extern __shared__ __align__(16) int gsmem[];
  const int d = kDepth > 0 ? kDepth : depth;
  const int stride = cand_width + 1;        // padded: transposing copies
  const int groups = kGridThreads / cand_width;
  const int per_pass = groups * kC;
  int* theta_s = gsmem;                                  // [window][stride]
  int* s_idx = theta_s + pad4(window * stride);          // [pass][window]
  int* cfeat_s = s_idx + per_pass * window;              // [window][D]
  float* thr_s = reinterpret_cast<float*>(cfeat_s + pad4(window * d));
  float* stack = thr_s + pad4(window * d);  // [stack_depth][kC][threads]
  float* leaf_s = stack + stack_depth * kC * kGridThreads;  // [window << D]
  const float* leaves = kStageLeaves ? leaf_s : leaf_flat;
  const int n_chunks = (n_cand + cand_width - 1) / cand_width;
  const int n_units = (n + per_pass - 1) / per_pass * n_chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / cand_width, cl = tid - g * cand_width;

  // trees [w_lo, w_lo + w_len) of candidates [c0, c0 + cand_width): their
  // idx_theta columns transposed, split features, thresholds and leaves;
  // the caller syncs. A column past n_cand holds tree w_lo's offset: a
  // valid index, never written out.
  auto stage = [&](int w_lo, int w_len, int c0) {
    for (int c = warp; c < cand_width; c += kGridThreads / 32) {
      const int* src =
          idx_theta + static_cast<size_t>(c0 + c) * n_trees + w_lo;
      for (int t = lane; t < w_len; t += 32) {
        if (c0 + c < n_cand)
          cp_async4(theta_s + t * stride + c, src + t);
        else
          theta_s[t * stride + c] = w_lo << d;
      }
    }
    copy_to_shared(cfeat_s, cfeat + static_cast<size_t>(w_lo) * d, w_len * d);
    copy_to_shared(thr_s, thr + static_cast<size_t>(w_lo) * d, w_len * d);
    if constexpr (kStageLeaves)
      copy_to_shared(leaf_s, leaf_flat + (static_cast<size_t>(w_lo) << d),
                     w_len << d);
    cp_async_wait_all();
  };

  if constexpr (kResident) {
    stage(0, n_trees, 0);
    __syncthreads();
  }
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int group = u / n_chunks;
    const int p0 = group * per_pass, c0 = (u - group * n_chunks) * cand_width;
    int sp = 0;  // the fold's stack of block sums, NumPy's recursion
    for (int b = 0; b < n_blocks;) {
      const int w_lo = __ldg(blocks + 4 * b);
      const int b_end = kResident ? n_blocks : b + 1;
      const int w_len = kResident ? n_trees : __ldg(blocks + 4 * b + 1);
      if constexpr (!kResident) {
        __syncthreads();  // the last stage's readers are done
        stage(w_lo, w_len, c0);
        __syncthreads();
      }
      // client half of every tree in the window, for this pass's clients,
      // less the staged leaves' offset (idx_theta carries the tree's
      // offset into leaf_flat); a client past n takes bits 0
      const int rebase = kStageLeaves ? (w_lo << d) : 0;
      for (int i = tid; i < per_pass * w_len; i += kGridThreads) {
        const int q = i / w_len, t = i - q * w_len;
        const float* hr = h + static_cast<size_t>(min(p0 + q, n - 1)) * f_h;
        int idx[1];
        tree_index<kDepth>(
            d,
            [&](int l, int& off, float& th) {
              off = cfeat_s[t * d + l];  // -1: a candidate split
              th = thr_s[t * d + l];
            },
            [&](int, int fl) {
              return fl >= 0 ? __ldg(hr + fl) : -__int_as_float(0x7f800000);
            },
            idx);
        s_idx[q * window + t] = (p0 + q < n ? idx[0] : 0) - rebase;
      }
      __syncthreads();
      for (; b < b_end; ++b) {
        const int lo = __ldg(blocks + 4 * b) - w_lo;
        float res[kC];
        grid_block_sums<kStageLeaves>(theta_s + lo * stride + cl, stride,
                                      s_idx + g * kC * window + lo, window,
                                      leaves, __ldg(blocks + 4 * b + 1), res);
#pragma unroll
        for (int j = 0; j < kC; ++j)
          stack[(sp * kC + j) * kGridThreads + tid] = res[j];
        ++sp;
        // merge the top two sums as often as NumPy's recursion closes
        // here (each thread its own column: no barrier)
        for (int m = __ldg(blocks + 4 * b + 3); m > 0; --m) {
          --sp;
#pragma unroll
          for (int j = 0; j < kC; ++j)
            stack[((sp - 1) * kC + j) * kGridThreads + tid] +=
                stack[(sp * kC + j) * kGridThreads + tid];
        }
      }
    }
    // the sum is the stack's bottom; NumPy's reduction adds it to its
    // identity 0.0
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int client = p0 + g * kC + j;
      if (client < n && c0 + cl < n_cand)
        out[static_cast<size_t>(client) * n_cand + c0 + cl] =
            0.0f + stack[j * kGridThreads + tid];
    }
    __syncthreads();  // s_idx is rewritten by the next unit
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch a grid of at most `blocks` blocks, and no more than the card
// runs at once (the blocks per SM this build's registers and `smem`
// allow, times the SMs): a host query of the kernel and the card, never
// of device data.
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int blocks, int threads, size_t smem,
           void* stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm > 0 && blocks > per_sm * sms) blocks = per_sm * sms;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for a depth: its own for 1..kMaxFixedDepth, else kDepth 0.
// Only the variant of the path's shapes (Fast) is specialized by depth.
template <template <int> class Fast, class Fn>
Fn by_depth(int depth, Fn generic) {
  switch (depth) {
    case 1: return Fast<1>::fn();
    case 2: return Fast<2>::fn();
    case 3: return Fast<3>::fn();
    case 4: return Fast<4>::fn();
    case 5: return Fast<5>::fn();
    case 6: return Fast<6>::fn();
    case 7: return Fast<7>::fn();
    case 8: return Fast<8>::fn();
    default: return generic;
  }
}
static_assert(kMaxFixedDepth == 8, "by_depth lists depths 1..8");

template <int kDepth>
struct StagedLogits {
  static auto fn() { return gbdt_logits_kernel<kDepth, true, true>; }
};
template <int kDepth>
struct ResidentGrid {
  static auto fn() { return gbdt_grid_logits_kernel<kDepth, true, true>; }
};

}  // namespace

extern "C" {

int gbdt_tile_rows() { return kTileRows; }
int gbdt_grid_threads() { return kGridThreads; }
int gbdt_grid_clients() { return kGridClients; }

// Launch on `stream` with the geometry of kernel.py's logits_geometry;
// returns the launch's cudaError_t (0 on success).
int gbdt_logits_launch(const float* x, int n, int f, const int* feat,
                       const float* thr, const float* leaf, int n_trees,
                       int depth, float base, const int* pblocks,
                       int n_pblocks, const int* chains, int n_chains,
                       int n_slots, int blocks, int threads, int stage_model,
                       int stage_x, int smem, float* out, void* stream) {
  auto kernel =
      stage_model
          ? (stage_x ? by_depth<StagedLogits>(
                           depth, gbdt_logits_kernel<0, true, true>)
                     : gbdt_logits_kernel<0, true, false>)
          : (stage_x ? gbdt_logits_kernel<0, false, true>
                     : gbdt_logits_kernel<0, false, false>);
  return launch(kernel, blocks, threads, smem, stream, x, n, f, feat, thr,
                leaf, n_trees, depth, base, pblocks, n_pblocks, chains,
                n_chains, n_slots, out);
}

// Launch on `stream` with the geometry of kernel.py's grid_geometry.
int gbdt_grid_logits_launch(const float* h, int n, int f_h, const int* cfeat,
                            const float* thr, const int* idx_theta,
                            int n_cand, const float* leaf_flat, int n_trees,
                            int depth, const int* pblocks, int n_pblocks,
                            int stack_depth, int cand_width, int window,
                            int resident, int stage_leaves, int blocks,
                            int smem, float* out, void* stream) {
  auto kernel =
      resident
          ? (stage_leaves ? by_depth<ResidentGrid>(
                                depth, gbdt_grid_logits_kernel<0, true, true>)
                          : gbdt_grid_logits_kernel<0, true, false>)
          : (stage_leaves ? gbdt_grid_logits_kernel<0, false, true>
                          : gbdt_grid_logits_kernel<0, false, false>);
  return launch(kernel, blocks, kGridThreads, smem, stream, h, n, f_h, cfeat,
                thr, idx_theta, n_cand, leaf_flat, n_trees, depth, pblocks,
                n_pblocks, stack_depth, cand_width, window, out);
}

}  // extern "C"
