// Decode attention on Hopper (sm_90a): one new token per sequence
// against its KV cache, the LM stack's serving step (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_dec_kernel, launched by decode_attention_pallas). There
// the grid (B*Hkv, S/BK) sweeps the cache in order on one core with the
// online-softmax carry in VMEM, the G = Hq/Hkv query heads of one kv
// group stacked into one (G, D) tile so each K/V block is read once per
// group.
//
// What it computes: for each query head h of kv-head h / G,
// softmax(scale * q_h k^T) v over the first lengths[b] cache positions;
// positions >= lengths[b] are masked and never read. Output in q's type,
// acc / max(l, 1e-30); with lengths[b] == 0 that is zeros, as in the
// Pallas kernel (the callers pass lengths >= 1, clamped to at most S).
// q and the output are float or bfloat16 whatever the cache's type
// (float or bfloat16): like the Pallas kernel, which casts q and each
// K/V block to float32, it serves a model in one type over a cache in
// another. The cache's type is a template parameter; q's is a runtime
// flag, read only when q is loaded and the output stored. Any D <= 256,
// any group size (groups above 8 heads take several blocks), K and V
// read through their strides with a dense last dim.
//
// What bounds it: decode reads every valid K and V element once and
// does 4 flops per element per query head; at G = 4 that is ~4 flops per
// byte, far below the H100's ridge, so the bound is device-memory
// bandwidth. The TPU's sequential sweep, carried over as one block per
// (batch, kv-head), gives 64 blocks at granite's decode batch of 8 on
// 132 SMs, each walking its whole cache with few loads in flight. So
// the cache is split (flash-decoding), by two kernels launched back to
// back on the stream by the one C entry point:
//
// * decode_split_kernel, grid (B*Hkv, group tiles, n_split): split s
//   covers cache positions [s * split_len, (s + 1) * split_len), cut at
//   lengths[b]. A block of 4 warps reads its K/V range once for the
//   (up to 8) query heads of its group tile, in tiles of 64 keys (32
//   for rows above 400 bytes) double-buffered into shared memory by
//   16-byte cp.async (scalar loads where the cache's rows or strides are
//   not 16-byte aligned). Thread j computes key j's logits for its heads
//   (q in shared memory as float32, read as broadcast float4s, the K
//   row as 16-byte vectors; rows padded to an odd number of 16-byte
//   chunks so neighbouring rows fall in distinct banks), each warp runs
//   the online softmax of up to two heads by shuffles, and thread t
//   accumulates P.V for one column pair of its heads, four keys at a
//   time (P read as float4). The products are float32 FMAs:
//   the work is bytes, not operations. Each split writes a float32
//   partial (m, l, acc[D]) per head to a workspace the wrapper
//   allocates; a split that lies wholly past lengths[b] reads nothing and
//   writes the empty partial (m = -1e30, l = 0, acc = 0).
// * decode_combine_kernel, one block per (batch, q-head): merges the
//   n_split partials in split order (deterministic from run to run) and
//   writes acc / max(l, 1e-30) in q's type.
//
// n_split is the wrapper's decode_splits, a function of the shapes only:
// the wrapper never reads lengths on the host, so the call can be
// captured in a CUDA graph. Build without --use_fast_math: expf must hold
// the float32 tolerance (2e-5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupTile = 8;
constexpr int kMaxSmemBytes = 232448;  // per block on Hopper
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* ws;   // (B*Hq, n_split) pairs (m, l), then (B*Hq, n_split, D) acc
  int q_bf16;  // q and o: 0 float32, 1 bfloat16
  int batch, hq, hkv, s, d;
  int n_split, split_len;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
};

template <class T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// element i of a float32 (bf16 == 0) or bfloat16 array
__device__ __forceinline__ float load_as_float(const void* p, long long i,
                                               int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_from_float(void* p, long long i,
                                                 int bf16, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);  // to nearest
  else
    static_cast<float*>(p)[i] = x;
}

// one 16-byte chunk as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// elements 2 cp and 2 cp + 1 of a staged row (rows are 16-byte aligned)
__device__ __forceinline__ float2 pair_of(const float* row, int cp) {
  return reinterpret_cast<const float2*>(row)[cp];
}
__device__ __forceinline__ float2 pair_of(const __nv_bfloat16* row, int cp) {
  return __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(row)[cp]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16-byte chunks holding one row of d elements
__host__ __device__ __forceinline__ int data_chunks(int d, int elt) {
  return (d * elt + 15) / 16;
}
// bytes of one staged row: an odd number of chunks
__host__ __device__ __forceinline__ int row_bytes(int d, int elt) {
  return (data_chunks(d, elt) | 1) * 16;
}

template <int GT, int TK>
__host__ __device__ __forceinline__ int split_smem_bytes(int d, int elt) {
  const int dpad = data_chunks(d, elt) * (16 / elt);
  return 4 * TK * row_bytes(d, elt) +  // 2 stages of a K and a V tile
         (GT * dpad + GT * TK + GT) * 4;  // q, scores, rescale factors
}

template <class T, int GT, int TK, bool VEC>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kElt = sizeof(T);
  constexpr int kEpc = 16 / kElt;              // elements per chunk
  constexpr int kHeadSets = kThreads / TK;     // score phase
  constexpr int kHeadsPer = (GT + kHeadSets - 1) / kHeadSets;
  const int d = a.d;
  const int dc = data_chunks(d, kElt);
  const int dpad = dc * kEpc;
  const int rb = row_bytes(d, kElt);
  const int tile_bytes = TK * rb;
  float* qs = reinterpret_cast<float*>(smem + 4 * tile_bytes);  // [GT][dpad]
  float* sc = qs + GT * dpad;                                   // [GT][TK]
  float* alpha_s = sc + GT * TK;                                // [GT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = a.hq / a.hkv;
  const int b = blockIdx.x / a.hkv;
  const int hk = blockIdx.x % a.hkv;
  const int g0 = blockIdx.y * GT;      // first head of this tile
  const int ng = min(GT, group - g0);  // heads of this tile
  const long long bh0 = static_cast<long long>(b) * a.hq + hk * group + g0;
  const int split = blockIdx.z;
  const int len = min(a.lengths[b], a.s);
  const int p_lo = split * a.split_len;
  const int p_hi = min(p_lo + a.split_len, len);
  const int n_tiles = p_hi > p_lo ? (p_hi - p_lo + TK - 1) / TK : 0;

  float* ml = a.ws + (bh0 * a.n_split + split) * 2;  // head g: + 2 g n_split
  float* acc_out = a.ws + static_cast<long long>(a.batch) * a.hq *
                              a.n_split * 2 +
                   (bh0 * a.n_split + split) * d;  // head g: + g n_split d

  if (n_tiles == 0) {  // wholly past the length: the empty partial
    for (int i = tid; i < ng * d; i += kThreads)
      acc_out[static_cast<long long>(i / d) * a.n_split * d + i % d] = 0.0f;
    if (tid < ng) {
      ml[2 * tid * a.n_split] = kNegInf;
      ml[2 * tid * a.n_split + 1] = 0.0f;
    }
    return;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // tile t of the split into stage st: rows past the split are not read
  auto load = [&](int t, int st) {
    const int j0 = p_lo + t * TK;
    const int nk = min(TK, p_hi - j0);
    uint8_t* kd = smem + 2 * st * tile_bytes;
    uint8_t* vd = kd + tile_bytes;
    if constexpr (VEC) {
      for (int i = tid; i < TK * dc; i += kThreads) {
        const int j = i / dc, c = i - j * dc;
        if (j < nk) {
          cp_async16(kd + j * rb + c * 16,
                     kb + static_cast<long long>(j0 + j) * a.k_ss + c * kEpc);
          cp_async16(vd + j * rb + c * 16,
                     vb + static_cast<long long>(j0 + j) * a.v_ss + c * kEpc);
        }
      }
    } else {
      for (int i = tid; i < TK * dpad; i += kThreads) {
        const int j = i / dpad, c = i - j * dpad;
        if (j < nk) {
          const long long jj = j0 + j;
          reinterpret_cast<T*>(kd + j * rb)[c] =
              c < d ? kb[jj * a.k_ss + c] : zero<T>();
          reinterpret_cast<T*>(vd + j * rb)[c] =
              c < d ? vb[jj * a.v_ss + c] : zero<T>();
        }
      }
    }
  };

  load(0, 0);
  cp_async_commit();
  for (int i = tid; i < GT * dpad; i += kThreads) {
    const int g = i / dpad, c = i - g * dpad;
    qs[i] = g < ng && c < d
                ? load_as_float(a.q, b * a.q_sb + (hk * group + g0 + g) * a.q_sh + c,
                                a.q_bf16)
                : 0.0f;
  }

  // P.V: thread t owns the column pair (2 cp, 2 cp + 1) of the heads
  // hs, hs + n_sets, ... (pairs past D hold zero padding or are idle)
  int cw = 1;
  while (cw < (d + 1) / 2) cw <<= 1;  // at most 128 pairs: D <= 256
  const int n_sets = kThreads / cw;
  const int cp = tid % cw;
  const int hs = tid / cw;
  const bool cp_live = 2 * cp < d;
  const auto pair = [&](const uint8_t* row, int i) {
    return pair_of(reinterpret_cast<const T*>(row), i);
  };

  float acc[GT][2];
#pragma unroll
  for (int u = 0; u < GT; ++u) acc[u][0] = acc[u][1] = 0.0f;
  // the softmax carry of heads warp and warp + kWarps (lane-uniform)
  float m_w[2] = {kNegInf, kNegInf};
  float l_w[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // tile t (and q) in shared memory

    const int j0 = p_lo + t * TK;
    const int nk = min(TK, p_hi - j0);
    const uint8_t* kd = smem + 2 * st * tile_bytes;
    const uint8_t* vd = kd + tile_bytes;

    // logits: thread j = tid % TK, heads tid / TK + kHeadSets * u
    {
      const int j = tid % TK;
      const int hset = tid / TK;
      if (j < nk) {
        float dot[kHeadsPer];
#pragma unroll
        for (int u = 0; u < kHeadsPer; ++u) dot[u] = 0.0f;
        const uint4* kr = reinterpret_cast<const uint4*>(kd + j * rb);
        for (int c = 0; c < dc; ++c) {
          float x[kEpc];
          unpack(kr[c], x);
#pragma unroll
          for (int u = 0; u < kHeadsPer; ++u) {
            const int g = hset + kHeadSets * u;
            if (g < GT) {
              const float4* qg =
                  reinterpret_cast<const float4*>(qs + g * dpad + c * kEpc);
#pragma unroll
              for (int e = 0; e < kEpc / 4; ++e) {
                const float4 qv = qg[e];  // the same address: a broadcast
                dot[u] = fmaf(qv.x, x[4 * e], dot[u]);
                dot[u] = fmaf(qv.y, x[4 * e + 1], dot[u]);
                dot[u] = fmaf(qv.z, x[4 * e + 2], dot[u]);
                dot[u] = fmaf(qv.w, x[4 * e + 3], dot[u]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kHeadsPer; ++u) {
          const int g = hset + kHeadSets * u;
          if (g < GT) sc[g * TK + j] = dot[u] * a.scale;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w and w + kWarps
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = warp + kWarps * u;
      if (g < ng) {
        float x[TK / 32];
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < TK / 32; ++e) {
          const int j = lane + 32 * e;
          x[e] = j < nk ? sc[g * TK + j] : kNegInf;
          mx = fmaxf(mx, x[e]);
        }
        const float m_new = fmaxf(m_w[u], warp_max(mx));
        float sum = 0.0f;
#pragma unroll
        for (int e = 0; e < TK / 32; ++e) {
          const int j = lane + 32 * e;
          const float p = j < nk ? expf(x[e] - m_new) : 0.0f;
          sc[g * TK + j] = p;
          sum += p;
        }
        const float al = expf(m_w[u] - m_new);
        l_w[u] = l_w[u] * al + warp_sum(sum);
        m_w[u] = m_new;
        if (lane == 0) alpha_s[g] = al;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, four keys at a time
#pragma unroll
    for (int u = 0; u < GT; ++u) {
      const int g = hs + n_sets * u;
      if (g < ng) {
        const float al = alpha_s[g];
        acc[u][0] *= al;
        acc[u][1] *= al;
      }
    }
    if (cp_live) {
      int j = 0;
      for (; j + 4 <= nk; j += 4) {
        float2 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = pair(vd + (j + e) * rb, cp);
#pragma unroll
        for (int u = 0; u < GT; ++u) {
          const int g = hs + n_sets * u;
          if (g < ng) {
            const float4 p = *reinterpret_cast<const float4*>(sc + g * TK + j);
            acc[u][0] = fmaf(p.x, vv[0].x, acc[u][0]);
            acc[u][1] = fmaf(p.x, vv[0].y, acc[u][1]);
            acc[u][0] = fmaf(p.y, vv[1].x, acc[u][0]);
            acc[u][1] = fmaf(p.y, vv[1].y, acc[u][1]);
            acc[u][0] = fmaf(p.z, vv[2].x, acc[u][0]);
            acc[u][1] = fmaf(p.z, vv[2].y, acc[u][1]);
            acc[u][0] = fmaf(p.w, vv[3].x, acc[u][0]);
            acc[u][1] = fmaf(p.w, vv[3].y, acc[u][1]);
          }
        }
      }
      for (; j < nk; ++j) {  // the tile's ragged end
        const float2 vv = pair(vd + j * rb, cp);
#pragma unroll
        for (int u = 0; u < GT; ++u) {
          const int g = hs + n_sets * u;
          if (g < ng) {
            const float p = sc[g * TK + j];
            acc[u][0] = fmaf(p, vv.x, acc[u][0]);
            acc[u][1] = fmaf(p, vv.y, acc[u][1]);
          }
        }
      }
    }
    __syncthreads();  // stage st and the scores are rewritten next
  }

  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = warp + kWarps * u;
      if (g < ng) {
        ml[2 * g * a.n_split] = m_w[u];
        ml[2 * g * a.n_split + 1] = l_w[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < GT; ++u) {
    const int g = hs + n_sets * u;
    if (g < ng && cp_live) {
      float* out = acc_out + static_cast<long long>(g) * a.n_split * d;
      out[2 * cp] = acc[u][0];
      if (2 * cp + 1 < d) out[2 * cp + 1] = acc[u][1];
    }
  }
}

// one block per (batch, q-head), thread c per output column
__global__ void decode_combine_kernel(const DecodeArgs a) {
  const long long bh = blockIdx.x;
  const int c = threadIdx.x;
  if (c >= a.d) return;
  const float* ml = a.ws + bh * a.n_split * 2;
  const float* acc = a.ws +
                     static_cast<long long>(a.batch) * a.hq * a.n_split * 2 +
                     bh * a.n_split * a.d;
  float mx = kNegInf;
  for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < a.n_split; ++s) {
    const float e = expf(ml[2 * s] - mx);
    den = fmaf(ml[2 * s + 1], e, den);
    num = fmaf(acc[static_cast<long long>(s) * a.d + c], e, num);
  }
  store_from_float(a.o, bh * a.d + c, a.q_bf16, num / fmaxf(den, 1e-30f));
}

template <class T, int GT, int TK, bool VEC>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const int smem = split_smem_bytes<GT, TK>(a.d, sizeof(T));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<T, GT, TK, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // as much of each SM for shared memory as it offers: more blocks at once
  const cudaError_t err_carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err_carve != cudaSuccess) return err_carve;
  const int group = a.hq / a.hkv;
  const dim3 grid(a.batch * a.hkv, (group + GT - 1) / GT, a.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<a.batch * a.hq, (a.d + 31) / 32 * 32, 0, stream>>>(
      a);
  return cudaGetLastError();
}

// 16-byte cp.async where every cache row starts 16-byte aligned
template <class T>
bool vector_loads(const DecodeArgs& a) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long elt = sizeof(T);
  const long long strides[] = {a.k_sb, a.k_sh, a.k_ss,
                               a.v_sb, a.v_sh, a.v_ss};
  for (long long s : strides)
    if (s * elt % 16 != 0) return false;
  return a.d * elt % 16 == 0 && aligned(a.k) && aligned(a.v);
}

template <class T, int GT>
cudaError_t launch_tile(const DecodeArgs& a, cudaStream_t stream) {
  const bool vec = vector_loads<T>(a);
  // 64 keys per tile while a staged row fits in 400 bytes, else 32
  if (row_bytes(a.d, sizeof(T)) <= 400)
    return vec ? launch<T, GT, 64, true>(a, stream)
               : launch<T, GT, 64, false>(a, stream);
  return vec ? launch<T, GT, 32, true>(a, stream)
             : launch<T, GT, 32, false>(a, stream);
}

int group_tile(int group) {
  if (group <= 1) return 1;
  if (group <= 2) return 2;
  if (group <= 4) return 4;
  return kMaxGroupTile;
}

template <class T>
cudaError_t launch_gt(const DecodeArgs& a, cudaStream_t stream) {
  switch (group_tile(a.hq / a.hkv)) {
    case 1: return launch_tile<T, 1>(a, stream);
    case 2: return launch_tile<T, 2>(a, stream);
    case 4: return launch_tile<T, 4>(a, stream);
    default: return launch_tile<T, kMaxGroupTile>(a, stream);
  }
}

}  // namespace

extern "C" {

int decode_attention_max_head_dim() { return 256; }

// most query heads per block (the wrapper's MAX_GROUP_TILE, checked at
// bind)
int decode_attention_max_group_tile() { return kMaxGroupTile; }

// q_dtype (q and o), kv_dtype (k and v): 0 float32, 1 bfloat16. q
// (B, Hq, D) and k, v (B, Hkv, S, D) through their strides in elements,
// the last dim dense; lengths (B,) int32; o (B, Hq, D) contiguous; ws
// float32 of B * Hq * n_split * (D + 2) elements. Launches the split and
// the combine kernel on `stream`; returns cudaGetLastError() (0 on
// success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, float* ws,
                            int q_dtype, int kv_dtype, int batch, int hq,
                            int hkv, int s, int d, int n_split,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb,
                            long long v_sh, long long v_ss, float scale,
                            void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_len = (s + n_split - 1) / n_split;  // 0 for an empty cache
  const DecodeArgs a{q,    k,    v,    lengths, o,         ws,   q_dtype,
                     batch, hq,  hkv,  s,       d,         n_split,
                     split_len,  q_sb, q_sh,    k_sb,      k_sh, k_ss,
                     v_sb, v_sh, v_ss, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = kv_dtype == 0 ? launch_gt<float>(a, st)
                                        : launch_gt<__nv_bfloat16>(a, st);
  return static_cast<int>(err);
}

}  // extern "C"
