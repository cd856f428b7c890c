// Decode attention on Hopper (sm_90a): one new token per sequence
// against its KV cache, the LM stack's serving step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_dec_kernel, launched by decode_attention_pallas). There
// the grid (B*Hkv, S/BK) sweeps the cache in order on one core with the
// online-softmax carry in VMEM, the G = Hq/Hkv query heads of one kv
// group stacked into one (G, D) tile so each K/V block is read once per
// group. Here one block owns one (batch, kv-head) pair and its group of
// query heads (up to 8 per block: larger groups take several blocks),
// and its W warps (8, or 4 for head dims above ~200, whose staging
// needs more shared memory) split the cache between them: warp w takes
// keys 32w.., 32(w+W).., each warp keeps its own float32 carry (m, l,
// acc) over its keys, and the warps' carries are combined at the end.
//
// What it computes: for each query head h of kv-head h / G,
// softmax(scale * q_h k^T) v over the first lengths[b] cache positions;
// positions >= lengths[b] are masked and never read. Output in q's type,
// acc / max(l, 1e-30); with lengths[b] == 0 that is zeros, as in the
// Pallas kernel (the callers pass lengths >= 1). q and the output are
// float or bfloat16 whatever the cache's type (float or bfloat16): like
// the Pallas kernel, which casts q and each K/V block to float32, it
// serves a model in one type over a cache in another. The cache's type
// is a template parameter; q's is a runtime flag, read only when q is
// loaded and the output stored.
//
// Layout: per 32-key chunk a warp stages K as float32 in shared memory
// (16 loads per lane in flight; rows padded to an odd stride, so lane j
// reading key j's row hits its own bank), lane j computes key j's logit
// for every head of the group (q in shared memory, broadcast), the warp
// reduces max and sum by shuffles, and the P.V product reads V straight
// from device memory, lane j owning output columns j, j+32, ... (NC of
// them).
//
// What bounds it: decode reads every valid K and V element once (2 * 2
// bytes per element in bfloat16) and does 4 flops per element per query
// head; at G = 4 that is ~4 flops per byte, far below the H100's ridge,
// so the bound is device-memory bandwidth. This version has B*Hkv blocks
// (64 at granite's decode batch of 8), fewer than the 132 SMs, and each
// warp walks its share of the cache one chunk at a time, so it is
// latency-bound (the first version, with one load in flight per lane
// while staging, was slower than the plain torch version: PERF.md).
// Splitting the cache over more blocks with a combine pass
// (flash-decoding) is the next step. Build without --use_fast_math: expf
// must hold the float32 tolerance (2e-5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kChunk = 32;      // keys per warp step, one per lane
constexpr int kLoadBatch = 16;  // staging loads in flight per lane
constexpr int kMaxGroupTile = 8;
constexpr size_t kMaxSmemBytes = 232448;  // per block on Hopper
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int q_bf16;  // q and o: 0 float32, 1 bfloat16
  int hq, hkv, s, d;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// odd row stride of a staged K chunk
__host__ __device__ __forceinline__ int k_stride(int d) { return d | 1; }

// floats of one warp's region: its K chunk and its probabilities (after
// the sweep the same region holds its carry for the combine)
__host__ __device__ __forceinline__ int warp_floats(int d, int gt) {
  return kChunk * k_stride(d) + gt * kChunk;
}

template <class T, int GT, int NC>
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_attention_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  const int ldk = k_stride(d);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int group = a.hq / a.hkv;
  const int b = blockIdx.x / a.hkv;
  const int hk = blockIdx.x % a.hkv;
  const int g0 = blockIdx.y * GT;           // first head of this tile
  const int ng = min(GT, group - g0);       // heads of this tile
  const int h0 = hk * group + g0;           // its first query head
  const int len = min(a.lengths[b], a.s);

  float* qs = smem;                         // [GT][d] queries
  float* region = qs + GT * d;
  float* ks = region + warp * warp_floats(d, GT);  // [kChunk][ldk]
  float* ps = ks + kChunk * ldk;                    // [GT][kChunk]

  for (int i = tid; i < GT * d; i += blockDim.x) {
    const int g = i / d, c = i % d;
    qs[i] = g < ng ? load_as_float(a.q, b * a.q_sb + (h0 + g) * a.q_sh + c,
                                   a.q_bf16)
                   : 0.0f;
  }
  __syncthreads();

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float m[GT], l[GT], acc[GT][NC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.0f;
  }

  for (int c0 = warp * kChunk; c0 < len; c0 += n_warps * kChunk) {
    const int nk = min(kChunk, len - c0);
    // lane reads elements lane, lane + 32, ... of the chunk (d of them),
    // kLoadBatch loads in flight before the stores
    for (int t0 = 0; t0 < d; t0 += kLoadBatch) {
      float buf[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = lane + 32 * (t0 + u);
        const int j = i / d, c = i - j * d;
        buf[u] = t0 + u < d && j < nk
                     ? to_float(kb[static_cast<long long>(c0 + j) * a.k_ss + c])
                     : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = lane + 32 * (t0 + u);
        const int j = i / d, c = i - j * d;
        if (t0 + u < d) ks[j * ldk + c] = buf[u];
      }
    }
    __syncwarp();

    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = 0.0f;
    const float* kr = ks + lane * ldk;
    for (int c = 0; c < d; ++c) {
      const float kx = kr[c];
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[g] = fmaf(qs[g * d + c], kx, sc[g]);
    }

    const bool valid = lane < nk;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float x = valid ? sc[g] * a.scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float alpha = expf(m[g] - m_new);
      const float p = expf(x - m_new);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      ps[g * kChunk + lane] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const T* vr = vb + static_cast<long long>(c0 + j) * a.v_ss;
      float vx[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vx[c] = col < d ? to_float(vr[col]) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = ps[g * kChunk + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[g][c] = fmaf(p, vx[c], acc[g][c]);
      }
    }
    __syncwarp();  // ks and ps are rewritten by the next chunk
  }

  // combine the warps' carries: each warp parks (m, l, acc) in its region
  __syncthreads();
  float* own = ks;  // this warp's region
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      own[g] = m[g];
      own[GT + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) own[2 * GT + g * d + col] = acc[g][c];
    }
  }
  __syncthreads();

  const long long o0 = (static_cast<long long>(b) * a.hq + h0) * d;
  for (int i = tid; i < ng * d; i += blockDim.x) {
    const int g = i / d, col = i % d;
    float mx = kNegInf;
    for (int w = 0; w < n_warps; ++w)
      mx = fmaxf(mx, region[w * warp_floats(d, GT) + g]);
    float num = 0.0f, den = 0.0f;
    for (int w = 0; w < n_warps; ++w) {
      const float* r = region + w * warp_floats(d, GT);
      const float e = expf(r[g] - mx);
      den += r[GT + g] * e;
      num += r[2 * GT + g * d + col] * e;
    }
    store_from_float(a.o, o0 + i, a.q_bf16, num / fmaxf(den, 1e-30f));
  }
}

template <class T, int GT, int NC>
cudaError_t launch(const DecodeArgs& a, int batch, cudaStream_t stream) {
  // 8 warps where their shared memory fits (head dims up to ~200), else 4
  int warps = kMaxWarps;
  size_t smem = 0;
  for (; warps >= 4; warps /= 2) {
    smem = (static_cast<size_t>(GT) * a.d +
            static_cast<size_t>(warps) * warp_floats(a.d, GT)) *
           sizeof(float);
    if (smem <= kMaxSmemBytes || warps == 4) break;
  }
  auto kernel = decode_attention_kernel<T, GT, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int group = a.hq / a.hkv;
  const dim3 grid(batch * a.hkv, (group + GT - 1) / GT);
  kernel<<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, int GT>
cudaError_t launch_nc(const DecodeArgs& a, int batch, cudaStream_t stream) {
  const int nc = (a.d + 31) / 32;
  if (nc <= 1) return launch<T, GT, 1>(a, batch, stream);
  if (nc <= 2) return launch<T, GT, 2>(a, batch, stream);
  if (nc <= 4) return launch<T, GT, 4>(a, batch, stream);
  if (nc <= 8) return launch<T, GT, 8>(a, batch, stream);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t launch_gt(const DecodeArgs& a, int batch, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  if (group <= 1) return launch_nc<T, 1>(a, batch, stream);
  if (group <= 2) return launch_nc<T, 2>(a, batch, stream);
  if (group <= 4) return launch_nc<T, 4>(a, batch, stream);
  return launch_nc<T, kMaxGroupTile>(a, batch, stream);
}

}  // namespace

extern "C" {

int decode_attention_max_head_dim() { return 256; }

// q_dtype (q and o), kv_dtype (k and v): 0 float32, 1 bfloat16. q
// (B, Hq, D) and k, v (B, Hkv, S, D) through their strides in elements,
// the last dim dense; lengths (B,) int32; o (B, Hq, D) contiguous.
// Launch on `stream`; returns cudaGetLastError() (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, int q_dtype,
                            int kv_dtype, int batch, int hq, int hkv,
                            int s, int d,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb,
                            long long v_sh, long long v_ss, float scale,
                            void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q,    k,    v,    lengths, o,    q_dtype, hq,
                     hkv,  s,    d,    q_sb,    q_sh, k_sb,    k_sh,
                     k_ss, v_sb, v_sh, v_ss,    scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = kv_dtype == 0
                              ? launch_gt<float>(a, batch, st)
                              : launch_gt<__nv_bfloat16>(a, batch, st);
  return static_cast<int>(err);
}

}  // extern "C"
