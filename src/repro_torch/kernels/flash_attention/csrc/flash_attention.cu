// Flash-attention forward on Hopper (sm_90a): the LM stack's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_fa_kernel, launched by flash_attention_pallas). On the TPU
// the grid runs (B*Hq, Sq/BQ, Sk/BK) in order on one core and carries the
// online-softmax state (acc, m, l) in VMEM scratch across the key axis.
// Here blocks run in parallel in no order, so one block owns one
// (batch*q-head, 64-row query tile) and walks the key tiles in a loop,
// keeping the carry in registers.
//
// What it computes: softmax(scale * q k^T + mask) v for q (B, Hq, Sq, D)
// and k, v (B, Hkv, Sk, D), q-head h reading kv-head h / (Hq/Hkv) (GQA).
// Masks: causal (kpos <= qpos, both counted from 0), sliding window
// (kpos > qpos - window), or none; keys past Sk (the ragged tail) are
// masked too. Masked logits are -1e30, as in the Pallas kernel, and key
// tiles that no row of the query tile can see are skipped. m, l and acc
// are float32; the output is acc / max(l, 1e-30) in q's type (float or
// bfloat16). Any Sq, Sk and D <= 256.
//
// Layout: 8 warps; warp w owns query rows 8w..8w+7 of the tile, lane j
// owns keys j and j+32 of each 64-key tile, so a row's softmax is one
// warp's shuffle reduction. Q is staged once as float32 in shared memory
// (rows read as float4 broadcasts), each K tile transposed (K^T, rows
// padded to 65 floats so the transposing store is conflict-free) and each
// V tile as is, each thread keeping 8 loads of K and of V in flight
// before it stores them. P goes through shared memory (per warp) into
// the P.V product, where lane j owns output columns j, j+32, ... (NC of
// them).
// Operands are read through their (batch, head, position) strides with
// a dense last dim, so the transposed views of _split_heads need no copy.
//
// What bounds it: at granite-3-2b's prefill (B=4, S=2048, Hq=32, D=64,
// causal) the work is ~6.9e10 flops against ~84 MB of operands, far on
// the arithmetic side of the H100's ridge; the bound is the bf16 tensor
// rate. This first version does its products with float32 FMAs from
// shared memory (no wgmma, no TMA), so it cannot come near that bound;
// it is the correct baseline that the tensor-core version will replace
// (PERF.md). Build without --use_fast_math: expf must be accurate to hold
// the float32 tolerance of the reference (2e-5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr int kLdk = kBK + 1;        // row stride of the K^T tile
constexpr int kLoadBatch = 8;        // staging loads in flight per thread
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, sk, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
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

__host__ __device__ __forceinline__ int padded_d(int d) {
  return (d + 3) & ~3;
}

__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  const size_t dq = padded_d(d);
  return kBQ * dq + dq * kLdk + static_cast<size_t>(kBK) * d + kBQ * kBK;
}

template <class T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  const int dq = padded_d(d);
  float* qs = smem;               // [kBQ][dq]   query tile
  float* kt = qs + kBQ * dq;      // [dq][kLdk]  K tile, transposed
  float* vs = kt + dq * kLdk;     // [kBK][d]    V tile
  float* ps = vs + kBK * d;       // [kBQ][kBK]  probabilities

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.hq;
  const int h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Q tile as float32, zero past Sq and past D; K^T's padding rows zero
  for (int i = tid; i < kBQ * dq; i += blockDim.x) {
    const int r = i / dq, c = i % dq;
    float x = 0.0f;
    if (q0 + r < a.sq && c < d)
      x = to_float(qb[static_cast<long long>(q0 + r) * a.q_ss + c]);
    qs[i] = x;
  }
  for (int i = tid; i < (dq - d) * kLdk; i += blockDim.x)
    kt[d * kLdk + i] = 0.0f;

  // key tiles some row of this query tile can see
  int k_lo = 0;
  int k_hi = a.sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.sk, q0 + kBQ);
  k_lo = (k_lo / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }
  const float* qw = qs + warp * kRows * dq;
  float* pw = ps + warp * kRows * kBK;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's K^T and V are no longer read
    // kLoadBatch elements of K and of V per thread in flight at once
    for (int i0 = tid; i0 < kBK * d; i0 += kLoadBatch * blockDim.x) {
      float kx[kLoadBatch], vx[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const int j = i / d, c = i - j * d;
        const bool ok = i < kBK * d && k0 + j < a.sk;
        kx[u] = ok ? to_float(kb[static_cast<long long>(k0 + j) * a.k_ss + c])
                   : 0.0f;
        vx[u] = ok ? to_float(vb[static_cast<long long>(k0 + j) * a.v_ss + c])
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const int j = i / d, c = i - j * d;
        if (i < kBK * d) {
          kt[c * kLdk + j] = kx[u];
          vs[j * d + c] = vx[u];
        }
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's rows and this lane's two keys
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int c = 0; c < dq; c += 4) {
      float k0v[4], k1v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        k0v[u] = kt[(c + u) * kLdk + lane];
        k1v[u] = kt[(c + u) * kLdk + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * dq + c);
        s[r][0] = fmaf(qv.x, k0v[0], s[r][0]);
        s[r][0] = fmaf(qv.y, k0v[1], s[r][0]);
        s[r][0] = fmaf(qv.z, k0v[2], s[r][0]);
        s[r][0] = fmaf(qv.w, k0v[3], s[r][0]);
        s[r][1] = fmaf(qv.x, k1v[0], s[r][1]);
        s[r][1] = fmaf(qv.y, k1v[1], s[r][1]);
        s[r][1] = fmaf(qv.z, k1v[2], s[r][1]);
        s[r][1] = fmaf(qv.w, k1v[3], s[r][1]);
      }
    }

    // mask, online softmax, P to shared memory, rescale the carry
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + lane + 32 * e;
        bool ok = kpos < a.sk;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        s[r][e] = ok ? s[r][e] * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * kBK + lane] = p0;
      pw[r * kBK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P V
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          vv[u][c] = col < d ? vs[(j + u) * d + col] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= a.sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d)
        ob[static_cast<long long>(qpos) * a.o_ss + col] =
            from_float<T>(acc[r][c] / den);
    }
  }
}

template <class T, int NC>
cudaError_t launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(a.d) * sizeof(float);
  auto kernel = flash_attention_kernel<T, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * a.hq, (a.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_nc(const FlashArgs& a, int batch, cudaStream_t stream) {
  const int nc = (a.d + 31) / 32;
  if (nc <= 1) return launch<T, 1>(a, batch, stream);
  if (nc <= 2) return launch<T, 2>(a, batch, stream);
  if (nc <= 4) return launch<T, 4>(a, batch, stream);
  if (nc <= 8) return launch<T, 8>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return 256; }

// dtype: 0 float32, 1 bfloat16. Strides in elements; the last dim of
// every operand is dense. Launch on `stream`; returns cudaGetLastError()
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int hq, int hkv,
                           int sq, int sk, int d, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, float scale,
                           int causal, int window, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q,    k,    v,    o,    hq,   hkv,  sq,    sk,
                    d,    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb,
                    v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_nc<float>(a, batch, s)
                              : launch_nc<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(err);
}

}  // extern "C"
