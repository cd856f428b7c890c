// Flash-attention forward on Hopper (sm_90a): the LM stack's prefill and
// its training forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_fa_kernel, launched by flash_attention_pallas). On the TPU
// the grid runs (B*Hq, Sq/BQ, Sk/BK) in order on one core and carries the
// online-softmax state (acc, m, l) in VMEM scratch across the key axis.
// Here blocks run in parallel in no order, so one block owns one
// (batch*q-head, query tile) and walks the key tiles in a loop, keeping
// the carry in registers; the longest causal tiles are launched first.
//
// What it computes: softmax(scale * q k^T + mask) v for q (B, Hq, Sq, D)
// and k, v (B, Hkv, Sk, D), q-head h reading kv-head h / (Hq/Hkv) (GQA).
// Masks: causal (kpos <= qpos, both counted from 0), sliding window
// (kpos > qpos - window), or none; keys past Sk (the ragged tail) are
// masked too. Masked logits are -1e30, as in the Pallas kernel, and key
// tiles that no row of a query tile can see are skipped. m, l and acc
// are float32; the output is acc / max(l, 1e-30) in q's type, written
// into the (B, Sq, Hq, D) storage the caller views without a copy.
// Operands are read through their (batch, head, position) strides with a
// dense last dim, so the transposed views of _split_heads need no copy.
//
// What bounds it: at granite-3-2b's prefill (B=4, S=2048, Hq=32, D=64,
// causal) the work is ~6.9e10 flops against ~84 MB of operands, far on
// the arithmetic side of the H100's ridge; the bound is the bf16
// tensor-core rate (989 TFLOP/s). The float32 rate outside the tensor
// cores is 67 TFLOP/s, 6.8 % of that, so only the tensor cores can come
// near the bound. Three kernels, chosen by one rule in the wrapper
// (kernel.py::which_kernel), by type, shape and alignment, never by a
// retry:
//
// * flash_attention_tc_kernel, the tensor-core kernel, takes bfloat16
//   q, k, v with D a multiple of 16 (up to 256), 16-byte-aligned bases
//   and strides that are multiples of 8 elements. Two consumer
//   warpgroups own 64 query rows each (128 per block) and walk 64-key
//   tiles of K and V. The tiles sit in a 2-stage ring in shared memory,
//   filled by 16-byte cp.async (commit_group / wait_group) so that the
//   copy of tile j+1 overlaps the products of tile j. S = Q K^T is
//   wgmma.mma_async m64n64k16 (bf16 in, float32 accumulate) with Q and K
//   from shared memory: a K tile stored [keys][D] is already the K-major
//   B operand. O += P V is wgmma with P from registers (the float32 S
//   fragment packed to bf16 pairs in place as the A operand) and V from
//   shared memory as an MN-major B operand (the transpose bit). P enters
//   as two bf16 terms, P rounded and the rounding's remainder, each one
//   wgmma: the Pallas kernel multiplies P V in float32, and one bf16 P
//   (off by up to 2^-9) moves a bf16 output of magnitude 4 or more
//   across a rounding boundary (a 1/32 error, past the 2e-2 tolerance);
//   the two terms hold P to about 2^-17. The head
//   dim is padded with zeros to 64-column panels, each row of a panel 128
//   bytes, one 128-byte swizzle atom: the cp.async stores write chunk c
//   of row r at chunk c ^ (r % 8), the layout the descriptors' 128-byte
//   swizzle reads. Row max and row sum come from the accumulator
//   fragment by shuffles across the four lanes that share a row; the
//   carry (m, l, O) stays in registers for the whole walk; only tiles on
//   the diagonal, the window's edge or the ragged end of Sk are masked.
//   Every thread both copies and computes, and a warpgroup waits for its
//   own products before its softmax (no producer warp, no ping-pong
//   between warpgroups): PERF.md has its time against the bound.
// * flash_attention_f32tc_kernel, the split-TF32 kernel, takes float32
//   q, k, v with D a multiple of 8 (up to 256), 16-byte-aligned bases
//   and strides that are multiples of 4 elements: every training step.
//   One TF32 product cannot hold the reference's float32 tolerance of
//   2e-5: it rounds each operand to 10 mantissa bits (2^-11 of its
//   size, 2^13 times float32's rounding). Split, it can: each operand is
//   written as hi + lo, two TF32 numbers (hi = x rounded to TF32 by
//   integer operations, lo = x - hi, which the tensor cores read as TF32
//   by dropping its low 13 bits), and a product is lo*hi + hi*lo +
//   hi*hi, summed in float32 on the tensor cores (mma.sync m16n8k8
//   .tf32; CUTLASS calls it OpMultiplyAddFastF32, "3xTF32"). The
//   truncation of lo leaves each operand within 2^-21 of x, and the
//   dropped lo*lo and the truncation each product within ~2^-20 of
//   float32's: errors of a float32 FMA chain's order, not of TF32. Both
//   S = Q K^T and O += P V are split so. Four warps own 16 query rows
//   each (64 a block) and walk key tiles of 32 (D <= 128) or 16 (D 192,
//   256) keys in a 2-stage cp.async ring; Q stays in shared memory, rows
//   padded to 8 NT + 4 floats so that every fragment load is free of
//   bank conflicts, and operands are split as their fragments are read
//   (no hi/lo tiles in shared memory: the split is three integer and
//   float operations a value). P never leaves registers: the
//   accumulator holds keys 2t and 2t + 1 of each octet where the A
//   operand wants columns t and t + 4, so column t is read as key 2t and
//   t + 4 as key 2t + 1, and V's B fragment takes its keys in the same
//   order. The softmax is float32 with expf, as in the SIMT kernel. What
//   bounds it: three products per multiply-add over the dense TF32 rate
//   (495 TFLOP/s), or the bytes at 3.35 TB/s, whichever is larger.
// * flash_attention_kernel, the SIMT kernel, takes everything else:
//   bfloat16 with a head dim that is not a multiple of 16, float32 with
//   one that is not a multiple of 8, and operands that break 16-byte
//   alignment. 8 warps; warp w owns query rows 8w..8w+7 of a 64-row tile,
//   lane j owns keys j and j+32 of each 64-key tile, so a row's softmax
//   is one warp's shuffle reduction. Q is staged once as float32 in
//   shared memory, each K tile transposed (rows padded to 65 floats) and
//   each V tile as is; the products are float32 FMAs. Any Sq, Sk and
//   D <= 256.
//
// Build without --use_fast_math: the float32 kernels' expf must be
// accurate to hold the float32 tolerance of the reference (2e-5). The
// bfloat16 tensor-core kernel takes 2^x from ex2.approx (held to 2e-2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ------------------------------------------------- tensor-core kernel (bf16)
namespace tc {

constexpr int kBQ = 128;          // query rows per block: two warpgroups
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;
constexpr int kStages = 2;        // K/V tiles in the ring
constexpr int kRowBytes = 128;    // one row of a 64-column bf16 panel
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory bytes: Q (NP panels of kBQ rows), then per stage a K and
// a V tile (NP panels of kBK rows each), plus slack to align to 1024
template <int NP>
struct Layout {
  static constexpr uint32_t q_bytes = NP * kBQ * kRowBytes;
  static constexpr uint32_t tile_bytes = NP * kBK * kRowBytes;
  static constexpr uint32_t bytes =
      q_bytes + kStages * 2 * tile_bytes + 1024;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// make the generic-proxy writes of cp.async visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// fence / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo/sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define FA_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define FA_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d (64x64, f32) = (accumulate ? d : 0) + A (64x16, K-major in shared
// memory) * B (16x64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64, f32) += A (64x16 bf16 in registers) * B (16x64, MN-major in
// shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is low
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as two packed bf16 pairs: the rounded values, and the
// remainders x - rounded, rounded in turn (hi + lo holds x to ~2^-17)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// rows [row0, row0 + ROWS) of a (positions, D) operand into NP swizzled
// panels at dst; rows at or past n_rows and columns past d are zeros
template <int NP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, int tid) {
  constexpr int kChunks = ROWS * NP * 8;  // 16-byte chunks
#pragma unroll
  for (int i0 = 0; i0 < kChunks; i0 += kThreads) {
    const int i = i0 + tid;
    const int r = i / (NP * 8);
    const int cc = i % (NP * 8);  // chunk of the row: panel cc / 8
    const bool ok = r < n_rows && cc * 8 < d;
    const __nv_bfloat16* g =
        ok ? src + static_cast<long long>(row0 + r) * row_stride + cc * 8
           : src;
    cp_async16(dst + (cc >> 3) * (ROWS * kRowBytes) + r * kRowBytes +
                   (((cc & 7) ^ (r & 7)) << 4),
               g, ok);
  }
}

// 2^x in one MUFU op (flushes denormal results to 0: p, alpha >= 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NP: 64-column panels of the head dim (D padded with zeros to 64 * NP).
// At D <= 64 two blocks share an SM (registers capped at 128).
template <int NP>
__global__ void __launch_bounds__(kThreads, NP == 1 ? 2 : 1)
    flash_attention_tc_kernel(const FlashArgs a) {
  using L = Layout<NP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t qs = (raw + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t kv = qs + L::q_bytes;        // stage s: K, then V

  const int tid = threadIdx.x;
  // the warpgroup (query rows 64 wg ..), broadcast so the compiler sees
  // it warp-uniform: wgmma under a branch on it is then not serialized
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;  // warp in the warpgroup
  const int lane = tid & 31;
  const int b = blockIdx.x / a.hq;
  const int h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // key tiles some row of the block can see
  int k_lo = 0;
  int k_hi = a.sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.sk, q0 + kBQ);
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  load_tile<NP, kBQ>(qs, qb, a.q_ss, q0, a.sq - q0, a.d, tid);
  if (n_tiles > 0) {
    load_tile<NP, kBK>(kv, kb, a.k_ss, k_lo, a.sk - k_lo, a.d, tid);
    load_tile<NP, kBK>(kv + L::tile_bytes, vb, a.v_ss, k_lo, a.sk - k_lo,
                       a.d, tid);
  }
  cp_async_commit();

  // this warpgroup's rows and the keys they can see
  const int qw0 = q0 + 64 * wg;
  const int kw_lo = a.window > 0 ? max(0, qw0 - a.window + 1) : 0;
  const int kw_hi = a.causal ? min(a.sk, qw0 + 64) : a.sk;
  const bool rows_live = qw0 < a.sq;
  // the thread's fragment rows are row0 and row0 + 8
  const int row0 = qw0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale_log2 = a.scale * kLog2e;

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kBK;
    const uint32_t ks = kv + (it % kStages) * 2 * L::tile_bytes;
    const uint32_t vs = ks + L::tile_bytes;
    if (it + 1 < n_tiles) {
      const uint32_t nk = kv + ((it + 1) % kStages) * 2 * L::tile_bytes;
      load_tile<NP, kBK>(nk, kb, a.k_ss, k0 + kBK, a.sk - k0 - kBK, a.d,
                         tid);
      load_tile<NP, kBK>(nk + L::tile_bytes, vb, a.v_ss, k0 + kBK,
                         a.sk - k0 - kBK, a.d, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile it (and Q) landed
    fence_proxy_async();
    __syncthreads();

    if (rows_live && k0 < kw_hi && k0 + kBK > kw_lo) {
      // S = Q K^T over NP * 4 steps of 16 head-dim columns
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP * 4; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns within a panel
        const uint64_t da = sw128_desc(qs + (kk >> 2) * (kBQ * kRowBytes) +
                                           wg * 64 * kRowBytes + off,
                                       16, 1024);
        const uint64_t db = sw128_desc(
            ks + (kk >> 2) * (kBK * kRowBytes) + off, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_0();
      fence_regs(s);

      // scale into the log2 domain; mask only the tiles that need it
      const bool edge = k0 + kBK > a.sk ||
                        (a.causal && k0 + kBK - 1 > qw0) ||
                        (a.window > 0 && k0 <= qw0 + 63 - a.window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * i + e] * scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * j + col0 + e;
              const int qpos = row0 + 8 * i;
              bool ok = kpos < a.sk;
              if (a.causal) ok = ok && kpos <= qpos;
              if (a.window > 0) ok = ok && kpos > qpos - a.window;
              x = ok ? x : kNegInf;
            }
            s[4 * j + 2 * i + e] = x;
          }

      // online softmax: the four lanes of a row reduce by shuffles
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(s[4 * j + 2 * i + e] - m_new);
            s[4 * j + 2 * i + e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = l[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[p][4 * j + 2 * i] *= alpha[i];
            o[p][4 * j + 2 * i + 1] *= alpha[i];
          }

      // P as the A operand: the S fragment of keys 16 kk .. packed in
      // place, as its bf16 rounding (pa) and the remainder (pr)
      uint32_t pa[4][4], pr[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], pa[kk][q],
                     pr[kk][q]);

      // O += P V, one 64-column panel of the head dim at a time
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = sw128_desc(
              vs + p * (kBK * kRowBytes) + kk * 16 * kRowBytes,
              kBK * kRowBytes, 1024);
          wgmma_rs(o[p], pa[kk], dv);
          wgmma_rs(o[p], pr[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_0();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    }
    __syncthreads();  // stage it % kStages is refilled at it + 1
  }

  if (!rows_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + col0;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[p][4 * j + 2 * i] / den,
                                    o[p][4 * j + 2 * i + 1] / den);
      }
  }
}

#undef FA_D32
#undef FA_R32

template <int NP>
cudaError_t launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<NP>;
  const int smem = static_cast<int>(Layout<NP>::bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the wrapper's takes_tensor_cores, checked again: bfloat16, D a multiple
// of 16 up to 256, 16-byte-aligned bases, strides of 8-element multiples
bool takes(const FlashArgs& a, int dtype) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh,
                               a.k_ss, a.v_sb, a.v_sh, a.v_ss};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return dtype == 1 && a.d % 16 == 0 && a.d <= 256 && aligned(a.q) &&
         aligned(a.k) && aligned(a.v) && aligned(a.o) && a.o_ss % 2 == 0;
}

cudaError_t launch_np(const FlashArgs& a, int batch, cudaStream_t stream) {
  switch ((a.d + 63) / 64) {
    case 1: return launch<1>(a, batch, stream);
    case 2: return launch<2>(a, batch, stream);
    case 3: return launch<3>(a, batch, stream);
    case 4: return launch<4>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------- split-TF32 tensor-core kernel (float32)
namespace tf32 {

constexpr int kStages = 2;  // K/V tiles in the ring

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows a block: 16 a warp

// NT: 8-column tiles of the head dim (D padded with zeros to 8 NT). Key
// tiles of 32 keys (D <= 128) or 16 (D 192, 256: 66.5 KB of Q and 33 KB
// a tile keep two blocks an SM at D 192, one at D 256). A staged row is
// 8 NT + 4 floats: a stride of 4 mod 8 words makes every fragment load
// below hit 32 distinct banks and keeps rows 16-byte aligned for
// cp.async. S takes 32 accumulator registers a thread at every
// instance: NB x KP independent chains of 4.
template <int NT>
struct Geo {
  static constexpr int kBK = NT <= 16 ? 32 : 16;
  static constexpr int kNB = kBK / 8;   // 8-key n-tiles of S
  static constexpr int kKP = 8 / kNB;   // chains of each
  static constexpr int kLd = 8 * NT + 4;
  static constexpr int q_floats = kBQ * kLd;
  static constexpr int tile_floats = kBK * kLd;
  static constexpr size_t bytes =
      (q_floats + static_cast<size_t>(kStages) * 2 * tile_floats) *
      sizeof(float);
};

// x = hi + lo: hi is x rounded to TF32 (half away from zero: the bits
// past TF32's 10 mantissa bits rounded off; x is finite here), exact to
// 2^-11 of x; lo = x - hi is exact in float32, and the tensor cores read
// it as TF32 by dropping its low 13 bits, which leaves hi + lo within
// 2^-21 of x. Three integer / float operations; cvt.rna.tf32.f32 costs
// four (it checks for infinities and NaN).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16x8, f32) += a (16x8 TF32, row) * b (8x8 TF32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split TF32: the two small products, then the large one
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// rows [row0, row0 + ROWS) of a (positions, D) float32 operand into a
// staged tile at dst (row stride Geo<NT>::kLd); rows at or past n_rows and
// columns past d are zeros
template <int NT, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, int tid) {
  constexpr int kChunks = 2 * NT;  // 16-byte chunks a row
  constexpr int kLd = Geo<NT>::kLd;
#pragma unroll
  for (int i0 = 0; i0 < ROWS * kChunks; i0 += kThreads) {
    const int i = i0 + tid;
    if (ROWS * kChunks % kThreads != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < n_rows && c * 4 < d;
    const float* g =
        ok ? src + static_cast<long long>(row0 + r) * row_stride + c * 4
           : src;
    tc::cp_async16(static_cast<uint32_t>(
                       __cvta_generic_to_shared(dst + r * kLd + c * 4)),
                   g, ok);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_f32tc_kernel(const FlashArgs a) {
  using G = Geo<NT>;
  constexpr int kBK = G::kBK, kNB = G::kNB, kKP = G::kKP, kLd = G::kLd;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBQ][kLd]   query tile
  float* kv = qs + G::q_floats;     // stage s: K, then V, [kBK][kLd] each

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int t = lane & 3;           // fragment column pair
  const int b = blockIdx.x / a.hq;
  const int h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb =
      static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* ob = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // key tiles some row of the block can see
  int k_lo = 0;
  int k_hi = a.sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.sk, q0 + kBQ);
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  load_rows<NT, kBQ>(qs, qb, a.q_ss, q0, a.sq - q0, a.d, tid);
  if (n_tiles > 0) {
    load_rows<NT, kBK>(kv, kb, a.k_ss, k_lo, a.sk - k_lo, a.d, tid);
    load_rows<NT, kBK>(kv + G::tile_floats, vb, a.v_ss, k_lo, a.sk - k_lo,
                       a.d, tid);
  }
  tc::cp_async_commit();

  // this warp's rows qw0 .. qw0 + 15; the thread's are row0 and row0 + 8
  const int qw0 = q0 + 16 * warp;
  const bool rows_live = qw0 < a.sq;
  const int row0 = qw0 + g;
  const float* qw = qs + (16 * warp + g) * kLd + t;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kBK;
    const float* ks = kv + (it % kStages) * 2 * G::tile_floats;
    const float* vs = ks + G::tile_floats;
    if (it + 1 < n_tiles) {
      float* nk = kv + ((it + 1) % kStages) * 2 * G::tile_floats;
      load_rows<NT, kBK>(nk, kb, a.k_ss, k0 + kBK, a.sk - k0 - kBK, a.d,
                         tid);
      load_rows<NT, kBK>(nk + G::tile_floats, vb, a.v_ss, k0 + kBK,
                         a.sk - k0 - kBK, a.d, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait_1();  // all but the newest group: tile it (and Q)
    __syncthreads();

    // the warp skips a tile none of its rows can see
    const bool live =
        rows_live && (!a.causal || k0 <= qw0 + 15) &&
        (a.window <= 0 || k0 + kBK - 1 > qw0 - a.window);
    if (live) {
      // S = Q K^T: per 8 columns of D, Q's A fragment and each key
      // octet's B fragment split in registers, three products each, into
      // kKP chains per octet (summed after)
      float acc[kNB][kKP][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int c = 0; c < kKP; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][c][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4];
        split(qw[8 * kk], ah[0], al[0]);
        split(qw[8 * kk + 8 * kLd], ah[1], al[1]);
        split(qw[8 * kk + 4], ah[2], al[2]);
        split(qw[8 * kk + 8 * kLd + 4], ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          const float* kp = ks + (8 * nb + g) * kLd + 8 * kk + t;
          uint32_t bh[2], bl[2];
          split(kp[0], bh[0], bl[0]);
          split(kp[4], bh[1], bl[1]);
          mma3(acc[nb][kk % kKP], ah, al, bh, bl);
        }
      }

      // scale; mask only the tiles that need it
      const bool edge = k0 + kBK > a.sk ||
                        (a.causal && k0 + kBK - 1 > qw0) ||
                        (a.window > 0 && k0 <= qw0 + 15 - a.window);
      float s[kNB][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = acc[nb][0][2 * i + e];
#pragma unroll
            for (int c = 1; c < kKP; ++c) x += acc[nb][c][2 * i + e];
            x *= a.scale;
            if (edge) {
              const int kpos = k0 + 8 * nb + 2 * t + e;
              const int qpos = row0 + 8 * i;
              bool ok = kpos < a.sk;
              if (a.causal) ok = ok && kpos <= qpos;
              if (a.window > 0) ok = ok && kpos > qpos - a.window;
              x = ok ? x : kNegInf;
            }
            s[nb][2 * i + e] = x;
          }

      // online softmax in accurate float32: the four lanes of a row
      // reduce by shuffles
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[nb][2 * i + e] - m_new);
            s[nb][2 * i + e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }

      // O += P V. The S fragment holds keys 2t and 2t + 1 of each octet
      // where the A fragment wants columns t and t + 4: column t is read
      // as key 2t and t + 4 as key 2t + 1, and V's B fragment takes its
      // keys in the same order, so P stays in its registers
#pragma unroll
      for (int kb8 = 0; kb8 < kNB; ++kb8) {
        uint32_t ph[4], pl[4];
        split(s[kb8][0], ph[0], pl[0]);
        split(s[kb8][2], ph[1], pl[1]);
        split(s[kb8][1], ph[2], pl[2]);
        split(s[kb8][3], ph[3], pl[3]);
        const float* vp = vs + (8 * kb8 + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[2], bl[2];
          split(vp[8 * n], bh[0], bl[0]);
          split(vp[kLd + 8 * n], bh[1], bl[1]);
          mma3(o[n], ph, pl, bh, bl);
        }
      }
    }
    __syncthreads();  // stage it % kStages is refilled at it + 1
  }

  if (!rows_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < a.d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
}

template <int NT>
cudaError_t launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  auto kernel = flash_attention_f32tc_kernel<NT>;
  const int smem = static_cast<int>(Geo<NT>::bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * a.hq, (a.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the wrapper's rule for this kernel, checked again: float32, D a
// multiple of 8 up to 256, 16-byte-aligned bases, strides of 4-element
// multiples
bool takes(const FlashArgs& a, int dtype) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh,
                               a.k_ss, a.v_sb, a.v_sh, a.v_ss};
  for (long long s : strides)
    if (s % 4 != 0) return false;
  return dtype == 0 && a.d % 8 == 0 && a.d <= 256 && aligned(a.q) &&
         aligned(a.k) && aligned(a.v) && aligned(a.o) && a.o_ss % 2 == 0;
}

// the instances: D 16, 24, 32, 64, 80, 128, 192 and 256 exactly; another
// D runs the next one up, its columns past D zeros
cudaError_t launch_nt(const FlashArgs& a, int batch, cudaStream_t stream) {
  const int nt = a.d / 8;
  if (nt <= 2) return launch<2>(a, batch, stream);
  if (nt <= 3) return launch<3>(a, batch, stream);
  if (nt <= 4) return launch<4>(a, batch, stream);
  if (nt <= 8) return launch<8>(a, batch, stream);
  if (nt <= 10) return launch<10>(a, batch, stream);
  if (nt <= 16) return launch<16>(a, batch, stream);
  if (nt <= 24) return launch<24>(a, batch, stream);
  if (nt <= 32) return launch<32>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tf32

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return 256; }

// dtype: 0 float32, 1 bfloat16. Strides in elements; the last dim of
// every operand is dense. kernel (the wrapper's which_kernel): 0 the SIMT
// kernel, 1 the bfloat16 tensor-core kernel, 2 the split-TF32 float32 one
// (1 and 2 are refused where their rule does not hold). Launch on
// `stream`; returns cudaGetLastError() (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int hq, int hkv,
                           int sq, int sk, int d, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, float scale,
                           int causal, int window, int kernel,
                           void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q,    k,    v,    o,    hq,   hkv,  sq,    sk,
                    d,    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb,
                    v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    if (!tc::takes(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::launch_np(a, batch, s));
  }
  if (kernel == 2) {
    if (!tf32::takes(a, dtype))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tf32::launch_nt(a, batch, s));
  }
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = dtype == 0
                              ? launch_nc<float>(a, batch, s)
                              : launch_nc<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(err);
}

}  // extern "C"
