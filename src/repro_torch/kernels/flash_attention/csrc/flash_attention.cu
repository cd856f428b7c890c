// Flash-attention forward on Hopper (sm_90a): the LM stack's prefill.
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
// near the bound. Two kernels, chosen by one rule in the wrapper
// (kernel.py::takes_tensor_cores), never by a retry:
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
//   shared memory as an MN-major B operand (the transpose bit). The head
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
// * flash_attention_kernel, the SIMT kernel, takes everything else:
//   float32 (TF32 keeps about 10 mantissa bits and cannot hold the
//   reference's float32 tolerance of 2e-5), and bfloat16 with a head dim
//   that is not a multiple of 16 or operands that break 16-byte
//   alignment. 8 warps; warp w owns query rows 8w..8w+7 of a 64-row tile,
//   lane j owns keys j and j+32 of each 64-key tile, so a row's softmax
//   is one warp's shuffle reduction. Q is staged once as float32 in
//   shared memory, each K tile transposed (rows padded to 65 floats) and
//   each V tile as is; the products are float32 FMAs. Any Sq, Sk and
//   D <= 256.
//
// Build without --use_fast_math: the SIMT kernel's expf must be accurate
// to hold the float32 tolerance of the reference (2e-5). The bfloat16
// tensor-core kernel takes 2^x from ex2.approx (held to 2e-2).

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

      // P as the A operand: the S fragment of keys 16 kk .. packed in place
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V, one 64-column panel of the head dim at a time
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(o[p], pa[kk],
                   sw128_desc(vs + p * (kBK * kRowBytes) +
                                  kk * 16 * kRowBytes,
                              kBK * kRowBytes, 1024));
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

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return 256; }

// dtype: 0 float32, 1 bfloat16. Strides in elements; the last dim of
// every operand is dense. tensor_cores: 1 runs the tensor-core kernel
// (the wrapper's takes_tensor_cores held; refused otherwise), 0 the SIMT
// kernel. Launch on `stream`; returns cudaGetLastError() (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int hq, int hkv,
                           int sq, int sk, int d, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, float scale,
                           int causal, int window, int tensor_cores,
                           void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q,    k,    v,    o,    hq,   hkv,  sq,    sk,
                    d,    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb,
                    v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!tc::takes(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::launch_np(a, batch, s));
  }
  const cudaError_t err = dtype == 0
                              ? launch_nc<float>(a, batch, s)
                              : launch_nc<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(err);
}

}  // extern "C"
