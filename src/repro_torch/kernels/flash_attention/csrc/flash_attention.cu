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
// masked too. Masked logits are -1e30, as in the Pallas kernel (the
// bfloat16 kernel's are -inf inside its FMA: the same zero weight), and
// key tiles that no row of a query tile can see are skipped. m, l and acc
// are float32; the output is acc / max(l, 1e-30) in q's type, written
// into the (B, Sq, Hq, D) storage the caller views without a copy.
// A row that sees no key (with a window, query positions from
// Sk + window - 1 on; no path makes one) has no defined answer, and the
// kernels differ there: the bfloat16 kernel outputs 0 (its P is 0 at
// every masked key); the SIMT and split-TF32 kernels the mean of V over
// the keys of the tiles they visit (0 where they visit none); ref.py the
// mean of V over all Sk keys.
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
//   q, k, v with D a multiple of 16 (up to 256), 16-byte-aligned bases,
//   strides that are multiples of 8 elements and a positive scale. A
//   block owns 128 query rows of one (batch, head) and is warp
//   specialised: a producer warpgroup, one thread of which keeps TMA loads
//   in flight (`setmaxnreg` leaves it 24 registers), and two consumer
//   warpgroups of 64 rows each that only compute (240 registers each).
//   Q, K and V come in through 4-D tensor maps (D, S, H, B) encoded on
//   the host over the strided views (cuTensorMapEncodeTiled through the
//   runtime's driver entry point: no libcuda at link time) and passed as
//   a __grid_constant__, so a graph replay holds them; TMA writes the
//   128-byte swizzle that the wgmma descriptors read, and fills rows past
//   Sk and columns past D with zeros, so the ragged tail costs no
//   instruction. K and V tiles have rings of their own, two stages each
//   (three and four measured the same), each stage with a full and an
//   empty mbarrier.
//   Key tiles are 128 keys up to D 128 and 64 above, so that O, S and
//   P's two terms fit 240 registers with no spill. D 80 is a 64-column
//   panel and a 16-column one in the 32-byte swizzle: 5 k-steps in
//   Q K^T, n 64 + 16 in P V, not the 8 of D 128. In each consumer
//   S(j) = Q K(j)^T (wgmma, A and B from shared memory) is issued with
//   O += P(j - 1) V(j - 1) (A from registers, V MN-major), and the
//   softmax of tile j runs while P V does (wgmma.wait_group 1); the two
//   warpgroups take turns issuing on named barriers, so that one's
//   softmax runs under the other's products. No __syncthreads in the
//   key loop. P enters as two bf16 terms, P rounded and the remainder
//   rounded, each one wgmma: the Pallas kernel multiplies P V in
//   float32, and one bf16 P (off by up to 2^-9) moves a bf16 output of
//   magnitude 4 or more across a rounding boundary (a 1/32 error, past
//   the 2e-2 tolerance); the two terms hold P to about 2^-17. The
//   softmax is float32 in the log2 domain, 2^x on ex2.approx, the scale
//   folded into one FMA with the row max; only tiles on the diagonal,
//   the window's edge or the ragged end of Sk are masked, by per-row key
//   bounds. Blocks take (batch, head) pairs in chunks whose K and V fit
//   in L2, the longest causal tiles first in each chunk: one head per
//   block in turn would stream K and V from device memory. What bounds
//   it: three products a (query, key) pair (6 D operations against the
//   4 D one bf16 P would need) at 989 TFLOP/s, and the softmax's 2^x
//   and conversions at D 64; PERF.md has its time against the bound.
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

#include <cuda.h>
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


// ------------------------------------------------------------ cp.async
// 16-byte copies for the split-TF32 kernel's ring
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

// ------------------------------------------------- tensor-core kernel (bf16)
namespace tc {

constexpr int kBQ = 128;          // query rows a block: two consumer warpgroups
constexpr int kThreads = 384;     // the producer warpgroup, then two consumers
constexpr int kStages = 2;        // K tiles in their ring, V tiles in theirs
constexpr int kPanelCols = 64;    // a panel row: 128 bytes, 128-byte swizzle
constexpr int kTailCols = 16;     // a tail row: 32 bytes, 32-byte swizzle
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint64_t kSwizzle128 = 1;  // the descriptors' layout codes
constexpr uint64_t kSwizzle32 = 3;
constexpr float kLog2e = 1.4426950408889634f;

// The head dim as NP 64-column panels and, with TAIL, one 16-column panel
// after them (D 80 = 64 + 16: both products take 5 k-steps of 16 columns,
// not 8). Columns past D are zeros from TMA's fill. BK keys a tile: 128
// up to 128 columns, 64 above, which holds O, S and P's two terms (D / 2
// + BK registers a thread) under 240.
template <int NP, int TAIL>
struct Geo {
  static constexpr int kCols = kPanelCols * NP + kTailCols * TAIL;
  static constexpr int kBK = kCols <= 128 ? 128 : 64;
  static constexpr int kTailRegs = TAIL != 0 ? 8 : 1;  // O's tail fragment
  static constexpr uint32_t q_panel = kBQ * 128;  // bytes
  static constexpr uint32_t q_bytes = NP * q_panel + TAIL * kBQ * 32;
  static constexpr uint32_t t_panel = kBK * 128;
  static constexpr uint32_t tile_bytes = NP * t_panel + TAIL * kBK * 32;
  static constexpr uint32_t k_off = q_bytes;  // stage s: k_off + s * tile
  static constexpr uint32_t v_off = k_off + kStages * tile_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * tile_bytes;
  // the ring's barriers: Q's, then per stage K full, K empty, V full and
  // V empty; 1024 bytes of slack align the panels to the swizzle atoms
  static constexpr uint32_t bytes = 1024 + bar_off + 8 * (1 + 4 * kStages);
};

// The kernel's parameters: tensor maps over q, k and v (64-column boxes
// with the 128-byte swizzle; 16-column boxes with the 32-byte swizzle for
// the tail), passed by value as a __grid_constant__, so that a graph
// replay holds them.
struct TcParams {
  CUtensorMap q, k, v;
  CUtensorMap qt, kt, vt;
  void* o;
  long long o_sb, o_sh, o_ss;
  int batch, hq, hkv, sq, sk;
  int d;
  int chunk;  // (batch, head) pairs a chunk of the grid
  float scale;
  int causal, window;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-D tensor map (D, S, H, B) into shared memory; its bytes
// complete the transaction count of `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// named barriers between the two consumer warpgroups (128 + 128 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// fence / commit / wait (and from reusing an in-flight operand's registers)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor; lbo / sbo in bytes, `layout` the
// swizzle (kSwizzle128 or kSwizzle32). Adding a byte offset >> 4 to it
// moves its start (addresses stay below 2^18).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// d (64xN, f32) = (accumulate ? d : 0) + A (64x16, K-major in shared
// memory) * B (16xN, K-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);
// d (64xN, f32) += A (64x16 bf16 in registers) * B (16xN, MN-major in
// shared memory: the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (x0, x1) as two packed bf16 pairs: the rounded values, and the
// remainders x - rounded, rounded in turn (hi + lo holds x to ~2^-17)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x is low
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x in one MUFU op (flushes denormal results to 0: p, alpha >= 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one key tile for a warpgroup's 64 rows (q: its rows in the
// first Q panel, qt: in Q's tail; k: the K tile): 4 NP k-steps of 16
// columns in the 128-byte panels, then one in the tail
template <int NP, int TAIL>
__device__ __forceinline__ void issue_s(float (&s)[Geo<NP, TAIL>::kBK / 2],
                                        uint32_t q, uint32_t qt, uint32_t k) {
  using G = Geo<NP, TAIL>;
  const uint64_t dq = make_desc(q, 16, 1024, kSwizzle128);
  const uint64_t dk = make_desc(k, 16, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk)
    wgmma_ss<G::kBK>(s, dq + (((kk >> 2) * G::q_panel + (kk & 3) * 32) >> 4),
                     dk + (((kk >> 2) * G::t_panel + (kk & 3) * 32) >> 4),
                     kk > 0);
  if constexpr (TAIL != 0)
    wgmma_ss<G::kBK>(s, make_desc(qt, 16, 256, kSwizzle32),
                     make_desc(k + NP * G::t_panel, 16, 256, kSwizzle32), 1);
}

// O += P V of one key tile (v: the V tile), P as its two bf16 terms: per
// 16 keys one product over the 64 NP panel columns (the panels LBO apart)
// and one over the tail's 16, for each term
template <int NP, int TAIL>
__device__ __forceinline__ void issue_pv(
    float (&o)[32 * NP], float (&ot)[Geo<NP, TAIL>::kTailRegs],
    const uint32_t (&ph)[Geo<NP, TAIL>::kBK / 16][4],
    const uint32_t (&pl)[Geo<NP, TAIL>::kBK / 16][4], uint32_t v) {
  using G = Geo<NP, TAIL>;
  const uint64_t dv = make_desc(v, G::t_panel, 1024, kSwizzle128);
  const uint64_t dvt = make_desc(v + NP * G::t_panel, 256, 256, kSwizzle32);
#pragma unroll
  for (int kk = 0; kk < G::kBK / 16; ++kk) {
    wgmma_rs<64 * NP>(o, ph[kk], dv + ((kk * 16 * 128) >> 4));
    wgmma_rs<64 * NP>(o, pl[kk], dv + ((kk * 16 * 128) >> 4));
    if constexpr (TAIL != 0) {
      wgmma_rs<16>(ot, ph[kk], dvt + ((kk * 16 * 32) >> 4));
      wgmma_rs<16>(ot, pl[kk], dvt + ((kk * 16 * 32) >> 4));
    }
  }
}

// The online softmax of one tile's S fragment, in place, in the log2
// domain: m is the scaled row max, P = 2^(s c - m) with the scale c
// folded into one FMA. Where `edge`, masked logits become -inf, whose P
// is exactly 0 (a finite sentinel would not do: the FMA keeps the
// rounding error of its product, ~1e22 for -1e30, and 2 to that is inf);
// m starts at -1e30, so a row with no key yet stays finite. The thread's
// rows are row0 and row0 + 8, its columns 8 j + col0 + {0, 1}. l is the
// thread's part of each row's sum (the four lanes of a row add theirs at
// the end); alpha rescales the carry.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int row0, int col0,
                                             int sk, int causal, int window,
                                             float scale_log2) {
  if (edge) {
    // each row's visible keys as bounds on the column 8 j + e past
    // k0 + col0: two compares an element
    const float masked = -__int_as_float(0x7f800000);  // -inf
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = row0 + 8 * i;
      hi[i] = (causal ? min(sk - 1, qpos) : sk - 1) - k0 - col0;
      lo[i] = window > 0 ? qpos - window + 1 - k0 - col0 : -(1 << 30);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          if (c > hi[i] || c < lo[i]) s[4 * j + 2 * i + e] = masked;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = s[2 * i];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = fast_exp2(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            fast_exp2(fmaf(s[4 * j + 2 * i + e], scale_log2, -m_new));
        s[4 * j + 2 * i + e] = p;
        sum += p;
      }
    l[i] = l[i] * alpha[i] + sum;
  }
}

// P as wgmma's A operand: the S fragment of keys 16 kk .. packed in place,
// as its bf16 rounding (ph) and the remainder (pl)
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], ph[kk][q],
                 pl[kk][q]);
}

// one K or V tile: its NP panels and its tail, rows [row, row + BK)
template <int NP, int TAIL>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          const CUtensorMap* tail, int row,
                                          int h, int b, uint32_t bar) {
  using G = Geo<NP, TAIL>;
#pragma unroll
  for (int c = 0; c < NP; ++c)
    tma_load(dst + c * G::t_panel, map, kPanelCols * c, row, h, b, bar);
  if constexpr (TAIL != 0)
    tma_load(dst + NP * G::t_panel, tail, kPanelCols * NP, row, h, b, bar);
}

template <int NP, int TAIL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ TcParams p) {
  using G = Geo<NP, TAIL>;
  constexpr int kBK = G::kBK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t qs =  // swizzle atoms: 1024-aligned
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t bars = qs + G::bar_off;
  const uint32_t q_full = bars;
  const auto k_full = [&](int s) { return bars + 8 * (1 + 4 * s); };
  const auto k_empty = [&](int s) { return bars + 8 * (2 + 4 * s); };
  const auto v_full = [&](int s) { return bars + 8 * (3 + 4 * s); };
  const auto v_empty = [&](int s) { return bars + 8 * (4 + 4 * s); };
  const auto k_tile = [&](int s) { return qs + G::k_off + s * G::tile_bytes; };
  const auto v_tile = [&](int s) { return qs + G::v_off + s * G::tile_bytes; };

  const int tid = threadIdx.x;
  // the warpgroup, broadcast so the compiler sees it warp-uniform: 0 the
  // producer, 1 and 2 the consumers
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // (batch, head) pairs in chunks whose K and V fit in L2 (p.chunk of
  // them), the chunks in turn, and in each chunk the longest causal query
  // tiles first: the blocks on the card share their heads' K and V in L2
  // (every head at once would stream them from device memory), and the
  // longest tiles still start first
  const int n_q = (p.sq + kBQ - 1) / kBQ;
  const int first = static_cast<int>(blockIdx.x) / (p.chunk * n_q) * p.chunk;
  const int heads = min(p.chunk, p.batch * p.hq - first);
  const int r = static_cast<int>(blockIdx.x) - first * n_q;
  const int b = (first + r % heads) / p.hq;
  const int h = (first + r % heads) % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (n_q - 1 - r / heads) * kBQ;

  // key tiles some row of the block can see; both consumers walk them all
  int k_lo = 0;
  int k_hi = p.sk;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(p.sk, q0 + kBQ);
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(q_full, G::q_bytes);
#pragma unroll
      for (int c = 0; c < NP; ++c)
        tma_load(qs + c * G::q_panel, &p.q, kPanelCols * c, q0, h, b, q_full);
      if constexpr (TAIL != 0)
        tma_load(qs + NP * G::q_panel, &p.qt, kPanelCols * NP, q0, h, b,
                 q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        const int k0 = k_lo + j * kBK;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), G::tile_bytes);
        load_tile<NP, TAIL>(k_tile(s), &p.k, &p.kt, k0, hk, b, k_full(s));
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), G::tile_bytes);
        load_tile<NP, TAIL>(v_tile(s), &p.v, &p.vt, k0, hk, b, v_full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // a consumer: query rows qw0 .. qw0 + 63; the thread's fragment rows
  // are row0 and row0 + 8
  const int cw = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qw0 = q0 + 64 * cw;
  const int row0 = qw0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t q_rows = qs + cw * 64 * 128;
  const uint32_t qt_rows = qs + NP * G::q_panel + cw * 64 * 32;
  // named barriers 1 and 2: each warpgroup's turn to issue its products,
  // so that one warpgroup's softmax runs under the other's products
  const int mine = 1 + cw;
  const int other = 2 - cw;

  float o[32 * NP], ot[G::kTailRegs];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < G::kTailRegs; ++i) ot[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  float s[kBK / 2];
  uint32_t ph[kBK / 16][4], pl[kBK / 16][4];

  // the mask only on tiles at the diagonal, the window's edge or Sk's end
  const auto edge = [&](int k0) {
    return k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > qw0) ||
           (p.window > 0 && k0 <= qw0 + 63 - p.window);
  };

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    if (cw == 1) bar_arrive(1);  // the first turn is warpgroup 0's
    // S(0), alone
    mbar_wait(k_full(0), 0);
    bar_sync(mine);
    fence_regs(s);
    wgmma_fence();
    issue_s<NP, TAIL>(s, q_rows, qt_rows, k_tile(0));
    wgmma_commit();
    fence_regs(s);
    bar_arrive(other);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile<kBK>(s, m, l, alpha, edge(k_lo), k_lo, row0, col0, p.sk,
                      p.causal, p.window, scale_log2);
    split_p<kBK>(s, ph, pl);

    // S(j) and P(j - 1) V(j - 1) issued together; softmax(j) runs while
    // the P V product does (wait_group 1), and while the other
    // warpgroup's products do
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;
      const int k0 = k_lo + j * kBK;
      mbar_wait(k_full(st), (j / kStages) & 1);
      mbar_wait(v_full(pst), ((j - 1) / kStages) & 1);
      bar_sync(mine);
      fence_regs(s);
      fence_regs(o);
      fence_regs(ot);
      wgmma_fence();
      issue_s<NP, TAIL>(s, q_rows, qt_rows, k_tile(st));
      wgmma_commit();
      issue_pv<NP, TAIL>(o, ot, ph, pl, v_tile(pst));
      wgmma_commit();
      fence_regs(s);
      fence_regs(o);
      fence_regs(ot);
      bar_arrive(other);
      wgmma_wait<1>();  // S(j) landed; P V may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty(st));
      softmax_tile<kBK>(s, m, l, alpha, edge(k0), k0, row0, col0, p.sk,
                        p.causal, p.window, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ot);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(v_empty(pst));
#pragma unroll
      for (int jj = 0; jj < 8 * NP; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * jj + 2 * i] *= alpha[i];
          o[4 * jj + 2 * i + 1] *= alpha[i];
        }
      if constexpr (TAIL != 0) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ot[4 * jj + 2 * i] *= alpha[i];
            ot[4 * jj + 2 * i + 1] *= alpha[i];
          }
      }
      split_p<kBK>(s, ph, pl);
    }

    // the last tile's P V, alone
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
    bar_sync(mine);
    fence_regs(o);
    fence_regs(ot);
    wgmma_fence();
    issue_pv<NP, TAIL>(o, ot, ph, pl, v_tile(last));
    wgmma_commit();
    fence_regs(o);
    fence_regs(ot);
    // warpgroup 1 takes no turn after this one: its arrivals at
    // warpgroup 0's barrier match warpgroup 0's waits
    if (cw == 0) bar_arrive(other);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ot);
    fence_regs(ph);
    fence_regs(pl);
  }

  // the four lanes of a row add their sums
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    den[i] = fmaxf(sum, 1e-30f);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= p.sq) continue;
    __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < 8 * NP; ++jj) {
      const int col = 8 * jj + col0;
      if (col < p.d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * jj + 2 * i] / den[i],
                                  o[4 * jj + 2 * i + 1] / den[i]);
    }
    if constexpr (TAIL != 0) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = kPanelCols * NP + 8 * jj + col0;
        if (col < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(ot[4 * jj + 2 * i] / den[i],
                                    ot[4 * jj + 2 * i + 1] / den[i]);
      }
    }
  }
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// that the library links no libcuda; null where the CUDA driver lacks it
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The geometry of one operand's tensor map: a (B, H, S, D) bfloat16
// operand read through its strides (in elements), as 4-D dims (D, S, H,
// B), innermost first, with the byte strides of S, H and B (a dim of
// size 1 takes a stride of 16 bytes where its own is 0), and boxes of
// `cols` x `rows` x 1 x 1. S is at least 1: a map is never empty.
struct MapGeometry {
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];
};

MapGeometry map_geometry(int d, int s, int h, int b, long long ss,
                         long long sh, long long sb, int cols, int rows) {
  MapGeometry g{};
  const long long size[3] = {s < 1 ? 1 : s, h, b};
  const long long stride[3] = {ss, sh, sb};
  g.dims[0] = static_cast<cuuint64_t>(d);
  for (int i = 0; i < 3; ++i) {
    g.dims[i + 1] = static_cast<cuuint64_t>(size[i]);
    const long long bytes = 2 * stride[i];
    g.strides[i] = static_cast<cuuint64_t>(
        size[i] == 1 && bytes == 0 ? 16 : bytes);
  }
  g.box[0] = static_cast<cuuint32_t>(cols);
  g.box[1] = static_cast<cuuint32_t>(rows);
  g.box[2] = g.box[3] = 1;
  return g;
}

bool encode(CUtensorMap* map, const void* base, const MapGeometry& g,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            g.dims, g.strides, g.box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of q, k and v for an instance: 64-column boxes of BQ rows (q)
// or BK rows (k, v), and, with a tail, 16-column ones
template <int NP, int TAIL>
bool encode_maps(TcParams& p, const FlashArgs& a, int batch) {
  using G = Geo<NP, TAIL>;
  const int cols[2] = {kPanelCols, kTailCols};
  const CUtensorMapSwizzle swizzle[2] = {CU_TENSOR_MAP_SWIZZLE_128B,
                                         CU_TENSOR_MAP_SWIZZLE_32B};
  CUtensorMap* maps[2][3] = {{&p.q, &p.k, &p.v}, {&p.qt, &p.kt, &p.vt}};
  for (int t = 0; t < 1 + TAIL; ++t) {
    const bool ok =
        encode(maps[t][0], a.q,
               map_geometry(a.d, a.sq, a.hq, batch, a.q_ss, a.q_sh, a.q_sb,
                            cols[t], kBQ),
               swizzle[t]) &&
        encode(maps[t][1], a.k,
               map_geometry(a.d, a.sk, a.hkv, batch, a.k_ss, a.k_sh, a.k_sb,
                            cols[t], G::kBK),
               swizzle[t]) &&
        encode(maps[t][2], a.v,
               map_geometry(a.d, a.sk, a.hkv, batch, a.v_ss, a.v_sh, a.v_sb,
                            cols[t], G::kBK),
               swizzle[t]);
    if (!ok) return false;
  }
  return true;
}

// (batch, head) pairs whose K and V fill about a third of the 50 MB L2
// (a q head's share of its kv head's K and V: 4 S D bytes over the group)
int chunk_heads(const FlashArgs& a, int batch) {
  const double share = 4.0 * a.sk * a.d / (a.hq / a.hkv);
  const double fit = share > 0 ? 16.0 * 1024 * 1024 / share : 1e9;
  return static_cast<int>(fmin(fmax(fit, 1.0), 1.0 * batch * a.hq));
}

template <int NP, int TAIL>
cudaError_t launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  using G = Geo<NP, TAIL>;
  TcParams p{};
  // a map the CUDA driver will not encode is refused, never worked around
  if (!encode_maps<NP, TAIL>(p, a, batch)) return cudaErrorInvalidValue;
  p.o = a.o;
  p.o_sb = a.o_sb;
  p.o_sh = a.o_sh;
  p.o_ss = a.o_ss;
  p.batch = batch;
  p.hq = a.hq;
  p.hkv = a.hkv;
  p.chunk = chunk_heads(a, batch);
  p.sq = a.sq;
  p.sk = a.sk;
  p.d = a.d;
  p.scale = a.scale;
  p.causal = a.causal;
  p.window = a.window;
  auto kernel = flash_attention_tc_kernel<NP, TAIL>;
  const int smem = static_cast<int>(G::bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(batch) * a.hq * ((a.sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the wrapper's takes_tensor_cores, checked again: bfloat16, D a multiple
// of 16 up to 256, 16-byte-aligned bases, strides of 8-element multiples;
// and a positive scale (the row max is taken before scaling)
bool takes(const FlashArgs& a, int dtype) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh,
                               a.k_ss, a.v_sb, a.v_sh, a.v_ss};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return dtype == 1 && a.d % 16 == 0 && a.d <= 256 && a.scale > 0.0f &&
         aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.o) &&
         a.o_ss % 2 == 0;
}

// the instances: D 80 as a panel and a tail; any other D as 64-column
// panels, its columns past D zeros
cudaError_t launch_np(const FlashArgs& a, int batch, cudaStream_t stream) {
  if (a.d == 80) return launch<1, 1>(a, batch, stream);
  switch ((a.d + 63) / 64) {
    case 1: return launch<1, 0>(a, batch, stream);
    case 2: return launch<2, 0>(a, batch, stream);
    case 3: return launch<3, 0>(a, batch, stream);
    case 4: return launch<4, 0>(a, batch, stream);
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
    cp_async16(static_cast<uint32_t>(
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
  cp_async_commit();

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
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile it (and Q)
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

// The geometry flash_attention_launch gives the tensor map of a (B, H, S,
// D) bfloat16 operand (strides in elements) with boxes of cols x rows:
// out[0..3] the dims (D, S, H, B), out[4..6] the byte strides of S, H and
// B, out[7..10] the box. For the card tests, which hold it to literal
// values.
void flash_attention_tc_map_geometry(int d, int s, int h, int b,
                                     long long ss, long long sh,
                                     long long sb, int cols, int rows,
                                     unsigned long long* out) {
  const tc::MapGeometry g = tc::map_geometry(d, s, h, b, ss, sh, sb, cols,
                                             rows);
  for (int i = 0; i < 4; ++i) out[i] = g.dims[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = g.strides[i];
  for (int i = 0; i < 4; ++i) out[7 + i] = g.box[i];
}

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
