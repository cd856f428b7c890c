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
// (float or bfloat16). Any D <= 256, any group size, K and V read
// through their strides with a dense last dim.
//
// What bounds it: decode reads every valid K and V element once and
// does 4 flops per element per query head, 4 to 16 flops a byte at
// groups 4 to 16: far below the H100's ridge, so the bound is
// device-memory bandwidth. At decode's batch of 8 the bytes are few
// (4 to 34 MB at the serving paths' shapes with 512 keys a row: 1.3 to
// 10 us at 3.35 TB/s), so what decides the time is whether every SM has
// work and how long each block's serial chain is. The earlier design
// lost on both counts at wide groups and D 256 (measured: one 128-key
// block took ~39 us at D 256 whatever the grid, ~4,100 dependent FMAs
// a thread): splits of the cache's capacity left half of every grid
// idle at half-full caches, D 256 ran 32 to 64 blocks with keys on 132
// SMs, and each thread ran a D-long chain of dependent FMAs per head,
// for dead heads too.
//
// The design, a split kernel and a combine kernel launched back to back
// by one C entry point:
//
// * The splits cut the valid length, not the capacity. split_range
//   gives split s of n_split the keys [s P, (s + 1) P) cut at the
//   length, P = ceil(ceil(len / 16) / n_split) 16-key chunks, computed
//   in the kernel from lengths[b]: n_split is a function of the shapes
//   alone (the wrapper never reads lengths on the host), so a captured
//   CUDA graph stays right when lengths changes in place, and every
//   split of a full-length batch has keys to read.
// * decode_split_tc_kernel (bfloat16 q and cache, D a multiple of 8,
//   rows 16-byte aligned): the group's products on tensor cores,
//   mma.sync m16n8k16 (bf16 in, float32 accumulate), the roles turned
//   so the 16 rows are keys or head dims and the 8 columns heads:
//   S^T = K q^T and O^T += V^T P^T. A group of up to 8 heads is one
//   8-column tile, of up to 16 two (recurrentgemma's 10, command-r-
//   plus's 12: one block, no dead-head arithmetic beyond the tile);
//   larger groups take blocks of 16. Grid (B*Hkv, head tiles, n_split),
//   4 warps a block. q is staged once by 16-byte cp.async issued before
//   lengths is read; the split streams through 64-key tiles of K and V,
//   two in flight by 16-byte cp.async (rows past the split and the pad
//   past D zero-filled). In each tile warp w computes S^T for the w-th
//   16-key chunk (a loop over D / 16 mma steps: no thread runs a D-long
//   chain), the block takes each head's max over the chunks in order
//   through shared memory, warp w turns its chunk into P^T (movmatrix
//   turns the accumulator into the B operand), and each warp multiplies
//   every chunk into O^T for its own quarter of the head dim (D / 64
//   16-row tiles), so the warps never merge partial outputs. The loops
//   over the D steps and the chunks are not unrolled: at decode's few
//   keys a block the code runs once per block, and a first version with
//   them unrolled (whole D a warp, 200 registers at D 256) took about
//   twice as long a block at 16 keys (PERF.md). P enters P.V as
//   two bf16 terms, P rounded and the rounding's remainder, each one
//   mma: the Pallas kernel multiplies P V in float32, and one bf16 P
//   moves a bfloat16 output by an ulp at outputs of magnitude 4 and
//   more (the flash-attention kernel's finding at D 256).
// * decode_split_simt_kernel (float32 q or cache, the mixed types, rows
//   not 16-byte aligned): float32 FMAs; a block of 4 warps reads its
//   split for up to 8 heads in tiles of 64 keys (32 above 400 bytes a
//   row) double-buffered by 16-byte cp.async, or scalar loads where
//   rows are not 16-byte aligned; thread j computes key j's logits,
//   each warp runs the online softmax of up to two heads, and thread t
//   accumulates P.V for one column pair of its heads.
// * Either writes a float32 partial (m, l, acc[D]) per head and split to
//   a workspace the wrapper allocates (a split past the length writes
//   the empty partial m = -1e30, l = 0, acc = 0), and
//   decode_combine_kernel, one block per (batch, q-head), merges the
//   n_split partials in split order and writes acc / max(l, 1e-30) in
//   q's type.
//
// No atomics: every sum runs in a fixed order, so outputs are
// bit-identical from run to run. Build without --use_fast_math: expf
// must hold the float32 tolerance (2e-5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupTile = 8;     // heads a SIMT block
constexpr int kTcHeadTile = 16;      // heads a tensor-core block
constexpr int kChunk = 16;           // keys a chunk (one mma's rows)
constexpr int kTcTile = 64;          // keys a tensor-core tile: 4 chunks
constexpr int kStages = 2;           // tiles in flight a block
constexpr int kMaxSmemBytes = 232448;  // per block on Hopper
constexpr int kMaxSplits = 4096;       // the combine's 48 KB of (m, l, w)
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
  int n_split;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
};

// keys [lo, hi) of split `split` of batch row b: the valid length cut
// into n_split runs of whole 16-key chunks (the last ones may be short
// or empty)
__device__ __forceinline__ void split_range(const DecodeArgs& a, int b,
                                            int split, int& lo, int& hi) {
  const int len = max(0, min(a.lengths[b], a.s));
  const int chunks = (len + kChunk - 1) / kChunk;
  const int per = (chunks + a.n_split - 1) / a.n_split;
  lo = min(split * per * kChunk, len);
  hi = min(lo + per * kChunk, len);
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// 16 bytes from src, or 16 zero bytes (nothing read) where !live
__device__ __forceinline__ void cp_async16_or_zero(void* dst,
                                                   const void* src,
                                                   bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most n of this thread's latest cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// the empty partial of heads [0, ng) of a split: m = -1e30, l = 0,
// acc = 0 (head g's pair at ml + 2 g n_split, its acc at acc_out + g
// n_split d)
__device__ __forceinline__ void write_empty(float* ml, float* acc_out,
                                            int ng, int n_split, int d,
                                            int tid) {
  for (int i = tid; i < ng * d; i += kThreads)
    acc_out[static_cast<long long>(i / d) * n_split * d + i % d] = 0.0f;
  if (tid < ng) {
    ml[2 * tid * n_split] = kNegInf;
    ml[2 * tid * n_split + 1] = 0.0f;
  }
}

// ------------------------------------------------- tensor-core split kernel
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}
// the 8x8 bf16 matrix a warp holds as one register a lane, transposed
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is low
  return *reinterpret_cast<const uint32_t*>(&v);
}

// DSW: 16-wide head-dim tiles each warp owns in P.V (the instance holds
// D <= 64 DSW); NT: 8-head column tiles (a block's heads: 8 NT)
template <int DSW, int NT>
struct TcLayout {
  static constexpr int kDs = kWarps * DSW;  // 16-wide steps of the dim
  // a staged row: kDs 32-byte steps and 16 bytes more, an odd number of
  // 16-byte chunks, so ldmatrix's 8 rows fall in distinct banks
  static constexpr int kRow = kDs * 32 + 16;
  static constexpr int kTileBytes = kTcTile * kRow;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQ = kStages * kStageBytes;              // q rows
  static constexpr int kP = kQ + NT * 8 * kRow;                 // P^T
  static constexpr int kPWords = 4 * NT;  // a lane's P^T words a chunk
  static constexpr int kMax = kP + kWarps * kPWords * 32 * 4;   // maxima
  static constexpr int kSum = kMax + kWarps * 16 * 4;           // sums
  static constexpr int kSmem = kSum + kWarps * 16 * 4;
};

template <int DSW, int NT>
__global__ void __launch_bounds__(kThreads)
    decode_split_tc_kernel(const DecodeArgs a) {
  using L = TcLayout<DSW, NT>;
  constexpr int kHeads = NT * 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem + L::kQ;  // [head][row]
  // P^T fragments [chunk][word][lane]; each chunk's maxima and sums
  // [chunk][head]
  uint32_t* pf = reinterpret_cast<uint32_t*>(smem + L::kP);
  float* mx_s = reinterpret_cast<float*>(smem + L::kMax);
  float* sum_s = reinterpret_cast<float*>(smem + L::kSum);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r8 = lane >> 2;  // an mma fragment's row (of 8)
  const int c4 = lane & 3;   // its column pair
  const int group = a.hq / a.hkv;
  const int b = blockIdx.x / a.hkv;
  const int hk = blockIdx.x % a.hkv;
  const int g0 = blockIdx.y * kHeads;
  const int ng = min(kHeads, group - g0);
  const long long bh0 = static_cast<long long>(b) * a.hq + hk * group + g0;
  const int split = blockIdx.z;
  const int ds = (a.d + 15) / 16;  // 16-wide steps of this head dim
  const int dc = a.d / 8;          // 16-byte chunks of data a row
  const int rc = 2 * ds;           // and with the zero pad

  // q once per block by 16-byte copies (heads past the group and the pad
  // past D zero), issued first: it waits on nothing
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.q_sb + (hk * group + g0) * a.q_sh;
  for (int i = tid; i < kHeads * rc; i += kThreads) {
    const int g = i / rc, x = i - g * rc;
    const bool live = g < ng && x < dc;
    cp_async16_or_zero(qs + g * L::kRow + x * 16,
                       live ? qb + g * a.q_sh + x * 8 : qb, live);
  }
  cp_async_commit();

  int p_lo, p_hi;
  split_range(a, b, split, p_lo, p_hi);
  const int n_tiles = (p_hi - p_lo + kTcTile - 1) / kTcTile;
  float* ml = a.ws + (bh0 * a.n_split + split) * 2;
  float* acc_out = a.ws + static_cast<long long>(a.batch) * a.hq *
                              a.n_split * 2 +
                   (bh0 * a.n_split + split) * a.d;
  if (n_tiles == 0) {
    cp_async_wait<0>();
    write_empty(ml, acc_out, ng, a.n_split, a.d, tid);
    return;
  }

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.v_sb + hk * a.v_sh;
  // thread (jr, x): 16-byte column x of rows jr, jr + rpt, ... (rc <= 32)
  const int rpt = kThreads / rc;
  const int jr = tid / rc;
  const int x = tid - jr * rc;
  // tile t of the split into stage st: K then V rows, rows past the
  // split and the pad past D zero-filled
  auto load = [&](int t, int st) {
    if (jr >= rpt) return;
    const int j0 = p_lo + t * kTcTile;
    uint8_t* kd = smem + st * L::kStageBytes + x * 16;
    uint8_t* vd = kd + L::kTileBytes;
    for (int j = jr; j < kTcTile; j += rpt) {
      const bool live = j0 + j < p_hi && x < dc;
      const long long jj = live ? j0 + j : 0;
      const int xx = live ? x * 8 : 0;
      cp_async16_or_zero(kd + j * L::kRow, kb + jj * a.k_ss + xx, live);
      cp_async16_or_zero(vd + j * L::kRow, vb + jj * a.v_ss + xx, live);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) load(st, st);
    cp_async_commit();
  }

  // O^T of this warp's head-dim tiles w DSW + i (16 rows each) x head
  // tile n (8 columns); the softmax carry of heads 8 n + 2 c4 + {0, 1},
  // the same in every warp
  float o[DSW][NT][4];
#pragma unroll
  for (int i = 0; i < DSW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.0f;
  float m_r[NT][2], l_r[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m_r[n][0] = m_r[n][1] = kNegInf;
    l_r[n][0] = l_r[n][1] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t (and q) in shared memory
    const uint8_t* kd = smem + st * L::kStageBytes;
    const uint8_t* vd = kd + L::kTileBytes;
    const int j0 = p_lo + t * kTcTile;
    const int live_chunks = min(kTcTile, p_hi - j0 + kChunk - 1) / kChunk;

    // S^T = K q^T for this warp's 16-key chunk: 16 keys x 8 NT heads
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    if (warp < live_chunks) {
      const uint8_t* kr = kd + (warp * kChunk + (lane & 15)) * L::kRow +
                          (lane >> 4) * 16;
      const uint8_t* qr =
          qs + (lane & 7) * L::kRow + ((lane >> 3) & 1) * 16;
#pragma unroll 1
      for (int kk = 0; kk < ds; ++kk) {
        uint32_t ka[4];
        ldsm_x4(ka, kr + kk * 32);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t qf[2];
          ldsm_x2(qf, qr + n * 8 * L::kRow + kk * 32);
          mma_16816(sc[n], ka, qf[0], qf[1]);
        }
      }
    }
    // each head's max over the chunk (a column: the 8 lanes of one c4),
    // then over the tile's chunks in order
    const int key = j0 + warp * kChunk + r8;
    const bool live0 = key < p_hi, live1 = key + 8 < p_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sc[n][h] = live0 ? sc[n][h] * a.scale : kNegInf;
        sc[n][2 + h] = live1 ? sc[n][2 + h] * a.scale : kNegInf;
        float mx = fmaxf(sc[n][h], sc[n][2 + h]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (r8 == 0) mx_s[warp * 16 + n * 8 + 2 * c4 + h] = mx;
      }
    __syncthreads();  // the chunks' maxima
    float al[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = n * 8 + 2 * c4 + h;
        float m_new = m_r[n][h];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, mx_s[w * 16 + g]);
        al[n][h] = expf(m_r[n][h] - m_new);
        m_r[n][h] = m_new;
        const float p0 = expf(sc[n][h] - m_new);
        const float p1 = expf(sc[n][2 + h] - m_new);
        sc[n][h] = p0;
        sc[n][2 + h] = p1;
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (r8 == 0) sum_s[warp * 16 + g] = sum;
      }
    // P^T as mma's B operand in two bf16 terms (P rounded, and the
    // rounding's remainder): keys 0-7 and 8-15 of the (key, head)
    // accumulator, each 8x8 transposed; to shared memory for every warp
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float x0 = sc[n][2 * half], x1 = sc[n][2 * half + 1];
        const __nv_bfloat162 r = __floats2bfloat162_rn(x0, x1);
        uint32_t* dst = pf + (warp * L::kPWords + n * 4 + half) * 32 + lane;
        dst[0] = transpose8x8(*reinterpret_cast<const uint32_t*>(&r));
        dst[2 * 32] = transpose8x8(
            pack_bf16(x0 - __low2float(r), x1 - __high2float(r)));
      }
    __syncthreads();  // P^T and the chunks' sums
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = n * 8 + 2 * c4 + h;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sum_s[w * 16 + g];
        l_r[n][h] = l_r[n][h] * al[n][h] + sum;
      }
#pragma unroll
    for (int i = 0; i < DSW; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[i][n][0] *= al[n][0];
        o[i][n][1] *= al[n][1];
        o[i][n][2] *= al[n][0];
        o[i][n][3] *= al[n][1];
      }
    // O^T += V^T P^T over the tile's chunks in order, this warp's dims
    const int mi = lane >> 3;
    const uint8_t* vr = vd + ((mi >> 1) * 8 + (lane & 7)) * L::kRow +
                        (mi & 1) * 16 + warp * DSW * 32;
#pragma unroll 1
    for (int c = 0; c < live_chunks; ++c) {
      uint32_t ph[NT][2], pl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t* src =
              pf + (c * L::kPWords + n * 4 + half) * 32 + lane;
          ph[n][half] = src[0];
          pl[n][half] = src[2 * 32];
        }
#pragma unroll
      for (int i = 0; i < DSW; ++i) {
        if (warp * DSW + i < ds) {
          uint32_t va[4];
          ldsm_x4_trans(va, vr + c * kChunk * L::kRow + i * 32);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma_16816(o[i][n], va, ph[n][0], ph[n][1]);
            mma_16816(o[i][n], va, pl[n][0], pl[n][1]);
          }
        }
      }
    }
    __syncthreads();  // stage st, P^T and the sums read: refill
    if (t + kStages < n_tiles) load(t + kStages, st);
    cp_async_commit();
  }

  // this warp's head-dim tiles of each live head; (m, l) from warp 0
#pragma unroll
  for (int i = 0; i < DSW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = n * 8 + 2 * c4 + (e & 1);
        const int col = (warp * DSW + i) * 16 + r8 + (e >> 1) * 8;
        if (g < ng && col < a.d)
          acc_out[static_cast<long long>(g) * a.n_split * a.d + col] =
              o[i][n][e];
      }
  if (warp == 0 && r8 == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = n * 8 + 2 * c4 + h;
        if (g < ng) {
          ml[2 * g * a.n_split] = m_r[n][h];
          ml[2 * g * a.n_split + 1] = l_r[n][h];
        }
      }
  }
}

// ------------------------------------------------------- SIMT split kernel
template <int GT, int TK>
__host__ __device__ __forceinline__ int split_smem_bytes(int d, int elt) {
  const int dpad = data_chunks(d, elt) * (16 / elt);
  return 4 * TK * row_bytes(d, elt) +  // 2 stages of a K and a V tile
         (GT * dpad + GT * TK + GT) * 4;  // q, scores, rescale factors
}

template <class T, int GT, int TK, bool VEC>
__global__ void __launch_bounds__(kThreads)
    decode_split_simt_kernel(const DecodeArgs a) {
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
  int p_lo, p_hi;
  split_range(a, b, split, p_lo, p_hi);
  const int n_tiles = p_hi > p_lo ? (p_hi - p_lo + TK - 1) / TK : 0;

  float* ml = a.ws + (bh0 * a.n_split + split) * 2;  // head g: + 2 g n_split
  float* acc_out = a.ws + static_cast<long long>(a.batch) * a.hq *
                              a.n_split * 2 +
                   (bh0 * a.n_split + split) * d;  // head g: + g n_split d

  if (n_tiles == 0) {  // wholly past the length: the empty partial
    write_empty(ml, acc_out, ng, a.n_split, d, tid);
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
    cp_async_wait<1>();
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

// one block per (batch, q-head), thread c per output column: the n_split
// partials' (m, l) staged in shared memory by parallel loads, each
// split's weight exp(m_s - max m) computed once, then every column's
// sum over the splits in split order
__global__ void decode_combine_kernel(const DecodeArgs a) {
  extern __shared__ float part[];  // m[n_split], l[n_split], w[n_split]
  const int n = a.n_split;
  float* m_s = part;
  float* l_s = part + n;
  float* w_s = part + 2 * n;
  const long long bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* ml = a.ws + bh * n * 2;
  const float* acc = a.ws + static_cast<long long>(a.batch) * a.hq * n * 2 +
                     bh * n * a.d;
  for (int s = c; s < n; s += blockDim.x) {
    m_s[s] = ml[2 * s];
    l_s[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, m_s[s]);
  for (int s = c; s < n; s += blockDim.x) w_s[s] = expf(m_s[s] - mx);
  __syncthreads();
  if (c >= a.d) return;
  float num = 0.0f, den = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    den = fmaf(l_s[s], w_s[s], den);
    num = fmaf(acc[static_cast<long long>(s) * a.d + c], w_s[s], num);
  }
  store_from_float(a.o, bh * a.d + c, a.q_bf16, num / fmaxf(den, 1e-30f));
}

template <class T, int GT, int TK, bool VEC>
cudaError_t launch_simt(const DecodeArgs& a, cudaStream_t stream) {
  const int smem = split_smem_bytes<GT, TK>(a.d, sizeof(T));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = decode_split_simt_kernel<T, GT, TK, VEC>;
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
  return cudaGetLastError();
}

// 16-byte loads where every cache row starts 16-byte aligned (and, with
// q too, every q row)
template <class T>
bool vector_loads(const DecodeArgs& a, bool with_q) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const long long elt = sizeof(T);
  const long long strides[] = {a.k_sb, a.k_sh, a.k_ss,
                               a.v_sb, a.v_sh, a.v_ss};
  for (long long s : strides)
    if (s * elt % 16 != 0) return false;
  if (with_q && (a.q_sb * elt % 16 != 0 || a.q_sh * elt % 16 != 0 ||
                 !aligned(a.q)))
    return false;
  return a.d * elt % 16 == 0 && aligned(a.k) && aligned(a.v);
}

template <class T, int GT>
cudaError_t launch_tile(const DecodeArgs& a, cudaStream_t stream) {
  const bool vec = vector_loads<T>(a, false);
  // 64 keys per tile while a staged row fits in 400 bytes, else 32
  if (row_bytes(a.d, sizeof(T)) <= 400)
    return vec ? launch_simt<T, GT, 64, true>(a, stream)
               : launch_simt<T, GT, 64, false>(a, stream);
  return vec ? launch_simt<T, GT, 32, true>(a, stream)
             : launch_simt<T, GT, 32, false>(a, stream);
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

// the attribute that lets instance (DSW, NT) of the tensor-core split
// kernel take its shared memory, set once per device: a host call on
// every launch would lengthen the host-bound decode step
constexpr int kMaxDevices = 64;

template <int DSW, int NT>
cudaError_t prepare_tc() {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_tc_kernel<DSW, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TcLayout<DSW, NT>::kSmem);
  if (err == cudaSuccess && known)
    ready[dev].store(true, std::memory_order_release);
  return err;
}

template <int DSW, int NT>
cudaError_t launch_tc(const DecodeArgs& a, cudaStream_t stream) {
  using L = TcLayout<DSW, NT>;
  static_assert(L::kSmem <= kMaxSmemBytes, "shared memory");
  const cudaError_t err = prepare_tc<DSW, NT>();
  if (err != cudaSuccess) return err;
  const int group = a.hq / a.hkv;
  const dim3 grid(a.batch * a.hkv, (group + kTcHeadTile - 1) / kTcHeadTile,
                  a.n_split);
  decode_split_tc_kernel<DSW, NT><<<grid, kThreads, L::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// blocks of instance (DSW, NT) one SM of the current device holds at
// once, or -1 on an error
template <int DSW, int NT>
int tc_blocks_per_sm() {
  if (prepare_tc<DSW, NT>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_split_tc_kernel<DSW, NT>, kThreads,
          TcLayout<DSW, NT>::kSmem) != cudaSuccess)
    return -1;
  return n;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(DSW, NT) as integral constants for the instance that takes head dim
// d (each warp's 16-wide dim tiles: 1, 2 or 4) and the group (one or two
// 8-head column tiles; groups above 16 take several blocks of 16)
template <class F>
auto with_tc_instance(int d, int group, F&& f) {
  const bool two = group > 8;
  if (d <= 64) return two ? f(Int<1>{}, Int<2>{}) : f(Int<1>{}, Int<1>{});
  if (d <= 128) return two ? f(Int<2>{}, Int<2>{}) : f(Int<2>{}, Int<1>{});
  return two ? f(Int<4>{}, Int<2>{}) : f(Int<4>{}, Int<1>{});
}

cudaError_t launch_tc_d(const DecodeArgs& a, cudaStream_t stream) {
  return with_tc_instance(a.d, a.hq / a.hkv, [&](auto dsw, auto nt) {
    return launch_tc<decltype(dsw)::value, decltype(nt)::value>(a, stream);
  });
}

}  // namespace

extern "C" {

int decode_attention_max_head_dim() { return 256; }


// most query heads per block of the SIMT and of the tensor-core split
// kernel (the wrapper's HEAD_TILE, checked at bind)
int decode_attention_max_group_tile() { return kMaxGroupTile; }
int decode_attention_tc_head_tile() { return kTcHeadTile; }

// blocks of the tensor-core split kernel one SM of the current device
// holds at once, for the instance a call at head dim d and group `group`
// takes (the wrapper checks its split rule against it at bind); -1 on an
// error
int decode_attention_tc_blocks_per_sm(int d, int group) {
  if (d < 1 || d > 256 || group < 1) return -1;
  return with_tc_instance(d, group, [](auto dsw, auto nt) {
    return tc_blocks_per_sm<decltype(dsw)::value, decltype(nt)::value>();
  });
}

// q_dtype (q and o), kv_dtype (k and v): 0 float32, 1 bfloat16. q
// (B, Hq, D) and k, v (B, Hkv, S, D) through their strides in elements,
// the last dim dense; lengths (B,) int32; o (B, Hq, D) contiguous; ws
// float32 of B * Hq * n_split * (D + 2) elements. tensor_cores: the
// tensor-core split kernel, which takes bfloat16 q and cache, D a
// multiple of 8 and every row of q, k and v 16-byte aligned (else the
// call fails); 0 the SIMT one. parts: 1 the split kernel, 2 the combine
// kernel (over the partials an earlier split left in ws), 3 both, the
// split first (a call: the parts apart serve measurement and tests).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, float* ws,
                            int q_dtype, int kv_dtype, int batch, int hq,
                            int hkv, int s, int d, int n_split,
                            int tensor_cores, int parts, long long q_sb,
                            long long q_sh, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, float scale, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || n_split < 1 ||
      n_split > kMaxSplits || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q,    k,    v,    lengths, o,    ws,   q_dtype,
                     batch, hq,  hkv,  s,       d,    n_split,
                     q_sb, q_sh, k_sb, k_sh,    k_ss, v_sb, v_sh,
                     v_ss, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores && (q_dtype != 1 || kv_dtype != 1 || d % 8 != 0 ||
                       !vector_loads<__nv_bfloat16>(a, true)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (parts & 1) {
    const cudaError_t err =
        tensor_cores ? launch_tc_d(a, st)
                     : (kv_dtype == 0 ? launch_gt<float>(a, st)
                                      : launch_gt<__nv_bfloat16>(a, st));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2)
    decode_combine_kernel<<<batch * hq, (d + 31) / 32 * 32,
                            3 * n_split * sizeof(float), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
