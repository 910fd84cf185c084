// Flash attention forward for Hopper (sm_90a): exact online-softmax
// attention with GQA, causal and sliding-window masks, f32 accumulation.
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the keys j that the masks allow (j < Skv; j <= i when causal;
// j > i - window with a window), G = H / KV query heads per KV head.
// Inputs q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, vd), all
// contiguous, f32 or bf16; the output (B, Sq, H, vd) is in q's dtype.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel), and on the model path the jnp scan that stands in
// for it (repro/models/layers.py::blocked_attention, static offsets).  The
// TPU kernel walks the kv tiles in order on one core, keeping (acc, m, l)
// in VMEM across grid steps; here a block holds the running state of its
// query rows in registers and loops over the kv tiles itself.
//
// Bound: operations.  A causal prefill does 2 (hd + vd) flops per allowed
// (query, key) pair and head (Qwen2-0.5B, S = 4096: 30 GFLOP for 29 MB),
// far above the card's flop/byte ratio.
//
// Two kernels, one per dtype, sharing the layout and the arithmetic:
// - Both take one (batch, KV head) and a run of consecutive query rows of
//   the flattened (position, group head) space per block (64 rows in f32,
//   128 in bf16), so the G query heads of a group share each K/V tile,
//   staged once in shared memory (that one K/V read per group is the
//   point of GQA).  Any G works: a block's rows may span several positions
//   or part of one position's group.
// - Online softmax exactly as the reference orders it: m_new = max(m,
//   max s), p = exp(s - m_new), corr = exp(m - m_new), l = l corr + sum p,
//   acc = acc corr + p v; out = l > 0 ? acc / max(l, 1e-30) : 0.  Masked
//   scores are -1e30 (not -inf).
// - kv tiles that every row of the block masks (past the causal diagonal,
//   or before every row's window) are skipped.  Skipping leaves the result
//   as it was: a masked tile after a valid key changes nothing, and the
//   exp(0) terms a masked tile adds before the first valid key are washed
//   out by exp(-1e30 - m) = 0.
// - Templated on the (hd, vd) pairs of ATTN_FOR_EACH_DIMS: every pair of
//   {16, 32, 64, 128}, and (24, 16), (96, 64), (112, 112).
//
// bf16 (the served dtype): warp-specialised for Hopper, wgmma bf16 -> f32
// fed by TMA.  A block is three warpgroups.  The third gives its registers
// up (setmaxnreg 40) and one of its threads is the producer: it walks the
// block's kv tiles and loads each tile's 64 keys of K and V with TMA (4-D
// tensor maps over (B, Skv, KV, dim), boxes of 64 keys by 64 columns, 128-
// byte swizzled; a dim above 64 takes two boxes, and the columns and keys
// past the tensor arrive as zeros) into a ring of three stages, each with
// a "full" mbarrier (the copies' bytes) and an "empty" one (all 256
// consumer threads).  The other two warpgroups (setmaxnreg 232) are the
// consumers, 64 query rows each.  Each first copies its q rows into
// shared memory with cp.async, once a block (rows of (position, group
// head) form no box TMA can take when G does not divide 128, as G = 6 and
// 7), and loads them into registers as wgmma's A fragments (ldmatrix).
// Per tile: S = q K^T by wgmma (m64n64k16, q from registers, K from the
// stage, K-major), the online softmax on the S accumulator in registers,
// then O += P V by wgmma with P from registers and V from the stage, read
// MN-major through its descriptor (m64n{vd}k16).  Tile i's S product is
// started with tile i - 1's P V, so that softmax i runs beside that
// product, and the two warpgroups take turns to start theirs (named barriers),
// so that one's softmax runs beside the other's products.  Every (hd, vd)
// pair takes this kernel.
// - S = q . k from the raw bf16 inputs: the products are exact in the f32
//   accumulator; `scale` is then applied to the f32 score (for hd = 64,
//   0.125 is a power of two, so this equals the reference's (q scale) . k).
//   The MMA contracts 16 columns a step, so a head dim that is no multiple
//   of 16 (hd = 24) is contracted rounded up (32); the q and K columns past
//   hd are zero in shared memory (q's zero-filled by cp.async, K's by
//   TMA's out-of-bounds fill): they add 0 to every score, and the scale
//   stays the caller's (hd^-0.5 of the true hd).
// - The online softmax runs on the S fragment, with quad shuffles for the
//   row max and sum; exp is ex2.approx with a denormal result flushed to
//   0.  Only the tiles on the causal diagonal, a window's edge or past Skv
//   are masked element by element.
// - Where P is rounded: P enters P.V as two bf16 terms, p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), two products against the same V tile, so P
//   keeps about 16 bits (relative error <= 2^-17).  One bf16 rounding of P
//   (2^-9) puts an absolute error of about 1e-3 of the output's scale on
//   every element, which fails the bf16 check (1e-5 + 5e-3 |ref| against
//   f64) on outputs near 0; l sums the f32 p.
// - Blocks walk the query tiles longest first (causal rows are unequal).
// - Sums are in a fixed order (the tensor cores' within a product, then
//   the products in the order they start), so a result is bitwise from run
//   to run.
//
// f32: on the CUDA cores in f32, as the reference computes (it widens q,
// k, v to f32 before both products), held to 1e-5 against f64, which TF32
// or bf16 tensor cores cannot meet.  8 warps of 8 rows; a kv tile holds 32
// keys, one per lane: each lane computes its key's score for the warp's 8
// rows (K transposed in shared memory, padded against bank conflicts; q
// rows, widened and scaled, broadcast), the warp reduces max and sum with
// shuffles, writes the 8 x 32 probabilities to shared memory, and each lane
// accumulates its own value columns (vd / 32 of them).  Nothing on the
// serving path runs it.
//
// Training (kLse): with an lse pointer, both kernels also store each row's
// log-sum-exp, lse = m + log(max(l, 1e-30)) in natural-log units of the
// scaled score (+inf where l == 0), into (B, H, Sq) f32, and the bf16
// kernel stores the output in f32 instead of bf16: the residuals the
// reference's custom_vjp saves (repro/models/layers.py::_make_flash) and
// flash_attention_bwd.cu reads.  m and l are kept in natural-log units in
// both kernels (the bf16 one scales the score before its max and takes
// exp2 of (s - m) log2(e)), so nothing needs converting.  Without the
// pointer the launch is the kLse = false instantiation, the same code,
// grid and shared memory as before the training path existed.
//
// Dynamic offsets (kDynamic, built with -DATTN_DYNAMIC into a library of
// its own): the path of the reference's blocked_attention that takes
// q_offset, kv_offset and kv_valid_len (_blocked_attention_ref), read on
// the device from int32[3] (attn::read_offsets), so no call reads a value
// back to the host.  The query rows' positions are shifted by q_offset -
// kv_offset and keys at or past lim = clamp(kv_valid_len - kv_offset, 0,
// Skv) are masked; the tile skipping above then follows the offsets, and a
// row that sees no key at all outputs 0 (lse +inf).  Only the padding is
// masked past Skv: the reference's scan also masks the last kv_offset
// real keys when Skv is no multiple of its tile, a fault the port does not
// copy.  Every dynamic launch writes lse and an f32 output (kLse), so the
// same launch serves inference and autograd; the static instantiations
// (kDynamic = false: no shift, lim = Skv) are the code they were.

#include <cuda.h>

#include <type_traits>

#include "../../attention_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::Elem;
using attn::exp2_ftz;
using attn::kNegInf;
using attn::ldmatrix_x4;
using attn::split;

// ---- f32: CUDA cores ------------------------------------------------------
namespace simt {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per kv tile, one a lane
constexpr int kKStride = kKeys + 1;           // transposed K row, padded

template <int HD, int VD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * HD + HD * kKStride + kKeys * VD + kRows * kKeys);
}

template <int HD, int VD, bool kLse, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ dyn,
                     int sq, int skv, int num_heads, int num_kv, int groups,
                     int causal, int window, float scale) {
  constexpr int kVec = Elem<float>::kPerVec;
  constexpr int kCols = (VD + 31) / 32;  // value columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][HD], scaled
  float* ks = qs + kRows * HD;                  // [HD][kKStride]
  float* vs = ks + HD * kKStride;               // [kKeys][VD]
  float* ps = vs + kKeys * VD;                  // [kRows][kKeys]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t f_end = f0 + kRows < rows_total ? f0 + kRows : rows_total;
  // positions in the keys' coordinates, and the keys past which all are
  // masked: no shift and Skv on the static path
  int shift = 0, lim = skv;
  if constexpr (kDynamic) {
    const attn::Offsets o = attn::read_offsets(dyn, skv);
    shift = o.shift;
    lim = o.lim;
  }
  const int pos_lo = static_cast<int>(f0 / groups) + shift;
  const int pos_hi = static_cast<int>((f_end - 1) / groups) + shift;

  // the block's query rows, widened to f32 and scaled (as the reference
  // does: q.astype(f32) * scale)
  for (int i = tid; i < kRows * (HD / kVec); i += blockDim.x) {
    const int r = i / (HD / kVec);
    const int d = (i % (HD / kVec)) * kVec;
    const int64_t f = f0 + r;
    float buf[kVec];
    if (f < rows_total) {
      const int64_t pos = f / groups;
      const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
      Elem<float>::load(q + ((b * sq + pos) * num_heads + h) * HD + d, buf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[r * HD + d + e] = buf[e] * scale;
  }

  int row_pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t f_row = f0 + warp * kRowsPerWarp + i;
    const int64_t f = f_row < rows_total ? f_row : rows_total - 1;
    row_pos[i] = static_cast<int>(f / groups) + shift;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // the kv tiles some row of the block may attend to
  const int kv_end = causal ? min(lim, pos_hi + 1) : lim;
  const int kv_first = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const float* qw = qs + warp * kRowsPerWarp * HD;
  float* pw = ps + warp * kRowsPerWarp * kKeys;

  for (int t0 = (kv_first / kKeys) * kKeys; t0 < kv_end; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * (HD / kVec); i += blockDim.x) {
      const int j = i / (HD / kVec);
      const int d = (i % (HD / kVec)) * kVec;
      float buf[kVec];
      if (t0 + j < skv) {
        Elem<float>::load(k + ((b * skv + t0 + j) * num_kv + kvh) * HD + d, buf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) buf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) ks[(d + e) * kKStride + j] = buf[e];
    }
    for (int i = tid; i < kKeys * (VD / kVec); i += blockDim.x) {
      const int j = i / (VD / kVec);
      const int d = (i % (VD / kVec)) * kVec;
      float buf[kVec];
      if (t0 + j < skv) {
        Elem<float>::load(v + ((b * skv + t0 + j) * num_kv + kvh) * VD + d, buf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) buf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) vs[j * VD + d + e] = buf[e];
    }
    __syncthreads();

    // scores of this lane's key for the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = ks[(d + 0) * kKStride + lane];
      const float k1 = ks[(d + 1) * kKStride + lane];
      const float k2 = ks[(d + 2) * kKStride + lane];
      const float k3 = ks[(d + 3) * kKStride + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * HD + d);
        s[i] = fmaf(qv.x, k0, s[i]);
        s[i] = fmaf(qv.y, k1, s[i]);
        s[i] = fmaf(qv.z, k2, s[i]);
        s[i] = fmaf(qv.w, k3, s[i]);
      }
    }

    // masks and the online-softmax update, one row at a time
    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int pos = row_pos[i];
      const bool ok = key < lim && (!causal || key <= pos) &&
                      (window <= 0 || key > pos - window);
      const float si = ok ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], attn::warp_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + attn::warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      pw[i * kKeys + lane] = p;
    }
    __syncwarp();

    // acc += p v over the tile's keys, each lane on its value columns
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < VD ? vs[(j + jj) * VD + d] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + i * kKeys + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[i][c] = fmaf(p4.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p4.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p4.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p4.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t f = f0 + warp * kRowsPerWarp + i;
    if (f >= rows_total) continue;
    if constexpr (kDynamic) {
      if (!attn::sees_a_key(row_pos[i], lim, causal, window)) l[i] = 0.0f;
    }
    const int64_t pos = f / groups;
    const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
    float* dst = out + ((b * sq + pos) * num_heads + h) * VD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < VD) dst[d] = Elem<float>::narrow(attn::finish(acc[i][c], l[i]));
    }
    if constexpr (kLse) {
      if (lane == 0) {
        lse[(b * num_heads + h) * sq + pos] = attn::log_sum_exp(m[i], l[i]);
      }
    }
  }
}

}  // namespace simt

// ---- bf16: tensor cores (wgmma), K and V by TMA --------------------------
namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;            // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's group
constexpr int kKeys = 64;                         // keys per kv tile
constexpr int kStages = 3;                        // kv tiles in the ring
constexpr int kAtom = 64;  // bf16 columns of one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

// 64-column blocks of a D-column operand in shared memory (the columns
// past D zero), and the columns the products contract (D rounded up to
// the MMA's K step of 16)
template <int D>
__host__ __device__ constexpr int atoms() {
  return (D + kAtom - 1) / kAtom;
}
template <int D>
__host__ __device__ constexpr int mma_cols() {
  return (D + 15) / 16 * 16;
}

// Shared memory, every tile 1024-byte aligned (the swizzle's period): q
// [atom][kRows][128 B], then per stage K [atom][kKeys][128 B] and V
// [atom][kKeys][128 B], then the stages' full and empty mbarriers
template <int HD, int VD>
struct Smem {
  static constexpr int kQ = atoms<HD>() * kRows * 128;
  static constexpr int kK = atoms<HD>() * kKeys * 128;
  static constexpr int kV = atoms<VD>() * kKeys * 128;
  static constexpr int kStage = kK + kV;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr size_t kBytes = 1024 + kBars + 2 * kStages * 8;
};

// whether the query at position `pos` may attend to `key`
__device__ __forceinline__ bool allowed(int key, int pos, int skv, int causal,
                                        int window) {
  return key < skv && (!causal || key <= pos) &&
         (window <= 0 || pos - key < window);
}

// ---- mbarriers and TMA ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// the producer's arrival, announcing the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
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
// one box of a 4-D tensor map at coordinates (c0, .., c3), innermost
// first, into shared memory at dst; its bytes complete on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----
// The shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// `lead` bytes between 64-column blocks (an MN-major operand's), `stride`
// bytes between groups of 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | uint64_t{1} << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most kPending of this warpgroup's committed groups are pending
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// keeps the compiler from moving a read or write of the accumulators
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}

// Accumulator layout (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup
// holds rows 16 w + g and 16 w + g + 8 (lane = 4 g + t), d[n][0..1] of
// row 16 w + g at columns 8 n + 2 t and + 1, d[n][2..3] of row 16 w + g +
// 8.  A from registers takes the same layout per 16 columns, as mma.sync
// does: the S accumulator of keys 16 kc .. 16 kc + 15 is P's A fragment.

// d += A B, m64nNk16 for N = 8 x (the array's first extent): A from
// registers, B from shared memory (its descriptor), K-major (kTransB 0)
// or MN-major (1); d is overwritten where accumulate is 0
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[14][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

// The consumers take turns at the tensor cores: warpgroup w waits on
// named barrier kTurn + w before it starts its products and then lets the
// other one go (bar.arrive on the other's barrier), so that one's softmax
// runs while the other's products do.  256 threads take part in each.
constexpr int kTurn = 3;  // ids 1 and 2 are the warpgroups' own barriers
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(kTurn + wg));
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(kTurn + (wg ^ 1)));
}

// S = q K^T over a tile's 64 keys, 16 columns of HK a step (started, not
// waited for): q the warpgroup's A fragments in registers, K the stage's
// tile, K-major
template <int HK>
__device__ __forceinline__ void s_product(float (&s)[kKeys / 8][4],
                                          const uint32_t (&qf)[HK / 16][4],
                                          uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < HK / 16; ++kc) {
    const uint32_t bt = (kc / 4) * kKeys * 128 + (kc % 4) * 32;
    wgmma_rs<0>(s, qf[kc], desc(k_tile + bt, 16, 1024), kc > 0);
  }
}

// O += P V over a tile's 64 keys, P in two bf16 terms (A from registers),
// 16 keys a step; V read MN-major from the stage (started, not waited for)
template <int VD>
__device__ __forceinline__ void pv_product(float (&o)[VD / 8][4],
                                           const uint32_t (&ph)[kKeys / 16][4],
                                           const uint32_t (&pl)[kKeys / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < kKeys / 16; ++kc) {
    const uint64_t vb = desc(v_tile + kc * 16 * 128, kKeys * 128, 1024);
    wgmma_rs<1>(o, ph[kc], vb, 1);
    wgmma_rs<1>(o, pl[kc], vb, 1);
  }
}

// The online softmax of one tile on the S accumulator, rows g (e = 0, 1)
// and g + 8 (e = 2, 3): scale, mask where some (row, key) pair of the
// tile is masked (`edge`), then m, corr and l in the reference's order;
// s becomes P and corr the factor of the accumulator
__device__ __forceinline__ void online_softmax(
    float (&s)[kKeys / 8][4], float (&m)[2], float (&l)[2],
    float (&corr)[2], const int (&row_pos)[2], int t0, int t, bool edge,
    int lim, int causal, int window, float scale) {
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] *= scale;
      if (edge && !allowed(t0 + n * 8 + 2 * t + (e & 1), row_pos[e >> 1],
                           lim, causal, window)) {
        s[n][e] = kNegInf;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_ftz((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
  }
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2_ftz((s[n][e] - mx[e >> 1]) * kLog2e);
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

// P (the S accumulator after online_softmax) as the A fragments of P V,
// each in two bf16 terms
__device__ __forceinline__ void split_p(const float (&p)[kKeys / 8][4],
                                        uint32_t (&ph)[kKeys / 16][4],
                                        uint32_t (&pl)[kKeys / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < kKeys / 16; ++kc) {
    split(p[2 * kc][0], p[2 * kc][1], ph[kc][0], pl[kc][0]);
    split(p[2 * kc][2], p[2 * kc][3], ph[kc][1], pl[kc][1]);
    split(p[2 * kc + 1][0], p[2 * kc + 1][1], ph[kc][2], pl[kc][2]);
    split(p[2 * kc + 1][2], p[2 * kc + 1][3], ph[kc][3], pl[kc][3]);
  }
}

// One block: one (batch, KV head) and kRows consecutive rows of the
// flattened (position, group head) space; warpgroups 0 and 1 compute 64
// rows each, warpgroup 2's first thread feeds them.  The output is bf16,
// or f32 with kLse (the training residual).
template <int HD, int VD, bool kLse, bool kDynamic>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const bf16* __restrict__ q,
                      std::conditional_t<kLse, float, bf16>* __restrict__ out,
                      float* __restrict__ lse, const int* __restrict__ dyn,
                      int batch, int sq, int skv, int num_heads, int num_kv,
                      int groups, int q_tiles, int causal, int window,
                      float scale) {
  using S = Smem<HD, VD>;
  constexpr int HK = mma_cols<HD>();
  extern __shared__ float4 smem4[];
  const uint32_t raw = attn::smem_addr(smem4);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* const smem = reinterpret_cast<char*>(smem4) + (base - raw);
  auto k_at = [&](int st) { return base + S::kQ + st * S::kStage; };
  auto v_at = [&](int st) { return k_at(st) + S::kK; };
  auto full = [&](int st) { return base + S::kBars + 8 * st; };
  auto empty = [&](int st) { return base + S::kBars + 8 * (kStages + st); };

  // (batch, KV head) varies fastest, the query tiles run from the last
  // (longest under a causal mask) to the first
  const int pairs = batch * num_kv;
  const int kvh = blockIdx.x % pairs % num_kv;
  const int b = blockIdx.x % pairs / num_kv;
  const int64_t qt = q_tiles - 1 - static_cast<int64_t>(blockIdx.x) / pairs;
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  const int64_t f0 = qt * kRows;
  const int64_t f_end = f0 + kRows < rows_total ? f0 + kRows : rows_total;
  // positions in the keys' coordinates, and the keys past which all are
  // masked: no shift and Skv on the static path
  int shift = 0, lim = skv;
  if constexpr (kDynamic) {
    const attn::Offsets o = attn::read_offsets(dyn, skv);
    shift = o.shift;
    lim = o.lim;
  }
  const int pos_lo = static_cast<int>(f0 / groups) + shift;
  const int pos_hi = static_cast<int>((f_end - 1) / groups) + shift;
  // the kv tiles some row of the block may attend to
  const int kv_end = causal ? min(lim, pos_hi + 1) : lim;
  const int kv_first = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_begin = kv_first / kKeys * kKeys;
  const int n_tiles =
      kv_end > t_begin ? (kv_end - t_begin + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- the producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), (it / kStages - 1) & 1);
        mbar_expect_tx(full(st), S::kStage);
        const int t0 = t_begin + it * kKeys;
#pragma unroll
        for (int a = 0; a < atoms<HD>(); ++a) {
          tma_load(k_at(st) + a * kKeys * 128, &tm_k, full(st), a * kAtom,
                   kvh, t0, b);
        }
#pragma unroll
        for (int a = 0; a < atoms<VD>(); ++a) {
          tma_load(v_at(st) + a * kKeys * 128, &tm_v, full(st), a * kAtom,
                   kvh, t0, b);
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 query rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = 64 * wg;  // the warpgroup's first row in the block

    // its q rows, as they are (bf16), zero past HD and past the last row,
    // placed as TMA's 128-byte swizzle places a row: 16-byte chunk c of
    // row r at chunk c ^ (r % 8)
    for (int i = tid; i < 64 * atoms<HD>() * 8; i += 128) {
      const int row = row0 + i / (atoms<HD>() * 8);
      const int c = i % (atoms<HD>() * 8);
      const bool ok = f0 + row < rows_total && c * 8 < HD;
      const int64_t f = ok ? f0 + row : 0;
      const int64_t pos = f / groups;
      const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
      cp_async16(smem + (c / 8) * kRows * 128 + row * 128 +
                     ((c % 8) ^ (row & 7)) * 16,
                 q + ((b * static_cast<int64_t>(sq) + pos) * num_heads + h) *
                         HD + (ok ? c * 8 : 0),
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
    // each warp's 16 rows as the A fragments of S = q K^T, 16 columns a
    // fragment (ldmatrix: lane l gives row l % 16, 16-byte chunk 2 kc + l /
    // 16, at its swizzled place); the products read q from registers, so
    // that K is their only shared-memory operand
    uint32_t qf[HK / 16][4];
#pragma unroll
    for (int kc = 0; kc < HK / 16; ++kc) {
      const int row = row0 + 16 * warp + (lane & 15);
      const int c = 2 * kc + (lane >> 4);
      ldmatrix_x4(qf[kc], smem + (c / 8) * kRows * 128 + row * 128 +
                              ((c % 8) ^ (row & 7)) * 16);
    }

    int row_pos[2];
    float m[2], l[2], o[VD / 8][4], s[kKeys / 8][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t f = f0 + row0 + 16 * warp + g + 8 * r;
      row_pos[r] =
          static_cast<int>((f < rows_total ? f : rows_total - 1) / groups) +
          shift;
      m[r] = kNegInf;
      l[r] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;  // the first product's
    }                                              // scale-d drops it

    // whether some (row, key) pair of the tile at t0 is masked
    auto edge = [&](int t0) {
      return t0 + kKeys > lim || (causal && t0 + kKeys - 1 > pos_lo) ||
             (window > 0 && t0 <= pos_hi - window);
    };
    // Tile i's S product is started with tile i - 1's P V, in one turn;
    // tile i's softmax then runs while that P V does (and while the other
    // warpgroup's products do).  A warpgroup takes n_tiles + 1 turns;
    // warpgroup 1 opens the first for warpgroup 0 and passes none after
    // its last.
    uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
    float corr[2];
    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);
      mbar_wait(full(0), 0);
      turn_wait(wg);
      wgmma_fence();
      s_product<HK>(s, qf, k_at(0));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax(s, m, l, corr, row_pos, t_begin, t, edge(t_begin), lim,
                     causal, window, scale);
      split_p(s, ph, pl);  // o is 0: corr has nothing to scale
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int prev = (it - 1) % kStages;
      const int t0 = t_begin + it * kKeys;
      mbar_wait(full(st), (it / kStages) & 1);
      turn_wait(wg);
      fence_regs(o);
      wgmma_fence();
      s_product<HK>(s, qf, k_at(st));
      wgmma_commit();
      pv_product<VD>(o, ph, pl, v_at(prev));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S
      fence_regs(s);
      online_softmax(s, m, l, corr, row_pos, t0, t, edge(t0), lim, causal,
                     window, scale);
      wgmma_wait<0>();  // P V of the tile before
      fence_regs(o);
      mbar_arrive(empty(prev));  // this warpgroup is done with that stage
#pragma unroll
      for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      }
      split_p(s, ph, pl);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      turn_wait(wg);
      fence_regs(o);
      wgmma_fence();
      pv_product<VD>(o, ph, pl, v_at(last));
      wgmma_commit();
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(last));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t f = f0 + row0 + 16 * warp + g + 8 * r;
      if (f >= rows_total) continue;
      if constexpr (kDynamic) {
        if (!attn::sees_a_key(row_pos[r], lim, causal, window)) l[r] = 0.0f;
      }
      const int64_t pos = f / groups;
      const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
      auto* dst =
          out + ((b * static_cast<int64_t>(sq) + pos) * num_heads + h) * VD +
          2 * t;
      if constexpr (kLse) {
#pragma unroll
        for (int n = 0; n < VD / 8; ++n) {
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(attn::finish(o[n][2 * r], l[r]),
                          attn::finish(o[n][2 * r + 1], l[r]));
        }
        if (t == 0) {
          lse[(b * static_cast<int64_t>(num_heads) + h) * sq + pos] =
              attn::log_sum_exp(m[r], l[r]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < VD / 8; ++n) {
          __nv_bfloat162 pair;
          pair.x = Elem<bf16>::narrow(attn::finish(o[n][2 * r], l[r]));
          pair.y = Elem<bf16>::narrow(attn::finish(o[n][2 * r + 1], l[r]));
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = pair;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, a libcuda call, through the runtime's entry
// point query (no link to libcuda); null where libcuda has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, Skv, KV, D) bf16 tensor at p: boxes of kKeys
// keys by kAtom columns of one KV head, 128-byte swizzled, zero past the
// tensor's keys and columns.  Returns a CUDA error code.
template <int D>
int kv_map(CUtensorMap* map, const void* p, int batch, int skv, int num_kv) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(num_kv),
                              static_cast<cuuint64_t>(skv),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[1] * dims[0] * 2,
                                 dims[2] * dims[1] * dims[0] * 2};
  const cuuint32_t box[4] = {kAtom, 1, kKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hop

template <int HD, int VD, bool kLse, bool kDynamic>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const int* dyn, int batch, int sq, int skv,
               int num_heads, int num_kv, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = simt::smem_bytes<HD, VD>();
  auto kernel = simt::flash_fwd_f32_kernel<HD, VD, kLse, kDynamic>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const dim3 grid(static_cast<unsigned>((rows + simt::kRows - 1) /
                                        simt::kRows),
                  num_kv, batch);
  kernel<<<grid, simt::kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, dyn, sq,
      skv, num_heads, num_kv, groups, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int VD, bool kLse, bool kDynamic>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* dyn, int batch, int sq, int skv,
                int num_heads, int num_kv, int causal, int window, float scale,
                cudaStream_t stream) {
  using Out = std::conditional_t<kLse, float, __nv_bfloat16>;
  constexpr size_t smem = hop::Smem<HD, VD>::kBytes;
  auto kernel = hop::flash_fwd_bf16_kernel<HD, VD, kLse, kDynamic>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const int64_t q_tiles = (rows + hop::kRows - 1) / hop::kRows;
  const int64_t blocks = q_tiles * num_kv * batch;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  CUtensorMap tm_k, tm_v;
  if (int e = hop::kv_map<HD>(&tm_k, k, batch, skv, num_kv)) return e;
  if (int e = hop::kv_map<VD>(&tm_v, v, batch, skv, num_kv)) return e;
  kernel<<<static_cast<unsigned>(blocks), hop::kThreads, smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<Out*>(out), lse, dyn, batch, sq, skv, num_heads, num_kv,
      groups, static_cast<int>(q_tiles), causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef ATTN_DYNAMIC
// dtype: 0 f32 (CUDA cores), 1 bf16 (tensor cores).  window <= 0: no
// window.  lse: null, or (B, H, Sq) f32 for each row's log-sum-exp, and
// then a bf16 launch writes `out` in f32.  Returns the CUDA error of the
// launch (0 on success); the wrapper has checked every shape.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int batch, int sq, int skv, int num_heads,
                                   int num_kv, int hd, int vd, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define ATTN_LAUNCH(FN, H, V)                                                \
  return l ? FN<H, V, true, false>(q, k, v, out, l, nullptr, batch, sq, skv, \
                                   num_heads, num_kv, causal, window, scale, \
                                   s)                                        \
           : FN<H, V, false, false>(q, k, v, out, l, nullptr, batch, sq,     \
                                    skv, num_heads, num_kv, causal, window,  \
                                    scale, s);
#define ATTN_CASE(H, V)                                                     \
  if (hd == H && vd == V) {                                                 \
    if (dtype == 0) ATTN_LAUNCH(launch_f32, H, V)                           \
    if (dtype == 1) ATTN_LAUNCH(launch_bf16, H, V)                          \
  }
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
#undef ATTN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// The dynamic-offset entry: `offsets` is int32[3] on the device (q_offset,
// kv_offset, kv_valid_len), `out` (B, Sq, H, vd) f32 and `lse` (B, H, Sq)
// f32 whatever the dtype.  Otherwise as flash_attention_fwd.
extern "C" int flash_attention_fwd_dynamic(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* offsets, int batch, int sq, int skv, int num_heads,
    int num_kv, int hd, int vd, int causal, int window, float scale,
    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* dyn = static_cast<const int*>(offsets);
#define ATTN_CASE(H, V)                                                      \
  if (hd == H && vd == V) {                                                  \
    if (dtype == 0)                                                          \
      return launch_f32<H, V, true, true>(q, k, v, out, l, dyn, batch, sq,   \
                                          skv, num_heads, num_kv, causal,    \
                                          window, scale, s);                 \
    if (dtype == 1)                                                          \
      return launch_bf16<H, V, true, true>(q, k, v, out, l, dyn, batch, sq,  \
                                           skv, num_heads, num_kv, causal,   \
                                           window, scale, s);                \
  }
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
