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
//   the flattened (position, group head) space per block (64 rows in f32;
//   128 in bf16 at hd, vd <= 64, else 64), so the G query heads of a group
//   share each K/V tile, staged once in shared memory (that one K/V read
//   per group is the point of GQA).  Any G works: a block's rows
//   may span several positions or part of one position's group.
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
// bf16 (the served dtype): FlashAttention-2 on the tensor cores,
// mma.sync.m16n8k16 bf16 -> f32.  4 warps, each of two 16-row MMA tiles at
// hd, vd <= 64 (one above, where two would spill), which share every K and
// V fragment the warp loads; each warp keeps its Q fragments (ldmatrix) and
// the S and O accumulators in registers.  K/V tiles of 64 keys are
// double-buffered in shared memory with cp.async (rows padded by 16 bytes,
// so ldmatrix is free of bank conflicts); V is read through ldmatrix.trans.
// - S = q . k from the raw bf16 inputs: the products are exact in the f32
//   accumulator; `scale` is then applied to the f32 score (for hd = 64,
//   0.125 is a power of two, so this equals the reference's (q scale) . k).
//   The MMA contracts 16 columns a step, so a head dim that is no multiple
//   of 16 (hd = 24) is staged rounded up (32), the q and K columns past hd
//   zero-filled in shared memory by the copies themselves: they add 0 to
//   every score, and the scale stays the caller's (hd^-0.5 of the true hd).
// - The online softmax runs on the S fragment, with quad shuffles for the
//   row max and sum; exp is ex2.approx with a denormal result flushed to
//   0.  Only the tiles on the causal diagonal, a window's edge or past Skv
//   are masked element by element.
// - Where P is rounded: P enters P.V as two bf16 terms, p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), two MMAs against the same V fragment, so P
//   keeps about 16 bits (relative error <= 2^-17).  One bf16 rounding of P
//   (2^-9) puts an absolute error of about 1e-3 of the output's scale on
//   every element, which fails the bf16 check (1e-5 + 5e-3 |ref| against
//   f64) on outputs near 0; l sums the f32 p.
// - Blocks walk the query tiles longest first (causal rows are unequal).
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
using attn::ldmatrix_x4_trans;
using attn::mma;
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

// ---- bf16: tensor cores ---------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kKeys = 64;  // keys per kv tile
constexpr int kPad = 8;    // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// 16-row MMA tiles per warp: two where the accumulators fit in registers
// (hd, vd <= 64: 254 registers, no spill), so each K/V fragment a warp
// loads feeds two MMAs; one above
template <int HD, int VD>
__host__ __device__ constexpr int m_tiles() {
  return HD <= 64 && VD <= 64 ? 2 : 1;
}

template <int HD, int VD>
__host__ __device__ constexpr int rows_per_block() {
  return 16 * m_tiles<HD, VD>() * kWarps;
}

// q and K columns staged: hd rounded up to the MMA's K step of 16, the
// columns past hd zero
template <int HD>
__host__ __device__ constexpr int hd_mma() {
  return (HD + 15) / 16 * 16;
}

template <int HD, int VD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (rows_per_block<HD, VD>() * (hd_mma<HD>() + kPad) +
                         2 * kKeys * (hd_mma<HD>() + kPad) +
                         2 * kKeys * (VD + kPad));
}

// whether the query at position `pos` may attend to `key`
__device__ __forceinline__ bool allowed(int key, int pos, int skv, int causal,
                                        int window) {
  return key < skv && (!causal || key <= pos) &&
         (window <= 0 || pos - key < window);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t holds rows g
// and g + 8 of A and of the accumulators, columns 2 t and 2 t + 1 of each
// 8-wide accumulator tile.  Each warp owns m_tiles() such 16-row tiles,
// which share every K and V fragment it loads.
// The output is bf16, or f32 with kLse (the training residual).
template <int HD, int VD, bool kLse, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      std::conditional_t<kLse, float, bf16>* __restrict__ out,
                      float* __restrict__ lse, const int* __restrict__ dyn,
                      int batch, int sq, int skv,
                      int num_heads, int num_kv, int groups, int q_tiles,
                      int causal, int window, float scale) {
  constexpr int HK = hd_mma<HD>();  // q . k columns, zero past HD
  constexpr int QS = HK + kPad;      // shared-memory row strides (elements)
  constexpr int VS = VD + kPad;
  constexpr int M = m_tiles<HD, VD>();
  constexpr int kRows = rows_per_block<HD, VD>();
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kRows][QS]
  bf16* ks = qs + kRows * QS;                 // [2][kKeys][QS]
  bf16* vs = ks + 2 * kKeys * QS;             // [2][kKeys][VS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // (batch, KV head) varies fastest, the query tiles run from the last
  // (longest under a causal mask) to the first
  const int pairs = batch * num_kv;
  const int kvh = blockIdx.x % pairs % num_kv;
  const int64_t b = blockIdx.x % pairs / num_kv;
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

  // the block's query rows, as they are (bf16), zero past HD
  for (int i = tid; i < kRows * (HK / 8); i += kWarps * 32) {
    const int r = i / (HK / 8);
    const int c = (i % (HK / 8)) * 8;
    const int64_t f = f0 + r < rows_total ? f0 + r : 0;
    const int64_t pos = f / groups;
    const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
    cp_async16(qs + r * QS + c,
               q + ((b * sq + pos) * num_heads + h) * HD + (c < HD ? c : 0),
               f0 + r < rows_total && c < HD);
  }
  auto load_kv = [&](int t0, int buf) {
    bf16* kd = ks + buf * kKeys * QS;
    bf16* vd = vs + buf * kKeys * VS;
    for (int i = tid; i < kKeys * (HK / 8); i += kWarps * 32) {
      const int j = i / (HK / 8);
      const int c = (i % (HK / 8)) * 8;
      const int64_t key = t0 + j < skv ? t0 + j : 0;
      cp_async16(kd + j * QS + c,
                 k + ((b * skv + key) * num_kv + kvh) * HD + (c < HD ? c : 0),
                 t0 + j < skv && c < HD);
    }
    for (int i = tid; i < kKeys * (VD / 8); i += kWarps * 32) {
      const int j = i / (VD / 8);
      const int c = (i % (VD / 8)) * 8;
      const int64_t key = t0 + j < skv ? t0 + j : 0;
      cp_async16(vd + j * VS + c, v + ((b * skv + key) * num_kv + kvh) * VD + c,
                 t0 + j < skv);
    }
  };

  // the kv tiles some row of the block may attend to
  const int kv_end = causal ? min(lim, pos_hi + 1) : lim;
  const int kv_first = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_begin = kv_first / kKeys * kKeys;
  const int n_tiles =
      kv_end > t_begin ? (kv_end - t_begin + kKeys - 1) / kKeys : 0;
  if (n_tiles > 0) load_kv(t_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // per 16-row tile mi: rows (warp M + mi) 16 + g (r = 0) and + 8 (r = 1)
  uint32_t qf[M][HK / 16][4];
  int row_pos[M][2];
  float o[M][VD / 8][4];
  float m[M][2], l[M][2];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    const int row0 = (warp * M + mi) * 16;
#pragma unroll
    for (int kc = 0; kc < HK / 16; ++kc) {
      ldmatrix_x4(qf[mi][kc], qs + (row0 + (lane & 15)) * QS + kc * 16 +
                                  (lane >> 4) * 8);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t f = f0 + row0 + g + 8 * r;
      row_pos[mi][r] = static_cast<int>(
          (f < rows_total ? f : rows_total - 1) / groups) + shift;
      m[mi][r] = kNegInf;
      l[mi][r] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.0f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKeys;
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kKeys, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* kt = ks + buf * kKeys * QS;
    const bf16* vt = vs + buf * kKeys * VS;

    // S = q k^T over the tile's 64 keys: 8 accumulator tiles of 8 keys
    float s[M][kKeys / 8][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kc = 0; kc < HK / 16; ++kc) {
#pragma unroll
      for (int n2 = 0; n2 < kKeys / 16; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * QS +
                            kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          mma(s[mi][2 * n2], qf[mi][kc], kb[0], kb[1]);
          mma(s[mi][2 * n2 + 1], qf[mi][kc], kb[2], kb[3]);
        }
      }
    }

    // scale, then mask where some (row, key) pair of the tile is masked
    const bool edge = t0 + kKeys > lim || (causal && t0 + kKeys - 1 > pos_lo) ||
                      (window > 0 && t0 <= pos_hi - window);
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mi][n][e] *= scale;
          if (edge && !allowed(t0 + n * 8 + 2 * t + (e & 1),
                               row_pos[mi][e >> 1], lim, causal, window)) {
            s[mi][n][e] = kNegInf;
          }
        }
      }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][n][0], s[mi][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][n][2], s[mi][n][3]));
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2_ftz((m[mi][r] - mx[r]) * kLog2e);
        m[mi][r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mi][n][e] = exp2_ftz((s[mi][n][e] - mx[e >> 1]) * kLog2e);
          sum[e >> 1] += s[mi][n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[mi][r] = l[mi][r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mi][n][e] *= corr[e >> 1];
      }
    }

    // O += P V, 16 keys at a time; P (the S fragment, as A) in two bf16
    // terms against each V fragment
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t ph[M][4], pl[M][4];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        const float(&s0)[4] = s[mi][2 * kc];
        const float(&s1)[4] = s[mi][2 * kc + 1];
        split(s0[0], s0[1], ph[mi][0], pl[mi][0]);
        split(s0[2], s0[3], ph[mi][1], pl[mi][1]);
        split(s1[0], s1[1], ph[mi][2], pl[mi][2]);
        split(s1[2], s1[3], ph[mi][3], pl[mi][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < VD / 16; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * VS +
                                  n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          mma(o[mi][2 * n2], ph[mi], vb[0], vb[1]);
          mma(o[mi][2 * n2], pl[mi], vb[0], vb[1]);
          mma(o[mi][2 * n2 + 1], ph[mi], vb[2], vb[3]);
          mma(o[mi][2 * n2 + 1], pl[mi], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t f = f0 + (warp * M + mi) * 16 + g + 8 * r;
      if (f >= rows_total) continue;
      if constexpr (kDynamic) {
        if (!attn::sees_a_key(row_pos[mi][r], lim, causal, window)) {
          l[mi][r] = 0.0f;
        }
      }
      const int64_t pos = f / groups;
      const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
      auto* dst = out + ((b * sq + pos) * num_heads + h) * VD + 2 * t;
      if constexpr (kLse) {
#pragma unroll
        for (int n = 0; n < VD / 8; ++n) {
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(attn::finish(o[mi][n][2 * r], l[mi][r]),
                          attn::finish(o[mi][n][2 * r + 1], l[mi][r]));
        }
        if (t == 0) {
          lse[(b * num_heads + h) * sq + pos] =
              attn::log_sum_exp(m[mi][r], l[mi][r]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < VD / 8; ++n) {
          __nv_bfloat162 pair;
          pair.x =
              Elem<bf16>::narrow(attn::finish(o[mi][n][2 * r], l[mi][r]));
          pair.y =
              Elem<bf16>::narrow(attn::finish(o[mi][n][2 * r + 1], l[mi][r]));
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = pair;
        }
      }
    }
  }
}

}  // namespace tc

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
  constexpr size_t smem = tc::smem_bytes<HD, VD>();
  auto kernel = tc::flash_fwd_bf16_kernel<HD, VD, kLse, kDynamic>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  constexpr int kRows = tc::rows_per_block<HD, VD>();
  const int64_t q_tiles = (rows + kRows - 1) / kRows;
  const int64_t blocks = q_tiles * num_kv * batch;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<static_cast<unsigned>(blocks), tc::kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<Out*>(out), lse, dyn,
      batch, sq, skv, num_heads, num_kv, groups, static_cast<int>(q_tiles),
      causal, window, scale);
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
