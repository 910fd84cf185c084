// Flash attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's forward with respect to q, k and v, recomputed from
// the forward's residuals (its f32 output O and each row's log-sum-exp).
//
//   delta_i = sum_c dO[i, c] O[i, c]
//   P_ij    = exp(s_ij - lse_i),  s_ij = scale q_i . k_j, -1e30 if masked
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dq_i    = scale sum_j dS_ij k_j
//   dk_j    = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//
// where the sums over i run over every query row of the G heads that share
// k_j's KV head (that sum over the group is GQA's gradient), with the
// forward's masks (j < Skv; j <= i when causal; i - j < window with a
// window).  q, k, v (B, S, heads, dim) are f32 or bf16; O and dO (B, Sq, H,
// vd) and lse (B, H, Sq) are f32; dq, dk, dv come out in q's dtype.
//
// Replaces the custom_vjp backward of the reference's flash path,
// repro/models/layers.py::_make_flash (flash_bwd), which on the TPU is jnp
// inside a custom_vjp rather than a Pallas kernel.  It keeps the
// reference's two passes, so there are no atomics and the gradient is the
// same bits at every launch:
// - dq pass: one block per (batch, KV head, run of 64 query rows of the
//   flattened (position, group head) space, f = pos G + g, as the forward),
//   looping over the kv tiles its rows may see.  It first computes delta
//   for its rows and stores it (B, H, Sq) for the second pass.
// - dk/dv pass: one block per (batch, KV head, tile of keys), looping over
//   every query row of the group that may attend to its keys.
// Both skip the kv tiles or query rows that every pair of the block masks
// (past the causal diagonal, outside the window); a masked pair inside a
// kept tile gets P = 0, as exp(-1e30 - lse) is in the reference.
//
// Bound: operations.  The gradient needs 2 (3 hd + 2 vd) flops per allowed
// (query, key) pair and head (q.k, dO.v, dq, dk and dv); the two passes
// recompute q.k and dO.v once more each.  At Qwen2-0.5B's training shape
// (B = 4, S = 2048 causal, 14 heads) that is 75.2 GFLOP, 76 us at the
// card's bf16 tensor-core rate.
//
// bf16 (the trained dtype): FlashAttention-2's backward on the tensor
// cores, mma.sync.m16n8k16 bf16 -> f32, 4 warps a block, operands read
// from shared memory with ldmatrix (.trans where the contraction runs
// along the stored rows), tiles double-buffered with cp.async, rows padded
// by 16 bytes so that ldmatrix is free of bank conflicts.
// - dq pass: a warp owns 16 query rows.  The block stages its q rows once
//   and its dO rows once, split into three bf16 terms dO_1 + dO_2 + dO_3
//   (each the rounding of what the ones before leave; also written to a
//   scratch for the second pass), and walks 64-key K/V tiles: S = q K^T;
//   P = exp(scale S - lse); dP = sum_n dO_n V^T; dS = P (dP - delta), in
//   place of S; dq += dS K, dS entering as three bf16 terms (the
//   accumulator fragment is reused as the A operand).
// - dk/dv pass: a block owns 64 keys, a warp 16 of them as the MMA's rows;
//   it walks steps of 64 query rows (32 where the accumulators would spill,
//   hd + vd >= 224): S^T = K q^T; P^T = exp(scale S^T - lse), lse and delta
//   indexed by the column; dv += P^T dO as P_1 dO_1 + P_2 dO_1 + P_1 dO_2
//   (P in two terms); dP^T = sum_n V dO_n^T; dS^T = P^T (dP^T - delta);
//   dk += dS^T q, dS in three terms.  q, dO's terms, lse and delta come in
//   by cp.async; rows past the block's range are zero-filled (dO = 0 and
//   delta = 0 make their terms 0).
// - Where it rounds: q, k, v are bf16 already, so q.k and every product
//   with q, k, v or a term of dO is exact in the f32 accumulator.  P, dS
//   and dO are f32; one bf16 rounding of any of them (up to 2^-8 of its
//   value) would put an error of about 1e-3 of a gradient's scale on every
//   element and fail the bf16 check (1e-5 of max |ref| + 5e-3 |ref|
//   against f64).  Two terms keep about 16 bits and pass it at the 2,048-
//   token shapes, but at Mixtral's (600M dq elements over windows of 4,096
//   keys) the tail of their error crossed dq's limit; three keep about 24
//   bits, as f32 does.  dv keeps two terms of P and dO, which its check
//   passes there.  S takes the raw bf16 q.k and scales
//   the f32 score, as the forward does, so P = exp2(S scale log2(e) - lse
//   log2(e)) matches the lse the forward wrote; exp2 is ex2.approx, a
//   denormal flushed to 0.  Only the gradients are rounded to bf16, once,
//   in the epilogues.
// - Tiles that need masking element by element: in the dq pass those on
//   the causal diagonal, a window's edge or past Skv; in the dk/dv pass
//   those on the diagonal or a window's edge (a key past Skv only feeds its
//   own dk and dv rows, which are not stored).
// - Head dims: q and K are staged with hd rounded up to the MMA's K step
//   of 16 (hd 24 as 32), the columns past hd zero-filled by the copies;
//   every vd of ATTN_FOR_EACH_DIMS is a multiple of 16.
// - This design issues 17 product-equivalents where the bound counts five
//   (dq pass: S, 3 dP, 3 dq; dk/dv pass: S, 3 dP, 3 dv, 3 dk), so its
//   ceiling is 29% of the bound at mma.sync's full rate; wgmma and TMA are
//   the later redesign.
//
// f32: on the CUDA cores, held to 1e-5 against f64, which TF32 or bf16
// products cannot meet.  Each operand tile is staged transposed in shared
// memory (rows padded to 33 floats, free of bank conflicts both when a lane
// reads its own column and when it walks a row): a lane owns a key (dq
// pass, 8 warps of 8 rows, 32 keys a tile) or a query row (dk/dv pass, 4
// warps of 8 keys, 32 rows a step) for the two dot products, and an output
// column for the accumulation, reading the 32 P or dS values of its warp's
// rows or keys as broadcasts.  A lane owns columns lane, lane + 32, ... of
// dq, dk and dv, (dim + 31) / 32 of them, each loop bounded by the dim.
// Shared memory at (112, 112): 95 KB for the dq pass, 65 KB for the dk/dv
// pass, both above the 48 KB default and opted in at launch.
//
// Dynamic offsets (kDynamic, built with -DATTN_DYNAMIC into a library of
// its own, beside the forward's): the gradients of flash_attention.cu's
// dynamic entry, the offsets read on the device from the same int32[3].
// As in the forward, query positions are shifted by q_offset - kv_offset
// and keys at or past lim are masked, so both passes' skipping (the dq
// pass's kv tiles, the dk/dv pass's query rows) follows the offsets; a key
// block wholly at or past lim walks no rows and stores zeros.  A row that
// saw no key has lse = +inf from the forward, so its P is 0.  The static
// instantiations (no shift, lim = Skv) are the same code.

#include "../../attention_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async4;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::Elem;
using attn::exp2_ftz;
using attn::kNegInf;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma;

constexpr int kStride = 33;  // f32: a transposed tile row, 32 entries + 1 pad

// whether the query at `pos` may attend to `key` (the forward's masks)
__device__ __forceinline__ bool allowed(int key, int pos, int skv, int causal,
                                        int window) {
  return key < skv && (!causal || key <= pos) &&
         (window <= 0 || pos - key < window);
}

// ---- f32: CUDA cores --------------------------------------------------------
namespace simt {

// ---- dq pass ----------------------------------------------------------------
namespace dq_pass {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per kv tile, one a lane

template <int HD, int VD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * HD + kRows * VD + HD * kStride +
                          VD * kStride + kRows * kKeys);
}

template <int HD, int VD, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, const int* __restrict__ dyn,
                    int sq, int skv, int num_heads, int num_kv, int groups,
                    int causal, int window, float scale) {
  constexpr int kColsQ = (HD + 31) / 32;  // dq columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][HD], scaled
  float* dos = qs + kRows * HD;                 // [kRows][VD]
  float* kt = dos + kRows * VD;                 // [HD][kStride]
  float* vt = kt + HD * kStride;                // [VD][kStride]
  float* dss = vt + VD * kStride;               // [kRows][kKeys]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  // the last rows first: under a causal mask they see the most keys
  const int64_t f0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
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

  // the warp's rows: q (scaled), dO, lse and delta = rowsum(dO O)
  int row_pos[kRowsPerWarp];
  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int64_t f = f0 + r;
    const bool valid = f < rows_total;
    const int64_t pos = valid ? f / groups : 0;
    const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
    const int64_t row = (b * sq + pos) * num_heads + h;
    for (int c = lane; c < HD; c += 32) {
      qs[r * HD + c] = valid ? q[row * HD + c] * scale : 0.0f;
    }
    float dot = 0.0f;
    for (int c = lane; c < VD; c += 32) {
      const float d = valid ? dout[row * VD + c] : 0.0f;
      dos[r * VD + c] = d;
      dot += valid ? d * out[row * VD + c] : 0.0f;
    }
    dot = attn::warp_sum(dot);
    row_pos[i] = static_cast<int>(pos) + shift;
    row_delta[i] = dot;
    // an invalid row gets P = exp(s - inf) = 0
    row_lse[i] = valid ? lse[(b * num_heads + h) * sq + pos]
                       : __int_as_float(0x7f800000);
    if (valid && lane == 0) delta[(b * num_heads + h) * sq + pos] = dot;
  }

  float acc[kRowsPerWarp][kColsQ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int c = 0; c < kColsQ; ++c) acc[i][c] = 0.0f;
  }

  // the kv tiles some row of the block may attend to
  const int kv_end = causal ? min(lim, pos_hi + 1) : lim;
  const int kv_first = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const float* qw = qs + warp * kRowsPerWarp * HD;
  const float* dow = dos + warp * kRowsPerWarp * VD;
  float* dsw = dss + warp * kRowsPerWarp * kKeys;

  for (int t0 = kv_first / kKeys * kKeys; t0 < kv_end; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      kt[d * kStride + j] =
          t0 + j < skv
              ? k[((b * skv + t0 + j) * num_kv + kvh) * HD + d]
              : 0.0f;
    }
    for (int i = tid; i < kKeys * VD; i += blockDim.x) {
      const int j = i / VD, d = i % VD;
      vt[d * kStride + j] =
          t0 + j < skv
              ? v[((b * skv + t0 + j) * num_kv + kvh) * VD + d]
              : 0.0f;
    }
    __syncthreads();

    // this lane's key against the warp's rows: s = (scale q) . k, dO . v
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = kt[(d + 0) * kStride + lane];
      const float k1 = kt[(d + 1) * kStride + lane];
      const float k2 = kt[(d + 2) * kStride + lane];
      const float k3 = kt[(d + 3) * kStride + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qw + i * HD + d);
        s[i] = fmaf(x.x, k0, s[i]);
        s[i] = fmaf(x.y, k1, s[i]);
        s[i] = fmaf(x.z, k2, s[i]);
        s[i] = fmaf(x.w, k3, s[i]);
      }
    }
#pragma unroll 4
    for (int d = 0; d < VD; d += 4) {
      const float v0 = vt[(d + 0) * kStride + lane];
      const float v1 = vt[(d + 1) * kStride + lane];
      const float v2 = vt[(d + 2) * kStride + lane];
      const float v3 = vt[(d + 3) * kStride + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(dow + i * VD + d);
        dp[i] = fmaf(x.x, v0, dp[i]);
        dp[i] = fmaf(x.y, v1, dp[i]);
        dp[i] = fmaf(x.z, v2, dp[i]);
        dp[i] = fmaf(x.w, v3, dp[i]);
      }
    }
    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float si =
          allowed(key, row_pos[i], lim, causal, window) ? s[i] : kNegInf;
      const float p = expf(si - row_lse[i]);
      dsw[i * kKeys + lane] = p * (dp[i] - row_delta[i]);
    }
    __syncwarp();

    // dq += dS k over the tile's keys, each lane on its dq columns
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float kk[4][kColsQ];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kColsQ; ++c) {
          const int d = lane + 32 * c;
          kk[jj][c] = d < HD ? kt[d * kStride + j + jj] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 ds4 =
            *reinterpret_cast<const float4*>(dsw + i * kKeys + j);
#pragma unroll
        for (int c = 0; c < kColsQ; ++c) {
          acc[i][c] = fmaf(ds4.x, kk[0][c], acc[i][c]);
          acc[i][c] = fmaf(ds4.y, kk[1][c], acc[i][c]);
          acc[i][c] = fmaf(ds4.z, kk[2][c], acc[i][c]);
          acc[i][c] = fmaf(ds4.w, kk[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t f = f0 + warp * kRowsPerWarp + i;
    if (f >= rows_total) continue;
    const int64_t pos = f / groups;
    const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
    float* dst = dq + ((b * sq + pos) * num_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < kColsQ; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dst[d] = scale * acc[i][c];
    }
  }
}

}  // namespace dq_pass

// ---- dk/dv pass -------------------------------------------------------------
namespace dkv_pass {

constexpr int kWarps = 4;
constexpr int kKeysPerWarp = 8;
constexpr int kKeys = kWarps * kKeysPerWarp;  // keys per block
constexpr int kRows = 32;                     // query rows a step, one a lane

template <int HD, int VD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kKeys * HD + kKeys * VD + HD * kStride +
                          VD * kStride + 2 * kRows +
                          2 * kWarps * kRows * kKeysPerWarp);
}

template <int HD, int VD, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ dyn,
                     int sq, int skv, int num_heads, int num_kv, int groups,
                     int causal, int window, float scale) {
  constexpr int kColsK = (HD + 31) / 32;  // dk columns per lane
  constexpr int kColsV = (VD + 31) / 32;  // dv columns per lane
  constexpr int W = kKeysPerWarp;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kKeys][HD]
  float* vs = ks + kKeys * HD;                  // [kKeys][VD]
  float* qt = vs + kKeys * VD;                  // [HD][kStride], scaled q
  float* dot = qt + HD * kStride;               // [VD][kStride], dO
  float* lse_s = dot + VD * kStride;            // [kRows]
  float* delta_s = lse_s + kRows;               // [kRows]
  float* ps = delta_s + kRows;                  // [kWarps][kRows][W]
  float* dss = ps + kWarps * kRows * W;         // [kWarps][kRows][W]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  // the first keys first: under a causal mask they see the most rows
  const int k0 = blockIdx.x * kKeys;
  const int k_last = min(k0 + kKeys, skv) - 1;

  for (int i = tid; i < kKeys * HD; i += blockDim.x) {
    const int j = i / HD, d = i % HD;
    const int64_t key = (b * skv + k0 + j) * num_kv + kvh;
    ks[i] = k0 + j < skv ? k[key * HD + d] : 0.0f;
  }
  for (int i = tid; i < kKeys * VD; i += blockDim.x) {
    const int j = i / VD, d = i % VD;
    const int64_t key = (b * skv + k0 + j) * num_kv + kvh;
    vs[i] = k0 + j < skv ? v[key * VD + d] : 0.0f;
  }

  float acc_k[W][kColsK], acc_v[W][kColsV];
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
#pragma unroll
    for (int c = 0; c < kColsK; ++c) acc_k[kk][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsV; ++c) acc_v[kk][c] = 0.0f;
  }

  // positions in the keys' coordinates, and the keys past which all are
  // masked: no shift and Skv on the static path
  int shift = 0, lim = skv;
  if constexpr (kDynamic) {
    const attn::Offsets o = attn::read_offsets(dyn, skv);
    shift = o.shift;
    lim = o.lim;
  }
  // the query rows some key of the block may be attended by (none when
  // every key of the block is at or past lim)
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  const int k_first = kDynamic ? max(k0 - shift, 0) : k0;
  const int64_t f_lo = causal ? static_cast<int64_t>(k_first) * groups : 0;
  const int64_t f_win =
      (static_cast<int64_t>(k_last) + window - shift) * groups;
  const int64_t f_hi =
      kDynamic && k0 >= lim                   ? f_lo
      : window > 0 && f_win < rows_total ? f_win
                                          : rows_total;
  const float* kw = ks + warp * W * HD;
  const float* vw = vs + warp * W * VD;
  float* pw = ps + warp * kRows * W;
  float* dsw = dss + warp * kRows * W;

  for (int64_t fc = f_lo; fc < f_hi; fc += kRows) {
    __syncthreads();  // the previous step's readers are done
    for (int i = tid; i < kRows * HD; i += blockDim.x) {
      const int r = i / HD, d = i % HD;
      const int64_t f = fc + r;
      float x = 0.0f;
      if (f < f_hi) {
        const int64_t pos = f / groups;
        const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
        x = q[((b * sq + pos) * num_heads + h) * HD + d] *
            scale;
      }
      qt[d * kStride + r] = x;
    }
    for (int i = tid; i < kRows * VD; i += blockDim.x) {
      const int r = i / VD, d = i % VD;
      const int64_t f = fc + r;
      float x = 0.0f;
      if (f < f_hi) {
        const int64_t pos = f / groups;
        const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
        x = dout[((b * sq + pos) * num_heads + h) * VD + d];
      }
      dot[d * kStride + r] = x;
    }
    if (tid < kRows) {
      const int64_t f = fc + tid;
      float l = __int_as_float(0x7f800000), dl = 0.0f;  // P = 0, dS = 0
      if (f < f_hi) {
        const int64_t pos = f / groups;
        const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
        l = lse[(b * num_heads + h) * sq + pos];
        dl = delta[(b * num_heads + h) * sq + pos];
      }
      lse_s[tid] = l;
      delta_s[tid] = dl;
    }
    __syncthreads();

    // this lane's row against the warp's keys: s = (scale q) . k, dO . v
    float s[W], dp[W];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) s[kk] = dp[kk] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float q0 = qt[(d + 0) * kStride + lane];
      const float q1 = qt[(d + 1) * kStride + lane];
      const float q2 = qt[(d + 2) * kStride + lane];
      const float q3 = qt[(d + 3) * kStride + lane];
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(kw + kk * HD + d);
        s[kk] = fmaf(q0, x.x, s[kk]);
        s[kk] = fmaf(q1, x.y, s[kk]);
        s[kk] = fmaf(q2, x.z, s[kk]);
        s[kk] = fmaf(q3, x.w, s[kk]);
      }
    }
#pragma unroll 4
    for (int d = 0; d < VD; d += 4) {
      const float o0 = dot[(d + 0) * kStride + lane];
      const float o1 = dot[(d + 1) * kStride + lane];
      const float o2 = dot[(d + 2) * kStride + lane];
      const float o3 = dot[(d + 3) * kStride + lane];
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(vw + kk * VD + d);
        dp[kk] = fmaf(o0, x.x, dp[kk]);
        dp[kk] = fmaf(o1, x.y, dp[kk]);
        dp[kk] = fmaf(o2, x.z, dp[kk]);
        dp[kk] = fmaf(o3, x.w, dp[kk]);
      }
    }
    const int64_t f_row = fc + lane;
    const int pos = static_cast<int>(
        (f_row < rows_total ? f_row : rows_total - 1) / groups) + shift;
    const float row_lse = lse_s[lane], row_delta = delta_s[lane];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      const int key = k0 + warp * W + kk;
      const float sk =
          allowed(key, pos, lim, causal, window) ? s[kk] : kNegInf;
      const float p = expf(sk - row_lse);
      pw[lane * W + kk] = p;
      dsw[lane * W + kk] = p * (dp[kk] - row_delta);
    }
    __syncwarp();

    // dk += dS^T (scale q), dv += P^T dO over the step's rows, each lane on
    // its columns
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 pa = *reinterpret_cast<const float4*>(pw + r * W);
      const float4 pb = *reinterpret_cast<const float4*>(pw + r * W + 4);
      const float4 da = *reinterpret_cast<const float4*>(dsw + r * W);
      const float4 db = *reinterpret_cast<const float4*>(dsw + r * W + 4);
      const float p[W] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float ds[W] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
      for (int c = 0; c < kColsK; ++c) {
        const int d = lane + 32 * c;
        const float x = d < HD ? qt[d * kStride + r] : 0.0f;
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          acc_k[kk][c] = fmaf(ds[kk], x, acc_k[kk][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kColsV; ++c) {
        const int d = lane + 32 * c;
        const float x = d < VD ? dot[d * kStride + r] : 0.0f;
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          acc_v[kk][c] = fmaf(p[kk], x, acc_v[kk][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const int key = k0 + warp * W + kk;
    if (key >= skv) continue;
    const int64_t row = (b * skv + key) * num_kv + kvh;
#pragma unroll
    for (int c = 0; c < kColsK; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dk[row * HD + d] = acc_k[kk][c];
    }
#pragma unroll
    for (int c = 0; c < kColsV; ++c) {
      const int d = lane + 32 * c;
      if (d < VD) dv[row * VD + d] = acc_v[kk][c];
    }
  }
}

}  // namespace dkv_pass

}  // namespace simt

// ---- bf16: tensor cores -----------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kRows = 64;  // dq pass: query rows a block, 16 a warp
constexpr int kKeys = 64;  // dq pass: keys a tile; dk/dv pass: keys a block
constexpr int kPad = 8;    // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;
// bf16 terms an f32 operand (dO, dS) enters its products as: three keep
// about 24 bits (two, about 16, leave a tail that fails the bf16 check at
// Mixtral's 600M gradient elements)
constexpr int kTerms = 3;

// q and K columns staged: hd rounded up to the MMA's K step of 16, the
// columns past hd zero
template <int HD>
__host__ __device__ constexpr int hd_mma() {
  return (HD + 15) / 16 * 16;
}

// dk/dv pass: query rows a step, 32 where 64 would leave the dk and dv
// accumulators (hd + vd floats a key) too few registers
template <int HD, int VD>
__host__ __device__ constexpr int row_step() {
  return HD + VD >= 224 ? 32 : 64;
}

// the masks of one call
struct Masks {
  int skv, causal, window;
  __device__ __forceinline__ bool allows(int key, int pos) const {
    return allowed(key, pos, skv, causal, window);
  }
};

// acc[NT][4] += A B^T over K columns, for the warp's 16 rows of A at `a`
// and NT * 8 rows of B at `b`, both row-major bf16 in shared memory
// (strides as, bs elements).  A is a sum of kATerms bf16 terms at a, a +
// a_term, ...; B of kBTerms at b, b + b_term, ...; each pair of terms is
// one MMA, in a fixed order.
template <int K, int NT, int kATerms, int kBTerms>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        int as, int a_term, const bf16* b,
                                        int bs, int b_term) {
  static_assert(K % 16 == 0 && NT % 2 == 0, "MMA steps of 16");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[kATerms][4];
#pragma unroll
    for (int i = 0; i < kATerms; ++i) {
      ldmatrix_x4(af[i], a + i * a_term + (lane & 15) * as + kc * 16 +
                             (lane >> 4) * 8);
    }
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
#pragma unroll
      for (int j = 0; j < kBTerms; ++j) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + j * b_term +
                            (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * bs +
                            kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < kATerms; ++i) {
          mma(acc[2 * n2], af[i], bf[0], bf[1]);
          mma(acc[2 * n2 + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
}

// (x, y) as kN bf16 pairs f[0][i] + f[1][i] + ...: each the bf16 rounding
// of what the terms before it leave (exact in f32), so kN terms keep about
// 8 kN bits of each
template <int kN, int kM>
__device__ __forceinline__ void split_terms(float x, float y,
                                            uint32_t (&f)[kN][kM], int i) {
#pragma unroll
  for (int n = 0; n < kN; ++n) f[n][i] = attn::take_bf16x2(x, y);
}

// acc[NT][4] += A B over 16 KT columns of A: A the warp's 16 x 16 KT f32
// accumulator fragment `a` (as the MMA leaves it) entering as kN bf16
// terms (split_terms); B 16 KT rows of NT * 8 columns at `b`, row-major
// bf16 in shared memory (stride bs), read with ldmatrix.trans.  Each
// 16-column step's kN products go into a zeroed fragment that is then
// added to acc in f32 (round to nearest): acc's chain through the tensor
// cores' adds is then one add a step, not kN.  A long reduction (dk and
// dv of MQA: 49k rows of Granite-34B's 48 heads a key) drifts on the long
// chain past the bf16 limits (dk 4.4, dv 3.3 of them at 1,024 queries
// over 4,160 keys, 48/1 heads, not causal).
template <int KT, int NT, int kN>
__device__ __forceinline__ void mma_fab(float (&acc)[NT][4],
                                        const float (&a)[2 * KT][4],
                                        const bf16* b, int bs) {
  static_assert(NT % 2 == 0, "MMA steps of 16");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[kN][4];
    split_terms(a[2 * kc][0], a[2 * kc][1], af, 0);
    split_terms(a[2 * kc][2], a[2 * kc][3], af, 1);
    split_terms(a[2 * kc + 1][0], a[2 * kc + 1][1], af, 2);
    split_terms(a[2 * kc + 1][2], a[2 * kc + 1][3], af, 3);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kc * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * bs +
                                n2 * 16 + (lane >> 4) * 8);
      float part[2][4] = {};
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        mma(part[0], af[n], bf[0], bf[1]);
        mma(part[1], af[n], bf[2], bf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * n2][e] += part[0][e];
        acc[2 * n2 + 1][e] += part[1][e];
      }
    }
  }
}

template <int HD, int VD>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (kRows * (hd_mma<HD>() + kPad) +
                         kTerms * kRows * (VD + kPad) +
                         2 * kKeys * (hd_mma<HD>() + kPad) +
                         2 * kKeys * (VD + kPad));
}

// dq pass; also writes delta (B, H, Sq) and dO split into kTerms bf16
// terms, dout_split (kTerms, B, Sq, H, VD), for the dk/dv pass
template <int HD, int VD, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dout_split, bf16* __restrict__ dq,
                    const int* __restrict__ dyn, int batch, int sq,
                    int num_heads, int num_kv, int groups, int q_tiles,
                    Masks masks, float scale) {
  constexpr int HK = hd_mma<HD>();  // q . k columns, zero past HD
  constexpr int QS = HK + kPad;      // shared-memory row strides (elements)
  constexpr int VS = VD + kPad;
  static_assert(VD % 16 == 0 && VD <= 128, "vd: a multiple of 16, <= 128");
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kRows][QS]
  bf16* dos = qs + kRows * QS;                // [kTerms][kRows][VS]
  bf16* ks = dos + kTerms * kRows * VS;       // [2][kKeys][QS]
  bf16* vs = ks + 2 * kKeys * QS;             // [2][kKeys][VS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int skv = masks.skv;
  // (batch, KV head) varies fastest, the query tiles run from the last
  // (longest under a causal mask) to the first
  const int pairs = batch * num_kv;
  const int kvh = blockIdx.x % pairs % num_kv;
  const int64_t b = blockIdx.x % pairs / num_kv;
  const int64_t qt = q_tiles - 1 - static_cast<int64_t>(blockIdx.x) / pairs;
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  const int64_t f0 = qt * kRows;
  const int64_t f_end = f0 + kRows < rows_total ? f0 + kRows : rows_total;
  // positions in the keys' coordinates, and the masks with keys at or past
  // lim masked: no shift and the call's masks on the static path
  int shift = 0, lim = skv;
  if constexpr (kDynamic) {
    const attn::Offsets o = attn::read_offsets(dyn, skv);
    shift = o.shift;
    lim = o.lim;
  }
  const Masks mk{lim, masks.causal, masks.window};
  const int pos_lo = static_cast<int>(f0 / groups) + shift;
  const int pos_hi = static_cast<int>((f_end - 1) / groups) + shift;
  auto row_of = [&](int64_t f) {  // f's (B, Sq, H) row
    return (b * sq + f / groups) * num_heads +
           static_cast<int64_t>(kvh) * groups + f % groups;
  };

  // the block's q rows, as they are (bf16), zero past HD and past the rows
  for (int i = tid; i < kRows * (HK / 8); i += kWarps * 32) {
    const int r = i / (HK / 8);
    const int c = (i % (HK / 8)) * 8;
    const bool valid = f0 + r < rows_total;
    cp_async16(qs + r * QS + c,
               q + row_of(valid ? f0 + r : 0) * HD + (c < HD ? c : 0),
               valid && c < HD);
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
  const int kv_end = masks.causal ? min(lim, pos_hi + 1) : lim;
  const int kv_first =
      masks.window > 0 ? max(0, pos_lo - masks.window + 1) : 0;
  const int t_begin = kv_first / kKeys * kKeys;
  const int n_tiles =
      kv_end > t_begin ? (kv_end - t_begin + kKeys - 1) / kKeys : 0;
  if (n_tiles > 0) load_kv(t_begin, 0);
  cp_async_commit();

  // the warp's 16 rows: dO split into its terms (shared memory and the
  // scratch), delta = rowsum(dO O) in f32 (stored, and kept for rows g and
  // g + 8 of this lane)
  const int64_t term = static_cast<int64_t>(batch) * sq * num_heads * VD;
  float row_delta[2] = {0.0f, 0.0f};
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const bool valid = f0 + r < rows_total;
    const int64_t row = row_of(valid ? f0 + r : 0);
    const int c = lane * 4;
    float dot = 0.0f;
    if (c < VD) {
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f), o = d;
      if (valid) {
        d = *reinterpret_cast<const float4*>(dout + row * VD + c);
        o = *reinterpret_cast<const float4*>(out + row * VD + c);
      }
      dot = fmaf(d.w, o.w, fmaf(d.z, o.z, fmaf(d.y, o.y, d.x * o.x)));
      uint32_t f[kTerms][2];
      split_terms(d.x, d.y, f, 0);
      split_terms(d.z, d.w, f, 1);
#pragma unroll
      for (int n = 0; n < kTerms; ++n) {
        const uint2 pair = make_uint2(f[n][0], f[n][1]);
        *reinterpret_cast<uint2*>(dos + (n * kRows + r) * VS + c) = pair;
        if (valid) {
          *reinterpret_cast<uint2*>(dout_split + n * term + row * VD + c) =
              pair;
        }
      }
    }
    dot = attn::warp_sum(dot);
    if (valid && lane == 0) {
      const int64_t f = f0 + r;
      delta[(b * num_heads + static_cast<int64_t>(kvh) * groups +
             f % groups) * sq + f / groups] = dot;
    }
    if (i == g) row_delta[0] = dot;
    if (i == g + 8) row_delta[1] = dot;
  }

  // rows g (r = 0) and g + 8 (r = 1) of the warp's 16: position and lse in
  // log2 units (+inf past the rows: P = 0)
  int row_pos[2];
  float row_lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t f = f0 + warp * 16 + g + 8 * r;
    const int64_t fc = f < rows_total ? f : rows_total - 1;
    row_pos[r] = static_cast<int>(fc / groups) + shift;
    row_lse2[r] = f < rows_total
                      ? lse[(b * num_heads + static_cast<int64_t>(kvh) *
                                                 groups + f % groups) * sq +
                            f / groups] * kLog2e
                      : __int_as_float(0x7f800000);
  }
  const float c1 = scale * kLog2e;

  float acc[HK / 8][4];
#pragma unroll
  for (int n = 0; n < HK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  const bf16* qw = qs + warp * 16 * QS;
  const bf16* dow = dos + warp * 16 * VS;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKeys;
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kKeys, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and q's) has landed
    __syncthreads();
    const bf16* kt = ks + buf * kKeys * QS;
    const bf16* vt = vs + buf * kKeys * VS;

    // S = q K^T and dP = dO V^T over the tile's 64 keys
    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    }
    mma_abt<HK, kKeys / 8, 1, 1>(s, qw, QS, 0, kt, QS, 0);
    mma_abt<VD, kKeys / 8, kTerms, 1>(dp, dow, VS, kRows * VS, vt, VS, 0);

    // P, masked where some (row, key) pair of the tile is, then dS = P (dP
    // - delta) in place of S
    const bool edge = t0 + kKeys > lim ||
                      (masks.causal && t0 + kKeys - 1 > pos_lo) ||
                      (masks.window > 0 && t0 <= pos_hi - masks.window);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            edge && !mk.allows(t0 + n * 8 + 2 * t + (e & 1), row_pos[r])
                ? 0.0f
                : exp2_ftz(fmaf(s[n][e], c1, -row_lse2[r]));
        s[n][e] = p * (dp[n][e] - row_delta[r]);
      }
    }

    // dq += dS K, dS in its bf16 terms
    mma_fab<kKeys / 16, HK / 8, kTerms>(acc, s, kt, QS);
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();  // no copy outlives the block (none is left pending
                       // unless it saw no tile)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t f = f0 + warp * 16 + g + 8 * r;
    if (f >= rows_total) continue;
    bf16* dst = dq + row_of(f) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HK / 8; ++n) {
      if (n * 8 < HD) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __halves2bfloat162(
            Elem<bf16>::narrow(scale * acc[n][2 * r]),
            Elem<bf16>::narrow(scale * acc[n][2 * r + 1]));
      }
    }
  }
}

template <int HD, int VD>
constexpr size_t dkv_smem_bytes() {
  constexpr int N = row_step<HD, VD>();
  return sizeof(bf16) * (kKeys * (hd_mma<HD>() + kPad) + kKeys * (VD + kPad) +
                         2 * N * (hd_mma<HD>() + kPad) +
                         2 * kTerms * N * (VD + kPad)) +
         sizeof(float) * 2 * 2 * N;
}

// dk/dv pass, from q, the dq pass's dO terms and delta, and lse
template <int HD, int VD, bool kDynamic>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout_split,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ dyn,
                     int batch, int sq, int num_heads, int num_kv, int groups,
                     Masks masks, float scale) {
  constexpr int HK = hd_mma<HD>();
  constexpr int QS = HK + kPad;
  constexpr int VS = VD + kPad;
  constexpr int N = row_step<HD, VD>();  // query rows a step
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // [kKeys][QS]
  bf16* vs = ks + kKeys * QS;                 // [kKeys][VS]
  bf16* qs = vs + kKeys * VS;                 // [2][N][QS]
  bf16* dos = qs + 2 * N * QS;                // [2][kTerms][N][VS]
  float* lse_s =
      reinterpret_cast<float*>(dos + 2 * kTerms * N * VS);  // [2][N]
  float* delta_s = lse_s + 2 * N;                                 // [2][N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int skv = masks.skv;
  // (batch, KV head) varies fastest, the key tiles run from the first
  // (seen by the most rows under a causal mask) to the last
  const int pairs = batch * num_kv;
  const int kvh = blockIdx.x % pairs % num_kv;
  const int64_t b = blockIdx.x % pairs / num_kv;
  const int k0 = static_cast<int>(blockIdx.x / pairs) * kKeys;
  const int k_last = min(k0 + kKeys, skv) - 1;
  const int64_t term = static_cast<int64_t>(batch) * sq * num_heads * VD;

  for (int i = tid; i < kKeys * (HK / 8); i += kWarps * 32) {
    const int j = i / (HK / 8);
    const int c = (i % (HK / 8)) * 8;
    const int64_t key = k0 + j < skv ? k0 + j : 0;
    cp_async16(ks + j * QS + c,
               k + ((b * skv + key) * num_kv + kvh) * HD + (c < HD ? c : 0),
               k0 + j < skv && c < HD);
  }
  for (int i = tid; i < kKeys * (VD / 8); i += kWarps * 32) {
    const int j = i / (VD / 8);
    const int c = (i % (VD / 8)) * 8;
    const int64_t key = k0 + j < skv ? k0 + j : 0;
    cp_async16(vs + j * VS + c, v + ((b * skv + key) * num_kv + kvh) * VD + c,
               k0 + j < skv);
  }

  // positions in the keys' coordinates, and the masks with keys at or past
  // lim masked: no shift and the call's masks on the static path
  int shift = 0, lim = skv;
  if constexpr (kDynamic) {
    const attn::Offsets o = attn::read_offsets(dyn, skv);
    shift = o.shift;
    lim = o.lim;
  }
  const Masks mk{lim, masks.causal, masks.window};
  // the query rows some key of the block may be attended by (Sq G <
  // 2^31: the wrapper checks it; none when every key of the block is at
  // or past lim)
  const int rows_total = sq * groups;
  const int64_t f_causal =
      static_cast<int64_t>(kDynamic ? max(k0 - shift, 0) : k0) * groups;
  const int f_lo = !masks.causal        ? 0
                   : f_causal < rows_total ? static_cast<int>(f_causal)
                                           : rows_total;
  const int64_t f_win =
      (static_cast<int64_t>(k_last) + masks.window - shift) * groups;
  const int f_hi = masks.window > 0 && f_win < rows_total
                       ? static_cast<int>(f_win)
                       : rows_total;
  const int n_steps = f_hi > f_lo && !(kDynamic && k0 >= lim)
                          ? (f_hi - f_lo + N - 1) / N
                          : 0;
  // q, dO's terms, lse and delta of rows [fc, fc + N), zero past f_hi
  auto load_rows = [&](int fc, int buf) {
    bf16* qd = qs + buf * N * QS;
    bf16* dod = dos + buf * kTerms * N * VS;
    for (int i = tid; i < N * (HK / 8); i += kWarps * 32) {
      const int r = i / (HK / 8);
      const int c = (i % (HK / 8)) * 8;
      const int f = fc + r < f_hi ? fc + r : 0;
      const int64_t row = (b * sq + f / groups) * num_heads +
                          static_cast<int64_t>(kvh) * groups + f % groups;
      cp_async16(qd + r * QS + c, q + row * HD + (c < HD ? c : 0),
                 fc + r < f_hi && c < HD);
    }
    for (int i = tid; i < kTerms * N * (VD / 8); i += kWarps * 32) {
      const int n = i / (N * (VD / 8));
      const int r = i % (N * (VD / 8)) / (VD / 8);
      const int c = (i % (VD / 8)) * 8;
      const int f = fc + r < f_hi ? fc + r : 0;
      const int64_t row = (b * sq + f / groups) * num_heads +
                          static_cast<int64_t>(kvh) * groups + f % groups;
      cp_async16(dod + (n * N + r) * VS + c,
                 dout_split + n * term + row * VD + c, fc + r < f_hi);
    }
    if (tid < N) {
      const int f = fc + tid < f_hi ? fc + tid : 0;
      const int64_t i = (b * num_heads + static_cast<int64_t>(kvh) * groups +
                         f % groups) * sq + f / groups;
      cp_async4(lse_s + buf * N + tid, lse + i, fc + tid < f_hi);
      cp_async4(delta_s + buf * N + tid, delta + i, fc + tid < f_hi);
    }
  };
  if (n_steps > 0) load_rows(f_lo, 0);
  cp_async_commit();  // with K and V

  float acc_k[HK / 8][4], acc_v[VD / 8][4];
#pragma unroll
  for (int n = 0; n < HK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.0f;
  }
  const bf16* kw = ks + warp * 16 * QS;
  const bf16* vw = vs + warp * 16 * VS;
  // this lane's keys: rows g (r = 0) and g + 8 (r = 1) of the warp's 16
  const int key0 = k0 + warp * 16 + g;
  const int key_hi = k0 + kKeys - 1;
  const float c1 = scale * kLog2e;

  for (int it = 0; it < n_steps; ++it) {
    const int fc = f_lo + it * N;
    const int buf = it & 1;
    if (it + 1 < n_steps) load_rows(fc + N, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's group (and K's, V's) has landed
    __syncthreads();
    const bf16* qt = qs + buf * N * QS;
    const bf16* dot = dos + buf * kTerms * N * VS;
    const float* lse_t = lse_s + buf * N;
    const float* delta_t = delta_s + buf * N;

    // S^T = K q^T over the step's N rows, then P^T in place
    float s[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
    mma_abt<HK, N / 8, 1, 1>(s, kw, QS, 0, qt, QS, 0);
    const int f_last = min(fc + N, f_hi) - 1;
    const bool edge =
        (kDynamic && key_hi >= lim) ||
        (masks.causal && key_hi > fc / groups + shift) ||
        (masks.window > 0 && f_last / groups + shift - k0 >= masks.window);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        s[n][e] = edge && !mk.allows(key0 + 8 * (e >> 1),
                                     (fc + col) / groups + shift)
                      ? 0.0f
                      : exp2_ftz(fmaf(s[n][e], c1, -lse_t[col] * kLog2e));
      }
    }

    // dv += P^T dO: P_1 dO_1 + P_2 dO_1, then P_1 dO_2 (P in two terms and
    // dO in two keep 16 bits, which dv's check passes)
    mma_fab<N / 16, VD / 8, 2>(acc_v, s, dot, VS);
    mma_fab<N / 16, VD / 8, 1>(acc_v, s, dot + N * VS, VS);

    // dP^T = V dO^T, dO in its terms; dS^T = P^T (dP^T - delta) in place
    // of P^T
    float dp[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.0f;
    }
    mma_abt<VD, N / 8, 1, kTerms>(dp, vw, VS, 0, dot, VS, N * VS);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= dp[n][e] - delta_t[n * 8 + 2 * t + (e & 1)];
      }
    }

    // dk += dS^T q, dS in its bf16 terms
    mma_fab<N / 16, HK / 8, kTerms>(acc_k, s, qt, QS);
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    const int64_t row = (b * skv + key) * num_kv + kvh;
#pragma unroll
    for (int n = 0; n < HK / 8; ++n) {
      if (n * 8 < HD) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row * HD + n * 8 + 2 * t) =
            __halves2bfloat162(Elem<bf16>::narrow(scale * acc_k[n][2 * r]),
                               Elem<bf16>::narrow(scale * acc_k[n][2 * r + 1]));
      }
    }
#pragma unroll
    for (int n = 0; n < VD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dv + row * VD + n * 8 + 2 * t) =
          __halves2bfloat162(Elem<bf16>::narrow(acc_v[n][2 * r]),
                             Elem<bf16>::narrow(acc_v[n][2 * r + 1]));
    }
  }
}

}  // namespace tc

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int HD, int VD, bool kDynamic>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, const int* dyn, int batch, int sq, int skv,
               int num_heads, int num_kv, int causal, int window, float scale,
               cudaStream_t stream) {
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);

  constexpr size_t smem_dq = simt::dq_pass::smem_bytes<HD, VD>();
  auto dq_kernel = simt::dq_pass::flash_bwd_dq_kernel<HD, VD, kDynamic>;
  int err = allow_smem(dq_kernel, smem_dq);
  if (err) return err;
  const dim3 grid_dq(static_cast<unsigned>((rows + simt::dq_pass::kRows - 1) /
                                           simt::dq_pass::kRows),
                     num_kv, batch);
  dq_kernel<<<grid_dq, simt::dq_pass::kWarps * 32, smem_dq, stream>>>(
      qp, kp, vp, static_cast<const float*>(out), dop, lp, dlp,
      static_cast<float*>(dq), dyn, sq, skv, num_heads, num_kv, groups,
      causal, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  constexpr size_t smem_dkv = simt::dkv_pass::smem_bytes<HD, VD>();
  auto dkv_kernel = simt::dkv_pass::flash_bwd_dkv_kernel<HD, VD, kDynamic>;
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err) return err;
  const dim3 grid_dkv(
      static_cast<unsigned>((skv + simt::dkv_pass::kKeys - 1) /
                            simt::dkv_pass::kKeys),
      num_kv, batch);
  dkv_kernel<<<grid_dkv, simt::dkv_pass::kWarps * 32, smem_dkv, stream>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<float*>(dk),
      static_cast<float*>(dv), dyn, sq, skv, num_heads, num_kv, groups,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int VD, bool kDynamic>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* delta,
                void* dout_split, void* dq, void* dk, void* dv,
                const int* dyn, int batch, int sq, int skv, int num_heads,
                int num_kv, int causal, int window, float scale,
                cudaStream_t stream) {
  using tc::bf16;
  const tc::Masks masks{skv, causal, window};
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const int64_t pairs = static_cast<int64_t>(batch) * num_kv;
  const int64_t q_tiles = (rows + tc::kRows - 1) / tc::kRows;
  const int64_t k_tiles = (skv + tc::kKeys - 1) / tc::kKeys;
  if (max(q_tiles, k_tiles) * pairs >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* lp = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);
  bf16* dsp = static_cast<bf16*>(dout_split);

  constexpr size_t smem_dq = tc::dq_smem_bytes<HD, VD>();
  auto dq_kernel = tc::flash_bwd_dq_kernel<HD, VD, kDynamic>;
  int err = allow_smem(dq_kernel, smem_dq);
  if (err) return err;
  dq_kernel<<<static_cast<unsigned>(q_tiles * pairs), tc::kWarps * 32,
              smem_dq, stream>>>(
      qp, kp, vp, static_cast<const float*>(out),
      static_cast<const float*>(dout), lp, dlp, dsp, static_cast<bf16*>(dq),
      dyn, batch, sq, num_heads, num_kv, groups, static_cast<int>(q_tiles),
      masks, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  constexpr size_t smem_dkv = tc::dkv_smem_bytes<HD, VD>();
  auto dkv_kernel = tc::flash_bwd_dkv_kernel<HD, VD, kDynamic>;
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err) return err;
  dkv_kernel<<<static_cast<unsigned>(k_tiles * pairs), tc::kWarps * 32,
               smem_dkv, stream>>>(
      qp, kp, vp, dsp, lp, dlp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dyn, batch, sq, num_heads, num_kv, groups, masks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef ATTN_DYNAMIC
// dtype: 0 f32 (CUDA cores), 1 bf16 (tensor cores) for q, k, v, dq, dk,
// dv; out, dout (B, Sq, H, vd), lse and the scratch delta (B, H, Sq) are
// f32.  dout_split: bf16 only, a scratch (3, B, Sq, H, vd) for dO's three
// bf16 terms (null for f32).  window <= 0: no window.  Launches the dq
// pass, then the dk/dv pass, on `stream`; returns the CUDA error of the
// launches (0 on success).  The wrapper has checked every shape.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dout_split, void* dq,
                                   void* dk, void* dv, int batch, int sq,
                                   int skv, int num_heads, int num_kv, int hd,
                                   int vd, int causal, int window, float scale,
                                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* dyn = nullptr;
#else
// The dynamic-offset entry: `offsets` is the forward's int32[3] on the
// device (q_offset, kv_offset, kv_valid_len).  Otherwise as the static
// entry flash_attention_bwd.
extern "C" int flash_attention_bwd_dynamic(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dout_split,
    void* dq, void* dk, void* dv, const void* offsets, int batch, int sq,
    int skv, int num_heads, int num_kv, int hd, int vd, int causal,
    int window, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* dyn = static_cast<const int*>(offsets);
#endif
#ifdef ATTN_DYNAMIC
  constexpr bool kDynamic = true;
#else
  constexpr bool kDynamic = false;
#endif
#define ATTN_CASE(H, V)                                                      \
  if (hd == H && vd == V) {                                                  \
    if (dtype == 0)                                                          \
      return launch_f32<H, V, kDynamic>(q, k, v, out, dout, lse, delta, dq,  \
                                        dk, dv, dyn, batch, sq, skv,         \
                                        num_heads, num_kv, causal, window,   \
                                        scale, s);                           \
    if (dtype == 1 && dout_split)                                            \
      return launch_bf16<H, V, kDynamic>(q, k, v, out, dout, lse, delta,     \
                                         dout_split, dq, dk, dv, dyn, batch, \
                                         sq, skv, num_heads, num_kv, causal, \
                                         window, scale, s);                  \
  }
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
