// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, GQA groups, f32 accumulation, in one launch.
//
//   out[b, 0, h] = sum_{j < n} softmax_j(scale * q[b, 0, h] . k[b, j, h / G]) v[b, j, h / G]
//
// with n = min(cache_len, S) read on the device (no host sync per step)
// and G = H / KV.  scale * q is rounded to q's dtype before it is used,
// the order of the model's jnp decode (repro/models/layers.py::
// decode_attention scales q in its own dtype; the Pallas kernel widens q
// first, which differs by that one rounding in bf16).  The rounding is a
// no-op in f32.  Inputs q (B, 1, H, hd), k_cache (B, S, KV, hd), v_cache
// (B, S, KV, vd), contiguous, f32 or bf16; out (B, 1, H, vd) in q's dtype.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_kernel (body _decode_kernel), and on the model path the
// full-row jnp softmax that stands in for it (repro/models/layers.py::
// decode_attention).  The TPU kernel streams the cache tiles in order
// through one core, the (acc, m, l) state of the G grouped queries in VMEM.
//
// Bound: HBM bytes.  A step reads each valid K and V slot once (Qwen2-0.5B,
// B = 8, S = 4096: 16.8 MB, 5.0 us at 3.35 TB/s) for 4 flops per slot,
// head and dim, far below the card's flop/byte ratio.  So the valid slots
// have to stream through many SMs at once, with many bytes in flight on
// each, and a call must pay no fixed cost that does not scale with n.
//
// Design:
// - One thread-block cluster of kCluster CTAs per (b, KV head, chunk of up
//   to 8 query heads of the group); the Qwen2-0.5B decode step (B = 8,
//   2 KV heads, G = 7) is 16 clusters of 8, 128 CTAs.  The CTAs split the
//   valid range [0, n) evenly, in whole chunks of 32 slots, so the work
//   follows cache_len and not S; a CTA past n does no loads.
// - Each warp of a CTA takes every kWarps-th chunk of the CTA's range and
//   stages it, K and V, in shared memory with 16-byte cp.async, kStages
//   chunks deep (a chunk loads while the one before it is used); rows are
//   padded by 16 bytes so that the reads below do not conflict.  Then the
//   warp scores the chunk against the group's (up to 8) query heads and
//   runs the reference's online-softmax update (m, l, acc):
//   - bf16 on the tensor cores (mma.m16n8k16, f32 accumulators): the heads
//     are the top 8 rows of a 16-row tile, S = q K^T on the raw bf16
//     operands, and P enters P V as two bf16 terms (hi + lo), so its
//     rounding stays near f32's (on the CUDA cores, the 1,024 FMAs a lane
//     makes per chunk would set the time);
//   - f32 on the CUDA cores: a lane scores 2 heads against 4 slots (a
//     register tile: 8 shared-memory reads per 64 FMAs), and for P V takes
//     16 bytes of a V row (lanes split the row's columns and the slots).
// - The warps' states merge in shared memory into the CTA's (m, l, acc),
//   which each CTA stores into rank 0's shared memory through distributed
//   shared memory (map_shared_rank), once every CTA of the cluster runs (a
//   cluster arrive at the start, its wait before the stores).  After one
//   full cluster barrier rank 0 merges the parts in rank order and writes
//   the group's outputs: M = max m, L = sum l exp(m - M), A = sum acc
//   exp(m - M), out = L > 0 ? A / max(L, 1e-30) : 0, each factor
//   exp(m - M) computed once per head.  A part with no slot holds (-1e30,
//   0, 0) and adds nothing.  There are no global partials, no second
//   kernel and no atomics: every run gives the same bits.
// - A group wider than 8 heads takes several row chunks, each reading the
//   cache again (MQA with G = 16: twice); the Qwen2 group (G = 7) is one.
// - Templated on the dtype and on the (hd, vd) pairs of ATTN_FOR_EACH_DIMS
//   (every pair of {16, 32, 64, 128}, and (24, 16), (96, 64), (112, 112));
//   the warps per CTA follow the staged bytes (5 at the Qwen2 shape, down
//   to 1 for f32 at hd = vd = 112 or 128).
// - A row of hd or vd that is no power-of-two number of 16-byte pieces
//   (hd 24, 96, 112) leaves some lanes of a staging round without a piece:
//   they copy nothing.  The bf16 path's MMA contracts 16 columns a step, so
//   there K and q are staged with hd rounded up to 16 (hd = 24: 32), the
//   columns past hd zero-filled by the copies themselves.  In the f32
//   path's P V a V row of 28 lanes (vd = 112) leaves one row group a warp
//   step, and lanes 28..31 take no rows.

#include <cooperative_groups.h>

#include <type_traits>

#include "../../attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::Elem;
using attn::kNegInf;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::split;

constexpr int kCluster = 8;     // CTAs per (b, KV head, row chunk)
constexpr int kRows = 8;        // query heads of a group per CTA
constexpr int kChunk = 32;      // slots a warp takes per step, one per lane
constexpr int kStages = 2;      // chunks a warp keeps in shared memory
constexpr int kPad = 16;        // bytes after each staged row
// staged bytes per CTA at most.  Two CTAs, each with its 16 KB of parts,
// fit an SM, so every cluster of a call is resident at once (at one CTA per
// SM the card cannot place all 16 clusters of the Qwen2 shape together, and
// the call runs in two waves).  At the Qwen2 shape the budget is 5 warps of
// two chunks: 320 slots a CTA, 2,560 a cluster in flight at once, so a
// served decode step (cache_len 2,049-2,111 in chip_smoke.py's LM run)
// streams in one round and a warp waits on one load round trip.
constexpr int kStageBudget = 92 * 1024;
constexpr int kMaxWarps = 5;
static_assert(kRows == 8, "a lane scores 2 heads, 4 lanes cover the rows");

template <typename T, int HD, int VD>
struct Plan {
  static constexpr int kVec = 16 / sizeof(T);             // per 16 bytes
  // q and K columns staged: hd, rounded up to the MMA's K step of 16 on the
  // tensor cores (bf16), the columns past hd zero
  static constexpr int kHdK =
      std::is_same<T, float>::value ? HD : (HD + 15) / 16 * 16;
  static constexpr int kStrideK = kHdK * sizeof(T) + kPad;  // staged bytes
  static constexpr int kStrideV = VD * sizeof(T) + kPad;
  static constexpr int kStage = kChunk * (kStrideK + kStrideV);
  static constexpr int kWarpBytes = kStages * kStage;
  static_assert(kRows * VD * 4 <= kWarpBytes, "a warp's acc fits its stage");
  static constexpr int kWarps =
      kStageBudget / kWarpBytes >= kMaxWarps ? kMaxWarps
      : kStageBudget / kWarpBytes >= 1 ? kStageBudget / kWarpBytes : 1;
  static constexpr int kStaged = kWarps * kWarpBytes;
  // dynamic shared memory: the staged chunks, then rank 0's parts (static
  // shared memory stops at 48 KB)
  static constexpr int kSmem = kStaged + kCluster * kRows * VD * 4;
  static constexpr int kLanesPerRow = VD / kVec;  // lanes across a V row
  static constexpr int kGroups = 32 / kLanesPerRow;  // V rows per warp step
  // 16-byte pieces of a staged K row (those past kDataK zero-filled) and of
  // a V row
  static constexpr int kPiecesK = kHdK * sizeof(T) / 16;
  static constexpr int kDataK = HD * sizeof(T) / 16;
  static constexpr int kPiecesV = VD * sizeof(T) / 16;
};

// q's rows in shared memory: f32, 16 bytes apart from a bank's view
template <int HD>
__host__ __device__ constexpr int q_stride() {
  return HD + 4;
}

// f32 on the CUDA cores.  Scoring: lane (pair, sg) takes rows 2 pair,
// 2 pair + 1 and the chunk's slots sg + 8 i, i < 4 (staged rows 16 bytes
// apart: the 8 slot groups' K reads and the 4 pairs' q reads fall in
// distinct banks).  P.V: lane (grp, col) takes the chunk's slots grp +
// kGroups j and 16 bytes of their V rows from column col.
template <typename T, int HD, int VD, int kWarps, typename Stage>
__device__ __forceinline__ void warp_chunks_simt(
    const unsigned char* my, Stage&& stage_chunk, int lo, int hi, int mine,
    int warp, int lane, const float* qs, float (*ps)[kRows], float* wm,
    float* wl, float (*wacc)[VD]) {
  using P = Plan<T, HD, VD>;
  constexpr int kVec = P::kVec;
  constexpr int kQStride = q_stride<P::kHdK>();
  const int pair = lane & 3;
  const int sg = lane >> 2;
  // a lane past the last whole row group (vd = 112: lanes 28..31) takes
  // no V rows
  const int grp = lane / P::kLanesPerRow;
  const int first_row = grp < P::kGroups ? grp : kChunk;
  const int col = (lane % P::kLanesPerRow) * kVec;
  float m[2], l[2];  // the online softmax of rows 2 pair, 2 pair + 1
  float acc[kRows][kVec];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.0f;
  }

  for (int t = 0; t < mine; ++t) {
    if (t + kStages - 1 < mine) stage_chunk(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this chunk's copies have landed
    __syncwarp();
    const unsigned char* kst = my + (t % kStages) * P::kStage;
    const unsigned char* vst = kst + kChunk * P::kStrideK;
    const int count = min(kChunk, hi - (lo + (warp + t * kWarps) * kChunk));
    float sc[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[rr][i] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < HD; d += kVec) {
      float qf[2][kVec];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              qs + (2 * pair + rr) * kQStride + d + e);
          qf[rr][e] = x.x;
          qf[rr][e + 1] = x.y;
          qf[rr][e + 2] = x.z;
          qf[rr][e + 3] = x.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float kf[kVec];
        Elem<T>::load(
            reinterpret_cast<const T*>(kst + (sg + 8 * i) * P::kStrideK) + d,
            kf);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            sc[rr][i] = fmaf(qf[rr][e], kf[e], sc[rr][i]);
        }
      }
    }
    // the reference's online-softmax update; slot 0 is valid, so every row
    // sees a valid score in the chunk
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (sg + 8 * i >= count) sc[rr][i] = kNegInf;
        mx = fmaxf(mx, sc[rr][i]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sc[rr][i] - m_new);
        ps[sg + 8 * i][2 * pair + rr] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr[rr] + sum;
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float c = __shfl_sync(0xffffffffu, corr[i & 1], i >> 1);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] *= c;
    }
    __syncwarp();
    for (int j = first_row; j < count; j += P::kGroups) {
      float vf[kVec];
      Elem<T>::load(reinterpret_cast<const T*>(vst + j * P::kStrideV) + col,
                    vf);
      const float4 p0 = *reinterpret_cast<const float4*>(&ps[j][0]);
      const float4 p1 = *reinterpret_cast<const float4*>(&ps[j][4]);
      const float pj[kRows] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[i][e] = fmaf(pj[i], vf[e], acc[i][e]);
      }
    }
    __syncwarp();  // the buffer is free for the chunk after next
  }
  cp_async_wait<0>();

  // the lanes that share columns sum their slots' parts (a row of 28
  // lanes, vd = 112, is a warp step's one group: nothing to sum)
  static_assert(P::kGroups == 1 ||
                    (P::kLanesPerRow & (P::kLanesPerRow - 1)) == 0,
                "the butterfly takes a power-of-two row of lanes");
  if constexpr (P::kGroups > 1) {
#pragma unroll
    for (int off = P::kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      }
    }
  }
  if (sg == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      wm[2 * pair + rr] = m[rr];
      wl[2 * pair + rr] = l[rr];
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) wacc[i][col + e] = acc[i][e];
    }
  }
}

// d += a b: a 16 x 16 bf16 (row) whose rows 8..15 are zero (a1 = a3 = 0),
// b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_top(float (&d)[4], uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// bf16 on the tensor cores (mma.m16n8k16, f32 accumulators).  The group's
// 8 heads are rows 0..7 of the 16-row A tiles (rows 8..15 are zero), so
// lane = 4 g + tq holds head g: its scores at slots 2 tq, 2 tq + 1 of each
// 8-slot tile, and its output at columns 2 tq, 2 tq + 1 of each 8-column
// tile.  S = q K^T takes the raw bf16 operands (products exact in f32;
// scale * q was rounded to bf16 already); P enters P V as two bf16 terms,
// P = hi + lo, so its rounding stays near f32's.
template <int HD, int VD, int kWarps, typename Stage>
__device__ __forceinline__ void warp_chunks_tc(
    const unsigned char* my, Stage&& stage_chunk, int lo, int hi, int mine,
    int warp, int lane, const float* qs, float* wm, float* wl,
    float (*wacc)[VD]) {
  using bf16 = __nv_bfloat16;
  using P = Plan<bf16, HD, VD>;
  constexpr int KS = P::kStrideK / 2;  // staged row strides, in elements
  constexpr int VS = P::kStrideV / 2;
  constexpr int HK = P::kHdK;          // q . k columns, zero past HD
  constexpr int kQStride = q_stride<HK>();
  const int g = lane >> 2;
  const int tq = lane & 3;
  // A fragments of q (row g; rows 8..15 zero): columns 2 tq (+1) and
  // 2 tq + 8 (+1) of each 16-wide step, rounded back to bf16 exactly
  uint32_t qa[HK / 16][2];
#pragma unroll
  for (int kc = 0; kc < HK / 16; ++kc) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = qs + g * kQStride + kc * 16 + h * 8 + 2 * tq;
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(x[0], x[1]);
      qa[kc][h] = *reinterpret_cast<const uint32_t*>(&v2);
    }
  }
  float m = kNegInf, l = 0.0f;  // head g's online softmax
  float o[VD / 8][4];
#pragma unroll
  for (int n = 0; n < VD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }

  for (int t = 0; t < mine; ++t) {
    if (t + kStages - 1 < mine) stage_chunk(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this chunk's copies have landed
    __syncwarp();
    const bf16* kt =
        reinterpret_cast<const bf16*>(my + (t % kStages) * P::kStage);
    const bf16* vt = kt + kChunk * KS;
    const int count = min(kChunk, hi - (lo + (warp + t * kWarps) * kChunk));

    // S = q K^T over the chunk's 32 slots: 4 tiles of 8 slots
    float sc[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
    }
#pragma unroll
    for (int kc = 0; kc < HK / 16; ++kc) {
#pragma unroll
      for (int n2 = 0; n2 < kChunk / 16; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * KS +
                            kc * 16 + ((lane >> 3) & 1) * 8);
        mma_top(sc[2 * n2], qa[kc][0], qa[kc][1], kb[0], kb[1]);
        mma_top(sc[2 * n2 + 1], qa[kc][0], qa[kc][1], kb[2], kb[3]);
      }
    }
    // the reference's online-softmax update over head g's slots (its 4
    // lanes share them); slot 0 is valid, so the row max is a score
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n * 8 + 2 * tq + e >= count) sc[n][e] = kNegInf;
        mx = fmaxf(mx, sc[n][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = expf(sc[n][e] - m_new);
        sum += sc[n][e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int n = 0; n < VD / 8; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }
    // O += P V, 16 slots at a time
#pragma unroll
    for (int kc = 0; kc < kChunk / 16; ++kc) {
      uint32_t ph[2], pl[2];
      split(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      split(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[1], pl[1]);
#pragma unroll
      for (int n2 = 0; n2 < VD / 16; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * VS +
                                  n2 * 16 + (lane >> 4) * 8);
        mma_top(o[2 * n2], ph[0], ph[1], vb[0], vb[1]);
        mma_top(o[2 * n2], pl[0], pl[1], vb[0], vb[1]);
        mma_top(o[2 * n2 + 1], ph[0], ph[1], vb[2], vb[3]);
        mma_top(o[2 * n2 + 1], pl[0], pl[1], vb[2], vb[3]);
      }
    }
    __syncwarp();  // the buffer is free for the chunk after next
  }
  cp_async_wait<0>();
  if (tq == 0) {
    wm[g] = m;
    wl[g] = l;
  }
#pragma unroll
  for (int n = 0; n < VD / 8; ++n) {
    wacc[g][n * 8 + 2 * tq] = o[n][0];
    wacc[g][n * 8 + 2 * tq + 1] = o[n][1];
  }
}

template <typename T, int HD, int VD>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(Plan<T, HD, VD>::kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ cache_len,
              T* __restrict__ out, int s, int num_heads, int num_kv,
              int groups, int row_chunks, float scale) {
  using P = Plan<T, HD, VD>;
  constexpr int kWarps = P::kWarps;
  constexpr int kVec = P::kVec;
  extern __shared__ __align__(16) unsigned char stage[];
  constexpr int kQStride = q_stride<P::kHdK>();
  // P of each warp's chunk (the f32 path's; the bf16 path keeps P in
  // registers)
  constexpr int kPsWarps = std::is_same<T, float>::value ? kWarps : 1;
  __shared__ __align__(16) float qs[kRows * kQStride];
  __shared__ __align__(16) float ps[kPsWarps][kChunk][kRows];
  __shared__ float wm[kWarps][kRows];
  __shared__ float wl[kWarps][kRows];
  __shared__ float wf[kWarps][kRows];  // exp(m_w - M) of each warp
  // rank 0's: the (m, l, acc) of each CTA of the cluster, and their factors
  __shared__ float part_m[kCluster][kRows];
  __shared__ float part_l[kCluster][kRows];
  __shared__ float part_f[kCluster][kRows];
  __shared__ float total_l[kRows];
  auto part_acc = reinterpret_cast<float (*)[kRows][VD]>(stage + P::kStaged);
  // a warp's acc, once its chunks are done, in its own staging buffers
  auto wacc = [&](int w) {
    return reinterpret_cast<float (*)[VD]>(stage + w * P::kWarpBytes);
  };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // distributed shared memory may be written only once its CTA runs: arrive
  // now, and wait for every CTA's arrival before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.y / row_chunks;
  const int g0 = (blockIdx.y % row_chunks) * kRows;
  const int rows = min(kRows, groups - g0);
  const int64_t b = blockIdx.z;
  const int n = max(0, min(__ldg(cache_len), s));
  // the cluster's CTAs split [0, n) evenly, in whole chunks
  const int share = ((n + kCluster - 1) / kCluster + kChunk - 1) / kChunk *
                    kChunk;
  const int lo = min(rank * share, n);
  const int hi = min(lo + share, n);
  const int chunks = (hi - lo + kChunk - 1) / kChunk;
  const int mine = chunks > warp ? (chunks - warp + kWarps - 1) / kWarps : 0;

  const int64_t row_k = static_cast<int64_t>(num_kv) * HD;  // slot stride
  const int64_t row_v = static_cast<int64_t>(num_kv) * VD;
  const T* kbase = k + (b * s * num_kv + kvh) * HD;  // slot j: + j * row_k
  const T* vbase = v + (b * s * num_kv + kvh) * VD;
  unsigned char* my = stage + warp * P::kWarpBytes;

  // stage the warp's t-th chunk, K then V, in buffer t % kStages (K rows
  // past the valid slots are left as they are: their scores are masked)
  auto stage_chunk = [&](int t) {
    const int c0 = lo + (warp + t * kWarps) * kChunk;
    const int count = min(kChunk, hi - c0);
    unsigned char* kd = my + (t % kStages) * P::kStage;
    unsigned char* vd = kd + kChunk * P::kStrideK;
    // lane l copies 16-byte piece l % pieces of every (32 / pieces)-th row
    // (lanes past the last whole round of pieces copy nothing); the K
    // pieces past hd are zero-filled
    {
      constexpr int kStep = 32 / P::kPiecesK;
      const int j0 = lane / P::kPiecesK;
      const int p = lane % P::kPiecesK;
      const bool data = p < P::kDataK;
      const T* g = kbase + (c0 + j0) * row_k + (data ? p : 0) * kVec;
      unsigned char* d = kd + j0 * P::kStrideK + p * 16;
      for (int j = j0 < kStep ? j0 : kChunk; j < count; j += kStep) {
        cp_async16(d, g, data);
        g += kStep * row_k;
        d += kStep * P::kStrideK;
      }
    }
    // V rows past the valid slots are zero-filled: their P is 0, and 0
    // times a stale NaN would not be
    {
      constexpr int kStep = 32 / P::kPiecesV;
      const int j0 = lane / P::kPiecesV;
      const int p = lane % P::kPiecesV;
      const T* first = vbase + c0 * row_v + p * kVec;
      const T* g = first + j0 * row_v;
      unsigned char* d = vd + j0 * P::kStrideV + p * 16;
      for (int j = j0 < kStep ? j0 : kChunk; j < kChunk; j += kStep) {
        cp_async16(d, j < count ? g : first, j < count);
        g += kStep * row_v;
        d += kStep * P::kStrideV;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < mine) stage_chunk(t);
    cp_async_commit();
  }

  // the group's query heads: widened, scaled, rounded to T, widened (zero
  // past hd)
  for (int i = tid; i < kRows * (P::kHdK / kVec); i += blockDim.x) {
    const int r = i / (P::kHdK / kVec);
    const int d = (i % (P::kHdK / kVec)) * kVec;
    float buf[kVec];
    if (r < rows && d < HD) {
      const int64_t h = static_cast<int64_t>(kvh) * groups + g0 + r;
      Elem<T>::load(q + (b * num_heads + h) * HD + d, buf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = buf[e] * scale;
      qs[r * kQStride + d + e] = Elem<T>::widen(Elem<T>::narrow(x));
    }
  }
  __syncthreads();

  // the warp's chunks, folded into its (m, l, acc) in wm, wl, wacc
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    warp_chunks_tc<HD, VD, kWarps>(my, stage_chunk, lo, hi, mine, warp,
                                   lane, qs, wm[warp], wl[warp], wacc(warp));
  } else {
    warp_chunks_simt<T, HD, VD, kWarps>(my, stage_chunk, lo, hi, mine, warp,
                                        lane, qs, ps[warp], wm[warp],
                                        wl[warp], wacc(warp));
  }
  __syncthreads();
  // merge the warps' states into the CTA's, (m, l) per head first (each
  // warp's factor exp(m_w - M) computed once), and store it in rank 0's
  // part[rank] through distributed shared memory
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < kRows) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w][tid]);
    float ll = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][tid] - mm);
      wf[w][tid] = f;
      ll += wl[w][tid] * f;
    }
    *cluster.map_shared_rank(&part_m[rank][tid], 0) = mm;
    *cluster.map_shared_rank(&part_l[rank][tid], 0) = ll;
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * VD; idx += blockDim.x) {
    const int i = idx / VD;
    const int d = idx % VD;
    float aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) aa += wacc(w)[i][d] * wf[w][i];
    *cluster.map_shared_rank(&part_acc[rank][i][d], 0) = aa;
  }
  // the one cluster barrier: every part has landed in rank 0, and no CTA
  // reads another's shared memory after it
  cluster.sync();
  if (rank != 0) return;

  // rank 0 merges the cluster's parts, in rank order
  if (tid < kRows) {
    float mm = kNegInf;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) mm = fmaxf(mm, part_m[c][tid]);
    float ll = 0.0f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const float f = expf(part_m[c][tid] - mm);
      part_f[c][tid] = f;
      ll += part_l[c][tid] * f;
    }
    total_l[tid] = ll;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * VD; idx += blockDim.x) {
    const int i = idx / VD;
    const int d = idx % VD;
    float aa = 0.0f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) aa += part_acc[c][i][d] * part_f[c][i];
    const int64_t h = static_cast<int64_t>(kvh) * groups + g0 + i;
    out[(b * num_heads + h) * VD + d] =
        Elem<T>::narrow(attn::finish(aa, total_l[i]));
  }
}

template <typename T, int HD, int VD>
int launch(const void* q, const void* k, const void* v,
           const int32_t* cache_len, void* out, int batch, int s,
           int num_heads, int num_kv, float scale, cudaStream_t stream) {
  using P = Plan<T, HD, VD>;
  const int groups = num_heads / num_kv;
  const int row_chunks = (groups + kRows - 1) / kRows;
  auto kernel = decode_kernel<T, HD, VD>;
  // shared memory beyond 48 KB is granted per device, once
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  const dim3 grid(kCluster, num_kv * row_chunks, batch);
  kernel<<<grid, P::kWarps * 32, P::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, static_cast<T*>(out), s,
      num_heads, num_kv, groups, row_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* cache_len, void* out, int batch, int s,
             int num_heads, int num_kv, int hd, int vd, float scale,
             cudaStream_t stream) {
#define ATTN_CASE(H, V)                                                     \
  if (hd == H && vd == V)                                                   \
    return launch<T, H, V>(q, k, v, cache_len, out, batch, s, num_heads,    \
                           num_kv, scale, stream);
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 f32, 1 bf16.  One launch on `stream`; returns its CUDA error (0
// on success).  The wrapper has checked every shape.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* cache_len,
                                    void* out, int batch, int s,
                                    int num_heads, int num_kv, int hd, int vd,
                                    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(cache_len);
  if (dtype == 0)
    return dispatch<float>(q, k, v, len, out, batch, s, num_heads, num_kv,
                           hd, vd, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, len, out, batch, s, num_heads,
                                   num_kv, hd, vd, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
