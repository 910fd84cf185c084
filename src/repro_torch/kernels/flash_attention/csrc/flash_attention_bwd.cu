// Flash attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's forward with respect to q, k and v, recomputed from
// the forward's residuals (its f32 output O and each row's log-sum-exp).
//
//   delta_i = sum_c dO[i, c] O[i, c]
//   P_ij    = exp(s_ij - lse_i),  s_ij = (scale q_i) . k_j, -1e30 if masked
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
//   flattened (position, group head) space, as the forward's f32 kernel),
//   looping over the kv tiles its rows may see, 32 keys a tile, one per
//   lane.  It first computes delta for its rows and stores it (B, H, Sq)
//   for the second pass.
// - dk/dv pass: one block per (batch, KV head, tile of 32 keys), looping
//   over every query row of the group that may attend to its keys, 32 rows
//   a step, one per lane.
// Both skip the kv tiles or query rows that every pair of the block masks
// (past the causal diagonal, outside the window); a masked pair inside a
// kept tile gets P = exp(-1e30 - lse) = 0, as in the reference.
//
// Bound: operations.  The gradient needs 2 (3 hd + 2 vd) flops per allowed
// (query, key) pair and head (q.k, dO.v, dq, dk and dv); the two passes
// recompute q.k and dO.v once more each.  At Qwen2-0.5B's training shape
// (B = 4, S = 2048 causal, 14 heads) that is 75.2 GFLOP, 76 us at the
// card's bf16 tensor-core rate.
//
// This first design is simple and exact rather than fast: SIMT in f32 for
// both entries (bf16 inputs are widened exactly as they are staged), so
// the bf16 entry computes what the reference computes in f32 and rounds
// only the three gradients.  Each operand tile is staged transposed in
// shared memory (rows padded to 33 floats, free of bank conflicts both
// when a lane reads its own column and when it walks a row): a lane owns a
// key (dq pass) or a query row (dk/dv pass) for the two dot products, and
// an output column for the accumulation, reading the 32 P or dS values of
// its warp's rows or keys as broadcasts.  Tensor cores (mma.sync, then
// wgmma with TMA) are the later redesign.
//
// hd and vd are template parameters: the pairs of ATTN_FOR_EACH_DIMS, each
// a multiple of 4 (the float4 reads of staged rows).  A lane owns columns
// lane, lane + 32, ... of dq, dk and dv, (dim + 31) / 32 of them, each loop
// bounded by the dim: at hd 112 four columns (the last for lanes 0-15), at
// hd 24 or vd 16 one, some lanes idle.  Shared memory at (112, 112): 95 KB
// for the dq pass, 65 KB for the dk/dv pass, both above the 48 KB default
// and opted in at launch.

#include "../../attention_common.cuh"

namespace {

using attn::Elem;
using attn::kNegInf;

constexpr int kStride = 33;  // a transposed tile row: 32 entries + 1 pad

// whether the query at `pos` may attend to `key` (the forward's masks)
__device__ __forceinline__ bool allowed(int key, int pos, int skv, int causal,
                                        int window) {
  return key < skv && (!causal || key <= pos) &&
         (window <= 0 || pos - key < window);
}

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

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int skv, int num_heads,
                    int num_kv, int groups, int causal, int window,
                    float scale) {
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
  const int pos_lo = static_cast<int>(f0 / groups);
  const int pos_hi = static_cast<int>((f_end - 1) / groups);

  // the warp's rows: q (widened, scaled), dO, lse and delta = rowsum(dO O)
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
      qs[r * HD + c] = valid ? Elem<T>::widen(q[row * HD + c]) * scale : 0.0f;
    }
    float dot = 0.0f;
    for (int c = lane; c < VD; c += 32) {
      const float d = valid ? dout[row * VD + c] : 0.0f;
      dos[r * VD + c] = d;
      dot += valid ? d * out[row * VD + c] : 0.0f;
    }
    dot = attn::warp_sum(dot);
    row_pos[i] = static_cast<int>(pos);
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
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
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
              ? Elem<T>::widen(k[((b * skv + t0 + j) * num_kv + kvh) * HD + d])
              : 0.0f;
    }
    for (int i = tid; i < kKeys * VD; i += blockDim.x) {
      const int j = i / VD, d = i % VD;
      vt[d * kStride + j] =
          t0 + j < skv
              ? Elem<T>::widen(v[((b * skv + t0 + j) * num_kv + kvh) * VD + d])
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
          allowed(key, row_pos[i], skv, causal, window) ? s[i] : kNegInf;
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
    T* dst = dq + ((b * sq + pos) * num_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < kColsQ; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dst[d] = Elem<T>::narrow(scale * acc[i][c]);
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

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int skv, int num_heads,
                     int num_kv, int groups, int causal, int window,
                     float scale) {
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
    ks[i] = k0 + j < skv ? Elem<T>::widen(k[key * HD + d]) : 0.0f;
  }
  for (int i = tid; i < kKeys * VD; i += blockDim.x) {
    const int j = i / VD, d = i % VD;
    const int64_t key = (b * skv + k0 + j) * num_kv + kvh;
    vs[i] = k0 + j < skv ? Elem<T>::widen(v[key * VD + d]) : 0.0f;
  }

  float acc_k[W][kColsK], acc_v[W][kColsV];
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
#pragma unroll
    for (int c = 0; c < kColsK; ++c) acc_k[kk][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsV; ++c) acc_v[kk][c] = 0.0f;
  }

  // the query rows some key of the block may be attended by
  const int64_t rows_total = static_cast<int64_t>(sq) * groups;
  const int64_t f_lo = causal ? static_cast<int64_t>(k0) * groups : 0;
  const int64_t f_win = (static_cast<int64_t>(k_last) + window) * groups;
  const int64_t f_hi =
      window > 0 && f_win < rows_total ? f_win : rows_total;
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
        x = Elem<T>::widen(q[((b * sq + pos) * num_heads + h) * HD + d]) *
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
        (f_row < rows_total ? f_row : rows_total - 1) / groups);
    const float row_lse = lse_s[lane], row_delta = delta_s[lane];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      const int key = k0 + warp * W + kk;
      const float sk =
          allowed(key, pos, skv, causal, window) ? s[kk] : kNegInf;
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
      if (d < HD) dk[row * HD + d] = Elem<T>::narrow(acc_k[kk][c]);
    }
#pragma unroll
    for (int c = 0; c < kColsV; ++c) {
      const int d = lane + 32 * c;
      if (d < VD) dv[row * VD + d] = Elem<T>::narrow(acc_v[kk][c]);
    }
  }
}

}  // namespace dkv_pass

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int HD, int VD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int batch, int sq, int skv, int num_heads, int num_kv,
           int causal, int window, float scale, cudaStream_t stream) {
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);

  constexpr size_t smem_dq = dq_pass::smem_bytes<HD, VD>();
  auto dq_kernel = dq_pass::flash_bwd_dq_kernel<T, HD, VD>;
  int err = allow_smem(dq_kernel, smem_dq);
  if (err) return err;
  const dim3 grid_dq(
      static_cast<unsigned>((rows + dq_pass::kRows - 1) / dq_pass::kRows),
      num_kv, batch);
  dq_kernel<<<grid_dq, dq_pass::kWarps * 32, smem_dq, stream>>>(
      qp, kp, vp, static_cast<const float*>(out), dop, lp, dlp,
      static_cast<T*>(dq), sq, skv, num_heads, num_kv, groups, causal, window,
      scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  constexpr size_t smem_dkv = dkv_pass::smem_bytes<HD, VD>();
  auto dkv_kernel = dkv_pass::flash_bwd_dkv_kernel<T, HD, VD>;
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err) return err;
  const dim3 grid_dkv(
      static_cast<unsigned>((skv + dkv_pass::kKeys - 1) / dkv_pass::kKeys),
      num_kv, batch);
  dkv_kernel<<<grid_dkv, dkv_pass::kWarps * 32, smem_dkv, stream>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      skv, num_heads, num_kv, groups, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16 (q, k, v, dq, dk, dv); out, dout (B, Sq, H, vd),
// lse and the scratch delta (B, H, Sq) are f32.  window <= 0: no window.
// Launches the dq pass, then the dk/dv pass, on `stream`; returns the CUDA
// error of the launches (0 on success).  The wrapper has checked every
// shape.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int batch, int sq, int skv, int num_heads,
                                   int num_kv, int hd, int vd, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_CASE(H, V)                                                      \
  if (hd == H && vd == V) {                                                  \
    if (dtype == 0)                                                          \
      return launch<float, H, V>(q, k, v, out, dout, lse, delta, dq, dk, dv, \
                                 batch, sq, skv, num_heads, num_kv, causal,  \
                                 window, scale, s);                          \
    if (dtype == 1)                                                          \
      return launch<__nv_bfloat16, H, V>(q, k, v, out, dout, lse, delta, dq, \
                                         dk, dv, batch, sq, skv, num_heads,  \
                                         num_kv, causal, window, scale, s);  \
  }
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
