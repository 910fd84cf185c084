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
// far above the card's flop/byte ratio.  This first kernel computes on the
// CUDA cores in f32, as the reference does (it widens q, k, v to f32
// before both products), so it is held against the f32 peak in practice;
// tensor-core tiles (mma.sync / wgmma with TMA) are later work.
//
// Design, simple and right first:
// - A block serves one (batch, KV head) and 64 consecutive query rows of
//   the flattened (position, group head) space, so the G query heads of a
//   group share each K/V tile, staged once in shared memory (that one
//   K/V read per group is the point of GQA).  Any G works: a block's rows
//   may span several positions or part of one position's group.
// - 8 warps of 8 rows each.  A kv tile holds 32 keys, one per lane: each
//   lane computes its key's score for the warp's 8 rows (K transposed in
//   shared memory, padded against bank conflicts; q rows broadcast), the
//   warp reduces max and sum with shuffles, writes the 8 x 32
//   probabilities to shared memory, and each lane accumulates its own
//   value columns (vd / 32 of them).
// - Online softmax exactly as the reference orders it: m_new = max(m,
//   max s), p = exp(s - m_new), corr = exp(m - m_new), l = l corr + sum p,
//   acc = acc corr + p v; out = l > 0 ? acc / max(l, 1e-30) : 0.  Masked
//   scores are -1e30 (not -inf).
// - kv tiles that every row of the block masks (past the causal diagonal,
//   or before every row's window) are skipped.  Skipping leaves the result
//   as it was: a masked tile after a valid key changes nothing, and the
//   exp(0) terms a masked tile adds before the first valid key are washed
//   out by exp(-1e30 - m) = 0.
// - Templated on the dtype and on hd, vd in {16, 32, 64, 128}.

#include "../../attention_common.cuh"

namespace {

using attn::Elem;
using attn::kNegInf;

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

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int num_heads, int num_kv, int groups, int causal,
                 int window, float scale) {
  constexpr int kVec = Elem<T>::kPerVec;
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
  const int pos_lo = static_cast<int>(f0 / groups);
  const int pos_hi = static_cast<int>((f_end - 1) / groups);

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
      Elem<T>::load(q + ((b * sq + pos) * num_heads + h) * HD + d, buf);
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
    row_pos[i] = static_cast<int>(f / groups);
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // the kv tiles some row of the block may attend to
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
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
        Elem<T>::load(k + ((b * skv + t0 + j) * num_kv + kvh) * HD + d, buf);
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
        Elem<T>::load(v + ((b * skv + t0 + j) * num_kv + kvh) * VD + d, buf);
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
      const bool ok = key < skv && (!causal || key <= pos) &&
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
    const int64_t pos = f / groups;
    const int64_t h = static_cast<int64_t>(kvh) * groups + f % groups;
    T* dst = out + ((b * sq + pos) * num_heads + h) * VD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < VD) dst[d] = Elem<T>::narrow(attn::finish(acc[i][c], l[i]));
    }
  }
}

template <typename T, int HD, int VD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int num_heads, int num_kv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, VD>();
  auto kernel = flash_fwd_kernel<T, HD, VD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = num_heads / num_kv;
  const int64_t rows = static_cast<int64_t>(sq) * groups;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), num_kv,
                  batch);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, num_heads,
      num_kv, groups, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int skv, int num_heads, int num_kv, int hd,
             int vd, int causal, int window, float scale,
             cudaStream_t stream) {
#define ATTN_CASE(H, V)                                                   \
  if (hd == H && vd == V)                                                 \
    return launch<T, H, V>(q, k, v, out, batch, sq, skv, num_heads, num_kv, \
                           causal, window, scale, stream);
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 f32, 1 bf16.  window <= 0: no window.  Returns the CUDA error of
// the launch (0 on success); the wrapper has checked every shape.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int sq, int skv, int num_heads, int num_kv,
                                   int hd, int vd, int causal, int window,
                                   float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, batch, sq, skv, num_heads, num_kv,
                           hd, vd, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, sq, skv, num_heads,
                                   num_kv, hd, vd, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
