// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, GQA groups, f32 accumulation (flash-decoding).
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
// head and dim, far below the card's flop/byte ratio.  So the cache has to
// stream through many SMs at once: with one block per (b, KV head) a
// Qwen2 step would use 16 of the 132 SMs.
//
// Design, simple and right first:
// - Split-S: block (split, KV head x row chunk, b) takes a range of
//   split_len cache slots, chosen by the wrapper so that about four blocks
//   per SM are in flight; its slots past n are skipped (a split wholly
//   past n does no loads).  Its 4 warps take 32 slots at a time, one per
//   lane: a lane loads its slot's key with 16-byte loads, computes the
//   scores of the (up to 8) query heads of the group from shared memory,
//   and the warp runs the reference's online-softmax update (m, l, acc)
//   with shuffles; each lane accumulates its own value columns.
// - The warps' states merge in shared memory, and the splits' in a small
//   second kernel: M = max m, L = sum l exp(m - M), A = sum acc exp(m - M),
//   out = L > 0 ? A / max(L, 1e-30) : 0.  A part with no slot holds
//   (-1e30, 0, 0) and adds nothing; with one split the first kernel writes
//   the output itself.
// - A group wider than 8 heads takes several row chunks, each reading the
//   cache again (MQA with G = 16: twice); the Qwen2 group (G = 7) is one.
// - Templated on the dtype and on hd, vd in {16, 32, 64, 128}.

#include "../../attention_common.cuh"

namespace {

using attn::Elem;
using attn::kNegInf;

constexpr int kWarps = 4;
constexpr int kRows = 8;  // query heads of a group per block

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ cache_len,
                    T* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int s, int num_heads, int num_kv, int groups,
                    int row_chunks, int split_len, int num_splits,
                    float scale) {
  constexpr int kVec = Elem<T>::kPerVec;
  constexpr int kCols = (VD + 31) / 32;
  __shared__ __align__(16) float qs[kRows * HD];
  __shared__ float ps[kWarps][kRows][32];
  __shared__ float wm[kWarps][kRows];
  __shared__ float wl[kWarps][kRows];
  __shared__ float wacc[kWarps][kRows][VD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / row_chunks;
  const int g0 = (blockIdx.y % row_chunks) * kRows;
  const int rows = min(kRows, groups - g0);
  const int64_t b = blockIdx.z;
  const int n = max(0, min(__ldg(cache_len), s));
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n);

  // the group's query heads: widened, scaled, rounded to T, widened
  for (int i = tid; i < kRows * (HD / kVec); i += blockDim.x) {
    const int r = i / (HD / kVec);
    const int d = (i % (HD / kVec)) * kVec;
    float buf[kVec];
    if (r < rows) {
      const int64_t h = static_cast<int64_t>(kvh) * groups + g0 + r;
      Elem<T>::load(q + (b * num_heads + h) * HD + d, buf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = buf[e] * scale;
      qs[r * HD + d + e] = Elem<T>::widen(Elem<T>::narrow(x));
    }
  }
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int c0 = lo + warp * 32; c0 < hi; c0 += kWarps * 32) {
    const int slot = c0 + lane;
    const bool ok = slot < hi;
    float sc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) sc[i] = 0.0f;
    if (ok) {
      const T* kp = k + ((b * s + slot) * num_kv + kvh) * HD;
#pragma unroll 2
      for (int d = 0; d < HD; d += kVec) {
        float kf[kVec];
        Elem<T>::load(kp + d, kf);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            sc[i] = fmaf(qs[i * HD + d + e], kf[e], sc[i]);
        }
      }
    }
    // lane 0's slot is valid, so every row sees a valid score here
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float si = ok ? sc[i] : kNegInf;
      const float m_new = fmaxf(m[i], attn::warp_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + attn::warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      ps[warp][i][lane] = p;
    }
    __syncwarp();
    const int count = min(32, hi - c0);
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const T* vp = v + ((b * s + c0 + j) * num_kv + kvh) * VD;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        const float vv = d < VD ? Elem<T>::widen(vp[d]) : 0.0f;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][c] = fmaf(ps[warp][i][j], vv, acc[i][c]);
      }
    }
    __syncwarp();
  }

  // merge the warps' states
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (lane == 0) {
      wm[warp][i] = m[i];
      wl[warp][i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < VD) wacc[warp][i][d] = acc[i][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * VD; idx += blockDim.x) {
    const int i = idx / VD;
    const int d = idx % VD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w][i]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][i] - mm);
      ll += wl[w][i] * f;
      aa += wacc[w][i][d] * f;
    }
    const int64_t h = static_cast<int64_t>(kvh) * groups + g0 + i;
    if (num_splits == 1) {
      out[(b * num_heads + h) * VD + d] =
          Elem<T>::narrow(attn::finish(aa, ll));
    } else {
      const int64_t o = (b * num_heads + h) * num_splits + split;
      part_acc[o * VD + d] = aa;
      if (d == 0) {
        part_m[o] = mm;
        part_l[o] = ll;
      }
    }
  }
}

// merge the splits of one (b, head): grid (H, B)
template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      T* __restrict__ out, int num_heads, int vd,
                      int num_splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * num_heads +
                      blockIdx.x;
  const int64_t base = row * num_splits;
  float mm = kNegInf;
  for (int p = 0; p < num_splits; ++p) mm = fmaxf(mm, part_m[base + p]);
  for (int d = threadIdx.x; d < vd; d += blockDim.x) {
    float ll = 0.0f, aa = 0.0f;
    for (int p = 0; p < num_splits; ++p) {
      const float f = expf(part_m[base + p] - mm);
      ll += part_l[base + p] * f;
      aa += part_acc[(base + p) * vd + d] * f;
    }
    out[row * vd + d] = Elem<T>::narrow(attn::finish(aa, ll));
  }
}

template <typename T, int HD, int VD>
int launch(const void* q, const void* k, const void* v,
           const int32_t* cache_len, void* out, float* part_m, float* part_l,
           float* part_acc, int batch, int s, int num_heads, int num_kv,
           int split_len, int num_splits, float scale, cudaStream_t stream) {
  const int groups = num_heads / num_kv;
  const int row_chunks = (groups + kRows - 1) / kRows;
  const dim3 grid(num_splits, num_kv * row_chunks, batch);
  decode_split_kernel<T, HD, VD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, static_cast<T*>(out), part_m,
      part_l, part_acc, s, num_heads, num_kv, groups, row_chunks, split_len,
      num_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(num_heads, batch), 128, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), num_heads, VD,
      num_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* cache_len, void* out, float* part_m,
             float* part_l, float* part_acc, int batch, int s, int num_heads,
             int num_kv, int hd, int vd, int split_len, int num_splits,
             float scale, cudaStream_t stream) {
#define ATTN_CASE(H, V)                                                     \
  if (hd == H && vd == V)                                                   \
    return launch<T, H, V>(q, k, v, cache_len, out, part_m, part_l,         \
                           part_acc, batch, s, num_heads, num_kv, split_len, \
                           num_splits, scale, stream);
  ATTN_FOR_EACH_DIMS(ATTN_CASE)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 f32, 1 bf16.  part_m, part_l: f32 [B, H, num_splits]; part_acc:
// f32 [B, H, num_splits, vd] (unused with one split).  Returns the CUDA
// error of the launches (0 on success); the wrapper has checked every
// shape.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* cache_len,
                                    void* out, void* part_m, void* part_l,
                                    void* part_acc, int batch, int s,
                                    int num_heads, int num_kv, int hd, int vd,
                                    int split_len, int num_splits,
                                    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch<float>(q, k, v, len, out, pm, pl, pa, batch, s,
                           num_heads, num_kv, hd, vd, split_len, num_splits,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, len, out, pm, pl, pa, batch, s,
                                   num_heads, num_kv, hd, vd, split_len,
                                   num_splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
