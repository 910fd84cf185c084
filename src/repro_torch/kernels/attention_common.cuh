// Helpers shared by the attention kernels (flash_attention/csrc and
// decode_attention/csrc): 16-byte loads widened to f32, the cast back with
// round-to-nearest-even, warp reductions, cp.async copies into shared
// memory, the tensor-core pieces (ldmatrix, mma.sync, the split of an f32
// pair into bf16 terms), exp2 and the reference's finite mask value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

// Masked scores take this finite value, as in the reference
// (repro/models/layers.py and both Pallas kernels): a row that has seen
// no valid key yet adds exp(0) per masked slot, and the first valid key
// washes that out through exp(-1e30 - m) = 0.  -inf would make such rows
// NaN instead.
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerVec = 4;  // elements per 16-byte load
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  __device__ __forceinline__ static float widen(float x) { return x; }
  __device__ __forceinline__ static float narrow(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared with cp.async, zero-filled where !valid.  The
// copies of a thread land once cp_async_wait<k> leaves at most k of its
// groups pending; other threads see them after a barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 bytes global -> shared with cp.async, zero-filled where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---- tensor cores: mma.sync.m16n8k16, bf16 operands, f32 accumulators ----
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t holds rows g
// and g + 8 of A and of the accumulators, columns 2 t and 2 t + 1 of each
// 8-wide accumulator tile.

// four 8 x 8 b16 matrices from shared memory, each lane giving one row
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pair nearest (x, y), as the bits of a __nv_bfloat162; (x, y)
// keep what it leaves, exact in f32
__device__ __forceinline__ uint32_t take_bf16x2(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  x -= hf.x;
  y -= hf.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as two bf16 pairs: hi = bf16(x, y), lo = bf16((x, y) - hi), so
// hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  hi = take_bf16x2(x, y);
  lo = take_bf16x2(x, y);
}

// 2^x, a result below the smallest normal flushed to 0 (a p or corr that
// small adds nothing an f32 sum of at least one term 1 keeps)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The reference's finish: acc / max(l, 1e-30) where some key was seen,
// else 0 (an IEEE division, as XLA's)
__device__ __forceinline__ float finish(float acc, float l) {
  return l > 0.0f ? acc / fmaxf(l, 1e-30f) : 0.0f;
}

// The reference's saved log-sum-exp of a row with running max m and sum
// l: m + log(max(l, 1e-30)) where some key was seen, else +inf
// (repro/models/layers.py::_make_flash)
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.0f ? m + logf(fmaxf(l, 1e-30f)) : __int_as_float(0x7f800000);
}

// blocked_attention's dynamic offsets, read on the device from int32[3]
// (q_offset, kv_offset, kv_valid_len), so that no launch waits on a host
// read: query row i sits at q_offset + i, key j at kv_offset + j, the
// causal and window masks compare those positions, and keys at kv_offset +
// j >= kv_valid_len are masked, as are the keys j >= Skv past the inputs.
// A kernel works in the keys' local coordinates: each query position is
// shifted by q_offset - kv_offset, and keys j >= lim = clamp(kv_valid_len
// - kv_offset, 0, Skv) are masked.  The shift is clamped to +-2^29: with
// Sq, Skv and the window below 2^28 (the wrapper's limits) that moves no
// mask, and every position stays far from int overflow.
struct Offsets {
  int shift;
  int lim;
};

__device__ __forceinline__ Offsets read_offsets(const int* dyn, int skv) {
  const long long q = __ldg(dyn), kv = __ldg(dyn + 1), valid = __ldg(dyn + 2);
  const long long bound = 1ll << 29;
  const long long shift = q - kv < -bound ? -bound : q - kv > bound ? bound
                                                                    : q - kv;
  const long long lim = valid - kv < 0 ? 0 : valid - kv > skv ? skv
                                                             : valid - kv;
  return {static_cast<int>(shift), static_cast<int>(lim)};
}

// Whether a query at (shifted) position `pos` may attend to some key j <
// lim.  Under dynamic offsets a row may see none; such a row outputs 0 with
// lse = +inf (the kernels clear its l), where the reference's scan outputs
// the mean of every value it walked, the padding's zeros among them.
__device__ __forceinline__ bool sees_a_key(int pos, int lim, int causal,
                                           int window) {
  const int hi = causal ? min(lim, pos + 1) : lim;
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  return lo < hi;
}

}  // namespace attn

// The (head dim, value head dim) pairs the attention kernels (flash
// forward and backward, decode) are built for: every pair of {16, 32, 64,
// 128}, and the model families' own (hybrid: Zamba2-7B's 112, 112; MLA:
// qk_nope + qk_rope and v_head, MiniCPM3-4B's 96, 64 and its smoke
// config's 24, 16).  A list of pairs, not their cross product, keeps the
// builds short.
#define ATTN_FOR_EACH_DIMS(X) \
  X(16, 16) X(16, 32) X(16, 64) X(16, 128) \
  X(32, 16) X(32, 32) X(32, 64) X(32, 128) \
  X(64, 16) X(64, 32) X(64, 64) X(64, 128) \
  X(128, 16) X(128, 32) X(128, 64) X(128, 128) \
  X(24, 16) X(96, 64) X(112, 112)
