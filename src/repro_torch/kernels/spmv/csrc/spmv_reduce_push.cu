// Min/max push for Hopper (sm_90a): one warp per destination row of a CSR
// matrix.
//
//   out[v] = ⊕ over e in [ro[v], ro[v+1]) with keep(e) of values[src[e]] ⊗ w[e]
//
// with ⊕ ∈ {min, max} and ⊗ ∈ {+, ×, min}; a row with no kept edge gets ⊕'s
// identity (+inf / -inf for f32, INT32_MAX / INT32_MIN for i32), as XLA's
// segment_min / segment_max give an empty segment.
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_reduce_push, the TPU
// kernel that carries every push of the traversal workloads: SSSP
// (min_plus, f32), widest path (max_times, f32) and connected components
// (min_min, i32).  The TPU version has no scatter, so it runs a
// Hillis-Steele scan over the `rank` stream and scatters each run's result
// through a one-hot MXU matmul, with +/-inf flags and hi/lo 16-bit halves to
// keep that matmul exact.  On Hopper the destination-sorted stream with its
// row offsets is a CSR matrix: each row reads its own edge range and reduces
// it in registers, so none of those encodings is needed and `rank` is not
// read.  The gather values[src[e]] and the ⊗ are fused in.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + 4 [+ 1 with a mask]) + 4 * (N + 1) + 4 * N
//   + 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once) for two
// operations per edge, far below the card's operation/byte ratio.
//
// Design, as spmv_push.cu: one warp per row with a grid-stride loop over
// rows; the lanes stride over the row's edges and reduce in registers, then
// across the warp (shuffles for f32, __reduce_min/max_sync for i32).  There
// are no atomics, so every run gives the same bits.  A hub row stays on a
// single warp: splitting hub rows is later work, for both kernels.
//
// Bitwise rules, held against the plain PyTorch version (scatter_reduce):
// - f32 min/max propagate NaN, as scatter_reduce "amin"/"amax" and XLA do
//   (fminf/fmaxf would drop it); ⊗ = min propagates NaN as torch.minimum.
// - Build without --use_fast_math and without -ftz=true: max_times widths
//   are products of reliabilities in (0, 1] and reach denormals on long
//   paths, which the CPU keeps.
// - +inf + length stays +inf (IEEE addition, no special case needed).
// - -0 and +0 compare equal, so a row holding both may return either; the
//   semirings' inputs are non-negative.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond this
constexpr unsigned kFullMask = 0xffffffffu;

enum class Add { kMin, kMax };
enum class Mul { kPlus, kTimes, kMin };

template <typename T, Add A>
__device__ __forceinline__ T identity() {
  if constexpr (std::is_same<T, float>::value) {
    return A == Add::kMin ? INFINITY : -INFINITY;
  } else {
    return A == Add::kMin ? INT32_MAX : INT32_MIN;
  }
}

// min (less = true) or max of a and b; a NaN operand wins
template <bool kLess, typename T>
__device__ __forceinline__ T pick(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
  }
  return (kLess ? a < b : a > b) ? a : b;
}

template <typename T, Mul M>
__device__ __forceinline__ T combine(T x, T w) {
  if constexpr (M == Mul::kPlus) {
    return x + w;
  } else if constexpr (M == Mul::kTimes) {
    return x * w;
  } else {
    return pick<true>(x, w);
  }
}

template <typename T, Add A>
__device__ __forceinline__ T warp_reduce(T acc) {
  if constexpr (std::is_same<T, int32_t>::value) {
    return A == Add::kMin ? __reduce_min_sync(kFullMask, acc)
                          : __reduce_max_sync(kFullMask, acc);
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = pick<A == Add::kMin>(acc, __shfl_down_sync(kFullMask, acc, off));
    }
    return acc;  // lane 0 holds the row's result
  }
}

template <typename T, Add A, Mul M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_reduce_push_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ src,
                        const T* __restrict__ w,
                        const int32_t* __restrict__ row_offsets,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ out,
                        int32_t num_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // `row` is uniform across the warp, so every lane reaches the shuffles
  for (int64_t row = first; row < num_rows; row += stride) {
    const int32_t lo = __ldg(row_offsets + row);
    const int32_t hi = __ldg(row_offsets + row + 1);
    T acc = identity<T, A>();
    for (int32_t e = lo + lane; e < hi; e += 32) {
      if (mask == nullptr || __ldg(mask + e)) {
        acc = pick<A == Add::kMin>(
            acc, combine<T, M>(__ldg(values + __ldg(src + e)), __ldg(w + e)));
      }
    }
    acc = warp_reduce<T, A>(acc);
    if (lane == 0) out[row] = acc;
  }
}

template <typename T, Add A, Mul M>
int launch(const void* values, const void* src, const void* w,
           const void* row_offsets, const void* mask, void* out, int num_rows,
           void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (static_cast<int64_t>(num_rows) + kWarpsPerBlock - 1) /
                   kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  spmv_reduce_push_kernel<T, A, M>
      <<<static_cast<int>(blocks), kWarpsPerBlock * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(values), static_cast<const int32_t*>(src),
          static_cast<const T*>(w), static_cast<const int32_t*>(row_offsets),
          static_cast<const uint8_t*>(mask), static_cast<T*>(out), num_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per semiring the port registers.  Each launches on `stream` and
// returns cudaGetLastError() (0 on success).  `mask` may be null.  Pointers
// are device pointers; `values`, `w` and `out` share the semiring's dtype.
#define SPMV_REDUCE_ENTRY(name, T, A, M)                                     \
  extern "C" int name(const void* values, const void* src, const void* w,   \
                      const void* row_offsets, const void* mask, void* out, \
                      int num_rows, void* stream) {                         \
    return launch<T, A, M>(values, src, w, row_offsets, mask, out,          \
                           num_rows, stream);                               \
  }

SPMV_REDUCE_ENTRY(spmv_reduce_push_min_plus_f32, float, Add::kMin, Mul::kPlus)
SPMV_REDUCE_ENTRY(spmv_reduce_push_max_times_f32, float, Add::kMax,
                  Mul::kTimes)
SPMV_REDUCE_ENTRY(spmv_reduce_push_min_min_i32, int32_t, Add::kMin, Mul::kMin)
