// Min/max push for Hopper (sm_90a): one warp per destination row of a CSR
// matrix, for one value vector or a batch of B of them.
//
//   out[b, v] = ⊕ over e in [ro[v], ro[v+1]) with keep(e) of
//               values[b, src[e]] ⊗ w[e]
//
// with ⊕ ∈ {min, max} and ⊗ ∈ {+, ×, min}; a row with no kept edge gets ⊕'s
// identity (+inf / -inf for f32, INT32_MAX / INT32_MIN for i32), as XLA's
// segment_min / segment_max give an empty segment.
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_reduce_push, the TPU
// kernel that carries every push of the traversal workloads: SSSP
// (min_plus, f32), widest path (max_times, f32) and connected components
// (min_min, i32), and ::spmv_reduce_push_batched, its B-query form that
// carries every push of their serving waves.  The TPU version has no
// scatter, so it runs a Hillis-Steele scan over the `rank` stream and
// scatters each run's result through a one-hot MXU matmul, with +/-inf flags
// and hi/lo 16-bit halves to keep that matmul exact (and shrinks its chunk to
// fit B rows in VMEM, batched_reduce_chunk, which Hopper does not need).  On
// Hopper the destination-sorted stream with its row offsets is a CSR matrix:
// each row reads its own edge range and reduces it in registers, so none of
// those encodings is needed and `rank` is not read.  The gather
// values[b, src[e]] and the ⊗ are fused in.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + 4 [+ 1 with a mask]) + 4 * (N + 1)
//   + B * 4 * N + B * 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once) for two
// operations per edge and batch row, far below the card's operation/byte
// ratio.
//
// Design: one warp per (destination row, batch row) with a grid-stride
// loop over rows, block x serving batch row x % B so a hub row's B warps
// start together, and a software-pipelined edge loop.  The
// lanes reduce in registers, then across the warp (shuffles for f32,
// __reduce_min/max_sync for i32).  There are no atomics, so every run gives
// the same bits, and a single-vector push is the B = 1 launch of the same
// entry, so each batch row is bitwise equal to it.  A hub row stays on a
// single warp: splitting hub rows, as spmv_push.cu's merge path does for
// the sum, is later work.
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
constexpr int kMaxBlocks = 132 * 32;  // per batch row; grid-stride beyond this
constexpr int kMaxBatch = 65535;      // keeps kMaxBlocks * batch in gridDim.x
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

// kMasked: whether `mask` is given, as in spmv_push.cu
template <typename T, Add A, Mul M, bool kMasked>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_reduce_push_kernel(const T* __restrict__ values,
                        int64_t values_stride,
                        const int32_t* __restrict__ src,
                        const T* __restrict__ w,
                        const int32_t* __restrict__ row_offsets,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ out,
                        int32_t num_rows,
                        int32_t batch) {
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x % batch;
  values += b * values_stride;
  out += b * num_rows;
  const int64_t first = static_cast<int64_t>(blockIdx.x / batch) *
                            kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride =
      static_cast<int64_t>(gridDim.x / batch) * kWarpsPerBlock;
  // `row` is uniform across the warp, so every lane reaches the shuffles
  for (int64_t row = first; row < num_rows; row += stride) {
    const int32_t lo = __ldg(row_offsets + row);
    const int32_t hi = __ldg(row_offsets + row + 1);
    T acc = identity<T, A>();
    int32_t e = lo + lane;
    int32_t s = 0;
    T we = T();
    bool keep = false;
    if (e < hi) {
      keep = !kMasked || __ldg(mask + e);
      if (keep) {
        s = __ldg(src + e);
        we = __ldg(w + e);
      }
    }
    // software-pipelined as in spmv_push.cu: the next edge's src, w and
    // mask load while this edge's value is gathered
    while (e < hi) {
      const int32_t next = e + 32;
      int32_t s_next = 0;
      T w_next = T();
      bool keep_next = false;
      if (next < hi) {
        keep_next = !kMasked || __ldg(mask + next);
        if (keep_next) {  // a masked edge costs its mask byte only
          s_next = __ldg(src + next);
          w_next = __ldg(w + next);
        }
      }
      if (keep) {
        acc = pick<A == Add::kMin>(acc,
                                   combine<T, M>(__ldg(values + s), we));
      }
      e = next;
      s = s_next;
      we = w_next;
      keep = keep_next;
    }
    acc = warp_reduce<T, A>(acc);
    if (lane == 0) out[row] = acc;
  }
}

template <typename T, Add A, Mul M>
int launch(const void* values, int64_t values_stride, const void* src,
           const void* w, const void* row_offsets, const void* mask,
           void* out, int num_rows, int batch, void* stream) {
  if (num_rows <= 0 || batch <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int64_t blocks = (static_cast<int64_t>(num_rows) + kWarpsPerBlock - 1) /
                   kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto kernel = mask == nullptr ? spmv_reduce_push_kernel<T, A, M, false>
                                : spmv_reduce_push_kernel<T, A, M, true>;
  kernel<<<static_cast<unsigned>(blocks * batch), kWarpsPerBlock * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(values), values_stride,
          static_cast<const int32_t*>(src), static_cast<const T*>(w),
          static_cast<const int32_t*>(row_offsets),
          static_cast<const uint8_t*>(mask), static_cast<T*>(out), num_rows,
          batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per semiring the port registers, spmv_reduce_push_batched_<name>:
// `batch` row-major value rows [batch, n_src] -> out [batch, num_rows]; one
// value vector is the batch of one.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).  `mask` may be null.  Pointers are
// device pointers; `values`, `w` and `out` share the semiring's dtype.
#define SPMV_REDUCE_ENTRY(name, T, A, M)                                     \
  extern "C" int spmv_reduce_push_batched_##name(                           \
      const void* values, const void* src, const void* w,                   \
      const void* row_offsets, const void* mask, void* out, int num_rows,   \
      int batch, int64_t n_src, void* stream) {                             \
    return launch<T, A, M>(values, n_src, src, w, row_offsets, mask, out,   \
                           num_rows, batch, stream);                        \
  }

SPMV_REDUCE_ENTRY(min_plus_f32, float, Add::kMin, Mul::kPlus)
SPMV_REDUCE_ENTRY(max_times_f32, float, Add::kMax, Mul::kTimes)
SPMV_REDUCE_ENTRY(min_min_i32, int32_t, Add::kMin, Mul::kMin)
