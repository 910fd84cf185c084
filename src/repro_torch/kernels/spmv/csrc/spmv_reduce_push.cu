// Min/max push for Hopper (sm_90a): a merge-path CSR reduction, for one
// value vector or a batch of B of them.
//
//   out[b, v] = ⊕ over e in [ro[v], ro[v+1]) with keep(e) of
//               values[b, src[e]] ⊗ w[e]
//
// with ⊕ ∈ {min, max}, ⊗ ∈ {+, ×, min} and T ∈ {f32, i32}: twelve entries,
// one per (⊕, ⊗, T), so that every min/max semiring a user registers has a
// kernel, and twelve more over f32 values with bf16 or f16 `w` (narrow edge
// weights, widened exactly to f32 before the ⊗; i32 has no narrow form).
// A row with no kept edge gets ⊕'s identity (+inf / -inf for f32,
// INT32_MAX / INT32_MIN for i32), as XLA's segment_min / segment_max give
// an empty segment.
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
// Hopper the destination-sorted stream with its row offsets is a CSR matrix,
// so none of those encodings is needed and `rank` is not read.  The gather
// values[b, src[e]] and the ⊗ are fused in.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + sizeof(w) [+ 1 with a mask]) + 4 * (N + 1)
//   + B * 4 * N + B * 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once) for two
// operations per edge and batch row, far below the card's operation/byte
// ratio.
//
// Design: the merge path of merge_path.cuh, the sum push's partition.  Each
// block takes an equal share of rows plus edges, so synth-web-lg's hub rows
// (24 rows above 1,024 in-edges hold 73% of its edges, the largest 242,649)
// spread over as many blocks as they need instead of one warp each; a block
// folds the rows it holds whole and writes them, and its last row's partial
// goes to scratch, which a second kernel of the same call folds into the row
// in block order.  There are no atomics.  The partition depends on
// row_offsets and the build's tile (-DMERGE_ITEMS) only, never on B, so
// each batch row is folded as the B = 1 launch folds it and is bitwise
// equal to it.
//
// Determinism and the bitwise rules, held against the plain PyTorch version
// (scatter_reduce):
// - Min and max give one value in any order, but the fold order is fixed
//   anyway, so that the two choices order can change are made the same way
//   on every run: which NaN payload wins, and which of -0 and +0 a row
//   holding both returns (they compare equal; the shipped semirings' inputs
//   are non-negative).
// - f32 min/max propagate NaN, as scatter_reduce "amin"/"amax" and XLA do
//   (fminf/fmaxf would drop it); ⊗ = min propagates NaN as torch.minimum.
// - i32 ⊗ = + and × wrap as two's complement, as PyTorch and XLA do: they
//   are computed in uint32 (a signed overflow would be undefined in C++).
// - Build without --use_fast_math and without -ftz=true: max_times widths
//   are products of reliabilities in (0, 1] and reach denormals on long
//   paths, which the CPU keeps.
// - +inf + length stays +inf (IEEE addition, no special case needed).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "merge_path.cuh"

namespace {

template <typename T, bool kLess>
struct Reduce {
  __device__ __forceinline__ static T identity() {
    if constexpr (std::is_same<T, float>::value) {
      return kLess ? INFINITY : -INFINITY;
    } else {
      return kLess ? INT32_MAX : INT32_MIN;
    }
  }
  __device__ __forceinline__ static T apply(T a, T b) {
    return merge_path::pick<kLess>(a, b);
  }
};

}  // namespace

// The merge items (row ends and edges) one block takes: the wrapper sizes
// the scratch from it.
extern "C" int merge_path_tile() { return merge_path::kTile; }

// One entry per (⊕, ⊗, dtype), spmv_reduce_push_batched_<⊕>_<⊗>_<dtype>,
// and per (⊕, ⊗) over f32 values with narrow weights,
// spmv_reduce_push_batched_<⊕>_<⊗>_f32_wbf16 and ..._f32_wf16: `batch`
// row-major value rows [batch, n_src] -> out [batch, num_rows]; one value
// vector is the batch of one.  `values` and `out` share the dtype, and `w`
// has it too unless the name says otherwise.  `num_edges` is the length of
// src, w and mask (ro[num_rows] <= num_edges); `scratch` holds (batch + 1) * scratch_blocks 4-byte words,
// scratch_blocks >= ceil((num_rows + num_edges) / merge_path_tile()).
// Each launches both passes on `stream` and returns cudaGetLastError() (0 on
// success).  `mask` may be null.  Pointers are device pointers.
#define SPMV_REDUCE_ENTRY_W(name, T, W, LESS, M)                             \
  extern "C" int spmv_reduce_push_batched_##name(                           \
      const void* values, const void* src, const void* w,                   \
      const void* row_offsets, const void* mask, void* out, void* scratch,  \
      int64_t scratch_blocks, int num_rows, int64_t num_edges, int batch,   \
      int64_t n_src, void* stream) {                                        \
    return merge_path::merge_launch<T, W, Reduce<T, LESS>,                   \
                                    merge_path::M<T>>(                       \
        values, n_src, src, w, row_offsets, mask, out, scratch,              \
        scratch_blocks, num_rows, num_edges, batch, stream);                 \
  }
#define SPMV_REDUCE_ENTRY(name, T, LESS, M) \
  SPMV_REDUCE_ENTRY_W(name, T, T, LESS, M)

SPMV_REDUCE_ENTRY(min_plus_f32, float, true, Plus)
SPMV_REDUCE_ENTRY(min_times_f32, float, true, Times)
SPMV_REDUCE_ENTRY(min_min_f32, float, true, Min)
SPMV_REDUCE_ENTRY(max_plus_f32, float, false, Plus)
SPMV_REDUCE_ENTRY(max_times_f32, float, false, Times)
SPMV_REDUCE_ENTRY(max_min_f32, float, false, Min)
SPMV_REDUCE_ENTRY(min_plus_i32, int32_t, true, Plus)
SPMV_REDUCE_ENTRY(min_times_i32, int32_t, true, Times)
SPMV_REDUCE_ENTRY(min_min_i32, int32_t, true, Min)
SPMV_REDUCE_ENTRY(max_plus_i32, int32_t, false, Plus)
SPMV_REDUCE_ENTRY(max_times_i32, int32_t, false, Times)
SPMV_REDUCE_ENTRY(max_min_i32, int32_t, false, Min)
SPMV_REDUCE_ENTRY_W(min_plus_f32_wbf16, float, __nv_bfloat16, true, Plus)
SPMV_REDUCE_ENTRY_W(min_times_f32_wbf16, float, __nv_bfloat16, true, Times)
SPMV_REDUCE_ENTRY_W(min_min_f32_wbf16, float, __nv_bfloat16, true, Min)
SPMV_REDUCE_ENTRY_W(max_plus_f32_wbf16, float, __nv_bfloat16, false, Plus)
SPMV_REDUCE_ENTRY_W(max_times_f32_wbf16, float, __nv_bfloat16, false, Times)
SPMV_REDUCE_ENTRY_W(max_min_f32_wbf16, float, __nv_bfloat16, false, Min)
SPMV_REDUCE_ENTRY_W(min_plus_f32_wf16, float, __half, true, Plus)
SPMV_REDUCE_ENTRY_W(min_times_f32_wf16, float, __half, true, Times)
SPMV_REDUCE_ENTRY_W(min_min_f32_wf16, float, __half, true, Min)
SPMV_REDUCE_ENTRY_W(max_plus_f32_wf16, float, __half, false, Plus)
SPMV_REDUCE_ENTRY_W(max_times_f32_wf16, float, __half, false, Times)
SPMV_REDUCE_ENTRY_W(max_min_f32_wf16, float, __half, false, Min)
