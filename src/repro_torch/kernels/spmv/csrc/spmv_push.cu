// SpMV push for Hopper (sm_90a): a merge-path CSR SpMV, for one value
// vector or a batch of B of them.
//
//   out[b, v] = sum over e in [ro[v], ro[v+1]) of
//               keep(e) * (values[b, src[e]] ⊗ w[e])
//
// with ⊗ ∈ {×, +, min} over f32 (× is the sum of products of PageRank,
// HITS and Katz; + and min serve registered sum semirings), and w stored as
// f32, bf16 or f16 (the narrow forms are widened exactly to f32 before the
// ⊗).  Rows with no edge, or with every edge masked, write 0.
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_push, the TPU kernel that
// carries every push of the main path (the exact sweeps, the b_in pass and
// each summarized iteration), and ::spmv_push_batched, its B-query form that
// carries every sum push of a serving wave.  The TPU versions scatter
// through a one-hot MXU matmul over chunks staged in VMEM (a [B, chunk] @
// [chunk, tile_n] product in the batched form) because the TPU has no
// scatter; on Hopper the destination-sorted stream with its row offsets is a
// CSR matrix, reduced row by row.  The gather values[b, src[e]] and the ⊗,
// done outside the TPU kernel, are fused in here.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + sizeof(w) [+ 1 with a mask]) + 4 * (N + 1)
//   + B * 4 * N + B * 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once; the
// count of repro_torch/kernels/spmv/autotune.py::modeled_push_cost) for two
// flops per edge and batch row, far below the card's flop/byte ratio.  The
// value gathers hit L2 (N_src * 4 bytes per row of values).
//
// Design: the merge path of merge_path.cuh (equal shares of rows plus
// edges per block, whatever the row lengths; a second kernel of the same
// call folds the carries of rows that cross a block's end, in block order).
// Every sum is taken in an order fixed by row_offsets and the build's tile
// (-DMERGE_ITEMS) alone: there are no float atomics, every run of one tile
// gives the same bits, and each batch row is bitwise equal to the single
// push of its values.

#include "merge_path.cuh"

namespace {

struct Sum {
  __device__ __forceinline__ static float identity() { return 0.0f; }
  __device__ __forceinline__ static float apply(float a, float b) {
    return a + b;
  }
};

}  // namespace

// The merge items (row ends and edges) one block takes: the wrapper sizes
// the scratch from it.
extern "C" int merge_path_tile() { return merge_path::kTile; }

// One entry per ⊗ and weight type, spmv_push_batched_f32 (×),
// spmv_push_batched_plus_f32 and spmv_push_batched_min_f32 over f32 `w`,
// and the same names ending _wbf16 or _wf16 over bf16 or f16 `w`: `batch`
// value rows f32[batch, n_src], row-major -> out f32[batch, num_rows]; one
// value vector is the batch of one.  `num_edges` is the length of src, w
// and mask (ro[num_rows] <= num_edges); `scratch` holds (batch + 1) * scratch_blocks 4-byte words,
// scratch_blocks >= ceil((num_rows + num_edges) / merge_path_tile()).
// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success).  `mask` may be null.  Pointers are device pointers.
#define SPMV_PUSH_ENTRY(name, M, W)                                          \
  extern "C" int name(const void* values, const void* src, const void* w,   \
                      const void* row_offsets, const void* mask, void* out, \
                      void* scratch, int64_t scratch_blocks, int num_rows,  \
                      int64_t num_edges, int batch, int64_t n_src,          \
                      void* stream) {                                       \
    return merge_path::merge_launch<float, W, Sum, merge_path::M<float>>(    \
        values, n_src, src, w, row_offsets, mask, out, scratch,              \
        scratch_blocks, num_rows, num_edges, batch, stream);                 \
  }

SPMV_PUSH_ENTRY(spmv_push_batched_f32, Times, float)
SPMV_PUSH_ENTRY(spmv_push_batched_plus_f32, Plus, float)
SPMV_PUSH_ENTRY(spmv_push_batched_min_f32, Min, float)
SPMV_PUSH_ENTRY(spmv_push_batched_f32_wbf16, Times, __nv_bfloat16)
SPMV_PUSH_ENTRY(spmv_push_batched_plus_f32_wbf16, Plus, __nv_bfloat16)
SPMV_PUSH_ENTRY(spmv_push_batched_min_f32_wbf16, Min, __nv_bfloat16)
SPMV_PUSH_ENTRY(spmv_push_batched_f32_wf16, Times, __half)
SPMV_PUSH_ENTRY(spmv_push_batched_plus_f32_wf16, Plus, __half)
SPMV_PUSH_ENTRY(spmv_push_batched_min_f32_wf16, Min, __half)
