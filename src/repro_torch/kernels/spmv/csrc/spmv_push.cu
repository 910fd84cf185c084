// SpMV push for Hopper (sm_90a): one warp per destination row of a CSR
// matrix, for one value vector or a batch of B of them.
//
//   out[b, v] = sum over e in [ro[v], ro[v+1]) of
//               keep(e) * values[b, src[e]] * w[e]
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_push, the TPU kernel that
// carries every push of the main path (the exact sweeps, the b_in pass and
// each summarized iteration), and ::spmv_push_batched, its B-query form that
// carries every sum push of a serving wave.  The TPU versions scatter
// through a one-hot MXU matmul over chunks staged in VMEM (a [B, chunk] @
// [chunk, tile_n] product in the batched form) because the TPU has no
// scatter; on Hopper the destination-sorted stream with its row offsets is a
// CSR matrix, so each row reads its own edge range and reduces it in
// registers.  The gather values[b, src[e]], done outside the TPU kernel, is
// fused in here.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + 4 [+ 1 with a mask]) + 4 * (N + 1)
//   + B * 4 * N + B * 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once) for two
// flops per edge and batch row, far below the card's flop/byte ratio.
//
// Design, simple and right first: one warp per (destination row, batch
// row), with a grid-stride loop over rows.  Block x serves batch row x % B,
// so the B warps of one row (a hub row's among them) start together and a
// hub row's critical path stays one row long whatever B is.  The lanes
// stride over the row's edges and reduce with warp shuffles in a fixed
// order, so there are no atomics and every run gives the same bits; the
// single push is the B = 1 launch of the same entry, so each batch row is
// bitwise equal to the single push of its value row.  The edge loop is
// software-pipelined: the next edge's src, w (and mask) are loaded while
// this edge's value is gathered, which keeps the hub rows' dependent loads
// from running in series (left to the compiler, the w load was sometimes
// issued only after the src load returned).  Rows with no edge write 0.  A
// hub row with millions of in-edges stays on a single warp: splitting hub
// rows (or a merge-path balance) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 32;  // per batch row; grid-stride beyond this
constexpr int kMaxBatch = 65535;      // keeps kMaxBlocks * batch in gridDim.x

// kMasked: whether `mask` is given (an unmasked launch loads no mask byte
// and no branch guards its loads)
template <bool kMasked>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_push_kernel(const float* __restrict__ values,
                 int64_t values_stride,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const int32_t* __restrict__ row_offsets,
                 const uint8_t* __restrict__ mask,
                 float* __restrict__ out,
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
    float acc = 0.0f;
    int32_t e = lo + lane;
    int32_t s = 0;
    float we = 0.0f;
    bool keep = false;
    if (e < hi) {
      keep = !kMasked || __ldg(mask + e);
      if (keep) {
        s = __ldg(src + e);
        we = __ldg(w + e);
      }
    }
    while (e < hi) {
      const int32_t next = e + 32;
      int32_t s_next = 0;
      float w_next = 0.0f;
      bool keep_next = false;
      if (next < hi) {
        keep_next = !kMasked || __ldg(mask + next);
        if (keep_next) {  // a masked edge costs its mask byte only
          s_next = __ldg(src + next);
          w_next = __ldg(w + next);
        }
      }
      if (keep) acc += __ldg(values + s) * we;
      e = next;
      s = s_next;
      we = w_next;
      keep = keep_next;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[row] = acc;
  }
}

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
  auto kernel = mask == nullptr ? spmv_push_kernel<false>
                                : spmv_push_kernel<true>;
  kernel<<<static_cast<unsigned>(blocks * batch), kWarpsPerBlock * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), values_stride,
      static_cast<const int32_t*>(src), static_cast<const float*>(w),
      static_cast<const int32_t*>(row_offsets),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), num_rows,
      batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `batch` value rows f32[batch, n_src], row-major -> out f32[batch, num_rows];
// one value vector is the batch of one.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  `mask` may be null.  Pointers are
// device pointers.
extern "C" int spmv_push_batched_f32(const void* values, const void* src,
                                     const void* w, const void* row_offsets,
                                     const void* mask, void* out,
                                     int num_rows, int batch, int64_t n_src,
                                     void* stream) {
  return launch(values, n_src, src, w, row_offsets, mask, out, num_rows,
                batch, stream);
}
