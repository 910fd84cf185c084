// SpMV push for Hopper (sm_90a): one warp per destination row of a CSR
// matrix.
//
//   out[v] = sum over e in [ro[v], ro[v+1]) of keep(e) * values[src[e]] * w[e]
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_push, the TPU kernel that
// carries every push of the main path (the exact sweeps, the b_in pass and
// each summarized iteration).  The TPU version scatters through a one-hot
// MXU matmul over chunks staged in VMEM because the TPU has no scatter; on
// Hopper the destination-sorted stream with its row offsets is a CSR matrix,
// so each row reads its own edge range and reduces it in registers.  The
// gather values[src[e]], done outside the TPU kernel, is fused in here.
//
// Bound: HBM bytes.  A call moves about
//   (ro[N] - ro[0]) * (4 + 4 [+ 1 with a mask]) + 4 * (N + 1) + 4 * N
//   + 4 * N_src
// bytes (src, w, mask, row offsets, out, and each value read once) for two
// flops per edge, far below the card's flop/byte ratio.
//
// Design, simple and right first: one warp per row with a grid-stride loop
// over rows; the lanes stride over the row's edges and reduce with warp
// shuffles in a fixed order, so there are no atomics and every run gives
// the same bits.  Rows with no edge write 0.  A hub row with millions of
// in-edges stays on a single warp: splitting hub rows (or a merge-path
// balance) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_push_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const int32_t* __restrict__ row_offsets,
                 const uint8_t* __restrict__ mask,
                 float* __restrict__ out,
                 int32_t num_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // `row` is uniform across the warp, so every lane reaches the shuffles
  for (int64_t row = first; row < num_rows; row += stride) {
    const int32_t lo = __ldg(row_offsets + row);
    const int32_t hi = __ldg(row_offsets + row + 1);
    float acc = 0.0f;
    for (int32_t e = lo + lane; e < hi; e += 32) {
      if (mask == nullptr || __ldg(mask + e)) {
        acc += __ldg(values + __ldg(src + e)) * __ldg(w + e);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[row] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `mask` may be null.  Pointers are device pointers.
extern "C" int spmv_push_f32(const void* values, const void* src,
                             const void* w, const void* row_offsets,
                             const void* mask, void* out, int num_rows,
                             void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (static_cast<int64_t>(num_rows) + kWarpsPerBlock - 1) /
                   kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  spmv_push_kernel<<<static_cast<int>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(src),
      static_cast<const float*>(w), static_cast<const int32_t*>(row_offsets),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), num_rows);
  return static_cast<int>(cudaGetLastError());
}
