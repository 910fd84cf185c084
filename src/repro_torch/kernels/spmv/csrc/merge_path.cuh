// Merge-path CSR push for Hopper (sm_90a), shared by spmv_push.cu (⊕ = sum)
// and spmv_reduce_push.cu (⊕ = min or max): for one value vector or a batch
// of B of them,
//
//   out[b, v] = ⊕ over e in [ro[v], ro[v+1]) with keep(e) of
//               values[b, src[e]] ⊗ T(w[e])
//
// and ⊕'s identity in a row with no kept edge.  A source instantiates
// merge_launch<T, W, Add, Mul> with two policies:
//   Add: static T identity();  static T apply(T earlier, T later)  (⊕)
//   Mul: static T apply(T value, T weight)  (⊗: Plus, Times or Min below)
// W is the stored weight's type: T itself, or bf16 / f16 under f32 values
// (narrow edge weights, the weight stream at 2 bytes an edge).  A narrow
// weight is widened exactly to f32 before the ⊗ (__bfloat162float,
// __half2float: f16 subnormals, such as 1/d_out above d_out = 16384, stay
// exact), which is what PyTorch's and XLA's promotion of bf16 ⊗ f32 does.
//
// The tile, kTile = kThreads * kItems merge items a block, is a build
// parameter: -DMERGE_ITEMS=k (odd, default 7) builds one library per tile,
// and the wrapper loads the library of the layout's tuned tile.
// Every fold below passes the earlier partial first, so a non-commutative
// rounding (a float sum) or a tie rule (which NaN or which zero a min keeps)
// is the same on every run.
//
// Design: merge-path SpMV (Merrill and Garland, SC'16).  The N row ends
// and the ro[N] - ro[0] edges form one merged list, and each block takes
// an equal share of it, kTile items, whatever the row lengths: a hub row
// with 240k in-edges is spread over ~140 blocks, and 300k short rows over as
// many blocks as their edges need.
// - A block finds its start and end on the merge path with a 32-ary warp
//   search over row_offsets (no plan is built or cached per layout), stages
//   its rows' ends and its edges' products values[src[e]] ⊗ w[e] in shared
//   memory (coalesced src, w and mask reads; a masked edge loads its mask
//   byte and nothing else and stages ⊕'s identity), and each thread walks
//   kItems items of it from its own diagonal (a binary search in shared
//   memory).
// - A thread writes every row it begins and ends; the first row it ends
//   takes the partials of the earlier threads in that row, from a segmented
//   scan of the threads' (row, partial) carries (warp shuffles, then across
//   warps in shared memory).  The block's last carry, the row that crosses
//   its end, goes to scratch.
// - A second kernel, launched by the same call, folds each run of block
//   carries, in block order, into the row the run belongs to (which a later
//   block has written).
// Every fold is taken in an order fixed by row_offsets and the build's
// tile alone: there are no atomics, every run of one tile gives the same
// bits (another tile folds a sum in another order), and batch row b takes
// the same partition and order as a single push (the B = 1 launch of the
// same entry), so each batch row is bitwise equal to it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace merge_path {

#ifndef MERGE_ITEMS
#define MERGE_ITEMS 7
#endif

constexpr int kThreads = 256;
constexpr int kItems = MERGE_ITEMS;          // merge items per thread (odd:
                                             // no bank conflicts in the walk)
static_assert(kItems % 2 == 1 && kItems > 0, "MERGE_ITEMS must be odd");
constexpr int kTile = kThreads * kItems;     // merge items per block
constexpr int kWarps = kThreads / 32;
constexpr int kFixWarps = 8;                 // fix-up: one warp per carry
constexpr int kMaxBatch = 65535;             // gridDim.y
constexpr unsigned kFull = 0xffffffffu;

// min (kLess) or max of a and b, the earlier operand first; a NaN operand
// wins, as in torch.minimum and scatter_reduce "amin"/"amax" (fminf/fmaxf
// would drop it)
template <bool kLess, typename T>
__device__ __forceinline__ T pick(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
  }
  return (kLess ? a < b : a > b) ? a : b;
}

// The ⊗ policies, over f32 or i32.  i32 + and × wrap as two's complement,
// as PyTorch and XLA do: they are computed in uint32 (a signed overflow
// would be undefined in C++).
template <typename T>
struct Plus {
  __device__ __forceinline__ static T apply(T x, T w) {
    if constexpr (std::is_same<T, float>::value) {
      return x + w;
    } else {
      return static_cast<T>(static_cast<uint32_t>(x) +
                            static_cast<uint32_t>(w));
    }
  }
};

template <typename T>
struct Times {
  __device__ __forceinline__ static T apply(T x, T w) {
    if constexpr (std::is_same<T, float>::value) {
      return x * w;
    } else {
      return static_cast<T>(static_cast<uint32_t>(x) *
                            static_cast<uint32_t>(w));
    }
  }
};

template <typename T>
struct Min {
  __device__ __forceinline__ static T apply(T x, T w) {
    return pick<true>(x, w);
  }
};

// A stored weight as the ⊗ operand: the same type as the values, or a
// narrow float widened exactly to f32.
template <typename W>
__device__ __forceinline__ W widen(W w) {
  return w;
}
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}
__device__ __forceinline__ float widen(__half w) { return __half2float(w); }

// The merge-path coordinate of diagonal d: how many of the N row ends come
// before it, i.e. the count of rows p with ro[p+1] - ro[0] + p + 1 <= d
// (strictly increasing in p).  A 32-ary search by one warp: each step
// samples 32 pivots and keeps the span between the last true and the first
// false one.  Uniform across the warp.
__device__ __forceinline__ int merge_search(const int32_t* __restrict__ ro,
                                            int lo, int nnz, int num_rows,
                                            int d, int lane) {
  int a = max(0, d - nnz), b = min(d, num_rows);  // the answer is in [a, b]
  while (a < b) {
    const int step = (b - a + 31) >> 5;
    const int p = a + (lane + 1) * step - 1;
    const bool before = p < b && __ldg(ro + p + 1) - lo + p + 1 <= d;
    const int c = __popc(__ballot_sync(kFull, before));
    const int next = a + c * step;
    if (c < 32) b = min(b, next + step - 1);
    a = next;
  }
  return a;
}

// kMasked: whether `mask` is given (an unmasked launch loads no mask byte)
template <typename T, typename W, typename Add, typename Mul, bool kMasked>
__global__ void __launch_bounds__(kThreads)
merge_push_kernel(const T* __restrict__ values, int64_t values_stride,
                  const int32_t* __restrict__ src, const W* __restrict__ w,
                  const int32_t* __restrict__ row_offsets,
                  const uint8_t* __restrict__ mask, T* __restrict__ out,
                  int32_t* __restrict__ carry_row, T* __restrict__ carry_val,
                  int32_t num_rows, int32_t num_blocks) {
  __shared__ int32_t s_end[kTile];   // row ends, from the block's first edge
  __shared__ T s_prod[kTile];        // keep(e) ? values[src[e]] ⊗ w[e] : id
  __shared__ int32_t s_bounds[2];
  __shared__ int32_t s_warp_row[2][kWarps];  // first and last lane's row
  __shared__ T s_warp_val[kWarps];           // last lane's scan value
  __shared__ T s_scan[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.y;
  values += b * values_stride;
  out += b * num_rows;
  carry_val += b * num_blocks;

  const int lo = __ldg(row_offsets);
  const int nnz = __ldg(row_offsets + num_rows) - lo;
  const int total = num_rows + nnz;
  const int d0 = blockIdx.x * kTile;
  if (d0 >= total) return;  // past the merge path (E bounds the grid)
  const int d1 = min(d0 + kTile, total);
  if (warp < 2) {
    const int x = merge_search(row_offsets, lo, nnz, num_rows,
                               warp ? d1 : d0, lane);
    if (lane == 0) s_bounds[warp] = x;
  }
  __syncthreads();
  const int x0 = s_bounds[0];               // first row of the block
  const int n_rows = s_bounds[1] - x0;      // row ends in the block
  const int e0 = lo + d0 - x0;              // first edge of the block
  const int n_items = d1 - d0;
  const int n_edges = n_items - n_rows;

  for (int i = tid; i < n_rows; i += kThreads) {
    s_end[i] = __ldg(row_offsets + x0 + i + 1) - e0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j < n_edges) {
      const int e = e0 + j;
      T prod = Add::identity();
      if (!kMasked || __ldg(mask + e)) {
        prod = Mul::apply(__ldg(values + __ldg(src + e)),
                          static_cast<T>(widen(__ldg(w + e))));
      }
      s_prod[j] = prod;
    }
  }
  __syncthreads();

  // this thread's start on the block's merge path
  const int d = min(tid * kItems, n_items);
  int x = max(0, d - n_edges);
  for (int hi = min(d, n_rows); x < hi;) {
    const int p = (x + hi) >> 1;
    if (s_end[p] + p + 1 <= d) {
      x = p + 1;
    } else {
      hi = p;
    }
  }
  int y = d - x;
  T run = Add::identity();
  T first = Add::identity();
  int first_row = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (d + k < n_items) {
      if (x < n_rows && s_end[x] <= y) {  // row x ends here
        if (first_row < 0) {
          first = run;
          first_row = x;
        } else {
          out[x0 + x] = run;
        }
        run = Add::identity();
        ++x;
      } else {
        run = Add::apply(run, s_prod[y]);
        ++y;
      }
    }
  }

  // segmented inclusive scan of the carries (x, run); rows never decrease
  // from thread to thread, so equal rows at two lanes mean one run between
  T val = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T v = __shfl_up_sync(kFull, val, off);
    const int r = __shfl_up_sync(kFull, x, off);
    if (lane >= off && r == x) val = Add::apply(v, val);
  }
  const int lane0_row = __shfl_sync(kFull, x, 0);
  if (lane == 0) s_warp_row[0][warp] = x;
  if (lane == 31) {
    s_warp_row[1][warp] = x;
    s_warp_val[warp] = val;
  }
  __syncthreads();
  if (lane0_row == x) {  // the run reaches back into earlier warps
    T before = Add::identity();
    for (int v = warp - 1; v >= 0 && s_warp_row[1][v] == x; --v) {
      before = Add::apply(s_warp_val[v], before);
      if (s_warp_row[0][v] != x) break;
    }
    val = Add::apply(before, val);
  }
  s_scan[tid] = val;
  __syncthreads();
  // the thread before this one ended inside the row this one starts in
  if (first_row >= 0) {
    out[x0 + first_row] =
        Add::apply(tid > 0 ? s_scan[tid - 1] : Add::identity(), first);
  }
  if (tid == kThreads - 1) {
    if (b == 0) carry_row[blockIdx.x] = x0 + x;
    carry_val[blockIdx.x] = val;
  }
}

// One warp per block carry: the first carry of each run of equal rows folds
// the run in block order (lane-strided, then a fixed shuffle tree) into the
// row, which the block that ended the row has written.
template <typename T, typename Add>
__global__ void __launch_bounds__(kFixWarps * 32)
carry_fixup_kernel(const int32_t* __restrict__ row_offsets,
                   const int32_t* __restrict__ carry_row,
                   const T* __restrict__ carry_val, T* __restrict__ out,
                   int32_t num_rows, int32_t num_blocks) {
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * kFixWarps + (threadIdx.x >> 5);
  const int64_t b = blockIdx.y;
  carry_val += b * num_blocks;
  out += b * num_rows;
  const int total = num_rows + __ldg(row_offsets + num_rows) -
                    __ldg(row_offsets);
  const int ran = (total + kTile - 1) / kTile;  // blocks that wrote a carry
  if (blk >= ran) return;
  const int row = carry_row[blk];
  if (row >= num_rows || (blk > 0 && carry_row[blk - 1] == row)) return;
  T acc = Add::identity();
  for (int base = blk; base < ran; base += 32) {
    const int i = base + lane;
    const bool in_run = i < ran && carry_row[i] == row;
    if (in_run) acc = Add::apply(acc, carry_val[i]);
    if (!__all_sync(kFull, in_run)) break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = Add::apply(acc, __shfl_down_sync(kFull, acc, off));
  }
  if (lane == 0) out[row] = Add::apply(out[row], acc);
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success).  `scratch` holds int32 carry rows [blocks], then T carry values
// [batch, blocks] (T is 4 bytes: (batch + 1) * scratch_blocks words).
template <typename T, typename W, typename Add, typename Mul>
int merge_launch(const void* values, int64_t values_stride, const void* src,
                 const void* w, const void* row_offsets, const void* mask,
                 void* out, void* scratch, int64_t scratch_blocks,
                 int num_rows, int64_t num_edges, int batch, void* stream) {
  static_assert(sizeof(T) == 4, "carries are 4-byte words");
  static_assert(std::is_same<W, T>::value ||
                    (std::is_same<T, float>::value && sizeof(W) == 2),
                "weights are T, or bf16 / f16 under f32 values");
  if (num_rows <= 0 || batch <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (num_rows + num_edges + kTile - 1) / kTile;
  if (batch > kMaxBatch || num_rows + num_edges >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (blocks > scratch_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* carry_row = static_cast<int32_t*>(scratch);
  T* carry_val = reinterpret_cast<T*>(carry_row + blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = mask == nullptr ? merge_push_kernel<T, W, Add, Mul, false>
                                : merge_push_kernel<T, W, Add, Mul, true>;
  kernel<<<dim3(static_cast<unsigned>(blocks), batch), kThreads, 0, s>>>(
      static_cast<const T*>(values), values_stride,
      static_cast<const int32_t*>(src), static_cast<const W*>(w),
      static_cast<const int32_t*>(row_offsets),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), carry_row,
      carry_val, num_rows, static_cast<int32_t>(blocks));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_fixup_kernel<T, Add><<<
      dim3(static_cast<unsigned>((blocks + kFixWarps - 1) / kFixWarps),
           batch), kFixWarps * 32, 0, s>>>(
      static_cast<const int32_t*>(row_offsets), carry_row, carry_val,
      static_cast<T*>(out), num_rows, static_cast<int32_t>(blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace merge_path
