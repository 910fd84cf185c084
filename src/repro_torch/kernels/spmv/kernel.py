"""SpMV pushes: the hand-written Hopper kernels and their plain PyTorch
versions.

:func:`spmv_push` computes, over a destination-sorted edge stream read as a
CSR matrix (``row_offsets`` into ``src``/``w``),

    out[v] = Σ_{e ∈ [ro[v], ro[v+1])} keep(e) · (values[src[e]] ⊗ w[e])

with ``keep(e) = mask[e]`` when a mask is given and ⊗ ∈ {×, +, min} (×
by default); ``w`` is f32, or bf16/f16 (narrow edge weights, widened to
f32 at the product as PyTorch's promotion does).
:func:`spmv_reduce_push` is its min/max sibling, ``out[v] = ⊕_e keep(e) ?
values[src[e]] ⊗ w[e]`` with ⊕ ∈ {min, max}, ⊗ ∈ {+, ×,
min}, f32 or i32 values (f32 ones also under bf16/f16 weights) and the
⊕-identity in rows with no kept edge.
:func:`spmv_push_batched` and :func:`spmv_reduce_push_batched` push a
``[B, N_src]`` matrix of B value rows through the one shared stream in one
launch, each output row bitwise equal to the single push of its value row.
They replace the Pallas kernels ``repro/kernels/spmv/kernel.py::spmv_push``,
``::spmv_reduce_push``, ``::spmv_push_batched`` and
``::spmv_reduce_push_batched``; the CUDA sources (``csrc/spmv_push.cu``,
``csrc/spmv_reduce_push.cu``, both on ``csrc/merge_path.cuh``) say how and
what bounds them.  Both are merge-path pushes: every block takes an equal
share of the rows and edges, whatever the row lengths, and a second pass,
launched by the same call, folds the partials of the rows that cross a
block's end into them (their scratch is allocated here).  Neither uses
atomics: every launch on the same inputs gives the same bits.

On a CUDA tensor a wrapper launches its kernel or raises; only a tensor
that lies on the CPU takes the plain version.  Each source is built at
first use by :mod:`repro_torch.kernels.build`, into ``build/`` beside this
file, once per merge-path tile that a call asks for (``tile=``, one of
:data:`TILES`; :mod:`repro_torch.kernels.spmv.autotune` picks it per
layout); nothing is compiled or loaded when this module is imported.  The
plain versions ignore the tile.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import current_stream, load_entry

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "spmv_push.cu"
REDUCE_SOURCE = CSRC / "spmv_reduce_push.cu"

#: ⊗ -> the entry of ``csrc/spmv_push.cu`` summing ``values[src] ⊗ w`` in
#: f32 (f32 weights; :data:`WEIGHT_TAGS` names the narrow-weight entries)
SUM_ENTRIES = {"times": "spmv_push_batched_f32",
               "plus": "spmv_push_batched_plus_f32",
               "min": "spmv_push_batched_min_f32"}
#: narrow weight dtype -> the suffix of its entries, which take f32 values
WEIGHT_TAGS = {torch.bfloat16: "_wbf16", torch.float16: "_wf16"}
#: (⊕, ⊗, dtype) -> the name of the entry of ``csrc/spmv_reduce_push.cu``
#: computing it (``spmv_reduce_push_batched_<name>``): every min/max
#: semiring over f32 or i32
REDUCE_ENTRIES = {
    (op, mul, dtype): f"{op}_{mul}_{tag}"
    for op in ("min", "max") for mul in ("plus", "times", "min")
    for dtype, tag in ((torch.float32, "f32"), (torch.int32, "i32"))}
#: the kernels' limit on batch rows
MAX_BATCH = 65535
#: threads of a merge-path block; a tile is THREADS × an odd number of
#: merge items a thread (``-DMERGE_ITEMS``)
THREADS = 256
#: the tiles (merge items, row ends and edges, a block) the tuner may pick:
#: 3, 5, 7, 11 and 15 items a thread
TILES = (768, 1280, 1792, 2816, 3840)
#: the tile of a layout that names none (7 items a thread)
DEFAULT_TILE = 1792

#: every entry takes six device pointers (values, src, w, row_offsets, mask
#: or null, out) and its carries' scratch, the scratch's block count
#: (int64), the row count, the edge count (int64), the batch, the values'
#: row stride (int64) and the stream
_ARGTYPES = ((ctypes.c_void_p,) * 7
             + (ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p))


def check_tile(tile: Optional[int]) -> int:
    """``tile`` (``None`` = :data:`DEFAULT_TILE`), checked against
    :data:`TILES`."""
    tile = DEFAULT_TILE if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"merge tile {tile!r} is not one of {TILES}")
    return tile


def tile_defines(tile: int) -> tuple:
    """The ``-D`` defines that build ``tile`` into a source."""
    return (f"MERGE_ITEMS={check_tile(tile) // THREADS}",)


@functools.lru_cache(maxsize=None)
def merge_tile(source: Path = SOURCE, tile: int = DEFAULT_TILE) -> int:
    """The merge items one block of ``source``'s library for ``tile``
    takes, as the library reports it; read once per ``(source, tile)``.
    Raises unless it is ``tile``: the carries' scratch is sized from it."""
    got = load_entry(source, "merge_path_tile", (), tile_defines(tile))()
    if got != tile:
        raise RuntimeError(f"the library of {source.name} built for tile "
                           f"{tile} reports tile {got}")
    return got


def _check_rank(who: str, values: torch.Tensor, batched: bool) -> None:
    """A batched push takes ``[B, N_src]`` value rows, a single push one
    vector (launched as the batch of one)."""
    if values.dim() != (2 if batched else 1):
        raise ValueError(f"{who}: values must be "
                         f"{'[B, N_src]' if batched else '1-D'}; got shape "
                         f"{tuple(values.shape)}")


def weight_dtypes(dtype: torch.dtype) -> tuple:
    """The weight dtypes a kernel takes with ``dtype`` values: the values'
    own, and bf16/f16 under f32."""
    return (dtype,) + (tuple(WEIGHT_TAGS) if dtype == torch.float32 else ())


def _check(who: str, rows, src, w, row_offsets, mask, dtype) -> None:
    """Device (CUDA), dtype, shape and contiguity checks of a kernel's
    operands, raising on the first that fails; ``rows`` (a vector, or
    ``[B, N_src]``) must be ``dtype`` and ``w`` one of
    :func:`weight_dtypes`.  A non-contiguous bank (transposed or sliced) is
    refused, not copied: the caller makes it contiguous once."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    named = [("src", src, (torch.int32,)), ("w", w, weight_dtypes(dtype)),
             ("row_offsets", row_offsets, (torch.int32,))]
    if mask is not None:
        named.append(("mask", mask, (torch.bool, torch.uint8)))
    for name, t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, values on "
                             f"{dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{who}: {name} must be {dtypes}; got "
                             f"{t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be 1-D and contiguous; "
                             f"got shape {tuple(t.shape)}")
    if rows.dtype != dtype:
        raise ValueError(f"{who}: values must be {dtype}; got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError(f"{who}: values must be contiguous; got shape "
                         f"{tuple(rows.shape)}, strides {rows.stride()}")
    batch = rows.shape[0] if rows.dim() == 2 else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"{who}: the batch must hold 1 to {MAX_BATCH} rows; "
                         f"got {batch}")
    if w.shape != src.shape or (mask is not None and mask.shape != src.shape):
        raise ValueError(f"{who}: w and mask must align with src")
    if row_offsets.shape[0] < 1:
        raise ValueError(f"{who}: row_offsets needs num_rows + 1 entries")
    if max(src.shape[0], rows.shape[-1], row_offsets.shape[0]) >= 2**31:
        raise ValueError(f"{who}: sizes must fit in int32")


def _launch(who: str, dev: torch.device, fn, *args) -> None:
    """Call the ``extern "C"`` entry ``fn`` with ``args`` and the current
    stream of ``dev``; raises on a failed launch."""
    with torch.cuda.device(dev.index):
        err = fn(*args, current_stream(dev))
    if err:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")


def _batch_shape(values: torch.Tensor):
    """``(batch, n_src)`` of one value vector (the batch of one) or of
    ``[B, N_src]`` rows."""
    return tuple(values.shape) if values.dim() == 2 else (1, values.shape[0])


def _rows(row_offsets: torch.Tensor):
    """``(lo, hi, rows)``: the edge range the rows cover and each edge's
    row, for the plain versions."""
    num_rows = row_offsets.shape[0] - 1
    lo, hi = int(row_offsets[0]), int(row_offsets[-1])
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=row_offsets.device),
        (row_offsets[1:] - row_offsets[:-1]).long(), output_size=hi - lo)
    return lo, hi, rows


def scratch_blocks(num_rows: int, num_edges: int, tile: int) -> int:
    """The blocks of one merge-path launch over ``num_rows`` row ends and
    ``num_edges`` edges at ``tile``: what the carries' scratch is sized
    from."""
    return -(-(num_rows + num_edges) // tile)


def _merge_launch(who: str, source: Path, entry: str, values, src, w,
                  row_offsets, mask, tile: int) -> torch.Tensor:
    """Check the operands of a CUDA push, allocate its output and its
    carries' scratch, and launch ``entry`` (or its narrow-weight form) of
    ``source``'s library for ``tile`` on them."""
    dev = values.device
    _check(who, values, src, w, row_offsets, mask, values.dtype)
    entry += WEIGHT_TAGS.get(w.dtype, "")  # a narrow weight's entry
    batch, n_src = _batch_shape(values)
    num_rows, num_edges = row_offsets.shape[0] - 1, src.shape[0]
    if num_rows + num_edges >= 2**31:
        raise ValueError(f"{who}: rows plus edges must fit in int32")
    out = torch.empty(values.shape[:-1] + (num_rows,), dtype=values.dtype,
                      device=dev)
    if num_rows == 0:
        return out
    # the carries: a row id per block, then a value per block and batch row
    blocks = scratch_blocks(num_rows, num_edges, merge_tile(source, tile))
    scratch = torch.empty((batch + 1) * blocks, dtype=torch.int32, device=dev)
    _launch(who, dev, load_entry(source, entry, _ARGTYPES,
                                 tile_defines(tile)),
            values.data_ptr(), src.data_ptr(), w.data_ptr(),
            row_offsets.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), blocks, num_rows, num_edges,
            batch, n_src)
    return out


def _sum_push(who: str, batched: bool, values, src, w, row_offsets, mask,
              mul: str, tile: Optional[int]):
    """The SpMV push of one value vector or of ``[B, N_src]`` value rows:
    the kernel for CUDA tensors, the plain version for CPU ones."""
    _check_rank(who, values, batched)
    tile = check_tile(tile)
    if mul not in SUM_ENTRIES:
        raise ValueError(f"{who}: mul must be one of {sorted(SUM_ENTRIES)}; "
                         f"got {mul!r}")
    if values.device.type == "cpu":
        return spmv_push_plain(values, src, w, row_offsets, mask, mul=mul)
    if values.dtype != torch.float32:
        raise ValueError(f"{who}: values must be {torch.float32}; got "
                         f"{values.dtype}")
    return _merge_launch(who, SOURCE, SUM_ENTRIES[mul], values, src, w,
                         row_offsets, mask, tile)


def spmv_push(values: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
              row_offsets: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *,
              mul: str = "times", tile: Optional[int] = None) -> torch.Tensor:
    """f32[N] = Σ over each row's edge range of ``values[src] ⊗ w``
    (masked), ⊗ = ``mul`` ∈ {times, plus, min}.

    ``values`` f32[N_src], ``src`` i32[E], ``w`` f32, bf16 or f16 [E],
    ``row_offsets`` i32[N+1] (non-decreasing, ``row_offsets[N] <= E``),
    ``mask`` bool or u8[E], ``tile`` the merge-path tile (one of
    :data:`TILES`; ``None`` = :data:`DEFAULT_TILE`).  CUDA tensors launch
    the kernel on the current stream (counted in ``spmv_push.launches``);
    CPU tensors take :func:`spmv_push_plain`.
    """
    out = _sum_push("spmv_push", False, values, src, w, row_offsets, mask,
                    mul, tile)
    if values.is_cuda and out.numel():
        spmv_push.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
spmv_push.launches = 0


def spmv_push_batched(values: torch.Tensor, src: torch.Tensor,
                      w: torch.Tensor, row_offsets: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *,
                      mul: str = "times",
                      tile: Optional[int] = None) -> torch.Tensor:
    """f32[B, N]: :func:`spmv_push` of each row of ``values`` f32[B, N_src]
    (row-major and contiguous) through the one stream, in one launch; the
    mask is per edge, shared by the rows.  Each output row is bitwise equal
    to :func:`spmv_push` of its value row at the same tile.  CUDA tensors
    launch the kernel on the current stream (counted in
    ``spmv_push_batched.launches``); CPU tensors take
    :func:`spmv_push_batched_plain`."""
    out = _sum_push("spmv_push_batched", True, values, src, w, row_offsets,
                    mask, mul, tile)
    if values.is_cuda and out.numel():
        spmv_push_batched.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
spmv_push_batched.launches = 0


def _combine(x: torch.Tensor, w: torch.Tensor, mul: str) -> torch.Tensor:
    """``x ⊗ w`` elementwise for ⊗ = ``mul`` (min propagates NaN)."""
    if mul == "times":
        return x * w
    if mul == "plus":
        return x + w
    if mul == "min":
        return torch.minimum(x, w)
    raise ValueError(f"mul must be 'plus', 'times' or 'min', got {mul!r}")


def spmv_push_plain(values: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                    row_offsets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    mul: str = "times",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv_push` (and, for ``[B,
    N_src]`` values, of :func:`spmv_push_batched`): an ``index_add_`` along
    the last axis over ``values[..., src] ⊗ w`` in edge order, computed in
    ``dtype``.  In f32 it repeats the JAX package's sequential segment sum;
    ``torch.float64`` makes it the oracle the kernel is held against (a
    sequential f32 sum over a 240k-edge hub row drifts ~1e-4 relative from
    it)."""
    lo, hi, rows = _rows(row_offsets)
    contrib = _combine(values.to(dtype)[..., src[lo:hi].long()],
                       w[lo:hi].to(dtype), mul)
    if mask is not None:
        contrib = torch.where(mask[lo:hi].bool(), contrib, 0.0)
    out = torch.zeros(values.shape[:-1] + (row_offsets.shape[0] - 1,),
                      dtype=dtype, device=values.device)
    return out.index_add_(-1, rows, contrib)


#: the plain version of :func:`spmv_push_batched`
spmv_push_batched_plain = spmv_push_plain


def reduce_identity(dtype: torch.dtype, op: str):
    """⊕'s identity for ``op`` ∈ {min, max}: what an empty row gets (+∞/−∞,
    or the integer extrema), as XLA's ``segment_min``/``segment_max``."""
    if op not in ("min", "max"):
        raise ValueError(f"op must be 'min' or 'max', got {op!r}")
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _reduce_push(who: str, batched: bool, values, src, w, row_offsets, mask,
                 op: str, mul: str, tile: Optional[int]):
    """The min/max push of one value vector or of ``[B, N_src]`` value rows:
    the kernel for CUDA tensors, the plain version for CPU ones."""
    _check_rank(who, values, batched)
    tile = check_tile(tile)
    if values.device.type == "cpu":
        return spmv_reduce_push_plain(values, src, w, row_offsets, mask,
                                      op=op, mul=mul)
    name = REDUCE_ENTRIES.get((op, mul, values.dtype))
    if name is None:
        raise ValueError(f"{who}: no kernel for (op={op!r}, mul={mul!r}, "
                         f"{values.dtype}); it has "
                         f"{sorted(REDUCE_ENTRIES.values())}")
    return _merge_launch(who, REDUCE_SOURCE,
                         f"spmv_reduce_push_batched_{name}", values, src, w,
                         row_offsets, mask, tile)


def spmv_reduce_push(values: torch.Tensor, src: torch.Tensor,
                     w: torch.Tensor, row_offsets: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *, op: str,
                     mul: str, tile: Optional[int] = None) -> torch.Tensor:
    """``out[v] = op over each row's (kept) edges of values[src] ⊗ w``.

    ``op`` ∈ {min, max}, ``mul`` ∈ {plus, times, min}; ``values`` f32 or
    i32 on the card (:data:`REDUCE_ENTRIES`; i32 ``plus`` and ``times``
    wrap as two's complement), ``w`` of the same dtype or, under f32
    values, bf16/f16.  Rows with no kept edge get :func:`reduce_identity`.
    Other operands as :func:`spmv_push`.  CUDA tensors launch the kernel on
    the current stream (counted in ``spmv_reduce_push.launches``); CPU
    tensors take :func:`spmv_reduce_push_plain`.
    """
    out = _reduce_push("spmv_reduce_push", False, values, src, w,
                       row_offsets, mask, op, mul, tile)
    if values.is_cuda and out.numel():
        spmv_reduce_push.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
spmv_reduce_push.launches = 0


def spmv_reduce_push_batched(values: torch.Tensor, src: torch.Tensor,
                             w: torch.Tensor, row_offsets: torch.Tensor,
                             mask: Optional[torch.Tensor] = None, *, op: str,
                             mul: str,
                             tile: Optional[int] = None) -> torch.Tensor:
    """``[B, N]``: :func:`spmv_reduce_push` of each row of ``values``
    ``[B, N_src]`` (row-major and contiguous) through the one stream, in one
    launch; the mask is per edge, shared by the rows.  Each output row is
    bitwise equal to :func:`spmv_reduce_push` of its value row at the same
    tile.  CUDA tensors launch the kernel on the current stream (counted in
    ``spmv_reduce_push_batched.launches``); CPU tensors take
    :func:`spmv_reduce_push_batched_plain`."""
    out = _reduce_push("spmv_reduce_push_batched", True, values, src, w,
                       row_offsets, mask, op, mul, tile)
    if values.is_cuda and out.numel():
        spmv_reduce_push_batched.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
spmv_reduce_push_batched.launches = 0


def spmv_reduce_push_plain(values: torch.Tensor, src: torch.Tensor,
                           w: torch.Tensor, row_offsets: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *, op: str,
                           mul: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv_reduce_push` (and, for
    ``[B, N_src]`` values, of :func:`spmv_reduce_push_batched`): the
    ``scatter_reduce`` segment reduce along the last axis of ``values[...,
    src] ⊗ w`` over each row's edge range (a narrow ``w`` promoted to the
    values' f32), with masked edges at the identity.  Min and max give the
    same answer in any order, and NaN propagates."""
    ident = reduce_identity(values.dtype, op)
    lo, hi, rows = _rows(row_offsets)
    contrib = _combine(values[..., src[lo:hi].long()],
                       w[lo:hi].to(values.dtype), mul)
    if mask is not None:
        contrib = torch.where(mask[lo:hi].bool(), contrib, ident)
    out = torch.full(values.shape[:-1] + (row_offsets.shape[0] - 1,), ident,
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(-1, rows.expand(contrib.shape), contrib,
                               reduce="amin" if op == "min" else "amax",
                               include_self=True)


#: the plain version of :func:`spmv_reduce_push_batched`
spmv_reduce_push_batched_plain = spmv_reduce_push_plain
