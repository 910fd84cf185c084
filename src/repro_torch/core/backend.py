"""One ``push`` primitive for every sweep (PyTorch port of
``repro.core.backend``, single-device part).

Every propagation (the exact sweeps, ``build_summary``'s frozen big-vertex
pass and each summarized iteration) is

    out[v] = ⊕ over in-edges (u, v) of ( values[u] ⊗ weight(u, v) )

over an :class:`EdgeLayout`: the receiver-sorted edge stream with the
per-edge weight baked in.  Sorting is the amortized cost: the engine builds
a layout once per applied update batch and reuses it across queries.

Dispatch is by the device of ``values``, not by a backend name.  Values
with weights stored in the semiring's dtype, or in bf16/f16 under an f32
semiring (``weight_dtype=``: narrow edge weights, widened to f32 at the
product), go to a hand-written kernel at the layout's merge tile
(``EdgeLayout.merge_tile``, stamped by the engine's tuner),
``[N]`` values to the single form and ``[B, N]`` values (B queries through
one layout, the serving engine's waves) to the batched form:

- every f32 sum (``plus_times``, and a registered sum with ⊗ = + or min)
  to the SpMV kernel
  (:func:`repro_torch.kernels.spmv.kernel.spmv_push`,
  :func:`~repro_torch.kernels.spmv.kernel.spmv_push_batched`);
- every min/max semiring over f32 or i32 (``min_plus``, ``max_times``,
  ``min_min`` and any registered one, e.g. a ``max_min`` bottleneck) to the
  min/max kernel
  (:func:`repro_torch.kernels.spmv.kernel.spmv_reduce_push`,
  :func:`~repro_torch.kernels.spmv.kernel.spmv_reduce_push_batched`).

A CUDA tensor launches the kernel and a CPU tensor takes its plain
version.  The semirings the reference's Pallas path refuses too (sums
outside f32, min/max outside f32 and i32) take the plain segment reduce on
the CPU and raise ``NotImplementedError`` on the card.

A :class:`ShardedEdgeLayout` (built by :func:`repro_torch.graph.partition.
build_sharded_layout`) holds one locally destination-sorted stream per
edge shard.  Its push is one push of the kernel above per shard, the
partials merged by the semiring's ⊕ (:meth:`~repro_torch.core.semiring.
Semiring.merge`) and, on a layout that carries a device mesh, completed by
the semiring's all-reduce over the mesh's process group
(:meth:`~repro_torch.core.semiring.Semiring.all_reduce`): each rank pushes
only its own shards.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.semiring import Semiring, resolve_semiring
from repro_torch.sharding.rules import flat_mesh
from repro_torch.graph.csr import gather_push, sort_by_dst
from repro_torch.graph.graph import GraphState, inv_out_degree
from repro_torch.kernels.spmv.kernel import (REDUCE_ENTRIES, spmv_push,
                                             spmv_push_batched,
                                             spmv_reduce_push,
                                             spmv_reduce_push_batched,
                                             weight_dtypes)

#: stream padding granularity, kept from the JAX package so layouts match
#: it byte for byte (the CUDA kernel itself reads only each row's range)
CHUNK = 512

#: weight modes an EdgeLayout can bake: ``inv_out`` = 1/d_out(u) (PageRank
#: emission; plus_times only), ``unit`` = the semiring's ⊗-identity,
#: ``length`` = per-edge lengths (default 1).
WEIGHT_MODES = ("inv_out", "unit", "length")


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    """Receiver-sorted edge stream with baked per-edge weights.

    ``dst`` holds ``num_segments`` in padding slots and ``weight`` the
    semiring's ⊕-identity there.  ``row_offsets`` (int32[num_segments + 1])
    gives the edge range per receiver: the kernel reads it as CSR row
    pointers.  ``order`` maps sorted position to edge slot (sentinel
    ``edge_capacity`` in padding; ``None`` for summary layouts); ``rank`` is
    the position within the destination run, baked for min/max layouts.
    ``weight_mode``/``reverse``/``semiring`` record how the layout was built
    so a mismatched consumer is rejected (:func:`require_layout`).
    ``merge_tile`` is the kernels' merge-path tile for this layout (``None``
    = the default), stamped by the engine's tuner when it builds the
    layout, so every push through the layout takes it.
    """

    src: torch.Tensor          # int32[E_pad]
    dst: torch.Tensor          # int32[E_pad] (sentinel = num_segments)
    weight: torch.Tensor       # dtype[E_pad] (⊕-identity where invalid)
    valid: torch.Tensor        # bool[E_pad]
    row_offsets: torch.Tensor  # int32[num_segments + 1]
    order: Optional[torch.Tensor] = None
    rank: Optional[torch.Tensor] = None
    weight_mode: str = "inv_out"
    reverse: bool = False
    pad_chunk: int = CHUNK
    semiring: str = "plus_times"
    merge_tile: Optional[int] = None

    @property
    def num_segments(self) -> int:
        """Size of the receiver space this layout pushes into."""
        return self.row_offsets.shape[0] - 1


@dataclasses.dataclass(frozen=True)
class ShardedEdgeLayout:
    """Edge-partitioned sibling of :class:`EdgeLayout`: one locally
    destination-sorted stream per shard, stacked along a leading shard axis.

    Every row keeps the invariants of an :class:`EdgeLayout`: the baked
    ⊗-operand, the ⊕-identity and the sentinel in its padding, at least
    one chunk of slack, and ``row_offsets`` over the whole
    ``num_segments`` receiver space, so that each shard's push is the
    ordinary single-stream kernel.  ``order`` maps each (shard, position)
    to its edge slot (sentinel ``edge_capacity``): the partition
    certificate, every live slot in exactly one shard.  ``merge_tile`` is
    the merge-path tile every shard's push takes.

    ``mesh`` (a 1-D ``torch.distributed.device_mesh.DeviceMesh``: the
    mesh axes ``axes`` of the engine's mesh, flattened) says where the
    shard axis lives:
    ``mesh=None`` runs every shard here and merges the partials on this
    device.  With a mesh of R ranks each rank pushes ``num_shards / R`` of
    them and the partials meet in the semiring's all-reduce.
    ``total_shards`` is set on a layout that holds only this rank's rows
    (``repro_torch.graph.partition.place_sharded_layout``); ``None`` means
    the rows held are all of them.  A push or a summary takes a mesh
    layout only once it is placed.
    """

    src: torch.Tensor          # int32[S, E_pad]
    dst: torch.Tensor          # int32[S, E_pad] (sentinel = num_segments)
    weight: torch.Tensor       # dtype[S, E_pad] (⊕-identity where invalid)
    valid: torch.Tensor        # bool[S, E_pad]
    row_offsets: torch.Tensor  # int32[S, num_segments + 1]
    order: Optional[torch.Tensor] = None
    rank: Optional[torch.Tensor] = None
    weight_mode: str = "inv_out"
    reverse: bool = False
    pad_chunk: int = CHUNK
    semiring: str = "plus_times"
    merge_tile: Optional[int] = None
    mesh: Optional[object] = None
    axes: Tuple[str, ...] = ()
    total_shards: Optional[int] = None

    @property
    def num_shards(self) -> int:
        """Edge shards over the whole mesh (all of them without one)."""
        return (self.row_offsets.shape[0] if self.total_shards is None
                else self.total_shards)

    @property
    def num_segments(self) -> int:
        """Size of the receiver space, shared by every shard."""
        return self.row_offsets.shape[1] - 1


#: the layouts :func:`push` accepts
AnyEdgeLayout = Union[EdgeLayout, ShardedEdgeLayout]


def mesh_rank_and_size(mesh) -> Tuple[int, int]:
    """``(this rank's coordinate, ranks)`` over every dim of a device mesh
    (row-major, as its flattened edge-shard axis counts them); ``(0, 1)``
    without one."""
    if mesh is None:
        return 0, 1
    mesh = flat_mesh(mesh)
    return mesh.get_local_rank(), mesh.size()


def require_placed(layout: ShardedEdgeLayout, who: str) -> None:
    """A mesh layout must hold this rank's rows only (placed once per
    build by ``repro_torch.graph.partition.place_sharded_layout``)."""
    if layout.mesh is not None and layout.total_shards is None:
        raise ValueError(
            f"{who} over a mesh layout that holds every rank's rows; "
            f"place it with repro_torch.graph.partition."
            f"place_sharded_layout first")


def padded_length(e: int, chunk: int) -> int:
    """Stream length after padding: the next chunk multiple plus one spare
    chunk, as in the JAX package."""
    return (e // chunk + 2) * chunk


def validate_weight_dtype(weight_dtype: Optional[str],
                          s: Semiring) -> Optional[str]:
    """Check a compressed edge-weight storage dtype: only f32 semirings may
    store weights as bfloat16/float16.  Returns the storage dtype name, or
    ``None`` when nothing is compressed."""
    if weight_dtype is None or weight_dtype == s.dtype:
        return None
    if s.dtype != "float32" or weight_dtype not in ("bfloat16", "float16"):
        raise ValueError(
            f"weight_dtype={weight_dtype!r} is not a storage form of "
            f"semiring {s.name!r} ({s.dtype}); compressed weights need an "
            f"f32 semiring and a bfloat16/float16 storage dtype")
    return weight_dtype


def bake_weights(s: Semiring, weight: str, valid: torch.Tensor,
                 src: torch.Tensor, *, inv_deg=None, lengths=None,
                 weight_dtype: Optional[str] = None) -> torch.Tensor:
    """The per-edge ⊗-operand for a stream, per weight mode; invalid slots
    bake the semiring's ⊕-identity.  ``valid``/``src``/``lengths`` follow
    the caller's stream order; ``inv_deg`` is the node-space 1/d_out."""
    dtype = s.torch_dtype
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    zero = s.zero.item()
    if weight == "inv_out":
        w = torch.where(valid, inv_deg[src], 0.0)
    elif weight == "unit":
        # filled on the device: no scalar is copied from the host
        # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
        w = torch.full(valid.shape, s.one.item(), dtype=dtype,
                       device=valid.device).masked_fill_(~valid, zero)
    else:
        per_edge = (torch.ones_like(src, dtype=dtype) if lengths is None
                    else lengths.to(dtype))
        w = torch.where(valid, per_edge, zero)
    stored = validate_weight_dtype(weight_dtype, s)
    return w if stored is None else w.to(getattr(torch, stored))


def stream_rank(dst: torch.Tensor, valid: torch.Tensor,
                row_offsets: torch.Tensor) -> torch.Tensor:
    """Per-edge rank within its destination run (``i - row_offsets[dst_i]``
    over the sorted stream; 0 in invalid and padding slots).  Stacked
    ``[S, E_pad]`` streams with ``[S, N + 1]`` offsets give one rank per
    row."""
    num_segments = row_offsets.shape[-1] - 1
    idx = torch.arange(dst.shape[-1], dtype=torch.int32, device=dst.device)
    start = row_offsets.gather(-1, dst.clamp(max=num_segments).long())
    return torch.where(valid, idx - start, 0)


def _pad_stream(src, dst, weight, valid, *, sentinel: int, chunk: int,
                zero=0.0):
    """Pad the sorted stream to :func:`padded_length`; padded weight slots
    hold ``zero`` (the consuming semiring's ⊕-identity)."""
    e = src.shape[0]
    pad = padded_length(e, chunk) - e
    f = torch.nn.functional.pad
    return (f(src, (0, pad)), f(dst, (0, pad), value=sentinel),
            f(weight, (0, pad), value=zero), f(valid, (0, pad)))


def validate_weight_spec(weight: str, *, reverse: bool = False,
                         semiring="plus_times", lengths=None,
                         edge_capacity: Optional[int] = None) -> Semiring:
    """Shared checks for every (weight, reverse, semiring) consumer
    (:func:`build_layout` and ``build_summary``).  Returns the resolved
    semiring."""
    s = resolve_semiring(semiring)
    if weight not in WEIGHT_MODES:
        raise ValueError(f"unknown weight mode {weight!r}; expected one of "
                         f"{WEIGHT_MODES}")
    if reverse and weight == "inv_out":
        raise ValueError(
            "reverse=True requires weight='unit' or 'length': inv_out "
            "would normalize by the out-degree of the receiving endpoint")
    if weight == "inv_out" and (s.add, s.mul) != ("sum", "times"):
        raise ValueError(
            "weight='inv_out' (1/d_out emission) is a sum-of-products "
            f"notion; semiring {s.name!r} needs 'unit' or 'length' weights")
    if lengths is not None and weight != "length":
        raise ValueError("lengths= is only meaningful with weight='length'")
    if (lengths is not None and edge_capacity is not None
            and lengths.shape[0] != edge_capacity):
        raise ValueError(
            f"lengths must cover every edge slot: got shape "
            f"{tuple(lengths.shape)}, edge_capacity={edge_capacity}")
    return s


def build_layout(
    state: GraphState,
    *,
    weight: str = "inv_out",
    reverse: bool = False,
    chunk: int = CHUNK,
    semiring: str = "plus_times",
    lengths: Optional[torch.Tensor] = None,
    weight_dtype: Optional[str] = None,
) -> EdgeLayout:
    """Full-graph propagation layout, sorted once per call.

    ``weight`` picks the baked ⊗-operand (``inv_out``, ``unit`` or
    ``length``, the latter from ``lengths``, else ``state.edge_len``, else
    1).  ``reverse=True`` builds the transposed layout.  Degrees are baked
    in, so a layout is valid until the next applied update batch.
    ``weight_dtype`` stores the weights as bfloat16/float16 (f32 semirings
    only).
    """
    record_trace("build_layout")
    if weight == "length" and lengths is None:
        lengths = state.edge_len
    s = validate_weight_spec(weight, reverse=reverse, semiring=semiring,
                             lengths=lengths,
                             edge_capacity=state.edge_capacity)
    se = sort_by_dst(state, reverse=reverse)
    w = bake_weights(
        s, weight, se.valid, se.src, inv_deg=inv_out_degree(state),
        lengths=None if lengths is None else lengths[se.order.long()],
        weight_dtype=weight_dtype)
    src, dst, w, valid = _pad_stream(
        se.src, se.dst, w, se.valid, sentinel=state.node_capacity,
        # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
        chunk=chunk, zero=s.zero.item())
    order = torch.nn.functional.pad(
        se.order, (0, src.shape[0] - se.order.shape[0]),
        value=state.edge_capacity)
    rank = (stream_rank(dst, valid, se.row_offsets)
            if s.add != "sum" else None)
    return EdgeLayout(src, dst, w, valid, se.row_offsets, order, rank,
                      weight_mode=weight, reverse=reverse, pad_chunk=chunk,
                      semiring=s.name)


def summary_layout(summary, *, chunk: int = CHUNK,
                   semiring: str = "plus_times") -> AnyEdgeLayout:
    """Propagation layout over a summary's compacted, pre-sorted E_K
    buffer (valid edges first, padding at the ``K_cap`` sentinel), at
    the kernels' default merge tile.  A sharded summary (stacked
    ``[S, H_s]`` E_K shards) gives a :class:`ShardedEdgeLayout` with the
    summary's mesh, so every summarized sweep runs per shard."""
    record_trace("summary_layout")
    s = resolve_semiring(semiring)
    if summary.semiring != s.name:
        raise ValueError(
            f"summary_layout(semiring={s.name!r}) over a summary baked for "
            f"{summary.semiring!r}; rebuild the summary for this semiring")
    k_cap = summary.hot_ids.shape[0]
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    zero = s.zero.item()
    if summary.ek_src.dim() == 2:
        # the stacked per-shard E_K (a summary built through a sharded
        # layout): padding is marked by the K_cap sentinel destination
        h_s = summary.ek_src.shape[1]
        extra = padded_length(h_s, chunk) - h_s
        pad2 = lambda x, v: torch.nn.functional.pad(x, (0, extra), value=v)
        dst = pad2(summary.ek_dst, k_cap)
        valid = pad2(summary.ek_dst < k_cap, False)
        rank = (stream_rank(dst, valid, summary.ek_row_offsets)
                if s.add != "sum" else None)
        return ShardedEdgeLayout(
            pad2(summary.ek_src, 0), dst, pad2(summary.ek_w, zero), valid,
            summary.ek_row_offsets, None, rank, weight_mode="summary",
            pad_chunk=chunk, semiring=s.name, mesh=summary.mesh,
            axes=summary.axes, total_shards=summary.total_shards)
    h_cap = summary.ek_src.shape[0]
    valid = (torch.arange(h_cap, dtype=torch.int32,
                          device=summary.ek_src.device)
             < summary.num_ek.clamp(max=h_cap))
    src, dst, w, valid = _pad_stream(
        summary.ek_src, summary.ek_dst, summary.ek_w, valid,
        sentinel=k_cap, chunk=chunk, zero=zero)
    rank = (stream_rank(dst, valid, summary.ek_row_offsets)
            if s.add != "sum" else None)
    return EdgeLayout(src, dst, w, valid, summary.ek_row_offsets, None, rank,
                      weight_mode="summary", pad_chunk=chunk,
                      semiring=s.name)


def require_layout(layout: Optional[AnyEdgeLayout], *, weight: str,
                   reverse: bool, who: str,
                   semiring: str = "plus_times") -> None:
    """A cached layout, single or sharded, must match the weighting,
    orientation and semiring the sweep was built for; ``None`` passes."""
    want_s = resolve_semiring(semiring).name
    if layout is not None and (layout.weight_mode != weight
                               or layout.reverse != reverse
                               or layout.semiring != want_s):
        raise ValueError(
            f"{who} needs a layout built with (weight={weight!r}, "
            f"reverse={reverse}, semiring={want_s!r}); got "
            f"(weight={layout.weight_mode!r}, reverse={layout.reverse}, "
            f"semiring={layout.semiring!r})")


def normalize_layout_spec(spec) -> tuple:
    """``(weight, reverse[, semiring])`` → ``(weight, reverse, semiring)``;
    two-element specs mean ``plus_times``."""
    if len(spec) == 2:
        return (spec[0], spec[1], "plus_times")
    if len(spec) != 3:
        raise ValueError(
            f"layout spec must be (weight, reverse[, semiring]); got {spec!r}")
    return tuple(spec)


def push(
    values: torch.Tensor,
    layout: AnyEdgeLayout,
    *,
    semiring: Union[str, Semiring] = "plus_times",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[v] = ⊕_{(u,v)} values[u] ⊗ layout.weight[(u,v)]``.

    ``semiring`` must match the one the layout was built for.  ``values``
    lives in the layout's node space: ``[N]``, or ``[B, N]`` for B queries
    through the one layout (row-major and contiguous on the card); the
    result has ``layout.num_segments`` entries per row and receivers with
    no unmasked in-edge get the ⊕-identity.  ``mask`` filters edges in the
    layout's sorted order and is shared by the rows.  A CUDA tensor
    launches the semiring's kernel, single or batched (see the module
    docstring), at the layout's merge tile, one launch per call; what has
    no kernel raises ``NotImplementedError`` there.

    A :class:`ShardedEdgeLayout` runs one such push per shard this rank
    holds (one launch each on the card), ⊕-merges the partials and, when
    the layout carries a mesh, all-reduces them over it; its ``mask`` is
    ``[S, E_pad]``, one row per shard held (a mesh layout is placed
    first, so it holds this rank's rows).  min/max results are bitwise those
    of the single layout's push, f32 sums differ by summation order.
    """
    s = resolve_semiring(semiring)
    if isinstance(layout, ShardedEdgeLayout):
        record_trace("push[sharded]")
        return _push_sharded(values, layout, s=s, mask=mask)
    if layout.semiring != s.name:
        raise ValueError(
            f"push(semiring={s.name!r}) over a layout built for "
            f"{layout.semiring!r}; rebuild the layout for this semiring")
    if values.dim() > 2:
        raise ValueError(
            f"push expects values of shape [N] or [B, N]; got "
            f"{tuple(values.shape)}")
    batched = values.dim() == 2
    record_trace("push")
    if batched:
        record_trace("push[batched]")
    f32_sum = (s.add, s.dtype) == ("sum", "float32")
    reduce_entry = (s.add, s.mul, s.torch_dtype) in REDUCE_ENTRIES
    # the semiring's own dtype, or bf16/f16 under an f32 semiring
    stored = layout.weight.dtype in weight_dtypes(s.torch_dtype)
    if stored and f32_sum:
        fn = spmv_push_batched if batched else spmv_push
        return fn(values, layout.src, layout.weight, layout.row_offsets, mask,
                  mul=s.mul, tile=layout.merge_tile)
    if stored and reduce_entry:
        fn = spmv_reduce_push_batched if batched else spmv_reduce_push
        return fn(values, layout.src, layout.weight, layout.row_offsets,
                  mask, op=s.add, mul=s.mul, tile=layout.merge_tile)
    if values.is_cuda:
        raise NotImplementedError(
            f"semiring {s.name!r} over {layout.weight.dtype} weights has no "
            f"GPU kernel: the kernels sum in f32 and take min/max in f32 or "
            f"i32, with weights in the semiring's dtype or, under f32, "
            f"bf16/f16")
    return gather_push(layout, values, layout.num_segments,
                       weight=layout.weight, mask=mask, semiring=s)


def _shard_view(layout: ShardedEdgeLayout, i: int) -> EdgeLayout:
    """Shard ``i`` of the stacked rows as a plain :class:`EdgeLayout`
    (contiguous row views, the same metadata and merge tile)."""
    return EdgeLayout(
        layout.src[i], layout.dst[i], layout.weight[i], layout.valid[i],
        layout.row_offsets[i], None,
        None if layout.rank is None else layout.rank[i],
        weight_mode=layout.weight_mode, reverse=layout.reverse,
        pad_chunk=layout.pad_chunk, semiring=layout.semiring,
        merge_tile=layout.merge_tile)


def _push_sharded(values: torch.Tensor, layout: ShardedEdgeLayout, *,
                  s: Semiring, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-shard partial pushes merged by ⊕, then the mesh's all-reduce.

    Each shard's stream is sorted on its own, so its reduce is the single
    layout's push (the kernel on the card); the partials are dense
    ``[..., num_segments]`` vectors.  ⊕ = min/max is exact under any
    regrouping, so those results are bitwise the unsharded push's."""
    if layout.semiring != s.name:
        raise ValueError(
            f"push(semiring={s.name!r}) over a sharded layout built for "
            f"{layout.semiring!r}; rebuild the layout for this semiring")
    if mask is not None and mask.shape != layout.dst.shape:
        raise ValueError(
            f"sharded push mask must cover the sharded sorted stream "
            f"{tuple(layout.dst.shape)}; got {tuple(mask.shape)}")
    require_placed(layout, "push")
    part = None
    for i in range(layout.row_offsets.shape[0]):
        one = push(values, _shard_view(layout, i), semiring=s,
                   mask=None if mask is None else mask[i])
        part = one if part is None else s.merge(part, one)
    if layout.mesh is not None:
        part = s.all_reduce(part, layout.mesh)
    return part


def push_coo(
    values: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_segments: int,
    *,
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    semiring: Union[str, Semiring] = "plus_times",
) -> torch.Tensor:
    """Unsorted-COO push for callers with no layout at hand: a plain
    segment reduce over the caller's edge order (``values`` ``[N]`` or
    ``[B, N]``).  Prefer :func:`push` with a cached layout."""
    record_trace("push_coo")
    s = resolve_semiring(semiring)
    contrib = values[..., src]
    if weight is not None:
        contrib = s.combine(contrib, weight)
    if mask is not None:
        # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
        contrib = torch.where(mask, contrib, s.zero.item())
    return s.segment_reduce(contrib, dst, num_segments=num_segments)


#: call counters: every primitive above ticks its own name per call, so a
#: run can show what it was built from (e.g. zero ``push_coo`` calls)
_TRACE_COUNTS: collections.Counter = collections.Counter()


def record_trace(name: str) -> None:
    """Tick the counter for ``name`` (one tick per call: PyTorch runs
    eagerly, so a call is a trace)."""
    _TRACE_COUNTS[name] += 1


def trace_count(name: str) -> int:
    """Calls of primitive ``name`` since the last :func:`reset_trace_counts`."""
    return _TRACE_COUNTS[name]


def reset_trace_counts() -> None:
    """Zero every call counter."""
    _TRACE_COUNTS.clear()
