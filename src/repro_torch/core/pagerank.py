"""PageRank power method, exact and summarized (PyTorch port of
``repro.core.pagerank``).

Gelly-style normalization as in the paper (§2, §3.1): a vertex v sets
``rank(v) = (1-β) + β·Σ incoming`` with each u emitting ``rank(u)/d_out(u)``.
The summarized version runs the same update only for the hot set K, in a
compacted id space, with the frozen big-vertex contribution ``b_in`` added
each iteration and every cold rank carried over unchanged.

Every iteration is one :func:`repro_torch.core.backend.push`, per shard
when the summary was built through a sharded layout.  The loops
run on the host and read the step size back each iteration to keep the JAX
package's trip count exactly (``num_iters`` steps unless the change reaches
``tol``): one device-to-host sync per iteration.  The batched sweep
(:func:`summarized_pagerank_batched`) runs B queries of the serving engine
over one shared summary, one batched push per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import backend as B
from repro_torch.core.semiring import PLUS_TIMES
from repro_torch.graph.graph import GraphState, inv_out_degree


def _set_drop(dest: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``dest`` with ``dest[..., idx] = vals`` along the last axis
    (``[N]`` or ``[B, N]`` with ``vals`` ``[B, K]``), where indices at or
    past ``N`` (the out-of-range sentinels used here) write nothing."""
    n = dest.shape[-1]
    ext = torch.cat([dest, dest.new_zeros(dest.shape[:-1] + (1,))], dim=-1)
    ext[..., idx.long().clamp(max=n)] = vals
    return ext[..., :n].contiguous()


def _power_loop(step, r0: torch.Tensor, num_iters: int,
                tol: float) -> Tuple[torch.Tensor, int]:
    """Iterate ``r = step(r)`` while ``i < num_iters`` and the L1 change of
    the last step exceeds ``tol``; returns ``(r, iterations)``."""
    r, i, delta = r0, 0, float("inf")
    while i < num_iters and delta > tol:
        new_r = step(r)
        delta = float((new_r - r).abs().sum())
        r, i = new_r, i + 1
    return r, i


def _power_loop_batched(step, r0: torch.Tensor, num_iters: int, tol: float,
                        keep: torch.Tensor):
    """:func:`_power_loop` over ``[B, K]`` rows: rows where ``keep``
    (bool[B, 1]) is False carry their state and report zero change; the
    loop runs while any row's L1 change exceeds ``tol``.  Returns ``(r,
    iterations, row_delta f32[B])``."""
    r, i = r0, 0
    delta = torch.full((r0.shape[0],), float("inf"), device=r0.device)
    worst = float("inf")
    while i < num_iters and worst > tol:
        new_r = torch.where(keep, step(r), r)
        delta = (new_r - r).abs().sum(dim=1)
        worst = float(delta.max())
        r, i = new_r, i + 1
    return r, i, delta


def _keep(row_mask: Optional[torch.Tensor], batch: int,
          device) -> torch.Tensor:
    """bool[B, 1]: the live rows of a batched sweep (all when
    ``row_mask`` is None)."""
    if row_mask is None:
        return torch.ones((batch, 1), dtype=torch.bool, device=device)
    return row_mask.reshape(batch, 1)


# --------------------------------------------------------------------------
# Exact PageRank over the full graph
# --------------------------------------------------------------------------


def pagerank(
    state: GraphState,
    init_ranks: Optional[torch.Tensor] = None,
    *,
    beta: float = 0.85,
    num_iters: int = 30,
    tol: float = 0.0,
    teleport_by_n: bool = False,
    dangling: bool = False,
    teleport_v: Optional[torch.Tensor] = None,
    layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, int]:
    """Full power-method PageRank; returns ``(ranks f32[N_cap], iterations)``.

    ``teleport_v`` replaces the uniform teleport with a personalization
    vector.  ``layout`` is a cached forward ``inv_out`` layout; without one
    the sweep builds it on entry.
    """
    B.require_layout(layout, weight="inv_out", reverse=False, who="pagerank")
    active = state.node_active
    n_active = state.num_active_nodes().to(torch.float32).clamp(min=1.0)
    if teleport_v is not None:
        teleport = (1.0 - beta) * teleport_v
        r0 = torch.where(active, teleport_v, 0.0)
    elif teleport_by_n:
        teleport = (1.0 - beta) / n_active
        r0 = torch.where(active, 1.0 / n_active, 0.0)
    else:
        teleport = 1.0 - beta
        r0 = active.to(torch.float32)
    if init_ranks is not None:
        r0 = init_ranks
    if layout is None:
        layout = B.build_layout(state, weight="inv_out")
    dangling_mask = active & (state.out_deg == 0)

    def step(r):
        incoming = B.push(r, layout)
        if dangling:
            incoming = incoming + torch.where(dangling_mask, r,
                                              0.0).sum() / n_active
        return torch.where(active, teleport + beta * incoming, 0.0)

    return _power_loop(step, r0, num_iters, tol)


# --------------------------------------------------------------------------
# Summarized PageRank over the hot set (the paper's contribution)
# --------------------------------------------------------------------------


def compact_indices(mask: torch.Tensor, size: int, *,
                    rows: int = 64) -> torch.Tensor:
    """Indices of True entries of ``mask``, compacted into int32[size].

    Positions follow the JAX package's column-major assignment exactly:
    ``col_off[j] + (#True in column j above row i)`` over the
    ``(rows, cols)`` reshape, with ``col_off`` an exclusive prefix sum of
    the column totals taken through a second ``rows``-high level.  The
    order is what makes ``hot_ids``, local ids and the E_K order match the
    reference bitwise.  Unused slots hold ``len(mask)``; past ``size``
    entries an arbitrary subset of exactly ``size`` survives.
    """
    e = mask.shape[0]
    dev = mask.device

    def col_prefix(m2):
        """Per-element exclusive prefix count down its column, and the
        column totals."""
        inc = torch.cumsum(m2, dim=0, dtype=torch.int32)
        return inc[-1], inc - m2

    cols = max((e + rows - 1) // rows, 1)
    e_pad = rows * cols
    m = torch.nn.functional.pad(mask, (0, e_pad - e))
    col_tot, pos_in_col = col_prefix(m.reshape(rows, cols).to(torch.int32))
    cols2 = max((cols + rows - 1) // rows, 1)
    ct2 = torch.nn.functional.pad(col_tot, (0, rows * cols2 - cols))
    grp_tot, pos_in_grp = col_prefix(ct2.reshape(rows, cols2))
    grp_off = torch.cumsum(grp_tot, 0, dtype=torch.int32) - grp_tot
    col_off = (grp_off[None, :] + pos_in_grp).reshape(-1)[:cols]
    pos = (col_off[None, :] + pos_in_col).reshape(-1)
    tgt = torch.where(m & (pos < size), pos, size)
    out = torch.full((size,), e, dtype=torch.int32, device=dev)
    return _set_drop(out, tgt,
                     torch.arange(e_pad, dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class SummaryBuffers:
    """Compacted summary graph G = (K ∪ {B}, E_K ∪ E_B) in fixed capacities.

    ``hot_ids[i]`` is the global id of the i-th hot vertex (i < num_hot;
    padding holds ``N_cap``).  ``ek_src``/``ek_dst`` are *local* endpoints
    of the E_K edges sorted by local destination (invalid slots hold the
    ``K_cap`` sentinel and sort last), ``ek_w`` their weights and
    ``ek_row_offsets`` (int32[K_cap + 1]) the edge range per local
    destination.  ``b_in[z]`` is the frozen big-vertex contribution.
    ``overflow`` is True if |K| or |E_K| exceeded a capacity: the caller
    must fall back to exact recomputation.  ``weight_mode``/``semiring``
    record how ``ek_w``/``b_in`` were baked.  ``ek_w`` stays in the
    semiring's dtype whatever the full layout stores (as in the
    reference).

    **Sharded form** (built by :func:`build_summary` through a
    :class:`~repro_torch.core.backend.ShardedEdgeLayout`): the ``ek_*``
    buffers gain a leading shard axis, ``ek_src``/``ek_dst``/``ek_w``
    ``[S, H_s]`` and ``ek_row_offsets`` ``[S, K_cap + 1]``, one locally
    destination-sorted E_K shard each, shard ``j`` owning the local ids
    ``[j·⌈K_cap/S⌉, (j+1)·⌈K_cap/S⌉)``.  ``hot_ids``, ``b_in`` and the
    counters stay whole.  ``mesh``/``axes`` carry the device mesh: on R
    ranks each holds its ``S / R`` rows and ``total_shards`` is S.
    """

    hot_ids: torch.Tensor         # int32[K_cap]
    num_hot: torch.Tensor         # int32 0-d
    ek_src: torch.Tensor          # int32[H_cap]
    ek_dst: torch.Tensor          # int32[H_cap]
    ek_w: torch.Tensor            # dtype[H_cap]
    ek_row_offsets: torch.Tensor  # int32[K_cap + 1]
    num_ek: torch.Tensor          # int32 0-d
    b_in: torch.Tensor            # dtype[K_cap]
    num_eb: torch.Tensor          # int32 0-d
    overflow: torch.Tensor        # bool 0-d
    weight_mode: str = "inv_out"
    semiring: str = "plus_times"
    mesh: Optional[object] = None
    axes: Tuple[str, ...] = ()
    total_shards: Optional[int] = None

    @property
    def sharded(self) -> bool:
        """True for the stacked per-shard E_K form."""
        return self.ek_src.dim() == 2

    @property
    def num_shards(self) -> Optional[int]:
        """Shard count of the sharded form, ``None`` for flat summaries."""
        if not self.sharded:
            return None
        return (self.ek_src.shape[0] if self.total_shards is None
                else self.total_shards)


def _build_summary_sharded(
    state: GraphState,
    ranks_prev: torch.Tensor,
    hot_mask: torch.Tensor,
    *,
    hot_node_capacity: int,
    hot_edge_capacity: int,
    weight: str,
    layout: B.ShardedEdgeLayout,
    s,
    shard_bucket_capacity: Optional[int] = None,
) -> SummaryBuffers:
    """Summary construction over a sharded layout: a bucket sort over the
    shard axis, in which no stage gathers the whole edge stream.

    1. **local selection**: each shard masks its own sorted stream for
       E_K / E_B and relabels endpoints through the whole-graph
       ``local_of`` vector;
    2. **local destination sort**: one stable sort per shard by local
       destination groups its E_K edges into S buckets of ``W =
       ⌈K_cap/S⌉`` local ids each, sorted within each bucket;
    3. **capacity-padded exchange**: each (source shard, bucket) block is
       padded to ``C = ⌈H_cap/S⌉`` slots (``shard_bucket_capacity``
       overrides C) and the ``[S_in, S_out, C]`` stack is exchanged on its
       leading axes, ``all_to_all_single`` across a mesh of more than one
       rank and a transpose otherwise; shard ``j`` then holds every E_K
       edge into its bucket;
    4. **local merge**: one stable sort per shard merges its S sorted
       blocks, and ``ek_row_offsets`` come from a per-shard
       ``searchsorted``.

    A block over C raises ``overflow`` beside the |K| and |E_K| checks,
    and the caller falls back to exact recomputation.  ``b_in`` is the
    sharded push under the E_B mask.  The counters are summed over the
    mesh, so every rank sees the same ``num_ek``, ``num_eb`` and
    ``overflow``.  The E_K weights keep the layout's storage dtype, as in
    the reference.
    """
    dev = state.device
    n_cap = state.node_capacity
    k_cap, h_cap = hot_node_capacity, hot_edge_capacity
    B.require_placed(layout, "build_summary")
    num_shards = layout.num_shards
    rows, e_pad = layout.dst.shape
    if shard_bucket_capacity is None:
        bucket_cap = -(-h_cap // num_shards)  # C, per (source shard, bucket)
    elif shard_bucket_capacity < 1:
        raise ValueError(f"shard_bucket_capacity must be >= 1; got "
                         f"{shard_bucket_capacity}")
    else:
        bucket_cap = shard_bucket_capacity
    bucket_w = -(-k_cap // num_shards)      # W, local ids per bucket
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    s_zero = s.zero.item()
    _, n_ranks = B.mesh_rank_and_size(layout.mesh)

    # ---- hot-vertex relabelling: whole-graph node space, as flat -----------
    hot_ids = compact_indices(hot_mask, k_cap)
    num_hot = hot_mask.sum(dtype=torch.int32)
    local_valid = torch.arange(k_cap, dtype=torch.int32, device=dev) < num_hot
    local_of = _set_drop(torch.zeros(n_cap, dtype=torch.int32, device=dev),
                         hot_ids, torch.arange(k_cap, dtype=torch.int32,
                                               device=dev))

    # ---- 1. per-shard E_K / E_B selection over the sorted streams ---------
    dst_c = layout.dst.clamp(max=n_cap - 1)
    src_hot = hot_mask[layout.src]
    dst_hot = hot_mask[dst_c]
    ek_mask = layout.valid & src_hot & dst_hot
    eb_mask = layout.valid & ~src_hot & dst_hot

    # the frozen big-vertex boundary: the sharded push under the E_B mask;
    # [B, N] ranks_prev (a serving wave) gives b_in [B, K_cap]
    b_in_global = B.push(ranks_prev, layout, mask=eb_mask, semiring=s)
    b_in = torch.where(local_valid,
                       b_in_global[..., hot_ids.clamp(max=n_cap - 1)], s_zero)

    # ---- 2. local relabel and destination sort ------------------------------
    lsrc = torch.where(ek_mask, local_of[layout.src], 0)
    ldst = torch.where(ek_mask, local_of[dst_c], k_cap)  # sentinel last
    ek_w = torch.where(ek_mask, layout.weight, s_zero)
    ldst, perm = torch.sort(ldst, dim=1, stable=True)
    lsrc, ek_w = lsrc.gather(1, perm), ek_w.gather(1, perm)

    # ---- 3. capacity-padded blocks and the exchange -------------------------
    bounds = (torch.arange(num_shards + 1, dtype=torch.int32, device=dev)
              * bucket_w).clamp(max=k_cap)
    off = torch.searchsorted(ldst, bounds.expand(rows, -1).contiguous(),
                             side="left", out_int32=True)
    n_block = off[:, 1:] - off[:, :-1]                 # [S_in, S_out]
    lane = torch.arange(bucket_cap, dtype=torch.int32, device=dev)
    idx = (off[:, :-1, None] + lane).clamp(max=e_pad - 1).reshape(
        rows, num_shards * bucket_cap).long()
    block_valid = lane < n_block.clamp(max=bucket_cap)[:, :, None]

    def exchange(x, fill):
        """[S_in, E_pad] stream -> [S_out, S_in·C] received blocks."""
        g = torch.where(block_valid,
                        x.gather(1, idx).reshape(rows, num_shards,
                                                 bucket_cap), fill)
        send = g.transpose(0, 1)                       # [buckets, S_in, C]
        if n_ranks == 1:
            return send.reshape(rows, num_shards * bucket_cap)
        # bucket chunk j goes to rank j; rank i's source shards come back
        # in rank order
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(),
                               group=layout.mesh.get_group())
        return recv.reshape(n_ranks, rows, rows, bucket_cap).transpose(
            0, 1).reshape(rows, num_shards * bucket_cap)

    ek_src2 = exchange(lsrc, 0)
    ek_dst2 = exchange(ldst, k_cap)
    ek_w2 = exchange(ek_w, s_zero)

    # ---- 4. local merge sort and row offsets --------------------------------
    ek_dst2, perm2 = torch.sort(ek_dst2, dim=1, stable=True)
    ek_src2, ek_w2 = ek_src2.gather(1, perm2), ek_w2.gather(1, perm2)
    ek_row_offsets = torch.searchsorted(
        ek_dst2, torch.arange(k_cap + 1, dtype=torch.int32,
                              device=dev).expand(rows, -1).contiguous(),
        side="left", out_int32=True)

    # the counters over every rank's shards, in one collective
    counts = torch.stack([ek_mask.sum(dtype=torch.int32),
                          eb_mask.sum(dtype=torch.int32),
                          (n_block > bucket_cap).sum(dtype=torch.int32)])
    if layout.mesh is not None:
        counts = PLUS_TIMES.all_reduce(counts, layout.mesh)
    num_ek, num_eb = counts[0], counts[1]
    return SummaryBuffers(
        hot_ids=hot_ids, num_hot=num_hot, ek_src=ek_src2, ek_dst=ek_dst2,
        ek_w=ek_w2, ek_row_offsets=ek_row_offsets, num_ek=num_ek,
        b_in=b_in, num_eb=num_eb,
        overflow=(num_hot > k_cap) | (num_ek > h_cap) | (counts[2] > 0),
        weight_mode=weight, semiring=s.name, mesh=layout.mesh,
        axes=layout.axes, total_shards=layout.total_shards)


def build_summary(
    state: GraphState,
    ranks_prev: torch.Tensor,
    hot_mask: torch.Tensor,
    *,
    hot_node_capacity: int,
    hot_edge_capacity: int,
    weight: str = "inv_out",
    reverse: bool = False,
    layout: Optional[B.AnyEdgeLayout] = None,
    semiring: str = "plus_times",
    lengths: Optional[torch.Tensor] = None,
    shard_bucket_capacity: Optional[int] = None,
) -> SummaryBuffers:
    """Construct the big-vertex summary (§3.1) into bounded buffers.

    ``weight``/``reverse``/``semiring`` as for
    :func:`repro_torch.core.backend.build_layout`; ``layout`` is a cached
    full-graph layout matching them, through which the frozen big-vertex
    pass runs as one masked push (without one it is an unsorted
    :func:`~repro_torch.core.backend.push_coo`).  ``ranks_prev`` is the
    vector the frozen contribution is computed from.

    Handed a :class:`~repro_torch.core.backend.ShardedEdgeLayout`, the
    construction itself runs sharded (:func:`_build_summary_sharded`) and
    gives the stacked per-shard E_K form, whose summarized sweeps then
    push per shard; ``shard_bucket_capacity`` tightens its per-(shard,
    bucket) slot count.  The layout's baked weights are then the only
    source of the E_K weights: ``lengths`` does not override them.
    """
    if weight == "length" and lengths is None and layout is None:
        lengths = state.edge_len
    s = B.validate_weight_spec(weight, reverse=reverse, semiring=semiring,
                               lengths=lengths,
                               edge_capacity=state.edge_capacity)
    B.require_layout(layout, weight=weight, reverse=reverse,
                     who="build_summary", semiring=s)
    if isinstance(layout, B.ShardedEdgeLayout):
        return _build_summary_sharded(
            state, ranks_prev, hot_mask, hot_node_capacity=hot_node_capacity,
            hot_edge_capacity=hot_edge_capacity, weight=weight, layout=layout,
            s=s, shard_bucket_capacity=shard_bucket_capacity)
    dev = state.device
    n_cap, e_cap = state.node_capacity, state.edge_capacity
    k_cap, h_cap = hot_node_capacity, hot_edge_capacity
    mask = state.edge_mask()
    inv_deg = inv_out_degree(state)
    w_dtype = s.torch_dtype
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    s_zero = s.zero.item()
    if weight == "length" and layout is not None and layout.order is not None:
        # the layout's baked lengths, mapped back to slot order, so E_K
        # cannot diverge from the b_in boundary pass
        lengths = _set_drop(
            torch.full((e_cap,), s_zero, dtype=w_dtype, device=dev),
            layout.order, layout.weight.to(w_dtype))

    e_src, e_dst = (state.dst, state.src) if reverse else (state.src, state.dst)
    src_hot = hot_mask[e_src]
    dst_hot = hot_mask[e_dst]
    ek_mask = mask & src_hot & dst_hot
    eb_mask = mask & ~src_hot & dst_hot
    num_hot = hot_mask.sum(dtype=torch.int32)
    num_ek = ek_mask.sum(dtype=torch.int32)
    num_eb = eb_mask.sum(dtype=torch.int32)
    overflow = (num_hot > k_cap) | (num_ek > h_cap)

    # ---- hot-vertex relabelling: global id -> local id ------------------
    # padding entries hold an out-of-range sentinel: gathers clamp it and
    # are masked by local_valid; scatters drop it
    hot_ids = compact_indices(hot_mask, k_cap)
    local_valid = torch.arange(k_cap, dtype=torch.int32, device=dev) < num_hot
    local_of = _set_drop(torch.zeros(n_cap, dtype=torch.int32, device=dev),
                         hot_ids, torch.arange(k_cap, dtype=torch.int32,
                                               device=dev))

    # ---- frozen big-vertex contribution (once per query) -----------------
    if layout is None:
        if weight == "inv_out":
            coo_w = inv_deg[e_src]
        elif weight == "length":
            coo_w = (torch.ones_like(e_src, dtype=w_dtype) if lengths is None
                     else lengths.to(w_dtype))
        else:  # "unit": the ⊗-identity, no combine needed
            coo_w = None
        b_in_global = B.push_coo(ranks_prev, e_src, e_dst, n_cap,
                                 weight=coo_w, mask=eb_mask, semiring=s)
    else:
        eb_mask_s = ~hot_mask[layout.src] & hot_mask[
            layout.dst.clamp(max=n_cap - 1)]
        b_in_global = B.push(ranks_prev, layout, mask=eb_mask_s, semiring=s)
    b_in = torch.where(local_valid,
                       b_in_global[..., hot_ids.clamp(max=n_cap - 1)], s_zero)

    # ---- compact E_K into the bounded buffer -----------------------------
    ek_idx = compact_indices(ek_mask, h_cap)
    ek_valid = (torch.arange(h_cap, dtype=torch.int32, device=dev)
                < num_ek.clamp(max=h_cap))
    ek_idx_c = ek_idx.clamp(max=e_cap - 1)
    gsrc = e_src[ek_idx_c]
    gdst = e_dst[ek_idx_c]
    # val((u,v)) = 1/d_out(u) including edges that leave K (§3.1)
    if weight == "inv_out":
        ek_w = torch.where(ek_valid, inv_deg[gsrc], 0.0)
    elif weight == "length":
        per_edge = (torch.ones(h_cap, dtype=w_dtype, device=dev)
                    if lengths is None else lengths.to(w_dtype)[ek_idx_c])
        ek_w = torch.where(ek_valid, per_edge, s_zero)
    else:
        ek_w = torch.where(
            # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
            ek_valid, torch.tensor(s.one.item(), dtype=w_dtype, device=dev),
            torch.tensor(s_zero, dtype=w_dtype, device=dev))
    ek_src = torch.where(ek_valid, local_of[gsrc], 0)
    ek_dst = torch.where(ek_valid, local_of[gdst], 0)

    # ---- destination-sort the compacted buffer ---------------------------
    ek_key = torch.where(ek_valid, ek_dst, k_cap)
    ek_dst_s, ek_order = torch.sort(ek_key, stable=True)
    ek_row_offsets = torch.searchsorted(
        ek_dst_s, torch.arange(k_cap + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True)
    return SummaryBuffers(
        hot_ids=hot_ids, num_hot=num_hot, ek_src=ek_src[ek_order],
        ek_dst=ek_dst_s, ek_w=ek_w[ek_order], ek_row_offsets=ek_row_offsets,
        num_ek=num_ek, b_in=b_in, num_eb=num_eb, overflow=overflow,
        weight_mode=weight, semiring=s.name)


def summarized_pagerank(
    summary: SummaryBuffers,
    ranks_prev: torch.Tensor,
    *,
    beta: float = 0.85,
    num_iters: int = 30,
    tol: float = 0.0,
    teleport_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Power iteration restricted to the summary graph (§3.1): for every
    hot vertex z, ``rank(z) = (1-β)·t(z) + β·(Σ_{E_K} rank(u)·val(u,z) +
    b_in(z))``; cold ranks carry over.  Returns the global rank vector (a
    new tensor) and the iterations run."""
    k_cap = summary.hot_ids.shape[0]
    n = ranks_prev.shape[0]
    local_valid = (torch.arange(k_cap, dtype=torch.int32,
                                device=ranks_prev.device) < summary.num_hot)
    hot_c = summary.hot_ids.clamp(max=n - 1)
    r_local0 = torch.where(local_valid, ranks_prev[hot_c], 0.0)
    t_local = (1.0 if teleport_v is None
               else torch.where(local_valid, teleport_v[hot_c], 0.0))
    layout = B.summary_layout(summary)

    def step(r):
        incoming = B.push(r, layout)
        return torch.where(local_valid, (1.0 - beta) * t_local
                           + beta * (incoming + summary.b_in), 0.0)

    r_local, iters = _power_loop(step, r_local0, num_iters, tol)
    return _set_drop(ranks_prev, summary.hot_ids, r_local), iters


def summarized_pagerank_batched(
    summary: SummaryBuffers,
    ranks_prev: torch.Tensor,
    *,
    beta: float = 0.85,
    num_iters: int = 30,
    tol: float = 0.0,
    teleport_v: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Batched :func:`summarized_pagerank`: B queries over one shared
    summary.  ``ranks_prev``/``teleport_v`` are ``[B, N]`` (per-slot
    personalization vectors) and ``summary.b_in`` is ``[K_cap]`` or the
    per-query ``[B, K_cap]`` a batched :func:`build_summary` gives.  Each
    iteration is one batched push over the E_K layout.  ``row_mask``
    (bool[B]) freezes finished or vacant serving slots: their rows carry
    over unchanged and report zero delta.  Returns ``(ranks [B, N],
    iterations, row_delta f32[B])``, ``row_delta`` being each row's last
    L1 step."""
    batch, n = ranks_prev.shape
    k_cap = summary.hot_ids.shape[0]
    dev = ranks_prev.device
    local_valid = torch.arange(k_cap, dtype=torch.int32,
                               device=dev) < summary.num_hot
    hot_c = summary.hot_ids.clamp(max=n - 1)
    r_local0 = torch.where(local_valid, ranks_prev[:, hot_c], 0.0)
    t_local = (1.0 if teleport_v is None
               else torch.where(local_valid, teleport_v[:, hot_c], 0.0))
    keep = _keep(row_mask, batch, dev)
    layout = B.summary_layout(summary)

    def step(r):
        incoming = B.push(r, layout)
        return torch.where(local_valid, (1.0 - beta) * t_local
                           + beta * (incoming + summary.b_in), 0.0)

    r_local, iters, delta = _power_loop_batched(step, r_local0, num_iters,
                                                tol, keep)
    ranks = _set_drop(ranks_prev, summary.hot_ids, r_local)
    return torch.where(keep, ranks, ranks_prev), iters, delta
