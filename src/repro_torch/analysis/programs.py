"""The hot-path program catalog the analysis passes run (PyTorch port of
``repro.analysis.programs``).

Each :class:`Program` names one function the engine actually runs —
``push``/``push_coo``, ``build_summary``, ``fused_query_step`` /
``fused_query_step_batched`` (the serving engine's wave step), the
streaming apply step (``add_edges``) and the async pipeline's epoch
counts — bound to small concrete inputs from one :class:`GraphSpec` on one
device, so that

- :func:`~repro_torch.analysis.dispatch_lint.record_program` runs it under
  a dispatch recorder armed with the spec-derived thresholds, and
- :func:`~repro_torch.analysis.memory_audit.audit_memory` holds its
  largest intermediate (and on the card its peak) to the spec-derived
  byte budget.

A program is a callable on fixed inputs: PyTorch traces and compiles
nothing, so there is no ``trace``/``compile`` as in the reference.  The
port dispatches a push by the device of its values, not by a backend name,
so the reference's ``push[segment_sum,*]`` and ``push[pallas,*]`` are one
program each here (``push[plus_times]``: the SpMV kernel on the card, its
plain version on the CPU).  The meshless sharded programs run the
reference's shard loop (``push_sharded[loop]``, ``build_summary[sharded]``,
``fused_query_step[pagerank,sharded]``, at ``spec.num_shards`` shards).
Given a mesh of two or more ranks, :func:`catalog` adds the mesh programs
(the reference's ``catalog(mesh=...)``): ``push_sharded[pallas,mesh]`` is
the push the engine runs (the kernel on the card, its plain version on the
CPU), ``push_sharded[segment_sum,mesh]`` the sorted segment reduce a
semiring without a kernel entry takes (``graph.csr.gather_push``), each a
shard's partials merged and all-reduced over the mesh, with
``build_summary[sharded,mesh]`` and ``fused_query_step[pagerank,sharded,
mesh]``; ``tools/analyze_torch.py``'s collective pass records them on a
fake process group and holds their collectives to the budgets.

:func:`run_rebuild_scenario` and :func:`run_async_rebuild_scenario` are
the rebuild pass's canned engine loops (the reference's retrace
scenarios, at the same sizes, seeds and rounds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import memory_audit
from repro_torch.core import backend as B
from repro_torch.core.algorithm import make_algorithm
from repro_torch.core.control import default_probe_ids
from repro_torch.core.epoch import snapshot_counts
from repro_torch.core.fused import fused_query_step, fused_query_step_batched
from repro_torch.core.pagerank import build_summary
from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.graph.csr import gather_push
from repro_torch.graph.graph import GraphState, add_edges, clone, from_edges
from repro_torch.graph.partition import build_sharded_layout

#: the reference's programs the port does not run (none: the mesh programs
#: join the catalog given a mesh of two or more ranks)
OMITTED: tuple = ()


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """The concrete shape every catalog program runs at, and the source of
    the derived analysis bounds (``en_threshold``, ``edge_threshold``, the
    byte budget via :func:`repro_torch.analysis.memory_audit.
    budgets_for_spec`)."""

    node_capacity: int = 1024
    edge_capacity: int = 16384
    num_edges: int = 8192
    hot_node_capacity: int = 128
    hot_edge_capacity: int = 512
    batch: int = 4
    num_shards: int = 4
    apply_chunk: int = 64

    @property
    def en_threshold(self) -> int:
        """Elements at which an intermediate counts as ``[E, N]``-class
        (half the full product, to catch padded/halved variants while
        staying orders above any legitimate E- or B·N-sized buffer)."""
        return (self.edge_capacity * self.node_capacity) // 2

    @property
    def edge_threshold(self) -> int:
        """Elements at which a scatter index or an int64 temporary counts
        as *edge-scale* (half an edge buffer — catches full-E work while
        exempting apply-chunk degree bookkeeping and hot-set K-space
        compaction)."""
        return self.edge_capacity // 2


@dataclasses.dataclass
class Program:
    """One hot-path program bound to concrete inputs.

    ``fn`` takes ``args`` positionally.  ``prepare`` (optional) makes fresh
    inputs for each run, for a program that writes its inputs in place
    (the streaming apply); :meth:`inputs` gives them, outside whatever
    records the run.  ``budgets`` defaults to the spec-derived ones.
    """

    name: str
    fn: Callable
    args: tuple
    spec: GraphSpec
    budgets: memory_audit.CollectiveBudgets = None
    prepare: Optional[Callable[[], tuple]] = None

    def __post_init__(self):
        if self.budgets is None:
            self.budgets = memory_audit.budgets_for_spec(self.spec)

    def inputs(self) -> tuple:
        """The arguments of one run."""
        return self.prepare() if self.prepare is not None else self.args

    def run(self):
        """One run on fresh inputs."""
        return self.fn(*self.inputs())


def build_graph(spec: GraphSpec, seed: int = 0, *,
                device=None) -> GraphState:
    """A concrete G(n, m) graph at the spec's capacities on ``device``
    (the card unless another device is named)."""
    src, dst = generators.gnm_edges(
        spec.node_capacity, spec.num_edges, seed=seed)
    return from_edges(src, dst, spec.node_capacity, spec.edge_capacity,
                      device=device)


def _query_args(state: GraphState, algo) -> tuple:
    scalar = functools.partial(torch.tensor, dtype=torch.float32,
                               device=state.device)
    return (state, algo.init_state(state), state.out_deg, state.node_active,
            scalar(0.2), scalar(0.05))


def _bank(algo_state: Dict[str, torch.Tensor], batch: int) -> Dict:
    """A serving slot bank: every leaf repeated over a leading batch
    axis."""
    return {k: v[None].repeat((batch,) + (1,) * v.dim())
            for k, v in algo_state.items()}


def _segment_sum_sharded(values: torch.Tensor,
                         layout: B.ShardedEdgeLayout) -> torch.Tensor:
    """The sharded push through the sorted segment reduce
    (``gather_push``) of each held shard, merged and all-reduced over the
    layout's mesh: the path of a semiring without a kernel entry."""
    s = B.resolve_semiring(layout.semiring)
    part = None
    for i in range(layout.row_offsets.shape[0]):
        view = B._shard_view(layout, i)
        one = gather_push(view, values, view.num_segments,
                          weight=view.weight, semiring=s)
        part = one if part is None else s.merge(part, one)
    return s.all_reduce(part, layout.mesh)


def catalog(spec: Optional[GraphSpec] = None, *, device=None,
            mesh=None) -> List[Program]:
    """Build the program catalog at ``spec`` on ``device`` (the card unless
    another device is named); with ``mesh`` (a ``DeviceMesh`` of two or
    more ranks on the device's type) also the mesh programs."""
    spec = spec or GraphSpec()
    dev = resolve_device(device)
    state = build_graph(spec, device=dev)
    progs: List[Program] = []
    caps = dict(hot_node_capacity=spec.hot_node_capacity,
                hot_edge_capacity=spec.hot_edge_capacity)

    ranks = torch.where(state.node_active, 1.0, 0.0).to(torch.float32)
    values_b = ranks[None].repeat(spec.batch, 1)

    # --- push: the propagation primitive ----------------------------------
    lay_pt = B.build_layout(state, weight="inv_out", semiring="plus_times")
    lay_mp = B.build_layout(state, weight="length", semiring="min_plus")
    progs.append(Program(
        "push[plus_times]", functools.partial(B.push, semiring="plus_times"),
        (ranks, lay_pt), spec))
    progs.append(Program(
        "push[min_plus]", functools.partial(B.push, semiring="min_plus"),
        (ranks, lay_mp), spec))
    progs.append(Program(
        "push_batched[plus_times]",
        functools.partial(B.push, semiring="plus_times"),
        (values_b, lay_pt), spec))

    # --- push_coo: the unsorted fallback (allowlisted by definition) ------
    w = torch.ones(spec.edge_capacity, dtype=torch.float32, device=dev)
    progs.append(Program(
        "push_coo[plus_times]",
        lambda v, s, d, w: B.push_coo(
            v, s, d, spec.node_capacity, weight=w, semiring="plus_times"),
        (ranks, state.src, state.dst, w), spec))

    # --- sharded push: the meshless shard loop -----------------------------
    sh_loop = build_sharded_layout(state, num_shards=spec.num_shards,
                                   weight="inv_out", semiring="plus_times")
    progs.append(Program(
        "push_sharded[loop]", functools.partial(B.push, semiring="plus_times"),
        (ranks, sh_loop), spec))

    # --- summary construction + fused queries ------------------------------
    progs.append(Program(
        "build_summary", functools.partial(build_summary, **caps),
        (state, ranks, state.node_active), spec))
    progs.append(Program(
        "build_summary[sharded]",
        functools.partial(build_summary, layout=sh_loop, **caps),
        (state, ranks, state.node_active), spec))

    pagerank = make_algorithm("pagerank")
    sssp = make_algorithm("sssp", sources=(0,))
    for algo, label in ((pagerank, "pagerank"), (sssp, "sssp")):
        progs.append(Program(
            f"fused_query_step[{label}]",
            functools.partial(fused_query_step, algo=algo, **caps),
            _query_args(state, algo), spec))
    progs.append(Program(
        "fused_query_step[pagerank,sharded]",
        functools.partial(fused_query_step, algo=pagerank, layouts=(sh_loop,),
                          **caps),
        _query_args(state, pagerank), spec))

    # the closed-loop variant: the drift estimate computed in the step
    probes = default_probe_ids(spec.node_capacity, 64, device=dev)
    progs.append(Program(
        "fused_query_step[pagerank,drift]",
        functools.partial(fused_query_step, algo=pagerank, with_drift=True,
                          **caps),
        _query_args(state, pagerank) + (probes,), spec))

    # the serving engine's wave step: batched bank + row mask + per-row
    # cold flags, exactly as GraphServingEngine.step drives it
    st, _, deg, act, r, dd = _query_args(state, pagerank)
    bank = _bank(pagerank.init_state(state), spec.batch)
    row_mask = torch.ones(spec.batch, dtype=torch.bool, device=dev)
    cold_rows = torch.ones(spec.batch, dtype=torch.bool, device=dev)
    progs.append(Program(
        "serving_wave[pagerank,batched]",
        functools.partial(fused_query_step_batched, algo=pagerank, **caps),
        (st, bank, deg, act, r, dd, row_mask, cold_rows), spec))
    progs.append(Program(
        "serving_wave[pagerank,batched,drift]",
        functools.partial(fused_query_step_batched, algo=pagerank,
                          with_drift=True, **caps),
        (st, bank, deg, act, r, dd, row_mask, cold_rows, probes), spec))

    # seed-local cold start: PPR's teleport-support seeds drive the
    # reachability sweeps instead of full-active coverage
    ppr = make_algorithm("personalized-pagerank", seeds=(1, 5))
    ppr_bank = _bank(ppr.init_state(state), spec.batch)
    progs.append(Program(
        "serving_wave[ppr,seed-cold]",
        functools.partial(fused_query_step_batched, algo=ppr, **caps),
        (st, ppr_bank, deg, act, r, dd, row_mask, cold_rows), spec))

    # --- the streaming apply step ------------------------------------------
    # add_edges writes its state in place (the reference donates it): each
    # run gets a fresh copy, and the engine's host-held edge count
    new_src = torch.zeros(spec.apply_chunk, dtype=torch.int32, device=dev)
    new_dst = torch.ones(spec.apply_chunk, dtype=torch.int32, device=dev)
    progs.append(Program(
        "engine_apply[add_edges]",
        lambda st, s, d: add_edges(st, s, d, num_edges=spec.num_edges),
        (state, new_src, new_dst), spec,
        prepare=lambda: (clone(state), new_src, new_dst)))

    # the async pipeline's variants: the preserving apply (the served
    # snapshot's buffers survive: the apply goes to a clone) and the
    # per-epoch count vector dispatched at build and read at promotion
    progs.append(Program(
        "engine_apply[add_edges,preserving]",
        lambda st, s, d: add_edges(clone(st), s, d, num_edges=spec.num_edges),
        (state, new_src, new_dst), spec))
    progs.append(Program(
        "epoch[snapshot_counts]", snapshot_counts, (state,), spec))

    # --- mesh-sharded variants ---------------------------------------------
    if mesh is not None and mesh.size() >= 2:
        sh_mesh = build_sharded_layout(
            state, mesh=mesh, num_shards=spec.num_shards, weight="inv_out",
            semiring="plus_times", placed=True)
        progs.append(Program(
            "push_sharded[segment_sum,mesh]", _segment_sum_sharded,
            (ranks, sh_mesh), spec))
        progs.append(Program(
            "push_sharded[pallas,mesh]",
            functools.partial(B.push, semiring="plus_times"),
            (ranks, sh_mesh), spec))
        progs.append(Program(
            "build_summary[sharded,mesh]",
            functools.partial(build_summary, layout=sh_mesh, **caps),
            (state, ranks, state.node_active), spec))
        progs.append(Program(
            "fused_query_step[pagerank,sharded,mesh]",
            functools.partial(fused_query_step, algo=pagerank, mesh=mesh,
                              **caps),
            _query_args(state, pagerank), spec))
    return progs


def _scenario(name: str, spec: Optional[GraphSpec], device, report,
              warm_rounds: int, autotune: str, **session_kw) -> List:
    """One canned engine loop: a PageRank session at 256 vertices and 2,048
    edge slots, ``warm_rounds`` rounds of (32 random edges, one query) to
    warm it, then two more.  The two later rounds run under a
    :class:`~repro_torch.analysis.rebuild.RebuildMonitor` (RB-REBUILD for
    any event after warm-up) and a dispatch recorder (DSP findings,
    program ``name``; at these capacities nothing is edge-scale by the
    spec, so in effect DSP-F64 and DSP-HOST-SYNC); on the card also under
    CUDA's sync debug mode (its warnings counted).  ``autotune`` is the
    session's tile mode: under ``"full"`` with an empty tuner cache the
    warm-up must time each key once and the later rounds none, so a key or
    memo that changes per epoch shows as RB-REBUILD.  ``report`` (a dict)
    receives the counts and the tiles the engine took."""
    from repro_torch.analysis.dispatch_lint import DispatchRecorder
    from repro_torch.analysis.rebuild import RebuildMonitor
    from repro_torch.api import session

    spec = spec or GraphSpec()
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n = min(spec.node_capacity, 256)
    src, dst = generators.gnm_edges(n, 512, seed=1)
    chunk = 32

    def round_(s):
        s.add_edges(rng.integers(0, n, chunk).astype(np.int32),
                    rng.integers(0, n, chunk).astype(np.int32))
        s.query()

    rec = DispatchRecorder(name, en_threshold=spec.en_threshold,
                           edge_threshold=spec.edge_threshold)
    caught = []
    with RebuildMonitor() as mon:
        with session((src, dst), algorithm="pagerank", node_capacity=n,
                     edge_capacity=2048, device=dev, autotune=autotune,
                     **session_kw) as s:
            for _ in range(warm_rounds):
                round_(s)
            warm = mon.snapshot()
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    caught = stack.enter_context(
                        warnings.catch_warnings(record=True))
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    stack.callback(torch.cuda.set_sync_debug_mode, "default")
                with rec:
                    for _ in range(2):
                        round_(s)
            if (session_kw.get("async_rebuild")
                    and s.engine._pipeline.current.epoch < 3):
                raise RuntimeError(
                    f"{name}: serving epoch "
                    f"{s.engine._pipeline.current.epoch} after "
                    f"{warm_rounds + 2} rounds; every round past the first "
                    f"should have flipped one")
            tiles = {f"{k[0]}@b{k[1]}": t for k, t in s.engine._tiles.items()}
    findings = mon.check_warm(warm, scenario=name) + rec.findings()
    if report is not None:
        report.update(
            scenario=name, autotune=autotune, tiles=tiles,
            warm_events=mon.totals(warm),
            events_after_warm=mon.totals(mon.events - warm),
            host_sync_sites=dict(rec.sync_sites),
            device_syncs=sum("called a synchronizing" in str(w.message)
                             for w in caught) if dev.type == "cuda" else None)
    return findings


def run_rebuild_scenario(spec: Optional[GraphSpec] = None, *, device=None,
                         report: Optional[dict] = None,
                         autotune: str = "off") -> List:
    """The rebuild pass's canned engine loop: one session, repeated
    same-shape update batches and queries.  Round 1 warms every library
    and tuning the loop uses (session setup, the first exact compute, the
    first streaming step); rounds 2–3 replay identical work and must add
    **zero** builds, loads or tuning runs.  Returns RB-REBUILD findings
    for anything after warm-up, and the DSP findings of rounds 2–3."""
    return _scenario("engine-loop[pagerank]", spec, device, report, 1,
                     autotune)


def run_async_rebuild_scenario(spec: Optional[GraphSpec] = None, *,
                               device=None,
                               report: Optional[dict] = None,
                               autotune: str = "off") -> List:
    """The async pipeline's rebuild pass: one ``async_rebuild=True``
    session, same-shape update batches and queries.  Rounds 1–2 warm
    every library (the fused step on the served snapshot, the preserving
    apply, ``snapshot_counts``, the layout builds dispatched per epoch;
    round 2 is the first full flip: promote 1, dispatch 2); rounds 3–4
    each flip an epoch — promote, serve, integrate, dispatch — and must
    add **zero** builds, loads or tuning runs."""
    return _scenario("engine-loop[pagerank,async]", spec, device, report, 2,
                     autotune, async_rebuild=True)
