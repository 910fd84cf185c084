"""Pod-scale dry run: what one device of a 256- or 512-card mesh would
compute, hold and send for every (architecture x shape) cell and for the
graph workload (the PyTorch port of ``repro.launch.dryrun``).

The reference lowers each cell with abstract inputs on 512 host-platform
devices and reads XLA's partitioned HLO.  Here one process is rank 0 of a
fake process group of the mesh's size (:func:`repro_torch.launch.mesh.
fake_production_mesh`: every collective returns at once and moves no
data), and the cell's real step function runs once under a dispatch cost
counter (:mod:`repro_torch.launch.dispatch_cost`), which counts each aten
op on this rank's local shards and each collective DTensor issues:

- **LM cells** (``--workload lm``): the parameters, optimizer state and
  inputs are DTensors of fake tensors (``FakeTensorMode``, CPU-typed, so
  the attention counted is the kernels' plain versions: the reference's
  dry run lowers its jnp attention too, and its model path never launches
  a Pallas kernel) at the placements of :mod:`repro_torch.launch.specs`;
  the step is the donated train step with remat, the prefill step or the
  serve step of :mod:`repro_torch.train.step`.
- **The veilgraph cell** (``--workload veilgraph``): rank 0's program runs
  for real on ``--device``: one ``fused_query_step`` of PageRank (30
  iterations, ``hot_node_capacity`` 2^21, ``hot_edge_capacity`` 2^26,
  each capped at the graph's size)
  over a seeded random graph of N = 2^25 rows and E = 2^30 edges cut over
  the mesh's 256 or 512 edge shards, with the reference's three gates
  (no ``push_coo`` call, no all-gather of a whole edge buffer, the pinned
  push shapes within 10% of their modeled bytes).  Rank 0 holds what
  the reference's placement gives it: its slot range of the edge buffers
  (built from that range alone) and the node vectors whole.  The fake
  all-reduce merges nothing, so the frontier sweeps and the pushes see
  rank 0's edges only: the record's ``query_stats`` are rank 0's view, and
  the answer is not checked here.

Every number a record holds is a model of one device, never an answer
and never a time.  Records go to ``artifacts/dryrun_torch/<mesh>/
<arch>__<shape>.json``; a cell that fails is an error record, and the run
exits 1.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_9b \\
      --shape train_4k --mesh single --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --workload veilgraph \\
      --mesh single          # on the card
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.dispatch_cost import CostCounter
from repro_torch.launch.mesh import (axis_sizes, destroy_mesh,
                                     fake_production_mesh)
from repro_torch.launch.specs import cell_spec, skip_reason
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.sharding.rules import (axis_rules, local_index,
                                        rules_for_mesh, to_placements)
from repro_torch.train.optimizer import AdamWState

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: what the LM records say of the attention they count
ATTENTION_NOTE = ("attention counted through the flash and decode "
                  "kernels' plain versions (CPU-typed fake tensors), as the "
                  "reference's dry run lowers its jnp attention")


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors (dicts, an
    ``AdamWState``) and its spec tree."""
    if isinstance(tree, AdamWState):
        return AdamWState(*(_map(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def materialize(tree, specs, mesh):
    """A tree of ``meta`` tensors as DTensors placed by their specs on
    ``mesh``, each rank's shard an empty tensor of the mesh's device type
    (fake under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        pl = to_placements(spec, mesh)
        idx = local_index(t.shape, mesh, pl)
        local = torch.empty([s.stop - s.start for s in idx], dtype=t.dtype,
                            device=mesh.device_type)
        return DTensor.from_local(
            local, mesh, pl, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride(),
            run_check=False)
    return _map(one, tree, specs)


def _place_outputs(out, specs, mesh):
    """The step's outputs redistributed to the cell's output specs (the
    reference's ``out_shardings``)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(placements=to_placements(spec, mesh))
    return tuple(_map(one, o, s) for o, s in zip(out, specs))


def _chips(mesh) -> int:
    return math.prod(mesh.mesh.shape)


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             verbose: bool = True, *, cfg=None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One LM cell on ``mesh`` (a ``DeviceMesh`` of the CPU device type on a
    fake group): its record, with status ``ok`` (the :class:`~repro_torch.
    launch.roofline.Roofline` of the step's counts), ``skipped`` (the
    reference's reason) or ``error`` (the exception and its traceback).
    ``cfg``/``shape`` replace the arch's config and the named shape (a
    smoke model, a small shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason is not None:
        rec.update(status="skipped", reason=reason)
        return rec
    rules = rules_for_mesh(mesh)
    sizes = axis_sizes(mesh)
    t0 = time.time()
    try:
        with axis_rules(rules), FakeTensorMode(allow_non_fake_inputs=True):
            cell = cell_spec(cfg, arch, shape, rules, sizes)
            args = tuple(materialize(a, s, mesh)
                         for a, s in zip(cell.args, cell.in_pspecs))
            arg_bytes = _local_bytes(args)
            with CostCounter() as cc:
                raw = cell.step_fn(*args)
                out = _place_outputs(raw, cell.out_pspecs, mesh)
            donated = {id(t) for i in cell.donate for t in _leaves(args[i])}
            alias = sum(_local_bytes(t) for t in _leaves(raw)
                        if id(t) in donated)
            mem = {"argument_bytes": arg_bytes,
                   "output_bytes": _local_bytes(out), "alias_bytes": alias,
                   "temp_bytes": cc.cost.peak_bytes}
            del raw, out, args
        rf = RL.analyze(cc.cost, arch=arch, shape=shape, mesh_name=mesh_name,
                        chips=_chips(mesh), cfg=cfg, memory_stats=mem)
        if verbose:
            print(f"  memory: args={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"out={mem['output_bytes'] / 2**30:.2f}GiB "
                  f"temp={mem['temp_bytes'] / 2**30:.2f}GiB (per device)")
            print(f"  counts: flops={cc.cost.flops:.3e} "
                  f"bytes={cc.cost.bytes:.3e} collectives="
                  f"{dict(cc.cost.coll_counts)} (per device)")
            print(f"  roofline: compute={rf.compute_s * 1e3:.2f}ms "
                  f"memory={rf.memory_s * 1e3:.2f}ms "
                  f"collective={rf.collective_s * 1e3:.2f}ms "
                  f"dominant={rf.dominant} "
                  f"useful_ratio={rf.useful_flops_ratio:.3f} "
                  f"roofline_frac={rf.roofline_fraction:.3f}")
        rec.update(status="ok", trace_s=round(time.time() - t0, 1),
                   ops=cc.cost.ops, matmul_flops=cc.cost.matmul_flops,
                   coll_max=dict(cc.cost.coll_max), note=ATTENTION_NOTE,
                   roofline=rf.to_dict())
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


#: what the graph record says of its query stats
GRAPH_NOTE = ("rank 0 holds its slot range of the edge buffers and the node "
              "vectors whole; the fake group's collectives return at once, "
              "so query_stats are rank 0's view (its sweeps and pushes over "
              "its own edges)")

#: the slots the degree count streams through at a time
DEGREE_CHUNK = 1 << 26


def random_edges(lo: int, hi: int, nodes: int, *, device,
                 seed: int = 0):
    """``(src, dst)`` int32 of the edge slots ``[lo, hi)`` of the seeded
    random graph: each endpoint a function of (seed, slot, which end), a
    32-bit integer hash (``lowbias32``) of the slot's counter taken modulo
    ``nodes``, so that any slot range is the same slots of the whole
    graph, on any device."""
    mask = 0xFFFFFFFF
    slot = torch.arange(lo, hi, dtype=torch.int64, device=device)

    def mul32(x, c):
        # x·c mod 2^32 in int64 without overflow: c in two 16-bit halves
        return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & mask

    def end(which: int) -> torch.Tensor:
        x = (slot * 2 + which + seed * 0x9E3779B9) & mask
        x = x ^ (x >> 16)
        x = mul32(x, 0x7FEB352D)
        x = x ^ (x >> 15)
        x = mul32(x, 0x846CA68B)
        x = x ^ (x >> 16)
        return (x % nodes).to(torch.int32)
    return end(0), end(1)


def _streamed_degrees(nodes: int, edges: int, *, device, seed: int):
    """``(out_deg, in_deg, deg_prev, active_prev)`` of the whole random
    graph, counted from chunks of :data:`DEGREE_CHUNK` slots made and
    dropped in turn (a loader would all-reduce its ranks' counts): the
    degrees now and the out-degrees and activity before the last 1% of
    the edges (the update batch a query follows)."""
    old = edges - edges // 100
    zeros = lambda: torch.zeros(nodes, dtype=torch.int32, device=device)
    out_deg, in_deg, prev_out, prev_in = (zeros() for _ in range(4))
    for lo in range(0, edges, DEGREE_CHUNK):
        hi = min(lo + DEGREE_CHUNK, edges)
        src, dst = random_edges(lo, hi, nodes, device=device, seed=seed)
        count = lambda ids: torch.bincount(
            ids, minlength=nodes).to(torch.int32)
        out_deg += count(src)
        in_deg += count(dst)
        if lo < old:
            k = min(hi, old) - lo
            prev_out += count(src[:k])
            prev_in += count(dst[:k])
        del src, dst
    return out_deg, in_deg, prev_out, (prev_out + prev_in) > 0


def random_graph(nodes: int, edges: int, mesh, *, seed: int = 0):
    """This rank's part of a seeded uniform random graph of ``edges`` live
    edges over ``nodes`` vertices (:func:`random_edges`), made on the
    mesh's device as the reference's ``graph_shardings`` place it: its
    slot range of the edge buffers, built from that range alone
    (:func:`repro_torch.graph.partition.from_edge_slice`), the node
    vectors whole; and the out-degrees and active flags before the last
    1% of its edges (the update batch a query follows).  The degrees come
    from streaming the whole graph in chunks."""
    from repro_torch.graph.partition import edge_slot_range, from_edge_slice

    device = torch.device(mesh.device_type)
    out_deg, in_deg, deg_prev, active_prev = _streamed_degrees(
        nodes, edges, device=device, seed=seed)
    lo, hi = edge_slot_range(mesh, edges)
    src, dst = random_edges(lo, hi, nodes, device=device, seed=seed)
    state = from_edge_slice(mesh, src, dst, node_capacity=nodes,
                            edge_capacity=edges, num_edges=edges,
                            degrees=(out_deg, in_deg))
    return state, deg_prev, active_prev


def _resolve_backend(backend: str, device: torch.device) -> str:
    """The per-shard push path: the SpMV kernels on the card, their plain
    versions (the sorted segment reduce) on the CPU; ``pallas`` asks for
    the kernels and ``segment_sum`` for the plain path, and each raises on
    the other device (the port picks the path by the device)."""
    path = "cuda-kernels" if device.type == "cuda" else "segment_sum"
    want = {"pallas": "cuda-kernels", "segment_sum": "segment_sum"}
    if backend != "auto" and want[backend] != path:
        raise ValueError(f"--backend {backend} runs on "
                         f"{'the card' if backend == 'pallas' else 'the CPU'}"
                         f"; this run is on {device}")
    return path


def run_veilgraph_cell(mesh, mesh_name: str, *, nodes: int = 2**25,
                       edges: int = 2**30, backend: str = "auto",
                       seed: int = 0) -> dict:
    """The paper's workload at pod scale: rank 0's one fused
    summarized-PageRank query over a ``nodes`` x ``edges`` streaming graph
    through the sharded path (``fused_query_step`` with ``mesh=``, every
    O(E) pass a per-shard push and the semiring's all-reduce, the summary
    by the bucket exchange), run for real on the mesh's device under the
    dispatch cost counter, with the reference's three gates:

    - zero ``push_coo`` calls;
    - no all-gather of a whole ``4·E`` edge buffer
      (:func:`repro_torch.analysis.memory_audit.budgets_for_graph`);
    - every pinned push shape within 10% of its committed modeled HBM
      bytes (:func:`repro_torch.launch.roofline.check_push_baselines`).

    The state is rank 0's as the reference's ``in_shardings`` place it
    (:func:`random_graph`: its slot range of the edge buffers, the node
    vectors whole).  The record holds the per-device
    counts, the SpMV launches, the memory (argument bytes: the edge slice,
    the node vectors and the algorithm state this rank holds; temporaries:
    the counter's peak of what the step made) and a
    :class:`~repro_torch.launch.roofline.Roofline` at the card's rates.
    Every collective of the fake group returns at once, so the record's
    ``query_stats`` are rank 0's view (its frontier sweeps and pushes
    over its own edges), as the pushes' all-reduce already were."""
    from repro_torch.analysis.memory_audit import audit_cost, \
        budgets_for_graph
    from repro_torch.core import backend as B
    from repro_torch.core.algorithm import make_algorithm
    from repro_torch.core.fused import fused_query_step
    from repro_torch.graph.graph import edge_slice
    from repro_torch.kernels.spmv import kernel as K

    device = torch.device(mesh.device_type)
    rec: Dict[str, Any] = {"arch": "veilgraph-pagerank",
                           "shape": f"N={nodes},E={edges}", "mesh": mesh_name}
    t0 = time.time()
    try:
        backend_r = _resolve_backend(backend, device)
        state, deg_prev, active_prev = random_graph(nodes, edges, mesh,
                                                    seed=seed)
        algo = make_algorithm("pagerank", num_iters=30, tol=1e-6)
        algo_state = algo.init_state(state)
        # the reference's capacities, capped at the graph's own size (a
        # small graph in a test would otherwise exchange buckets sized
        # for 2^26 hot edges)
        caps = dict(hot_node_capacity=min(2**21, nodes),
                    hot_edge_capacity=min(2**26, edges))
        scalar = lambda v: torch.tensor(v, dtype=torch.float32,
                                        device=device)
        arg_bytes = _local_bytes((state, algo_state, deg_prev, active_prev))
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_setup = time.time() - t0
        kernels = (K.spmv_push, K.spmv_reduce_push)
        before = [k.launches for k in kernels]
        B.reset_trace_counts()
        t1 = time.time()
        with CostCounter() as cc:
            new_state, stats = fused_query_step(
                state, algo_state, deg_prev, active_prev, scalar(0.2),
                scalar(0.05), algo=algo, mesh=mesh, **caps)
            if device.type == "cuda":
                torch.cuda.synchronize()
        t_step = time.time() - t1
        push_coo = B.trace_count("push_coo")
        if push_coo:
            raise AssertionError(
                f"sharded path made {push_coo} unsorted push_coo call(s); "
                f"the hot loop must be cached-layout pushes only")
        audit = audit_cost(cc.cost, budgets_for_graph(edges),
                           program="veilgraph-cell[sharded]")
        if audit:
            raise AssertionError("collective audit failed for the sharded "
                                 "cell:\n" + "\n".join(f"  {f}"
                                                       for f in audit))
        push_checks = RL.check_push_baselines()
        print(f"  push roofline: {len(push_checks)} pinned shapes within "
              f"10% of baseline HBM bytes")
        launches = {k.__name__: k.launches - b
                    for k, b in zip(kernels, before)}
        stats_host = {k: float(v) for k, v in zip(
            stats._fields, torch.stack([torch.as_tensor(x).float().reshape(())
                                        .to(device) for x in stats]).tolist())}
        # the paper's useful work: 2 flops an edge visit over the O(E)
        # selection passes and 30 iterations over the hot edge capacity
        useful = 2.0 * (6 * edges + 30 * caps["hot_edge_capacity"])
        mem = {"argument_bytes": arg_bytes,
               "output_bytes": _local_bytes(new_state),
               "temp_bytes": cc.cost.peak_bytes}
        rf = RL.Roofline(
            arch="veilgraph-pagerank", shape=rec["shape"], mesh=mesh_name,
            chips=_chips(mesh), flops_per_device=cc.cost.flops,
            bytes_per_device=cc.cost.bytes,
            collective_bytes_per_device=cc.cost.collective_bytes,
            collective_breakdown=RL.collective_bytes(cc.cost),
            model_flops=useful, memory_stats=mem)
        rec.update(status="ok", setup_s=round(t_setup, 1),
                   step_s=round(t_step, 3), backend=backend_r,
                   push_coo_calls=push_coo,
                   replicated_edge_buffer_gathers=0,
                   max_all_gather_bytes=cc.cost.coll_max.get("all-gather",
                                                             0.0),
                   coll_max=dict(cc.cost.coll_max), launches=launches,
                   query_stats=stats_host, note=GRAPH_NOTE,
                   edge_slots_held=edge_slice(state).src.shape[0],
                   push_roofline=push_checks,
                   roofline=rf.to_dict())
        print(f"  veilgraph memory: args={arg_bytes / 2**30:.2f}GiB "
              f"temp={cc.cost.peak_bytes / 2**30:.2f}GiB; "
              f"flops={cc.cost.flops:.3e} bytes={cc.cost.bytes:.3e} "
              f"collectives={dict(cc.cost.coll)}; launches={launches}")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def _cell_in_process(arch: str, shape_name: str, multi: bool) -> dict:
    """One LM cell in a process of its own: its own fake group and mesh
    (CPU-typed), the record, the group ended."""
    mesh = fake_production_mesh(multi_pod=multi, device_type="cpu")
    try:
        return run_cell(arch, shape_name, mesh,
                        "multi" if multi else "single", verbose=False)
    finally:
        destroy_mesh()


def _lm_cells(cells, multi: bool, out_dir: Path) -> int:
    """Every LM cell, each in a process of its own, a few at a time (a
    cell is one core's Python dispatch: a 32k prefill walks the plain
    attention's tiles for many minutes); writes each record as it comes
    and returns the failures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    workers = max(1, min(4, (os.cpu_count() or 1) // 2, len(cells)))
    failures = 0
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {ex.submit(_cell_in_process, a, s, multi): (a, s)
                   for a, s in cells}
        for fut in as_completed(futures):
            arch, shape_name = futures[fut]
            rec = fut.result()
            (out_dir / f"{arch}__{shape_name}.json").write_text(
                json.dumps(rec, indent=1))
            tag = f"[{arch} x {shape_name}]"
            if rec["status"] == "error":
                failures += 1
                print(f"{tag} ERROR: {rec['error']}", flush=True)
            elif rec["status"] == "skipped":
                print(f"{tag} skipped: {rec['reason']}", flush=True)
            else:
                rf = rec["roofline"]
                print(f"{tag} ok (traced in {rec['trace_s']}s): dominant "
                      f"{rf['dominant']}, compute {rf['compute_s']:.4g}s "
                      f"memory {rf['memory_s']:.4g}s collective "
                      f"{rf['collective_s']:.4g}s", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workload", type=str, default="lm",
                    choices=["lm", "veilgraph"])
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "segment_sum"],
                    help="per-shard push path of the veilgraph workload "
                    "(auto: the kernels on the card, the plain path on the "
                    "CPU)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the veilgraph cell runs (default: the "
                    "card); LM cells are traced on CPU-typed fake tensors")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    multi = args.mesh == "multi"
    out_dir = ART / args.mesh
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if args.workload == "lm":
        if args.all:
            cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
        else:
            arch = ALIASES.get(args.arch, args.arch)
            shapes = [args.shape] if args.shape else list(SHAPES)
            cells = [(arch, s) for s in shapes]
        print(f"mesh {args.mesh}: {'512' if multi else '256'} ranks, each "
              f"cell as rank 0 of a fake group of its own (CPU-typed fake "
              f"tensors)", flush=True)
        failures = _lm_cells(cells, multi, out_dir)
        print(f"done: {len(cells)} cells, {failures} failures, "
              f"{time.time() - t0:.1f}s")
        return 1 if failures else 0
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    mesh = fake_production_mesh(multi_pod=multi, device_type=device.type)
    print(f"mesh {args.mesh}: {axis_sizes(mesh)} ({_chips(mesh)} ranks, "
          f"rank 0 of a fake group on {mesh.device_type})")
    try:
        rec = run_veilgraph_cell(mesh, args.mesh, backend=args.backend)
    finally:
        destroy_mesh()
    (out_dir / "veilgraph__pagerank.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in ("arch", "status")}))
    if rec["status"] == "error":
        print(f"  ERROR: {rec['error']}", flush=True)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
