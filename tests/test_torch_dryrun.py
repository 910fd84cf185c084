"""The pod-scale dry run (``repro_torch.launch``: ``specs``,
``dispatch_cost``, ``roofline``, ``dryrun``) on the CPU.

- **Parity with the reference**, exact: ``skip_reason``,
  ``text_and_prefix_lens`` and ``model_flops_for`` for every arch and shape
  of ``SHAPES``; the shapes and dtypes of ``input_specs`` against the
  reference's ``ShapeDtypeStruct`` stand-ins (its decode cache from
  ``jax.eval_shape``); ``input_pspecs``, ``cache_pspecs`` and
  ``param_pspecs_guarded`` at the single- and multi-pod axis sizes against
  the reference's ``PartitionSpec``\\ s.
- **Matmul flops against the reference's dot flops**: one smoke train,
  prefill and decode cell of the dense, MoE and SSM families, without a
  mesh.  The oracle is the reference's meshless lowering (``jax.jit(...)
  .lower().compile()``) read by ``repro.launch.hlo_cost.parse_module``
  and its dot rule, each while body times its ``known_trip_count``.  The
  dense and MoE cells count the same flops (measured: equal to 1e-12);
  the SSM cells are held within 3% (measured: train 2.8%, prefill 2.4%,
  decode 0.9% below), because the port's SSD contracts B and C once a
  group where the reference's einsums broadcast them to every head.
  Elementwise flops and bytes are not compared: the port dispatches
  eagerly where XLA fuses.
- **The model on DTensor parameters**: every family's smoke prefill (its
  forward, with the caches) and one dense train step on a (2, 2) fake
  mesh, and a dense prefill on the (2, 2, 2) one, each ``ok``; the
  counter's per-device counts are of shards.
- **The veilgraph cell** at small sizes on both fake meshes: its three
  gates pass, and rank 0 holds its slot range of the edge buffers and the
  node vectors whole (the reference's ``graph_shardings``); a generated
  slice is the same slots of the whole generated graph; a sliced state's
  placed layout is the whole-state build's rows; rebalancing a sliced
  state raises.

The fake process group is started and ended by a module fixture (one per
mesh shape), since xdist runs a file in one process.
"""

import re

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as JCF
from repro.launch import hlo_cost as JH
from repro.launch import roofline as JRL
from repro.launch import specs as JS
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import ShapeConfig as JShape
from repro.sharding import rules as JR

import repro_torch.configs as TCF
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.dispatch_cost import CostCounter
from repro_torch.launch.mesh import destroy_mesh, init_fake_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.sharding import rules as TR
from repro_torch.train.optimizer import AdamWState

SIZES = {"single": {"data": 16, "model": 16},
         "multi": {"pod": 2, "data": 16, "model": 16}}
TABLES = {"single": (TR.RULES_SINGLE_POD, JR.RULES_SINGLE_POD),
          "multi": (TR.RULES_MULTI_POD, JR.RULES_MULTI_POD)}


def _paths(tree, prefix=()):
    """``{path: leaf}`` of a nested dict (jax and torch leaves alike)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", TCF.ARCH_IDS)
def test_specs_match_the_reference(arch):
    tcfg, jcfg = TCF.get_config(arch), JCF.get_config(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert SP.skip_reason(tcfg, shape) == JS.skip_reason(jcfg, jshape)
        assert SP.text_and_prefix_lens(tcfg, shape) == \
            JS.text_and_prefix_lens(jcfg, jshape)
        assert RL.model_flops_for(tcfg, shape) == \
            JRL.model_flops_for(jcfg, jshape)
        got, want = SP.input_specs(tcfg, shape), JS.input_specs(jcfg, jshape)
        got_l, want_l = _paths(got), _paths(want)
        assert got_l.keys() == want_l.keys()
        for path, leaf in want_l.items():
            assert tuple(got_l[path].shape) == tuple(leaf.shape), path
            assert _dtype(got_l[path]) == _dtype(leaf), path
        for mesh_name, sizes in SIZES.items():
            trules, jrules = TABLES[mesh_name]
            gp = _paths(SP.input_pspecs(tcfg, shape, got, trules, sizes))
            wp = _paths(JS.input_pspecs(jcfg, jshape, want, jrules, sizes))
            assert gp.keys() == wp.keys()
            for path, spec in wp.items():
                assert gp[path] == tuple(spec), (path, mesh_name)
    for mesh_name, sizes in SIZES.items():
        trules, jrules = TABLES[mesh_name]
        got = _paths(SP.param_pspecs_guarded(tcfg, trules, sizes))
        want = _paths(JS.param_pspecs_guarded(jcfg, jrules, sizes))
        assert got.keys() == want.keys()
        for path, spec in want.items():
            assert got[path] == tuple(spec), (path, mesh_name)


# ---------------------------------------------------------------------------
# matmul flops against the reference's dot flops
# ---------------------------------------------------------------------------


def _ref_dot_flops(name, comps, memo) -> float:
    """The dot flops of HLO computation ``name`` (``hlo_cost``'s dot rule),
    each while body and condition times its known trip count."""
    if name in memo:
        return memo[name]
    memo[name] = 0.0
    comp = comps.get(name)
    total = 0.0
    for ins in (comp.instrs if comp is not None else ()):
        if ins.opcode == "while":
            trip = JH._TRIP_RE.search(ins.tail)
            sub = sum(_ref_dot_flops(c, comps, memo) for c in (
                ins.attr(r"body=%?([\w.\-]+)"),
                ins.attr(r"condition=%?([\w.\-]+)")) if c)
            total += (int(trip.group(1)) if trip else 1) * sub
        elif ins.opcode == "dot":
            total += JH._dot_flops(ins, comp)
        else:
            callees = re.findall(r"(?:calls|to_apply)=%?([\w.\-]+)", ins.tail)
            for grp in re.findall(r"branch_computations=\{([^}]*)\}",
                                  ins.tail):
                callees += re.findall(r"%([\w.\-]+)", grp)
            total += sum(_ref_dot_flops(c, comps, memo) for c in callees)
    memo[name] = total
    return total


def _fake(tree):
    if isinstance(tree, AdamWState):
        return AdamWState(*(_fake(t) for t in tree))
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype)


#: (arch, relative tolerance): dense and MoE count the reference's dots;
#: the SSM's per-group B and C products sit below its per-head ones
FLOP_CELLS = (("qwen2_0_5b", 1e-12), ("mixtral_8x22b", 1e-12),
              ("mamba2_2_7b", 0.03))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,rtol", FLOP_CELLS)
def test_matmul_flops_match_the_reference_dots(arch, rtol, kind):
    jcell = JS.cell_spec(JCF.get_smoke_config(arch), arch,
                         JShape(kind, kind, 64, 2), {}, {})
    compiled = jax.jit(jcell.step_fn, donate_argnums=jcell.donate).lower(
        *jcell.args_sds).compile()
    comps, entry = JH.parse_module(compiled.as_text())
    want = _ref_dot_flops(entry, comps, {})
    cell = SP.cell_spec(TCF.get_smoke_config(arch), arch,
                        ShapeConfig(kind, kind, 64, 2), {}, {})
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(_fake(a) for a in cell.args)
        with CostCounter() as cc:
            cell.step_fn(*args)
    assert want > 0
    assert cc.cost.matmul_flops == pytest.approx(want, rel=rtol)


# ---------------------------------------------------------------------------
# the model on DTensor parameters, and the graph cell, on fake meshes
# ---------------------------------------------------------------------------

MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", params=sorted(MESHES))
def fake_mesh(request):
    shape, names = MESHES[request.param]
    mesh = init_fake_mesh(shape, names, device_type="cpu")
    yield request.param, mesh
    destroy_mesh()


#: one smoke config of each family: dense GQA, MLA, hybrid, encoder-decoder,
#: MoE, SSM and the vision frontend
FAMILIES = ("qwen2_0_5b", "minicpm3_4b", "zamba2_7b", "seamless_m4t_large_v2",
            "mixtral_8x22b", "mamba2_2_7b", "internvl2_2b")


def _cell(arch, kind, mesh, name):
    return D.run_cell(arch, kind, mesh, name, verbose=False,
                      cfg=TCF.get_smoke_config(arch),
                      shape=ShapeConfig(kind, kind, 64, 4))


def test_every_family_runs_on_dtensor_parameters(fake_mesh):
    name, mesh = fake_mesh
    cells = [(a, "prefill") for a in FAMILIES] + [("qwen2_0_5b", "train")]
    if name == "multi":
        cells = [("qwen2_0_5b", "prefill")]
    for arch, kind in cells:
        rec = _cell(arch, kind, mesh, name)
        assert rec["status"] == "ok", (arch, kind, rec.get("traceback"))
        rf = rec["roofline"]
        assert rf["chips"] == mesh.size() and rf["flops_per_device"] > 0
        assert rf["collective_breakdown"]["counts"], (arch, kind)
        assert rf["memory_stats"]["argument_bytes"] > 0
        assert rf["rates"]["peak_flops_bf16"] == 989e12


def test_counts_are_of_local_shards(fake_mesh):
    # x [B, D] with B over data times W [D, F] with F over model: one rank
    # multiplies a quarter of the product (on the pod mesh too, whose pod
    # axis neither splits)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    name, mesh = fake_mesh
    b, d, f = 8, 16, 32
    x_pl = [Replicate()] * mesh.ndim
    w_pl = [Replicate()] * mesh.ndim
    x_pl[mesh.mesh_dim_names.index("data")] = Shard(0)
    w_pl[mesh.mesh_dim_names.index("model")] = Shard(1)
    with FakeTensorMode():
        x = D.materialize(torch.empty(b, d, device="meta"), ("data",), mesh)
        w = D.materialize(torch.empty(d, f, device="meta"),
                          (None, "model"), mesh)
        assert tuple(x.placements) == tuple(x_pl)
        assert tuple(w.placements) == tuple(w_pl)
        with CostCounter() as cc:
            y = x @ w
    assert isinstance(y, DTensor)
    assert cc.cost.matmul_flops == 2 * b * d * f / 4
    assert cc.cost.coll == {}


def test_veilgraph_cell_passes_its_gates(fake_mesh):
    name, mesh = fake_mesh
    rec = D.run_veilgraph_cell(mesh, name, nodes=2**12, edges=2**16)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["push_coo_calls"] == 0 and rec["max_all_gather_bytes"] == 0
    assert all(r["hbm_ratio_vs_baseline"] <= 1.10
               for r in rec["push_roofline"].values())
    rf = rec["roofline"]
    coll = rf["collective_breakdown"]
    # every O(E) sweep meets in an all-reduce of an [N] vector, the
    # summary's buckets in all-to-alls
    assert coll["counts"]["all-reduce"] >= 1
    assert coll["counts"]["all-to-all"] == 3
    assert rec["coll_max"]["all-reduce"] >= 4 * 2**12
    # rank 0 holds what the reference's placement gives it: its E / R
    # slots of the edge buffers (9 B a slot) and the node vectors whole
    # (18 B a vertex: the degrees, the activity, the ranks and the
    # snapshot), well under one whole-state edge buffer
    slots = 2**16 // mesh.size()
    assert rec["edge_slots_held"] == slots
    assert rf["memory_stats"]["argument_bytes"] == 9 * slots + 18 * 2**12 + 4
    assert rf["memory_stats"]["argument_bytes"] < 4 * 2**16
    assert rec["query_stats"]["num_hot"] > 0
    assert rec["backend"] == "segment_sum"
    with pytest.raises(ValueError, match="the card"):
        D._resolve_backend("pallas", torch.device("cpu"))


def test_generated_slice_is_the_whole_graphs_slots(fake_mesh):
    # rank 0's slice, made from its slot range alone, is the same slots of
    # the whole generated graph, and its streamed degrees are the whole
    # graph's
    from repro_torch.graph.graph import edge_slice
    from repro_torch.graph.partition import edge_slot_range

    _, mesh = fake_mesh
    nodes, edges = 2**10, 2**14
    src, dst = D.random_edges(0, edges, nodes, device="cpu", seed=3)
    part, deg_prev, active_prev = D.random_graph(nodes, edges, mesh, seed=3)
    lo, hi = edge_slot_range(mesh, edges)
    assert (lo, hi) == (0, edges // mesh.size())
    sl = edge_slice(part)
    assert part.edge_capacity == edges and sl.lo == lo
    assert torch.equal(sl.src, src[lo:hi]) and torch.equal(sl.dst,
                                                           dst[lo:hi])
    assert bool(sl.mask.all()) and int(part.num_edges) == edges
    count = lambda ids: torch.bincount(ids, minlength=nodes).to(torch.int32)
    assert torch.equal(part.out_deg, count(src))
    assert torch.equal(part.in_deg, count(dst))
    assert torch.equal(part.node_active, (count(src) + count(dst)) > 0)
    old = edges - edges // 100
    assert torch.equal(deg_prev, count(src[:old]))
    assert torch.equal(active_prev,
                       (count(src[:old]) + count(dst[:old])) > 0)
    # any range is the same slots; another seed is another graph
    mid = D.random_edges(5000, 5100, nodes, device="cpu", seed=3)
    assert torch.equal(mid[0], src[5000:5100])
    assert not torch.equal(D.random_edges(0, edges, nodes, device="cpu",
                                          seed=4)[0], src)


def test_sliced_state_layout_rows_and_rebalance(fake_mesh):
    # a sliced state's placed layout is, field by field, the whole-state
    # build's rows of this rank; a rebalanced assignment would move edges
    # between the ranks' slices, which raises
    from repro_torch.graph import partition as TP
    from repro_torch.graph.graph import from_edges

    _, mesh = fake_mesh
    nodes, edges = 2**10, 2**14
    src, dst = D.random_edges(0, edges, nodes, device="cpu", seed=5)
    whole = from_edges(src.numpy(), dst.numpy(), nodes, edges, device="cpu")
    part, _, _ = D.random_graph(nodes, edges, mesh, seed=5)
    placed = TP.place_graph_state(whole, mesh)
    assert TP.edge_slot_range(mesh, edges)[1] == placed.src.to_local(
        ).shape[0] == part.src.to_local().shape[0]
    for spec in (dict(weight="inv_out"),
                 dict(weight="unit", reverse=True, semiring="min_min")):
        for shards in (mesh.size(), 2 * mesh.size()):
            want = TP.build_sharded_layout(whole, mesh=mesh,
                                           num_shards=shards, placed=True,
                                           **spec)
            for st in (part, placed):
                got = TP.build_sharded_layout(st, mesh=mesh,
                                              num_shards=shards,
                                              placed=True, **spec)
                assert got.total_shards == shards
                for f in ("src", "dst", "weight", "valid", "row_offsets",
                          "order", "rank"):
                    a, b = getattr(got, f), getattr(want, f)
                    assert (a is None and b is None) or torch.equal(a, b), f
    with pytest.raises(ValueError, match="its own rows"):
        TP.build_sharded_layout(part, mesh=mesh)
    with pytest.raises(NotImplementedError, match="queue 1 entry 15"):
        TP.rebalance_sharded_layout(part, num_shards=mesh.size())
    slots = torch.from_numpy(TP.shard_slots(edges, mesh.size()))
    with pytest.raises(NotImplementedError, match="queue 1 entry 15"):
        TP.build_sharded_layout(part, mesh=mesh, slots=slots, placed=True)
    # the whole state still rebalances
    assert TP.rebalance_sharded_layout(whole, num_shards=mesh.size())[1] in (
        True, False)


@pytest.mark.parametrize("fake_mesh", ["single"], indirect=True)
def test_remat_recompute_keeps_the_sharding_rules(fake_mesh):
    # autograd runs a card's backward, remat's recompute with it, on a
    # thread of its own, which the thread-local rules do not reach: the
    # recompute carries the forward's (its `ws` redistributions), so a
    # backward run outside the rules gives the gradients' placements of
    # one run inside them
    from repro_torch.models.transformer import lm_forward
    from repro_torch.train.optimizer import tree_leaves

    name, mesh = fake_mesh
    cfg = TCF.get_smoke_config("qwen2_0_5b")
    rules = TR.rules_for_mesh(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    cell = SP.cell_spec(cfg, "qwen2_0_5b", ShapeConfig("t", "train", 16, 4),
                        rules, sizes)
    placements = []
    with FakeTensorMode(allow_non_fake_inputs=True):
        for inside in (True, False):
            params = D.materialize(cell.args[0], cell.in_pspecs[0], mesh)
            leaves = [t.requires_grad_() for t in tree_leaves(params)]
            tokens = D.materialize(cell.args[2]["tokens"],
                                   cell.in_pspecs[2]["tokens"], mesh)
            with TR.axis_rules(rules):
                loss = lm_forward(params, cfg, tokens,
                                  remat=True).float().sum()
                if inside:
                    grads = torch.autograd.grad(loss, leaves)
            if not inside:
                grads = torch.autograd.grad(loss, leaves)
            placements.append([tuple(g.placements) for g in grads])
    assert placements[0] == placements[1]
