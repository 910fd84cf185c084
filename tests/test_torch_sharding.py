"""The sharding substrate of training in the port against the JAX
reference: the rule tables and specs, the parameters' logical names,
``abstract_params`` and ``param_pspecs``, the int8 compressed mean, the
sharded checkpoint and ``elastic_reshard``, ``shard_batch`` and the graph
buffers' shardings.

One process holds a 1-rank gloo group (a module fixture, destroyed at its
end) for the 1 x 1 ``("data", "model")`` mesh; one 2-rank
``torch.multiprocessing.spawn`` (the rank body in
``tests/_sharding_ranks.py``, which imports no JAX) runs every multi-rank
check.  The reference's ``compressed_mean`` on two forced host devices
fails on this jax (its ``shard_map`` body's indexing is refused), so the
two ranks are held to a numpy transcription of its ``leaf``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.configs as JCF
from repro.graph.graph import from_edges as jfrom_edges
from repro.graph.partition import graph_shardings as jgraph_shardings
from repro.models import params as JPAR
from repro.sharding import rules as JR
from repro.train import checkpoint as JCK
from repro.train import compression as JCMP

import repro_torch.configs as TCF
from repro_torch.data.pipeline import shard_batch
from repro_torch.graph.graph import from_edges
from repro_torch.graph.partition import edge_sharding, graph_shardings
from repro_torch.launch.mesh import (axis_sizes, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import params as TPAR
from repro_torch.sharding import rules as TR
from repro_torch.train import compression as TCMP
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import elastic_reshard

TABLES = ("RULES_SINGLE_POD", "RULES_MULTI_POD", "RULES_SINGLE_POD_ZERO1")
SIZES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


@pytest.fixture(scope="module")
def mesh():
    """The local 1 x 1 ("data", "model") mesh on a 1-rank gloo group."""
    m = make_local_mesh("cpu")
    yield m
    dist.destroy_process_group()


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    # every leaf's logical names give the reference's spec under each
    # table, plain and guarded at the production meshes' sizes
    jcfg, tcfg = JCF.get_config(arch), TCF.get_config(arch)
    jdefs = JPAR.build_defs(jcfg)
    tdefs = TPAR.build_defs(tcfg)
    paths = [p for p, _ in _leaves(tdefs)]
    assert sorted(paths) == sorted(
        tuple(k.key for k in p) for p, _ in jax.tree_util.tree_leaves_with_path(
            jdefs, is_leaf=lambda x: isinstance(x, JPAR.ParamDef)))
    for table in TABLES:
        jrules, trules = getattr(JR, table), getattr(TR, table)
        assert jrules == trules
        jspecs = JPAR.param_pspecs(jcfg, jrules)
        tspecs = TPAR.param_pspecs(tcfg, trules)
        for path in paths:
            jd, td = _at(jdefs, path), _at(tdefs, path)
            assert td.logical == jd.logical, path
            assert _at(tspecs, path) == tuple(_at(jspecs, path)), path
            for sizes in SIZES:
                want = JR.guarded_pspec(jd.shape, jd.logical, jrules, sizes)
                got = TR.guarded_pspec(td.shape, td.logical, trules, sizes)
                assert got == tuple(want), (path, table, sizes)


@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_abstract_params_match_the_reference(arch):
    want = JPAR.abstract_params(JCF.get_config(arch))
    got = TPAR.abstract_params(TCF.get_config(arch))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        t = _at(got, tuple(k.key for k in path))
        assert t.device.type == "meta"
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{leaf.dtype}"


def test_logical_specs_and_rules_context():
    logical = ("batch", "ctx", "heads", None, "edges")
    for table in TABLES:
        assert TR.logical_to_pspec(logical, getattr(TR, table)) == tuple(
            JR.logical_to_pspec(logical, getattr(JR, table)))
    assert TR.logical_to_pspec(logical) == ()
    with TR.axis_rules(TR.RULES_MULTI_POD):
        assert TR.get_rules() is TR.RULES_MULTI_POD
        assert TR.logical_to_pspec(("batch", "embed_p")) == (
            ("pod", "data"),)
    assert TR.get_rules() is None


class _Mesh2x2:
    """A stand-in (2, 2) ("data", "model") mesh: the names and sizes the
    placement rules read, without a process group of four."""
    mesh_dim_names = ("data", "model")
    mesh = torch.empty(2, 2)

    def size(self, dim=None):
        return 4 if dim is None else 2


def test_mesh_placements_and_shardings(mesh):
    assert axis_sizes(mesh) == {"data": 1, "model": 1}
    assert TR.rules_for_mesh(mesh) is TR.RULES_SINGLE_POD
    assert TR.rules_for_mesh(None) == {}
    wide = _Mesh2x2()
    assert TR.to_placements(("data", None, "model"), wide) == (
        Shard(0), Shard(2))
    assert TR.to_placements((None, ("data", "model")), wide) == (
        Shard(1), Shard(1))
    # a mesh dim of size 1 splits nothing: replicated, whatever the spec
    assert TR.to_placements(("data", None, "model"), mesh) == (
        Replicate(), Replicate())
    assert TR.to_placements((), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="pod"):
        TR.to_placements(("pod",), mesh)
    sh = TR.named_sharding(wide, "batch", "embed_p")
    assert sh.spec == ("data",) and sh.placements == (Shard(0), Replicate())
    sh = TR.named_sharding(mesh, "batch", "embed_p")
    assert sh.spec == ("data",) and sh.placements == (Replicate(),
                                                      Replicate())
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=str(need)):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    # ws: nothing without rules or for a plain tensor; a DTensor is
    # redistributed to its names' placements
    x = torch.arange(6.0).reshape(2, 3)
    assert TR.ws(x, "batch", None) is x
    d = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
    with TR.axis_rules(TR.RULES_SINGLE_POD):
        assert TR.ws(x, "batch", None) is x
        y = TR.ws(d, "batch", "heads")
    # ("data", "model"): (Shard(0), Shard(1)) on a wide mesh, replicated
    # on this one's size-1 dims
    assert y.placements == TR.to_placements(("data", "model"), mesh)
    assert torch.equal(y.full_tensor(), x)


def test_graph_shardings_structure(mesh):
    src, dst = np.array([0, 2], np.int32), np.array([1, 3], np.int32)
    g = from_edges(src, dst, 4, 1024, device="cpu")
    sh = graph_shardings(mesh, g)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1])
    jsh = jgraph_shardings(jmesh, jfrom_edges(src, dst, 4, 1024))
    for field in g._fields:
        got, want = getattr(sh, field), getattr(jsh, field)
        if want is None:
            assert got is None
        else:
            assert got.spec == tuple(want.spec) and got.mesh is mesh, field
    assert edge_sharding(mesh, 1024).spec == (("data", "model"),)
    assert edge_sharding(mesh, 1024).placements == (Replicate(),
                                                    Replicate())
    assert edge_sharding(_Mesh2x2(), 1024).placements == (Shard(0), Shard(0))


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("shape", [(1000,), (3, 257), (4096,), (2, 3, 64)])
def test_quantize_dequantize_bitwise(shape):
    # both round half to even; scales and blocks are the same f32 ops
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape)
         * rng.uniform(0.01, 100.0, shape)).astype(np.float32)
    x.reshape(-1)[:7] = [0.0, 127.0, -63.5, 0.5, 1.5, -2.5, 0.0]  # ties
    jq, js = JCMP.quantize(jnp.asarray(x))
    tq, ts = TCMP.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TCMP.dequantize(tq, ts, shape, x.size).numpy(),
        np.asarray(JCMP.dequantize(jq, js, shape, x.size)))
    assert TCMP.BLOCK == JCMP.BLOCK
    assert TCMP.compression_ratio() == JCMP.compression_ratio()


def test_compressed_mean_one_rank_matches_the_reference(mesh):
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((1, 512)).astype(np.float32),
         "b": {"c": rng.standard_normal((1, 3, 100)).astype(np.float32)}}
    e = {"w": (0.01 * rng.standard_normal((1, 512))).astype(np.float32),
         "b": {"c": np.zeros((1, 3, 100), np.float32)}}
    jmesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    jm, je = JCMP.compressed_mean(jax.tree_util.tree_map(jnp.asarray, g),
                                  jax.tree_util.tree_map(jnp.asarray, e),
                                  jmesh, axis="data")
    pl = (Shard(0), Replicate())
    dt = lambda a: DTensor.from_local(torch.from_numpy(a.copy()), mesh, pl)
    tm, te = TCMP.compressed_mean(jax.tree_util.tree_map(dt, g),
                                  jax.tree_util.tree_map(dt, e), mesh,
                                  axis="data")
    for path, want in _leaves(jax.tree_util.tree_map(np.asarray, jm)):
        got = _at(tm, path)
        assert isinstance(got, DTensor) and got.placements == pl
        np.testing.assert_array_equal(got.to_local().numpy(), want)
        np.testing.assert_array_equal(_at(te, path).to_local().numpy(),
                                      np.asarray(_at(je, path)))
    zeros = TCMP.init_error_state(tm)
    assert zeros["w"].placements == pl
    assert not zeros["w"].to_local().any()
    assert TCMP.init_error_state({"x": torch.ones(2, 3)})["x"].dtype == (
        torch.float32)
    with pytest.raises(TypeError, match="DTensor"):
        TCMP.compressed_mean({"w": torch.ones(1, 4)}, {"w": torch.ones(1, 4)},
                             mesh)


def _leaf_transcribed(gs, errs):
    """The reference's ``leaf`` (``repro/train/compression.py``) over all
    ranks at once in numpy, on its own quantize: (mean, new errors), each
    with the leading rank dim."""
    n = np.float32(gs.shape[0])
    g1 = gs.astype(np.float32) + errs
    qs = [JCMP.quantize(jnp.asarray(r)) for r in g1]
    qsum = np.sum([np.asarray(q).astype(np.int32) for q, _ in qs], axis=0)
    ssum = np.sum([np.asarray(s) for _, s in qs], axis=0, dtype=np.float32)
    recon = qsum.astype(np.float32) * (ssum / n)[:, None]
    size = g1[0].size
    mean = recon.reshape(-1)[:size].reshape(g1[0].shape) / n
    sent = [np.asarray(JCMP.dequantize(q, s, g1[0].shape, size))
            for q, s in qs]
    return (np.stack([mean] * gs.shape[0]),
            np.stack([g1[r] - sent[r] for r in range(gs.shape[0])]))


# -------------------------------------------------------- two gloo ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawn the two ranks once: their pickled results and the
    checkpoint directory they saved into."""
    import _sharding_ranks as R

    tmp = tmp_path_factory.mktemp("sharding")
    out, ckpt_dir = str(tmp / "res"), str(tmp / "ckpt")
    mp.spawn(R.run, args=(f"file://{tmp / 'store'}", out, ckpt_dir),
             nprocs=R.RANKS, join=True)
    got = []
    for rank in range(R.RANKS):
        with open(f"{out}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    return R, got, ckpt_dir


def test_two_ranks_compressed_mean(two_ranks):
    R, got, _ = two_ranks
    grads, errs, _, _ = R.arrays()
    for k in R.LEAVES:
        mean, new_err = _leaf_transcribed(grads[k], errs[k])
        for rank in range(R.RANKS):
            np.testing.assert_array_equal(got[rank]["mean"][k],
                                          mean[rank:rank + 1])
            np.testing.assert_array_equal(got[rank]["err"][k],
                                          new_err[rank:rank + 1])


def test_two_ranks_shard_batch(two_ranks):
    R, got, _ = two_ranks
    batch = R.arrays()[3]
    for rank in range(R.RANKS):
        np.testing.assert_array_equal(got[rank]["tokens"],
                                      batch["tokens"][2 * rank:2 * rank + 2])
        assert got[rank]["labels_untouched"]


def test_two_rank_checkpoint_restores_in_one_process(two_ranks, mesh):
    R, _, ckpt_dir = two_ranks
    want = R.arrays()[2]
    ckpt = CheckpointManager(ckpt_dir)
    assert ckpt.latest_step() == R.STEP
    target = {k: torch.empty(s, device="meta") for k, s in R.CKPT.items()}
    got = ckpt.restore(R.STEP, target, "cpu")
    for k in R.CKPT:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # the same files through the reference's restore
    jgot = JCK.CheckpointManager(ckpt_dir).restore(
        R.STEP, {k: jax.ShapeDtypeStruct(s, jnp.float32)
                 for k, s in R.CKPT.items()})
    for k in R.CKPT:
        np.testing.assert_array_equal(np.asarray(jgot[k]), want[k])
    # elastic_reshard onto the one-rank mesh: DTensors, bitwise
    shardings = {"emb": TR.NamedSharding(mesh, ("model",)),
                 "w": TR.NamedSharding(mesh, (None, "data")), "scale": None}
    placed = elastic_reshard(ckpt, R.STEP, target, shardings)
    # (the one-rank mesh's size-1 dims split nothing: replicated)
    assert placed["emb"].placements == TR.to_placements(("model",), mesh)
    assert placed["w"].placements == TR.to_placements((None, "data"), mesh)
    for k in ("emb", "w"):
        np.testing.assert_array_equal(placed[k].full_tensor().numpy(),
                                      want[k])
    assert placed["scale"].device.type == "meta"


def test_reference_checkpoint_restored_onto_the_mesh(tmp_path, mesh):
    # the reference writes a params tree; the port restores it onto the
    # local mesh with param_pspecs under RULES_SINGLE_POD, bitwise
    cfg = JCF.get_smoke_config("qwen2_0_5b")
    jparams = JPAR.init_params(jax.random.PRNGKey(3), cfg)
    JCK.CheckpointManager(tmp_path, async_save=False).save(2, jparams)
    tcfg = TCF.get_smoke_config("qwen2_0_5b")
    specs = TPAR.param_pspecs(tcfg, TR.RULES_SINGLE_POD)
    shardings = jax.tree_util.tree_map(
        lambda s: TR.NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, tuple))
    got = elastic_reshard(CheckpointManager(tmp_path), 2,
                          TPAR.abstract_params(tcfg), shardings)
    for path, want in _leaves(jax.tree_util.tree_map(np.asarray, jparams)):
        leaf = _at(got, path)
        assert isinstance(leaf, DTensor)
        assert leaf.placements == TR.to_placements(_at(specs, path), mesh)
        np.testing.assert_array_equal(leaf.to_local().numpy(), want)


def test_shard_batch_keeps_the_one_device_call(mesh):
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
             "mask": np.ones((3, 4), bool)}
    got = shard_batch(batch, device="cpu")
    assert all(isinstance(v, torch.Tensor) and not isinstance(v, DTensor)
               for v in got.values())
    np.testing.assert_array_equal(got["tokens"].numpy(), batch["tokens"])
    placed = shard_batch(batch, {"tokens": TR.named_sharding(mesh, "batch",
                                                             None)})
    assert isinstance(placed["tokens"], DTensor)
    assert placed["mask"] is batch["mask"]
    np.testing.assert_array_equal(placed["tokens"].full_tensor().numpy(),
                                  batch["tokens"])
