"""Parity of the port's sorted stream, layouts and ``push`` with the JAX
package, and of the SpMV kernel with its plain version.

Integer outputs and min/max pushes are bitwise; f32 sums hold the
reference's own per-push tolerance (rtol = atol = 1e-6, as in
tests/test_kernels.py).  The CUDA kernel itself is tested in
tests/test_torch_spmv_kernel.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as JB
from repro.graph import csr as JC
from repro.graph import graph as JG
from repro.kernels.spmv.ref import spmv_push_ref
from repro_torch.convert import edge_layout_from_numpy
from repro_torch.core import backend as TB
from repro_torch.graph import csr as TC
from repro_torch.graph import graph as TG
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.kernels.spmv.kernel import spmv_push, spmv_push_plain

TOL = dict(rtol=1e-6, atol=1e-6)
_LAYOUT_ARRAYS = ("src", "dst", "weight", "valid", "row_offsets", "order",
                  "rank")


def _graphs(lengths=False):
    """The same graph, with tombstones and padding, in both packages."""
    src, dst = barabasi_albert_edges(300, 3, 7, 0.3)
    n_cap, e_cap = 320, src.shape[0] + 150
    w = (np.random.default_rng(0).random(src.shape[0]).astype(np.float32)
         + 0.5) if lengths else None
    js = JG.from_edges(src, dst, n_cap, e_cap, weights=w)
    ts = TG.from_edges(src, dst, n_cap, e_cap, weights=w,
                       device="cpu")
    slots = np.arange(0, src.shape[0], 17, dtype=np.int32)
    js = JG.remove_edges_by_slot(js, jnp.asarray(slots))
    ts = TG.remove_edges_by_slot(ts, torch.from_numpy(slots))
    return js, ts


def _np_layout(layout):
    return {k: None if getattr(layout, k) is None
            else np.asarray(getattr(layout, k)) for k in _LAYOUT_ARRAYS}


def _assert_layouts_equal(jl, tl):
    j, t = _np_layout(jl), _np_layout(tl)
    for k in _LAYOUT_ARRAYS:
        if j[k] is None or t[k] is None:
            assert j[k] is None and t[k] is None, k
            continue
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    assert (jl.weight_mode, jl.reverse, jl.pad_chunk, jl.semiring) == \
        (tl.weight_mode, tl.reverse, tl.pad_chunk, tl.semiring)


@pytest.mark.parametrize("reverse", [False, True])
def test_sort_by_dst_matches_reference(reverse):
    js, ts = _graphs()
    a = JC.sort_by_dst(js, reverse=reverse)
    b = TC.sort_by_dst(ts, reverse=reverse)
    for k in a._fields:
        x, y = np.asarray(getattr(a, k)), getattr(b, k).numpy()
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    np.testing.assert_array_equal(
        np.asarray(JB.stream_rank(a.dst, a.valid, a.row_offsets)),
        TB.stream_rank(b.dst, b.valid, b.row_offsets).numpy())


@pytest.mark.parametrize("weight,reverse,semiring,weight_dtype", [
    ("inv_out", False, "plus_times", None),
    ("unit", True, "plus_times", None),
    ("length", False, "min_plus", None),
    ("unit", False, "min_min", None),
    ("unit", True, "max_times", None),
    ("inv_out", False, "plus_times", "float16"),
])
def test_build_layout_matches_reference(weight, reverse, semiring,
                                        weight_dtype):
    js, ts = _graphs(lengths=weight == "length")
    _assert_layouts_equal(
        JB.build_layout(js, weight=weight, reverse=reverse,
                        semiring=semiring, weight_dtype=weight_dtype),
        TB.build_layout(ts, weight=weight, reverse=reverse,
                        semiring=semiring, weight_dtype=weight_dtype))


def test_layout_spec_checks_match_reference():
    for bad in (dict(weight="bogus"), dict(weight="inv_out", reverse=True),
                dict(weight="inv_out", semiring="min_plus")):
        with pytest.raises(ValueError):
            JB.validate_weight_spec(**bad)
        with pytest.raises(ValueError):
            TB.validate_weight_spec(**bad)
    with pytest.raises(ValueError):
        TB.validate_weight_dtype("bfloat16", TB.resolve_semiring("min_min"))
    assert TB.normalize_layout_spec(("unit", True)) == \
        JB.normalize_layout_spec(("unit", True))
    js, ts = _graphs()
    with pytest.raises(ValueError):
        TB.require_layout(TB.build_layout(ts), weight="unit", reverse=False,
                          who="t")


def _values(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(0, 1000, n).astype(np.int32)
    return rng.random(n).astype(dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_push_plus_times_matches_reference(masked):
    js, ts = _graphs()
    jl = JB.build_layout(js)
    tl = TB.build_layout(ts)
    v = _values(js.node_capacity, 1)
    mask = (np.random.default_rng(2).random(jl.dst.shape[0]) < 0.6
            if masked else None)
    ref = JB.push(jnp.asarray(v), jl, backend="segment_sum",
                  mask=None if mask is None else jnp.asarray(mask))
    out = TB.push(torch.from_numpy(v), tl,
                  mask=None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the kernel's plain version against the kernel-level oracle
    contrib = v[np.asarray(jl.src)] * np.asarray(jl.weight)
    if mask is not None:
        contrib = np.where(mask, contrib, np.float32(0))
    oracle = spmv_push_ref(jnp.asarray(contrib),
                           jnp.minimum(jl.dst, js.node_capacity - 1),
                           js.node_capacity)
    plain = spmv_push_plain(torch.from_numpy(v), tl.src, tl.weight,
                            tl.row_offsets,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("semiring,weight,reverse", [
    ("min_plus", "length", False),
    ("min_min", "unit", True),
    ("max_times", "unit", False),
])
def test_push_min_max_semirings_bitwise(semiring, weight, reverse):
    js, ts = _graphs(lengths=weight == "length")
    jl = JB.build_layout(js, weight=weight, reverse=reverse,
                         semiring=semiring)
    tl = TB.build_layout(ts, weight=weight, reverse=reverse,
                         semiring=semiring)
    dt = np.int32 if semiring == "min_min" else np.float32
    v = _values(js.node_capacity, 3, dt)
    mask = np.random.default_rng(4).random(jl.dst.shape[0]) < 0.7
    for m in (None, mask):
        ref = JB.push(jnp.asarray(v), jl, semiring=semiring,
                      backend="segment_sum",
                      mask=None if m is None else jnp.asarray(m))
        out = TB.push(torch.from_numpy(v), tl, semiring=semiring,
                      mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # each row of a batched push equals the single push
    vb = np.stack([v, _values(js.node_capacity, 5, dt)])
    ref_b = JB.push(jnp.asarray(vb), jl, semiring=semiring,
                    backend="segment_sum")
    out_b = TB.push(torch.from_numpy(vb), tl, semiring=semiring)
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))


def test_push_coo_and_summary_layout_match_reference():
    js, ts = _graphs()
    v = _values(js.node_capacity, 6)
    w = _values(js.edge_capacity, 7)
    m = js.edge_mask()
    ref = JB.push_coo(jnp.asarray(v), js.src, js.dst, js.node_capacity,
                      weight=jnp.asarray(w), mask=m)
    out = TB.push_coo(torch.from_numpy(v), ts.src, ts.dst, ts.node_capacity,
                      weight=torch.from_numpy(w), mask=ts.edge_mask())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError):
        TB.push(torch.from_numpy(v), TB.build_layout(ts), semiring="min_plus")


def test_edge_layout_converter_round_trip():
    js, _ = _graphs()
    jl = JB.build_layout(js)
    tl = edge_layout_from_numpy(
        _np_layout(jl), device="cpu", weight_mode=jl.weight_mode, reverse=jl.reverse,
        pad_chunk=jl.pad_chunk, semiring=jl.semiring)
    _assert_layouts_equal(jl, tl)


def test_trace_counters_count_calls():
    _, ts = _graphs()
    TB.reset_trace_counts()
    layout = TB.build_layout(ts)
    TB.push(torch.ones(ts.node_capacity), layout)
    TB.push(torch.ones(ts.node_capacity), layout)
    assert (TB.trace_count("build_layout"), TB.trace_count("push"),
            TB.trace_count("push_coo")) == (1, 2, 0)
    TB.reset_trace_counts()
    assert TB.trace_count("push") == 0


def test_spmv_push_wrapper_plain_on_cpu_and_launch_count():
    before = spmv_push.launches
    _, ts = _graphs()
    tl = TB.build_layout(ts)
    v = torch.from_numpy(_values(ts.node_capacity, 8))
    np.testing.assert_array_equal(
        spmv_push(v, tl.src, tl.weight, tl.row_offsets).numpy(),
        spmv_push_plain(v, tl.src, tl.weight, tl.row_offsets).numpy())
    assert spmv_push.launches == before  # the CPU path launches nothing
    # rows with no in-edge give 0; an empty row space gives an empty result
    empty = torch.zeros(1, dtype=torch.int32)
    assert spmv_push_plain(v, tl.src, tl.weight, empty).shape == (0,)


#: registered here under names no other test uses (the reference's
#: registry is process-global): (name, ⊕, ⊗, dtype, layout weight)
CUSTOM_SEMIRINGS = [
    ("parity_max_min_f32", "max", "min", "float32", "length"),
    ("parity_min_plus_i32", "min", "plus", "int32", "length"),
    ("parity_max_times_i32", "max", "times", "int32", "length"),
    ("parity_sum_plus_f32", "sum", "plus", "float32", "length"),
]


@pytest.mark.parametrize("spec", CUSTOM_SEMIRINGS, ids=lambda s: s[0])
def test_push_registered_custom_semiring_matches_reference(spec):
    """A semiring registered in both packages goes through ``push`` (the
    kernel wrapper's plain version here): min/max bitwise against the
    reference's ``segment_sum`` push, a sum at its per-push tolerance."""
    from repro.core import semiring as JS
    from repro_torch.core import semiring as TS

    name, add, mul, dtype, weight = spec
    JS.register_semiring(JS.Semiring(name, add, mul, dtype))
    TS.register_semiring(TS.Semiring(name, add, mul, dtype))
    js, ts = _graphs(lengths=True)
    jl = JB.build_layout(js, weight=weight, semiring=name)
    tl = TB.build_layout(ts, weight=weight, semiring=name)
    _assert_layouts_equal(jl, tl)
    dt = np.dtype(dtype)
    v = _values(js.node_capacity, 9, dt)
    mask = np.random.default_rng(10).random(jl.dst.shape[0]) < 0.6
    for m in (None, mask):
        ref = np.asarray(JB.push(jnp.asarray(v), jl, semiring=name,
                                 backend="segment_sum",
                                 mask=None if m is None else jnp.asarray(m)))
        out = TB.push(torch.from_numpy(v), tl, semiring=name,
                      mask=None if m is None else torch.from_numpy(m))
        assert out.dtype == getattr(torch, dtype)
        if add == "sum":
            np.testing.assert_allclose(out.numpy(), ref, **TOL)
        else:
            np.testing.assert_array_equal(out.numpy(), ref)
    vb = np.stack([v, _values(js.node_capacity, 11, dt)])
    ref_b = np.asarray(JB.push(jnp.asarray(vb), jl, semiring=name,
                               backend="segment_sum"))
    out_b = TB.push(torch.from_numpy(vb), tl, semiring=name).numpy()
    if add == "sum":
        np.testing.assert_allclose(out_b, ref_b, **TOL)
    else:
        np.testing.assert_array_equal(out_b, ref_b)
