"""The kernels' convenience wrappers and oracles (``repro_torch.kernels.*.
ops``/``ref``) against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through
- the reference's ``repro.core.backend.push(..., backend="segment_sum")``
  over its own layouts (its ``semiring_push`` forces the Pallas kernels,
  which raise on this jax), ``repro.kernels.spmv.ref.spmv_push_ref``,
  ``repro.models.layers._blocked_attention_ref`` (what
  ``flash_attention_ref`` calls) and ``repro.models.layers.
  decode_attention`` (what ``decode_attention_ref`` re-exports), and
- the port's ``semiring_push``/``pagerank_push``/``spmv_push_ref`` and the
  attention ops and refs, which on CPU tensors run the kernels' plain
  versions.

Tolerances: min/max pushes bitwise; f32 sums rtol = atol = 1e-6 (the
reference's per-push tolerance, ``tests/test_kernels.py``); attention
rtol = atol = 1e-5 (``tests/test_torch_attention.py``: the tiles' sums are
taken in another order).  The ops on the card are ``chip_smoke.py``'s
``ops`` phase (each op's launch counted, held to its ref and plain
version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JB
from repro.graph import graph as JG
from repro.kernels.spmv.ref import spmv_push_ref as jspmv_push_ref
from repro.models import layers as JL
from repro_torch.core import backend as TB
from repro_torch.graph import graph as TG
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.spmv import ops as OPS
from repro_torch.kernels.spmv.ref import spmv_push_ref

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(lengths=False):
    """The same graph, with tombstones and padding, in both packages."""
    src, dst = barabasi_albert_edges(300, 3, 7, 0.3)
    n_cap, e_cap = 320, src.shape[0] + 150
    w = (np.random.default_rng(0).random(src.shape[0]).astype(np.float32)
         + 0.5) if lengths else None
    js = JG.from_edges(src, dst, n_cap, e_cap, weights=w)
    ts = TG.from_edges(src, dst, n_cap, e_cap, weights=w, device="cpu")
    slots = np.arange(0, src.shape[0], 17, dtype=np.int32)
    js = JG.remove_edges_by_slot(js, jnp.asarray(slots))
    ts = TG.remove_edges_by_slot(ts, torch.from_numpy(slots))
    return js, ts


def _values(n, batch, dtype, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    if dtype == "int32":
        return rng.integers(0, 1000, shape).astype(np.int32)
    return (rng.random(shape) + 0.1).astype(np.float32)


def _match(out, ref, bitwise):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if bitwise:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, **SUM_TOL)


@pytest.mark.parametrize("batch", [None, 4], ids=["single", "batched"])
@pytest.mark.parametrize("semiring,weight,dtype", [
    ("plus_times", "unit", "float32"),
    ("plus_times", "length", "float32"),
    ("min_plus", "length", "float32"),
    ("max_times", "unit", "float32"),
    ("min_min", "unit", "int32"),
])
def test_semiring_push_matches_reference(semiring, weight, dtype, batch):
    js, ts = _graphs(lengths=weight == "length")
    x = _values(js.node_capacity, batch, dtype)
    jl = JB.build_layout(js, weight=weight, semiring=semiring)
    ref = JB.push(jnp.asarray(x), jl, semiring=semiring,
                  backend="segment_sum")
    out = OPS.semiring_push(ts, torch.from_numpy(x), semiring=semiring,
                            weight=weight)
    _match(out, ref, bitwise=semiring != "plus_times")
    # a cached layout gives the same bits as the one built per call
    lay = TB.build_layout(ts, weight=weight, semiring=semiring)
    assert torch.equal(OPS.semiring_push(ts, torch.from_numpy(x),
                                         semiring=semiring, layout=lay), out)


@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batched"])
def test_pagerank_push_matches_reference(batch):
    js, ts = _graphs()
    x = _values(js.node_capacity, batch, "float32", seed=5)
    ref = JB.push(jnp.asarray(x), JB.build_layout(js, weight="inv_out"),
                  backend="segment_sum")
    out = OPS.pagerank_push(ts, torch.from_numpy(x))
    _match(out, ref, bitwise=False)
    lay = TB.build_layout(ts)
    assert torch.equal(OPS.pagerank_push(ts, torch.from_numpy(x),
                                         layout=lay), out)


def test_pagerank_push_is_the_inv_out_semiring_push():
    _, ts = _graphs()
    x = torch.from_numpy(_values(ts.node_capacity, None, "float32"))
    assert torch.equal(OPS.pagerank_push(ts, x),
                       OPS.semiring_push(ts, x, weight="inv_out"))


def test_spmv_push_ref_matches_reference():
    js, _ = _graphs()
    jl = JB.build_layout(js, weight="inv_out")
    n = js.node_capacity
    x = _values(n, None, "float32", seed=7)
    contrib = x[np.asarray(jl.src)] * np.asarray(jl.weight)
    dst = np.array(jl.dst)            # the padding holds the sentinel n
    assert (dst == n).any()
    ref = jspmv_push_ref(jnp.asarray(contrib), jnp.asarray(dst), n)
    out = spmv_push_ref(torch.from_numpy(contrib), torch.from_numpy(dst), n)
    _match(out, ref, bitwise=False)
    # the oracle is the sequential segment sum the plain push computes
    _, ts = _graphs()
    tl = TB.build_layout(ts)
    np.testing.assert_array_equal(
        out.numpy(), TB.push(torch.from_numpy(x), tl).numpy())


@pytest.mark.parametrize("semiring,weight,dtype", [
    ("plus_times", "unit", "float32"), ("min_plus", "length", "float32"),
    ("min_min", "unit", "int32")])
def test_sharded_semiring_push_waits_for_sharding(semiring, weight, dtype):
    # the sharded op against the reference's meshless shard loop, also
    # at an explicit (rebalanced) slot assignment
    from repro.graph import partition as JP
    from repro.kernels.spmv.ops import sharded_semiring_push
    from repro_torch.graph import partition as TP

    js, ts = _graphs(lengths=weight == "length")
    x = _values(ts.node_capacity, None, dtype)
    want = sharded_semiring_push(js, jnp.asarray(x), num_shards=4,
                                 semiring=semiring, weight=weight,
                                 backend="segment_sum")
    got = OPS.sharded_semiring_push(ts, torch.from_numpy(x), num_shards=4,
                                    semiring=semiring, weight=weight)
    _match(got, want, bitwise=semiring != "plus_times")
    slots = TP.balanced_shard_slots(ts, num_shards=4)
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(JP.balanced_shard_slots(js, num_shards=4)))
    got = OPS.sharded_semiring_push(ts, torch.from_numpy(x), num_shards=4,
                                    semiring=semiring, weight=weight,
                                    slots=slots)
    _match(got, want, bitwise=semiring != "plus_times")


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,s,h,kv,hd,vd,causal,window", [
    (2, 256, 8, 2, 64, 64, True, None),
    (1, 300, 14, 2, 64, 64, True, 48),     # Qwen2 heads, window, padding
    (2, 128, 4, 4, 32, 16, False, None),   # MHA, vd != hd
])
def test_flash_attention_ref_and_op_match_reference(b, s, h, kv, hd, vd,
                                                    causal, window):
    rng = np.random.default_rng(s + h)
    q, k, v = (_normal(rng, shape) for shape in
               ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, vd)))
    ref = JL._blocked_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=0, kv_offset=0, kv_valid_len=None,
        q_block=128, kv_block=256, softmax_scale=hd ** -0.5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (b, s, h, vd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    # on CPU tensors the op is the kernel's plain version
    op = flash_attention_op(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(op.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,cache_len", [
    (2, 256, 14, 2, 64, 200),
    (3, 128, 8, 8, 32, 128),
    (1, 96, 16, 1, 64, 1),
])
def test_decode_attention_ref_and_op_match_reference(b, s, h, kv, hd,
                                                     cache_len):
    rng = np.random.default_rng(s * 7 + cache_len)
    q, k, v = (_normal(rng, shape) for shape in
               ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    ref = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              cache_len=jnp.int32(cache_len))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = decode_attention_ref(tq, tk, tv, cache_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    op = decode_attention_op(tq, tk, tv, cache_len)
    np.testing.assert_allclose(op.numpy(), np.asarray(ref), **ATTN_TOL)
