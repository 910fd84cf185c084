"""Parity of the port's batched ``[B, N]`` push with the JAX package's
(``backend="segment_sum"``, no mesh).

For every registered (semiring, weight) pair the serving suite covers, B
value rows made with numpy go through ``repro.core.backend.push`` and
``repro_torch.core.backend.push`` over the same graph: min/max results are
bitwise, sums hold the serving suite's rtol 1e-5 / atol 1e-6.  The port's
batched push is also held against the stack of its own single pushes, and
the masked form (one mask per edge, shared by the rows) against JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as JB
from repro.graph import graph as JG
from repro.graph.generators import gnm_edges
from repro_torch.convert import graph_state_from_numpy
from repro_torch.core import backend as TB

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 3
#: the JAX serving suite's (semiring, weight) pairs
SEMIRING_WEIGHTS = [
    ("plus_times", "inv_out"),
    ("plus_times", "unit"),
    ("min_plus", "length"),
    ("min_min", "unit"),
    ("max_times", "unit"),
]


def _graphs(n=150, m=900, seed=0):
    """The same graph in both packages, with lengths for ``length``
    layouts (in [0.5, 1.5): no denormal sums)."""
    src, dst = gnm_edges(n, m, seed=seed)
    lens = (0.5 + np.random.default_rng(seed).random(src.shape[0])).astype(
        np.float32)
    js = JG.from_edges(src, dst, n, m + 64, weights=lens)
    ts = graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")
    return js, ts


def _values(semiring, n, seed=0):
    rng = np.random.default_rng(seed)
    if semiring == "min_min":
        return rng.integers(0, n, (BATCH, n)).astype(np.int32)
    return rng.random((BATCH, n)).astype(np.float32)


def _check(out, ref, semiring):
    ref = np.array(ref)
    assert out.dtype == torch.from_numpy(ref).dtype
    assert tuple(out.shape) == ref.shape
    if semiring == "plus_times":
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    else:
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("semiring,weight", SEMIRING_WEIGHTS)
@pytest.mark.parametrize("masked", [False, True])
def test_batched_push_matches_reference(semiring, weight, masked):
    js, ts = _graphs()
    jl = JB.build_layout(js, weight=weight, semiring=semiring)
    tl = TB.build_layout(ts, weight=weight, semiring=semiring)
    vals = _values(semiring, js.node_capacity)
    mask = None
    if masked:
        mask = np.random.default_rng(1).random(tl.src.shape[0]) < 0.6
    ref = JB.push(jnp.asarray(vals), jl, semiring=semiring,
                  backend="segment_sum",
                  mask=None if mask is None else jnp.asarray(mask))
    out = TB.push(torch.from_numpy(vals), tl, semiring=semiring,
                  mask=None if mask is None else torch.from_numpy(mask))
    _check(out, ref, semiring)
    # each row is the port's single push of that row
    for b in range(BATCH):
        single = TB.push(torch.from_numpy(vals[b]), tl, semiring=semiring,
                         mask=None if mask is None else torch.from_numpy(mask))
        if semiring == "plus_times":
            np.testing.assert_allclose(out[b].numpy(), single.numpy(), **TOL)
        else:
            np.testing.assert_array_equal(out[b].numpy(), single.numpy())


def test_batched_push_records_its_trace_and_rejects_3d():
    _, ts = _graphs()
    tl = TB.build_layout(ts)
    TB.reset_trace_counts()
    TB.push(torch.ones((2, ts.node_capacity)), tl)
    TB.push(torch.ones(ts.node_capacity), tl)
    assert TB.trace_count("push") == 2
    assert TB.trace_count("push[batched]") == 1
    with pytest.raises(ValueError, match=r"\[N\] or \[B, N\]"):
        TB.push(torch.ones((2, 2, ts.node_capacity)), tl)
