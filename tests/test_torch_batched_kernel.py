"""The batched push kernels against their plain versions and against the
single-vector kernels.

``spmv_push_batched`` and ``spmv_reduce_push_batched`` push B value rows
through one shared stream in one launch.  On the CPU the batched plain
versions are held against the stack of the single plain versions (bitwise
for min/max; the sums too, since each row's ``index_add_`` runs in the same
edge order).  On the card each batched kernel is held against its plain
version on the CPU (the sum against f64 at rtol 1e-5, min/max bitwise up
to NaN payloads) and each of its rows bitwise against the single kernel on
that row.  This file imports
neither JAX nor the JAX package, so the card's tests run where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_batched_kernel.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv.kernel import (MAX_BATCH, spmv_push,
                                             spmv_push_batched,
                                             spmv_push_batched_plain,
                                             spmv_push_plain,
                                             spmv_reduce_push,
                                             spmv_reduce_push_batched,
                                             spmv_reduce_push_batched_plain,
                                             spmv_reduce_push_plain)

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 4
#: (op, mul, numpy dtype) of the shipped semirings' kernel entries and of
#: the sum's other ⊗ entries; op None = the sum
SEMIRINGS = [(None, "times", np.float32), ("min", "plus", np.float32),
             ("max", "times", np.float32), ("min", "min", np.int32),
             (None, "plus", np.float32), (None, "min", np.float32)]


def _ids(sr):
    if sr[0] is None:
        return "sum" if sr[1] == "times" else f"sum_{sr[1]}"
    return f"{sr[0]}_{sr[1]}"


def _csr(semiring, seed, *, batch=BATCH):
    """A CSR matrix with empty rows, one-edge rows, rows longer than a warp
    and a hub row, offsets that start past edge 0, B value rows that hit
    the semiring's edge cases, and a mask."""
    op, mul, dt = semiring
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0, 1, 0, 31, 32, 33, 0, 5000],
                             rng.integers(0, 40, 292)])
    ro = (11 + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    e, n_src = int(ro[-1]) + 7, 500
    src = rng.integers(0, n_src, e).astype(np.int32)
    if dt == np.int32:
        values = rng.integers(0, 1000, (batch, n_src)).astype(np.int32)
        values[:, ::7] = np.iinfo(np.int32).max
        w = np.full(e, np.iinfo(np.int32).max, np.int32)
        w[::5] = rng.integers(0, 1000, w[::5].shape[0])
    elif op == "min":
        values = (10 * rng.random((batch, n_src))).astype(np.float32)
        values[:, ::6] = np.inf
        values[-1, 3] = np.nan
        w = rng.random(e).astype(np.float32)
    else:
        values = rng.random((batch, n_src)).astype(np.float32)
        values[:, ::6] = 0.0
        w = (1.0 - rng.random(e)).astype(np.float32)
    mask = rng.random(e) < 0.5
    return [torch.from_numpy(a) for a in (values, src, w, ro, mask)]


def _batched(semiring):
    op, mul, _ = semiring
    if op is None:
        return spmv_push_batched, spmv_push, dict(mul=mul)
    return spmv_reduce_push_batched, spmv_reduce_push, dict(op=op, mul=mul)


def _plain(semiring, batched):
    op, mul, _ = semiring
    if op is None:
        return (spmv_push_batched_plain if batched else spmv_push_plain,
                dict(mul=mul))
    return (spmv_reduce_push_batched_plain if batched
            else spmv_reduce_push_plain), dict(op=op, mul=mul)


def _same_bits(a, b, *, any_nan=False):
    """Equal bit for bit (dtype and shape included); with ``any_nan`` a NaN
    matches any NaN (the card's arithmetic returns its own NaN payload,
    the CPU keeps the input's)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if any_nan and a.dtype.kind == "f":
        nan = np.isnan(a)
        np.testing.assert_array_equal(nan, np.isnan(b))
        a, b = a[~nan], b[~nan]
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_batched_is_the_stack_of_single_plains(semiring, masked):
    values, src, w, ro, mask = _csr(semiring, 1)
    mask = mask if masked else None
    fn, kw = _plain(semiring, True)
    single, _ = _plain(semiring, False)
    out = fn(values, src, w, ro, mask, **kw)
    assert out.shape == (BATCH, ro.shape[0] - 1)
    want = torch.stack([single(values[b], src, w, ro, mask, **kw)
                        for b in range(BATCH)])
    _same_bits(out.numpy(), want.numpy())
    # CPU tensors take the plain version through the wrapper, launching
    # nothing
    wrapper, _, _ = _batched(semiring)
    before = wrapper.launches
    _same_bits(wrapper(values, src, w, ro, mask, **kw).numpy(), want.numpy())
    assert wrapper.launches == before


def test_plain_batched_sum_in_f64_matches_a_row_loop():
    values, src, w, ro, mask = _csr(SEMIRINGS[0], 2, batch=2)
    got = spmv_push_batched_plain(values, src, w, ro, mask,
                                  dtype=torch.float64).numpy()
    v, s, wt, r, m = (t.numpy() for t in (values, src, w, ro, mask))
    for b in range(2):
        for row in (0, 1, 3, 7, 100):
            e = np.arange(r[row], r[row + 1])
            e = e[m[e]]
            want = float(np.sum(v[b, s[e]].astype(np.float64) * wt[e]))
            assert got[b, row] == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
def test_wrappers_reject_the_wrong_rank(semiring):
    values, src, w, ro, _ = _csr(semiring, 3)
    fn, single, kw = _batched(semiring)
    for bad in (values[0], values[None]):  # [N_src] and [1, B, N_src]
        with pytest.raises(ValueError, match=r"\[B, N_src\]"):
            fn(bad, src, w, ro, **kw)
    with pytest.raises(ValueError, match="1-D"):
        single(values, src, w, ro, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch", [1, BATCH, BATCH + 2])
def test_kernel_matches_plain_and_single_kernel(cuda_device, semiring,
                                                masked, batch):
    host = _csr(semiring, 4, batch=batch)
    if not masked:
        host[4] = None
    values, src, w, ro, mask = [None if t is None else t.to(cuda_device)
                                for t in host]
    fn, single, kw = _batched(semiring)
    before, single_before = fn.launches, single.launches
    out = fn(values, src, w, ro, mask, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and single.launches == single_before
    plain, _ = _plain(semiring, True)
    if semiring[0] is None:
        ref = plain(*host, dtype=torch.float64, **kw)
        np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), **TOL)
    else:
        _same_bits(out.cpu().numpy(), plain(*host, **kw).numpy(),
                   any_nan=True)
    # each row is the single kernel on that row, bit for bit
    for b in range(batch):
        _same_bits(out[b].cpu().numpy(),
                   single(values[b], src, w, ro, mask, **kw).cpu().numpy())
    # no atomics: a second launch gives the same bits
    _same_bits(out.cpu().numpy(),
               fn(values, src, w, ro, mask, **kw).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_sum_rows_on_a_hub_layout_are_the_single_push(cuda_device, batch,
                                                      masked):
    """On a layout whose hub row spans many of the merge path's blocks,
    each row of a batched sum is the single push of its value row, bit for
    bit, whatever B is (the partition depends on the row offsets only)."""
    rng = np.random.default_rng(8)
    counts = np.concatenate([rng.integers(0, 40, 3000), [300_000],
                             np.zeros(500, np.int64),
                             rng.integers(0, 40, 3000)])
    ro = (3 + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    e, n_src = int(ro[-1]) + 5, 4000
    host = [rng.random((batch, n_src)).astype(np.float32),
            rng.integers(0, n_src, e).astype(np.int32),
            rng.random(e).astype(np.float32), ro, rng.random(e) < 0.5]
    values, src, w, ro, mask = [torch.from_numpy(a).to(cuda_device)
                                for a in host]
    mask = mask if masked else None
    out = spmv_push_batched(values, src, w, ro, mask)
    ref = spmv_push_batched_plain(values, src, w, ro, mask,
                                  dtype=torch.float64)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    for b in range(batch):
        _same_bits(out[b].cpu().numpy(),
                   spmv_push(values[b], src, w, ro, mask).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device, semiring):
    values, src, w, ro, mask = [t.to(cuda_device)
                                for t in _csr(semiring, 5)]
    fn, _, kw = _batched(semiring)
    bad = [
        (values.t().contiguous().t(), src, w, ro),  # a transposed bank
        (values[:, ::2], src, w, ro),              # a sliced bank
        (values[0], src, w, ro),                   # one row
        (values[None], src, w, ro),                # 3-D
        (values, src.long(), w, ro),               # int64 ids
        (values, src, w[:-1], ro),                 # misaligned weights
        (values, src, w, ro.cpu()),                # mixed devices
        (values[:0], src, w, ro),                  # an empty batch
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args, **kw)
    with pytest.raises(ValueError):
        fn(values, src, w, ro, mask.float(), **kw)
    big = values[:1].expand(MAX_BATCH + 1, -1).contiguous()
    with pytest.raises(ValueError, match="batch"):
        fn(big, src, w, ro, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", [
    ("min", "plus", np.float32), ("max", "times", np.float32),
    ("min", "min", np.int32), ("max", "min", np.float32),
    ("min", "plus", np.int32)], ids=lambda sr: f"{sr[0]}_{sr[1]}_"
    f"{np.dtype(sr[2]).name}")
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_reduce_rows_on_a_hub_layout_are_the_single_push(
        cuda_device, semiring, batch, masked):
    """On a layout whose hub row spans many of the merge path's blocks,
    each row of a batched min/max push is the single push of its value row,
    bit for bit, whatever B is, and the batch is bitwise its plain
    version."""
    op, mul, dt = semiring
    rng = np.random.default_rng(9)
    counts = np.concatenate([rng.integers(0, 40, 3000), [300_000],
                             np.zeros(500, np.int64),
                             rng.integers(0, 40, 3000)])
    ro = (3 + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    e, n_src = int(ro[-1]) + 5, 4000
    if dt == np.int32:
        vals = rng.integers(-2**31, 2**31 - 1, (batch, n_src)).astype(dt)
        w = rng.integers(-2**31, 2**31 - 1, e).astype(dt)
    else:
        vals = (10 * rng.random((batch, n_src))).astype(dt)
        vals[:, ::9] = np.inf
        w = rng.random(e).astype(dt)
    host = [torch.from_numpy(a) for a in
            (vals, rng.integers(0, n_src, e).astype(np.int32), w, ro,
             rng.random(e) < 0.5)]
    if not masked:
        host[4] = None
    values, src, w, ro, mask = [None if t is None else t.to(cuda_device)
                                for t in host]
    kw = dict(op=op, mul=mul)
    out = spmv_reduce_push_batched(values, src, w, ro, mask, **kw)
    _same_bits(out.cpu().numpy(),
               spmv_reduce_push_batched_plain(*host, **kw).numpy(),
               any_nan=True)
    for b in range(batch):
        _same_bits(out[b].cpu().numpy(),
                   spmv_reduce_push(values[b], src, w, ro, mask,
                                    **kw).cpu().numpy())
