"""The min/max push kernel against its plain version.

The plain version's semantics are pinned on the CPU against a per-row loop
in numpy, bitwise: min and max give the same answer in any order.  The CUDA
kernel is held bitwise against the plain version on the card.  Every
(⊕, ⊗, dtype) with a kernel entry is covered, {min, max} × {+, ×, min} ×
{f32, i32}, with masks, empty rows, ±∞, NaN, the int32 extrema, i32 sums
and products that wrap, and denormals; on the card also the merge path's
edge cases (every edge in one row, a hub between runs of empty rows, a
sub-range of the edges, rows at the tile size ±1, a fully masked hub) at
every built tile.  The f32 semirings also run over bf16/f16 weights
(widened exactly), bitwise the same way.
This file imports neither JAX nor the JAX package, so the card's tests run
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_reduce_kernel.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv.kernel import (REDUCE_ENTRIES, reduce_identity,
                                             spmv_reduce_push,
                                             spmv_reduce_push_plain)

#: (op, mul, numpy dtype) of every kernel entry
SEMIRINGS = [(op, mul, dt) for op in ("min", "max")
             for mul in ("plus", "times", "min")
             for dt in (np.float32, np.int32)]
TINY = np.float32(1e-38)  # just above the smallest normal f32
I32 = np.iinfo(np.int32)


def _operands(op, mul, dt, n_src, e, rng):
    """Values and weights that hit each semiring's edge cases."""
    if dt == np.int32:
        values = rng.integers(0, 1000, n_src).astype(np.int32)
        values[::7] = I32.max  # unlabelled vertices
        if mul == "min":
            w = np.full(e, I32.max, np.int32)  # unit weights
            w[::5] = rng.integers(0, 1000, w[::5].shape[0])
            return values, w
        # sums and products past the int32 range wrap
        values[1::7] = rng.integers(I32.min, I32.max, values[1::7].shape[0])
        w = rng.integers(-1000, 1000, e).astype(np.int32)
        w[::3] = rng.integers(I32.min, I32.max, w[::3].shape[0])
        return values, w
    if mul == "plus":  # distances: unreached +∞, a NaN, lengths >= 0
        values = (rng.random(n_src) * 10).astype(np.float32)
        values[::6] = np.inf
        values[3] = np.nan
        return values, rng.random(e).astype(np.float32)
    if mul == "min":  # capacities: +∞ on both sides, a NaN
        values = (rng.random(n_src) * 10).astype(np.float32)
        values[::6] = np.inf
        values[4] = np.nan
        w = (rng.random(e) * 10).astype(np.float32)
        w[::5] = np.inf
        w[e // 2:e // 2 + 1] = np.nan
        return values, w
    # widths in [0, 1] with zeros, denormals and a NaN; reliabilities
    # in (0, 1] that push tiny widths below the smallest normal
    values = rng.random(n_src).astype(np.float32)
    values[::6] = 0.0
    values[1::6] = TINY * np.float32(0.75)  # already denormal
    values[2::6] = TINY
    values[5] = np.nan
    w = (1.0 - rng.random(e)).astype(np.float32)
    return values, w


def _csr(op, mul, dt, num_rows, n_src, counts, seed, *, lead=0, tail=0):
    """A CSR matrix with the given per-row edge counts (``lead`` unused
    edges before the first row and ``tail`` after the last) and a mask."""
    rng = np.random.default_rng(seed)
    ro = (lead + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    e = int(ro[-1]) + tail
    src = rng.integers(0, n_src, e).astype(np.int32)
    values, w = _operands(op, mul, dt, n_src, e, rng)
    mask = rng.random(e) < 0.5
    return values, src, w, ro, mask


def _shapes():
    rng = np.random.default_rng(0)
    return {
        # empty rows, one-edge rows, rows longer than a warp, a hub row
        "mixed": (300, 500, np.concatenate([
            [0, 1, 0, 31, 32, 33, 0, 5000],
            rng.integers(0, 40, 292)]), dict()),
        # row offsets that start past edge 0 and stop before the end
        "offset": (50, 80, rng.integers(0, 10, 50), dict(lead=17, tail=9)),
        "no-rows": (0, 10, np.zeros(0, np.int64), dict(tail=4)),
    }


def _loop(op, mul, values, src, w, ro, mask):
    """The reference semantics, one row at a time in numpy."""
    dt = values.dtype
    ident = dt.type(reduce_identity(torch.from_numpy(values).dtype, op))
    out = np.full(ro.shape[0] - 1, ident, dt)
    red = np.minimum if op == "min" else np.maximum  # both keep NaN
    with np.errstate(invalid="ignore", over="ignore"):
        for v in range(out.shape[0]):
            for e in range(ro[v], ro[v + 1]):
                if mask is not None and not mask[e]:
                    continue
                x, y = values[src[e]], w[e]
                c = (x + y if mul == "plus" else x * y if mul == "times"
                     else np.minimum(x, y))
                out[v] = red(out[v], c)
    return out


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit for bit, except that any NaN matches any NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        np.testing.assert_array_equal(nan, np.isnan(b))
        a, b = a[~nan], b[~nan]
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _ids(sr):
    """``op_mul``, with the dtype appended where it is not the shipped
    semiring's (i32 for min_min, f32 otherwise)."""
    op, mul, dt = sr
    usual = np.int32 if (op, mul) == ("min", "min") else np.float32
    return f"{op}_{mul}" + ("" if dt == usual else
                            "_i32" if dt == np.int32 else "_f32")


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("name", ["mixed", "offset", "no-rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_version_matches_a_row_loop(semiring, name, masked):
    op, mul, dt = semiring
    rows, n_src, counts, kw = _shapes()[name]
    values, src, w, ro, mask = _csr(op, mul, dt, rows, n_src, counts, 1, **kw)
    mask = mask if masked else None
    want = _loop(op, mul, values, src, w, ro, mask)
    args = [None if a is None else torch.from_numpy(a)
            for a in (values, src, w, ro, mask)]
    got = spmv_reduce_push_plain(*args, op=op, mul=mul)
    _same_bits(got.numpy(), want)
    # CPU tensors take the plain version and launch nothing
    before = spmv_reduce_push.launches
    _same_bits(spmv_reduce_push(*args, op=op, mul=mul).numpy(), want)
    assert spmv_reduce_push.launches == before


def test_plain_version_edge_cases():
    # an empty row gets the identity; +∞ + length stays +∞; the CPU keeps
    # denormal products; NaN propagates through ⊗ and ⊕
    ro = torch.tensor([0, 0, 2, 3, 5], dtype=torch.int32)
    src = torch.tensor([0, 1, 0, 2, 0], dtype=torch.int32)
    dist = torch.tensor([np.inf, 2.0, np.nan])
    out = spmv_reduce_push_plain(dist, src, torch.ones(5), ro, op="min",
                                 mul="plus")
    assert out[0] == np.inf and out[1] == 3.0 and out[2] == np.inf
    assert torch.isnan(out[3])
    width = torch.tensor([TINY, 1.0, 0.0])
    out = spmv_reduce_push_plain(width, src, torch.full((5,), 0.5), ro,
                                 op="max", mul="times")
    assert out[0] == -np.inf and out[1] == 0.5
    assert 0.0 < out[2] == out[3] < TINY  # a denormal, not flushed
    lab = torch.tensor([5, 3, 9], dtype=torch.int32)
    out = spmv_reduce_push_plain(lab, src, torch.full((5,), 2**31 - 1,
                                                      dtype=torch.int32),
                                 ro, op="min", mul="min")
    assert out.tolist() == [2**31 - 1, 3, 5, 5]
    assert reduce_identity(torch.int32, "max") == -2**31
    with pytest.raises(ValueError):
        reduce_identity(torch.float32, "sum")


#: the f32 semirings, which also take bf16/f16 weights
F32_SEMIRINGS = [sr for sr in SEMIRINGS if sr[2] == np.float32]
NARROW = [torch.bfloat16, torch.float16]


def _narrow_csr(semiring, wdtype, seed):
    """``_csr`` over the mixed shape with the weights rounded to
    ``wdtype``: (values, src, narrow w, row offsets, mask) tensors."""
    op, mul, dt = semiring
    rows, n_src, counts, kw = _shapes()["mixed"]
    values, src, w, ro, mask = (torch.from_numpy(a) for a in _csr(
        op, mul, dt, rows, n_src, counts, seed, **kw))
    return values, src, w.to(wdtype), ro, mask


@pytest.mark.parametrize("semiring", F32_SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("wdtype", NARROW, ids=str)
def test_plain_version_widens_narrow_weights(semiring, wdtype):
    """bf16/f16 weights under f32 values: the push is the row loop over the
    exactly widened weights, bit for bit, and the f32 push of them."""
    op, mul, _ = semiring
    values, src, w, ro, mask = _narrow_csr(semiring, wdtype, 8)
    got = spmv_reduce_push_plain(values, src, w, ro, mask, op=op, mul=mul)
    assert got.dtype == torch.float32
    _same_bits(got.numpy(), _loop(op, mul, values.numpy(), src.numpy(),
                                  w.float().numpy(), ro.numpy(),
                                  mask.numpy()))
    _same_bits(spmv_reduce_push(values, src, w, ro, mask, op=op,
                                mul=mul).numpy(), got.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the min/max kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", F32_SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("wdtype", NARROW, ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_narrow_entries_match_plain_version_bitwise(cuda_device, semiring,
                                                    wdtype, masked):
    """Each of the twelve narrow-weight entries bitwise the plain version,
    and each row of its batched launch bitwise the single push."""
    from repro_torch.kernels.spmv.kernel import spmv_reduce_push_batched

    op, mul, _ = semiring
    host = list(_narrow_csr(semiring, wdtype, 10))
    if not masked:
        host[4] = None
    args = [None if t is None else t.to(cuda_device) for t in host]
    before = spmv_reduce_push.launches
    out = spmv_reduce_push(*args, op=op, mul=mul)
    torch.cuda.synchronize()
    assert spmv_reduce_push.launches == before + 1
    _same_bits(out.cpu().numpy(),
               spmv_reduce_push_plain(*host, op=op, mul=mul).numpy())
    values = args[0]
    bank = torch.stack([values, values.flip(0), values * 0.5])
    rows = spmv_reduce_push_batched(bank, *args[1:], op=op, mul=mul)
    for b in range(3):
        _same_bits(rows[b].cpu().numpy(), spmv_reduce_push(
            bank[b].contiguous(), *args[1:], op=op, mul=mul).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", SEMIRINGS, ids=_ids)
@pytest.mark.parametrize("name", ["mixed", "offset", "no-rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_version_bitwise(cuda_device, semiring, name,
                                              masked):
    op, mul, dt = semiring
    rows, n_src, counts, kw = _shapes()[name]
    host = [torch.from_numpy(a) for a in
            _csr(op, mul, dt, rows, n_src, counts, 2, **kw)]
    if not masked:
        host[4] = None
    args = [None if t is None else t.to(cuda_device) for t in host]
    before = spmv_reduce_push.launches
    out = spmv_reduce_push(*args, op=op, mul=mul)
    torch.cuda.synchronize()
    assert spmv_reduce_push.launches == before + (rows > 0)
    _same_bits(out.cpu().numpy(),
               spmv_reduce_push_plain(*host, op=op, mul=mul).numpy())
    # no atomics: a second launch gives the same bits
    _same_bits(out.cpu().numpy(),
               spmv_reduce_push(*args, op=op, mul=mul).cpu().numpy())


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    values, src, w, ro, mask = [
        torch.from_numpy(a).to(cuda_device)
        for a in _csr("min", "plus", np.float32, 10, 20, np.full(10, 3), 3)]
    kw = dict(op="min", mul="plus")
    bad = [
        (values.double(), src, w, ro),            # f64 values
        (values, src.long(), w, ro),               # int64 ids
        (values, src, w.int(), ro),                # weights of another dtype
        (values, src, w[:-1], ro),                 # misaligned weights
        (values, src[::2], w[::2], ro),            # non-contiguous
        (values, src, w, ro.cpu()),                # mixed devices
        (values[None], src, w, ro),                # 2-D values
    ]
    for args in bad:
        with pytest.raises(ValueError):
            spmv_reduce_push(*args, **kw)
    with pytest.raises(ValueError):
        spmv_reduce_push(values, src, w, ro, mask.float(), **kw)
    # every min/max triple over f32 and i32 has an entry; other dtypes none
    with pytest.raises(ValueError, match="no kernel"):
        spmv_reduce_push(values.double(), src, w.double(), ro, op="max",
                         mul="plus")
    assert set(REDUCE_ENTRIES) == {(op, mul, getattr(torch, np.dtype(
        dt).name)) for op, mul, dt in SEMIRINGS}


def _merge_cases(tile):
    """Layouts that stress the merge path's partition, whose blocks take
    ``tile`` merge items (row ends and edges) each: name -> (n_src, per-row
    edge counts, ``_csr`` keywords, the hub row whose every edge a masked
    run masks, or None)."""
    rng = np.random.default_rng(5)
    short = lambda n: rng.integers(0, 30, n)
    empty = lambda n: np.zeros(n, np.int64)
    return {
        "one-row-holds-all": (1000, np.array([1 << 20]), {}, None),
        "hub-between-empty-runs": (
            5000, np.concatenate([empty(3000), [200_000], empty(3000)]), {},
            None),
        "offset-range": (
            2000, np.concatenate([short(4000), [50_000], short(4000)]),
            dict(lead=5003, tail=7001), None),
        "tile-multiples": (
            2000, np.array([0, 1, tile - 1] + [k * tile + dk
                                              for k in (1, 2, 3)
                                              for dk in (-1, 0, 1)]), {},
            None),
        "hub-fully-masked": (
            2000, np.concatenate([short(1000), [100_000], short(1000)]), {},
            1000),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", [
    ("min", "plus", np.float32), ("max", "times", np.float32),
    ("min", "min", np.int32), ("max", "min", np.float32),
    ("min", "plus", np.int32)], ids=_ids)
@pytest.mark.parametrize("name", ["one-row-holds-all",
                                  "hub-between-empty-runs", "offset-range",
                                  "tile-multiples", "hub-fully-masked"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_on_merge_path_edge_cases(cuda_device, semiring, name,
                                         masked):
    """Hub rows spread over many blocks, empty rows, a sub-range of the
    edges, rows that end on and beside block boundaries: bitwise the plain
    version, the identity in empty and fully masked rows, and a second
    launch bit for bit the first."""
    from repro_torch.kernels.spmv.kernel import REDUCE_SOURCE, merge_tile

    op, mul, dt = semiring
    n_src, counts, kw, hub = _merge_cases(merge_tile(REDUCE_SOURCE))[name]
    host = [torch.from_numpy(a) for a in
            _csr(op, mul, dt, len(counts), n_src, counts, 6, **kw)]
    if not masked:
        host[4] = None
    elif hub is not None:
        host[4][host[3][hub]:host[3][hub + 1]] = False
    args = [None if t is None else t.to(cuda_device) for t in host]
    before = spmv_reduce_push.launches
    out = spmv_reduce_push(*args, op=op, mul=mul)
    torch.cuda.synchronize()
    assert spmv_reduce_push.launches == before + 1
    got = out.cpu().numpy()
    _same_bits(got, spmv_reduce_push_plain(*host, op=op, mul=mul).numpy())
    ident = got.dtype.type(reduce_identity(out.dtype, op))
    assert (got[counts == 0] == ident).all()
    if masked and hub is not None:
        assert got[hub] == ident
    _same_bits(got, spmv_reduce_push(*args, op=op, mul=mul).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [768, 1280, 1792, 2816, 3840])
@pytest.mark.parametrize("name", ["one-row-holds-all",
                                  "hub-between-empty-runs", "offset-range",
                                  "tile-multiples", "hub-fully-masked"])
def test_every_tile_bitwise_the_plain_version(cuda_device, tile, name):
    """Each built tile, ``min_plus`` over f32 and bf16 weights and
    ``min_min`` over i32, masked, on the edge cases cut for that tile:
    bitwise the plain version."""
    from repro_torch.kernels.spmv.kernel import REDUCE_SOURCE, merge_tile

    assert merge_tile(REDUCE_SOURCE, tile) == tile
    n_src, counts, kw, hub = _merge_cases(tile)[name]
    for op, mul, dt, wdtype in (("min", "plus", np.float32, None),
                                ("min", "plus", np.float32, torch.bfloat16),
                                ("min", "min", np.int32, None)):
        host = [torch.from_numpy(a) for a in
                _csr(op, mul, dt, len(counts), n_src, counts, 6, **kw)]
        if wdtype is not None:
            host[2] = host[2].to(wdtype)
        if hub is not None:
            host[4][host[3][hub]:host[3][hub + 1]] = False
        args = [t.to(cuda_device) for t in host]
        out = spmv_reduce_push(*args, op=op, mul=mul, tile=tile)
        _same_bits(out.cpu().numpy(),
                   spmv_reduce_push_plain(*host, op=op, mul=mul).numpy())
