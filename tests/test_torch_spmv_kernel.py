"""The SpMV push kernel against its plain version.

The plain version's semantics are pinned on the CPU against a per-row
loop; the CUDA kernel is held against the plain version in f64 on the card.
f32 results hold rtol 1e-5 against f64: the hub row sums 5000 f32
products, whose rounding alone reaches about 2e-6 relative.  bf16/f16
weights are widened exactly, so the same tolerance holds against the f64
plain version over the same narrow weights; every built merge tile is
held to it too.  This file imports
neither JAX nor the JAX package, so the card's tests run where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_spmv_kernel.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv.kernel import spmv_push, spmv_push_plain

TOL = dict(rtol=1e-5, atol=1e-6)


def _csr(num_rows, n_src, counts, seed, *, lead=0, tail=0):
    """A CSR matrix with the given per-row edge counts, ``lead`` unused
    edges before the first row and ``tail`` after the last, and a mask."""
    rng = np.random.default_rng(seed)
    ro = (lead + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    e = int(ro[-1]) + tail
    src = rng.integers(0, n_src, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    values = rng.random(n_src).astype(np.float32)
    mask = rng.random(e) < 0.5
    return [torch.from_numpy(a) for a in (values, src, w, ro, mask)]


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


def _loop(values, src, w, ro, mask):
    out = np.zeros(ro.shape[0] - 1, np.float64)
    for v in range(out.shape[0]):
        for e in range(ro[v], ro[v + 1]):
            if mask is None or mask[e]:
                out[v] += float(values[src[e]]) * float(w[e])
    return out


@pytest.mark.parametrize("name", ["mixed", "offset", "no-rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_version_matches_a_row_loop(name, masked):
    rows, n_src, counts, kw = _shapes()[name]
    values, src, w, ro, mask = _csr(rows, n_src, counts, 1, **kw)
    mask = mask if masked else None
    want = _loop(*(None if t is None else t.numpy()
                   for t in (values, src, w, ro, mask)))
    got64 = spmv_push_plain(values, src, w, ro, mask, dtype=torch.float64)
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-12, atol=0)
    got = spmv_push(values, src, w, ro, mask)  # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (rows,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mul", ["plus", "min"])
def test_plain_version_sums_each_mul(mul):
    """The sum over ⊗ = + and min (registered sum semirings), in f64,
    against a row loop."""
    rows, n_src, counts, kw = _shapes()["mixed"]
    values, src, w, ro, mask = _csr(rows, n_src, counts, 3, **kw)
    v, s, wt, r, m = (t.numpy() for t in (values, src, w, ro, mask))
    want = np.zeros(rows)
    for row in range(rows):
        for e in range(r[row], r[row + 1]):
            if m[e]:
                x, y = float(v[s[e]]), float(wt[e])
                want[row] += x + y if mul == "plus" else min(x, y)
    got = spmv_push_plain(values, src, w, ro, mask, mul=mul,
                          dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        spmv_push(values, src, w, ro, mask, mul=mul).numpy(), want, **TOL)
    with pytest.raises(ValueError, match="mul"):
        spmv_push(values, src, w, ro, mask, mul="max")


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("mul", ["times", "plus", "min"])
def test_plain_version_widens_narrow_weights(wdtype, mul):
    """bf16/f16 weights: the push is the f32 push of the exactly widened
    weights, bit for bit, and the f64 row loop over them."""
    rows, n_src, counts, kw = _shapes()["mixed"]
    values, src, w, ro, mask = _csr(rows, n_src, counts, 8, **kw)
    narrow = w.to(wdtype)
    got = spmv_push(values, src, narrow, ro, mask, mul=mul)
    assert got.dtype == torch.float32
    assert torch.equal(got, spmv_push(values, src, narrow.float(), ro, mask,
                                      mul=mul))
    if mul == "times":
        want = _loop(*(t.numpy() for t in (values, src, narrow.float(), ro,
                                           mask)))
        np.testing.assert_allclose(
            spmv_push_plain(values, src, narrow, ro, mask,
                            dtype=torch.float64).numpy(), want, rtol=1e-12,
            atol=0)


def test_tiles_are_checked_and_sized():
    from repro_torch.kernels.spmv.kernel import (DEFAULT_TILE, THREADS,
                                                 TILES, scratch_blocks,
                                                 tile_defines)

    assert DEFAULT_TILE in TILES
    for tile in TILES:
        assert tile % THREADS == 0 and (tile // THREADS) % 2 == 1
        assert tile_defines(tile) == (f"MERGE_ITEMS={tile // THREADS}",)
    assert scratch_blocks(300, 5000, 1792) == 3
    assert scratch_blocks(300, 5076, 768) == 7
    values, src, w, ro, mask = _csr(10, 20, np.full(10, 3), 3)
    for bad in (1000, 2048, 0):
        with pytest.raises(ValueError, match="merge tile"):
            spmv_push(values, src, w, ro, tile=bad)
    # the plain version ignores a valid tile
    assert torch.equal(spmv_push(values, src, w, ro, tile=768),
                       spmv_push(values, src, w, ro))


def test_merge_tile_refuses_a_library_of_another_tile(monkeypatch):
    """The carries' scratch is sized from the library's own tile: one that
    reports another tile than it was built for is refused."""
    from repro_torch.kernels.spmv import kernel as K

    asked = []

    def fake_entry(source, entry, argtypes, defines=()):
        asked.append(defines)
        return lambda: 1280

    monkeypatch.setattr(K, "load_entry", fake_entry)
    K.merge_tile.cache_clear()
    try:
        assert K.merge_tile(K.SOURCE, 1280) == 1280
        with pytest.raises(RuntimeError, match="reports tile 1280"):
            K.merge_tile(K.REDUCE_SOURCE, 768)
    finally:
        K.merge_tile.cache_clear()
    assert asked == [("MERGE_ITEMS=5",), ("MERGE_ITEMS=3",)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SpMV kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("mul", ["times", "plus", "min"])
@pytest.mark.parametrize("masked", [False, True])
def test_narrow_entries_match_plain_version(cuda_device, wdtype, mul,
                                            masked):
    """Each narrow-weight entry within TOL of the f64 plain version, twice
    bit for bit, and each row of its batched launch bitwise the single."""
    from repro_torch.kernels.spmv.kernel import spmv_push_batched

    rows, n_src, counts, kw = _shapes()["mixed"]
    values, src, w, ro, mask = [t.to(cuda_device)
                                for t in _csr(rows, n_src, counts, 9, **kw)]
    w = w.to(wdtype)
    mask = mask if masked else None
    before = spmv_push.launches
    out = spmv_push(values, src, w, ro, mask, mul=mul)
    torch.cuda.synchronize()
    assert spmv_push.launches == before + 1
    ref = spmv_push_plain(values, src, w, ro, mask, mul=mul,
                          dtype=torch.float64)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert torch.equal(out, spmv_push(values, src, w, ro, mask, mul=mul))
    bank = torch.stack([values, values * 0.5, values.flip(0)])
    rows_out = spmv_push_batched(bank, src, w, ro, mask, mul=mul)
    for b in range(3):
        assert torch.equal(rows_out[b], spmv_push(bank[b].contiguous(), src,
                                                  w, ro, mask, mul=mul))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [768, 1280, 1792, 2816, 3840])
@pytest.mark.parametrize("name", ["one-row-holds-all",
                                  "hub-between-empty-runs", "offset-range",
                                  "tile-multiples", "hub-fully-masked"])
def test_every_tile_on_merge_path_edge_cases(cuda_device, tile, name):
    """Each built tile, f32 and bf16 weights, masked: within TOL of the
    f64 plain version on the edge cases cut for that tile, empty and fully
    masked rows exactly 0, the batched rows bitwise the single push."""
    from repro_torch.kernels.spmv.kernel import merge_tile, spmv_push_batched

    assert merge_tile(tile=tile) == tile
    n_src, counts, kw, hub = _merge_cases(tile)[name]
    host = _csr(len(counts), n_src, counts, 6, **kw)
    values, src, w, ro, mask = [t.to(cuda_device) for t in host]
    if hub is not None:
        mask[ro[hub]:ro[hub + 1]] = False
    for wt in (w, w.to(torch.bfloat16)):
        out = spmv_push(values, src, wt, ro, mask, tile=tile)
        ref = spmv_push_plain(values, src, wt, ro, mask, dtype=torch.float64)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **TOL)
        assert bool((out[torch.from_numpy(counts == 0).to(cuda_device)]
                     == 0).all())
        if hub is not None:
            assert float(out[hub]) == 0.0
        bank = torch.stack([values, values * 0.5])
        rows = spmv_push_batched(bank, src, wt, ro, mask, tile=tile)
        assert torch.equal(rows[0], out)


@pytest.mark.gpu
def test_a_missing_entry_raises_and_never_falls_back(cuda_device,
                                                    monkeypatch):
    """A narrow-weight push whose entry the library lacks raises; it does
    not take the plain version."""
    from repro_torch.kernels.spmv import kernel as K

    values, src, w, ro, _ = [t.to(cuda_device)
                             for t in _csr(10, 20, np.full(10, 3), 3)]
    monkeypatch.setitem(K.WEIGHT_TAGS, torch.bfloat16, "_wmissing")
    before = spmv_push.launches
    with pytest.raises(AttributeError, match="_wmissing"):
        spmv_push(values, src, w.to(torch.bfloat16), ro)
    assert spmv_push.launches == before


@pytest.mark.gpu
def test_scratch_sized_for_another_tile_is_refused(cuda_device, monkeypatch):
    """Scratch for fewer blocks than the library's tile launches is
    refused by the launch, not overrun."""
    from repro_torch.kernels.spmv import kernel as K

    values, src, w, ro, _ = [t.to(cuda_device)
                             for t in _csr(300, 500, np.full(300, 20), 3)]
    real = K.scratch_blocks
    monkeypatch.setattr(K, "scratch_blocks",
                        lambda rows, edges, tile: real(rows, edges, 3840))
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmv_push(values, src, w, ro, tile=768)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixed", "offset", "no-rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_version(cuda_device, name, masked):
    rows, n_src, counts, kw = _shapes()[name]
    args = [t.to(cuda_device) for t in _csr(rows, n_src, counts, 2, **kw)]
    values, src, w, ro, mask = args
    mask = mask if masked else None
    before = spmv_push.launches
    out = spmv_push(values, src, w, ro, mask)
    torch.cuda.synchronize()
    assert spmv_push.launches == before + (rows > 0)
    ref = spmv_push_plain(values, src, w, ro, mask, dtype=torch.float64)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    # no atomics: a second launch gives the same bits
    assert torch.equal(out, spmv_push(values, src, w, ro, mask))


def _merge_cases(tile):
    """Layouts that stress the sum kernel's merge-path partition, whose
    blocks take ``tile`` merge items (row ends and edges) each: name ->
    (n_src, per-row edge counts, ``_csr`` keywords, the hub row whose every
    edge a masked run masks, or None)."""
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
@pytest.mark.parametrize("name", ["one-row-holds-all",
                                  "hub-between-empty-runs", "offset-range",
                                  "tile-multiples", "hub-fully-masked"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_on_merge_path_edge_cases(cuda_device, name, masked):
    """Hub rows spread over many blocks, empty rows, a sub-range of the
    edges, rows that end on and beside block boundaries: every row within
    TOL of the f64 plain version, empty and fully masked rows exactly 0,
    and a second launch bit for bit the first."""
    from repro_torch.kernels.spmv.kernel import merge_tile

    n_src, counts, kw, hub = _merge_cases(merge_tile())[name]
    host = _csr(len(counts), n_src, counts, 6, **kw)
    values, src, w, ro, mask = [t.to(cuda_device) for t in host]
    if not masked:
        mask = None
    elif hub is not None:
        mask[ro[hub]:ro[hub + 1]] = False
    before = spmv_push.launches
    out = spmv_push(values, src, w, ro, mask)
    torch.cuda.synchronize()
    assert spmv_push.launches == before + 1
    ref = spmv_push_plain(values, src, w, ro, mask, dtype=torch.float64)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert bool((out[torch.from_numpy(counts == 0).to(cuda_device)]
                 == 0).all())
    if masked and hub is not None:
        assert float(out[hub]) == 0.0
    assert torch.equal(out, spmv_push(values, src, w, ro, mask))


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    values, src, w, ro, mask = [t.to(cuda_device)
                                for t in _csr(10, 20, np.full(10, 3), 3)]
    bad = [
        (values.double(), src, w, ro),            # f64 values
        (values, src.long(), w, ro),               # int64 ids
        (values, src, w[:-1], ro),                 # misaligned weights
        (values, src[::2], w[::2], ro),            # non-contiguous
        (values, src, w, ro.cpu()),                # mixed devices
        (values[None], src, w, ro),                # 2-D values
    ]
    for args in bad:
        with pytest.raises(ValueError):
            spmv_push(*args)
    with pytest.raises(ValueError):
        spmv_push(values, src, w, ro, mask.float())


@pytest.mark.gpu
def test_push_on_the_gpu_runs_the_kernel_or_raises(cuda_device):
    from repro_torch.core import backend as B
    from repro_torch.graph.graph import from_edges

    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 400).astype(np.int32)
    dst = rng.integers(0, 50, 400).astype(np.int32)
    state = from_edges(src, dst, 50, 450, device=cuda_device)
    values = torch.rand(50, device=cuda_device)
    before = spmv_push.launches
    out = B.push(values, B.build_layout(state))
    assert spmv_push.launches == before + 1
    cpu = B.push(values.cpu(), B.build_layout(
        from_edges(src, dst, 50, 450, device="cpu")))
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), **TOL)
    # a min/max semiring launches the min/max kernel, not the SpMV one
    from repro_torch.kernels.spmv.kernel import spmv_reduce_push
    before, reduce_before = spmv_push.launches, spmv_reduce_push.launches
    widths = B.push(values, B.build_layout(state, weight="unit",
                                           semiring="max_times"),
                    semiring="max_times")
    assert (spmv_push.launches, spmv_reduce_push.launches) == (
        before, reduce_before + 1)
    assert torch.equal(widths.cpu(), B.push(values.cpu(), B.build_layout(
        from_edges(src, dst, 50, 450, device="cpu"), weight="unit",
        semiring="max_times"), semiring="max_times"))
    # a [B, N] push is one launch of the batched kernel of its semiring,
    # and a bank that is not contiguous is refused, not copied
    from repro_torch.kernels.spmv.kernel import (spmv_push_batched,
                                                 spmv_reduce_push_batched)
    bank = torch.stack([values, values * 0.5])
    counts = lambda: (spmv_push.launches, spmv_reduce_push.launches,
                      spmv_push_batched.launches,
                      spmv_reduce_push_batched.launches)
    before = counts()
    sums = B.push(bank, B.build_layout(state))
    widths = B.push(bank, B.build_layout(state, weight="unit",
                                         semiring="max_times"),
                    semiring="max_times")
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    np.testing.assert_allclose(sums[0].cpu().numpy(), out.cpu().numpy(),
                               **TOL)
    assert sums.shape == widths.shape == (2, 50)
    with pytest.raises(ValueError, match="contiguous"):
        B.push(values[None].expand(2, -1), B.build_layout(state))
    # narrow weights launch their entries of the same kernel, within TOL of
    # the plain version over the same narrow weights
    for wd in ("bfloat16", "float16"):
        narrow = B.build_layout(state, weight_dtype=wd)
        before = spmv_push.launches
        got = B.push(values, narrow)
        assert spmv_push.launches == before + 1
        ref = spmv_push_plain(values, narrow.src, narrow.weight,
                              narrow.row_offsets, dtype=torch.float64)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   **TOL)


@pytest.mark.gpu
def test_push_launches_a_kernel_for_every_registered_semiring(cuda_device):
    """A semiring a user registers runs on the card through ``push``: every
    min/max one over f32 or i32 on the min/max kernel (bitwise the CPU's
    push), every f32 sum on the SpMV kernel (within TOL); a sum outside f32
    has no kernel, as on the reference's Pallas path."""
    from repro_torch.core import backend as B
    from repro_torch.core.semiring import Semiring, register_semiring
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels.spmv.kernel import spmv_reduce_push

    rng = np.random.default_rng(12)
    src = rng.integers(0, 60, 500).astype(np.int32)
    dst = rng.integers(0, 60, 500).astype(np.int32)
    lengths = (0.5 + rng.random(500)).astype(np.float32)
    graphs = {d: from_edges(src, dst, 60, 520, weights=lengths, device=d)
              for d in ("cpu", cuda_device)}
    for add, mul, dtype in [("max", "min", "float32"),
                            ("min", "plus", "int32"),
                            ("max", "times", "int32"),
                            ("min", "times", "float32"),
                            ("sum", "plus", "float32"),
                            ("sum", "min", "float32")]:
        name = f"card_{add}_{mul}_{dtype}"
        register_semiring(Semiring(name, add, mul, dtype))
        values = torch.from_numpy(
            rng.integers(0, 100, 60).astype(dtype) if dtype == "int32"
            else rng.random(60).astype(dtype))
        outs = {}
        for d, g in graphs.items():
            layout = B.build_layout(g, weight="length", semiring=name)
            counts = (spmv_push.launches, spmv_reduce_push.launches)
            outs[d] = B.push(values.to(d), layout, semiring=name).cpu()
            made = (spmv_push.launches - counts[0],
                    spmv_reduce_push.launches - counts[1])
            assert made == ((0, 0) if d == "cpu" else
                            (1, 0) if add == "sum" else (0, 1)), name
        if add == "sum":
            np.testing.assert_allclose(outs[cuda_device].numpy(),
                                       outs["cpu"].numpy(), **TOL)
        else:
            assert torch.equal(outs[cuda_device], outs["cpu"]), name
    register_semiring(Semiring("card_sum_times_float64", "sum", "times",
                               "float64"))
    layout = B.build_layout(graphs[cuda_device], weight="length",
                            semiring="card_sum_times_float64")
    with pytest.raises(NotImplementedError, match="no GPU kernel"):
        B.push(torch.rand(60, dtype=torch.float64, device=cuda_device),
               layout, semiring="card_sum_times_float64")
