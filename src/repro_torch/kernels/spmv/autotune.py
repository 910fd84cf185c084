"""Merge-path tile tuner for the SpMV pushes on the card (PyTorch port of
``repro.kernels.spmv.autotune``).

The reference tunes the ``(tile_n, chunk)`` geometry of its TPU kernels.
The port's pushes (:mod:`repro_torch.kernels.spmv.kernel`) have one knob
instead: the merge-path tile, the merge items (row ends and edges) one
block takes, a build parameter of both CUDA sources (one library per tile,
:data:`~repro_torch.kernels.spmv.kernel.TILES`).  A small tile puts more
blocks on the card's 132 SMs, which a summary's layout of some 20k edges
needs (at the default 1,792 it fills only a dozen of them); a large one
runs fewer blocks, merge searches and carries, which a full layout of
millions of edges can use.  The engine tunes its full-graph layouts only:
a summary's E_K layout keeps the default tile, since its size changes
with every query and its capacity does not tell it.

``TuneKey``
    ``(e_pad, n, b, dtype, reduce, w_itemsize, platform)``: the edge
    stream's length (the engine's edge capacity; the merge path reads no
    padding), the rows, the batch rows of a call, the values' dtype, the ⊕
    kind (``sum``/``min``/``max``), the stored weight's bytes (2 for
    bf16/f16 weights, which change the bytes a push moves) and the device:
    ``torch.cuda.get_device_name()`` on the card, ``"cpu"`` on the CPU.
    Tunings are never shared across device kinds.

``modeled_push_cost``
    The bytes and operations of one push at a tile, against the card's
    rates in :data:`DEVICE_SPECS`: HBM bytes (``src``, ``w`` at its
    itemsize, the mask byte, row offsets, values, output and the carries'
    scratch written and read) and two operations an edge, and the shared
    memory of a block.  It bounds a push; it does not rank the tiles (a
    model of occupancy and merge searches ranked the full synth-web-lg
    layout wrong on the card).  :mod:`repro_torch.launch.roofline` gates
    on the same numbers.  Tiles whose block does not fit the card's
    shared memory are pruned before any timing.

``tune``
    ``"off"`` gives :data:`~repro_torch.kernels.spmv.kernel.DEFAULT_TILE`;
    ``"cached"`` answers from the in-process cache or a loaded JSON cache,
    else the default tile (no timing, and not written to the cache);
    ``"full"`` times every candidate on the caller's own stream (the
    engine passes the first layout it builds for the key) through the
    real wrappers (a CUDA graph of launches, timed with CUDA events) and
    caches the winner.  ``run_count()`` counts the timed searches (the
    engine's ``autotune_runs``).  On the CPU the plain versions ignore the
    tile, so a ``"cpu"`` key gets the default tile in every mode.

``save_cache`` / ``load_cache``
    JSON persistence (``{"version": 1, "entries": {key: tile}}``), so that
    a later run replays a ``"full"`` tuning under ``"cached"``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.build import record_event
from repro_torch.kernels.spmv.kernel import DEFAULT_TILE, THREADS, TILES

#: the tiles the tuner chooses among (every built tile)
TILE_CANDIDATES = TILES
#: the platform of a key on the CPU
CPU_PLATFORM = "cpu"
#: the modes of :func:`tune` (``EngineConfig.autotune``)
MODES = ("off", "cached", "full")
#: shared memory of a block beside its tile: the block's bounds, the warps'
#: rows and values and the threads' scan values (``merge_push_kernel``)
CARRY_SMEM_BYTES = 8 + 2 * 8 * 4 + 8 * 4 + THREADS * 4


@dataclass(frozen=True)
class DeviceSpec:
    """The figures of one card that the cost model reads."""

    name: str
    smem_per_block: int         # static shared memory a block may use
    hbm_bytes_per_s: float      # device memory rate
    f32_flops: float            # f32 rate outside the tensor cores


#: device name -> its figures (NVIDIA's published H100 SXM figures: 48 KiB
#: of static shared memory a block, 3.35 TB/s, 67 TFLOP/s f32)
DEVICE_SPECS: Dict[str, DeviceSpec] = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        name="NVIDIA H100 80GB HBM3", smem_per_block=48 * 1024,
        hbm_bytes_per_s=3.35e12, f32_flops=67e12),
}


def device_spec(platform: str) -> DeviceSpec:
    """The figures of the card named ``platform``; raises for a card the
    table does not hold (it never falls back to another card's)."""
    spec = DEVICE_SPECS.get(platform)
    if spec is None:
        raise ValueError(
            f"no cost-model figures for device {platform!r}: add it to "
            f"repro_torch.kernels.spmv.autotune.DEVICE_SPECS (it holds "
            f"{sorted(DEVICE_SPECS)})")
    return spec


@dataclass(frozen=True)
class TuneKey:
    """Everything a push's cost depends on."""

    e_pad: int          # edge stream length (the engine's edge capacity)
    n: int              # rows (num_segments)
    b: int              # batch rows a call (1 = a single query)
    dtype: str          # the values' dtype ("float32" / "int32")
    reduce: str         # ⊕ kind: "sum" | "min" | "max"
    platform: str       # torch.cuda.get_device_name(), or "cpu"
    w_itemsize: int = 4  # bytes of a stored weight (2 for bf16/f16)

    def as_str(self) -> str:
        return (f"{self.e_pad}/{self.n}/{self.b}/{self.dtype}/"
                f"{self.reduce}/{self.w_itemsize}/{self.platform}")

    @staticmethod
    def from_str(s: str) -> "TuneKey":
        e_pad, n, b, dtype, reduce, w_itemsize, platform = s.split("/", 6)
        return TuneKey(int(e_pad), int(n), int(b), dtype, reduce, platform,
                       int(w_itemsize))


@dataclass(frozen=True)
class PushCost:
    """The modeled cost of one push at one tile on one card."""

    hbm_bytes: float     # what the push must move: each input read once,
                         # each output and the carries written once
    flops: float         # ⊗ and ⊕ per edge and batch row
    smem_bytes: int      # shared memory of a block
    blocks: int          # blocks of the launch, per batch row
    spec: DeviceSpec

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.spec.hbm_bytes_per_s

    @property
    def compute_s(self) -> float:
        return self.flops / self.spec.f32_flops

    @property
    def bound_time_s(self) -> float:
        """The least time the card could take: bytes or operations."""
        return max(self.memory_s, self.compute_s)


def block_smem_bytes(tile: int, itemsize: int = 4) -> int:
    """Shared memory of one block at ``tile``: each item's row end (4
    bytes) and product (``itemsize``), and the carries' scan."""
    return tile * (4 + itemsize) + CARRY_SMEM_BYTES


def modeled_push_cost(*, e_pad: int, n: int, b: int = 1, itemsize: int = 4,
                      w_itemsize: int = 4, reduce: str = "sum",
                      tile: int = DEFAULT_TILE, masked: bool = False,
                      n_src: Optional[int] = None,
                      spec: Optional[DeviceSpec] = None) -> PushCost:
    """Bytes, operations and shared memory of one push of ``e_pad`` edges
    into ``n`` rows from ``n_src`` (default ``n``) values a batch row, at
    ``tile``, on ``spec`` (default the H100).

    HBM: ``src`` (4 bytes an edge), ``w`` (``w_itemsize``), the mask byte
    when ``masked``, ``n + 1`` row offsets, ``b`` value rows
    (``itemsize``) read once, ``b`` output rows written once, and the
    carries' scratch (a row id and ``b`` values a block) written by the
    first pass and read by the second.  Operations: ⊗ and ⊕, two an edge
    and batch row.  ``reduce`` is part of the key only: the sum and the
    min/max pushes run one merge path.
    """
    del reduce  # one merge path for every ⊕: the same bytes and blocks
    spec = DEVICE_SPECS["NVIDIA H100 80GB HBM3"] if spec is None else spec
    n_src = n if n_src is None else n_src
    blocks = -(-(n + e_pad) // tile)
    per_edge = 4 + w_itemsize + (1 if masked else 0)
    carries = 2 * blocks * (b + 1) * 4
    hbm = (e_pad * per_edge + 4 * (n + 1) + b * itemsize * (n_src + n)
           + carries)
    return PushCost(hbm_bytes=float(hbm), flops=2.0 * b * e_pad,
                    smem_bytes=block_smem_bytes(tile, itemsize),
                    blocks=blocks, spec=spec)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def candidates(key: TuneKey, spec: Optional[DeviceSpec] = None) -> List[int]:
    """The tiles whose block fits the card's shared memory, in
    :data:`TILE_CANDIDATES` order; nothing is built or timed here.
    ``spec`` defaults to the figures of ``key.platform``."""
    spec = device_spec(key.platform) if spec is None else spec
    itemsize = _itemsize(key.dtype)
    return [t for t in TILE_CANDIDATES
            if block_smem_bytes(t, itemsize) <= spec.smem_per_block]


# ---------------------------------------------------------------------------
# the in-process cache and the timed-run counter (the engine reads it)

_CACHE: Dict[TuneKey, int] = {}
_RUNS = 0           # timed ("full") searches this process
_HITS = 0           # answers from the cache (in-process or loaded)


def run_count() -> int:
    """Timed searches so far in this process (cache answers excluded)."""
    return _RUNS


def cache_hits() -> int:
    return _HITS


def clear_cache() -> None:
    global _RUNS, _HITS
    _CACHE.clear()
    _RUNS = 0
    _HITS = 0


def cache_entries() -> Dict[str, int]:
    return {k.as_str(): v for k, v in _CACHE.items()}


def save_cache(path) -> None:
    """Write the in-process cache as JSON."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": 1, "entries": cache_entries()}
    p.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


def load_cache(path) -> int:
    """Merge a JSON cache into the in-process cache; returns the entries
    added.  A tile that is not built (not in :data:`TILE_CANDIDATES`)
    raises."""
    p = Path(path)
    if not p.exists():
        return 0
    payload = json.loads(p.read_text())
    if payload.get("version") != 1:
        raise ValueError(f"{p}: unknown autotune cache version "
                         f"{payload.get('version')!r}")
    added = 0
    for ks, tile in payload.get("entries", {}).items():
        if int(tile) not in TILE_CANDIDATES:
            raise ValueError(f"{p}: tile {tile} of {ks!r} is not one of "
                             f"{TILE_CANDIDATES}")
        key = TuneKey.from_str(ks)
        if key not in _CACHE:
            added += 1
        _CACHE[key] = int(tile)
    return added


# ---------------------------------------------------------------------------
# measurement

def _values(key: TuneKey, dev: torch.device, gen: torch.Generator):
    """Random ``[b, n]`` values of the key's dtype (one vector for
    ``b == 1``)."""
    dtype = getattr(torch, key.dtype)
    shape = (key.n,) if key.b == 1 else (key.b, key.n)
    if dtype.is_floating_point:
        return torch.rand(shape, generator=gen, device=dev)
    return torch.randint(0, 1000, shape, generator=gen, device=dev,
                         dtype=dtype)


def _time_candidate(key: TuneKey, tile: int, *, sample,
                    iters: int = 20) -> float:
    """Mean device time (s) of one push at ``tile`` through the real
    wrappers, from CUDA events around a CUDA graph of ``iters`` launches
    after a warm-up, on ``sample`` (``(src, w, row_offsets)`` on the
    card) with random values.  Raises without a card."""
    from repro_torch.kernels.spmv import kernel as K

    if not torch.cuda.is_available():
        raise RuntimeError("timing a merge tile needs a CUDA device")
    src, w, ro = sample
    gen = torch.Generator(device=src.device)
    gen.manual_seed(0)
    values = _values(key, src.device, gen)
    batched = key.b > 1
    if key.reduce == "sum":
        fn = K.spmv_push_batched if batched else K.spmv_push
        call = lambda: fn(values, src, w, ro, mul="times", tile=tile)
    else:
        fn = K.spmv_reduce_push_batched if batched else K.spmv_reduce_push
        call = lambda: fn(values, src, w, ro, op=key.reduce, mul="plus",
                          tile=tile)
    # tuning launches are not the caller's pushes: the count is put back
    launches = fn.launches
    for _ in range(3):
        call()
    # replayed from a CUDA graph: eager launches of a 20 µs push are held
    # by the wrapper's host cost, which would hide the tiles' differences
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    fn.launches = launches
    return start.elapsed_time(end) / iters * 1e-3


def _timed(key: TuneKey, tile: int, sample) -> float:
    """:func:`_time_candidate`, counted as one tuning timing."""
    record_event("autotune-timing", f"{key.as_str()}@{tile}")
    return _time_candidate(key, tile, sample=sample)


def tune(key: TuneKey, mode: str = "cached", *,
         spec: Optional[DeviceSpec] = None, sample=None) -> int:
    """The merge tile for ``key``.

    ``"off"`` → :data:`DEFAULT_TILE`, no cache interaction.  ``"cached"``
    → the cached answer, else :data:`DEFAULT_TILE` (not cached: the cache
    holds timed or loaded tunings only, so that a later ``"full"`` still
    times).  ``"full"`` → time every candidate on ``sample``, ``(src, w,
    row_offsets)`` of a real layout of the key's shape on the card, and
    cache the fastest; without a ``sample`` it raises.  A ``"cpu"`` key
    gets the default tile in every mode (the plain versions ignore the
    tile).
    """
    global _RUNS, _HITS
    if mode not in MODES:
        raise ValueError(f"unknown autotune mode {mode!r}; expected one of "
                         f"{MODES}")
    if mode == "off" or key.platform == CPU_PLATFORM:
        return DEFAULT_TILE
    hit = _CACHE.get(key)
    if hit is not None:
        _HITS += 1
        return hit
    if mode == "cached":
        return DEFAULT_TILE
    if sample is None:
        raise ValueError(f"autotune='full' for {key.as_str()!r} needs a "
                         f"layout of the key's shape to time on")
    cands = candidates(key, spec)
    if not cands:
        return DEFAULT_TILE
    record_event("autotune-search", key.as_str())
    timed = sorted((_timed(key, t, sample), t) for t in cands)
    best = timed[0][1]
    _RUNS += 1
    _CACHE[key] = best
    return best


def platform_of(device) -> str:
    """The key's platform for ``device``: the card's name, or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_PLATFORM
    return torch.cuda.get_device_name(dev)


def tune_for_push(*, edge_capacity: int, num_segments: int, batch: int = 1,
                  dtype: str = "float32", reduce: str = "sum",
                  weight_dtype: Optional[str] = None, mode: str = "cached",
                  device="cuda", sample=None) -> int:
    """The front door the engine calls at layout-build time: the key from
    its capacities, the batch rows of its calls, the semiring's dtype and
    ⊕, the stored weight dtype (``None`` = the values' dtype) and the
    device, resolved with :func:`tune` (``sample``: the stream a ``full``
    tuning times on)."""
    key = TuneKey(e_pad=edge_capacity, n=num_segments, b=batch, dtype=dtype,
                  reduce=reduce, platform=platform_of(device),
                  w_itemsize=_itemsize(weight_dtype or dtype))
    return tune(key, mode, sample=sample)


__all__ = [
    "DEVICE_SPECS", "DeviceSpec", "MODES", "PushCost", "TILE_CANDIDATES",
    "TuneKey", "block_smem_bytes", "cache_entries", "cache_hits", "candidates",
    "clear_cache", "device_spec", "load_cache", "modeled_push_cost",
    "platform_of", "run_count", "save_cache", "tune", "tune_for_push",
]
