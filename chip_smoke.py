#!/usr/bin/env python3
"""Smoke run of the PyTorch port of VeilGraph on one CUDA card.

    python3 chip_smoke.py

Builds the five kernel sources (``src/repro_torch/kernels/*/csrc``: the
SpMV push and the min/max push, each in a single and a batched form and
once per merge-path tile, the flash attention forward and backward, each
also with ``-DATTN_DYNAMIC`` for its dynamic-offset entry, and decode
attention; one ``nvcc`` per source, tile and define, started together) and holds
every kernel against its plain version at the shapes its path gives it,
each batched row also bitwise against the single kernel and each push
against a second launch of itself (the shapes include every edge of the
stream in one row).  Every entry that no shipped semiring launches (nine
min/max semirings, the sum with ⊗ = + and min) is checked once, as a
registered semiring, at a small synth-web-lg layout; every bf16/f16-weight
entry at the full layout, with and without the b_in mask; every built
tile against the default one, timed at the full layout and at a
summary-sized one beside the cost model.  Each SpMV bound comes from
``repro_torch.launch.roofline``, the tuner's own byte count.  Then it
drives these paths over the ``synth-web-lg`` stream:

- PageRank through ``repro_torch.session``: the initial exact query, 11
  approximate queries and one exact one, every push through ``spmv_push``;
  two queries are replayed on the CPU with the plain versions;
- traversal through ``repro_torch.session``: SSSP, widest path and
  connected components, approximate and exact queries, every push through
  ``spmv_reduce_push``; each session is replayed on the CPU and must agree
  bitwise, and its exact answer must equal an independent graph search;
- serving through ``repro_torch.serve_session`` at ``slots=4``: 10
  personalized-PageRank seeds, 4 SSSP and 2 widest-path sources and one
  query each of connected components, Katz and HITS, with stream chunks
  applied between waves; every push of a wave is one launch of
  ``spmv_push_batched`` or ``spmv_reduce_push_batched``.  The run is
  replayed on the CPU (bitwise for the min/max lanes, whose answers also
  equal scipy's searches), and every ticket of the PPR, Katz and HITS
  lanes is held against an f64 replay of its wave, from a bank rebuilt
  from the wave's tickets alone;
- the closed loop: PageRank at ``quality_target=0.95`` (12 queries) and
  SSSP at 0.9 (5 queries) through ``repro_torch.session``, and the serving
  plan at 0.95.  Each drift reading is held against the host's f64
  recomputation from the card's own state and layouts, each decision
  against a fresh controller fed the card's readings, and each drift push
  is one kernel launch; every query prints the quality measured against an
  exact replay of its graph;
- the async rebuild: PageRank, SSSP and CC (and PageRank at 0.95) with
  ``async_rebuild=True``, each bitwise against a synchronous session fed
  each epoch's updates before its first query serving it, under forced
  approximate, exact and repeat-last actions; a served snapshot's buffers
  hash alike across the next build, and an add-only integrate makes no
  host sync (CUDA's sync debug mode).  One more PageRank run holds each
  build back behind a sleep on the build stream, so that builds still run
  when the next query promotes them.  The serving plan with
  ``async_rebuild=True`` is bitwise a synchronous run fed each chunk one
  wave later;
- the tuned narrow path: PageRank with ``weight_dtype="bfloat16"`` and
  ``autotune="full"`` (RBO@4000 against the exact replay), again under
  ``"cached"`` after ``load_cache`` of what ``full`` saved (no timed run,
  the same tiles), SSSP over bf16-exact lengths bitwise the f32 session,
  and the serving plan with both knobs (min/max answers bitwise the f32
  run's, sums within 1% L1); the bf16 PageRank session's summed push
  device time under ``autotune="off"`` and ``"full"``, full-graph and
  summary layouts apart;
- the sharded engine on a 1-rank NCCL mesh (an in-process store, no
  network) at 8 edge shards: PageRank over the main path's 12 queries, SSSP
  and CC at the traversal settings, a forced-imbalance SSSP stream (edge
  capacity twice the edges, so every live slot starts in the head shards:
  exactly one recut, to live counts within 1) and one ``serve_session``
  wave (2 PPR and 2 SSSP tickets), each against an unsharded session on
  the card (SSSP and CC bitwise; PageRank within rtol 1e-5, atol 1e-6
  where both sessions pick the same hot set and E_K, else both at RBO@4000
  ≥ 0.95 against an f64 exact replay); every push of these runs is 8
  launches, one a shard.  Then the push's time through 8 shards beside
  one layout's, and the four SpMV kernels on a shard's stream;
- the mesh engine across four ranks of the one card (``mesh-ranks``):
  four spawned processes, each its own CUDA context on device 0, joined
  in a gloo group (CUDA tensors staged through the host; NCCL refuses two
  ranks on one device) and a 1-D mesh, at 8 shards, two a rank: the
  PageRank, SSSP, CC and forced-imbalance SSSP streams above, an async
  PageRank stream and one serving wave, each rank's answers and stats
  bitwise every other rank's and held to the unsharded runs on the card
  as above (and the async stream to an unsharded async run); each rank's
  launches two a sharded push, counted in that rank; no rank builds a
  kernel or imports JAX, and a rank that raises or outlasts the group's
  timeout fails the phase;
- the two examples on the card (``examples``):
  ``examples/streaming_pagerank_torch.py`` on synth-web-lg (10 queries,
  the paper's four metrics a query) and ``examples/quickstart_torch.py``;
- the hot-path analysis gates (``repro_torch.analysis``): every program of
  the catalog (push, push_coo, build_summary, the fused steps and serving
  waves, the apply steps, the epoch counts, at 1,024 vertices and 16,384
  edge slots) once under both the dispatch lint and CUDA's sync debug
  mode (``"error"`` where the baseline lists no host read of the program
  on the card) with its peak allocation, and held to the CPU run of the
  same program; both canned engine loops untuned and under
  ``autotune="full"`` from an empty tuner cache (the warm-up must time
  the served key once), and the sync loop under ``"cached"`` from the
  saved tile, each adding no kernel build, library load or tuning run
  after warm-up; and the AST lint.  A finding
  on the card that ``src/repro_torch/analysis/baseline.json`` does not
  allow fails the run;
- the kernels' convenience wrappers (``kernels/*/ops.py``) against their
  refs and plain versions: ``pagerank_push``, ``semiring_push`` (sum,
  min/max single and batched), ``flash_attention_op`` and
  ``decode_attention_op``;

and the LM paths:

- the two attention kernels against their plain versions at Qwen2-0.5B's
  widths (f32 against f64, bf16 against f64), timed in bf16 beside the
  plain version and ``scaled_dot_product_attention``;
- LM serving through ``repro_torch.serve.ServingEngine`` on Qwen2-0.5B at
  full width (24 layers, seeded weights, greedy): 16 requests of 2048
  prompt tokens and 64 new tokens on 8 slots, every attention call one
  launch of ``flash_attention`` (prefill) or ``decode_attention`` (decode
  step) and no plain call; wave 0 is replayed on the card through the
  plain attention versions on the served tokens, and every step's logits
  must agree; no serving launch writes the log-sum-exp;
- the flash backward (and the forward's log-sum-exp and f32 output)
  against their f64 plain versions at the training shape (B = 4, S = 2048,
  14 heads, 2 KV heads, bf16), a ragged length with a window, G = 1 and
  the f32 entry, each gradient bitwise across two launches; at the
  training shapes (Qwen2-0.5B's; Zamba2-7B's hd 112, 32/32 heads;
  MiniCPM3-4B's hd 96 with vd 64, 40/40; and the MLA smoke dims) the
  backward's device time beside the forward's (with and without lse), the
  plain backward, ``scaled_dot_product_attention`` forward + backward and
  the bound;
- LM training on Qwen2-0.5B at full width and depth (f32 params, bf16
  activations, ``SyntheticLMData(lag=1)`` over 4,096 ids, B = 4, S =
  2048): one step's gradients through the kernels against the same step
  through the plain attention (loss, grad norm, every leaf's relative
  L2, beside a control: the plain step at half the tiles), then 30
  donated AdamW steps with remat and the cosine schedule through
  ``RestartableLoop`` (the loss must fall; 48 flash forward launches, the
  24 of remat's recomputation included, all with lse, and 24 backward
  calls a step), a checkpoint saved at step 10 restored bitwise into
  fresh tensors and steps 11 and 12 resumed from it;
- the attention kernels at the MoE family's shapes (head dim 128, 48
  query heads over 8 KV heads): Mixtral-8x22B's prefill past its
  4,096-token window (B = 1, S = 6144), DBRX-132B's served prefill (B = 4,
  S = 2048) and decode over a full 4,096-slot ring (B = 4);
- MoE serving at full width with the depth cut: Mixtral-8x22B (4 of 56
  layers; 8 requests of 6,144 prompt and 32 new tokens on 4 slots, so the
  prefill's window mask applies and every decode step wraps the ring) and
  DBRX-132B (2 of 40 layers; 4 requests of 2,048 + 16), one flash launch
  per layer and wave, one decode launch per layer and step, no plain
  call; each layer's share of prefill assignments dropped by capacity;
  wave 0 replayed through the plain attention versions with the served
  expert ids forced (a bf16 rounding difference can flip a near-tied
  route), the routes the unforced replay would flip reported;
- SSM serving: Mamba2-2.7B at full width and depth (8 requests of 4,096 +
  64 on 4 slots), no attention launch, and its chunked scan (a prefill of
  S + 1 tokens) against the served recurrence (a prefill of S, then one
  decode step) within the same logit tolerance;
- the attention kernels at the hybrid and MLA families' head dims: hd 112
  (Zamba2-7B, 32/32 heads) and hd 96 with vd 64 (MiniCPM3-4B, 40/40),
  causal prefill at B = 1, S = 4096 and decode over a full 4,160-slot
  cache at B = 4, and MLA's smoke (24, 16) at a small shape;
- hybrid and MLA serving at full width and depth: Zamba2-7B (81 layers,
  the shared attention block applied 13 times) and MiniCPM3-4B (62
  layers), each 8 requests of 4,096 prompt and 32 new tokens on 4 slots,
  one flash launch per attention call and wave and one decode launch per
  attention call and step, no plain call; wave 0 replayed through the
  plain attention versions in bf16 (as every served model's wave 0:
  within the logit tolerance, or within a stated multiple of a control's
  drift, the plain versions at half the tiles on the same prompts, where
  that is larger, as at the hybrid's 81 layers) and, teacher-forced in
  f32 through the kernels' f32 entries against the plain versions, within
  1% of the logit tolerance;
- training the MoE, SSM, hybrid and MLA families at full width with the
  depth cut so that the donated step fits, each at B = 4: Mixtral-8x22B
  (1 layer, S = 6,144, past its window), Mamba2-2.7B (64 layers),
  Zamba2-7B (36 layers, 6 applications of the shared block) and
  MiniCPM3-4B (40 layers), each at S = 2,048 but Mixtral: one step's
  gradients through the kernels against the plain attention, in bf16
  within the dense phase's limits (Mixtral on one sequence, its routes
  forced; Zamba2 at 12 layers, where its own drift, a control's, stays
  under 2/3 of them) and in an f32 model of 2 layers (Zamba2 6) at 1% of
  them, each step exactly 2 flash launches with lse and 1 backward call
  per attention call; then ten donated steps at the dense phase's rate
  on the cosine schedule with warm-up, whose last loss must be below the
  untrained model's on that batch by more than the batches' spread; each
  step's time, tokens/s, peak memory (under the card's and the
  backward's own peak plus the moments and the update's temporaries) and
  backward device time a call;
- the attention kernels at the encoder-decoder's and the vision
  frontend's shapes: SeamlessM4T-large-v2's encoder unmasked over 1,500
  frames and its cross attention unmasked from 512 and 1,024 decoder
  positions over them (Sq ≠ Skv), its decode step's cross attention over
  the whole 1,500-slot cross cache, and InternVL2-2B's causal prefill over
  256 patches + 512 tokens (hd 128, G = 2); the flash backward at both
  families' training shapes;
- the encoder-decoder and the vision frontend served whole at full width
  (SeamlessM4T-large-v2, 24 + 24 layers; InternVL2-2B, 24), each 8
  requests of 512 prompt and 64 new tokens on 4 slots, each request with
  its 1,500 encoder frames or 256 patch embeddings, through
  ``make_prefill_step`` and ``make_serve_step`` in lockstep (the serving
  engine passes no frontend inputs, as the reference's): one flash launch
  per encoder, self and cross call and wave, one decode launch per self
  and cross call and step; wave 0 replayed through the plain attention
  versions, the served cross cache against the replay's;
- both trained whole at full width as the families above (B = 4;
  Seamless 1,024 decoder tokens over 1,500 frames, InternVL2 256 patches
  + 1,792 tokens, its loss over the text positions), the encoder's
  gradients, which reach it only through cross attention, among the
  checked leaves;
- ``blocked_attention``'s dynamic offsets (``attention-dynamic``): the
  model's entry point under autograd with ``q_offset``, ``kv_offset`` and
  ``kv_valid_len`` as int32 tensors on the card, at Qwen2-0.5B's heads
  and Granite-34B's, Skv a multiple of the tile and no multiple, the valid
  length inside the last tile: one launch each of the flash kernels'
  dynamic forward and backward entries, no host read (CUDA's sync debug
  mode), the f32 output, lse and gradients against the f64 plain versions
  in f32 and bf16, timed beside ``scaled_dot_product_attention`` with the
  same mask;
- the sharding substrate on a 1-rank NCCL mesh (``sharding``):
  ``lm-train``'s step-10 checkpoint restored by ``elastic_reshard`` onto
  the 1 x 1 ``("data", "model")`` mesh with ``param_pspecs`` under
  ``RULES_SINGLE_POD`` (bitwise), one step's gradient tree through the
  int8 ``compressed_mean`` (mean + error = g, mean within 1% of max |g|)
  and a batch placed by ``shard_batch``;
- Granite-34B (88 layers, MQA 48/1) and Yi-9B (48 layers, 32/4) served
  whole at full width, their weights in bf16, 8 requests of 4,096 + 32 on
  4 slots (``lm-serve-granite``, ``lm-serve-yi``), after the attention
  kernels at their shapes (prefill B = 1, S = 4,096; decode over a full
  4,160-slot cache at B = 4, Granite's six row chunks each reading the
  cache), each with wave 0's ``lm-teacher-forced`` replay.

It prints one JSON line per phase.  The line before the last lists the
kernels, with each one's launches on every graph path; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero.  It needs a CUDA device and the repository's ``src/``
beside it, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
SEED = 0
QUERIES = 12                # 11 approximate + 1 exact (query id 11)
TEACHER_FORCED = 2          # approximate queries with E_K edges replayed
RBO_DEPTH = 4000            # the paper's depth above 200 edges per query
# traversal sessions: four approximate queries, then an exact one; r = 0.05
# so that one new edge puts a vertex of out-degree <= 19 into K_r (at the
# default 0.2 most synth-web-lg hot sets are empty)
TRAVERSAL = (("sssp", {"sources": (0,)}), ("widest-path", {"sources": (0,)}),
             ("connected-components", {}))
TRAVERSAL_QUERIES = 5
TRAVERSAL_EXACT_EVERY = 4
TRAVERSAL_R = 0.05
SEMIRING_OF = {"sssp": "min_plus", "widest-path": "max_times",
               "connected-components": "min_min"}
BATCH = 4                   # the serving engine's default slots
ENTRY_EDGES = 400_000       # the small layout of the kernel entry checks
# serving: how many requests of each seeded workload, and the tolerance of
# the PPR / Katz / HITS rows against an f64 replay of their sweep
SERVE_PPR, SERVE_SSSP, SERVE_WIDEST = 10, 4, 2
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, after
    a warm-up (inputs stay in L2 where they fit, as in the power loop)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(name, values, layout, mask=None, mul="times") -> dict:
    """Run the kernel (the sum of ``values[src] ⊗ w``, ⊗ = ``mul``) once
    against the plain version in f64 on the card, then time kernel, plain
    version and, for ⊗ = ×, a library SpMV on the same inputs.  The
    tolerance scales with the sum of |values| ⊗ |w|, which bounds the sum's
    terms for the non-negative values and weights used here."""
    from repro_torch.kernels.spmv.kernel import (SUM_ENTRIES, spmv_push,
                                                 spmv_push_plain)

    src, w, ro = layout.src, layout.weight, layout.row_offsets
    run = lambda: spmv_push(values, src, w, ro, mask, mul=mul)
    out = run()
    torch.cuda.synchronize()
    ref = spmv_push_plain(values, src, w, ro, mask, mul=mul,
                          dtype=torch.float64)
    scale = spmv_push_plain(values.abs(), src, w.abs(), ro, mask, mul=mul,
                            dtype=torch.float64)
    err = (out.double() - ref).abs()
    ok = bool((err <= 1e-5 * scale).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the f64 plain "
                             f"version (max abs err {float(err.max())})")
    # no float atomics: a second launch gives the same bits
    if not same_bits(out, run()):
        raise AssertionError(f"{name}: two launches of the kernel differ")
    num_rows, n_src = ro.shape[0] - 1, values.shape[0]
    lo, hi = int(ro[0]), int(ro[-1])
    nnz = hi - lo
    lens = (ro[1:] - ro[:-1]).long()
    hubs = lens > 1024  # rows that keep one warp busy for 32+ trips
    kernel_ms = cuda_ms(run)
    # the same launches replayed from a CUDA graph: the device's time alone,
    # which kernel_ms hides where the host's enqueue is slower
    device_ms = graph_ms(run)
    launch_us = host_us(run)
    plain_ms = cuda_ms(lambda: spmv_push_plain(values, src, w, ro, mask,
                                               mul=mul))
    # library yardstick: cuSPARSE SpMV through torch on a CSR tensor of the
    # same (masked) matrix; timed here only, never called by the port.
    # cuSPARSE refuses more entries than rows x columns (repeated sources
    # in a row), so such a matrix has none
    library_ms = library_device_ms = lib_err = None
    if mul == "times" and nnz <= num_rows * n_src:
        wl = (w[lo:hi] if mask is None
              else torch.where(mask[lo:hi], w[lo:hi], 0.0)).float()
        csr = torch.sparse_csr_tensor(
            (ro - lo).contiguous(), src[lo:hi].contiguous(), wl.contiguous(),
            size=(num_rows, n_src))
        library_ms = cuda_ms(lambda: torch.mv(csr, values))
        library_device_ms = graph_ms(lambda: torch.mv(csr, values))
        lib_err = float((torch.mv(csr, values).double() - ref).abs().max())
    nbytes, byte_ms, op_ms = push_bound(nnz, num_rows, n_src, 1,
                                        mask is not None, w)
    return {"phase": "kernel-check", "shape": name, "mul": mul,
            "entry": entry_name(SUM_ENTRIES[mul], w),
            "weight_dtype": str(w.dtype).split(".")[-1], "rows": num_rows,
            "n_src": n_src, "nnz": nnz,
            "max_row": int(lens.max()) if num_rows else 0,
            "rows_over_1024": int(hubs.sum()),
            "edges_in_rows_over_1024": int(lens[hubs].sum()),
            "masked": mask is not None, "host_us_per_launch": launch_us,
            "max_abs_err": float(err.max()), "within_tol": ok,
            "run_to_run_bitwise": True,
            "library_max_abs_err": lib_err,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "kernel_device_ms": device_ms,
            "library_device_ms": library_device_ms,
            "timing": "kernel_ms, plain_ms, library_ms: 20 eager calls "
                      "back to back, their host cost included; *_device_ms: "
                      "20 calls replayed from one CUDA graph",
            "bytes": nbytes,
            "bound_ms": max(byte_ms, op_ms), "bound_us": max(byte_ms, op_ms) * 1e3,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "roofline_share": max(byte_ms, op_ms) / kernel_ms,
            **mask_facts(ro, mask)}


def same_bits(a, b) -> bool:
    """Equal bit for bit (and in dtype and shape)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def b_in_mask(hot, layout):
    """The mask of the ``b_in`` pass over ``layout``, as ``build_summary``
    makes it: the edges from a cold source into a hot destination."""
    return ~hot[layout.src] & hot[layout.dst.clamp(max=hot.shape[0] - 1)]


def mask_facts(ro, mask) -> dict:
    """What a mask leaves of a push: the kept edges, and the kept edges of
    the longest row (the hub row, whose one warp sets most of a push's
    time); nothing for an unmasked push."""
    if mask is None:
        return {}
    cum = torch.zeros(mask.shape[0] + 1, dtype=torch.int64,
                      device=mask.device)
    cum[1:] = torch.cumsum(mask.long(), 0)
    kept = cum[ro[1:].long()] - cum[ro[:-1].long()]
    lens = ro[1:] - ro[:-1]
    hub = int(torch.argmax(lens))
    return {"kept_edges": int(kept.sum()), "hub_row_edges": int(lens[hub]),
            "hub_row_kept_edges": int(kept[hub])}


def check_reduce_kernel(name, values, layout, mask=None) -> dict:
    """Hold the min/max kernel bitwise against its plain version on the
    card, then time kernel, plain version and a library segment reduce of
    the precomputed contribution stream (the reduce alone) on the same
    inputs."""
    from repro_torch.core.semiring import resolve_semiring
    from repro_torch.kernels.spmv.kernel import (REDUCE_ENTRIES,
                                                 reduce_identity,
                                                 spmv_reduce_push,
                                                 spmv_reduce_push_plain)

    s = resolve_semiring(layout.semiring)
    kw = dict(op=s.add, mul=s.mul)
    src, w, ro = layout.src, layout.weight, layout.row_offsets
    out = spmv_reduce_push(values, src, w, ro, mask, **kw)
    torch.cuda.synchronize()
    ref = spmv_reduce_push_plain(values, src, w, ro, mask, **kw)
    ok = same_bits(out, ref)
    differ = out != ref
    err = float((out[differ].double() - ref[differ].double()).abs().max()) \
        if bool(differ.any()) else 0.0
    if not ok:
        raise AssertionError(f"{name}: min/max kernel differs from its plain "
                             f"version in {int(differ.sum())} rows (max abs "
                             f"err {err})")
    run = lambda: spmv_reduce_push(values, src, w, ro, mask, **kw)
    # no atomics and a fixed fold order: a second launch gives the same bits
    if not same_bits(out, run()):
        raise AssertionError(f"{name}: two launches of the kernel differ")
    num_rows, n_src = ro.shape[0] - 1, values.shape[0]
    lo, hi = int(ro[0]), int(ro[-1])
    nnz = hi - lo
    lens = (ro[1:] - ro[:-1]).long()
    kernel_ms = cuda_ms(run)
    device_ms = graph_ms(run)
    launch_us = host_us(run)
    plain_ms = cuda_ms(lambda: spmv_reduce_push_plain(values, src, w, ro,
                                                      mask, **kw))
    # library yardstick: torch.segment_reduce over the contribution stream
    # computed beforehand, so it times the reduce only; never called by
    # the port
    ident = reduce_identity(values.dtype, s.add)
    x, wt = values[src[lo:hi].long()], w[lo:hi]
    contrib = (x + wt if s.mul == "plus" else x * wt if s.mul == "times"
               else torch.minimum(x, wt))
    if mask is not None:
        contrib = torch.where(mask[lo:hi], contrib, ident)
    library_ms, library_note = None, "segment_reduce of the precomputed " \
        "contributions (reduce only)"
    try:
        seg = lambda: torch.segment_reduce(contrib, s.add, lengths=lens,
                                           unsafe=True, initial=ident)
        library_ok = same_bits(seg(), ref)
        library_ms = cuda_ms(seg)
    except RuntimeError as exc:  # segment_reduce takes no int32
        library_ok, library_note = None, f"not timed: {exc}".splitlines()[0]
    # two operations per edge, over the f32 rate (the int32 rate is lower,
    # but the bytes bound these shapes by three orders of magnitude)
    nbytes, byte_ms, op_ms = push_bound(nnz, num_rows, n_src, 1,
                                        mask is not None, w, reduce=s.add)
    bound_ms = max(byte_ms, op_ms)
    return {"phase": "reduce-kernel-check", "shape": name,
            "semiring": s.name, "entry": entry_name(
                "spmv_reduce_push_batched_"
                + REDUCE_ENTRIES[(s.add, s.mul, values.dtype)], w),
            "dtype": str(values.dtype).split(".")[-1],
            "weight_dtype": str(w.dtype).split(".")[-1],
            "rows": num_rows, "n_src": n_src, "nnz": nnz,
            "max_row": int(lens.max()) if num_rows else 0,
            "masked": mask is not None, "bitwise": ok, "max_abs_err": err,
            "run_to_run_bitwise": True, "host_us_per_launch": launch_us,
            "kernel_ms": kernel_ms, "kernel_device_ms": device_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library_note,
            "timing": "kernel_ms, plain_ms, library_ms: 20 eager calls "
                      "back to back, their host cost included; "
                      "kernel_device_ms: 20 calls replayed from one CUDA "
                      "graph",
            "library_bitwise": library_ok, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "roofline_share": bound_ms / kernel_ms,
            **mask_facts(ro, mask)}


def reduce_checks(src, dst, nodes, dev, rng, hot) -> list:
    """The min/max kernel at the full synth-web-lg layouts of the traversal
    path: min_plus and max_times length layouts, min_min unit layouts in
    both directions, and one masked pass like the b_in pass of the hot set
    ``hot``."""
    from repro_torch.core.backend import build_layout
    from repro_torch.graph.graph import from_edges

    state = from_edges(src, dst, nodes, src.shape[0], device=dev)
    e = state.edge_capacity
    rows = []
    # (a) distances with ~10% unreached (+inf), lengths in [0.5, 1.5)
    dist = torch.from_numpy(10 * rng.random(nodes).astype(np.float32))
    dist[torch.from_numpy(rng.random(nodes) < 0.1)] = float("inf")
    lengths = torch.from_numpy((0.5 + rng.random(e)).astype(np.float32))
    lay = build_layout(state, weight="length", semiring="min_plus",
                       lengths=lengths.to(dev))
    dist = dist.to(dev)
    rows.append(check_reduce_kernel("(a) synth-web-lg min_plus length",
                                    dist, lay))
    # (e) the b_in pass: edges from a cold source into a hot destination
    rows.append(check_reduce_kernel("(e) synth-web-lg min_plus, b_in mask",
                                    dist, lay, b_in_mask(hot, lay)))
    # (f) every edge of the stream in one row: the hub case at its extreme
    rows.append(check_reduce_kernel(
        "(f) synth-web-lg min_plus, edges in one row", dist,
        one_row_layout(lay)))
    del lay
    # (b) widths in [0, 1] with zeros and denormals, reliabilities in
    # (0, 1]: products below the smallest normal stay denormal
    width = rng.random(nodes).astype(np.float32)
    pick = rng.random(nodes)
    width[pick < 0.05] = 0.0
    width[(pick >= 0.05) & (pick < 0.10)] = np.float32(3e-39)
    width[(pick >= 0.10) & (pick < 0.15)] = np.float32(1.5e-38)
    rel = (1.0 - rng.random(e)).astype(np.float32)
    lay = build_layout(state, weight="length", semiring="max_times",
                       lengths=torch.from_numpy(rel).to(dev))
    width_t = torch.from_numpy(width).to(dev)
    row = check_reduce_kernel("(b) synth-web-lg max_times length", width_t,
                              lay)
    out = check_denormals(width_t, lay)
    row["denormal_rows"] = out
    rows.append(row)
    del lay
    # (c, d) labels with ~10% unlabelled (INT32_MAX), unit min_min layouts
    labels = rng.integers(0, nodes, nodes).astype(np.int32)
    labels[rng.random(nodes) < 0.1] = np.iinfo(np.int32).max
    labels_t = torch.from_numpy(labels).to(dev)
    for tag, rev in (("(c) synth-web-lg min_min unit forward", False),
                     ("(d) synth-web-lg min_min unit reverse", True)):
        lay = build_layout(state, weight="unit", reverse=rev,
                           semiring="min_min")
        rows.append(check_reduce_kernel(tag, labels_t, lay))
        del lay
    return rows


def one_row_layout(layout):
    """``layout``'s stream as one row: every edge into one destination."""
    one_row = torch.tensor([0, int(layout.row_offsets[-1])],
                           dtype=torch.int32, device=layout.src.device)
    return SimpleNamespace(src=layout.src, weight=layout.weight,
                           row_offsets=one_row, semiring=layout.semiring)


def entry_checks(src, dst, nodes, dev, rng) -> tuple:
    """One check of each kernel entry that no shipped semiring uses, at a
    small synth-web-lg layout (its first ENTRY_EDGES edges over all its
    vertices): the nine other min/max (⊕, ⊗, dtype) bitwise, and the sum
    with ⊗ = + and min at the f64 tolerance.  Each runs as a semiring a
    user registers.  Returns (min/max rows, sum rows)."""
    from repro_torch.core.backend import build_layout
    from repro_torch.core.semiring import Semiring, register_semiring
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels.spmv.kernel import REDUCE_ENTRIES

    e = ENTRY_EDGES
    state = from_edges(src[:e], dst[:e], nodes, e, device=dev)
    shipped = {("min", "plus", torch.float32),
               ("max", "times", torch.float32), ("min", "min", torch.int32)}
    tag = f"small synth-web-lg ({e} edges)"
    reduce_rows, sum_rows = [], []
    for (op, mul, dtype), entry in sorted(REDUCE_ENTRIES.items(),
                                          key=lambda kv: kv[1]):
        if (op, mul, dtype) in shipped:
            continue
        name = f"smoke_{entry}"
        register_semiring(Semiring(name, op, mul, str(dtype).split(".")[-1]))
        if dtype == torch.int32:  # sums and products past int32 wrap
            values = rng.integers(-2**31, 2**31 - 1, nodes).astype(np.int32)
            lengths = rng.integers(-2**31, 2**31 - 1, e).astype(np.int32)
        else:
            values = (10 * rng.random(nodes)).astype(np.float32)
            values[rng.random(nodes) < 0.1] = np.inf
            lengths = (0.5 + rng.random(e)).astype(np.float32)
        lay = build_layout(state, weight="length", semiring=name,
                           lengths=torch.from_numpy(lengths).to(dev))
        reduce_rows.append(check_reduce_kernel(
            f"{tag} {entry}", torch.from_numpy(values).to(dev), lay))
    values = torch.from_numpy(rng.random(nodes).astype(np.float32)).to(dev)
    lengths = torch.from_numpy((0.5 + rng.random(e)).astype(np.float32))
    for mul in ("plus", "min"):
        name = f"smoke_sum_{mul}_f32"
        register_semiring(Semiring(name, "sum", mul, "float32"))
        lay = build_layout(state, weight="length", semiring=name,
                           lengths=lengths.to(dev))
        sum_rows.append(check_kernel(f"{tag} sum_{mul}", values, lay,
                                     mul=mul))
    return reduce_rows, sum_rows


def check_denormals(width, layout) -> int:
    """Rows of the max_times push whose result is denormal: they must
    exist, or the check did not test that the build keeps them."""
    from repro_torch.kernels.spmv.kernel import spmv_reduce_push

    out = spmv_reduce_push(width, layout.src, layout.weight,
                           layout.row_offsets, op="max", mul="times")
    tiny = (out > 0) & (out < torch.finfo(torch.float32).tiny)
    count = int(tiny.sum())
    if count == 0:
        raise AssertionError("no denormal row in the max_times check")
    return count


def push_bound(nnz, rows, n_src, batch, masked, w, *, reduce="sum",
               tile=None):
    """(bytes, byte ms, operation ms) of one push, from
    ``repro_torch.launch.roofline`` (the tuner's cost model, at this card's
    figures): the stream (src, w at its width and the mask) and row
    offsets read once, each value row read once, each output row written
    once, the carries written and read; two operations per edge and batch
    row."""
    from repro_torch.launch.roofline import push_roofline_check

    rec = push_roofline_check(
        edge_capacity=nnz, num_segments=rows, n_src=n_src, batch=batch,
        masked=masked, reduce=reduce,
        weight_dtype=str(w.dtype).split(".")[-1], tile=tile,
        platform=torch.cuda.get_device_name(0))
    return (rec["hbm_bytes"], rec["memory_s"] * 1e3,
            rec["compute_s"] * 1e3)


def entry_name(base: str, w) -> str:
    """The kernel entry that ``base`` names for weights ``w``: its
    narrow-weight form for bf16/f16 weights."""
    from repro_torch.kernels.spmv.kernel import WEIGHT_TAGS

    return base + WEIGHT_TAGS.get(w.dtype, "")


def ptxas_summary(lib, full: bool) -> dict:
    """What ``-Xptxas -v`` said of a library: every line (``full``), or
    its kernel count, the most registers and shared memory of a kernel,
    and any line that reports a spill."""
    import re

    lines = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "ptxas" in ln or "spill" in ln]
    if full:
        return {"ptxas": lines}
    regs = [int(x) for ln in lines for x in re.findall(r"Used (\d+) reg", ln)]
    smem = [int(x) for ln in lines for x in re.findall(r"(\d+) bytes smem",
                                                        ln)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "max_smem_bytes": max(smem, default=0),
            "spills": [ln for ln in lines if "spill" in ln
                       and not re.search(r"\b0 bytes spill stores, 0 bytes "
                                         r"spill loads", ln)]}


def host_us(fn, reps: int = 50) -> float:
    """Host time to enqueue one launch (checks, ctypes call), no sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def rows_match_single(out, single, values) -> None:
    """Each row of a batched launch, bit for bit, is the single kernel on
    that row."""
    for b in range(values.shape[0]):
        if not same_bits(out[b], single(values[b])):
            raise AssertionError(f"batched row {b} differs from the single "
                                 f"kernel on that row")


def check_batched_kernel(name, values, layout, mask=None,
                         mul="times") -> dict:
    """``spmv_push_batched`` on ``values`` [B, N] (⊗ = ``mul``): against
    the plain version in f64 (the tolerance of ``check_kernel``), each row
    bitwise against ``spmv_push``; then kernel, plain and, for ⊗ = ×,
    cuSPARSE SpMM times."""
    from repro_torch.kernels.spmv.kernel import (SUM_ENTRIES, spmv_push,
                                                 spmv_push_batched,
                                                 spmv_push_batched_plain)

    src, w, ro = layout.src, layout.weight, layout.row_offsets
    run = lambda: spmv_push_batched(values, src, w, ro, mask, mul=mul)
    out = run()
    torch.cuda.synchronize()
    ref = spmv_push_batched_plain(values, src, w, ro, mask, mul=mul,
                                  dtype=torch.float64)
    scale = spmv_push_batched_plain(values.abs(), src, w.abs(), ro, mask,
                                    mul=mul, dtype=torch.float64)
    err = (out.double() - ref).abs()
    if not bool((err <= 1e-5 * scale).all()):
        raise AssertionError(f"{name}: batched kernel disagrees with the f64 "
                             f"plain version (max abs err {float(err.max())})")
    rows_match_single(out, lambda v: spmv_push(v, src, w, ro, mask,
                                               mul=mul), values)
    batch, n_src = values.shape
    num_rows = ro.shape[0] - 1
    lo, hi = int(ro[0]), int(ro[-1])
    lens = (ro[1:] - ro[:-1]).long()
    kernel_ms = cuda_ms(run)
    device_ms = graph_ms(run)
    launch_us = host_us(run)
    plain_ms = cuda_ms(lambda: spmv_push_batched_plain(values, src, w, ro,
                                                       mask, mul=mul))
    # library yardstick: cuSPARSE SpMM through torch, CSR @ values^T; timed
    # here only, never called by the port
    library_ms = lib_err = None
    if mul == "times":
        wl = (w[lo:hi] if mask is None
              else torch.where(mask[lo:hi], w[lo:hi], 0.0)).float()
        csr = torch.sparse_csr_tensor((ro - lo).contiguous(),
                                      src[lo:hi].contiguous(),
                                      wl.contiguous(),
                                      size=(num_rows, n_src))
        vt = values.t().contiguous()
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, vt))
        lib_err = float((torch.sparse.mm(csr, vt).t().double()
                         - ref).abs().max())
    nbytes, byte_ms, op_ms = push_bound(hi - lo, num_rows, n_src, batch,
                                        mask is not None, w)
    bound_ms = max(byte_ms, op_ms)
    return {"phase": "batched-kernel-check", "kernel": "spmv_push_batched",
            "entry": entry_name(SUM_ENTRIES[mul], w), "mul": mul,
            "shape": name, "batch": batch, "rows": num_rows, "n_src": n_src,
            "nnz": hi - lo, "max_row": int(lens.max()) if num_rows else 0,
            "masked": mask is not None, "host_us_per_launch": launch_us,
            "max_abs_err": float(err.max()), "within_tol": True,
            "rows_bitwise_vs_single": True,
            "library": "torch.sparse.mm (cuSPARSE SpMM)",
            "library_max_abs_err": lib_err, "kernel_ms": kernel_ms,
            "kernel_device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "roofline_share": bound_ms / kernel_ms,
            **mask_facts(ro, mask)}


def check_batched_reduce_kernel(name, values, layout, mask=None) -> dict:
    """``spmv_reduce_push_batched`` on ``values`` [B, N]: bitwise against
    the plain version and, row by row, against ``spmv_reduce_push``; then
    kernel, plain and ``segment_reduce`` times (f32 only: it takes no
    int32)."""
    from repro_torch.core.semiring import resolve_semiring
    from repro_torch.kernels.spmv.kernel import (
        REDUCE_ENTRIES, reduce_identity, spmv_reduce_push,
        spmv_reduce_push_batched, spmv_reduce_push_batched_plain)

    s = resolve_semiring(layout.semiring)
    kw = dict(op=s.add, mul=s.mul)
    src, w, ro = layout.src, layout.weight, layout.row_offsets
    run = lambda: spmv_reduce_push_batched(values, src, w, ro, mask, **kw)
    out = run()
    torch.cuda.synchronize()
    ref = spmv_reduce_push_batched_plain(values, src, w, ro, mask, **kw)
    if not same_bits(out, ref):
        raise AssertionError(f"{name}: batched min/max kernel differs from "
                             f"its plain version in "
                             f"{int((out != ref).sum())} entries")
    rows_match_single(
        out, lambda v: spmv_reduce_push(v, src, w, ro, mask, **kw), values)
    if not same_bits(out, run()):
        raise AssertionError(f"{name}: two launches of the batched kernel "
                             f"differ")
    batch, n_src = values.shape
    num_rows = ro.shape[0] - 1
    lo, hi = int(ro[0]), int(ro[-1])
    lens = (ro[1:] - ro[:-1]).long()
    kernel_ms = cuda_ms(run)
    device_ms = graph_ms(run)
    launch_us = host_us(run)
    plain_ms = cuda_ms(lambda: spmv_reduce_push_batched_plain(
        values, src, w, ro, mask, **kw))
    library_ms = None
    if values.dtype == torch.float32:
        # library yardstick: segment_reduce along the last axis of the
        # [B, E] contributions computed beforehand (the reduce only)
        ident = reduce_identity(values.dtype, s.add)
        x, wt = values[:, src[lo:hi].long()], w[lo:hi]
        contrib = (x + wt if s.mul == "plus" else x * wt if s.mul == "times"
                   else torch.minimum(x, wt))
        if mask is not None:
            contrib = torch.where(mask[lo:hi], contrib, ident)
        lengths = lens.expand(batch, -1).contiguous()
        seg = lambda: torch.segment_reduce(contrib, s.add, lengths=lengths,
                                           axis=1, unsafe=True, initial=ident)
        if not same_bits(seg(), ref):
            raise AssertionError(f"{name}: segment_reduce yardstick differs")
        library_ms = cuda_ms(seg)
        del contrib, x
    nbytes, byte_ms, op_ms = push_bound(hi - lo, num_rows, n_src, batch,
                                        mask is not None, w, reduce=s.add)
    bound_ms = max(byte_ms, op_ms)
    return {"phase": "batched-kernel-check",
            "kernel": "spmv_reduce_push_batched", "shape": name,
            "entry": entry_name("spmv_reduce_push_batched_" + REDUCE_ENTRIES[
                (s.add, s.mul, values.dtype)], w),
            "semiring": s.name, "dtype": str(values.dtype).split(".")[-1],
            "batch": batch, "rows": num_rows, "n_src": n_src, "nnz": hi - lo,
            "max_row": int(lens.max()) if num_rows else 0,
            "masked": mask is not None, "host_us_per_launch": launch_us,
            "bitwise": True, "max_abs_err": 0.0,
            "rows_bitwise_vs_single": True, "run_to_run_bitwise": True,
            "library": ("segment_reduce of the precomputed [B, E] "
                        "contributions (reduce only)" if library_ms else
                        "none for int32"),
            "kernel_ms": kernel_ms, "kernel_device_ms": device_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "roofline_share": bound_ms / kernel_ms,
            **mask_facts(ro, mask)}


def batched_checks(src, dst, nodes, dev, rng, hot) -> list:
    """Both batched kernels at synth-web-lg's full layouts, B = 4: the sum
    over the ``inv_out`` layout, unmasked and with the ``b_in`` mask of the
    hot set ``hot`` (the single checks' draw); min/max over the
    ``min_plus`` length layout (unmasked and with that mask),
    ``max_times``, and ``min_min`` in both directions."""
    from repro_torch.core.backend import build_layout
    from repro_torch.graph.graph import from_edges

    state = from_edges(src, dst, nodes, src.shape[0], device=dev)
    e = state.edge_capacity
    rows = []
    lay = build_layout(state)
    vals = torch.from_numpy(rng.random((BATCH, nodes)).astype(
        np.float32)).to(dev)
    rows.append(check_batched_kernel("synth-web-lg inv_out layout", vals,
                                     lay))
    rows.append(check_batched_kernel("synth-web-lg inv_out layout, b_in mask",
                                     vals, lay, b_in_mask(hot, lay)))
    del lay
    dist = torch.from_numpy(10 * rng.random((BATCH, nodes)).astype(
        np.float32))
    dist[torch.from_numpy(rng.random((BATCH, nodes)) < 0.1)] = float("inf")
    dist = dist.to(dev)
    lengths = torch.from_numpy((0.5 + rng.random(e)).astype(np.float32))
    lay = build_layout(state, weight="length", semiring="min_plus",
                       lengths=lengths.to(dev))
    rows.append(check_batched_reduce_kernel(
        "(a) synth-web-lg min_plus length", dist, lay))
    rows.append(check_batched_reduce_kernel(
        "(e) synth-web-lg min_plus, b_in mask", dist, lay,
        b_in_mask(hot, lay)))
    rows.append(check_batched_reduce_kernel(
        "(f) synth-web-lg min_plus, edges in one row", dist,
        one_row_layout(lay)))
    del lay
    width = rng.random((BATCH, nodes)).astype(np.float32)
    width[rng.random((BATCH, nodes)) < 0.05] = 0.0
    rel = (1.0 - rng.random(e)).astype(np.float32)
    lay = build_layout(state, weight="length", semiring="max_times",
                       lengths=torch.from_numpy(rel).to(dev))
    rows.append(check_batched_reduce_kernel(
        "(b) synth-web-lg max_times length", torch.from_numpy(width).to(dev),
        lay))
    del lay
    labels = rng.integers(0, nodes, (BATCH, nodes)).astype(np.int32)
    labels[rng.random((BATCH, nodes)) < 0.1] = np.iinfo(np.int32).max
    labels_t = torch.from_numpy(labels).to(dev)
    for tag, rev in (("(c) synth-web-lg min_min unit forward", False),
                     ("(d) synth-web-lg min_min unit reverse", True)):
        lay = build_layout(state, weight="unit", reverse=rev,
                           semiring="min_min")
        rows.append(check_batched_reduce_kernel(tag, labels_t, lay))
        del lay
    return rows


# ---- narrow edge weights, merge tiles and the tuned sessions --------------
NARROW = ("bfloat16", "float16")
SUMMARY_ROWS, SUMMARY_EDGES = 5_000, 20_000  # a summary-sized layout
SERVE_SUM_L1 = 1e-2         # a sum lane's bf16 answer against the f32 run's,
                            # relative L1 (bf16 keeps 1/d_out to 2^-9)
RBO_FLOOR = 0.95            # the paper's bar for an approximate answer


def f32_semiring(op: str, mul: str) -> str:
    """The name of an f32 min/max semiring (op, mul): the shipped one, or
    one registered here as a user would."""
    from repro_torch.core.semiring import (Semiring, available_semirings,
                                           register_semiring)

    shipped = {("min", "plus"): "min_plus", ("max", "times"): "max_times"}
    name = shipped.get((op, mul), f"narrow_{op}_{mul}_f32")
    if name not in available_semirings():
        register_semiring(Semiring(name, op, mul, "float32"))
    return name


def narrow_checks(src, dst, nodes, dev, rng, hot) -> tuple:
    """Every narrow-weight entry (bf16 and f16 weights under f32 values) at
    synth-web-lg's full layout, unmasked and with the b_in mask of ``hot``:
    the three sums within the f64 tolerance (the inv_out weights), the
    twelve min/max bitwise (lengths in [0.5, 1.5) stored narrow), each
    batched row (B = 4, masked) bitwise its single push.  Returns (sum
    rows, min/max rows, batched rows)."""
    from repro_torch.core.backend import build_layout
    from repro_torch.graph.graph import from_edges

    state = from_edges(src, dst, nodes, src.shape[0], device=dev)
    e = state.edge_capacity
    v = torch.from_numpy(rng.random(nodes).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.random((BATCH, nodes)).astype(
        np.float32)).to(dev)
    dist = 10 * rng.random((BATCH, nodes))
    dist[rng.random((BATCH, nodes)) < 0.1] = np.inf
    dist = torch.from_numpy(dist.astype(np.float32)).to(dev)
    lengths = torch.from_numpy((0.5 + rng.random(e)).astype(
        np.float32)).to(dev)
    sums, reduces, batched = [], [], []
    for wd in NARROW:
        lay = build_layout(state, weight_dtype=wd)
        eb = b_in_mask(hot, lay)
        for mul in ("times", "plus", "min"):
            for mask in (None, eb):
                tag = (f"synth-web-lg inv_out {wd} ⊗={mul}"
                       + ("" if mask is None else ", b_in mask"))
                sums.append(check_kernel(tag, v, lay, mask, mul=mul))
            batched.append(check_batched_kernel(
                f"synth-web-lg inv_out {wd} ⊗={mul}, b_in mask", bank, lay,
                eb, mul=mul))
        del lay, eb
        for op in ("min", "max"):
            for mul in ("plus", "times", "min"):
                name = f32_semiring(op, mul)
                lay = build_layout(state, weight="length", semiring=name,
                                   lengths=lengths, weight_dtype=wd)
                eb = b_in_mask(hot, lay)
                for mask in (None, eb):
                    reduces.append(check_reduce_kernel(
                        f"synth-web-lg {name} length {wd}"
                        + ("" if mask is None else ", b_in mask"), dist[0],
                        lay, mask))
                batched.append(check_batched_reduce_kernel(
                    f"synth-web-lg {name} length {wd}, b_in mask", dist, lay,
                    eb))
                del lay, eb
    return sums, reduces, batched


def tile_sweep(src, dst, nodes, dev, rng) -> list:
    """Every built tile against the default one: the full synth-web-lg
    layouts (sum over f32 and bf16 weights, min_plus) and a summary-sized
    layout (SUMMARY_EDGES edges into SUMMARY_ROWS rows; sum and min_plus).
    Sums within the f64 tolerance of ``check_kernel`` (another tile folds
    in another order), min/max bitwise the default tile; each tile's device
    time (20 pushes replayed from a CUDA graph) beside its bound from
    ``repro_torch.launch.roofline``."""
    from repro_torch.core.backend import build_layout
    from repro_torch.graph.generators import gnm_edges
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels.spmv.kernel import (DEFAULT_TILE, TILES,
                                                 spmv_push, spmv_push_plain,
                                                 spmv_reduce_push)
    from repro_torch.launch.roofline import push_roofline_check

    full = from_edges(src, dst, nodes, src.shape[0], device=dev)
    s_src, s_dst = gnm_edges(SUMMARY_ROWS, SUMMARY_EDGES, seed=SEED)
    small = from_edges(s_src, s_dst, SUMMARY_ROWS, SUMMARY_EDGES, device=dev)
    cases = []
    for tag, state in (("full", full), ("summary-sized", small)):
        n = state.node_capacity
        lengths = torch.from_numpy((0.5 + rng.random(
            state.edge_capacity)).astype(np.float32)).to(dev)
        v = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
        d = 10 * rng.random(n)
        d[rng.random(n) < 0.1] = np.inf
        d = torch.from_numpy(d.astype(np.float32)).to(dev)
        cases.append((f"{tag} sum f32", "sum", v, build_layout(state)))
        if tag == "full":
            cases.append((f"{tag} sum bf16", "sum", v, build_layout(
                state, weight_dtype="bfloat16")))
        cases.append((f"{tag} min_plus f32", "min", d, build_layout(
            state, weight="length", semiring="min_plus", lengths=lengths)))
    rows = []
    for name, reduce, values, lay in cases:
        src_, w, ro = lay.src, lay.weight, lay.row_offsets
        if reduce == "sum":
            push = lambda t: spmv_push(values, src_, w, ro, tile=t)
            ref = spmv_push_plain(values, src_, w, ro, dtype=torch.float64)
            scale = spmv_push_plain(values.abs(), src_, w.abs(), ro,
                                    dtype=torch.float64)
        else:
            push = lambda t: spmv_reduce_push(values, src_, w, ro, op="min",
                                              mul="plus", tile=t)
        default = push(DEFAULT_TILE)
        nnz = int(ro[-1] - ro[0])
        per_tile = []
        for tile in TILES:
            out = push(tile)
            torch.cuda.synchronize()
            if reduce == "sum":
                err = (out.double() - ref).abs()
                if not bool((err <= 1e-5 * scale).all()):
                    raise AssertionError(f"{name}: tile {tile} disagrees "
                                         f"with the f64 plain version")
                check = {"max_abs_err_vs_f64": float(err.max()),
                         "max_abs_diff_vs_default": float(
                             (out - default).abs().max())}
            else:
                if not same_bits(out, default):
                    raise AssertionError(f"{name}: tile {tile} differs "
                                         f"from the default tile")
                check = {"bitwise_vs_default": True}
            model = push_roofline_check(
                edge_capacity=nnz, num_segments=ro.shape[0] - 1,
                reduce=reduce, weight_dtype=str(w.dtype).split(".")[-1],
                tile=tile, platform=torch.cuda.get_device_name(0))
            per_tile.append({
                "tile": tile, "items_per_thread": tile // 256,
                "device_ms": graph_ms(lambda: push(tile)), **check,
                "bound_ms": model["bound_time_s"] * 1e3,
                "blocks": model["blocks"],
                "smem_bytes": model["smem_bytes"]})
        fastest = min(per_tile, key=lambda r: r["device_ms"])
        rows.append({"phase": "tile-sweep", "layout": name, "nnz": nnz,
                     "rows": ro.shape[0] - 1,
                     "weight_dtype": str(w.dtype).split(".")[-1],
                     "tiles": per_tile, "fastest_tile": fastest["tile"],
                     "timing": "device_ms: 20 pushes replayed from one "
                               "CUDA graph, inputs warm in L2"})
    return rows


def push_time_by_mode(stream, modes=("off", "full", "full", "off")) -> list:
    """The device time of the pushes of the bf16 PageRank main path (the
    session defaults, QUERIES queries at the main path's policy) under
    each autotune mode in ``modes``, alternated so that a drift of the
    card's clock shows.  Every push through ``backend.push`` is counted by
    its layout and whether it is masked; after the run each such class is
    timed once from a CUDA graph of its first call's inputs (an event pair
    around an eager push would time the host's launch too, since the
    host-bound loop leaves the card idle before each push), and count ×
    time is summed apart for the full-graph layouts (the exact sweeps and
    the ``b_in`` pass) and the summaries' E_K layouts.  ``"full"`` answers
    from the tuning cache of the run before it."""
    import itertools

    import repro_torch
    from repro_torch.core import backend as B
    from repro_torch.core.policies import periodic_exact

    real, seen = B.push, {}

    def counted(values, layout, **kwargs):
        key = (id(layout), kwargs.get("mask") is not None)
        if key not in seen:
            # held here, so that no later layout takes this one's id
            seen[key] = [0, layout, values.clone(), kwargs]
        seen[key][0] += 1
        return real(values, layout, **kwargs)

    rows = []
    for mode in modes:
        seen.clear()
        B.push = counted
        try:
            sess = repro_torch.session(
                stream, weight_dtype="bfloat16", autotune=mode,
                on_query=periodic_exact(QUERIES - 1))
            for _ in itertools.islice(sess.play(), QUERIES):
                pass
        finally:
            B.push = real
        pushes = {False: 0, True: 0}
        ms = {False: 0.0, True: 0.0}
        for count, layout, values, kwargs in seen.values():
            summary = layout.weight_mode == "summary"
            pushes[summary] += count
            ms[summary] += count * graph_ms(
                lambda: real(values, layout, **kwargs))
        rows.append({
            "phase": "tuned-narrow-push-time", "autotune": mode,
            "tiles": layout_tiles(sess.engine),
            "full_layout_pushes": pushes[False],
            "full_layout_push_ms": ms[False],
            "summary_pushes": pushes[True], "summary_push_ms": ms[True],
            "push_ms": ms[False] + ms[True],
            "timing": "per layout and mask, 20 pushes replayed from one "
                      "CUDA graph, times the pushes made"})
        del sess
        seen.clear()
    return rows


def layout_tiles(engine) -> list:
    """The merge tile stamped on each of the engine's layouts."""
    return [lay.merge_tile for lay in engine.edge_layouts()]


def tuned_sessions(stream, plan, main_rows, dev, rng) -> tuple:
    """The sessions with both knobs, each with the kernel counts set to 0
    just before it and read just after: PageRank at the session defaults
    with ``weight_dtype="bfloat16"`` and ``autotune="full"`` (12 queries,
    RBO@4000 against the f64 exact replay, beside the f32 main path's);
    then ``"cached"`` after ``load_cache`` of what ``full`` saved (no timed
    run, the same tiles); SSSP over streamed lengths that bf16 holds
    exactly, bitwise the f32 session query for query; the 19-ticket
    serving plan with both knobs, its min/max answers bitwise the f32
    run's and its sum answers within SERVE_SUM_L1 of them.  Returns (rows,
    {path: launches})."""
    import itertools
    import tempfile

    import repro_torch
    from repro_torch.core.policies import periodic_exact
    from repro_torch.kernels.spmv import autotune as AT
    from repro_torch.kernels.spmv.kernel import spmv_reduce_push

    rows, by_path = [], {}
    knobs = dict(weight_dtype="bfloat16", autotune="full")
    AT.clear_cache()
    t0 = time.perf_counter()
    sess, q_rows, launches, _ = drive_main_path(
        stream, {"inputs": {}, "outputs": {}}, **knobs)
    wall = time.perf_counter() - t0
    engine = sess.engine
    runs, tiles = engine.autotune_runs, layout_tiles(engine)
    if runs < 1:
        raise AssertionError("autotune='full' timed no tile")
    if engine.edge_layouts()[0].weight.dtype != torch.bfloat16:
        raise AssertionError("the PageRank layout is not bf16")
    f32_rbo = {r["query"]: r.get("rbo_vs_exact") for r in main_rows}
    for r in q_rows:
        r["phase"] = "tuned-narrow-pagerank"
        r["f32_rbo_vs_exact"] = f32_rbo.get(r["query"])
        if r.get("rbo_vs_exact", 1.0) < RBO_FLOOR:
            raise AssertionError(f"bf16 query {r['query']}: RBO@4000 "
                                 f"{r['rbo_vs_exact']} < {RBO_FLOOR}")
    rows += q_rows
    by_path["tuned-narrow"] = {"spmv_push": launches}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "autotune_cache.json"
        AT.save_cache(path)
        entries = AT.cache_entries()
        AT.clear_cache()
        loaded = AT.load_cache(path)
    del sess, engine
    reset_launch_counts()
    cached = repro_torch.session(stream, weight_dtype="bfloat16",
                                 autotune="cached")
    if cached.engine.autotune_runs or layout_tiles(cached.engine) != tiles:
        raise AssertionError(f"'cached' after load_cache: "
                             f"{cached.engine.autotune_runs} runs, tiles "
                             f"{layout_tiles(cached.engine)} != {tiles}")
    by_path["tuned-narrow"]["spmv_push"] += launch_counts()["spmv_push"]
    rows.append({"phase": "tuned-narrow-cache", "full_timed_runs": runs,
                 "full_wall_s": wall, "cache_entries": entries,
                 "loaded": loaded, "cached_timed_runs": 0,
                 "tiles_full": tiles,
                 "tiles_cached": layout_tiles(cached.engine)})
    del cached
    # SSSP over lengths bf16 holds exactly, streamed with each chunk
    policy = periodic_exact(TRAVERSAL_EXACT_EVERY)
    chunks = list(itertools.islice(iter(stream), TRAVERSAL_QUERIES))
    lens = [rng.choice([0.5, 1.0, 1.5, 2.0, 3.0], len(s)).astype(np.float32)
            for s, _ in chunks]
    answers, sssp_runs = {}, {}
    for wd in (None, "bfloat16"):
        reset_launch_counts()
        s = repro_torch.session(
            stream, "sssp", sources=(0,),
            r=TRAVERSAL_R, on_query=policy, weight_dtype=wd,
            autotune="off" if wd is None else "full")
        out = [s.scores.copy()]
        for (a, b), w in zip(chunks, lens):
            s.engine.register_add_edges(a, b, w)
            out.append(s.query().scores)
        answers[wd] = out
        sssp_runs[wd] = (launch_counts()["spmv_reduce_push"],
                         [st.action for st in s.stats_log],
                         layout_tiles(s.engine))
        if wd is not None:
            by_path["tuned-narrow"]["spmv_reduce_push"] = sssp_runs[wd][0]
            if s.engine.edge_layouts()[0].weight.dtype != torch.bfloat16:
                raise AssertionError("the SSSP layout is not bf16")
        del s
    for q, (a, b) in enumerate(zip(answers[None], answers["bfloat16"])):
        if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError(f"bf16 SSSP query {q - 1} differs from f32")
    rows.append({"phase": "tuned-narrow-sssp", "queries": len(chunks),
                 "actions": sssp_runs["bfloat16"][1],
                 "bitwise_vs_f32_session": True,
                 "reached": int(np.isfinite(answers[None][-1]).sum()),
                 "launches": sssp_runs["bfloat16"][0],
                 "f32_launches": sssp_runs[None][0],
                 "tiles": sssp_runs["bfloat16"][2]})
    # the serving plan with both knobs, against the f32 run of the plan
    s_rows, s_tickets, srv, counts, s_wall, _ = drive_serving(
        stream, plan, dev, **knobs)
    by_path["tuned-narrow-serving"] = counts
    st = srv.stats
    tiles = {f"{name}@B={b}": tile
             for (name, b), tile in srv.engine._tiles.items()}
    del srv
    _, f_tickets, f_srv, _, _, _ = drive_serving(stream, plan, dev)
    del f_srv
    sum_l1 = 0.0
    for t, f in zip(s_tickets, f_tickets):
        if t.algorithm in SEMIRING_OF:
            if not np.array_equal(t.result.view(np.uint8),
                                  f.result.view(np.uint8)):
                raise AssertionError(f"ticket {t.ticket_id} ({t.algorithm}):"
                                     f" bf16 answer differs from f32")
        else:
            l1 = float(np.abs(t.result.astype(np.float64) - f.result).sum()
                       / max(np.abs(f.result.astype(np.float64)).sum(),
                             1e-30))
            sum_l1 = max(sum_l1, l1)
    if sum_l1 > SERVE_SUM_L1:
        raise AssertionError(f"a sum lane's bf16 answer is {sum_l1} (L1, "
                             f"relative) from f32")
    rows.append({"phase": "tuned-narrow-serving", "queries": len(s_tickets),
                 "waves": st.waves, "wall_s": s_wall,
                 "queries_per_s": st.queries_per_s,
                 "p50_wave_latency_s": st.p50_wave_latency_s,
                 "launches": counts, "lane_tiles": tiles,
                 "autotune_runs": AT.run_count(),
                 "min_max_answers_bitwise_vs_f32": True,
                 "sum_answers_l1_rel_vs_f32_max": sum_l1})
    rows += push_time_by_mode(stream)
    AT.clear_cache()
    return rows, by_path


def attention_bound(*, b, sq, skv, h, kv, hd, vd, pairs, elt=2) -> dict:
    """The least device time of one attention call: its bytes (q, the K/V
    slots it needs, the output, each once, ``elt`` bytes an element) over
    HBM's rate, or its operations (2 (hd + vd) per allowed (query, key)
    pair and head) over the bf16 tensor-core peak, whichever is longer."""
    nbytes = elt * (b * sq * h * (hd + vd) + b * skv * kv * (hd + vd))
    ops = 2 * (hd + vd) * h * b * pairs
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(byte_s, op_s) * 1e3,
            "bound_us": max(byte_s, op_s) * 1e6,
            "bound_by": "bytes" if byte_s >= op_s else "operations"}


def allowed_pairs(sq, skv, causal, window) -> int:
    """(query, key) pairs the masks allow: row i sees keys [lo, hi)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, i + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bounds() -> list:
    """The attention kernels' least device times at Qwen2-0.5B's widths (14
    heads, 2 KV heads, head dim 64, bf16): causal prefill B = 1, S = 4096,
    and decode B = 8 against a full cache of 4096 slots."""
    h, kv, hd, s = 14, 2, 64, 4096
    return [
        {"phase": "attention-kernel-bound", "kernel": "flash_attention",
         "shape": f"Qwen2-0.5B causal prefill, B=1, S={s}",
         **attention_bound(b=1, sq=s, skv=s, h=h, kv=kv, hd=hd, vd=hd,
                           pairs=allowed_pairs(s, s, True, None))},
        {"phase": "attention-kernel-bound", "kernel": "decode_attention",
         "shape": f"Qwen2-0.5B decode, B=8, cache S={s}",
         **attention_bound(b=8, sq=1, skv=s, h=h, kv=kv, hd=hd, vd=hd,
                           pairs=s)}]


def exact_reference(state, beta: float = 0.85, iters: int = 30):
    """Plain f64 PageRank on the card, written apart from the port's sweep
    code (same Gelly normalization, 30 iterations)."""
    live = state.edge_mask()
    s, d = state.src[live].long(), state.dst[live].long()
    n = state.node_capacity
    deg = torch.zeros(n, dtype=torch.float64, device=s.device).index_add_(
        0, s, torch.ones_like(s, dtype=torch.float64))
    active = state.node_active
    r = active.double()
    for _ in range(iters):
        inc = torch.zeros_like(r).index_add_(0, d, r[s] / deg[s])
        r = torch.where(active, (1.0 - beta) + beta * inc, 0.0)
    return r


def snapshot(engine) -> dict:
    """Copies of the inputs of the query the engine is about to serve."""
    st = engine.state
    return {"state": {k: None if v is None else v.clone()
                      for k, v in st._asdict().items()},
            "ranks": engine.algo_state["ranks"].clone(),
            "deg_prev": engine.deg_prev.clone(),
            "active_prev": engine.active_prev.clone()}


def drive_main_path(stream, holder: dict, **overrides):
    """The port's main path through its front door (``overrides`` go to
    the session); returns the session, per-query rows and the kernel
    launches it made."""
    import repro_torch
    from repro_torch.core.algorithm import Action
    from repro_torch.core.policies import periodic_exact
    from repro_torch.kernels.spmv.kernel import spmv_push, spmv_reduce_push
    from repro_torch.metrics import rbo_from_scores

    policy = periodic_exact(QUERIES - 1)

    def on_query(qid, view):
        action = policy(qid, view)
        if action == Action.APPROXIMATE:
            holder["inputs"][qid] = snapshot(holder["engine"])
        return action

    def on_query_result(qid, msg, action, scores, st):
        if action == Action.APPROXIMATE:
            holder["outputs"][qid] = (scores.clone(), st)

    spmv_push.launches = spmv_reduce_push.launches = 0
    t0 = time.perf_counter()
    sess = repro_torch.session(stream, on_query=on_query,
                               on_query_result=on_query_result, **overrides)
    holder["engine"] = sess.engine
    init = sess.stats_log[0]
    expected = init.iterations
    rows = [{"phase": "main-path", "query": -1, "action": init.action,
             "iterations": init.iterations,
             "wall_ms": init.wall_time_s * 1e3,
             "launches": spmv_push.launches}]
    plays = sess.play()
    for _ in range(QUERIES):
        before = spmv_push.launches
        res = next(plays)
        st = res.stats
        made = spmv_push.launches - before
        if st.overflow_fallback:
            raise AssertionError("the default capacities must not overflow")
        want = st.iterations + (st.action == Action.APPROXIMATE.value)
        expected += want
        exact = exact_reference(sess.engine.state).cpu().numpy()
        rows.append({
            "phase": "main-path", "query": st.query_id, "action": st.action,
            "num_hot": st.num_hot, "num_ek": st.num_ek, "num_eb": st.num_eb,
            "iterations": st.iterations, "wall_ms": st.wall_time_s * 1e3,
            "launches": made, "pushes": want,
            "rbo_vs_exact": rbo_from_scores(
                res.scores.astype(np.float64), exact, depth=RBO_DEPTH,
                active=sess.engine.state.node_active.cpu().numpy())})
        if made != want:
            raise AssertionError(f"query {st.query_id}: {made} kernel "
                                 f"launches for {want} pushes")
    total = spmv_push.launches
    wall = time.perf_counter() - t0
    if total != expected:
        raise AssertionError(f"{total} launches for {expected} pushes")
    if spmv_reduce_push.launches:
        raise AssertionError("the PageRank path launched the min/max kernel")
    return sess, rows, total, wall


def teacher_forced(inputs: dict, engine, device) -> tuple:
    """Replay one query's inputs on ``device``: the hot mask and summary
    stage by stage, then the fused step.  Returns (hot mask, summary,
    ranks, stats, full-graph layout)."""
    from repro_torch.core.backend import build_layout
    from repro_torch.core.fused import fused_query_step
    from repro_torch.core.hotset import select_hot_set
    from repro_torch.core.pagerank import build_summary
    from repro_torch.graph.graph import GraphState

    cfg = engine.config
    state = GraphState(**{k: None if v is None else v.to(device)
                          for k, v in inputs["state"].items()})
    ranks = inputs["ranks"].to(device)
    deg_prev = inputs["deg_prev"].to(device)
    active_prev = inputs["active_prev"].to(device)
    r = torch.tensor(cfg.r, dtype=torch.float32, device=device)
    delta = torch.tensor(cfg.delta, dtype=torch.float32, device=device)
    layout = build_layout(state)
    knobs = dict(n=cfg.n, delta_hop_cap=cfg.delta_hop_cap,
                 degree_mode=cfg.degree_mode, expand_both=cfg.expand_both)
    hot, _ = select_hot_set(state, deg_prev, ranks, r, delta,
                            active_prev=active_prev, **knobs)
    summary = build_summary(state, ranks, hot,
                            hot_node_capacity=cfg.hot_node_capacity,
                            hot_edge_capacity=cfg.hot_edge_capacity,
                            layout=layout)
    new_state, stats = fused_query_step(
        state, {"ranks": ranks}, deg_prev, active_prev, r, delta,
        algo=engine.algorithm, hot_node_capacity=cfg.hot_node_capacity,
        hot_edge_capacity=cfg.hot_edge_capacity, layouts=(layout,), **knobs)
    return hot, summary, new_state["ranks"], stats, layout


def f64_replay(inputs: dict, engine, summary, layout, hot, iterations):
    """``b_in`` and the summarized ranks recomputed in f64 with the plain
    version, over a summary whose structure was already verified: the
    oracle both f32 replays are held against."""
    from repro_torch.core.backend import summary_layout
    from repro_torch.kernels.spmv.kernel import spmv_push_plain

    f64 = torch.float64
    ranks_prev = inputs["ranks"].to(hot.device)
    n = ranks_prev.shape[0]
    k_cap = summary.hot_ids.shape[0]
    local_valid = torch.arange(k_cap, device=hot.device) < summary.num_hot
    hot_c = summary.hot_ids.clamp(max=n - 1)
    eb = ~hot[layout.src] & hot[layout.dst.clamp(max=n - 1)]
    b_in = torch.where(local_valid, spmv_push_plain(
        ranks_prev, layout.src, layout.weight, layout.row_offsets, eb,
        dtype=f64)[hot_c], 0.0)
    ek = summary_layout(summary)
    beta = engine.algorithm.beta
    r = torch.where(local_valid, ranks_prev[hot_c].to(f64), 0.0)
    for _ in range(iterations):
        inc = spmv_push_plain(r, ek.src, ek.weight, ek.row_offsets,
                              dtype=f64)
        r = torch.where(local_valid, (1.0 - beta) + beta * (inc + b_in), 0.0)
    ranks = ranks_prev.to(f64).clone()
    ranks[hot_c[local_valid]] = r[local_valid]
    return b_in, ranks


def max_rel(a, b) -> float:
    """max |a - b| / max(|b|, 1e-12), in f64 on the CPU."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1e-12)).max())


def host_sync_cost(summary, ranks_prev) -> dict:
    """Per-iteration cost of the eager power loop's read-back of the step
    size: ``summarized_pagerank`` (one device-to-host read per iteration)
    against the same pushes and elementwise work with no read-back."""
    from repro_torch.core import backend as B
    from repro_torch.core.pagerank import summarized_pagerank

    k_cap = summary.hot_ids.shape[0]
    local_valid = torch.arange(k_cap, device=ranks_prev.device) < \
        summary.num_hot
    r0 = torch.where(local_valid, ranks_prev[summary.hot_ids.clamp(
        max=ranks_prev.shape[0] - 1)], 0.0)
    layout = B.summary_layout(summary)
    iters = summarized_pagerank(summary, ranks_prev)[1]

    def no_read_back():
        r = r0
        for _ in range(iters):
            new_r = torch.where(local_valid, 0.15 + 0.85 * (
                B.push(r, layout) + summary.b_in), 0.0)
            (new_r - r).abs().sum()  # the step size, left on the card
            r = new_r
        return r

    def wall_s(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps

    with_s = wall_s(lambda: summarized_pagerank(summary, ranks_prev))
    without_s = wall_s(no_read_back)
    return {"phase": "host-sync", "loop": "summarized_pagerank",
            "iterations": iters, "num_ek": int(summary.num_ek),
            "with_read_back_ms": with_s * 1e3,
            "without_read_back_ms": without_s * 1e3,
            "per_iteration_us": (with_s - without_s) / iters * 1e6}


def traversal_snapshot(engine) -> dict:
    """Copies of the inputs of the traversal query the engine is about to
    serve."""
    st = engine.state
    return {"state": {k: None if v is None else v.clone()
                      for k, v in st._asdict().items()},
            "algo_state": {k: v.clone() for k, v in engine.algo_state.items()},
            "deg_prev": engine.deg_prev.clone(),
            "active_prev": engine.active_prev.clone()}


def drive_traversal(stream, name: str, kw: dict, device, holder=None):
    """One traversal session through the front door on ``device``, with
    every kernel count set to 0 just before it.  Checks per query that the
    pushes are what the sweeps need and, on the card, that each was one
    ``spmv_reduce_push`` launch.  On the card each answer is also compared
    with an independent search of the same graph, which an exact answer
    must equal bitwise.  Returns (rows, host results, launches, pushes,
    wall seconds, engine)."""
    import repro_torch
    from repro_torch.core import backend as B
    from repro_torch.core.algorithm import Action
    from repro_torch.core.policies import periodic_exact
    from repro_torch.kernels.spmv.kernel import spmv_push, spmv_reduce_push

    policy = periodic_exact(TRAVERSAL_EXACT_EVERY)
    box = {}

    def on_query(qid, view):
        action = policy(qid, view)
        if holder is not None and action == Action.APPROXIMATE:
            holder[qid] = traversal_snapshot(box["engine"])
        return action

    # two pushes per iteration (and two b_in passes) for the two
    # orientations of connected components
    per_iter = 2 if name == "connected-components" else 1
    on_card = torch.device(device).type == "cuda"
    spmv_push.launches = spmv_reduce_push.launches = 0
    B.reset_trace_counts()
    t0 = time.perf_counter()
    sess = repro_torch.session(stream, name, device=device, r=TRAVERSAL_R,
                               on_query=on_query, **kw)
    box["engine"] = sess.engine
    init = sess.stats_log[0]
    rows = [{"phase": "traversal", "algorithm": name, "device": str(device),
             "query": -1, "action": init.action,
             "iterations": init.iterations, "wall_ms": init.wall_time_s * 1e3,
             "pushes": B.trace_count("push"),
             "launches": spmv_reduce_push.launches}]
    results = [sess.scores]
    plays = sess.play()
    for _ in range(TRAVERSAL_QUERIES):
        l0, p0 = spmv_reduce_push.launches, B.trace_count("push")
        res = next(plays)
        st = res.stats
        made = spmv_reduce_push.launches - l0
        pushes = B.trace_count("push") - p0
        want = per_iter * (st.iterations
                           + (st.action == Action.APPROXIMATE.value))
        if st.overflow_fallback:
            raise AssertionError(f"{name}: the default capacities must not "
                                 f"overflow")
        if pushes != want or made != (pushes if on_card else 0):
            raise AssertionError(f"{name} query {st.query_id}: {made} "
                                 f"launches, {pushes} pushes, {want} wanted")
        rows.append({"phase": "traversal", "algorithm": name,
                     "device": str(device), "query": st.query_id,
                     "action": st.action, "num_hot": st.num_hot,
                     "num_ek": st.num_ek, "num_eb": st.num_eb,
                     "iterations": st.iterations,
                     "wall_ms": st.wall_time_s * 1e3, "pushes": pushes,
                     "launches": made})
        if on_card:
            truth = independent_exact(name, sess.engine.state)
            rows[-1]["share_equal_to_exact"] = float(
                np.mean(res.scores == truth))
            if st.action == Action.EXACT.value and not np.array_equal(
                    res.scores.view(np.uint8), truth.view(np.uint8)):
                raise AssertionError(f"{name} query {st.query_id}: the "
                                     f"exact answer differs from an "
                                     f"independent search")
        results.append(res.scores)
    wall = time.perf_counter() - t0
    launches, pushes = spmv_reduce_push.launches, B.trace_count("push")
    if spmv_push.launches:
        raise AssertionError(f"{name}: {spmv_push.launches} SpMV launches "
                             f"on the traversal path")
    if launches != (pushes if on_card else 0):
        raise AssertionError(f"{name}: {launches} launches for {pushes} "
                             f"pushes")
    if not any(r.get("num_ek", 0) > 0 and r["action"] == "compute-approximate"
               for r in rows):
        raise AssertionError(f"{name}: no approximate query had E_K edges")
    if not any(r["action"] == "compute-exact" for r in rows[1:]):
        raise AssertionError(f"{name}: the policy served no exact query")
    return rows, results, launches, pushes, wall, sess.engine


def independent_exact(name: str, state, source: int = 0) -> np.ndarray:
    """The exact answer of ``name`` on the live graph, by scipy's graph
    searches (written apart from the port): hop distances from ``source``,
    reachability widths, or least ids of weak components."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra

    live = state.edge_mask().cpu().numpy()
    s = state.src.cpu().numpy()[live]
    d = state.dst.cpu().numpy()[live]
    n = state.node_capacity
    active = state.node_active.cpu().numpy()
    adj = csr_matrix((np.ones(s.shape[0]), (s, d)), shape=(n, n))
    if name == "connected-components":
        _, comp = connected_components(adj, directed=True, connection="weak")
        least = np.full(comp.max() + 1, n, np.int64)
        np.minimum.at(least, comp, np.arange(n))
        return np.where(active, least[comp],
                        np.iinfo(np.int32).max).astype(np.int32)
    hops = dijkstra(adj, indices=source,
                    unweighted=True).astype(np.float32)
    if name == "sssp":
        return hops
    return np.isfinite(hops).astype(np.float32)  # unit lengths: width 1


def traversal_ek_check(name, snap, engine, st, rng) -> dict:
    """Teacher-force one approximate query's hot set and summary on the
    card and hold the min/max kernel against its plain version at that E_K
    layout."""
    from repro_torch.core.backend import build_layout, summary_layout
    from repro_torch.core.hotset import select_hot_set
    from repro_torch.graph.graph import GraphState

    cfg, algo = engine.config, engine.algorithm
    dev = engine.device
    state = GraphState(**snap["state"])
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    hot, _ = select_hot_set(
        state, snap["deg_prev"], algo.selection_view(snap["algo_state"]),
        f32(cfg.r), f32(cfg.delta), active_prev=snap["active_prev"],
        n=cfg.n, delta_hop_cap=cfg.delta_hop_cap,
        degree_mode=cfg.degree_mode, expand_both=cfg.expand_both,
        normalize_scores=algo.normalize_selection_scores)
    layouts = tuple(build_layout(state, weight=w, reverse=r, semiring=sr)
                    for w, r, sr in algo.layout_specs)
    summaries = algo.build_summaries(
        snap["algo_state"], state, hot,
        hot_node_capacity=cfg.hot_node_capacity,
        hot_edge_capacity=cfg.hot_edge_capacity, layouts=layouts)
    got = (int(summaries[0].num_hot), int(summaries[0].num_ek))
    if got != (st["num_hot"], st["num_ek"]):
        raise AssertionError(f"{name} query {st['query']}: teacher-forced "
                             f"summary {got} differs from the session's")
    ek = summary_layout(summaries[0], semiring=algo.semiring)
    k_cap = summaries[0].hot_ids.shape[0]
    dist = (10 * rng.random(k_cap)).astype(np.float32)
    dist[rng.random(k_cap) < 0.1] = np.inf
    return check_reduce_kernel(
        f"E_K of {name} query {st['query']} ({got[0]} hot)",
        torch.from_numpy(dist).to(dev), ek)


def traversal_path(stream, dev, rng):
    """Drive the three traversal sessions on the card, then replay each on
    the CPU with the plain versions; returns (rows to print, E_K check,
    kernel launches, pushes)."""
    out, ek_check = [], None
    launches = pushes = 0
    keys = ("action", "num_hot", "num_ek", "num_eb", "iterations")
    for name, kw in TRAVERSAL:
        holder = {} if name == "sssp" else None
        rows, card, made, pushed, wall, engine = drive_traversal(
            stream, name, kw, dev, holder)
        launches += made
        pushes += pushed
        out.extend(rows)
        if holder is not None:
            # the last approximate query with E_K edges: past the first
            # one, whose hot set is most of the graph
            last = [r for r in rows if r["action"] == "compute-approximate"
                    and r["num_ek"] > 0][-1]
            ek_check = traversal_ek_check(name, holder[last["query"]],
                                          engine, last, rng)
        del engine, holder
        torch.cuda.empty_cache()
        cpu_rows, cpu, _, _, cpu_wall, _ = drive_traversal(
            stream, name, kw, "cpu")
        for a, b, x, y in zip(rows, cpu_rows, card, cpu):
            if any(a.get(k) != b.get(k) for k in keys):
                raise AssertionError(f"{name} query {a['query']}: card "
                                     f"{a} and CPU {b} differ")
            if not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                raise AssertionError(f"{name} query {a['query']}: results "
                                     f"differ between card and CPU")
        out.append({"phase": "traversal-total", "algorithm": name,
                    "queries": TRAVERSAL_QUERIES, "wall_s": wall,
                    "kernel_launches": made, "pushes": pushed,
                    "spmv_push_launches": 0,
                    "approximate_with_ek": sum(
                        r.get("num_ek", 0) > 0 for r in rows),
                    "cpu_replay_bitwise": True, "cpu_replay_s": cpu_wall})
    return out, ek_check, launches, pushes


#: every kernel wrapper of the port -> the kernel family that holds it
KERNELS = {"spmv_push": "spmv", "spmv_reduce_push": "spmv",
           "spmv_push_batched": "spmv", "spmv_reduce_push_batched": "spmv",
           "flash_attention": "flash_attention",
           "flash_attention_bwd": "flash_attention",
           "flash_attention_dynamic": "flash_attention",
           "flash_attention_bwd_dynamic": "flash_attention",
           "decode_attention": "decode_attention"}
KERNEL_NAMES = tuple(KERNELS)


def wrapper(name: str):
    """The wrapper function of a kernel (its ``.launches`` is the count)."""
    import importlib

    return getattr(importlib.import_module(
        f"repro_torch.kernels.{KERNELS[name]}.kernel"), name)


def launch_counts() -> dict:
    return {k: wrapper(k).launches for k in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for k in KERNEL_NAMES:
        wrapper(k).launches = 0


def serving_plan(src, dst, nodes, rng) -> list:
    """The requests of the serving run as (algorithm, params): seeds and
    sources drawn from the vertices with out-edges, and Katz at
    α = 1 / (2·√(max in-degree · max out-degree)), below 1/σ_max(A)."""
    out_deg = np.bincount(src, minlength=nodes)
    in_deg = np.bincount(dst, minlength=nodes)
    alpha = 1.0 / (2.0 * np.sqrt(float(in_deg.max()) * float(out_deg.max())))
    pick = rng.choice(np.flatnonzero(out_deg > 0),
                      SERVE_PPR + SERVE_SSSP + SERVE_WIDEST, replace=False)
    plan = [("personalized-pagerank", {"seeds": (int(v),)})
            for v in pick[:SERVE_PPR]]
    plan += [("sssp", {"sources": (int(v),)})
             for v in pick[SERVE_PPR:SERVE_PPR + SERVE_SSSP]]
    plan += [("widest-path", {"sources": (int(v),)})
             for v in pick[SERVE_PPR + SERVE_SSSP:]]
    plan += [("connected-components", {}), ("katz", {"alpha": alpha}),
             ("hits", {})]
    return plan


def capture_waves(store: dict):
    """Wrap the serving engine's batched step so that every wave of the
    PPR, Katz and HITS lanes, and the first wave of the others, keeps
    copies of its inputs and outputs in ``store[lane]`` (a list in wave
    order, for the replays); returns the function that undoes it."""
    from repro_torch.serve import graph as SG

    real = SG.fused_query_step_batched

    def wrapper(state, bank, deg_prev, active_prev, r, delta, row_mask,
                cold_rows=None, **kw):
        name = kw["algo"].name
        if name in SEMIRING_OF and name in store:
            return real(state, bank, deg_prev, active_prev, r, delta,
                        row_mask, cold_rows, **kw)
        keep = {"state": {k: None if v is None else v.clone()
                          for k, v in state._asdict().items()},
                "bank": {k: v.clone() for k, v in bank.items()},
                "deg_prev": deg_prev.clone(),
                "active_prev": active_prev.clone(), "r": r.clone(),
                "delta": delta.clone(), "row_mask": row_mask.clone(),
                "cold_rows": cold_rows.clone(), "kw": kw}
        out = real(state, bank, deg_prev, active_prev, r, delta, row_mask,
                   cold_rows, **kw)
        keep["out"] = {k: v.clone() for k, v in out[0].items()}
        keep["iterations"] = out[1].iterations
        store.setdefault(name, []).append(keep)
        return out

    SG.fused_query_step_batched = wrapper
    return lambda: setattr(SG, "fused_query_step_batched", real)


def drive_serving(stream, plan, device, capture=None, *, lag=0,
                  **overrides):
    """The serving path through ``repro_torch.serve_session`` on
    ``device`` (``overrides`` go to it), with every kernel count set to 0
    just before it: one stream chunk buffered before each wave from wave
    ``lag`` on.  Checks per wave that every batched push was one batched
    launch and that no single kernel ran outside an exact fallback, and on
    the card that each finished SSSP, widest-path and CC answer equals
    scipy's search of the graph that wave served.  Returns (rows, tickets,
    server, launch counts, wall seconds, and for each lane the tickets each
    of its waves finished)."""
    import repro_torch
    from repro_torch.core import backend as B

    on_card = torch.device(device).type == "cuda"
    undo = capture_waves(capture) if capture is not None else None
    reset_launch_counts()
    B.reset_trace_counts()
    t0 = time.perf_counter()
    srv = repro_torch.serve_session(stream, slots=BATCH, device=device,
                                    **overrides)
    tickets = [srv.submit(name, **kw) for name, kw in plan]
    chunks = iter(stream)
    rows, finished = [], {}
    try:
        while srv.pending:
            if len(rows) >= lag:
                s, d = next(chunks)
                srv.add_edges(s, d)
            c0, p0, b0 = (launch_counts(), B.trace_count("push"),
                          B.trace_count("push[batched]"))
            logged, done = len(srv.wave_log), [t.done for t in tickets]
            t = time.perf_counter()
            srv.step()
            wall_ms = (time.perf_counter() - t) * 1e3
            c1 = launch_counts()
            made = {k: c1[k] - c0[k] for k in KERNEL_NAMES}
            batched = B.trace_count("push[batched]") - b0
            single = B.trace_count("push") - p0 - batched
            lanes = srv.wave_log[logged:]
            fallback = any(w.overflow_fallback for w in lanes)
            got_b = made["spmv_push_batched"] + made["spmv_reduce_push_batched"]
            got_s = made["spmv_push"] + made["spmv_reduce_push"]
            if on_card and got_b != batched:
                raise AssertionError(f"wave {len(rows)}: {got_b} batched "
                                     f"launches for {batched} batched pushes")
            if on_card and got_s != single or (single and not fallback):
                raise AssertionError(f"wave {len(rows)}: {got_s} single "
                                     f"launches, {single} single pushes, "
                                     f"fallback {fallback}")
            if not on_card and (got_b or got_s):
                raise AssertionError("the CPU run launched a kernel")
            row = {"phase": "serving-wave", "device": str(device),
                   "wave": len(rows), "wall_ms": wall_ms,
                   "epoch": srv.stats.epoch,
                   "snapshot_lag": srv.stats.snapshot_lag,
                   "batched_pushes": batched, "launches": made,
                   "lanes": [{"lane": w.algorithm, "occupied": w.occupied,
                              "cold": w.cold, "num_hot": w.num_hot,
                              "num_ek": w.num_ek, "num_eb": w.num_eb,
                              "iterations": w.iterations,
                              "overflow_fallback": w.overflow_fallback,
                              **({} if w.row_drift is None else {
                                  "row_drift": w.row_drift,
                                  "refreshed": w.refreshed})}
                             for w in lanes]}
            newly = [tk for tk, was in zip(tickets, done)
                     if tk.done and not was]
            for w in lanes:
                finished.setdefault(w.algorithm, []).append(
                    [tk for tk in newly if tk.algorithm == w.algorithm])
            if on_card:
                row["finished_equal_to_search"] = check_served_answers(
                    srv._served_state(), newly)
            rows.append(row)
    finally:
        if undo is not None:
            undo()
    wall = time.perf_counter() - t0
    if not all(t.done for t in tickets):
        raise AssertionError("a ticket did not complete")
    return rows, tickets, srv, launch_counts(), wall, finished


def check_served_answers(state, finished) -> int:
    """Each finished SSSP, widest-path and CC ticket whose sweep converged
    must equal scipy's search of the graph it was served on, bit for bit;
    returns how many were checked."""
    checked = 0
    for t in finished:
        if t.algorithm not in SEMIRING_OF:
            continue
        if not t.converged:
            raise AssertionError(f"ticket {t.ticket_id} ({t.algorithm}) did "
                                 f"not converge in its wave")
        source = t.params.get("sources", (0,))[0]
        truth = independent_exact(t.algorithm, state, source)
        if not np.array_equal(t.result.view(np.uint8), truth.view(np.uint8)):
            raise AssertionError(f"ticket {t.ticket_id} ({t.algorithm}): the "
                                 f"served answer differs from scipy's search")
        checked += 1
    return checked


def ticket_bank(cap, tickets) -> dict:
    """The bank of one served wave rebuilt on the CPU from its tickets
    alone, one row per ticket from a fresh instance of its request (every
    ticket is seated fresh, ``max_waves=1``): independent of the engine's
    slot refill, row mask and harvest."""
    from repro_torch.core.algorithm import make_algorithm
    from repro_torch.graph.graph import GraphState

    state = GraphState(**{k: None if v is None else v.cpu()
                          for k, v in cap["state"].items()})
    rows = []
    for t in tickets:
        if t.max_waves != 1 or t.waves_run != 1:
            raise AssertionError(f"ticket {t.ticket_id} ran {t.waves_run} "
                                 f"of {t.max_waves} waves, not one fresh one")
        rows.append(make_algorithm(t.algorithm, **t.params).init_state(state))
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def wave_structure(cap, device, bank=None):
    """Teacher-force one captured wave on ``device`` up to its summaries:
    (hot mask, summaries, bank, state, row mask).  ``bank`` (the rows of
    the wave's live queries only, every one cold) replaces the captured
    bank and row mask."""
    from repro_torch.core import backend as B
    from repro_torch.core.fused import _cold_coverage
    from repro_torch.core.hotset import select_hot_set
    from repro_torch.graph.graph import GraphState

    kw = cap["kw"]
    algo = kw["algo"]
    to = lambda x: x.to(device)
    state = GraphState(**{k: None if v is None else to(v)
                          for k, v in cap["state"].items()})
    if bank is None:
        bank = {k: to(v) for k, v in cap["bank"].items()}
        row_mask = to(cap["row_mask"])
        cold = to(cap["cold_rows"]) & row_mask
    else:
        bank = {k: to(v) for k, v in bank.items()}
        row_mask = torch.ones(next(iter(bank.values())).shape[0],
                              dtype=torch.bool, device=device)
        cold = row_mask
    hot, _ = select_hot_set(
        state, to(cap["deg_prev"]), algo.batched_selection_scores(
            bank, row_mask), to(cap["r"]), to(cap["delta"]),
        active_prev=to(cap["active_prev"]), n=kw["n"],
        delta_hop_cap=kw["delta_hop_cap"], degree_mode=kw["degree_mode"],
        expand_both=kw["expand_both"],
        normalize_scores=algo.normalize_selection_scores)
    extra = _cold_coverage(state, algo, bank, cold)
    if extra is not None:
        hot = hot | extra
    layouts = tuple(B.build_layout(state, weight=w, reverse=r, semiring=s)
                    for w, r, s in map(B.normalize_layout_spec,
                                       algo.layout_specs))
    summaries = algo.build_summaries(
        bank, state, hot, hot_node_capacity=kw["hot_node_capacity"],
        hot_edge_capacity=kw["hot_edge_capacity"], layouts=layouts)
    return hot, summaries, bank, state, row_mask


def f64_wave(cap, hot, bank, state, row_mask):
    """One wave's summaries and sweep recomputed in f64 on the CPU over the
    given hot mask, bank and graph: the bank's f32 leaves widened, every
    push the plain batched version in f64, at most the card's iteration
    count.  Returns (the f64 result view, its iterations)."""
    import dataclasses

    from repro_torch.core import backend as B
    from repro_torch.kernels.spmv.kernel import spmv_push_batched_plain

    kw = cap["kw"]
    algo = dataclasses.replace(kw["algo"], num_iters=cap["iterations"])
    bank = {k: v.double() if v.dtype == torch.float32 else v
            for k, v in bank.items()}
    real = B.spmv_push_batched
    B.spmv_push_batched = lambda v, s, w, ro, m=None, mul="times", **_: \
        spmv_push_batched_plain(v, s, w, ro, m, mul=mul, dtype=torch.float64)
    try:
        layouts = tuple(B.build_layout(state, weight=w, reverse=r, semiring=s)
                        for w, r, s in map(B.normalize_layout_spec,
                                           algo.layout_specs))
        summaries = algo.build_summaries(
            bank, state, hot, hot_node_capacity=kw["hot_node_capacity"],
            hot_edge_capacity=kw["hot_edge_capacity"], layouts=layouts)
        out, iters, _ = algo.summarized_batched(bank, state, summaries,
                                                row_mask=row_mask)
    finally:
        B.spmv_push_batched = real
    # fewer iterations only where the f64 sweep reached an exact fixed
    # point (a zero step at tol = 0), which more steps would not move
    return algo.result_view(out), iters


def replay_waves(captured: dict, wave_log, finished: dict, dev) -> tuple:
    """For each captured wave: its hot mask and summary structure
    teacher-forced on the card from the served bank, and on the CPU from a
    bank rebuilt from the wave's tickets alone (bitwise equal, and equal to
    the served wave's counts); for the sum lanes, every served ticket
    against an f64 replay of its wave's sweep from that rebuilt bank.
    Returns (rows, and for the first PPR and SSSP waves the card's
    summary, hot mask and graph)."""
    rows, kept = [], {}
    for name, caps in captured.items():
        served_waves = [w for w in wave_log if w.algorithm == name]
        for k, cap in enumerate(caps):
            served, tickets = served_waves[k], finished[name][k]
            if len(tickets) != served.occupied:
                raise AssertionError(f"{name} wave {k}: {len(tickets)} "
                                     f"tickets finished, {served.occupied} "
                                     f"slots were live")
            g_hot, g_sums, _, g_state, _ = wave_structure(cap, dev)
            bank = ticket_bank(cap, tickets)
            c_hot, c_sums, bank, state, live = wave_structure(
                cap, torch.device("cpu"), bank)
            if not torch.equal(g_hot.cpu(), c_hot):
                raise AssertionError(f"{name} wave {k}: card and CPU hot "
                                     f"masks differ")
            for g, c in zip(g_sums, c_sums):
                for f in ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                          "ek_row_offsets", "num_ek", "num_eb", "overflow"):
                    if not same_bits(getattr(g, f).cpu(), getattr(c, f)):
                        raise AssertionError(f"{name} wave {k}: summary {f} "
                                             f"differs between card and CPU")
            got = (int(g_sums[0].num_hot), int(g_sums[0].num_ek))
            if got != (served.num_hot, served.num_ek):
                raise AssertionError(f"{name} wave {k}: teacher-forced "
                                     f"summary {got}, served "
                                     f"{served.num_hot, served.num_ek}")
            row = {"phase": "serving-replay", "lane": name, "lane_wave": k,
                   "wave": served.wave,
                   "tickets": [t.ticket_id for t in tickets],
                   "num_hot": got[0], "num_ek": got[1],
                   "hot_mask_bitwise": True,
                   "summary_structure_bitwise": True}
            if k == 0 and name in ("personalized-pagerank", "sssp"):
                kept[name] = (g_sums[0], g_hot, g_state)
            if name not in SEMIRING_OF:
                card = torch.from_numpy(np.stack([t.result for t in tickets])
                                        ).double()
                ref, iters = f64_wave(cap, c_hot, bank, state, live)
                row["iterations"] = cap["iterations"]
                row["f64_iterations"] = iters
                row["tickets_vs_f64_max_rel"] = max_rel(card, ref)
                row["tolerance"] = {"rtol": SERVE_RTOL, "atol": SERVE_ATOL}
                torch.testing.assert_close(card, ref, rtol=SERVE_RTOL,
                                           atol=SERVE_ATOL)
            rows.append(row)
    return rows, kept


def serving_path(stream, src, dst, nodes, dev, rng):
    """Serve the plan on the card (counts set to 0 just before, read just
    after), then on the CPU, and replay its waves (see
    :func:`replay_waves`); then the kernels at the E_K layouts and in the
    b_in passes of the first PPR and SSSP waves.  Returns (rows to print,
    kernel checks, the card's launch counts)."""
    from repro_torch.core import backend as B
    from repro_torch.core.backend import summary_layout

    plan = serving_plan(src, dst, nodes, rng)
    captured = {}
    rows, tickets, srv, counts, wall, finished = drive_serving(
        stream, plan, dev, captured)
    for k in ("spmv_push_batched", "spmv_reduce_push_batched"):
        if not counts[k]:
            raise AssertionError(f"the serving run never launched {k}")
    st = srv.stats
    out = rows + [{"phase": "serving-stats", "device": str(dev),
                   "queries": len(tickets), "waves": st.waves,
                   "wall_s": wall, "queries_per_s": st.queries_per_s,
                   "p50_wave_latency_s": st.p50_wave_latency_s,
                   "p95_wave_latency_s": st.p95_wave_latency_s,
                   "mean_occupancy": st.mean_occupancy,
                   "overflow_fallbacks": st.overflow_fallbacks,
                   "launches": counts}]
    replays, kept = replay_waves(captured, srv.wave_log, finished, dev)
    out += replays
    wave_log = [(w.algorithm, w.num_hot, w.num_ek, w.num_eb, w.occupied)
                for w in srv.wave_log]
    card = [(t.algorithm, t.waves_run, t.converged, t.exact_fallback,
             t.result) for t in tickets]
    specs = {name: caps[0]["kw"]["algo"].layout_specs
             for name, caps in captured.items()}
    del srv, captured
    torch.cuda.empty_cache()
    # the same run on the CPU: the same waves, and bitwise the same
    # answers for the min/max lanes
    cpu_rows, cpu_tickets, cpu_srv, _, cpu_wall, _ = drive_serving(
        stream, plan, "cpu")
    cpu_log = [(w.algorithm, w.num_hot, w.num_ek, w.num_eb, w.occupied)
               for w in cpu_srv.wave_log]
    if cpu_log != wave_log:
        raise AssertionError("card and CPU serving waves differ")
    # a sum lane "converges" in its wave only if its last f32 step is
    # exactly zero, which depends on the summation order: compared for the
    # min/max lanes only, reported for the others
    sum_rel, converged = 0.0, {"card": [], "cpu": []}
    for (name, waves, conv, fb, res), t in zip(card, cpu_tickets):
        if (waves, fb) != (t.waves_run, t.exact_fallback):
            raise AssertionError(f"ticket {t.ticket_id}: card and CPU "
                                 f"tickets differ")
        if name in SEMIRING_OF:
            if conv != t.converged or not np.array_equal(
                    res.view(np.uint8), t.result.view(np.uint8)):
                raise AssertionError(f"ticket {t.ticket_id} ({name}): card "
                                     f"and CPU answers differ")
        else:
            converged["card"].append(conv)
            converged["cpu"].append(t.converged)
            sum_rel = max(sum_rel, max_rel(torch.from_numpy(res),
                                           torch.from_numpy(t.result)))
    out.append({"phase": "serving-cpu-replay", "waves": len(cpu_rows),
                "wall_s": cpu_wall, "wave_structure_equal": True,
                "min_max_answers_bitwise": True,
                "sum_answers_card_vs_cpu_max_rel": sum_rel,
                "sum_tickets_converged": converged})
    # the batched kernels at the E_K layouts of two served waves, and the
    # single and batched kernels, on the same inputs, in the b_in pass of
    # those waves (their own hot sets' masks over the full layouts)
    checks = []
    for name, semiring in (("personalized-pagerank", "plus_times"),
                           ("sssp", "min_plus")):
        summary, hot, state = kept[name]
        ek = summary_layout(summary, semiring=semiring)
        w, rev, sr = B.normalize_layout_spec(specs[name][0])
        full = B.build_layout(state, weight=w, reverse=rev, semiring=sr)
        eb = b_in_mask(hot, full)
        tag = f"the first {name} wave ({int(summary.num_hot)} hot)"
        if semiring == "plus_times":
            v = torch.from_numpy(rng.random((BATCH, ek.row_offsets.shape[0]
                                             - 1)).astype(np.float32)).to(dev)
            checks.append(check_batched_kernel(f"E_K of {tag}", v, ek))
            v = torch.from_numpy(rng.random((BATCH, state.node_capacity))
                                 .astype(np.float32)).to(dev)
            checks.append(check_kernel(f"b_in pass of {tag}", v[0], full, eb))
            checks.append(check_batched_kernel(f"b_in pass of {tag}", v, full,
                                               eb))
        else:
            d = 10 * rng.random((BATCH, ek.row_offsets.shape[0] - 1))
            d[rng.random(d.shape) < 0.1] = np.inf
            checks.append(check_batched_reduce_kernel(
                f"E_K of {tag}", torch.from_numpy(d.astype(np.float32))
                .to(dev), ek))
            d = 10 * rng.random((BATCH, state.node_capacity))
            d[rng.random(d.shape) < 0.1] = np.inf
            d = torch.from_numpy(d.astype(np.float32)).to(dev)
            checks.append(check_reduce_kernel(f"b_in pass of {tag}", d[0],
                                              full, eb))
            checks.append(check_batched_reduce_kernel(f"b_in pass of {tag}",
                                                      d, full, eb))
        del full, eb
    return out, checks, counts, plan


# ---- closed-loop control and the async rebuild ---------------------------
CONTROL_RUNS = (("pagerank", {}, 0.95, 12),      # (algorithm, params,
                ("sssp", {"sources": (0,)}, 0.9, 5))  # target, queries)
# the card's drift readings against the host's f64 recomputation from the
# card's own state and layouts: |card - host| <= DRIFT_ATOL + DRIFT_RTOL *
# |host| + the first-order bound of the f32 rounding of the card's residual
# (a sum residual |F(x) - x| cancels: at a hub it is rounding noise)
DRIFT_ATOL, DRIFT_RTOL = 2e-6, 1e-4
F32_EPS = float(np.finfo(np.float32).eps)
SUM_FAMILY = ("pagerank", "personalized-pagerank", "katz")
# the async sessions: (algorithm, params, engine overrides); forced actions
# per query (A approximate, E exact, R repeat-last), one removal batch
ASYNC_RUNS = (("pagerank", {}, {}), ("sssp", {"sources": (0,)}, {}),
              ("connected-components", {}, {}),
              ("pagerank", {}, {"quality_target": 0.95}))
# one more PageRank run whose build stream first sleeps this many cycles
# (about 0.1 s) before every build, so that each build still runs when its
# query returns and when the next query promotes it: the answers are then
# bitwise only if promotion orders the main stream after the build
SLOW_BUILD_CYCLES = 200_000_000
ASYNC_ACTIONS = "AARAEAA"
ASYNC_REMOVE_AT = 3         # this query's batch also removes 200 edges


def capture_drift(store: list):
    """Wrap the fused steps' drift estimate so that every call keeps what
    a later recomputation needs (copies of what a later apply or wave may
    change), its readings and the kernel launches it made; returns the
    function that undoes it."""
    from repro_torch.core import fused as F

    real = F._drift_from_state

    def wrapper(algo, new_state, old_state, graph, hot, probe_ids, *,
                layouts):
        c0 = launch_counts()
        probe, cold = real(algo, new_state, old_state, graph, hot,
                           probe_ids, layouts=layouts)
        c1 = launch_counts()
        store.append({
            "algo": algo, "new": {k: v.clone() for k, v in new_state.items()},
            "old": {k: v.clone() for k, v in old_state.items()},
            "graph": graph._replace(node_active=graph.node_active.clone()),
            "hot": hot.clone(), "probes": probe_ids, "layouts": layouts,
            "probe": probe, "cold": cold,
            "launches": {k: c1[k] - c0[k] for k in c0 if c1[k] != c0[k]}})
        return probe, cold

    F._drift_from_state = wrapper
    return lambda: setattr(F, "_drift_from_state", real)


def host_residual(cap, inc=None) -> tuple:
    """One step's drift residual recomputed on the host from the card's
    state and layouts, written apart from the port in numpy: in f64 for
    the sums; for the min/max relaxations in f32 (their + and × round as on
    the card, and min/max take any order), so bitwise; for HITS, which
    defines no residual, the churn of its result.  Returns (the residual,
    a first-order bound of the f32 rounding of the card's residual per
    vertex: for a sum, ε·(|t| + 2|F(x)| + |x| + c·(L + 1)·Σ|w·x_src|) over a
    row of L edges with factor c, 0 where the card's residual is exact);
    ``[B, N]`` each for a bank, else ``[N]``.  ``inc`` (a sum's pushed
    vector, as the card's kernel gave it) replaces the host's push: the
    residual is then recomputed from it, and its bound drops the push's
    term."""
    algo, name = cap["algo"], cap["algo"].name
    new = {k: v.cpu().numpy() for k, v in cap["new"].items()}
    active = cap["graph"].node_active.cpu().numpy()
    n = active.shape[0]

    def edges(layout):
        v = layout.valid.cpu().numpy()
        return (layout.src.cpu().numpy()[v].astype(np.int64),
                layout.dst.cpu().numpy()[v].astype(np.int64),
                layout.weight.cpu().numpy()[v])

    def rows(x):
        return x if x.ndim == 2 else x[None]

    view = algo.result_view(cap["new"]).cpu().numpy()
    bound = None
    if name in SUM_FAMILY:
        s, d, w = edges(cap["layouts"][0])
        w = w.astype(np.float64)
        x = rows(new["katz" if name == "katz" else "ranks"]).astype(np.float64)
        if inc is None:
            inc = np.stack([np.bincount(d, weights=w * r[s], minlength=n)
                            for r in x])
            mag = np.stack([np.bincount(d, weights=np.abs(w * r[s]),
                                        minlength=n) for r in x])
            length = np.bincount(d, minlength=n).astype(np.float64)
        else:
            inc = rows(inc).astype(np.float64)
            mag, length = np.abs(inc), 0.0
        if name == "pagerank":
            tele = 1.0 - algo.beta
            if algo.teleport_by_n:
                tele /= max(int(active.sum()), 1)
            c = algo.beta
        elif name == "personalized-pagerank":
            tele = (1.0 - algo.beta) * rows(new["teleport"]).astype(
                np.float64)
            c = algo.beta
        else:
            tele, c = algo.beta, algo.alpha
        f = tele + c * inc
        out = np.abs(np.where(active, f, 0.0) - x)
        bound = F32_EPS * (np.abs(tele) + 2 * np.abs(f) + np.abs(x)
                           + c * (length + 1) * mag)
    elif name in ("sssp", "widest-path"):
        s, d, w = edges(cap["layouts"][0])
        out = []
        np_err = np.errstate(invalid="ignore")  # inf - inf, masked below
        np_err.__enter__()
        for r, pin in zip(rows(new[algo.value_key]), rows(new["source"])):
            if name == "sssp":
                inc = np.full(n, np.inf, np.float32)
                np.minimum.at(inc, d, r[s] + w)
                relaxed = np.where(pin, np.float32(0), np.minimum(r, inc))
                both = np.isfinite(relaxed) & np.isfinite(r)
                out.append(np.where(both, np.abs(relaxed - r),
                                    (relaxed != r).astype(np.float32)))
            else:
                inc = np.full(n, -np.inf, np.float32)
                np.maximum.at(inc, d, r[s] * w)
                relaxed = np.where(pin, np.float32(1), np.maximum(r, inc))
                out.append(np.abs(relaxed - r))
        np_err.__exit__(None, None, None)
        out = np.stack(out)
    elif name == "connected-components":
        out = []
        for lab in rows(new["labels"]):
            relaxed = lab.copy()
            for layout in cap["layouts"]:
                s, d, w = edges(layout)
                inc = np.full(n, np.iinfo(np.int32).max, np.int32)
                np.minimum.at(inc, d, np.minimum(lab[s], w))
                relaxed = np.minimum(relaxed, inc)
            out.append((active & (relaxed != lab)).astype(np.float32))
        out = np.stack(out)
    else:
        a = rows(view).astype(np.float64)
        b = rows(algo.result_view(cap["old"]).cpu().numpy()).astype(
            np.float64)
        both = np.isfinite(a) & np.isfinite(b)
        out = np.where(both, np.abs(a - b), (a != b).astype(np.float64))
        bound = F32_EPS * np.where(both, np.abs(a) + np.abs(b), 0.0)
    if bound is None:
        bound = np.zeros(out.shape)
    if view.ndim == 2:
        return out, bound
    return out[0], bound[0]


def host_signals(resid, result, hot, active, probes, normalize):
    """``(drift_probe, drift_cold)`` of one residual row in f64 on the host,
    written apart from ``repro_torch.core.control.drift_signals`` (the same
    reduction of a per-vertex bound gives the bound of each scalar)."""
    res = result.astype(np.float64)
    r = resid.astype(np.float64)
    finite = active & np.isfinite(res) & np.isfinite(r)
    r = np.where(finite, np.maximum(r, 0.0), 0.0)
    n_active = max(float(active.sum()), 1.0)
    mass = (n_active if normalize == "count" else
            max(float(np.where(finite, np.abs(res), 0.0).sum()), 1e-30))
    cold = float(np.where(hot, 0.0, r).sum()) / mass
    live = finite[probes]
    p_mean = float((r[probes] * live).sum()) / max(float(live.sum()), 1.0)
    return p_mean * n_active / mass, cold


def check_drift(cap) -> dict:
    """Check (a) of one captured step: every row's card readings against
    the host's f64 recomputation, at (DRIFT_ATOL, DRIFT_RTOL); for the
    min/max workloads the card's residual vector, recomputed on the card
    from the same inputs, is also bitwise the host's."""
    from repro_torch.core import backend as B

    algo = cap["algo"]
    result = algo.result_view(cap["new"]).cpu().numpy()
    hot = cap["hot"].cpu().numpy()
    active = cap["graph"].node_active.cpu().numpy()
    probes = cap["probes"].cpu().numpy().astype(np.int64)
    card_p = np.atleast_1d(cap["probe"].cpu().numpy()).astype(np.float64)
    card_c = np.atleast_1d(cap["cold"].cpu().numpy()).astype(np.float64)
    res_rows = result if result.ndim == 2 else result[None]

    def compare(host, bound):
        """Each row's readings against the host's signals of ``host``, at
        the tolerance plus the bound's share; returns (worst excess over
        the limit, rows of (card, host, bound) readings)."""
        host_rows = host if host.ndim == 2 else host[None]
        bound_rows = bound if bound.ndim == 2 else bound[None]
        worst, readings = 0.0, []
        for i, (h, b, res) in enumerate(zip(host_rows, bound_rows,
                                            res_rows)):
            hp, hc = host_signals(h, res, hot, active, probes,
                                  algo.drift_normalize)
            # where the residual is not finite host_signals drops it, and
            # its bound with it
            bp, bc = host_signals(np.where(np.isfinite(h), b, np.inf), res,
                                  hot, active, probes, algo.drift_normalize)
            for card, ref, f32_bound in ((card_p[i], hp, bp),
                                         (card_c[i], hc, bc)):
                excess = abs(card - ref) / (DRIFT_ATOL + DRIFT_RTOL * abs(ref)
                                            + f32_bound)
                worst = max(worst, excess)
                if excess > 1.0:
                    raise AssertionError(f"{algo.name}: card drift {card} "
                                         f"against the host's f64 {ref} "
                                         f"(f32 bound {f32_bound})")
            readings.append((float(card_p[i]), float(card_c[i]), hp, hc, bp,
                             bc))
        return worst, readings

    host, bound = host_residual(cap)
    worst, readings = compare(host, bound)
    out = {"rows": len(readings), "worst_excess_over_limit": worst,
           "readings": readings}
    if algo.name in SUM_FAMILY:
        # the same from the card's own push: tight where a hub's f32 sum
        # makes the bound of the full recomputation loose
        x = cap["new"]["katz" if algo.name == "katz" else "ranks"]
        inc = B.push(x, cap["layouts"][0]).cpu().numpy()
        tight, tight_readings = compare(*host_residual(cap, inc))
        out["given_push_worst_excess"] = tight
        out["given_push_readings"] = [r[2:] for r in tight_readings]
    if algo.name not in SUM_FAMILY and algo.name != "hits":
        card = algo.drift_residual(cap["new"], cap["graph"],
                                   layouts=cap["layouts"]).cpu().numpy()
        if not same_bits(torch.from_numpy(np.ascontiguousarray(card)),
                         torch.from_numpy(np.ascontiguousarray(
                             host.astype(np.float32)))):
            raise AssertionError(f"{algo.name}: the card's residual differs "
                                 f"from the host's")
        out["residual_bitwise"] = True
    return out


#: the drift pushes of one step, per algorithm: (kernel, launches), single
#: form for a session's query, batched form for a serving lane's wave
def drift_pushes(name: str, batched: bool) -> dict:
    if name == "hits":
        return {}
    kernel = "spmv_push" if name in SUM_FAMILY else "spmv_reduce_push"
    if batched:
        kernel += "_batched"
    return {kernel: 2 if name == "connected-components" else 1}


def control_path(stream, dev) -> tuple:
    """PageRank at quality_target=0.95 and SSSP at 0.9 through
    ``repro_torch.session`` on the card, every kernel count set to 0 just
    before each.  Per query: the drift readings, the controller's columns,
    and the quality measured against an exact replay of that query's graph
    (RBO@4000 against an f64 PageRank; for SSSP the share of vertices
    equal to scipy's search).  Checks (a) the readings against the host's
    f64 recomputation, (b) a fresh controller fed the card's readings
    decides exactly as the engine did, (c) each approximate query made its
    drift pushes as kernel launches, and every push of the run launched a
    kernel.  Returns (rows, launch counts)."""
    import repro_torch
    from repro_torch.core import backend as B
    from repro_torch.core.control import QualityController
    from repro_torch.metrics import rbo_from_scores

    out, totals = [], {}
    for name, kw, target, queries in CONTROL_RUNS:
        store = []
        undo = capture_drift(store)
        reset_launch_counts()
        B.reset_trace_counts()
        try:
            t0 = time.perf_counter()
            sess = repro_torch.session(stream, name, quality_target=target,
                                       **kw)
            plays = sess.play()
            rows = []
            for _ in range(queries):
                c0, n0 = launch_counts(), len(store)
                res = next(plays)
                c1 = launch_counts()
                st = res.stats
                caps = store[n0:]
                state = sess.engine.state
                if name == "pagerank":
                    quality = {"rbo_vs_f64_exact": rbo_from_scores(
                        res.scores.astype(np.float64),
                        exact_reference(state).cpu().numpy(),
                        depth=RBO_DEPTH,
                        active=state.node_active.cpu().numpy())}
                else:
                    truth = independent_exact(name, state)
                    quality = {"share_equal_to_exact": float(
                        np.mean(res.scores == truth))}
                rows.append({
                    "phase": "control", "algorithm": name,
                    "quality_target": target, "query": st.query_id,
                    "action": st.action, "refreshed": st.refreshed,
                    "drift_probe": (float(caps[0]["probe"]) if caps
                                    else None),
                    "drift_cold": float(caps[0]["cold"]) if caps else None,
                    "quality_est": st.quality_est, "r_eff": st.r_eff,
                    "delta_eff": st.delta_eff, "num_hot": st.num_hot,
                    "num_ek": st.num_ek, "iterations": st.iterations,
                    "wall_ms": st.wall_time_s * 1e3,
                    "launches": {k: c1[k] - c0[k] for k in c0
                                 if c1[k] != c0[k]},
                    "drift_launches": caps[0]["launches"] if caps else {},
                    **quality})
                # (c) the drift pushes of an approximate query
                approx = st.action == "compute-approximate"
                if len(caps) != approx or (approx and caps[0]["launches"]
                                           != drift_pushes(name, False)):
                    raise AssertionError(f"{name} query {st.query_id}: "
                                         f"drift pushes {rows[-1]}")
        finally:
            undo()
        wall = time.perf_counter() - t0
        counts, pushes = launch_counts(), B.trace_count("push")
        if sum(counts.values()) != pushes:
            raise AssertionError(f"{name}: {counts} launches for {pushes} "
                                 f"pushes")
        # (b) a fresh controller fed the card's readings decides alike
        cfg = sess.engine.config
        ctl = QualityController(target, r0=cfg.r, delta0=cfg.delta,
                                adjust_r=cfg.control_r,
                                adjust_delta=cfg.control_delta,
                                contraction=sess.algorithm.drift_contraction)
        for row in rows:
            if row["action"] != "compute-approximate":
                if row["action"] == "compute-exact":
                    ctl.refreshed()
                continue
            if (ctl.r_eff, ctl.delta_eff) != (row["r_eff"],
                                               row["delta_eff"]):
                raise AssertionError(f"{name} query {row['query']}: knobs "
                                     f"differ from the replayed controller")
            dec = ctl.observe(row["drift_probe"], row["drift_cold"])
            if dec.refresh != row["refreshed"]:
                raise AssertionError(f"{name} query {row['query']}: refresh "
                                     f"differs from the replayed controller")
            if dec.refresh:
                ctl.refreshed()
        # (a) the readings against the host's f64 recomputation
        worst = tight = 0.0
        for row, cap in zip([r for r in rows
                             if r["action"] == "compute-approximate"],
                            store):
            got = check_drift(cap)
            row["host_f64"] = got["readings"][0][2:4]
            row["f32_bound"] = got["readings"][0][4:]
            row["residual_bitwise"] = got.get("residual_bitwise")
            if "given_push_readings" in got:
                row["host_f64_given_push"] = got["given_push_readings"][0]
                tight = max(tight, got["given_push_worst_excess"])
            worst = max(worst, got["worst_excess_over_limit"])
        out += rows
        out.append({"phase": "control-total", "algorithm": name,
                    "quality_target": target, "queries": queries,
                    "wall_s": wall, "launches": counts, "pushes": pushes,
                    "refreshes": sess.engine.controller.refreshes,
                    "drift_tolerance": {"atol": DRIFT_ATOL,
                                        "rtol": DRIFT_RTOL},
                    "drift_worst_excess_over_limit": worst,
                    "drift_given_push_worst_excess": tight,
                    "controller_replay_exact": True,
                    "drift_pushes_per_query": drift_pushes(name, False)})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del sess, store
        torch.cuda.empty_cache()
    return out, totals


def control_serving_path(stream, plan, dev) -> tuple:
    """The serving plan at quality_target=0.95 on the card: per lane-wave
    the slots' drift, the lane's refreshes and the batched drift pushes'
    launches; checks (a) and (b) per lane-wave.  A refresh re-marks the
    lane's live slots cold; the live slots that were warm (not cold) on a
    refreshing lane-wave, the only ones it can change, are counted.
    Returns (rows, launch counts)."""
    from repro_torch.core.control import QualityController

    store = []
    undo = capture_drift(store)
    try:
        rows, tickets, srv, counts, wall, _ = drive_serving(
            stream, plan, dev, quality_target=0.95)
    finally:
        undo()
    if len(store) != len(srv.wave_log):
        raise AssertionError(f"{len(store)} drift estimates for "
                             f"{len(srv.wave_log)} lane-waves")
    cfg = srv.engine.config
    replay, out, worst, min_q = {}, [], 0.0, 1.0
    for w, cap in zip(srv.wave_log, store):
        name = cap["algo"].name
        if name != w.algorithm or cap["launches"] != drift_pushes(name, True):
            raise AssertionError(f"lane-wave {w}: drift launches "
                                 f"{cap['launches']}")
        got = check_drift(cap)
        worst = max(worst, got["worst_excess_over_limit"],
                    got.get("given_push_worst_excess", 0.0))
        # the engine read each live row's pair, and zeros for vacant ones
        for i, (pair, (p, c, *_)) in enumerate(zip(w.row_drift or (),
                                                     got["readings"])):
            if pair != (0.0, 0.0) and pair != (p, c):
                raise AssertionError(f"lane-wave {w.wave} {name} row {i}: "
                                     f"read {pair}, estimated {(p, c)}")
        # (b) the lane's controller replayed from the read readings
        ctl = replay.setdefault(name, QualityController(
            0.95, r0=cfg.r, delta0=cfg.delta, adjust_r=cfg.control_r,
            adjust_delta=cfg.control_delta,
            contraction=cap["algo"].drift_contraction))
        quality = None
        if w.overflow_fallback:
            ctl.refreshed()
        else:
            dec = ctl.observe(max(p for p, _ in w.row_drift),
                              max(c for _, c in w.row_drift))
            if dec.refresh != w.refreshed:
                raise AssertionError(f"lane-wave {w.wave} {name}: refresh "
                                     f"differs from the replayed controller")
            if dec.refresh:
                ctl.refreshed()
            quality = dec.quality_est
            min_q = min(min_q, quality)
        out.append({"phase": "control-serving-wave", "wave": w.wave,
                    "lane": name, "occupied": w.occupied, "cold": w.cold,
                    "row_drift": w.row_drift, "refreshed": w.refreshed,
                    "lane_refreshes": ctl.refreshes, "quality_est": quality,
                    "min_quality_est": min_q,
                    "drift_launches": cap["launches"],
                    "host_f64": [r[2:4] for r in got["readings"]],
                    "f32_bound": [r[4:] for r in got["readings"]],
                    "host_f64_given_push": got.get("given_push_readings"),
                    "residual_bitwise": got.get("residual_bitwise")})
    if min_q != srv.stats.min_quality_est:
        raise AssertionError(f"the replayed controllers' lowest quality "
                             f"estimate {min_q} differs from the served "
                             f"{srv.stats.min_quality_est}")
    for lane in srv._lanes.values():
        ctl = replay[lane.template.name]
        if (ctl.r_eff, ctl.delta_eff, ctl.refreshes) != (
                lane.controller.r_eff, lane.controller.delta_eff,
                lane.controller.refreshes):
            raise AssertionError(f"{lane.template.name}: the replayed "
                                 f"controller ended elsewhere")
    st = srv.stats
    out.append({"phase": "control-serving-total", "queries": len(tickets),
                "waves": st.waves, "wall_s": wall,
                "queries_per_s": st.queries_per_s,
                "refreshes": st.refreshes, "last_drift": st.last_drift,
                "min_quality_est": st.min_quality_est, "launches": counts,
                "drift_worst_excess_over_limit": worst,
                "warm_slots_on_refreshing_waves": sum(
                    w.occupied - w.cold for w in srv.wave_log
                    if w.refreshed),
                "controller_replay_exact": True})
    del srv, store
    torch.cuda.empty_cache()
    return rows + out, counts


def snapshot_hash(snap, specs) -> str:
    """A digest of a snapshot's graph buffers, baselines and the layouts of
    ``specs``."""
    import hashlib

    h = hashlib.sha256()
    tensors = [t for t in snap.state if t is not None]
    tensors += [snap.deg, snap.active]
    for layout in map(snap.layouts.__getitem__, specs):
        tensors += [layout.src, layout.dst, layout.weight, layout.valid,
                    layout.row_offsets]
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def count_syncs(fn):
    """Run ``fn()`` with CUDA's sync debug mode on; returns (its result,
    the file:line of each synchronizing call it made)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def async_path(stream, dev) -> tuple:
    """PageRank, SSSP and CC with ``async_rebuild=True`` on the card (and
    PageRank with quality_target=0.95 too), each against a synchronous
    oracle session fed each epoch's batches just before its first query
    that serves the epoch, under the same forced actions: answers bitwise,
    fallbacks and refreshes equal, epochs monotone with lag 0 or 1, a
    served snapshot's buffers unchanged across the next build, and an
    add-only integrate making no host sync.  A last PageRank run holds
    each build back behind a sleep on the build stream, and must find a
    build still running at a promotion.  Per query: the answer's and the
    call's ms, async and sync, the build's device ms (its events on the
    build stream) and whether it still ran when the call returned and when
    the next query promoted it.  Returns (rows, launch counts)."""
    import repro_torch
    from repro_torch.core import backend as B
    from repro_torch.core.algorithm import Action

    act = {"A": Action.APPROXIMATE, "E": Action.EXACT,
           "R": Action.REPEAT_LAST}
    # one repeat-last query past the script promotes the last build
    actions = [act[c] for c in ASYNC_ACTIONS] + [Action.REPEAT_LAST]
    chunks = [c for _, c in zip(ASYNC_ACTIONS, stream)]
    removal = (stream.init_src[:200], stream.init_dst[:200])
    out, totals = [], {}
    runs = [r + (False,) for r in ASYNC_RUNS] + [("pagerank", {}, {}, True)]
    for name, kw, extra, slow in runs:
        reset_launch_counts()
        B.reset_trace_counts()
        t0 = time.perf_counter()
        sa = repro_torch.session(stream, name, async_rebuild=True,
                                 on_query=lambda q, v: actions[q], **kw,
                                 **extra)
        eng = sa.engine
        pipe = eng._pipeline
        integrate, finalize = eng._async_integrate, eng._finalize_promotion
        syncs, waited = [], {}

        def counted():
            if slow:
                with torch.cuda.stream(eng._build_stream):
                    torch.cuda._sleep(SLOW_BUILD_CYCLES)
            t = time.perf_counter()
            result, sites = count_syncs(integrate)
            syncs.append((sites, (time.perf_counter() - t) * 1e3))
            return result

        def promoting(snap):
            # whether the build was still running when promotion began
            waited[snap.epoch] = not snap.events[1].query()
            return finalize(snap)

        eng._async_integrate = counted
        eng._finalize_promotion = promoting
        rows, batches, builds, latest = [], {}, [], 0
        held, hash_checks = None, 0
        for q, (s, d) in enumerate(chunks):
            batch = [("add", s, d)]
            eng.register_add_edges(s, d)
            if q == ASYNC_REMOVE_AT:
                eng.register_remove_edges(*removal)
                batch.append(("rm",) + removal)
            n_syncs = len(syncs)
            t = time.perf_counter()
            scores, st = eng.query()
            call_ms = (time.perf_counter() - t) * 1e3
            building = pipe.building
            running = (building is not None
                       and not building.events[1].query())
            served = latest
            dispatched = building is not None and building.epoch > latest
            if dispatched:
                latest = building.epoch
                batches[latest] = batch
            builds.append(building if dispatched else None)
            if st.epoch != served or st.snapshot_lag not in (0, 1):
                raise AssertionError(f"{name} query {q}: epoch {st.epoch} "
                                     f"lag {st.snapshot_lag}, expected "
                                     f"{served}")
            if held is not None and held[0] is not pipe.current:
                # the build that ran while this snapshot was served is
                # promoted (and waited for): its buffers are unchanged
                if snapshot_hash(*held[:2]) != held[2]:
                    raise AssertionError(f"{name}: snapshot {held[0].epoch} "
                                         f"changed under a build")
                held, hash_checks = None, hash_checks + 1
            if held is None and hash_checks < 2 and dispatched:
                specs = tuple(pipe.current.layouts)
                held = (pipe.current, specs,
                        snapshot_hash(pipe.current, specs))
            rows.append({"phase": "async", "algorithm": name,
                         "quality_target": extra.get("quality_target"),
                         "query": q, "action": st.action, "epoch": st.epoch,
                         "snapshot_lag": st.snapshot_lag,
                         "refreshed": st.refreshed,
                         "overflow_fallback": st.overflow_fallback,
                         "slow_build": slow,
                         "async_answer_ms": st.wall_time_s * 1e3,
                         "async_call_ms": call_ms,
                         "build_running_at_return": running,
                         "integrate_host_ms": (syncs[-1][1]
                                               if len(syncs) > n_syncs
                                               else None),
                         "host_syncs_in_integrate": (
                             syncs[-1][0] if len(syncs) > n_syncs else None),
                         "scores": scores})
            if (q != ASYNC_REMOVE_AT and len(syncs) > n_syncs
                    and syncs[-1][0]):
                raise AssertionError(f"{name} query {q}: the add-only "
                                     f"integrate made host syncs at "
                                     f"{syncs[-1][0]}")
        eng.query()  # promote the last build (its events are done after)
        wall = time.perf_counter() - t0
        counts, pushes = launch_counts(), B.trace_count("push")
        if sum(counts.values()) != pushes:
            raise AssertionError(f"{name}: {counts} launches for {pushes} "
                                 f"pushes")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if hash_checks < 2:
            raise AssertionError(f"{name}: {hash_checks} snapshot checks")
        for row, snap in zip(rows, builds):
            row["build_events_ms"] = (
                None if snap is None
                else snap.events[0].elapsed_time(snap.events[1]))
            row["build_running_at_promotion"] = (
                None if snap is None else waited[snap.epoch])
        if slow and not any(waited.values()):
            raise AssertionError("no build was still running at its "
                                 "promotion, under a build stream held back")
        del sa, eng, pipe, builds, held
        torch.cuda.empty_cache()

        # the synchronous oracle, fed at the served epochs
        so = repro_torch.session(stream, name, on_query=lambda q, v:
                                 actions[q], **kw, **extra)
        fed = 0
        for q, row in enumerate(rows):
            while fed < row["epoch"]:
                fed += 1
                for kind, a, b in batches[fed]:
                    (so.engine.register_add_edges if kind == "add" else
                     so.engine.register_remove_edges)(a, b)
            t = time.perf_counter()
            ref, rst = so.engine.query()
            row["sync_call_ms"] = (time.perf_counter() - t) * 1e3
            scores = row.pop("scores")
            if not np.array_equal(scores.view(np.uint8), ref.view(np.uint8)):
                raise AssertionError(f"{name} query {q}: the async answer "
                                     f"differs from the synchronous oracle")
            if (row["overflow_fallback"], row["refreshed"]) != (
                    rst.overflow_fallback, rst.refreshed):
                raise AssertionError(f"{name} query {q}: fallback or "
                                     f"refresh differs from the oracle")
            row["sync_answer_ms"] = rst.wall_time_s * 1e3
            row["bitwise_vs_sync_oracle"] = True
        del so
        torch.cuda.empty_cache()
        out += rows
        out.append({"phase": "async-total", "algorithm": name,
                    "quality_target": extra.get("quality_target"),
                    "slow_build": slow,
                    "builds_running_at_promotion": sum(waited.values()),
                    "queries": len(rows), "wall_s": wall,
                    "launches": counts, "pushes": pushes,
                    "epochs_built": latest,
                    "snapshot_unchanged_across_build": hash_checks,
                    "bitwise_vs_sync_oracle": True})
    return out, totals


def async_serving_path(stream, plan, dev) -> tuple:
    """The serving plan with ``async_rebuild=True`` on the card against a
    synchronous serving run fed each chunk one wave later: every wave
    serves the epoch of the chunks before it, and every ticket's answer,
    waves and flags are bitwise the oracle's.  Returns (rows, launch
    counts)."""
    rows, tickets, srv, counts, wall, _ = drive_serving(
        stream, plan, dev, async_rebuild=True)
    for w, row in enumerate(rows):
        if (row["epoch"], row["snapshot_lag"]) != (w, 1):
            raise AssertionError(f"async wave {w}: epoch {row['epoch']}, "
                                 f"lag {row['snapshot_lag']}")
    card = [(t.waves_run, t.converged, t.exact_fallback, t.result)
            for t in tickets]
    st = srv.stats
    del srv
    torch.cuda.empty_cache()
    _, oracle, _, _, sync_wall, _ = drive_serving(stream, plan, dev, lag=1)
    for (waves, conv, fb, res), t in zip(card, oracle):
        if (waves, conv, fb) != (t.waves_run, t.converged,
                                 t.exact_fallback) or not np.array_equal(
                res.view(np.uint8), t.result.view(np.uint8)):
            raise AssertionError(f"ticket {t.ticket_id} ({t.algorithm}): "
                                 f"the async answer differs from the "
                                 f"synchronous run one wave later")
    for row in rows:
        row["phase"] = "async-serving-wave"
    return rows + [{"phase": "async-serving-total", "queries": len(tickets),
                    "waves": st.waves, "wall_s": wall,
                    "sync_oracle_wall_s": sync_wall,
                    "queries_per_s": st.queries_per_s,
                    "p50_wave_latency_s": st.p50_wave_latency_s,
                    "launches": counts,
                    "tickets_bitwise_vs_sync_one_wave_later": True}], counts


# ---- the sharded engine: S edge shards on a 1-rank mesh ------------------
SHARDS = 8                  # edge shards of the sharded phase
SHARDED_SEED = SEED + 28    # its own draws, so later phases keep theirs
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)  # f32 sums: summation order only


def one_rank_mesh(dev):
    """A 1-rank NCCL process group from an in-process store (no network)
    and its 1-D mesh; the caller destroys the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))


def drive_sharded(stream, name, kw, queries, every, dev, **overrides):
    """One session through its front door (``overrides`` go to it, the
    mesh knobs among them) with ``periodic_exact(every)``: for the initial
    exact query and each of ``queries`` after it, its stats, its pushes
    (sharded pushes and the single pushes of their shards), its kernel
    launches and the allocator's peak over its start.  Returns (session,
    rows, host results)."""
    import repro_torch
    from repro_torch.core import backend as B
    from repro_torch.core.policies import periodic_exact

    def counters():
        return (launch_counts(), B.trace_count("push"),
                B.trace_count("push[sharded]"),
                torch.cuda.memory_allocated())

    rows, results = [], []
    before = counters()
    torch.cuda.reset_peak_memory_stats()
    sess = repro_torch.session(stream, name, device=dev,
                               on_query=periodic_exact(every), **kw,
                               **overrides)
    plays = sess.play()
    for q in range(-1, queries):
        if q >= 0:
            before = counters()
            torch.cuda.reset_peak_memory_stats()
            res = next(plays)
            st, scores = res.stats, res.scores
        else:
            st, scores = sess.stats_log[0], sess.scores
        c0, p0, s0, base = before
        c1 = launch_counts()
        rows.append({
            "query": st.query_id, "action": st.action,
            "num_hot": st.num_hot, "num_ek": st.num_ek, "num_eb": st.num_eb,
            "iterations": st.iterations, "overflow": st.overflow_fallback,
            "rebalanced": st.rebalanced, "epoch": st.epoch,
            "last_imbalance": sess.engine.last_imbalance,
            "wall_ms": st.wall_time_s * 1e3,
            "sharded_pushes": B.trace_count("push[sharded]") - s0,
            "shard_pushes": B.trace_count("push") - p0,
            "launches": sum(c1[k] - c0[k] for k in KERNEL_NAMES),
            "peak_over_start_bytes": torch.cuda.max_memory_allocated()
            - base})
        results.append(scores)
    return sess, rows, results


def check_sharded_pushes(tag, rows, per_iter=1, held=SHARDS) -> int:
    """Every query of a sharded session: its sweeps' pushes (iterations,
    plus the ``b_in`` pass of an approximate query, ``per_iter`` of each)
    all sharded, each ``held`` shard pushes (the shards this rank holds)
    and as many launches.  Returns the sharded pushes."""
    total = 0
    for r in rows:
        want = per_iter * (r["iterations"]
                           + (r["action"] == "compute-approximate"))
        if (r["sharded_pushes"], r["shard_pushes"], r["launches"]) != (
                want, held * want, held * want):
            raise AssertionError(f"{tag} query {r['query']}: "
                                 f"{r['sharded_pushes']} sharded pushes, "
                                 f"{r['shard_pushes']} shard pushes, "
                                 f"{r['launches']} launches; {want} sharded "
                                 f"pushes wanted, {held} launches each")
        total += want
    return total


def sharded_push_times(sess, flat_sess, dev, rng) -> dict:
    """One full-graph PageRank push through the sharded layout (``SHARDS``
    launches and ⊕ merges; eager with the all-reduce, and its kernels and
    merges from a CUDA graph) beside the unsharded layout's one launch,
    with both bounds."""
    from repro_torch.core import backend as B

    lay = sess.engine.edge_layouts()[0]
    flat = flat_sess.engine.edge_layouts()[0]
    n = flat.num_segments
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    views = [B._shard_view(lay, i) for i in range(lay.num_shards)]

    def kernels_and_merges():
        part = B.push(v, views[0])
        for view in views[1:]:
            part = part + B.push(v, view)
        return part

    torch.testing.assert_close(B.push(v, lay), B.push(v, flat), **SHARD_TOL)
    sharded_bound = sum(max(push_bound(
        int(view.row_offsets[-1]), n, n, 1, False, view.weight)[1:])
        for view in views)
    flat_bound = max(push_bound(int(flat.row_offsets[-1]), n, n, 1, False,
                                flat.weight)[1:])
    return {"phase": "sharded-push-time", "shards": lay.num_shards,
            "launches_per_push": len(views),
            "shard_edges": [int(x.row_offsets[-1]) for x in views],
            "sharded_eager_ms": cuda_ms(lambda: B.push(v, lay)),
            "sharded_device_ms": graph_ms(kernels_and_merges),
            "sharded_bound_ms": sharded_bound,
            "unsharded_eager_ms": cuda_ms(lambda: B.push(v, flat)),
            "unsharded_device_ms": graph_ms(lambda: B.push(v, flat)),
            "unsharded_bound_ms": flat_bound,
            "timing": "eager: 20 calls back to back with their host cost "
                      "(the sharded one with its NCCL all-reduce); device: "
                      "20 calls replayed from one CUDA graph (the sharded "
                      "one's shard launches and merges, no all-reduce)",
            "bound": "sum over the shards of each launch's bound: every "
                     "shard reads the whole row_offsets and writes every "
                     "row"}


def shard_kernel_checks(sess, sssp_sess, dev, rng) -> tuple:
    """The four SpMV kernels against their plain versions on shard 0 of
    the sharded layouts the phase pushes through (PageRank's inv_out and
    SSSP's min_plus, 1/S of the edges over every row)."""
    from repro_torch.core import backend as B

    view = B._shard_view(sess.engine.edge_layouts()[0], 0)
    rview = B._shard_view(sssp_sess.engine.edge_layouts()[0], 0)
    n = view.num_segments
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    vb = torch.from_numpy(rng.random((BATCH, n)).astype(np.float32)).to(dev)
    d = (10 * rng.random((BATCH, n))).astype(np.float32)
    d[rng.random((BATCH, n)) < 0.1] = np.inf
    d = torch.from_numpy(d).to(dev)
    tag = f"synth-web-lg shard 0 of {SHARDS}"
    return ([check_kernel(f"{tag}, inv_out", v, view)],
            [check_reduce_kernel(f"{tag}, min_plus", d[0].contiguous(),
                                 rview)],
            [check_batched_kernel(f"{tag}, inv_out", vb, view),
             check_batched_reduce_kernel(f"{tag}, min_plus", d, rview)])


def exact_replays(stream, dev):
    """``at(q)``: the f64 exact PageRank (``exact_reference``) of the graph
    query q of the stream is served on, and its active mask, from a
    session that repeats its answers and so only applies the chunks;
    built at the first call, stepped forward only."""
    import repro_torch

    box = {}

    def at(q):
        if "plays" not in box:
            box["sess"] = repro_torch.session(
                stream, "pagerank", device=dev,
                on_query=lambda qid, view: repro_torch.Action.REPEAT_LAST)
            box["plays"], box["q"] = box["sess"].play(), -1
        while box["q"] < q:
            next(box["plays"])
            box["q"] += 1
        st = box["sess"].engine.state
        return (exact_reference(st).cpu().numpy(),
                st.node_active.cpu().numpy())
    return at


def compare_pagerank(flat_rows, flat_res, rows, res, exact_at) -> list:
    """Per query of the two PageRank sessions: the hot set and E_K sizes
    of both; ranks within ``SHARD_TOL`` where they agree (the exact query
    too), and where they differ both answers' RBO@4000 against an f64
    exact replay (``exact_at``) at ``RBO_FLOOR`` or above."""
    from repro_torch.metrics import rbo_from_scores

    out = []
    for a, b, x, y in zip(flat_rows, rows, flat_res, res):
        same = (a["num_hot"], a["num_ek"]) == (b["num_hot"], b["num_ek"])
        row = {"query": b["query"], "action": b["action"],
               "num_hot": [a["num_hot"], b["num_hot"]],
               "num_ek": [a["num_ek"], b["num_ek"]],
               "sizes_agree": same,
               "max_rel_diff": float(np.max(np.abs(y - x)
                                            / np.maximum(np.abs(x), 1e-30)))}
        if b["action"] != "compute-approximate":
            # the f64 replay of an exact sweep (30 iterations from ones)
            exact = exact_at(b["query"])
            row["max_rel_vs_f64"] = [max_rel(torch.from_numpy(z),
                                             torch.from_numpy(exact[0]))
                                     for z in (x, y)]
        if same or b["action"] != "compute-approximate":
            np.testing.assert_allclose(y, x, err_msg=f"query {b['query']}",
                                       **SHARD_TOL)
        else:
            exact = exact_at(b["query"])
            row["rbo_vs_exact"] = [rbo_from_scores(
                z.astype(np.float64), exact[0], depth=RBO_DEPTH,
                active=exact[1]) for z in (x, y)]
            if min(row["rbo_vs_exact"]) < RBO_FLOOR:
                raise AssertionError(f"sharded PageRank query {b['query']}: "
                                     f"RBO {row['rbo_vs_exact']} under "
                                     f"{RBO_FLOOR}")
        out.append(row)
    return out


def sharded_path(stream, plan, dev, rng) -> tuple:
    """The sharded engine on a 1-rank NCCL mesh at ``SHARDS`` shards: the
    main path's PageRank stream, SSSP and CC (the traversal settings), a
    forced-imbalance SSSP stream and one serving wave, each against an
    unsharded session on the same card (min/max bitwise, sums at
    ``SHARD_TOL``), then the push's device time sharded and not, and the
    kernels on a shard.  The unsharded runs come first; the launch counts
    are set to 0 before the sharded ones.  Last, in the same group, the
    dry run's 2-D mesh sessions (:func:`nd_mesh_runs`).  Returns (rows,
    launch counts, (sum, reduce, batched) kernel-check rows, (the 2-D mesh
    rows, their launch counts), the unsharded runs and the wave's plan for
    :func:`mesh_ranks_path`)."""
    import repro_torch
    import torch.distributed as dist

    from repro_torch.core import backend as B
    from repro_torch.graph.partition import shard_live_counts

    t0 = time.perf_counter()
    sssp_kw = dict(TRAVERSAL)["sssp"]
    wave_plan = ([p for p in plan if p[0] == "personalized-pagerank"][:2]
                 + [p for p in plan if p[0] == "sssp"][:2])
    # the unsharded runs on the card
    flat, flat_rows, flat_res = drive_sharded(stream, "pagerank", {},
                                              QUERIES, QUERIES - 1, dev)
    trav = {}
    for name in ("sssp", "connected-components"):
        trav[name] = drive_sharded(stream, name, dict(TRAVERSAL)[name],
                                   TRAVERSAL_QUERIES, TRAVERSAL_EXACT_EVERY,
                                   dev, r=TRAVERSAL_R)[1:]
    with repro_torch.serve_session(stream, slots=BATCH, device=dev) as srv:
        for name, kw in wave_plan:
            srv.submit(name, **kw)
        srv.step()
        flat_wave = ({lane.template.name: {k: v.clone() for k, v
                                           in lane.bank.items()}
                      for lane in srv._lanes.values()}, list(srv.wave_log))
    torch.cuda.empty_cache()

    # the f64 replay's session makes its exact sweep before the counts are
    # reset; its later steps only apply chunks
    exact_at = exact_replays(stream, dev)
    exact_at(-1)
    mesh = one_rank_mesh(dev)
    out = []
    try:
        reset_launch_counts()
        B.reset_trace_counts()
        t1 = time.perf_counter()
        shard = dict(mesh=mesh, num_shards=SHARDS)
        # ---- PageRank: the main path's stream ---------------------------
        sess, rows, res = drive_sharded(stream, "pagerank", {}, QUERIES,
                                        QUERIES - 1, dev, **shard)
        pagerank_1d = (rows, res)
        pushes = check_sharded_pushes("PageRank", rows)
        c0 = launch_counts()
        cmp = compare_pagerank(flat_rows, flat_res, rows, res, exact_at)
        replay = {k: launch_counts()[k] - c0[k] for k in KERNEL_NAMES}
        out.append({"phase": "sharded", "algorithm": "pagerank",
                    "queries": rows, "against_unsharded": cmp,
                    "sizes_differ": sum(not r["sizes_agree"] for r in cmp),
                    "sharded_pushes": pushes,
                    "rebalances": sess.engine.rebalances,
                    "summary_peak_over_start_bytes": max(
                        r["peak_over_start_bytes"] for r in rows
                        if r["action"] == "compute-approximate")})
        # ---- SSSP and CC, bitwise ----------------------------------------
        sessions = {"pagerank": sess}
        for name, per_iter in (("sssp", 1), ("connected-components", 2)):
            s, rows, res = drive_sharded(stream, name, dict(TRAVERSAL)[name],
                                         TRAVERSAL_QUERIES,
                                         TRAVERSAL_EXACT_EVERY, dev,
                                         r=TRAVERSAL_R, **shard)
            want_rows, want_res = trav[name]
            for a, b, x, y in zip(want_rows, rows, want_res, res):
                if (a["num_hot"], a["num_ek"], a["iterations"]) != (
                        b["num_hot"], b["num_ek"], b["iterations"]) or \
                        not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                    raise AssertionError(f"sharded {name} query {b['query']}"
                                         f" differs from the unsharded one")
            out.append({"phase": "sharded", "algorithm": name,
                        "queries": rows, "bitwise_vs_unsharded": True,
                        "sharded_pushes": check_sharded_pushes(
                            name, rows, per_iter),
                        "rebalances": s.engine.rebalances})
            sessions[name] = s
        # ---- forced imbalance: every live slot in the head shards --------
        edges = stream.init_src.shape[0] + sum(c[0].shape[0]
                                               for c in stream)
        s, rows, res = drive_sharded(stream, "sssp", sssp_kw,
                                     TRAVERSAL_QUERIES, TRAVERSAL_EXACT_EVERY,
                                     dev, r=TRAVERSAL_R,
                                     edge_capacity=2 * edges, **shard)
        want_rows, want_res = trav["sssp"]
        for x, y in zip(want_res, res):
            if not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                raise AssertionError("forced-imbalance SSSP differs from the "
                                     "unsharded session")
        counts = shard_live_counts(s.engine.state,
                                   s.engine._shard_slots).cpu().numpy()
        # the first applied chunk (query 0, after the initial exact row)
        if s.engine.rebalances != 1 or [r["rebalanced"] for r in rows] != [
                False, True] + [False] * (len(rows) - 2):
            raise AssertionError(f"forced imbalance: {s.engine.rebalances} "
                                 f"rebalances, {[r['rebalanced'] for r in rows]}")
        if counts.max() - counts.min() > 1:
            raise AssertionError(f"rebalanced live counts {counts.tolist()}")
        out.append({"phase": "sharded-rebalance", "algorithm": "sssp",
                    "edge_capacity": 2 * edges, "queries": rows,
                    "rebalances": s.engine.rebalances,
                    "live_counts_after": counts.tolist(),
                    "bitwise_vs_unsharded": True,
                    "sharded_pushes": check_sharded_pushes("rebalance", rows)})
        del s
        # ---- one serving wave on the mesh engine -------------------------
        with repro_torch.serve_session(stream, slots=BATCH, device=dev,
                                       **shard) as srv:
            for name, kw in wave_plan:
                srv.submit(name, **kw)
            c0, b0 = launch_counts(), B.trace_count("push[sharded]")
            srv.step()
            made = {k: launch_counts()[k] - c0[k] for k in KERNEL_NAMES}
            waves = list(srv.wave_log)
            banks = {lane.template.name: lane.bank
                     for lane in srv._lanes.values()}
        sharded_wave_pushes = B.trace_count("push[sharded]") - b0
        want_banks, want_log = flat_wave
        for a, b in zip(want_log, waves):
            if (a.algorithm, a.num_hot, a.num_ek, a.iterations) != (
                    b.algorithm, b.num_hot, b.num_ek, b.iterations):
                raise AssertionError(f"serving wave lane {b.algorithm}: "
                                     f"{b} against {a}")
        for name, bank in banks.items():
            for k, t in bank.items():
                if name == "sssp":
                    if not same_bits(t, want_banks[name][k]):
                        raise AssertionError(f"serving wave {name}.{k} "
                                             f"differs")
                else:
                    torch.testing.assert_close(t, want_banks[name][k],
                                               **SHARD_TOL)
        batched = made["spmv_push_batched"] + made["spmv_reduce_push_batched"]
        if batched != SHARDS * sharded_wave_pushes or any(
                made[k] for k in ("spmv_push", "spmv_reduce_push")):
            raise AssertionError(f"serving wave: {made} launches for "
                                 f"{sharded_wave_pushes} sharded pushes")
        out.append({"phase": "sharded-serving-wave",
                    "lanes": [{"lane": w.algorithm, "num_hot": w.num_hot,
                               "num_ek": w.num_ek,
                               "iterations": w.iterations} for w in waves],
                    "sharded_pushes": sharded_wave_pushes, "launches": made,
                    "ppr_within_tol_sssp_bitwise": True})
        # the phase's launches, less any of the replay's: S a sharded push
        counts = {k: launch_counts()[k] - replay[k] for k in KERNEL_NAMES}
        phase_pushes = B.trace_count("push[sharded]")
        if sum(counts.values()) != SHARDS * phase_pushes:
            raise AssertionError(f"sharded phase: {counts} launches for "
                                 f"{phase_pushes} sharded pushes")
        drive_s = time.perf_counter() - t1
        # ---- the push's time and the kernels on a shard ------------------
        out.append(sharded_push_times(sess, flat, dev, rng))
        checks = shard_kernel_checks(sess, sessions["sssp"], dev, rng)
        out.append({"phase": "sharded-total", "shards": SHARDS,
                    "mesh": "1-rank NCCL", "launches": counts,
                    "sharded_pushes": phase_pushes,
                    "replay_launches_left_out": replay,
                    "sharded_runs_s": drive_s,
                    "wall_s": time.perf_counter() - t0})
        del sessions
        nd = nd_mesh_runs(stream, dev, {"flat": (flat_rows, flat_res),
                                        "trav": trav,
                                        "pagerank_1d": pagerank_1d})
    finally:
        dist.destroy_process_group()
    del sess, flat
    torch.cuda.empty_cache()
    refs = {"flat": (flat_rows, flat_res), "trav": trav, "wave": flat_wave,
            "wave_plan": wave_plan}
    return out, counts, checks, nd, refs

# ---- the mesh engine on four ranks of the one card -----------------------
MESH_RANKS = 4              # gloo ranks, each with its own CUDA context
MESH_TIMEOUT_S = 120        # a rank's collective waits at most this long
MESH_JOIN_S = 600           # every rank must have finished by then
ASYNC_MESH_QUERIES = 6      # queries of the async PageRank stream


@contextlib.contextmanager
def counted_collectives():
    """Count the engine's collectives in this process: every
    ``torch.distributed.all_reduce`` (the semiring's merge and the
    summary's counters) and ``all_to_all_single`` (the summary's bucket
    exchange) made inside the block."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_to_all": 0}
    all_reduce, all_to_all = dist.all_reduce, dist.all_to_all_single

    def counted_all_reduce(*args, **kwargs):
        counts["all_reduce"] += 1
        return all_reduce(*args, **kwargs)

    def counted_all_to_all(*args, **kwargs):
        counts["all_to_all"] += 1
        return all_to_all(*args, **kwargs)
    dist.all_reduce, dist.all_to_all_single = (counted_all_reduce,
                                               counted_all_to_all)
    try:
        yield counts
    finally:
        dist.all_reduce, dist.all_to_all_single = all_reduce, all_to_all


def mesh_scenarios(stream, wave_plan, shard, dev) -> dict:
    """The runs of one mesh rank, in order: name -> a function of no
    arguments returning (rows, answers, extra): the sharded phase's
    PageRank, SSSP, CC and forced-imbalance SSSP streams, an async
    PageRank stream and one serving wave."""
    import repro_torch
    from repro_torch.graph.partition import shard_live_counts

    edges = stream.init_src.shape[0] + sum(c[0].shape[0] for c in stream)

    def session(name, kw, queries, every, extra=None, **over):
        def go():
            sess, rows, res = drive_sharded(stream, name, kw, queries, every,
                                            dev, **over, **shard)
            eng = sess.engine
            out = {"rebalances": eng.rebalances}
            if extra is not None:
                out.update(extra(eng))
            return rows, res, out
        return go

    def live_counts(eng):
        return {"live_counts_after": shard_live_counts(
            eng.state, eng._shard_slots).cpu().numpy().tolist()}

    def wave():
        with repro_torch.serve_session(stream, slots=BATCH, device=dev,
                                       **shard) as srv:
            for name, kw in wave_plan:
                srv.submit(name, **kw)
            srv.step()
            log = [(w.algorithm, w.num_hot, w.num_ek, w.iterations)
                   for w in srv.wave_log]
            banks = {lane.template.name: {k: v.cpu().numpy() for k, v
                                          in lane.bank.items()}
                     for lane in srv._lanes.values()}
        return log, banks, {}

    trav = lambda name, **over: session(
        name, dict(TRAVERSAL)[name], TRAVERSAL_QUERIES,
        TRAVERSAL_EXACT_EVERY, r=TRAVERSAL_R, **over)
    return {"pagerank": session("pagerank", {}, QUERIES, QUERIES - 1),
            "sssp": trav("sssp"),
            "connected-components": trav("connected-components"),
            "sssp-imbalance": session(
                "sssp", dict(TRAVERSAL)["sssp"], TRAVERSAL_QUERIES,
                TRAVERSAL_EXACT_EVERY, live_counts, r=TRAVERSAL_R,
                edge_capacity=2 * edges),
            "pagerank-async": session("pagerank", {}, ASYNC_MESH_QUERIES,
                                      QUERIES - 1, async_rebuild=True),
            "serving-wave": wave}


def mesh_rank(rank: int, init: str, stream_path: str, wave_plan,
              out: str) -> None:
    """One rank of the mesh phase: loads the pickled stream, joins a gloo
    group of ``MESH_RANKS`` (CUDA tensors are staged through the host by
    gloo; NCCL refuses two ranks on one device), builds the 1-D
    ``("shards",)`` mesh and runs
    :func:`mesh_scenarios` at ``SHARDS`` shards, two a rank, on the card's
    device 0, each with its launches, pushes and collectives counted from
    0; pickles the answers and counts to ``{out}.{rank}``.  It loads the
    kernels the parent built (a build here fails the phase) and imports no
    JAX."""
    from datetime import timedelta

    stamps = {"enter": time.time()}
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import backend as B
    from repro_torch.kernels.build import EVENTS

    with open(stream_path, "rb") as f:
        stream = pickle.load(f)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=MESH_RANKS,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (MESH_RANKS,),
                                mesh_dim_names=("shards",))
        stamps["mesh"] = time.time()
        res = {}
        for name, run in mesh_scenarios(
                stream, wave_plan, dict(mesh=mesh, num_shards=SHARDS),
                dev).items():
            reset_launch_counts()
            B.reset_trace_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with counted_collectives() as coll:
                rows, answers, extra = run()
            res[name] = {
                "rows": rows, "answers": answers, **extra,
                "launches": launch_counts(),
                "sharded_pushes": B.trace_count("push[sharded]"),
                "shard_pushes": B.trace_count("push"),
                "all_reduces": coll["all_reduce"],
                "all_to_alls": coll["all_to_all"],
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "wall_s": time.perf_counter() - t0}
        res["builds"] = sorted(k for k in EVENTS if k.startswith("build:"))
        res["jax_imported"] = "jax" in sys.modules
        stamps["runs"] = time.time()
        res["stamps"] = stamps
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh_ranks(stream, wave_plan) -> list:
    """Start ``MESH_RANKS`` ranks of :func:`mesh_rank` (spawned, a
    ``file://`` store in a temporary directory, no network) and return
    their pickled results in rank order.  The stream goes to them as a
    file: passed as an argument, it would be written through each child's
    pipe while the child starts, one child at a time.  A rank that raises
    fails the phase; ranks still running after ``MESH_JOIN_S`` are
    terminated and fail it too."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/stream.pkl", "wb") as f:
            pickle.dump(stream, f)
        spawned = time.time()
        ctx = mp.start_processes(
            mesh_rank, args=(f"file://{d}/store", f"{d}/stream.pkl",
                             wave_plan, f"{d}/rank"),
            nprocs=MESH_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh ranks still running after "
                                       f"{MESH_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        joined = time.time()
        got = []
        for rank in range(MESH_RANKS):
            with open(f"{d}/rank.{rank}", "rb") as f:
                got.append(pickle.load(f))
    for res in got:
        # seconds since the spawn: in the rank's function, its mesh built,
        # its runs done; and the spawn's end (the ranks' exits joined)
        res["stamps"] = {k: v - spawned for k, v in
                         dict(res["stamps"], joined=joined).items()}
    return got


def same_answers(a, b) -> bool:
    """Two ranks' answers equal, arrays bit for bit, at every level."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_answers(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_answers, a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype, a.shape) == (b.dtype, b.shape) and \
            a.tobytes() == b.tobytes()
    return a == b


#: the per-query fields every rank must report alike (its wall time and
#: peak memory are its own)
RANK_FIELDS = ("query", "action", "num_hot", "num_ek", "num_eb",
               "iterations", "overflow", "rebalanced", "last_imbalance",
               "sharded_pushes", "shard_pushes", "launches")


def check_mesh_ranks(got, refs, exact_at, async_exact_at) -> tuple:
    """Hold the mesh ranks' results: each rank's answers and stats those
    of every other rank, and rank 0's those of the unsharded runs on the
    same card (min/max bitwise, sums at ``SHARD_TOL``, PageRank through
    :func:`compare_pagerank`); the forced-imbalance stream's one recut;
    each rank's launches ``SHARDS / MESH_RANKS`` a sharded push, and no
    build in any rank.  Returns (one row per rank and scenario, the
    comparisons, the launches summed over the ranks)."""
    held = SHARDS // MESH_RANKS
    first = got[0]
    for rank, res in enumerate(got):
        if res["builds"] or res["jax_imported"]:
            raise AssertionError(f"mesh rank {rank}: builds {res['builds']}"
                                 f", JAX imported {res['jax_imported']}")
        for name, one in res.items():
            if not isinstance(one, dict) or name == "stamps":
                continue
            mine = [{k: r[k] for k in RANK_FIELDS if k in r}
                    if isinstance(r, dict) else r for r in one["rows"]]
            theirs = [{k: r[k] for k in RANK_FIELDS if k in r}
                      if isinstance(r, dict) else r
                      for r in first[name]["rows"]]
            if not (same_answers(one["answers"], first[name]["answers"])
                    and mine == theirs):
                raise AssertionError(f"mesh rank {rank} {name}: answers or "
                                     f"stats differ from rank 0's")
            # every push sharded (the serve session's initial exact sweeps
            # single, its wave batched), each a launch a shard held
            made = one["launches"]
            launches = sum(made[k] for k in KERNEL_NAMES[:4])
            if launches != held * one["sharded_pushes"] or \
                    one["shard_pushes"] != held * one["sharded_pushes"] or \
                    sum(made.values()) != launches:
                raise AssertionError(
                    f"mesh rank {rank} {name}: {made} launches and "
                    f"{one['shard_pushes']} shard pushes for "
                    f"{one['sharded_pushes']} sharded pushes, {held} a rank")
            if name in ("pagerank", "sssp", "connected-components",
                        "sssp-imbalance"):
                per_iter = 2 if name == "connected-components" else 1
                check_sharded_pushes(f"mesh rank {rank} {name}", one["rows"],
                                     per_iter, held)
    cmp = {}
    flat_rows, flat_res = refs["flat"]
    one = first["pagerank"]
    cmp["pagerank"] = compare_pagerank(flat_rows, flat_res, one["rows"],
                                       one["answers"], exact_at)
    for name in ("sssp", "connected-components", "sssp-imbalance"):
        want_rows, want_res = refs["trav"][name.replace("-imbalance", "")]
        one = first[name]
        for a, b, x, y in zip(want_rows, one["rows"], want_res,
                              one["answers"]):
            if (a["num_hot"], a["num_ek"], a["iterations"]) != (
                    b["num_hot"], b["num_ek"], b["iterations"]) or \
                    not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                raise AssertionError(f"mesh {name} query {b['query']} "
                                     f"differs from the unsharded one")
        cmp[name] = "bitwise"
    one = first["sssp-imbalance"]
    counts = np.asarray(one["live_counts_after"])
    if one["rebalances"] != 1 or [r["rebalanced"] for r in one["rows"]] != [
            False, True] + [False] * (len(one["rows"]) - 2):
        raise AssertionError(f"mesh forced imbalance: {one['rebalances']} "
                             f"recuts, {[r['rebalanced'] for r in one['rows']]}")
    if counts.max() - counts.min() > 1:
        raise AssertionError(f"mesh recut live counts {counts.tolist()}")
    async_rows, async_res = refs["async"]
    one = first["pagerank-async"]
    if [r["epoch"] for r in one["rows"]] != [r["epoch"]
                                             for r in async_rows]:
        raise AssertionError("mesh async PageRank: epochs differ")
    cmp["pagerank-async"] = compare_pagerank(async_rows, async_res,
                                             one["rows"], one["answers"],
                                             async_exact_at)
    want_banks, want_log = refs["wave"]
    log, banks = first["serving-wave"]["rows"], first["serving-wave"]["answers"]
    if log != [(a.algorithm, a.num_hot, a.num_ek, a.iterations)
               for a in want_log]:
        raise AssertionError(f"mesh serving wave: lanes {log}")
    for lane, bank in banks.items():
        for k, t in bank.items():
            want = want_banks[lane][k].cpu().numpy()
            if lane == "sssp":
                if not np.array_equal(t.view(np.uint8), want.view(np.uint8)):
                    raise AssertionError(f"mesh serving wave {lane}.{k}")
            else:
                np.testing.assert_allclose(t, want, err_msg=lane, **SHARD_TOL)
    cmp["serving-wave"] = "ppr within SHARD_TOL, sssp bitwise"
    rows, total = [], dict.fromkeys(KERNEL_NAMES, 0)
    for rank, res in enumerate(got):
        rows.append({"phase": "mesh-ranks", "rank": rank,
                     "seconds_since_spawn": res["stamps"]})
        for name, one in res.items():
            if not isinstance(one, dict) or name == "stamps":
                continue
            per_query = [r for r in one["rows"] if isinstance(r, dict)]
            recut = [r["query"] for r in per_query if r["rebalanced"]]
            rows.append({
                "phase": "mesh-ranks", "rank": rank, "scenario": name,
                "query_wall_ms": [r["wall_ms"] for r in per_query],
                "recut_query": recut[0] if recut else None,
                "launches": {k: v for k, v in one["launches"].items() if v},
                "sharded_pushes": one["sharded_pushes"],
                "all_reduces": one["all_reduces"],
                "all_to_alls": one["all_to_alls"],
                "peak_bytes": one["peak_bytes"], "wall_s": one["wall_s"]})
            for k in KERNEL_NAMES:
                total[k] += one["launches"][k]
    return rows, cmp, total


def mesh_ranks_path(stream, refs, dev) -> tuple:
    """The mesh engine across ``MESH_RANKS`` ranks on the one card (gloo
    over CUDA tensors; each rank its own CUDA context on device 0) at
    ``SHARDS`` shards, two a rank: the sharded phase's streams (PageRank,
    SSSP, CC, the forced-imbalance SSSP stream and one serving wave) and
    an async PageRank stream, each rank's answers bitwise every other
    rank's and rank 0's held to the unsharded runs of
    :func:`sharded_path` and to an unsharded async run made here.  Returns
    (rows, the launches summed over the ranks)."""
    t0 = time.perf_counter()
    _, async_rows, async_res = drive_sharded(
        stream, "pagerank", {}, ASYNC_MESH_QUERIES, QUERIES - 1, dev,
        async_rebuild=True)
    refs = dict(refs, **{"async": (async_rows, async_res)})
    exact_at, async_exact = exact_replays(stream, dev), exact_replays(stream,
                                                                       dev)
    # the async query q serves the graph of the synchronous query q - 1
    async_exact_at = lambda q: async_exact(q - 1)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    got = spawn_mesh_ranks(stream, refs["wave_plan"])
    spawn_s = time.perf_counter() - t1
    rows, cmp, total = check_mesh_ranks(got, refs, exact_at, async_exact_at)
    rows.append({"phase": "mesh-ranks-total", "ranks": MESH_RANKS,
                 "shards": SHARDS, "mesh": f"{MESH_RANKS}-rank gloo, one "
                 f"card, CUDA tensors", "launches": total,
                 "against_unsharded": cmp,
                 "ranks_bitwise_alike": True, "rank_builds": 0,
                 "spawn_to_join_s": spawn_s,
                 "wall_s": time.perf_counter() - t0})
    return rows, total


# ---- the two examples on the card ------------------------------------------
EXAMPLE_QUERIES = 10


def examples_path() -> tuple:
    """``examples/streaming_pagerank_torch.py``'s ``run`` on synth-web-lg
    (``EXAMPLE_QUERIES`` queries: per query the paper's four metrics) and
    ``examples/quickstart_torch.py``'s ``main``, both at their default
    device, the card; each answer's metrics finite, RBO in [0, 1], every
    push a kernel launch.  Returns (rows, launch counts)."""
    import io

    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import quickstart_torch
    import streaming_pagerank_torch

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = streaming_pagerank_torch.run(dataset="synth-web-lg",
                                           queries=EXAMPLE_QUERIES,
                                           verbose=False)
    run_s = time.perf_counter() - t0
    out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        quickstart_torch.main()
    quick_s = time.perf_counter() - t1
    counts = launch_counts()
    quick = out.getvalue().splitlines()
    if len(metrics) != EXAMPLE_QUERIES or len(quick) != 11:
        raise AssertionError(f"examples: {len(metrics)} rows, quickstart "
                             f"printed {len(quick)} lines")
    for r in metrics:
        if not (0.0 <= r["rbo"] <= 1.0 and np.isfinite(r["vertex_ratio"])
                and np.isfinite(r["edge_ratio"]) and r["speedup"] > 0):
            raise AssertionError(f"streaming_pagerank_torch row {r}")
    if counts["spmv_push"] == 0 or sum(counts.values()) != counts[
            "spmv_push"]:
        raise AssertionError(f"examples launched {counts}")
    return [{"phase": "examples", "example": "streaming_pagerank_torch",
             "dataset": "synth-web-lg", "rows": metrics,
             "mean_rbo": float(np.mean([r["rbo"] for r in metrics])),
             "wall_s": run_s},
            {"phase": "examples", "example": "quickstart_torch",
             "printed": quick, "wall_s": quick_s},
            {"phase": "examples-total", "launches": counts,
             "wall_s": time.perf_counter() - t0}], counts


# ---- the LM serving path (Qwen2-0.5B) -----------------------------------
LM_ARCH = "qwen2_0_5b"
LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 16, 2048, 64, 4096
# served logits against a replay through the plain attention versions:
# max |diff| <= LM_LOGIT_TOL * max(max |logit|, 1), the bf16 tolerance of
# tests/test_arch_smoke.py
LM_LOGIT_TOL = 0.05
# The bf16 replay's bound, as a share of LM_LOGIT_TOL: max(1,
# LM_DRIFT_RATIO x the drift from the plain replay of a control, the plain
# versions at half the tiles, on the same prompts).  Two correct paths
# whose f32 sums differ in order only drift alike: kernels against plain
# 0.88 of the limit on Zamba2-7B (81 layers), plain against plain 0.89;
# MiniCPM3-4B 0.63 and 0.59 (tools/replay_drift.py, NVIDIA H100 80GB HBM3,
# 700 W).  A fault that moves an attention output beyond its rounding
# moves the logits by many times that.
LM_DRIFT_RATIO = 1.5
# The f32 replay (the kernels' f32 entries against the plain versions):
# 1% of LM_LOGIT_TOL.  Its readings are 1.2e-4 and 2.6e-4 of LM_LOGIT_TOL
# (Zamba2-7B, MiniCPM3-4B, same card); bf16 rounding inside a kernel would
# drift the logits as the bf16 paths above do, 0.5 to 1 of it.
LM_F32_LOGIT_TOL = 1e-2 * LM_LOGIT_TOL
# the attention checks: (tag, kind, shape); flash (B, S, H, KV, hd, vd,
# causal, window[, Skv]: S queries over Skv keys, S by default), decode
# (B, S, H, KV, hd, vd, cache_len)
ATTN_F32_TOL = 1e-5         # kernel in f32 vs the f64 plain version
# kernel in bf16 vs the f64 plain version on the same bf16 inputs: both
# widen the inputs exactly, so the only bf16 error is the output's
# round-to-nearest, at most 2^-8 = 3.9e-3 of its value, over the f32 sums'
# error (at most 1.2e-6 in the f32 rows): |err| <= ATOL + RTOL |ref|
ATTN_BF16_RTOL, ATTN_BF16_ATOL = 5e-3, 1e-5
# decode's cold timing rotates through this many copies of its inputs:
# 6 x 16.8 MB at the Qwen2 shape, past the H100's 50 MB L2
COLD_COPIES = 6
ATTENTION_CHECKS = (
    ("Qwen2-0.5B causal prefill, B=1, S=4096", "flash",
     (1, 4096, 14, 2, 64, 64, True, None)),
    ("served prefill, B=8, S=2048", "flash",
     (8, 2048, 14, 2, 64, 64, True, None)),
    ("window 512, B=2, S=4096", "flash",
     (2, 4096, 14, 2, 64, 64, True, 512)),
    ("S=3001 (not a tile multiple), B=1", "flash",
     (1, 3001, 14, 2, 64, 64, True, None)),
    ("Qwen2-0.5B decode, B=8, S=4096, cache_len=4096", "decode",
     (8, 4096, 14, 2, 64, 64, 4096)),
    ("Qwen2-0.5B decode, B=8, S=4096, cache_len=2100", "decode",
     (8, 4096, 14, 2, 64, 64, 2100)),
    ("Qwen2-0.5B decode, B=8, S=4096, cache_len=128", "decode",
     (8, 4096, 14, 2, 64, 64, 128)),
    # the MoE family's shapes: head dim 128, 48 query heads over 8 (G = 6)
    ("Mixtral-8x22B prefill past its window, B=1, S=6144, window 4096",
     "flash", (1, 6144, 48, 8, 128, 128, True, 4096)),
    ("DBRX-132B served prefill, B=4, S=2048", "flash",
     (4, 2048, 48, 8, 128, 128, True, None)),
    ("Mixtral-8x22B decode over a full 4096-slot ring, B=4, cache_len=6160",
     "decode", (4, 4096, 48, 8, 128, 128, 6160)),
    # the hybrid family's shared attention (Zamba2-7B: hd 112, 32/32 heads,
    # G = 1) and MLA's (MiniCPM3-4B: hd = qk_nope + qk_rope 96, vd 64,
    # 40/40 heads), at their serving phases' shapes; MLA's smoke config's
    # (24, 16), hd padded to 32 in the bf16 kernels, for correctness
    ("Zamba2-7B causal prefill, B=1, S=4096, hd 112", "flash",
     (1, 4096, 32, 32, 112, 112, True, None)),
    ("MiniCPM3-4B causal prefill, B=1, S=4096, hd 96, vd 64", "flash",
     (1, 4096, 40, 40, 96, 64, True, None)),
    ("Zamba2-7B decode over a full 4160-slot cache, B=4, hd 112", "decode",
     (4, 4160, 32, 32, 112, 112, 4160)),
    ("MiniCPM3-4B decode over a full 4160-slot cache, B=4, hd 96, vd 64",
     "decode", (4, 4160, 40, 40, 96, 64, 4160)),
    ("MLA smoke config's heads, B=2, S=300, hd 24, vd 16", "flash",
     (2, 300, 4, 4, 24, 16, True, None)),
    ("MLA smoke config's heads, B=2, cache_len=257, hd 24, vd 16", "decode",
     (2, 300, 4, 4, 24, 16, 257)),
)

# the encoder-decoder's and the vision frontend's shapes (SeamlessM4T-
# large-v2: 16/16 heads of 64, G = 1; InternVL2-2B: 16/8 heads of 128,
# G = 2) as their serving phases give them: the encoder unmasked over its
# FRONTEND_ENC_LEN frames, cross attention unmasked from 512 and from
# 1,024 decoder positions over them, the vision prefill causal over 256
# patches + 512 tokens, and a decode step's cross attention over the whole
# cross cache; 1,500 is no multiple of a key tile.  They draw from a
# generator of their own (FRONTEND_SEED), so that the phases after them
# see the stream they saw before the rows were added
FRONTEND_SEED = SEED + 27
FRONTEND_ATTENTION_CHECKS = (
    ("SeamlessM4T encoder, B=4, S=1500, not causal", "flash",
     (4, 1500, 16, 16, 64, 64, False, None)),
    ("SeamlessM4T cross attention, B=4, Sq=512 over Skv=1500", "flash",
     (4, 512, 16, 16, 64, 64, False, None, 1500)),
    ("SeamlessM4T cross attention, B=4, Sq=1024 over Skv=1500", "flash",
     (4, 1024, 16, 16, 64, 64, False, None, 1500)),
    ("InternVL2-2B causal prefill, B=4, S=768 (256 patches + 512), hd 128, "
     "G=2", "flash", (4, 768, 16, 8, 128, 128, True, None)),
    ("SeamlessM4T cross decode over 1500 slots, B=4, cache_len=1500",
     "decode", (4, 1500, 16, 16, 64, 64, 1500)),
)


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls captured in one
    CUDA graph and replayed: the calls' host cost (argument checks, the
    launches themselves) is left out, which sets the time of a kernel that
    runs for tens of microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def profiled_device_ms(fn) -> float:
    """The summed device time of the kernels, copies and fills one
    ``fn()`` call runs, from a ``torch.profiler`` trace of the card alone:
    a step's device-only time, without the host's gaps between its
    launches (a DTensor step dispatches each op on the host first).
    None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        us += evt.cuda_time_total if t is None else t
    return us / 1e3 if us > 0 else None


def graph_ms_rotating(fns, reps: int = 20) -> float:
    """:func:`graph_ms` of calls that rotate through ``fns``, each on its
    own inputs: with more bytes in all than L2 holds, no call finds its
    inputs there from the call before, as in a model step that streams
    every layer's weights and cache between two calls of one layer."""
    count = iter(range(1 << 30))
    return graph_ms(lambda: fns[next(count) % len(fns)](), reps)


def graph_kernel_nodes(fn):
    """Kernel nodes in a CUDA graph of one ``fn()`` call: the launches the
    call makes, read from the captured graph through ``libcuda``
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  Raises where this
    PyTorch keeps no graph to read (no ``keep_graph``): the count is a
    check, and an unread one would pass."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as exc:
        raise RuntimeError("cannot count a call's kernel nodes: this "
                           "PyTorch's CUDAGraph has no keep_graph") from exc
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def max_excess(out, ref, atol, rtol=None) -> tuple:
    """(max |out - ref|, max of |out - ref| / (atol + rtol |ref|)): the
    check passes where the second is at most 1; rtol defaults to atol."""
    rtol = atol if rtol is None else rtol
    err = (out.double() - ref.double()).abs()
    share = err / (atol + rtol * ref.double().abs())
    return float(err.max()), float(share.max())


def flash_dims(shape) -> tuple:
    """(Sq, Skv, causal, window) of a flash check's shape (B, S, H, KV, hd,
    vd, causal, window[, Skv]): Skv is S unless given (cross attention)."""
    s, causal, window = shape[1], shape[6], shape[7]
    return s, (shape[8] if len(shape) > 8 else s), causal, window


def window_mask(sq, skv, window, dev):
    """The causal window as a boolean (Sq, Skv) mask for
    ``scaled_dot_product_attention``, or None without a window."""
    if window is None:
        return None
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(skv, device=dev)[None, :]
    return (j <= i) & (j > i - window)


def attention_case(kind, shape, dev) -> tuple:
    """(dims, run, plain, pairs, bound, library) of one attention check:
    the q, k, v shapes, the kernel call and its plain version as the model
    path makes them (``plain(q, k, v, dtype)``), the allowed (query, key)
    pairs, the bound, and ``library(q, k, v) -> (call, to_bshd)`` for
    ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_plain)

    b, s, h, kv, hd, vd = shape[:6]
    if kind == "flash":
        s, skv, causal, window = flash_dims(shape)
        dims = ((b, s, h, hd), (b, skv, kv, hd), (b, skv, kv, vd))
        # the plain version's tiles are the model config's
        tiles = dict(causal=causal, window=window, q_block=512,
                     kv_block=1024)
        run = lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                              window=window)
        plain = lambda q, k, v, dtype=None: flash_attention_plain(
            q, k, v, dtype=dtype, **tiles)
        pairs = allowed_pairs(s, skv, causal, window)
        bound = attention_bound(b=b, sq=s, skv=skv, h=h, kv=kv, hd=hd,
                                vd=vd, pairs=pairs)
        mask = window_mask(s, skv, window, dev)

        def library(q, k, v):
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            return (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=mask is None and causal,
                enable_gqa=True)), lambda o: o.transpose(1, 2)
    else:
        clen = shape[6]
        n = min(clen, s)
        dims = ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, vd))
        length = torch.tensor(clen, dtype=torch.int32, device=dev)
        run = lambda q, k, v: decode_attention(q, k, v, length)
        plain = lambda q, k, v, dtype=None: decode_attention_plain(
            q, k, v, length, dtype=dtype)
        pairs = n
        bound = attention_bound(b=b, sq=1, skv=n, h=h, kv=kv, hd=hd, vd=vd,
                                pairs=pairs)

        def library(q, k, v):
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous()[:, :, :n]
                      for t in (k, v))
            return (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True)), lambda o: o.transpose(1, 2)
    return dims, run, plain, pairs, bound, library


def check_attention_kernel(tag, kind, shape, rng, dev) -> dict:
    """Hold one attention kernel against its plain version on the card: in
    f32 against the plain version in f32 and in f64, and in bf16 (the
    served dtype) against f64; then time kernel, plain version and
    ``scaled_dot_product_attention`` in bf16 on the same inputs, each from
    a replayed CUDA graph (:func:`graph_ms`)."""
    dims, run, plain, pairs, bound, library = attention_case(kind, shape,
                                                             dev)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(dev) for d in dims)
    out = run(q, k, v)
    torch.cuda.synchronize()
    ref64 = plain(q, k, v, torch.float64)
    err_f64, share32 = max_excess(out, ref64, ATTN_F32_TOL)
    err_plain = float((out - plain(q, k, v)).abs().max())
    del ref64
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = run(q, k, v)
    ref64 = plain(q, k, v, torch.float64)
    err_bf16, share16 = max_excess(out, ref64, ATTN_BF16_ATOL,
                                   ATTN_BF16_RTOL)
    if share32 > 1 or share16 > 1 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{kind} attention, {tag}: kernel disagrees with "
                             f"its f64 plain version (f32 max abs err "
                             f"{err_f64}, bf16 {err_bf16})")
    # sums in a fixed order: a second launch gives the same bits
    if not torch.equal(out, run(q, k, v)):
        raise AssertionError(f"{kind} attention, {tag}: two bf16 launches "
                             f"differ")
    lib_fn, lib_out = library(q, k, v)
    lib_err = float((lib_out(lib_fn()).double() - ref64).abs().max())
    del ref64, out
    eager_ms = cuda_ms(lambda: run(q, k, v))
    kernel_ms = graph_ms(lambda: run(q, k, v))
    # every call is one launch: one kernel node in a captured graph
    nodes = graph_kernel_nodes(lambda: run(q, k, v))
    if nodes != 1:
        raise AssertionError(f"{kind} attention, {tag}: one call captured "
                             f"{nodes} kernel nodes")
    plain_ms = graph_ms(lambda: plain(q, k, v))
    library_ms = graph_ms(lib_fn)
    kernel_cold_ms = library_cold_ms = None
    if kind == "decode":
        # as a decode step calls it: each layer's cache is cold in L2
        copies = [tuple(t.clone() for t in (q, k, v))
                  for _ in range(COLD_COPIES)]
        kernel_cold_ms = graph_ms_rotating(
            [lambda c=c: run(*c) for c in copies])
        library_cold_ms = graph_ms_rotating(
            [library(*c)[0] for c in copies])
        del copies
    return {"phase": "attention-kernel-check", "kernel": (
                "flash_attention" if kind == "flash" else "decode_attention"),
            "shape": tag, "dims": list(shape), "pairs": pairs,
            "f32_max_abs_err_vs_f64": err_f64,
            "f32_max_abs_err_vs_plain_f32": err_plain,
            "bf16_max_abs_err_vs_f64": err_bf16,
            "share_of_limit": {"f32": share32, "bf16": share16},
            "tolerance": {
                "f32": {"atol": ATTN_F32_TOL, "rtol": ATTN_F32_TOL},
                "bf16": {"atol": ATTN_BF16_ATOL, "rtol": ATTN_BF16_RTOL}},
            "library": "scaled_dot_product_attention(enable_gqa=True)",
            "library_bf16_max_abs_err_vs_f64": lib_err,
            "kernel_ms": kernel_ms, "kernel_eager_ms": eager_ms,
            "kernel_cold_ms": kernel_cold_ms,
            "library_cold_ms": library_cold_ms,
            "kernel_nodes_per_call": nodes, "run_to_run_bitwise": True,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "timing": "device time of 20 calls replayed from one CUDA graph "
                      "(inputs warm in L2); kernel_eager_ms: 20 eager calls "
                      "back to back, their host cost included; *_cold_ms "
                      "(decode): the graph's calls rotate through "
                      f"{COLD_COPIES} copies of the inputs, more bytes than "
                      "L2 holds, so each call reads its cache from HBM",
            **bound,
            "roofline_share": bound["bound_ms"] / kernel_ms}


@contextlib.contextmanager
def counting_plain_attention(calls: list):
    """Count every call of the attention plain versions, wherever the
    model or a wrapper reaches them, while the block runs."""
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FA

    def counted(fn):
        def call(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    saved = [(FA, "flash_attention_plain", FA.flash_attention_plain),
             (DA, "decode_attention_plain", DA.decode_attention_plain)]
    for mod, n, fn in saved:
        setattr(mod, n, counted(fn))
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


@contextlib.contextmanager
def plain_attention_layers():
    """Within this block the model's attention calls run the kernels' plain
    versions, on any device: the replay the served logits are held
    against."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import layers as L

    saved = L.flash_attention, L.decode_attention_kernel
    L.flash_attention = flash_attention_plain
    L.decode_attention_kernel = decode_attention_plain
    try:
        yield
    finally:
        L.flash_attention, L.decode_attention_kernel = saved


def serve_path(phase, cfg, *, requests, slots, prompt_len, new_tokens,
               max_len, dev, rng, run_ctx=None) -> tuple:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens on ``cfg``
    (seeded weights, greedy) through ``repro_torch.serve.ServingEngine``,
    every attention call a kernel launch (counts set to 0 just before,
    read just after; an attention-free model launches none), inside
    ``run_ctx`` if given.  Returns (row, engine, prompts, counts); the
    engine keeps wave 0's logits and tokens for the replay."""
    from repro_torch.models.params import init_params, param_count_actual
    from repro_torch.models.transformer import attention_calls
    from repro_torch.serve.engine import Request, ServingEngine

    class RecordingEngine(ServingEngine):
        """Keeps wave 0's (logits, token) at every selection."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.wave, self.record = -1, []

        def _run_wave(self, wave, stats):
            self.wave += 1
            super()._run_wave(wave, stats)

        def _select(self, logits):
            cur = super()._select(logits)
            if self.wave == 0:
                self.record.append((logits.clone(), cur.clone()))
            return cur

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    engine = RecordingEngine(cfg, params, batch_slots=slots,
                             max_len=max_len, device=dev)
    del params
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len),
                           dtype=np.int32)
    reqs = [Request(prompt=prompts[i], max_new_tokens=new_tokens, id=i)
            for i in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    plain_calls = []
    flash = wrapper("flash_attention")
    with counting_plain_attention(plain_calls), (
            run_ctx or contextlib.nullcontext()):
        reset_launch_counts()
        flash.lse_launches = 0
        t0 = time.perf_counter()
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if plain_calls:
        raise AssertionError(f"{phase}: serving called a plain version: "
                             f"{sorted(set(plain_calls))}")
    if flash.lse_launches:
        raise AssertionError(f"{phase}: serving wrote the log-sum-exp in "
                             f"{flash.lse_launches} flash launches")
    waves = -(-requests // slots)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    calls = attention_calls(cfg)
    want.update(flash_attention=calls * waves,
                decode_attention=calls * stats.steps)
    if counts != want:
        raise AssertionError(f"{phase}: serving launched {counts}, expected "
                             f"{want} (one flash launch per attention call "
                             f"and prefill, one decode launch per attention "
                             f"call and step; none without attention)")
    for r in reqs:
        if len(r.output) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"{phase}: request {r.id}: output "
                                 f"{r.output[:8]}...")
    # one decode step of the served shape alone (the cache at wave 0's
    # midpoint): eager, and its device time from a replayed CUDA graph;
    # their ratio is the device's busy share of a step's model call
    from repro_torch.models.transformer import init_cache, lm_decode_step
    cache = init_cache(cfg, slots, max_len, device=dev)
    token = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(prompt_len + new_tokens // 2, dtype=torch.int32,
                       device=dev)
    step = lambda: lm_decode_step(engine.params, cfg, cache, token, pos)
    step_eager_ms = cuda_ms(step, reps=10)
    step_device_ms = graph_ms(step, reps=10)
    del cache
    row = {"phase": phase, "model": cfg.name,
           "params": param_count_actual(cfg), "layers": cfg.num_layers,
           "attention_calls_per_pass": calls,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab_size,
           "activation_dtype": cfg.activation_dtype, "requests": requests,
           "slots": slots, "prompt_len": prompt_len,
           "new_tokens": new_tokens, "max_len": max_len, "waves": waves,
           "setup_s": setup_s, "wall_s": wall, "prefill_s": stats.prefill_s,
           "decode_s": stats.decode_s, "steps": stats.steps,
           "tokens_out": stats.tokens_out,
           "tokens_per_s": stats.tokens_per_s,
           "ms_per_decode_step": stats.decode_s / stats.steps * 1e3,
           "prefill_ms_per_wave": stats.prefill_s / waves * 1e3,
           "decode_step_eager_ms": step_eager_ms,
           "decode_step_device_ms": step_device_ms,
           "decode_step_device_busy_share": step_device_ms / step_eager_ms,
           "peak_memory_gb": peak / 1e9,
           "setup_peak_memory_gb": setup_peak / 1e9,
           "launches": counts, "plain_attention_calls": len(plain_calls),
           "flash_lse_launches": flash.lse_launches}
    return row, engine, prompts, counts


def lm_serve_path(dev, rng) -> tuple:
    """Serve LM_REQUESTS random prompts on Qwen2-0.5B at full width (see
    :func:`serve_path`)."""
    from repro_torch.configs import get_config

    return serve_path("lm-serve", get_config(LM_ARCH), requests=LM_REQUESTS,
                      slots=LM_SLOTS, prompt_len=LM_PROMPT,
                      new_tokens=LM_NEW, max_len=LM_MAX_LEN, dev=dev,
                      rng=rng)


def replay_logits(params, cfg, prompts, tokens, max_len, dev, *, plain,
                  cache=None, inputs=None, crosses=None) -> list:
    """Logits (B, V), in f32, of wave 0 teacher-forced: the prefill's last
    position, then each decode step fed the served ``tokens``, through the
    plain attention versions (``plain``) or the kernels; ``cache`` starts
    the decode steps from a copy of that cache instead of the replay's own
    prefill.  ``inputs``: the prefill batch's frontend inputs (``frames``
    or ``patch_embeds``; the decode positions start after the patches);
    ``crosses``, a list: the prefill's cross cache is appended to it."""
    from repro_torch.models.transformer import lm_decode_step
    from repro_torch.train.step import make_prefill_step

    inputs = inputs or {}
    out = []
    with (plain_attention_layers() if plain
          else contextlib.nullcontext()):
        last, own = make_prefill_step(cfg, cache_len=max_len)(
            params, {"tokens": prompts, **inputs})
        out.append(last.float())
        del last
        if crosses is not None:
            crosses.append(own["cross"])
        if cache is not None:
            own = {key: {k: t.clone() for k, t in tree.items()}
                   for key, tree in cache.items()}
        plen = prompts.shape[1] + (inputs["patch_embeds"].shape[1]
                                   if "patch_embeds" in inputs else 0)
        for step in range(1, len(tokens)):
            pos = torch.tensor(plen + step - 1, dtype=torch.int32, device=dev)
            lg, own = lm_decode_step(params, cfg, own,
                                     tokens[step - 1][:, None], pos)
            out.append(lg[:, -1].float())
    return out


def drift_shares(got, want, tol=LM_LOGIT_TOL) -> list:
    """Per step: max |got - want| as a share of tol · max(max |want|, 1)."""
    return [float((g - w).abs().max()) / (tol * max(float(w.abs().max()),
                                                    1.0))
            for g, w in zip(got, want)]


def cross_drift(got, want) -> float:
    """Max over the cross cache's k and v of max |got - want| as a share
    of LM_LOGIT_TOL · max(max |want|, 1)."""
    return max(float((got[n].float() - want[n].float()).abs().max())
               / (LM_LOGIT_TOL * max(float(want[n].float().abs().max()),
                                     1.0)) for n in ("k", "v"))


def lm_teacher_forced(engine, prompts, dev, *, routes=None, inputs=None,
                      served_cross=None) -> dict:
    """Replay wave 0 on the card through the plain attention versions,
    teacher-forced (:func:`replay_logits`), twice: at the config's tiles,
    and at half of them, the control, whose f32 sums differ from the first
    replay's in order only, as the kernels' do.  A replay's drift is its
    max over steps of :func:`drift_shares`.  The served logits' drift from
    the plain replay must stay within max(1, LM_DRIFT_RATIO x the
    control's): LM_LOGIT_TOL, or, where the model's depth drifts two
    correct bf16 attention paths near it (Zamba2-7B), a stated multiple of
    the drift between two such paths on the same prompts.  ``routes`` (an
    MoE model): the served wave's expert ids of every ``moe_mlp`` call,
    which both replays take (:func:`forced_routes`); how many token routes
    the first replay's own top-k would have changed is reported, not
    asserted.  ``inputs``: wave 0's frontend inputs (a batch's
    ``frames`` or ``patch_embeds``).  ``served_cross``: an encoder-decoder's served cross
    cache of wave 0, whose bytes are compared with the replays' (bitwise
    share), and whose drift from the plain replay's must stay within
    max(1, LM_DRIFT_RATIO x the control's) of LM_LOGIT_TOL times its
    largest value."""
    import dataclasses

    cfg, rec = engine.cfg, engine.record
    tokens = [tok for _, tok in rec]
    served = [lg.float() for lg, _ in rec]
    toks = torch.from_numpy(prompts[:engine.slots]).to(dev)
    half = dataclasses.replace(cfg, q_block=cfg.q_block // 2,
                               kv_block=cfg.kv_block // 2)
    before = launch_counts()
    t0 = time.perf_counter()
    flips, runs, crosses = [], [], []
    for c, f in ((cfg, flips), (half, [])):
        with (forced_routes(routes, f) if routes is not None
              else contextlib.nullcontext()):
            runs.append(replay_logits(
                engine.params, c, toks, tokens, engine.max_len, dev,
                plain=True, inputs=inputs,
                crosses=crosses if served_cross is not None else None))
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("the plain replay launched a kernel")
    plain, control = runs
    if not all(bool(torch.isfinite(lg).all()) for lg in plain + control):
        raise AssertionError(f"{cfg.name}: replay logits not finite")
    shares = drift_shares(plain, served)
    control_shares = drift_shares(control, plain)
    bound = max(1.0, LM_DRIFT_RATIO * max(control_shares))
    worst = int(np.argmax(shares))
    errs = [float((p - s).abs().max()) for p, s in zip(plain, served)]
    scales = [float(s.abs().max()) for s in served]
    row = {"phase": "lm-teacher-forced", "model": cfg.name, "wave": 0,
           "steps": len(rec), "wall_s": time.perf_counter() - t0,
           "prefill_last_max_abs_diff": errs[0],
           "prefill_last_max_abs_logit": scales[0],
           "decode_max_abs_diff": max(errs[1:]),
           "decode_max_abs_logit": max(scales[1:]),
           "worst_step": worst, "worst_step_share_of_limit": shares[worst],
           "limit": f"{LM_LOGIT_TOL} * max(max|logit|, 1)",
           "control_tiles": [half.q_block, half.kv_block],
           "control_worst_step": int(np.argmax(control_shares)),
           "control_worst_share_of_limit": max(control_shares),
           "bound": f"max(1, {LM_DRIFT_RATIO} * control)",
           "bound_share_of_limit": bound,
           "share_by_step": shares, "control_share_by_step": control_shares,
           "teacher_forced_argmax_agreement": float(np.mean([
               float((p.argmax(-1).int() == t).float().mean())
               for p, t in zip(plain, tokens)]))}
    if routes is not None:
        if len(flips) != len(routes):
            raise AssertionError(f"the replay made {len(flips)} moe_mlp "
                                 f"calls, the served wave {len(routes)}")
        flips = [int(f) for f in flips]
        row.update(forced_routes=True, moe_calls=len(routes),
                   token_routes=sum(int(r[..., 0].numel()) for r in routes),
                   routes_the_unforced_replay_would_flip=sum(flips),
                   flips_in_prefill_by_layer=flips[:cfg.num_layers],
                   flips_in_decode=sum(flips[cfg.num_layers:]))
    if served_cross is not None:
        share_c = cross_drift(served_cross, crosses[0])
        control_c = cross_drift(crosses[1], crosses[0])
        bound_c = max(1.0, LM_DRIFT_RATIO * control_c)
        row.update(cross_cache={
            "share_of_limit": share_c, "control_share_of_limit": control_c,
            "bound_share_of_limit": bound_c,
            "max_abs_diff": max(float((served_cross[n].float()
                                       - crosses[0][n].float()).abs().max())
                                for n in ("k", "v")),
            "bitwise_share": float(np.mean([
                float((served_cross[n] == crosses[0][n]).float().mean())
                for n in ("k", "v")])),
            "dtype": str(served_cross["k"].dtype).replace("torch.", ""),
            "shape": list(served_cross["k"].shape)})
        if not share_c <= bound_c:
            raise AssertionError(f"the served cross cache disagrees with the "
                                 f"plain replay's: {row['cross_cache']}")
    del crosses
    if shares[worst] > bound:
        raise AssertionError(f"served logits disagree with the plain replay: "
                             f"{row}")
    return row


def lm_f32_replay(engine, prompts, dev) -> dict:
    """Wave 0 teacher-forced (the served tokens) with f32 activations on
    the served weights widened to f32, twice: through the kernels' f32
    entries and through the plain attention versions (the engine's bf16
    weights are dropped).  Each step's logits must agree within
    LM_F32_LOGIT_TOL, where a kernel that computed in bf16 would not."""
    import dataclasses

    from repro_torch.models.params import cast_params
    from repro_torch.models.transformer import attention_calls

    cfg = dataclasses.replace(engine.cfg, activation_dtype="float32")
    params = cast_params(engine.params, torch.float32)
    # the served bf16 copy is not used again: freeing it makes room for the
    # f32 prefill (Zamba2-7B: 13.5 GB beside the f32 copy's 27)
    engine.params = None
    torch.cuda.empty_cache()
    tokens = [tok for _, tok in engine.record]
    toks = torch.from_numpy(prompts[:engine.slots]).to(dev)
    t0 = time.perf_counter()
    before = launch_counts()
    kernel = replay_logits(params, cfg, toks, tokens, engine.max_len, dev,
                           plain=False)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    calls = attention_calls(cfg)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(flash_attention=calls, decode_attention=calls * (
        len(tokens) - 1))
    if launched != want:
        raise AssertionError(f"{cfg.name}: the f32 kernel replay launched "
                             f"{launched}, expected {want}")
    before = launch_counts()
    plain = replay_logits(params, cfg, toks, tokens, engine.max_len, dev,
                          plain=True)
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("the plain f32 replay launched a kernel")
    del params
    errs = [float((k - p).abs().max()) for k, p in zip(kernel, plain)]
    scales = [float(p.abs().max()) for p in plain]
    shares = drift_shares(kernel, plain, LM_F32_LOGIT_TOL)
    finite = all(bool(torch.isfinite(k).all()) for k in kernel)
    row = {"phase": "lm-f32-replay", "model": cfg.name, "wave": 0,
           "steps": len(tokens), "wall_s": time.perf_counter() - t0,
           "kernel_launches": launched,
           "prefill_last_max_abs_diff": errs[0],
           "prefill_last_max_abs_logit": scales[0],
           "decode_max_abs_diff": max(errs[1:]),
           "decode_max_abs_logit": max(scales[1:]),
           "worst_step": int(np.argmax(shares)),
           "worst_step_share_of_limit": max(shares),
           "limit": f"{LM_F32_LOGIT_TOL} * max(max|logit|, 1)",
           "argmax_agreement": float(np.mean([
               float((k.argmax(-1) == p.argmax(-1)).float().mean())
               for k, p in zip(kernel, plain)]))}
    if not finite or max(shares) > 1:
        raise AssertionError(f"f32 kernel replay disagrees with the plain "
                             f"one: {row}")
    return row


# ---- the MoE, SSM, hybrid and MLA families at full width ----------------
# (phase, arch, layers kept of the published depth, requests, slots,
# prompt tokens, new tokens, max_len); widths as published, and Zamba2-7B
# (81 layers: 13 applications of the shared block) and MiniCPM3-4B (62)
# whole
FAMILY_SERVING = (
    ("lm-serve-moe", "mixtral_8x22b", 4, 8, 4, 6144, 32, 8192),
    ("lm-serve-moe", "dbrx_132b", 2, 4, 4, 2048, 16, 4096),
    ("lm-serve-ssm", "mamba2_2_7b", 64, 8, 4, 4096, 64, 4224),
    ("lm-serve-hybrid", "zamba2_7b", 81, 8, 4, 4096, 32, 4160),
    ("lm-serve-mla", "minicpm3_4b", 62, 8, 4, 4096, 32, 4160),
)


@contextlib.contextmanager
def recorded_routes(record: list):
    """Append the top-k expert ids of every ``moe_mlp`` call (each layer of
    each prefill and decode step, in order) to ``record`` while the block
    runs; the routes themselves are the model's own."""
    from repro_torch.models import moe

    route = moe.route

    def recording(probs, k):
        w, i = route(probs, k)
        record.append(i)
        return w, i

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def forced_routes(record: list, flips: list):
    """Within this block each ``moe_mlp`` call takes the next expert ids of
    ``record``, with weights recomputed from the call's own probabilities
    at those experts (renormalised, as ``moe.route``); ``flips`` gets, per
    call, the count of tokens whose own top-k experts are another set."""
    from repro_torch.models import moe

    route, calls = moe.route, iter(record)

    def forced(probs, k):
        _, own = route(probs, k)
        want = next(calls)
        flips.append((own.sort(-1).values != want.sort(-1).values)
                     .any(-1).sum())
        w = probs.gather(-1, want)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), want

    moe.route = forced
    try:
        yield
    finally:
        moe.route = route


def family_config(arch: str, layers: int):
    """The published config with its depth cut to ``layers`` (an
    encoder-decoder's encoder too), and the cut as the row's
    ``reduced``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cut = {"num_layers": layers}
    if cfg.encoder_layers:
        cut["encoder_layers"] = layers
    reduced = {k: f"{getattr(cfg, k)} -> {n}" for k, n in cut.items()
               if getattr(cfg, k) != n}
    return dataclasses.replace(cfg, **cut), reduced


def lm_serve_moe_path(arch, layers, requests, slots, prompt_len, new_tokens,
                      max_len, dev, rng) -> tuple:
    """An MoE model at full width with its depth cut (:func:`serve_path`),
    every route of the served run recorded; then the share of assignments
    each layer's capacity dropped in each wave's prefill and in the decode
    steps, and wave 0 replayed through the plain attention versions with
    its routes forced (:func:`lm_teacher_forced`).  Returns (rows,
    counts)."""
    from repro_torch.models.moe import assign, capacity

    cfg, reduced = family_config(arch, layers)
    record = []
    row, engine, prompts, counts = serve_path(
        "lm-serve-moe", cfg, requests=requests, slots=slots,
        prompt_len=prompt_len, new_tokens=new_tokens, max_len=max_len,
        dev=dev, rng=rng, run_ctx=recorded_routes(record))
    e, nl = cfg.moe.num_experts, cfg.num_layers
    per_wave = nl * (1 + row["steps"] // row["waves"])
    if row["steps"] % row["waves"] or len(record) != per_wave * row["waves"]:
        raise AssertionError(f"{cfg.name}: {len(record)} moe_mlp calls for "
                             f"{row['waves']} waves and {row['steps']} steps")

    def dropped(ids):
        return int((~assign(ids, e, capacity(cfg, ids.shape[1]))[1]).sum())

    prefill_drop, decode_dropped = [], 0
    for w in range(row["waves"]):
        calls = record[w * per_wave:(w + 1) * per_wave]
        prefill_drop.append([dropped(ids) / ids.numel()
                             for ids in calls[:nl]])
        decode_dropped += sum(dropped(ids) for ids in calls[nl:])
    row.update(reduced=reduced, experts=e, top_k=cfg.moe.top_k,
               d_ff=cfg.d_ff, window=cfg.sliding_window,
               capacity_prefill=capacity(cfg, prompt_len),
               capacity_decode=capacity(cfg, 1),
               prefill_dropped_share_by_wave_and_layer=prefill_drop,
               decode_assignments_dropped=decode_dropped,
               moe_calls=len(record))
    wave0 = record[:nl * len(engine.record)]
    del record
    replay = lm_teacher_forced(engine, prompts, dev, routes=wave0)
    del engine, wave0
    torch.cuda.empty_cache()
    return [row, replay], counts


def lm_serve_ssm_path(arch, layers, requests, slots, prompt_len, new_tokens,
                      max_len, dev, rng) -> tuple:
    """The SSM model (:func:`serve_path`: no attention launch), then its two
    paths against each other at full width: the served wave 0's first
    decode step (a prefill of S tokens, then one recurrent step on the
    served token) against the last logits of a prefill of those S + 1
    tokens (the chunked scan, its last chunk padded), within
    LM_LOGIT_TOL.  Returns (rows, counts)."""
    from repro_torch.models.transformer import lm_prefill

    cfg, reduced = family_config(arch, layers)
    row, engine, prompts, counts = serve_path(
        "lm-serve-ssm", cfg, requests=requests, slots=slots,
        prompt_len=prompt_len, new_tokens=new_tokens, max_len=max_len,
        dev=dev, rng=rng)
    s_cfg = cfg.ssm
    row.update(reduced=reduced, d_state=s_cfg.d_state,
               ssm_heads=s_cfg.num_heads(cfg.d_model),
               ssm_head_dim=s_cfg.head_dim, chunk=s_cfg.chunk_size)
    t0 = time.perf_counter()
    before = launch_counts()
    toks = torch.cat([torch.from_numpy(prompts[:slots]).to(dev),
                      engine.record[0][1][:, None]], 1)
    logits, _ = lm_prefill(engine.params, cfg, toks, cache_len=0)
    last = logits[:, -1].float()
    del logits
    served = engine.record[1][0].float()
    err = float((last - served).abs().max())
    scale = float(served.abs().max())
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError(f"{cfg.name}: the SSM prefill launched a kernel")
    check = {"phase": "lm-ssm-scan-vs-recurrence", "model": cfg.name,
             "prompt_len": prompt_len, "slots": slots,
             "wall_s": time.perf_counter() - t0,
             "max_abs_diff": err, "max_abs_logit": scale,
             "share_of_limit": err / (LM_LOGIT_TOL * max(scale, 1.0)),
             "same_argmax": float((last.argmax(-1) == served.argmax(-1))
                                  .float().mean()),
             "limit": f"{LM_LOGIT_TOL} * max(max|logit|, 1)"}
    if not (bool(torch.isfinite(last).all())
            and err <= LM_LOGIT_TOL * max(scale, 1.0)):
        raise AssertionError(f"{cfg.name}: the chunked scan disagrees with "
                             f"the recurrence: {check}")
    del engine
    torch.cuda.empty_cache()
    return [row, check], counts


def lm_serve_attention_path(arch, layers, requests, slots, prompt_len,
                            new_tokens, max_len, dev, rng) -> tuple:
    """The hybrid (Zamba2-7B, ``lm-serve-hybrid``) or MLA (MiniCPM3-4B,
    ``lm-serve-mla``) model at full width (:func:`serve_path`: one flash
    launch per attention call and wave, one decode launch per attention
    call and step, at the families' head dims), then wave 0 replayed
    through the plain attention versions in bf16 (:func:`lm_teacher_forced`)
    and, against its replay through the kernels, in f32
    (:func:`lm_f32_replay`).  Returns (rows, counts)."""
    cfg, reduced = family_config(arch, layers)
    phase = "lm-serve-mla" if cfg.mla is not None else "lm-serve-hybrid"
    row, engine, prompts, counts = serve_path(
        phase, cfg, requests=requests, slots=slots, prompt_len=prompt_len,
        new_tokens=new_tokens, max_len=max_len, dev=dev, rng=rng)
    if cfg.mla is not None:
        m = cfg.mla
        row.update(mla={"q_lora_rank": m.q_lora_rank,
                        "kv_lora_rank": m.kv_lora_rank},
                   attention_head_dims=[m.qk_nope_head_dim
                                        + m.qk_rope_head_dim, m.v_head_dim])
    else:
        s_cfg = cfg.ssm
        row.update(hybrid_period=cfg.hybrid_period, d_state=s_cfg.d_state,
                   ssm_heads=s_cfg.num_heads(cfg.d_model),
                   attention_head_dims=[cfg.resolved_head_dim] * 2)
    row.update(reduced=reduced, d_ff=cfg.d_ff)
    replay = lm_teacher_forced(engine, prompts, dev)
    replay32 = lm_f32_replay(engine, prompts, dev)
    del engine
    torch.cuda.empty_cache()
    return [row, replay, replay32], counts


FAMILY_PATHS = {"lm-serve-moe": lm_serve_moe_path,
                "lm-serve-ssm": lm_serve_ssm_path,
                "lm-serve-hybrid": lm_serve_attention_path,
                "lm-serve-mla": lm_serve_attention_path}


# ---- the encoder-decoder and vision families at full width --------------
# (phase, arch, requests, slots, prompt tokens, new tokens); both models
# whole at their published widths.  Each SeamlessM4T-large-v2 request
# brings FRONTEND_ENC_LEN encoder frames, each InternVL2-2B request its
# frontend_len (256) patch embeddings, both 0.02 N(0, 1) from the seed, as
# tests/test_arch_smoke.py makes them
FRONTEND_SERVING = (
    ("lm-serve-encdec", "seamless_m4t_large_v2", 8, 4, 512, 64),
    ("lm-serve-vlm", "internvl2_2b", 8, 4, 512, 64),
)
FRONTEND_ENC_LEN = 1500
# (phase, arch, layers, batch, text tokens): Seamless's 1,024 decoder
# tokens over its 1,500 frames, InternVL2's 256 patches + 1,792 tokens
FRONTEND_TRAINING = (
    ("lm-train-encdec", "seamless_m4t_large_v2", 24, 4, 1024),
    ("lm-train-vlm", "internvl2_2b", 24, 4, 1792),
)


def frontend_positions(cfg) -> tuple:
    """(the batch key, positions a sequence) of the frontend stub's
    inputs: an encoder-decoder's FRONTEND_ENC_LEN ``frames``, a vision
    model's frontend_len ``patch_embeds``; (None, 0) for the others."""
    if cfg.encoder_layers > 0:
        return "frames", FRONTEND_ENC_LEN
    if cfg.frontend == "vision":
        return "patch_embeds", cfg.frontend_len
    return None, 0


def frontend_inputs(cfg, batch: int, rng) -> dict:
    """The frontend stub's inputs of ``batch`` sequences
    (:func:`frontend_positions`), numpy f32 (B, n, d) drawn 0.02 N(0, 1)
    from ``rng``; none for the families without a frontend."""
    name, n = frontend_positions(cfg)
    if name is None:
        return {}
    return {name: (0.02 * rng.standard_normal((batch, n, cfg.d_model))
                   ).astype(np.float32)}


class FrontendData:
    """Batches of ``data`` (a ``SyntheticLMData``) with the frontend
    inputs of ``cfg`` (:func:`frontend_inputs`) drawn for each step from
    (SEED, step); ``extra_positions`` of them come with each sequence."""

    def __init__(self, cfg, data):
        self.model_cfg, self.data, self.cfg = cfg, data, data.cfg
        self.extra_positions = frontend_positions(cfg)[1]

    def batch_at(self, step: int) -> dict:
        batch = self.data.batch_at(step)
        batch.update(frontend_inputs(self.model_cfg, batch["tokens"].shape[0],
                                     np.random.default_rng((SEED, step))))
        return batch


def lm_serve_frontend_path(phase, arch, requests, slots, prompt_len,
                           new_tokens, dev, rng) -> tuple:
    """Serve an encoder-decoder (SeamlessM4T-large-v2, ``lm-serve-encdec``)
    or a vision model (InternVL2-2B, ``lm-serve-vlm``) whole at full width
    (seeded weights held in bf16, greedy): ``requests`` prompts of
    ``prompt_len`` tokens, each with its frontend inputs
    (:func:`frontend_inputs`), in waves of ``slots`` through
    ``make_prefill_step``, then ``make_serve_step`` in lockstep at pos = P
    + prompt_len + i (P the patches; ``ServingEngine`` passes no frontend
    inputs, as the reference's).  Every attention call is a kernel launch
    (counts set to 0 just before, read just after): per wave, per encoder
    layer one unmasked flash launch over the frames and per decoder layer
    a causal one and a cross one (Sq = prompt_len over Skv = the frames);
    per decode step per decoder layer a decode launch over the self cache
    and one over the whole cross cache; no plain call, no log-sum-exp.  A
    decode step alone is timed eager and from a replayed CUDA graph.  Then
    wave 0 is replayed through the plain attention versions
    (:func:`lm_teacher_forced`, with the served cross cache against the
    replay's).  Returns (rows, counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import (cast_params, init_params,
                                           param_count_actual)
    from repro_torch.models.transformer import (attention_calls, init_cache,
                                                lm_decode_step)
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = get_config(arch)
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
    max_len = prefix + prompt_len + new_tokens
    waves = requests // slots
    if waves * slots != requests:
        raise ValueError(f"{phase}: {requests} requests do not fill waves of "
                         f"{slots}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    served = cast_params(params, torch.bfloat16)
    del params
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len),
                           dtype=np.int32)
    inputs = [{k: torch.from_numpy(a).to(dev) for k, a in
               frontend_inputs(cfg, slots, rng).items()}
              for _ in range(waves)]
    prefill = make_prefill_step(cfg, cache_len=max_len)
    serve = make_serve_step(cfg)
    record, outputs, plain_calls = [], [], []
    prefill_s = decode_s = 0.0
    steps = 0
    cross0 = None
    flash = wrapper("flash_attention")
    torch.cuda.reset_peak_memory_stats()
    with counting_plain_attention(plain_calls):
        reset_launch_counts()
        flash.lse_launches = 0
        t_wall = time.perf_counter()
        for w in range(waves):
            batch = {"tokens": torch.from_numpy(
                prompts[w * slots:(w + 1) * slots]).to(dev), **inputs[w]}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(served, batch)
            # a view of the prompt's (B, S, V) logits, which the copy frees
            logits = logits.clone()
            cur = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
            if w == 0:
                record.append((logits, cur))
                cross0 = cache.get("cross")
            toks = [cur]
            t0 = time.perf_counter()
            pos = torch.tensor(prefix + prompt_len, dtype=torch.int32,
                               device=dev)
            for _ in range(new_tokens - 1):
                logits, cache = serve(served, cache, cur[:, None], pos)
                cur = logits.argmax(-1).to(torch.int32)
                if w == 0:
                    record.append((logits, cur))
                toks.append(cur)
                pos = pos + 1
                steps += 1
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            outputs.append(torch.stack(toks, 1).cpu())
            del cache, logits
        wall = time.perf_counter() - t_wall
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if plain_calls:
        raise AssertionError(f"{phase}: serving called a plain version: "
                             f"{sorted(set(plain_calls))}")
    if flash.lse_launches:
        raise AssertionError(f"{phase}: serving wrote the log-sum-exp in "
                             f"{flash.lse_launches} flash launches")
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(flash_attention=attention_calls(cfg) * waves,
                decode_attention=attention_calls(cfg, decode=True) * steps)
    if counts != want:
        raise AssertionError(f"{phase}: serving launched {counts}, expected "
                             f"{want}")
    out = torch.cat(outputs)
    if tuple(out.shape) != (requests, new_tokens) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase}: outputs {tuple(out.shape)}, "
                             f"{out[0, :8].tolist()}...")
    cache = init_cache(cfg, slots, max_len, enc_len=FRONTEND_ENC_LEN,
                       device=dev)
    token = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(prefix + prompt_len + new_tokens // 2,
                       dtype=torch.int32, device=dev)
    step = lambda: lm_decode_step(served, cfg, cache, token, pos)
    step_eager_ms = cuda_ms(step, reps=10)
    step_device_ms = graph_ms(step, reps=10)
    del cache
    row = {"phase": phase, "model": cfg.name,
           "params": param_count_actual(cfg), "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers,
           "attention_calls_per_prefill": attention_calls(cfg),
           "attention_calls_per_decode_step": attention_calls(cfg,
                                                              decode=True),
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "activation_dtype": cfg.activation_dtype,
           "frontend_inputs": {k: list(v.shape)
                               for k, v in inputs[0].items()},
           "requests": requests, "slots": slots, "prompt_len": prompt_len,
           "new_tokens": new_tokens, "max_len": max_len, "waves": waves,
           "drive": "make_prefill_step, then make_serve_step in lockstep",
           "setup_s": setup_s, "wall_s": wall, "prefill_s": prefill_s,
           "decode_s": decode_s, "steps": steps,
           "tokens_out": int(out.numel()),
           "tokens_per_s": steps * slots / decode_s,
           "ms_per_decode_step": decode_s / steps * 1e3,
           "prefill_s_per_wave": prefill_s / waves,
           "decode_step_eager_ms": step_eager_ms,
           "decode_step_device_ms": step_device_ms,
           "decode_step_device_busy_share": step_device_ms / step_eager_ms,
           "peak_memory_gb": peak / 1e9,
           "setup_peak_memory_gb": setup_peak / 1e9,
           "launches": counts, "plain_attention_calls": len(plain_calls),
           "flash_lse_launches": flash.lse_launches,
           "timing": "host clock around each wave's prefill and its decode "
                     "loop, each ending in a sync; tokens_per_s counts the "
                     "decode steps' tokens over the decode time"}
    holder = SimpleNamespace(cfg=cfg, params=served, record=record,
                             slots=slots, max_len=max_len)
    replay = lm_teacher_forced(holder, prompts, dev, inputs=inputs[0],
                               served_cross=cross0)
    del holder, served, record, inputs, cross0
    torch.cuda.empty_cache()
    return [row, replay], counts


# ---- training: the flash backward and Qwen2-0.5B steps ------------------
# Mixtral-8x22B's training attention (lm-train-moe: B = 4, S = 6,144 past
# its 4,096 window, 48/8 heads of 128)
MIXTRAL_BWD_SHAPE = (4, 6144, 48, 8, 128, 128, True, 4096)
# the MQA rows below draw from a generator of their own (MQA_BWD_SEED), so
# that the rows and phases after them keep their draws
MQA_BWD_SHAPES = ((1, 1024, 48, 1, 128, 128, False, None, 4160),
                  (1, 1024, 48, 1, 128, 128, True, None))
MQA_BWD_SEED = SEED + 33
# the flash forward's device kernels, by the dtype of the call (the static
# and the dynamic entries alike), as the kernels line names them
FLASH_DEVICE_KERNELS = {"device_kernels": {
    "bfloat16": "hop::flash_fwd_bf16_kernel (wgmma; K/V by TMA into a "
                "3-stage ring, one producer thread; two consumer "
                "warpgroups of 64 rows)",
    "float32": "simt::flash_fwd_f32_kernel (CUDA cores)"}}
# the flash backward's checks: (tag, (B, S, H, KV, hd, vd, causal,
# window[, Skv]), dtype, timed); the first is Qwen2-0.5B's training shape, the kernels
# line's main row; the hybrid's and MLA's training shapes (Zamba2-7B's
# shared attention, hd 112, 32/32 heads; MiniCPM3-4B's hd 96 with vd 64,
# 40/40), MLA's smoke dims and Mixtral's training shape are timed too
FLASH_BWD_CHECKS = (
    ("training shape, B=4, S=2048, G=7", (4, 2048, 14, 2, 64, 64, True, None),
     "bfloat16", True),
    ("S=1999 (no tile multiple), window 256", (1, 1999, 14, 2, 64, 64, True,
                                               256), "bfloat16", False),
    ("G=1, B=2, S=1024", (2, 1024, 4, 4, 64, 64, True, None), "bfloat16",
     False),
    ("G=7, f32 entry, B=1, S=1000", (1, 1000, 14, 2, 64, 64, True, None),
     "float32", False),
    ("Zamba2-7B training shape, B=4, S=2048, hd 112, G=1",
     (4, 2048, 32, 32, 112, 112, True, None), "bfloat16", True),
    ("MiniCPM3-4B training shape, B=4, S=2048, hd 96, vd 64, G=1",
     (4, 2048, 40, 40, 96, 64, True, None), "bfloat16", True),
    ("MLA smoke config's heads, B=2, S=300, hd 24, vd 16",
     (2, 300, 4, 4, 24, 16, True, None), "bfloat16", True),
    ("Mixtral-8x22B training shape, B=4, S=6144, hd 128, G=6, window 4096",
     MIXTRAL_BWD_SHAPE, "bfloat16", True),
    # the static entry at Granite-34B's heads (MQA, 48 query heads on one
    # KV head, hd 128), where every key's dk and dv sum 48 x Sq rows: 1,024
    # queries over 4,160 keys, not causal, and causal at S = 1,024
    ("Granite-34B heads, static entry, 1,024 over 4,160 keys, not causal",
     MQA_BWD_SHAPES[0], "bfloat16", False),
    ("Granite-34B heads, static entry, S=1024, causal", MQA_BWD_SHAPES[1],
     "bfloat16", False),
)
# the backward at the new families' training shapes (lm-train-encdec's
# encoder, unmasked, and its cross attention, Sq 1,024 over Skv 1,500;
# lm-train-vlm's causal 256 + 1,792 positions), timed, drawn from the
# FRONTEND_SEED generator after FRONTEND_ATTENTION_CHECKS
FRONTEND_BWD_CHECKS = (
    ("SeamlessM4T encoder training shape, B=4, S=1500, not causal",
     (4, 1500, 16, 16, 64, 64, False, None), "bfloat16", True),
    ("SeamlessM4T cross training shape, B=4, Sq=1024 over Skv=1500",
     (4, 1024, 16, 16, 64, 64, False, None, 1500), "bfloat16", True),
    ("InternVL2-2B training shape, B=4, S=2048, hd 128, G=2",
     (4, 2048, 16, 8, 128, 128, True, None), "bfloat16", True),
)
# Tolerances against the f64 plain versions on the same inputs (|err| <=
# atol + rtol |ref|).  lse: 1e-5 (a sum of exps in f32, log of it; the bf16
# kernel's ex2.approx adds 2^-22 relative).  The forward's f32 output: the
# f32 entry 1e-5 (ATTN_F32_TOL); the bf16 entry 2e-5, its P entering P.V as
# two bf16 terms (2^-17 relative each, times |v| up to about 4).  The
# gradients, of f32 sums over up to 14,336 (row, key) terms: atol 1e-5 of
# the gradient's largest element, rtol 1e-5 in f32; the bf16 entry computes
# in f32 from the exactly widened inputs and rounds each gradient once to
# bf16, at most 2^-8 = 3.9e-3 of its value, so rtol 5e-3.
BWD_LSE_TOL = 1e-5
BWD_OUT_TOL = {"float32": ATTN_F32_TOL, "bfloat16": 2e-5}
BWD_GRAD_ATOL = 1e-5        # times max |ref| of each gradient
BWD_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}
# the training phase: Qwen2-0.5B at full width and depth (its 151,936-id
# vocabulary, embedding and f32 logits), on a synthetic stream whose ids
# are drawn from the first TRAIN_DATA_VOCAB of them: over 30 steps of 8,192
# tokens each id then recurs about 60 times, where drawn over all 151,936
# it recurs 1.6 times and no learning rate from 1e-4 to 3e-3 moved the
# 30-step loss off 12.0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2048, 30, 10
TRAIN_DATA_VOCAB, TRAIN_LR, TRAIN_WARMUP = 4096, 1e-3, 5
# the kernel step against the plain one (bf16 activations: a bf16 rounding
# the two paths take apart moves a value by 2^-8 and the difference grows
# through 24 layers; the CPU smoke config measured 1.6e-3 to 3.4e-3
# relative L2 per leaf): loss within 1e-3 relative, grad norm within 1e-2,
# every leaf's gradient within 0.05 relative L2 (the bf16 tolerance of
# tests/test_arch_smoke.py)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL = 1e-3, 1e-2, 0.05
# a run resumed from the step-10 checkpoint against the first run at steps
# 11 and 12: the restored state is bitwise, the embedding's gradient
# (index_put with accumulation) is not bitwise on the card
TRAIN_RESUME_RTOL = 1e-4


def flash_bwd_bound(b, s, h, kv, hd, vd, causal, window, elt,
                    skv=None) -> dict:
    """The least device time of one backward call (Sq = ``s`` queries over
    ``skv`` keys, ``s`` by default): 2 (3 hd + 2 vd) operations per allowed
    (query, key) pair and head over the bf16 tensor-core peak, or its
    bytes (q, k, v, dq, dk, dv at ``elt`` bytes; O, dO and lse in f32,
    each once) over HBM's rate."""
    skv = s if skv is None else skv
    pairs = allowed_pairs(s, skv, causal, window)
    ops = 2 * (3 * hd + 2 * vd) * h * b * pairs
    nbytes = (2 * elt * (b * s * h * hd + b * skv * kv * (hd + vd))
              + 4 * (2 * b * s * h * vd + b * h * s))
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {"pairs": pairs, "operations": ops, "bytes": nbytes,
            "bound_ms": max(byte_s, op_s) * 1e3,
            "bound_by": "bytes" if byte_s >= op_s else "operations"}


def flash_fwd_lse_bound(b, s, skv, h, kv, hd, vd, causal, window,
                        elt) -> dict:
    """The least device time of the training forward (``return_lse``):
    :func:`attention_bound`'s operations, and its bytes with the output
    written in f32 and the lse (f32) beside it."""
    pairs = allowed_pairs(s, skv, causal, window)
    ops = 2 * (hd + vd) * h * b * pairs
    nbytes = (elt * (b * s * h * hd + b * skv * kv * (hd + vd))
              + 4 * (b * s * h * vd + b * h * s))
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(byte_s, op_s) * 1e3,
            "bound_by": "bytes" if byte_s >= op_s else "operations"}


def sdpa_fwd_bwd(q, k, v, dout, causal, window):
    """``scaled_dot_product_attention`` forward and backward (enable_gqa)
    on the same inputs, as one callable: the library yardstick.  A window
    goes in as an explicit boolean mask."""
    import torch.nn.functional as F

    mask = window_mask(q.shape[1], k.shape[1], window, q.device)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gt = dout.to(q.dtype).transpose(1, 2).contiguous()

    def call():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           is_causal=mask is None and causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), gt)
    return call


def check_flash_backward(tag, shape, dtype, rng, dev, timed,
                         strict=True) -> dict:
    """The forward with lse and the backward kernel against their plain
    versions in f64 on the card; on the training shape also their device
    times beside the plain backward, SDPA forward+backward and the
    bound.  ``strict=False`` reports the shares of the limits and the
    bitwise checks in the row instead of raising on them (the mutation
    check of ``tools/attention_mutants.py``)."""
    from repro_torch.kernels.flash_attention import kernel as FA

    b, _, h, kv, hd, vd = shape[:6]
    s, skv, causal, window = flash_dims(shape)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(dev, dt) for d in ((b, s, h, hd), (b, skv, kv, hd),
                                      (b, skv, kv, vd)))
    dout = torch.from_numpy(rng.standard_normal((b, s, h, vd)).astype(
        np.float32)).to(dev)
    opts = dict(causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **opts)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, **opts)
    torch.cuda.synchronize()
    row = {"phase": "flash-bwd-kernel", "shape": tag, "dims": list(shape),
           "dtype": dtype}
    ref_out, ref_lse = FA.flash_attention_plain(q, k, v, dtype=torch.float64,
                                                return_lse=True, q_block=512,
                                                kv_block=1024, **opts)
    shares = {}
    row["lse_max_abs_err"], shares["lse"] = max_excess(lse, ref_lse,
                                                       BWD_LSE_TOL)
    row["out_f32_max_abs_err"], shares["out_f32"] = max_excess(
        out, ref_out, BWD_OUT_TOL[dtype])
    del ref_out, ref_lse
    # the training launch's output, cast, is the serving launch's output
    row["out_bitwise_vs_no_lse_launch"] = bool(torch.equal(
        out.to(dt), FA.flash_attention(q, k, v, **opts)))
    refs = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        dtype=torch.float64, q_block=512,
                                        kv_block=1024, **opts)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        scale = float(r.abs().max())
        err, shares[name] = max_excess(g, r, BWD_GRAD_ATOL * scale,
                                       BWD_GRAD_RTOL[dtype])
        row[f"{name}_max_abs_err"], row[f"{name}_max_abs_ref"] = err, scale
        if g.dtype != dt or not bool(torch.isfinite(g).all()):
            if strict:
                raise AssertionError(f"flash backward, {tag}: {name} is "
                                     f"{g.dtype} or not finite")
            shares[name] = float("inf")
    del refs
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, **opts)
    row["bitwise_second_launch"] = all(
        torch.equal(x, y) for x, y in zip(grads, again))
    del again
    bwd = lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout, **opts)
    # the two passes, each one kernel node of a captured call
    row["kernel_nodes_per_call"] = graph_kernel_nodes(bwd)
    row["share_of_limit"] = shares
    row["tolerance"] = {
        "lse": BWD_LSE_TOL, "out_f32": BWD_OUT_TOL[dtype],
        "grads": {"atol": f"{BWD_GRAD_ATOL} * max|ref|",
                  "rtol": BWD_GRAD_RTOL[dtype]}}
    row["passes"] = (max(shares.values()) <= 1
                     and row["bitwise_second_launch"]
                     and row["out_bitwise_vs_no_lse_launch"]
                     and row["kernel_nodes_per_call"] == 2)
    if strict and not row["passes"]:
        raise AssertionError(f"flash backward, {tag}: {row}")
    row["max_abs_err"] = max(row[f"{n}_max_abs_err"]
                             for n in ("dq", "dk", "dv"))
    if timed:
        import torch.nn.functional as F

        # the training forward's yardstick: SDPA's forward alone
        mask = window_mask(s, skv, window, dev)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_fwd = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
            enable_gqa=True)
        row.update(
            kernel_ms=graph_ms(bwd),
            kernel_eager_ms=cuda_ms(bwd, reps=5),
            fwd_lse_ms=graph_ms(lambda: FA.flash_attention(
                q, k, v, return_lse=True, **opts)),
            fwd_ms=graph_ms(lambda: FA.flash_attention(q, k, v, **opts)),
            library_fwd_ms=graph_ms(sdpa_fwd),
            fwd_lse_bound=flash_fwd_lse_bound(b, s, skv, h, kv, hd, vd,
                                              causal, window,
                                              q.element_size()),
            plain_ms=graph_ms(lambda: FA.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, q_block=512, kv_block=1024,
                **opts), reps=3),
            library="scaled_dot_product_attention(enable_gqa=True) "
                    "forward + backward, eager",
            library_ms=cuda_ms(sdpa_fwd_bwd(q, k, v, dout, causal, window),
                               reps=10),
            timing="device time of 20 calls (plain: 3) replayed from one "
                   "CUDA graph; kernel_eager_ms and library_ms: eager calls "
                   "back to back between two events",
            **flash_bwd_bound(b, s, h, kv, hd, vd, causal, window,
                              q.element_size(), skv))
        row["kernel_fwd_lse_plus_bwd_ms"] = row["fwd_lse_ms"] + row[
            "kernel_ms"]
        row["roofline_share"] = row["bound_ms"] / row["kernel_ms"]
    return row


@contextlib.contextmanager
def plain_training_attention():
    """Within this block a training call of the model's attention runs
    autograd through ``flash_attention_plain``, on any device: the step
    the kernel step is held against."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import layers as L

    saved = L.flash_attention_differentiable
    L.flash_attention_differentiable = (
        lambda q, k, v, **kw: flash_attention_plain(q, k, v, **kw))
    try:
        yield
    finally:
        L.flash_attention_differentiable = saved


def flat_tree(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_tree(tree[k], f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        return flat_tree(tree._asdict(), prefix)
    return {prefix: tree}


def lm_train_path(dev, on_checkpoint=None) -> tuple:
    """Train Qwen2-0.5B at full width and depth on the card
    (``SyntheticLMData(lag=1)`` over TRAIN_DATA_VOCAB ids, B = 4, S = 2048,
    AdamW, remat, the cosine schedule) through the donated
    ``make_train_step``, ``RestartableLoop`` and
    ``CheckpointManager``: one step's gradients with the kernels against
    the same step through the plain attention, TRAIN_STEPS steps whose
    loss must fall, and a resume from the step-10 checkpoint;
    ``on_checkpoint(ckpt, step)``, if given, then gets the checkpoint
    manager and that step, before the checkpoints are removed.  Returns
    (rows, launch counts of the TRAIN_STEPS-step run)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           shard_batch)
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.params import init_params, param_count_actual
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import LoopConfig, RestartableLoop
    from repro_torch.train.optimizer import adamw_init, cosine_schedule
    from repro_torch.train.step import make_train_step

    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    # what earlier phases still hold on the card, apart from training's own
    held_before_gb = torch.cuda.memory_allocated() / 1e9
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    data = SyntheticLMData(DataConfig(TRAIN_DATA_VOCAB, TRAIN_SEQ,
                                      TRAIN_BATCH, seed=SEED, lag=1),
                           host_batch=TRAIN_BATCH)
    rows = []

    # -- one step's gradients: kernels against the plain attention --------
    cmp_row, _ = train_grads_vs_plain("lm-train-vs-plain", params, cfg,
                                      shard_batch(data.batch_at(0), dev))
    rows.append(cmp_row)
    torch.cuda.empty_cache()

    # -- TRAIN_STEPS steps with checkpoints ---------------------------------
    # each step writes into the state it is given (the checkpoint's host
    # copy is taken before the next step)
    step_fn = make_train_step(cfg, learning_rate=cosine_schedule(
        TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS), remat=True)
    losses, snap = {}, {}

    def one_step(state, step):
        batch = shard_batch(data.batch_at(step), dev)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        losses[step] = float(metrics["loss"])
        out = {"params": p, "opt": o}
        if step == TRAIN_CKPT_EVERY:
            # a host copy of what the loop saves at this step
            snap["state"] = {k: t.cpu() for k, t in flat_tree(out).items()}
        return out

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = CheckpointManager(tmp, keep_last_k=3)
        loop = RestartableLoop(ckpt, LoopConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
            log_every=0), log=lambda s: None)
        # the loop holds the only reference to the state
        held = [{"params": params, "opt": adamw_init(params)}]
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        FA.flash_attention.lse_launches = 0
        t0 = time.perf_counter()
        state = loop.run(held.pop(), one_step, start_step=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts = launch_counts()
        lse_launches = FA.flash_attention.lse_launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update(flash_attention=2 * layers * TRAIN_STEPS,
                    flash_attention_bwd=layers * TRAIN_STEPS)
        if run_counts != want or lse_launches != 2 * layers * TRAIN_STEPS:
            raise AssertionError(f"{TRAIN_STEPS} steps launched "
                                 f"{run_counts} (lse {lse_launches}), "
                                 f"expected {want}")
        curve = [losses[i] for i in range(TRAIN_STEPS)]
        first, last = np.mean(curve[:5]), np.mean(curve[-5:])
        times = loop.timer.history
        step_s = float(np.median(times[1:]))
        rows.append({
            "phase": "lm-train", "model": cfg.name,
            "params": param_count_actual(cfg), "layers": layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
            "activation_dtype": cfg.activation_dtype, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "data_vocab": TRAIN_DATA_VOCAB,
            "steps": TRAIN_STEPS, "remat": True,
            "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "losses": curve,
            "mean_loss_first_5": float(first),
            "mean_loss_last_5": float(last), "wall_s": wall,
            "step_s_first": times[0], "step_s_median": step_s,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "timer": loop.timer.summary(), "peak_memory_gb": peak_gb,
            "held_by_earlier_phases_gb": held_before_gb,
            "peak_memory_own_gb": peak_gb - held_before_gb,
            "launches": run_counts,
            "launches_per_step": {
                "flash_attention": run_counts["flash_attention"]
                / TRAIN_STEPS, "flash_attention_lse": lse_launches
                / TRAIN_STEPS, "flash_attention_bwd":
                run_counts["flash_attention_bwd"] / TRAIN_STEPS},
            "timing": "host clock around each step, which ends in a read "
                      "of the loss (a sync); the median leaves out step 0 "
                      "and the checkpoint snapshots, which run after the "
                      "step's clock stops"})
        if not last < first:
            raise AssertionError(f"loss did not fall: {curve}")

        # -- restore step 10 into fresh tensors and resume ------------------
        ckpt.wait()
        t0 = time.perf_counter()
        restored = ckpt.restore(TRAIN_CKPT_EVERY, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del state
        flat_r = flat_tree(restored)
        bitwise = all(torch.equal(flat_r[k].cpu(), t)
                      for k, t in snap["state"].items())
        if not bitwise or sorted(flat_r) != sorted(snap["state"]):
            bad = [k for k, t in snap["state"].items()
                   if k not in flat_r or not torch.equal(flat_r[k].cpu(), t)]
            raise AssertionError(f"the step-10 checkpoint does not restore "
                                 f"bitwise: {bad[:5]}, keys "
                                 f"{sorted(set(flat_r) ^ set(snap['state']))}")
        del snap["state"]
        resumed = {}
        state = restored
        for step in (TRAIN_CKPT_EVERY + 1, TRAIN_CKPT_EVERY + 2):
            first_run = losses[step]
            state = one_step(state, step)
            resumed[step] = losses[step]
            losses[step] = first_run
        diffs = {s: abs(resumed[s] - losses[s]) / abs(losses[s])
                 for s in resumed}
        rows.append({"phase": "lm-train-resume",
                     "checkpoint_step": TRAIN_CKPT_EVERY,
                     "checkpoint_steps_kept": ckpt.all_steps(),
                     "restore_s": restore_s, "restored_bitwise": True,
                     "losses_first_run": {s: losses[s] for s in resumed},
                     "losses_resumed": resumed,
                     "rel_diff": diffs,
                     "bitwise": {s: resumed[s] == losses[s] for s in resumed},
                     "tolerance": TRAIN_RESUME_RTOL})
        if max(diffs.values()) > TRAIN_RESUME_RTOL:
            raise AssertionError(f"the resumed run disagrees: {rows[-1]}")
        del state, restored
        if on_checkpoint is not None:
            torch.cuda.empty_cache()
            on_checkpoint(ckpt, TRAIN_CKPT_EVERY)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return rows, run_counts


def train_grads_vs_plain(phase, params, cfg, batch, *,
                         share: float = 1.0) -> tuple:
    """One step's loss and gradients (``loss_and_grads``, remat) through
    the attention kernels against the same step through the plain
    attention (:func:`plain_training_attention`): loss, grad norm, and
    the worst leaf's gradient in relative L2, each within ``share`` times
    TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL or TRAIN_GRAD_RTOL.  A control, the
    plain step again at half the tiles (its f32 sums in another order),
    is reported beside them: the model's own drift on the same batch,
    which a depth fit for the comparison keeps well under the limits.
    The kernel step
    must launch exactly 2 flash forwards with lse per attention call
    (remat recomputes each) and 1 backward call, the plain steps none.
    An MoE model's plain steps take the kernel step's routes
    (:func:`forced_routes`, queue 3 item 9); the row counts the tokens
    whose own routes differ but asserts on the gradients.  The kernel
    step's gradients wait on the host while the plain steps run.  Returns
    (row, the kernel step's launch counts)."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.transformer import attention_calls
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import loss_and_grads

    calls = attention_calls(cfg)
    record = []
    t0 = time.perf_counter()
    reset_launch_counts()
    FA.flash_attention.lse_launches = 0
    with recorded_routes(record):
        loss_k, _, grads_k = loss_and_grads(params, cfg, batch, remat=True)
    gn_k = float(global_norm(grads_k))
    counts = launch_counts()
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(flash_attention=2 * calls, flash_attention_bwd=calls)
    if counts != want or FA.flash_attention.lse_launches != 2 * calls:
        raise AssertionError(f"{cfg.name}: a training step launched {counts} "
                             f"(lse {FA.flash_attention.lse_launches}), "
                             f"expected {want}")
    kernel_leaves = {k: g.cpu() for k, g in flat_tree(grads_k).items()}
    del grads_k
    # an encoder's gradients arrive only through cross attention's dk, dv
    encoder_norms = {k: float(g.float().norm())
                     for k, g in kernel_leaves.items()
                     if k.startswith("/encoder/")}
    if not all(np.isfinite(n) and n > 0 for n in encoder_norms.values()):
        raise AssertionError(f"{cfg.name}: an encoder leaf's gradient is "
                             f"zero or not finite: {encoder_norms}")

    def plain_step(c, flips):
        routes = (forced_routes(record, flips) if cfg.moe is not None
                  else contextlib.nullcontext())
        with plain_training_attention(), routes:
            loss, _, grads = loss_and_grads(params, c, batch, remat=True)
        return float(loss), float(global_norm(grads)), flat_tree(grads)

    flips = []
    loss_p, gn_p, plain = plain_step(cfg, flips)
    rel = {k: float((kernel_leaves.pop(k).to(g.device).float() - g.float())
                    .norm() / g.float().norm().clamp_min(1e-30))
           for k, g in plain.items()}
    half = dataclasses.replace(cfg, q_block=cfg.q_block // 2,
                               kv_block=cfg.kv_block // 2)
    loss_c, gn_c, control = plain_step(half, [])
    rel_c = {k: float((control.pop(k).float() - g.float()).norm()
                      / g.float().norm().clamp_min(1e-30))
             for k, g in plain.items()}
    del plain, control, record
    torch.cuda.synchronize()
    if launch_counts() != counts:
        raise AssertionError(f"{cfg.name}: a plain training step launched "
                             f"a kernel")
    diff = lambda a, b: abs(a - b) / abs(b)
    readings = {"loss": diff(float(loss_k), loss_p),
                "grad_norm": diff(gn_k, gn_p)}
    controls = {"loss": diff(loss_c, loss_p), "grad_norm": diff(gn_c, gn_p)}
    limits = {"loss": share * TRAIN_LOSS_RTOL,
              "grad_norm": share * TRAIN_GNORM_RTOL,
              "grad_rel_l2": share * TRAIN_GRAD_RTOL}
    # the gradients' reading is the worst leaf's, as the control's
    worst, worst_c = max(rel, key=rel.get), max(rel_c, key=rel_c.get)
    readings["grad_rel_l2"] = rel[worst]
    controls["grad_rel_l2"] = rel_c[worst_c]
    row = {"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
           "activation_dtype": cfg.activation_dtype,
           "batch": batch["tokens"].shape[0],
           "seq": batch["tokens"].shape[1],
           "loss_kernel": float(loss_k), "loss_plain": loss_p,
           "loss_control": loss_c, "loss_rel_diff": readings["loss"],
           "grad_norm_kernel": gn_k, "grad_norm_plain": gn_p,
           "grad_norm_control": gn_c,
           "grad_norm_rel_diff": readings["grad_norm"],
           "control_rel_diff": controls, "grad_rel_l2": rel,
           "grad_rel_l2_control": rel_c, "worst_leaf": worst,
           "worst_leaf_control": worst_c, "tolerance": limits,
           "share_of_tolerance": {k: readings[k] / limits[k]
                                  for k in readings},
           "control_share_of_tolerance": {k: controls[k] / limits[k]
                                          for k in controls},
           "launches_kernel_step": counts,
           "wall_s": time.perf_counter() - t0}
    if encoder_norms:
        row.update(encoder_grad_norm_kernel=encoder_norms,
                   encoder_grad_rel_l2={k: rel[k] for k in encoder_norms})
    if cfg.moe is not None:
        row.update(forced_route_calls=len(flips),
                   routes_the_plain_step_would_flip=int(sum(flips)),
                   token_routes=int(len(flips) * batch["tokens"].numel()))
    if any(readings[k] > limits[k] for k in readings):
        raise AssertionError(f"{cfg.name}: the kernel step disagrees with "
                             f"the plain step: {row}")
    return row, counts


# ---- training the MoE, SSM, hybrid and MLA families at full width -------
# (phase, arch, layers kept of the published depth, batch, seq); widths as
# published, the depth cut so that the donated step (about 16 bytes a
# parameter, and the activations) fits the card's 80 GB; Mixtral's 6,144
# positions run past its 4,096-token window, as its serving phase's
# prompts, four sequences a step: at one, its loss spiked under every
# rate that moved it
FAMILY_TRAINING = (
    ("lm-train-moe", "mixtral_8x22b", 1, 4, 6144),
    ("lm-train-ssm", "mamba2_2_7b", 64, 4, 2048),
    ("lm-train-hybrid", "zamba2_7b", 36, 4, 2048),
    ("lm-train-mla", "minicpm3_4b", 40, 4, 2048),
)
# every family trains at the dense phase's TRAIN_LR on launch/train.py's
# schedule: FAMILY_WARMUP steps of linear warm-up from 0, then half a
# cosine down to 0 at FAMILY_TRAIN_STEPS
FAMILY_TRAIN_STEPS, FAMILY_WARMUP = 10, 3
# the hybrid's bf16 comparison runs at FAMILY_CMP_HYBRID_LAYERS (of them
# every sixth the shared block's application), where the model's own
# drift (the control) stays under 2/3 of the limits; at the 36 layers it
# trains at, two correct bf16 paths differ by about 5% in every gradient
FAMILY_CMP_HYBRID_LAYERS = 12
# the bf16 comparison takes the first FAMILY_CMP_TOKENS // seq rows of the
# batch (at least one): the plain step keeps every tile's scores for its
# backward, B·S² of them
FAMILY_CMP_TOKENS = 8192
# the f32 comparison of each family: 2 layers (the hybrid 6, one
# application of its shared block), B = 1, S = 1,024, through the kernels'
# f32 entries, at 1% of the bf16 limits, as lm-f32-replay holds the served
# families
FAMILY_F32_LAYERS, FAMILY_F32_BATCH, FAMILY_F32_SEQ = 2, 1, 1024
FAMILY_F32_HYBRID_LAYERS, FAMILY_F32_SHARE = 6, 0.01
# bytes a parameter the AdamW step holds at its update, f32 parameters:
# donated p, g, m, v; functional also the new p, m and v
DONATED_BYTES, FUNCTIONAL_BYTES = 16, 28
# the donated step's peak may pass the backward's own peak (measured
# before the moments exist) plus the moments' 8 bytes a parameter by the
# update's temporaries: ten f32 slices of DONATE_SLICE_ELEMENTS
DONATE_UPDATE_TEMPS = 10


@contextlib.contextmanager
def timed_flash_backward(events: list):
    """Within this block each ``FlashAttention`` backward (the dO cast and
    the kernel's two passes) records a pair of CUDA events around itself
    on the current stream and appends it to ``events``."""
    from repro_torch.kernels.flash_attention.kernel import FlashAttention

    backward = FlashAttention.backward

    def timed(ctx, dout):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = backward(ctx, dout)
        end.record()
        events.append((start, end))
        return out

    FlashAttention.backward = staticmethod(timed)
    try:
        yield
    finally:
        FlashAttention.backward = staticmethod(backward)


def lm_train_family_path(phase, arch, layers, batch, seq, dev) -> tuple:
    """Train an MoE, SSM, hybrid, MLA, encoder-decoder or vision model at
    full width with its depth cut (f32 parameters, bf16 activations,
    ``SyntheticLMData(lag=1)`` over TRAIN_DATA_VOCAB ids, with a
    frontend's inputs (:class:`FrontendData`), remat) through
    ``make_train_step``: one step's gradients with the kernels against the
    plain attention before any optimizer state exists (the rows of the
    batch that hold at most FAMILY_CMP_TOKENS positions, frames and
    patches counted, the hybrid at FAMILY_CMP_HYBRID_LAYERS); the
    same in an f32 model at FAMILY_F32_*; then :func:`train_family_steps`.
    Returns (rows, launch counts of the donated steps)."""
    import dataclasses

    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           shard_batch)
    from repro_torch.models.params import init_params

    t_phase = time.perf_counter()
    seed = lambda: torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # -- one step's gradients: kernels against the plain attention --------
    cfg, reduced = family_config(arch, layers)
    cmp_cfg, cmp_reduced = (family_config(arch, FAMILY_CMP_HYBRID_LAYERS)
                            if cfg.family == "hybrid" else (cfg, reduced))
    data = FrontendData(cfg, SyntheticLMData(DataConfig(
        TRAIN_DATA_VOCAB, seq, batch, seed=SEED, lag=1), host_batch=batch))
    params = init_params(cmp_cfg, seed(), dev)
    rows_cmp = max(1, FAMILY_CMP_TOKENS // (seq + data.extra_positions))
    row, _ = train_grads_vs_plain(f"{phase}-vs-plain", params, cmp_cfg,
                                  shard_batch({k: v[:rows_cmp] for k, v in
                                               data.batch_at(0).items()},
                                              dev))
    row["reduced"] = cmp_reduced
    rows.append(row)
    del params
    torch.cuda.empty_cache()

    # -- the same in an f32 model through the kernels' f32 entries ---------
    f32_layers = (FAMILY_F32_HYBRID_LAYERS if cfg.family == "hybrid"
                  else FAMILY_F32_LAYERS)
    cfg32 = dataclasses.replace(family_config(arch, f32_layers)[0],
                                activation_dtype="float32")
    data32 = FrontendData(cfg32, SyntheticLMData(DataConfig(
        TRAIN_DATA_VOCAB, FAMILY_F32_SEQ, FAMILY_F32_BATCH, seed=SEED,
        lag=1), host_batch=FAMILY_F32_BATCH))
    params = init_params(cfg32, seed(), dev)
    row, _ = train_grads_vs_plain(f"{phase}-f32-vs-plain", params, cfg32,
                                  shard_batch(data32.batch_at(0), dev),
                                  share=FAMILY_F32_SHARE)
    rows.append(row)
    del params
    torch.cuda.empty_cache()

    row, counts = train_family_steps(phase, cfg, reduced, data, dev)
    row["wall_s"] = time.perf_counter() - t_phase
    rows.append(row)
    return rows, counts


def train_family_steps(phase, cfg, reduced, data, dev) -> tuple:
    """FAMILY_TRAIN_STEPS donated steps of ``make_train_step`` from a
    model made from SEED, at TRAIN_LR on ``cosine_schedule`` with
    FAMILY_WARMUP steps of warm-up.  Before them, the untrained model's
    loss on each of the run's batches, and the peak memory of one step's
    ``loss_and_grads`` before the moments exist (the backward's own:
    parameters, gradients, activations).

    Checks: the launches are exact; the loss falls, the last step's below
    the untrained model's on the same batch by more than the untrained
    losses' spread over the batches (max - min); each step's peak stays
    under the card's memory and under the backward's own peak plus the
    moments (8 bytes a parameter) plus the update's temporaries
    (DONATE_UPDATE_TEMPS f32 slices), which a functional update (28 bytes
    a parameter) would pass by about 12 bytes a parameter.  Reports
    each step's time, tokens/s, peak and backward device time a call.
    Returns (row, launch counts of the steps)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.params import init_params, param_count_actual
    from repro_torch.models.transformer import attention_calls
    from repro_torch.train import optimizer as TO
    from repro_torch.train.step import (loss_and_grads, make_eval_step,
                                        make_train_step)

    calls = attention_calls(cfg)
    batch, seq = data.cfg.global_batch, data.cfg.seq_len
    lr, steps, warmup = TRAIN_LR, FAMILY_TRAIN_STEPS, FAMILY_WARMUP
    held_before_gb = torch.cuda.memory_allocated() / 1e9
    n_params = param_count_actual(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    evaluate = make_eval_step(cfg)
    untrained = [float(evaluate(params, shard_batch(data.batch_at(step),
                                                    dev))["loss"])
                 for step in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grads = loss_and_grads(params, cfg, shard_batch(data.batch_at(0), dev),
                           remat=True)
    torch.cuda.synchronize()
    backward_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del grads
    state = TO.adamw_init(params)
    state_gb = sum(t.numel() * t.element_size() for t in TO.tree_leaves(
        [params, state.mu, state.nu])) / 1e9
    moments_gb = 2 * 4 * n_params / 1e9
    temps_gb = DONATE_UPDATE_TEMPS * 4 * TO.DONATE_SLICE_ELEMENTS / 1e9
    peak_bound_gb = backward_peak_gb + moments_gb + temps_gb
    step_fn = make_train_step(cfg, learning_rate=TO.cosine_schedule(
        lr, warmup, steps), remat=True)
    reset_launch_counts()
    FA.flash_attention.lse_launches = 0
    losses, lrs, gnorms, step_s, peaks, bwd_ms = [], [], [], [], [], []
    for step in range(steps):
        b = shard_batch(data.batch_at(step), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        t0 = time.perf_counter()
        with timed_flash_backward(events):
            params, state, metrics = step_fn(params, state, b)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        lrs.append(float(metrics["lr"]))
        gnorms.append(float(metrics["grad_norm"]))
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        bwd_ms.append(float(np.mean([s.elapsed_time(e) for s, e in events]))
                      if events else None)
        if len(events) != calls:
            raise AssertionError(f"{cfg.name}: step {step} made "
                                 f"{len(events)} backward calls, expected "
                                 f"{calls}")
    counts = launch_counts()
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(flash_attention=2 * calls * steps,
                flash_attention_bwd=calls * steps)
    lse = FA.flash_attention.lse_launches
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    step_median = float(np.median(step_s[1:]))
    spread = max(untrained) - min(untrained)
    row = {"phase": phase, "model": cfg.name, "reduced": reduced,
           "params": n_params, "layers": cfg.num_layers,
           "attention_calls": calls, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
           "activation_dtype": cfg.activation_dtype, "batch": batch,
           "seq": seq, "data_vocab": TRAIN_DATA_VOCAB, "steps": steps,
           "remat": True, "donate": True, "lr": lr, "warmup": warmup,
           "lr_by_step": lrs, "losses": losses, "grad_norm_by_step": gnorms,
           "untrained_losses": untrained, "untrained_spread": spread,
           "fall_below_untrained": untrained[-1] - losses[-1],
           "step_s": step_s, "step_s_median": step_median,
           "tokens_per_s": batch * seq / step_median,
           "tokens_per_s_by_step": [batch * seq / t for t in step_s],
           "frontend_positions": data.extra_positions,
           "positions_per_s": batch * (seq + data.extra_positions)
           / step_median,
           "peak_memory_gb_by_step": peaks, "peak_memory_gb": max(peaks),
           "card_memory_gb": card_gb,
           "held_by_earlier_phases_gb": held_before_gb,
           "params_moments_gb": state_gb,
           "backward_peak_gb": backward_peak_gb,
           "activations_gb": backward_peak_gb - held_before_gb
           - 2 * 4 * n_params / 1e9,
           "peak_bound_gb": peak_bound_gb,
           "donated_estimate_gb": DONATED_BYTES * n_params / 1e9,
           "functional_estimate_gb": FUNCTIONAL_BYTES * n_params / 1e9,
           "bwd_device_ms_per_call_by_step": bwd_ms,
           "launches": counts, "launches_per_step": {
               "flash_attention": counts["flash_attention"] / steps,
               "flash_attention_lse": lse / steps,
               "flash_attention_bwd": counts["flash_attention_bwd"] / steps},
           "timing": "host clock around each step, which ends in a read of "
                     "the loss (a sync); the median leaves out step 0; "
                     "the backward's device time between CUDA events "
                     "around each FlashAttention backward (the dO cast "
                     "and the kernel's two passes)"}
    del params, state, metrics
    torch.cuda.empty_cache()
    if counts != want or lse != want["flash_attention"]:
        raise AssertionError(f"{cfg.name}: {steps} steps launched {counts} "
                             f"(lse {lse}), expected {want}")
    peak = max(peaks)
    if not (losses[-1] < losses[0]
            and untrained[-1] - losses[-1] > spread):
        raise AssertionError(f"{cfg.name}: loss did not fall by more than "
                             f"the batches' spread {spread:.4f}: {losses}, "
                             f"untrained {untrained}, grad norms {gnorms}")
    if not peak < min(card_gb, peak_bound_gb):
        raise AssertionError(f"{cfg.name}: peak {peak:.2f} GB is not under "
                             f"the card's {card_gb:.2f} GB and the "
                             f"backward's {backward_peak_gb:.2f} GB plus the "
                             f"moments and the update's temporaries "
                             f"({peak_bound_gb:.2f} GB)")
    return row, counts


# analysis gates: program outputs on the card against the CPU run of the
# same program (kernels against plain versions at the catalog's shapes;
# sums over about eight edges a row)
ANALYSIS_RTOL, ANALYSIS_ATOL = 1e-5, 1e-6


# ---- Granite-34B and Yi-9B served whole, blocked_attention's dynamic
# offsets, the sharding substrate of training ----------------------------
# every row below draws from a generator of its own, so that the rows
# before them read what they read before these were added
GRANITE_YI_SEED = SEED + 29
# the attention kernels at the two dense models' serving shapes: MQA
# (Granite-34B: 48 query heads on 1 KV head, whose decode takes six row
# chunks of 8 heads, each reading the cache) and GQA (Yi-9B: 32 on 4),
# hd 128
DENSE_ATTENTION_CHECKS = (
    ("Granite-34B causal prefill, B=1, S=4096, MQA 48/1, hd 128", "flash",
     (1, 4096, 48, 1, 128, 128, True, None)),
    ("Yi-9B causal prefill, B=1, S=4096, 32/4, hd 128", "flash",
     (1, 4096, 32, 4, 128, 128, True, None)),
    ("Granite-34B decode over a full 4160-slot cache, B=4, G=48", "decode",
     (4, 4160, 48, 1, 128, 128, 4160)),
    ("Yi-9B decode over a full 4160-slot cache, B=4, G=8", "decode",
     (4, 4160, 32, 4, 128, 128, 4160)),
)
# (phase, arch): both whole at their published widths, 8 requests of
# 4,096 prompt and 32 new tokens on 4 slots over a 4,160-slot cache
DENSE_SERVING = (("lm-serve-granite", "granite_34b"),
                 ("lm-serve-yi", "yi_9b"))
DENSE_SHAPE = dict(requests=8, slots=4, prompt_len=4096, new_tokens=32,
                   max_len=4160)
# blocked_attention's dynamic offsets through the flash kernels' dynamic
# entries: (tag, (B, Sq, Skv, H, KV, hd, causal, window), (q_offset,
# kv_offset, kv_valid_len)) at Qwen2-0.5B's heads (14/2 x 64) and
# Granite-34B's (48/1 x 128); Skv a multiple of the bf16 kernels' 64-key
# tile and no multiple, kv_valid_len inside the last tile each time
DYNAMIC_CHECKS = (
    ("Qwen2-0.5B heads, 512 queries at 3,584 over 4,096 keys, valid 4,070",
     (1, 512, 4096, 14, 2, 64, True, None), (3584, 0, 4070)),
    ("Qwen2-0.5B heads, 256 queries at 5,000 over 3,001 keys at 2,200, "
     "window 1,024, valid 5,190", (2, 256, 3001, 14, 2, 64, True, 1024),
     (5000, 2200, 5190)),
    ("Granite-34B heads, 1,024 queries at 3,136 over 4,160 keys, valid "
     "4,100", (1, 1024, 4160, 48, 1, 128, True, None), (3136, 0, 4100)),
    ("Granite-34B heads, not causal, 128 queries over 2,500 keys at 100, "
     "valid 2,598", (1, 128, 2500, 48, 1, 128, False, None),
     (0, 100, 2598)),
)
# the sharding phase's limits: compressed_mean on one rank sends each
# leaf's int8 rounding, so mean + new error = g to f32 rounding (the sum
# of two f32 values of up to |g|: 2^-23 of the largest, doubled), and the
# mean is within one int8 step of g, max |block| / 127 <= max |g| / 100
SHARD_ERR_RTOL = 2 * 2.0 ** -23
SHARD_MEAN_SHARE = 1e-2


def lm_serve_dense_path(phase, arch, dev, rng) -> tuple:
    """A dense model whole at full width (:func:`serve_path` at
    DENSE_SHAPE), its weights drawn in f32 and stored in bf16 (the engine's
    dtype: the numbers an f32 tree would cast to; Granite-34B's two
    stacked MLP leaves a layer at a time, ``SLICED_INIT_ELEMENTS``), then
    wave 0 replayed through the plain attention versions
    (:func:`lm_teacher_forced`).  Returns (rows, counts)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    held_gb = torch.cuda.memory_allocated() / 1e9
    row, engine, prompts, counts = serve_path(phase, cfg, dev=dev, rng=rng,
                                              **DENSE_SHAPE)
    weight_bytes = sum(t.numel() * t.element_size()
                       for name, t in flat_tree(engine.params).items()
                       if name != "/embed/tok" or cfg.tie_embeddings)
    row.update(param_dtype=cfg.param_dtype, d_ff=cfg.d_ff,
               head_dim=cfg.resolved_head_dim,
               mlp="gated (SwiGLU)" if cfg.mlp_gated else "GELU, ungated",
               held_by_earlier_phases_gb=held_gb,
               weight_bytes=weight_bytes,
               decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S
               * 1e3,
               weight_bound_note="every weight a decode step reads (the "
                                 "embedding table but its gathered rows) "
                                 "over HBM's rate")
    replay = lm_teacher_forced(engine, prompts, dev)
    del engine
    torch.cuda.empty_cache()
    return [row, replay], counts


def dynamic_allowed(sq, skv, causal, window, offsets, dev):
    """The (Sq, Skv) boolean mask of a dynamic-offset call: query ``i`` at
    ``q_offset + i``, key ``j`` at ``kv_offset + j``, keys ``j < Skv`` and
    at positions below ``kv_valid_len``."""
    q_off, kv_off, valid = offsets
    i = q_off + torch.arange(sq, device=dev)[:, None]
    kpos = kv_off + torch.arange(skv, device=dev)[None, :]
    ok = kpos < valid
    if causal:
        ok = ok & (kpos <= i)
    if window is not None:
        ok = ok & (kpos > i - window)
    return ok


def check_dynamic_attention(tag, shape, offsets, dtype, rng, dev,
                            timed) -> dict:
    """One dynamic-offset call through the model's entry point
    (``models.layers.blocked_attention`` under autograd, the offsets 0-d
    int32 tensors on the card) and its backward: the layer's output and
    gradients bitwise those of the dynamic wrappers called directly, whose
    f32 output, lse and gradients are held against the f64 plain versions
    at the flash backward's limits (``check_flash_backward``), and the
    host reads of the driven call counted (CUDA's sync debug mode: none
    may happen).  Timed rows add each entry's device time beside its
    bound, the plain version and ``scaled_dot_product_attention`` with the
    same mask.  Returns the row, with ``driven_launches`` (the entry
    point's own launches, before any check's)."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import layers as L

    b, sq, skv, h, kv, hd, causal, window = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(dev, dt) for d in ((b, sq, h, hd), (b, skv, kv, hd),
                                      (b, skv, kv, hd)))
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(
        np.float32)).to(dev)
    offs = FA.Offsets(*(torch.tensor(x, dtype=torch.int32, device=dev)
                        for x in offsets))
    opts = dict(causal=causal, window=window)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def driven():
        out = L.blocked_attention(qg, kg, vg, q_offset=offs.q_offset,
                                  kv_offset=offs.kv_offset,
                                  kv_valid_len=offs.kv_valid_len, **opts)
        out.backward(dout.to(dt))
        return out

    torch.cuda.synchronize()
    before = launch_counts()
    layer_out, syncs = count_syncs(driven)
    torch.cuda.synchronize()
    driven_launches = {n: c - before[n] for n, c in launch_counts().items()}
    if syncs:
        raise AssertionError(f"dynamic attention, {tag}: the call read the "
                             f"host at {syncs}")
    # the layer's backward casts dO to f32 as FlashAttention does
    out, lse = FA.flash_attention_dynamic(q, k, v, offs, **opts)
    grads = FA.flash_attention_bwd_dynamic(
        q, k, v, out, lse, dout.to(dt).float(), offs, **opts)
    again = FA.flash_attention_dynamic(q, k, v, offs, **opts)
    # the forward's kernel nodes, past those that stack the offsets
    fwd_nodes = (graph_kernel_nodes(
        lambda: FA.flash_attention_dynamic(q, k, v, offs, **opts))
        - graph_kernel_nodes(lambda: FA.offsets_tensor(offs, q.device)))
    row = {"phase": "attention-dynamic", "shape": tag, "dims": list(shape),
           "offsets": list(offsets), "dtype": dtype,
           "host_reads": len(syncs), "driven_launches": driven_launches,
           "layer_bitwise_vs_wrappers": bool(
               torch.equal(layer_out, out.to(dt))
               and all(torch.equal(t.grad, g)
                       for t, g in zip((qg, kg, vg), grads))),
           "fwd_run_to_run_bitwise": bool(
               torch.equal(out, again[0]) and torch.equal(lse, again[1])),
           "fwd_kernel_nodes_per_call": fwd_nodes}
    del again
    ref_out, ref_lse = FA.flash_attention_plain(
        q, k, v, dtype=torch.float64, return_lse=True, q_block=512,
        kv_block=1024, offsets=offs, **opts)
    shares = {}
    row["lse_max_abs_err"], shares["lse"] = max_excess(lse, ref_lse,
                                                       BWD_LSE_TOL)
    row["out_f32_max_abs_err"], shares["out_f32"] = max_excess(
        out, ref_out, BWD_OUT_TOL[dtype])
    del ref_out, ref_lse
    refs = FA.flash_attention_bwd_plain(
        q, k, v, out, lse, dout.to(dt).float(), dtype=torch.float64,
        q_block=512, kv_block=1024, offsets=offs, **opts)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        scale = float(r.abs().max())
        err, shares[name] = max_excess(g, r, BWD_GRAD_ATOL * scale,
                                       BWD_GRAD_RTOL[dtype])
        row[f"{name}_max_abs_err"], row[f"{name}_max_abs_ref"] = err, scale
        if g.dtype != dt or not bool(torch.isfinite(g).all()):
            shares[name] = float("inf")
    del refs
    row.update(share_of_limit=shares, tolerance={
        "lse": BWD_LSE_TOL, "out_f32": BWD_OUT_TOL[dtype],
        "grads": {"atol": f"{BWD_GRAD_ATOL} * max|ref|",
                  "rtol": BWD_GRAD_RTOL[dtype]}},
        max_abs_err=max(row[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv")),
        fwd_max_abs_err=row["out_f32_max_abs_err"])
    if (max(shares.values()) > 1 or not row["layer_bitwise_vs_wrappers"]
            or not row["fwd_run_to_run_bitwise"] or fwd_nodes != 1):
        raise AssertionError(f"dynamic attention, {tag}: {row}")
    if timed:
        import torch.nn.functional as F

        mask = dynamic_allowed(sq, skv, causal, window, offsets, dev)
        pairs = int(mask.sum()) * b
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_fwd = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        qr, kr, vr = (t.clone().requires_grad_() for t in (qt, kt, vt))
        gt = dout.to(dt).transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qr, kr, vr), gt)

        fwd = lambda: FA.flash_attention_dynamic(q, k, v, offs, **opts)
        bwd = lambda: FA.flash_attention_bwd_dynamic(
            q, k, v, out, lse, dout, offs, **opts)
        elt = q.element_size()
        fwd_ops = 2 * 2 * hd * h * pairs
        fwd_bytes = (elt * (b * sq * h * hd + 2 * b * skv * kv * hd)
                     + 4 * (b * sq * h * hd + b * h * sq))
        bwd_ops = 2 * 5 * hd * h * pairs
        bwd_bytes = (2 * elt * (b * sq * h * hd + 2 * b * skv * kv * hd)
                     + 4 * (2 * b * sq * h * hd + b * h * sq))
        bound = lambda nbytes, ops: {
            "bytes": nbytes, "operations": ops,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / BF16_FLOPS else "operations")}
        row.update(
            pairs=pairs,
            fwd={"kernel_ms": graph_ms(fwd), "kernel_eager_ms": cuda_ms(fwd),
                 "plain_ms": graph_ms(lambda: FA.flash_attention_plain(
                     q, k, v, return_lse=True, q_block=512, kv_block=1024,
                     offsets=offs, **opts), reps=3),
                 "library_ms": graph_ms(sdpa_fwd),
                 **bound(fwd_bytes, fwd_ops)},
            bwd={"kernel_ms": graph_ms(bwd),
                 "kernel_eager_ms": cuda_ms(bwd, reps=5),
                 "plain_ms": graph_ms(lambda: FA.flash_attention_bwd_plain(
                     q, k, v, out, lse, dout, q_block=512, kv_block=1024,
                     offsets=offs, **opts), reps=3),
                 "library_ms": cuda_ms(sdpa_fwd_bwd, reps=10),
                 "library": "scaled_dot_product_attention forward + "
                            "backward with the same boolean mask, eager",
                 **bound(bwd_bytes, bwd_ops)},
            library="scaled_dot_product_attention(attn_mask=the call's "
                    "mask, enable_gqa=True)",
            timing="device time of 20 calls (plain: 3) replayed from one "
                   "CUDA graph, each call's int32[3] of offsets built on the "
                   "card included; *_eager_ms and the backward's library_ms: "
                   "eager calls back to back between two events")
        for part in ("fwd", "bwd"):
            row[part]["roofline_share"] = (row[part]["bound_ms"]
                                           / row[part]["kernel_ms"])
    return row


def attention_dynamic_path(dev, rng) -> tuple:
    """Every DYNAMIC_CHECKS row in f32 (the CUDA cores' entries) and bf16
    (the tensor cores', timed) through :func:`check_dynamic_attention`.
    Returns (rows, the driven calls' launches)."""
    rows, counts = [], dict.fromkeys(KERNEL_NAMES, 0)
    for tag, shape, offsets in DYNAMIC_CHECKS:
        for dtype in ("float32", "bfloat16"):
            row = check_dynamic_attention(tag, shape, offsets, dtype, rng,
                                          dev, timed=dtype == "bfloat16")
            for name, n in row["driven_launches"].items():
                counts[name] += n
            rows.append(row)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(flash_attention_dynamic=len(rows),
                flash_attention_bwd_dynamic=len(rows))
    if counts != want:
        raise AssertionError(f"the dynamic calls launched {counts}, expected "
                             f"{want}")
    return rows, counts


def sharding_path(ckpt, step, dev) -> list:
    """The sharding substrate of training on a 1-rank NCCL mesh (the 1 x 1
    ``("data", "model")`` local mesh, its group destroyed at the end):
    ``lm-train``'s checkpoint of ``step`` restored by ``elastic_reshard``
    onto the mesh with ``param_pspecs`` under ``RULES_SINGLE_POD``, each
    leaf bitwise the plain restore; one step's gradient tree of the
    restored Qwen2-0.5B (``loss_and_grads``, what the donated step
    computes before its update) through ``compressed_mean``, per leaf
    mean + new error = g to f32 rounding and the mean within
    SHARD_MEAN_SHARE max|g| of g; a batch placed by ``shard_batch``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           shard_batch)
    from repro_torch.launch.mesh import axis_sizes, make_local_mesh
    from repro_torch.models.params import abstract_params, param_pspecs
    from repro_torch.sharding.rules import (RULES_SINGLE_POD, NamedSharding,
                                            named_sharding, to_placements)
    from repro_torch.train.compression import (BLOCK, compressed_mean,
                                               compression_ratio,
                                               init_error_state)
    from repro_torch.train.fault_tolerance import elastic_reshard
    from repro_torch.train.step import loss_and_grads

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    torch.cuda.set_device(dev.index or 0)
    mesh = make_local_mesh("cuda")
    rows = []
    try:
        specs = param_pspecs(cfg, RULES_SINGLE_POD)
        target = {"params": abstract_params(cfg)}
        shardings = {"params": _map_tree(lambda s: NamedSharding(mesh, s),
                                         specs)}
        t1 = time.perf_counter()
        placed = elastic_reshard(ckpt, step, target, shardings)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t1
        plain = ckpt.restore(step, target, dev)
        flat_placed, flat_plain = (flat_tree(placed["params"]),
                                   flat_tree(plain["params"]))
        flat_specs = flat_tree(specs)
        bad = [k for k, t in flat_placed.items()
               if not isinstance(t, DTensor)
               or t.placements != to_placements(flat_specs[k], mesh)
               or not torch.equal(t.to_local(), flat_plain[k])]
        rows.append({"phase": "sharding-reshard", "model": cfg.name,
                     "checkpoint_step": step, "mesh": axis_sizes(mesh),
                     "rules": "RULES_SINGLE_POD", "leaves": len(flat_placed),
                     "sharded_leaves": sum(1 for s in flat_specs.values()
                                           if s),
                     "bitwise": not bad, "reshard_s": reshard_s})
        if bad:
            raise AssertionError(f"elastic_reshard: leaves {bad[:5]} differ "
                                 f"from the plain restore")
        del plain, flat_plain
        params = _map_tree(lambda t: t.to_local(), placed["params"])
        data = SyntheticLMData(DataConfig(TRAIN_DATA_VOCAB, TRAIN_SEQ,
                                          TRAIN_BATCH, seed=SEED, lag=1),
                               host_batch=TRAIN_BATCH)
        host = data.batch_at(step + 1)
        batch = shard_batch(host, dev)
        grads = loss_and_grads(params, cfg, batch, remat=True)[2]
        del params, placed
        leaves = flat_tree(grads)
        as_rank = lambda t: DTensor.from_local(t[None], mesh,
                                               named_sharding(
                                                   mesh, "batch").placements)
        g_tree = {k: as_rank(t) for k, t in leaves.items()}
        t1 = time.perf_counter()
        mean, new_err = compressed_mean(g_tree, init_error_state(g_tree),
                                        mesh, axis="data")
        torch.cuda.synchronize()
        mean_s = time.perf_counter() - t1
        worst_err = worst_mean = 0.0
        for k, g in leaves.items():
            m, e = mean[k].to_local()[0], new_err[k].to_local()[0]
            top = float(g.abs().max())
            worst_err = max(worst_err, float((m + e - g).abs().max())
                            / max(top, 1e-30))
            worst_mean = max(worst_mean, float((m - g).abs().max())
                             / max(top, 1e-30))
        numel = sum(t.numel() for t in leaves.values())
        payload = sum(t.numel() + 4 * -(-t.numel() // BLOCK)
                      for t in leaves.values())
        rows.append({"phase": "sharding-compressed-mean", "model": cfg.name,
                     "leaves": len(leaves), "elements": numel,
                     "payload_bytes": payload, "f32_bytes": 4 * numel,
                     "payload_over_f32": payload / (4 * numel),
                     "compression_ratio": compression_ratio(),
                     "max_mean_plus_err_minus_g_over_max_g": worst_err,
                     "max_mean_minus_g_over_max_g": worst_mean,
                     "limits": {"mean + err - g": SHARD_ERR_RTOL,
                                "mean - g": SHARD_MEAN_SHARE},
                     "seconds": mean_s})
        if worst_err > SHARD_ERR_RTOL or worst_mean > SHARD_MEAN_SHARE:
            raise AssertionError(f"compressed_mean: {rows[-1]}")
        del grads, mean, new_err, g_tree, leaves
        sh = {"tokens": named_sharding(mesh, "batch", None)}
        placed_batch = shard_batch(host, sh)
        ok = (isinstance(placed_batch["tokens"], DTensor)
              and placed_batch["tokens"].placements == sh["tokens"].placements
              and np.array_equal(placed_batch["tokens"].to_local().cpu()
                                 .numpy(), host["tokens"])
              and all(placed_batch[k] is host[k] for k in host
                      if k != "tokens"))
        rows.append({"phase": "sharding-batch", "keys": sorted(host),
                     "placed": ["tokens"], "placements": str(
                         sh["tokens"].placements), "bitwise": ok})
        if not ok:
            raise AssertionError(f"shard_batch: {rows[-1]}")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    rows.append({"phase": "sharding-total",
                 "wall_s": time.perf_counter() - t0})
    return rows


def _map_tree(fn, tree):
    """``fn`` of every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def same_outputs(card, cpu, what: str) -> float:
    """Hold a program's card result to its CPU result leaf by leaf:
    integer and boolean leaves bitwise, float leaves within
    ANALYSIS_RTOL/ATOL (NaN and infinities where the CPU has them).
    Returns the largest share of the tolerance a float leaf used,
    ``|card - cpu| / (atol + rtol |cpu|)`` over finite entries (a
    summarized step whose overflow flag is set carries values its caller
    discards, some past 1e30)."""
    from repro_torch.analysis.dispatch_lint import output_leaves

    got, want = dict(output_leaves(card)), dict(output_leaves(cpu))
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: outputs {sorted(got)} on the card, "
                             f"{sorted(want)} on the CPU")
    worst = 0.0
    for k, ref in want.items():
        out = got[k].cpu()
        if out.dtype != ref.dtype or out.shape != ref.shape:
            raise AssertionError(f"{what}: {k} is {out.dtype}"
                                 f"{tuple(out.shape)} on the card, "
                                 f"{ref.dtype}{tuple(ref.shape)} on the CPU")
        if ref.dtype.is_floating_point:
            torch.testing.assert_close(out, ref, rtol=ANALYSIS_RTOL,
                                       atol=ANALYSIS_ATOL, equal_nan=True,
                                       msg=lambda m: f"{what}: {k}: {m}")
            fin = torch.isfinite(ref)
            if fin.any():
                worst = max(worst, max_excess(out[fin], ref[fin],
                                              ANALYSIS_ATOL,
                                              ANALYSIS_RTOL)[1])
        elif not torch.equal(out, ref):
            raise AssertionError(f"{what}: {k} differs from the CPU run")
    return worst


def sync_debug_run(fn, args, mode: str) -> tuple:
    """``fn(*args)`` under ``torch.cuda.set_sync_debug_mode(mode)``
    (restored to ``"default"`` in a ``finally``), with the card's peak
    allocation beyond what was live before; returns (result, the
    file:line of each synchronizing call, peak bytes).  In ``"error"``
    mode a synchronizing call raises."""
    import warnings

    from repro_torch.analysis.memory_audit import cuda_peak_bytes

    def in_mode():
        torch.cuda.set_sync_debug_mode(mode)
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, peak = cuda_peak_bytes(in_mode)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)], peak


def analysis_path(dev) -> tuple:
    """The hot-path analysis gates on the card (``repro_torch.analysis``):
    every program of the catalog (``GraphSpec()``: 1,024 vertices, 16,384
    edge slots, B = 4) run once on the CPU (the dispatch lint's host-read
    sites there) and once on the card, under both the dispatch recorder
    (the DSP rules and the largest intermediate) and CUDA's sync debug
    mode — ``"error"`` where the baseline lists no host read of the
    program on the card, ``"warn"`` (warnings counted) where it does —
    with the peak allocation (MEM-TEMP), and its result held to the CPU
    run's; the mesh programs as rank 0 of a fake group of four under the
    dispatch cost counter (COL-*).  Then the rebuild scenarios on the card
    (after warm-up: zero builds, loads and tuning runs): both loops
    untuned, both under
    ``autotune="full"`` from an empty tuner cache (the warm-up must time
    the served key once), and the sync loop under ``"cached"`` from the
    saved cache (the loaded tile, no timing); then the AST lint.  Any
    finding on the card that the baseline does not allow (for ``cuda``)
    fails the run.  Returns (rows, launches by kernel)."""
    import tempfile

    from repro_torch.analysis import BASELINE, ast_lint, memory_audit
    from repro_torch.analysis import dispatch_lint as DL
    from repro_torch.analysis import findings as F
    from repro_torch.analysis import programs as PR
    from repro_torch.kernels.spmv import autotune as AT
    from repro_torch.launch.dispatch_cost import CostCounter
    from repro_torch.launch.mesh import destroy_mesh, init_fake_mesh

    baseline = F.load_baseline(BASELINE)
    spec = PR.GraphSpec()
    cpu = {}
    for prog in PR.catalog(spec, device="cpu"):
        rec, out = DL.record_program(prog)
        cpu[prog.name] = (sorted(rec.sync_sites), out)
    rows, found = [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    for prog in PR.catalog(spec, device=dev):
        listed = [e.where for e in baseline
                  if e.rule == "DSP-HOST-SYNC" and e.applies_to("cuda")
                  and e.where.startswith(prog.name + ":")]
        mode = "warn" if listed else "error"
        (rec, out), synced, peak = sync_debug_run(
            DL.record_program, (prog, prog.inputs()), mode)
        found += rec.findings()
        mem = memory_audit.audit_memory(
            prog.budgets, program=prog.name,
            largest_bytes=rec.largest_bytes, largest_at=rec.largest_at,
            peak_bytes=peak)
        found += mem
        cpu_sites, cpu_out = cpu[prog.name]
        err = same_outputs(out, cpu_out, prog.name)
        rows.append({
            "phase": "analysis", "program": prog.name,
            "device_syncs": len(synced), "sites": len(cpu_sites),
            "card_sites": len(rec.sync_sites),
            "largest_intermediate_bytes": rec.largest_bytes,
            "peak_bytes": peak, "sync_debug_mode": mode,
            "baseline_sync_sites": len(listed),
            "sync_calls": sorted(set(synced)), "ops": rec.ops,
            "largest_at": rec.largest_at, "mem_temp_budget_bytes":
                prog.budgets.temp_bytes_max,
            "findings": len(rec.findings()) + len(mem),
            "vs_cpu_share_of_tolerance": err})
    # the mesh programs, as rank 0 of a fake group of four (a 2 x 2 mesh on
    # the card): their largest collective of each kind against the budgets
    mesh = init_fake_mesh((2, 2), ("data", "model"), device_type="cuda")
    try:
        for prog in PR.catalog(spec, device=dev, mesh=mesh):
            if not prog.name.endswith(",mesh]"):
                continue
            inputs = prog.inputs()
            with CostCounter() as cc:
                prog.fn(*inputs)
                torch.cuda.synchronize()
            got = memory_audit.audit_cost(cc.cost, prog.budgets,
                                          program=prog.name)
            found += got
            rows.append({"phase": "analysis-collective",
                         "program": prog.name,
                         "collectives": dict(cc.cost.coll_counts),
                         "largest_bytes": dict(cc.cost.coll_max),
                         "findings": len(got)})
    finally:
        destroy_mesh()
    catalog_s = time.perf_counter() - t0
    counts = launch_counts()
    for k in ("spmv_push", "spmv_reduce_push", "spmv_push_batched"):
        if not counts[k]:
            raise AssertionError(f"the catalog on the card launched no "
                                 f"{k}")
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "tiles.json"
        try:
            for run, mode in ((PR.run_rebuild_scenario, "off"),
                              (PR.run_async_rebuild_scenario, "off"),
                              (PR.run_rebuild_scenario, "full"),
                              (PR.run_async_rebuild_scenario, "full"),
                              (PR.run_rebuild_scenario, "cached")):
                AT.clear_cache()
                if mode == "cached":
                    AT.load_cache(cache)
                hits = AT.cache_hits()
                report = {}
                got = run(device=dev, report=report, autotune=mode)
                found += got
                what = f"{report['scenario']} (autotune={mode})"
                if report["events_after_warm"]:
                    raise AssertionError(f"{what}: builds, loads or tuning "
                                         f"runs after warm-up: "
                                         f"{report['events_after_warm']}")
                searched = report["warm_events"].get("autotune-search", 0)
                if searched != (mode == "full"):
                    raise AssertionError(f"{what}: {searched} tile searches "
                                         f"in warm-up")
                if mode == "full" and run is PR.run_rebuild_scenario:
                    AT.save_cache(cache)
                    tuned = report["tiles"]
                if mode == "cached" and (report["tiles"] != tuned
                                         or AT.cache_hits() == hits):
                    raise AssertionError(f"{what}: tiles {report['tiles']}, "
                                         f"not the loaded {tuned}")
                rows.append({"phase": "analysis-rebuild", **report,
                             "findings": len(got)})
        finally:
            AT.clear_cache()
    counts = launch_counts()
    found += ast_lint.lint_files()
    passes = ("dispatch", "memory", "collective", "rebuild", "ast")
    new, matched, stale = F.check(found, baseline, passes_run=passes,
                                  device="cuda")
    rows.append({"phase": "analysis-gate", "programs": len(cpu),
                 "omitted": list(PR.OMITTED), "catalog_s": catalog_s,
                 "findings": len(found), "allowlisted": len(matched),
                 "new": [str(f) for f in new],
                 "stale": [e.key for e in stale]})
    if new:
        for row in rows:
            emit(row)
        raise AssertionError(f"{len(new)} analysis finding(s) on the card "
                             f"that the baseline does not allow: "
                             + "; ".join(map(str, new)))
    return rows, counts


def ops_path(dev) -> tuple:
    """The kernels' convenience wrappers (``kernels/*/ops.py``) on the card
    against their refs (``kernels/*/ref.py``) and plain versions:
    ``pagerank_push``, ``semiring_push`` (plus_times [N], min_plus [N]
    and [B, N]) and ``sharded_semiring_push`` (min_plus over the catalog's
    shards, meshless) at the catalog's graph, ``flash_attention_op`` and
    ``decode_attention_op`` in f32 at Qwen2-0.5B's heads.  Sums are held
    to an f64 plain version at ANALYSIS_RTOL/ATOL, min/max bitwise to the
    CPU's plain version, attention to its ref at ATTN_F32_TOL.  Returns
    (rows, launches by kernel of the seven op calls)."""
    from repro_torch.analysis import programs as PR
    from repro_torch.core.backend import build_layout
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.spmv.kernel import spmv_push_plain
    from repro_torch.kernels.spmv.ops import (pagerank_push, semiring_push,
                                              sharded_semiring_push)
    from repro_torch.kernels.spmv.ref import spmv_push_ref

    rng = np.random.default_rng(SEED)  # its own: later phases' draws stay
    spec = PR.GraphSpec()
    state = PR.build_graph(spec, device=dev)
    cpu_state = PR.build_graph(spec, device="cpu")
    n = spec.node_capacity
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    vb = torch.from_numpy(rng.random((spec.batch, n)).astype(np.float32))
    lay = build_layout(state)
    reset_launch_counts()
    outs = {
        "pagerank_push": pagerank_push(state, v.to(dev), layout=lay),
        "semiring_push[plus_times]": semiring_push(state, v.to(dev)),
        "semiring_push[min_plus]": semiring_push(
            state, v.to(dev), semiring="min_plus", weight="length"),
        "semiring_push[min_plus,batched]": semiring_push(
            state, vb.to(dev), semiring="min_plus", weight="length"),
        "sharded_semiring_push[min_plus]": sharded_semiring_push(
            state, v.to(dev), num_shards=spec.num_shards,
            semiring="min_plus", weight="length"),
    }
    b, s, h, kvh, hd = 2, 256, 14, 2, 64
    gen = torch.Generator().manual_seed(SEED)
    q, k, vv = (torch.randn(shape, generator=gen) for shape in (
        (b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    qd = torch.randn((b, 1, h, hd), generator=gen)
    cache_len = 200
    outs["flash_attention_op"] = flash_attention_op(q.to(dev), k.to(dev),
                                                    vv.to(dev))
    outs["decode_attention_op"] = decode_attention_op(
        qd.to(dev), k.to(dev), vv.to(dev), cache_len)
    torch.cuda.synchronize()
    counts = launch_counts()
    rows = []
    # sums: the f64 plain version of the same push, and for pagerank_push
    # also the ref (an index_add in edge order over the sorted stream)
    unit = build_layout(state, weight="unit")
    for name, layout in (("pagerank_push", lay),
                         ("semiring_push[plus_times]", unit)):
        ref64 = spmv_push_plain(v.to(dev), layout.src, layout.weight,
                                layout.row_offsets, dtype=torch.float64)
        err, share = max_excess(outs[name], ref64, ANALYSIS_ATOL,
                                ANALYSIS_RTOL)
        if share > 1:
            raise AssertionError(f"{name}: {err} from the f64 plain version")
        rows.append({"phase": "ops", "op": name, "vs": "f64 plain version",
                     "max_abs_err": err, "share_of_tolerance": share})
    ref = spmv_push_ref(v.to(dev)[lay.src.long()] * lay.weight, lay.dst, n)
    err, share = max_excess(outs["pagerank_push"], ref, ANALYSIS_ATOL,
                            ANALYSIS_RTOL)
    if share > 1:
        raise AssertionError(f"pagerank_push: {err} from spmv_push_ref")
    rows[0]["ref_max_abs_err"] = err
    # min/max: bitwise the CPU's plain version (of the unsharded push for
    # the sharded one)
    for name, vals in (("semiring_push[min_plus]", v),
                       ("semiring_push[min_plus,batched]", vb),
                       ("sharded_semiring_push[min_plus]", v)):
        want = semiring_push(cpu_state, vals, semiring="min_plus",
                             weight="length")
        if not torch.equal(outs[name].cpu(), want):
            raise AssertionError(f"{name} differs from the CPU's plain "
                                 f"version")
        rows.append({"phase": "ops", "op": name,
                     "vs": "CPU plain version (bitwise)", "max_abs_err": 0.0})
    for name, out, ref in (
            ("flash_attention_op", outs["flash_attention_op"],
             flash_attention_ref(q.to(dev), k.to(dev), vv.to(dev))),
            ("decode_attention_op", outs["decode_attention_op"],
             decode_attention_ref(qd.to(dev), k.to(dev), vv.to(dev),
                                  cache_len))):
        err, share = max_excess(out, ref, ATTN_F32_TOL)
        if share > 1:
            raise AssertionError(f"{name}: {err} from its ref")
        rows.append({"phase": "ops", "op": name, "vs": "ref (f32 plain)",
                     "max_abs_err": err, "share_of_tolerance": share})
    for kname in ("spmv_push", "spmv_reduce_push", "spmv_reduce_push_batched",
                  "flash_attention", "decode_attention"):
        if not counts[kname]:
            raise AssertionError(f"the ops launched no {kname}")
    return rows, counts


# ---- the pod-scale dry run (slice R) ---------------------------------------
#: the LM cells run on the card at full width on a 1 x 1 mesh: (shape, the
#: global batch it is cut to); decode with its cache full
DRYRUN_LM_CELLS = (("train_4k", 2), ("prefill_32k", 1), ("decode_32k", 8))
DRYRUN_SEED = 30


def placed_state_check(sess, mesh) -> dict:
    """One summarized query of a session's algorithm from its engine's
    graph and state, over layouts of ``SHARDS`` shards on ``mesh``, with
    every 97th vertex taken as new since the baselines (so the hot set
    grows through the frontier sweeps): from the whole graph state, and
    from the state placed as the reference's ``graph_shardings`` lays it
    out (edge buffers as DTensors, the layouts built from the rank's local
    buffers, each frontier sweep's counts summed over the edge group); the
    two bitwise, stats included.  On one rank the rank's slot range is
    every slot: this runs the placed state's code path (its local buffers,
    the sweeps' all-reduce over a group of one), not a split of the edges,
    which ``dryrun-graph`` (rank 0 of 256) and the four-rank CPU tests
    hold.  Fails unless the placed run made more all-reduces than the
    whole one (one a frontier sweep)."""
    from repro_torch.core.backend import normalize_layout_spec
    from repro_torch.core.fused import fused_query_step
    from repro_torch.graph.graph import edge_group, edge_slice
    from repro_torch.graph.partition import (build_sharded_layout,
                                             place_graph_state)
    from repro_torch.launch.dispatch_cost import CostCounter

    eng = sess.engine
    cfg, algo = eng.config, eng.algorithm
    placed = place_graph_state(eng.state, mesh)
    dev = eng.state.device
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    fresh = torch.arange(eng.state.node_capacity, device=dev) % 97 == 0
    deg_prev = torch.where(fresh, 0, eng.deg_prev)
    active_prev = eng.active_prev & ~fresh
    runs = []
    for st in (eng.state, placed):
        with CostCounter() as cc:
            layouts = tuple(
                build_sharded_layout(st, mesh=mesh, num_shards=SHARDS,
                                     weight=w, reverse=rev, semiring=sr,
                                     placed=True)
                for w, rev, sr in map(normalize_layout_spec,
                                      algo.layout_specs))
            new, stats = fused_query_step(
                st, eng.algo_state, deg_prev, active_prev,
                scalar(cfg.r), scalar(cfg.delta), algo=algo,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap,
                degree_mode=cfg.degree_mode, expand_both=cfg.expand_both,
                layouts=layouts)
        runs.append(({k: v.cpu().numpy() for k, v in new.items()},
                     [int(x) for x in stats[:8]],
                     int(cc.cost.coll_counts.get("all-reduce", 0))))
    (want, wstats, w_ar), (got, gstats, g_ar) = runs
    if wstats != gstats or any(
            not np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8))
            for k in want):
        raise AssertionError(f"{algo.name}: the placed state's query "
                             f"differs from the whole state's")
    group = edge_group(placed)
    held = edge_slice(placed).src.shape[0]
    if group is None or g_ar <= w_ar or held != placed.edge_capacity:
        raise AssertionError(
            f"{algo.name}: the placed state ran no sweep all-reduce over "
            f"its edge group ({w_ar} all-reduces whole, {g_ar} placed, "
            f"{held} of {placed.edge_capacity} slots held)")
    return {"phase": "dryrun-nd-mesh", "check": "placed-state",
            "algorithm": algo.name, "shards": SHARDS,
            "mesh": "1 x 1 (data, model), 1-rank NCCL",
            "edge_slots_held": held,
            "edge_capacity": placed.edge_capacity,
            "edge_group_ranks": group.size(),
            "all_reduces_whole": w_ar, "all_reduces_placed": g_ar,
            "stats": dict(zip(("num_hot", "num_kr", "num_kn", "num_kdelta",
                               "num_ek", "num_eb", "iterations",
                               "used_fallback"), gstats)),
            "bitwise_vs_whole_state": True}


def nd_mesh_runs(stream, dev, ref) -> tuple:
    """The sharded engine on the 1 x 1 ``("data", "model")`` mesh (both
    axes flattened into the edge-shard axis) at ``SHARDS`` shards, inside
    the sharded phase's 1-rank NCCL group: PageRank bitwise the 1-D mesh's
    session (itself held to the unsharded one) and within ``SHARD_TOL`` of
    the unsharded session where the hot sets agree, SSSP and CC bitwise
    the unsharded sessions; for PageRank and SSSP a query from the state
    placed as ``graph_shardings`` lays it out bitwise the whole state's
    (:func:`placed_state_check`).  ``ref`` holds the sharded phase's runs.  The
    counts are set to 0 before the runs and read after.  Returns (rows,
    launch counts)."""
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh("cuda")
    shard = dict(mesh=mesh, num_shards=SHARDS)
    out = []
    reset_launch_counts()
    sess, rows, res = drive_sharded(stream, "pagerank", {}, QUERIES,
                                    QUERIES - 1, dev, **shard)
    pushes = check_sharded_pushes("2-D mesh PageRank", rows)
    for a, b, x, y in zip(ref["pagerank_1d"][0], rows, ref["pagerank_1d"][1],
                          res):
        if (a["num_hot"], a["num_ek"], a["iterations"]) != (
                b["num_hot"], b["num_ek"], b["iterations"]) or \
                not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
            raise AssertionError(f"2-D mesh PageRank query {b['query']} "
                                 f"differs from the 1-D mesh's")
    agree = 0
    for a, b, x, y in zip(ref["flat"][0], rows, ref["flat"][1], res):
        if (a["num_hot"], a["num_ek"]) == (b["num_hot"], b["num_ek"]):
            np.testing.assert_allclose(y, x, **SHARD_TOL)
            agree += 1
    out.append({"phase": "dryrun-nd-mesh", "algorithm": "pagerank",
                "mesh": "1 x 1 (data, model), 1-rank NCCL",
                "shards": SHARDS, "queries": len(rows),
                "bitwise_vs_1d_mesh": True,
                "within_tol_vs_unsharded": agree, "sharded_pushes": pushes})
    out.append(placed_state_check(sess, mesh))
    del sess
    for name, per_iter in (("sssp", 1), ("connected-components", 2)):
        s, rows, res = drive_sharded(stream, name, dict(TRAVERSAL)[name],
                                     TRAVERSAL_QUERIES, TRAVERSAL_EXACT_EVERY,
                                     dev, r=TRAVERSAL_R, **shard)
        want_rows, want_res = ref["trav"][name]
        for a, b, x, y in zip(want_rows, rows, want_res, res):
            if (a["num_hot"], a["num_ek"], a["iterations"]) != (
                    b["num_hot"], b["num_ek"], b["iterations"]) or \
                    not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                raise AssertionError(f"2-D mesh {name} query {b['query']} "
                                     f"differs from the unsharded one")
        out.append({"phase": "dryrun-nd-mesh", "algorithm": name,
                    "queries": len(rows), "bitwise_vs_unsharded": True,
                    "sharded_pushes": check_sharded_pushes(
                        f"2-D mesh {name}", rows, per_iter)})
        if name == "sssp":
            out.append(placed_state_check(s, mesh))
        del s
    counts = launch_counts()
    out.append({"phase": "dryrun-nd-mesh-total", "launches": counts,
                "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return out, counts


def dryrun_graph_path(dev) -> tuple:
    """The veilgraph dry run cell at the reference's full size (N = 2^25,
    E = 2^30) as rank 0 of the single-pod mesh on a fake group of 256 on
    the card (``repro_torch.launch.dryrun.run_veilgraph_cell``: its three
    gates, its record; rank 0 holds its 2^22 edge slots and the node
    vectors, as the reference's ``graph_shardings`` place them), then one
    shard push of rank 0's layout, built from rank 0's slice alone, timed
    against the record's modeled bytes.  The counts are set to 0 before
    the cell.  Returns (rows, launch counts)."""
    import torch.distributed as dist

    from repro_torch.core import backend as B
    from repro_torch.graph.partition import build_sharded_layout
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import destroy_mesh, fake_production_mesh
    from repro_torch.launch.roofline import push_roofline_check

    if dist.is_initialized():
        raise AssertionError("the graph dry run starts its own fake group")
    t0 = time.perf_counter()
    mesh = fake_production_mesh(device_type="cuda")
    try:
        reset_launch_counts()
        rec = D.run_veilgraph_cell(mesh, "single")
        counts = launch_counts()
        if rec["status"] != "ok":
            raise AssertionError(f"veilgraph dry run cell: {rec['error']}\n"
                                 f"{rec['traceback']}")
        nodes, edges = 2**25, 2**30
        state, _, _ = D.random_graph(nodes, edges, mesh)
        layout = build_sharded_layout(state, mesh=mesh, placed=True)
        e_pad = layout.src.shape[1]
        del state
        torch.cuda.empty_cache()
        values = torch.ones(nodes, dtype=torch.float32, device=dev)
        push_ms = cuda_ms(lambda: B.push(values, layout), reps=10)
        model = push_roofline_check(edge_capacity=e_pad, num_segments=nodes)
        rf = rec["roofline"]
        coll = rf["collective_breakdown"]
        pushes = counts["spmv_push"]
        row = {"phase": "dryrun-graph", "mesh": "single (16, 16), rank 0 of "
               "a fake group of 256", "nodes": nodes, "edges": edges,
               "shard_edges": e_pad, "launches": counts,
               "spmv_push_launches": pushes,
               "edge_slots_held": rec["edge_slots_held"],
               "argument_bytes": rf["memory_stats"]["argument_bytes"],
               "temp_bytes": rf["memory_stats"]["temp_bytes"],
               "flops_per_device": rf["flops_per_device"],
               "bytes_per_device": rf["bytes_per_device"],
               "collective_bytes": {k: v for k, v in coll.items()
                                    if k != "counts"},
               "collective_counts": coll["counts"],
               "coll_max": rec["coll_max"],
               "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
               "collective_s": rf["collective_s"],
               "dominant": rf["dominant"],
               "push_coo_calls": rec["push_coo_calls"],
               "max_all_gather_bytes": rec["max_all_gather_bytes"],
               "push_baselines_within_10pct": len(rec["push_roofline"]),
               "query_stats": rec["query_stats"], "note": rec["note"],
               "cell_step_s":
               rec["step_s"], "cell_setup_s": rec["setup_s"],
               "shard_push_ms": push_ms,
               "shard_push_modeled_hbm_bytes": model["hbm_bytes"],
               "shard_push_bound_ms": model["bound_time_s"] * 1e3,
               "shard_push_bound_by": model["bound_by"],
               "wall_s": time.perf_counter() - t0}
        if pushes < 1:
            raise AssertionError("the graph cell launched no spmv_push")
        if row["argument_bytes"] >= 1e9 or row["edge_slots_held"] != (
                edges // mesh.size()):
            raise AssertionError(f"rank 0 holds {row['argument_bytes']} B "
                                 f"of arguments, {row['edge_slots_held']} "
                                 f"edge slots: more than its placement")
        del layout, values
    finally:
        destroy_mesh()
        torch.cuda.empty_cache()
    return [row], counts


def _dryrun_inputs(cfg, arch, shape, dev, rng):
    """The cell's arguments on the card: parameters from a seed, the AdamW
    state of a train cell, the batch's ids, a decode cell's cache full of
    seeded bf16 values at its last position."""
    from repro_torch.launch.specs import cell_spec
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import adamw_init

    cell = cell_spec(cfg, arch, shape, {}, {})
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        DRYRUN_SEED), dev)
    ids = lambda *s: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, s, dtype=np.int32)).to(dev)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return cell, (params, adamw_init(params),
                      {"tokens": ids(b, s), "labels": ids(b, s)})
    if shape.kind == "prefill":
        return cell, (params, {"tokens": ids(b, s)})
    gen = torch.Generator(device=dev).manual_seed(DRYRUN_SEED + 1)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
                for k, v in tree.items()}
    return cell, (params, fill(cell.args[1]), ids(b, 1),
                  torch.tensor(s - 1, dtype=torch.int32, device=dev))


def dryrun_lm_path(dev) -> tuple:
    """Qwen2-0.5B at full width on a 1 x 1 ``("data", "model")`` NCCL mesh
    with DTensor parameters and inputs at the cell specs' placements, under
    the rule table: one step of each cell of ``DRYRUN_LM_CELLS`` (global
    batches cut to fit one card) bitwise the plain-tensor step on the card
    (a train cell's loss and every gradient first, then the donated step's
    parameters, moments and metrics; a prefill's logits and caches; a
    decode step's logits and caches), with the flash forward, backward and
    decode launches of the DTensor steps counted (their kernels run on the
    local shards, through ``local_map``), and the cost counter's roofline
    record of that step beside the step's time: CUDA events around a
    second DTensor step (the host's dispatch gaps in), and the summed
    device time of a third step's kernels from a profiler trace
    (:func:`profiled_device_ms`).  Returns (rows, launch counts)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dispatch_cost import CostCounter
    from repro_torch.launch.mesh import destroy_mesh, make_local_mesh
    from repro_torch.launch.specs import cell_spec
    from repro_torch.models.config import SHAPES
    from repro_torch.sharding.rules import (axis_rules, rules_for_mesh,
                                            to_placements)
    from repro_torch.train.optimizer import AdamWState, tree_leaves
    from repro_torch.train.step import loss_and_grads

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(DRYRUN_SEED)
    mesh = make_local_mesh("cuda")
    rules = rules_for_mesh(mesh)
    sizes = {"data": 1, "model": 1}
    totals = {k: 0 for k in KERNEL_NAMES}
    out = []

    def place(tree, specs):
        if isinstance(tree, AdamWState):
            return AdamWState(*(place(t, s) for t, s in zip(tree, specs)))
        if isinstance(tree, dict):
            return {k: place(tree[k], specs[k]) for k in tree}
        return DTensor.from_local(tree.clone(), mesh,
                                  to_placements(specs, mesh))

    def local(tree):
        """Every tensor of a tree (tuples, an AdamWState, dicts), local."""
        if isinstance(tree, (tuple, list)):
            return [t for x in tree for t in local(x)]
        return [t.to_local() if isinstance(t, DTensor) else t
                for t in tree_leaves(tree)]

    def bitwise(tag, a, b):
        a, b = local(a), local(b)
        if len(a) != len(b) or not all(same_bits(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"dry run {tag}: the DTensor step differs "
                                 f"from the plain one")
        return len(a)

    try:
        with axis_rules(rules):
            for name, batch in DRYRUN_LM_CELLS:
                t0 = time.perf_counter()
                shape = dataclasses.replace(SHAPES[name], global_batch=batch)
                cell, args = _dryrun_inputs(cfg, LM_ARCH, shape, dev, rng)
                specs = cell_spec(cfg, LM_ARCH, shape, rules, sizes).in_pspecs
                dargs = tuple(place(a, s) for a, s in zip(args, specs))
                row = {"phase": "dryrun-lm", "model": LM_ARCH, "cell": name,
                       "global_batch": batch,
                       "global_batch_reference": SHAPES[name].global_batch,
                       "seq_len": shape.seq_len,
                       "mesh": "1 x 1 (data, model), 1-rank NCCL"}
                if shape.kind == "train":
                    loss, _, grads = loss_and_grads(args[0], cfg, args[2])
                    loss_d, _, grads_d = loss_and_grads(dargs[0], cfg,
                                                        dargs[2])
                    row["gradients_bitwise"] = bitwise(
                        f"{name} gradients", [loss, grads], [loss_d, grads_d])
                    del grads, grads_d
                torch.cuda.synchronize()
                plain = cell.step_fn(*args)
                reset_launch_counts()
                with CostCounter() as cc:
                    got = cell.step_fn(*dargs)
                    torch.cuda.synchronize()
                counts = launch_counts()
                row["outputs_bitwise"] = bitwise(name, plain, got)
                if shape.kind == "train":
                    row["state_bitwise"] = bitwise(
                        f"{name} parameters and moments", args[:2], dargs[:2])
                for k in KERNEL_NAMES:
                    totals[k] += counts[k]
                want = {"train": ("flash_attention", "flash_attention_bwd"),
                        "prefill": ("flash_attention",),
                        "decode": ("decode_attention",)}[shape.kind]
                if any(counts[k] < cfg.num_layers for k in want):
                    raise AssertionError(f"dry run {name}: launches {counts}")
                del plain, got
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                again = cell.step_fn(*dargs)
                end.record()
                torch.cuda.synchronize()
                del again
                # the same step's kernels alone, without DTensor's host
                # dispatch between them
                device_only = profiled_device_ms(
                    lambda: cell.step_fn(*dargs))
                rf = RL.analyze(cc.cost, arch=LM_ARCH, shape=shape,
                                mesh_name="1x1", chips=1, cfg=cfg,
                                memory_stats={"temp_bytes":
                                              cc.cost.peak_bytes})
                row.update(launches={k: v for k, v in counts.items() if v},
                           step_device_ms=start.elapsed_time(end),
                           step_device_only_ms=device_only,
                           roofline=rf.to_dict(),
                           wall_s=time.perf_counter() - t0)
                out.append(row)
                del args, dargs, cell
                torch.cuda.empty_cache()
    finally:
        destroy_mesh()
    out.append({"phase": "dryrun-lm-total", "launches": totals,
                "wall_s": time.perf_counter() - t_phase})
    return out, totals


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.backend import build_layout, summary_layout
    from repro_torch.graph.generators import DATASETS, generate, gnm_edges
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels.build import NVCC_FLAGS, build_library
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.spmv import kernel as K
    from repro_torch.stream import StreamConfig, build_stream

    if torch.cuda.device_count() != 1:
        print("chip_smoke.py runs on exactly one CUDA device; "
              f"{torch.cuda.device_count()} are visible (set "
              "CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # every time below is taken on this card at this power limit
    emit({"phase": "device", "nvidia_smi": smi})
    rng = np.random.default_rng(SEED)

    # ---- 1. build -----------------------------------------------------------
    # one nvcc per source and merge tile, started together
    t0 = time.perf_counter()
    jobs = [(source, K.tile_defines(tile))
            for source in (K.SOURCE, K.REDUCE_SOURCE) for tile in K.TILES]
    jobs += [(FA.SOURCE, ()), (FA.BWD_SOURCE, ()), (DA.SOURCE, ()),
             (FA.SOURCE, FA.DYNAMIC_DEFINES),
             (FA.BWD_SOURCE, FA.DYNAMIC_DEFINES)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: build_library(*job), jobs))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(NVCC_FLAGS),
          "libraries": [{"library": lib.name, "defines": list(defines),
                         **ptxas_summary(lib, full=not defines)}
                        for lib, (_, defines) in zip(libs, jobs)]})

    # ---- 2. kernel check at the full-graph shapes ---------------------------
    spec = DATASETS["synth-web-lg"]
    t0 = time.perf_counter()
    src, dst = generate(spec, seed=SEED)
    emit({"phase": "data", "dataset": spec.name, "nodes": spec.nodes,
          "edges": int(src.shape[0]),
          "seconds": time.perf_counter() - t0})
    checks = []
    by_path = {}  # each graph path's launches, its counts set to 0 before it
    full = build_layout(from_edges(src, dst, spec.nodes, src.shape[0],
                                   device=dev))
    v = torch.from_numpy(rng.random(spec.nodes).astype(np.float32)).to(dev)
    # one 5% hot draw gives the b_in mask of every masked check below,
    # single and batched, so that they push the same edges
    hot = torch.from_numpy(rng.random(spec.nodes) < 0.05).to(dev)
    checks.append(check_kernel("synth-web-lg inv_out layout", v, full))
    checks.append(check_kernel("synth-web-lg inv_out layout, b_in mask", v,
                               full, b_in_mask(hot, full)))
    # every edge of the stream in one row: the hub case at its extreme
    checks.append(check_kernel("synth-web-lg edges in one row", v,
                               one_row_layout(full)))
    del full
    for row in checks:
        emit(row)
    n_eu, m_eu = 862_000, 19_200_000
    e_src, e_dst = gnm_edges(n_eu, m_eu, seed=SEED)
    eu = build_layout(from_edges(e_src, e_dst, n_eu, e_src.shape[0],
                                 device=dev))
    v_eu = torch.from_numpy(rng.random(n_eu).astype(np.float32)).to(dev)
    checks.append(check_kernel("eu-2005 size (gnm 862k/19.2M)", v_eu, eu))
    emit(checks[-1])
    del eu, v_eu, e_src, e_dst
    reduce_rows = reduce_checks(src, dst, spec.nodes, dev, rng, hot)
    for row in reduce_rows:
        emit(row)
    torch.cuda.empty_cache()
    # the entries no shipped semiring uses, as registered semirings
    entry_reduce_rows, entry_sum_rows = entry_checks(src, dst, spec.nodes,
                                                     dev, rng)
    for row in entry_reduce_rows + entry_sum_rows:
        emit(row)
    torch.cuda.empty_cache()
    batched_rows = batched_checks(src, dst, spec.nodes, dev, rng, hot)
    for row in batched_rows:
        emit(row)
    torch.cuda.empty_cache()
    # every narrow-weight entry, then every built tile against the default
    narrow_sums, narrow_reduces, narrow_batched = narrow_checks(
        src, dst, spec.nodes, dev, rng, hot)
    for row in narrow_sums + narrow_reduces + narrow_batched:
        emit(row)
    batched_rows += narrow_batched
    torch.cuda.empty_cache()
    tile_rows = tile_sweep(src, dst, spec.nodes, dev, rng)
    for row in tile_rows:
        emit(row)
    torch.cuda.empty_cache()

    # ---- 3. main path ---------------------------------------------------------
    stream = build_stream(src, dst, StreamConfig(
        stream_size=spec.stream_size, num_queries=50))
    holder = {"inputs": {}, "outputs": {}}
    sess, rows, launches, wall = drive_main_path(stream, holder)
    main_rows = rows
    for row in rows:
        emit(row)
    emit({"phase": "main-path-total", "queries": QUERIES, "wall_s": wall,
          "kernel_launches": launches, "pushes": launches})

    # ---- 4. E_K kernel check and teacher-forced replays -------------------
    engine = sess.engine
    chosen = [q for q, (_, st) in sorted(holder["outputs"].items())
              if st.num_ek > 0][:TEACHER_FORCED]
    if len(chosen) < TEACHER_FORCED:
        raise AssertionError(f"only {len(chosen)} approximate queries had "
                             f"E_K edges")
    forced = []
    for qid in chosen:
        inputs = holder["inputs"][qid]
        card_ranks, card_st = holder["outputs"][qid]
        g_hot, g_sum, g_ranks, _, g_lay = teacher_forced(inputs, engine, dev)
        if qid == chosen[0]:
            g_sum_first = g_sum
            ek = summary_layout(g_sum)
            k_cap = g_sum.hot_ids.shape[0]
            v_k = torch.from_numpy(
                rng.random(k_cap).astype(np.float32)).to(dev)
            checks.append(check_kernel(f"E_K summary layout (query {qid})",
                                       v_k, ek))
            emit(checks[-1])
        c_hot, c_sum, c_ranks, c_st, _ = teacher_forced(
            inputs, engine, torch.device("cpu"))
        if not torch.equal(c_hot, g_hot.cpu()):
            raise AssertionError(f"query {qid}: hot masks differ")
        for k in ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_row_offsets",
                  "num_ek", "num_eb", "overflow"):
            if not torch.equal(getattr(c_sum, k), getattr(g_sum, k).cpu()):
                raise AssertionError(f"query {qid}: summary {k} differs")
        if not torch.equal(c_sum.ek_w, g_sum.ek_w.cpu()):
            raise AssertionError(f"query {qid}: summary ek_w differs")
        if (int(c_st.num_hot), int(c_st.num_ek)) != (card_st.num_hot,
                                                     card_st.num_ek):
            raise AssertionError(f"query {qid}: step stats differ")
        # the loop also stops early when an f32 step is exactly 0, which
        # depends on the sum order: the iteration counts are reported
        # b_in sums up to a hub's 240k contributions (all >= 0) and a
        # sequential f32 sum drifts further than the 1e-5 the kernel holds,
        # so both f32 replays are measured against an f64 one
        b64, r64 = f64_replay(inputs, engine, g_sum, g_lay, g_hot,
                              card_st.iterations)
        forced.append({
            "phase": "teacher-forced", "query": qid,
            "num_hot": card_st.num_hot, "num_ek": card_st.num_ek,
            "iterations": card_st.iterations,
            "cpu_iterations": c_st.iterations,
            "hot_mask_bitwise": True, "summary_structure_bitwise": True,
            "ek_w_bitwise": True,
            "b_in_card_vs_f64": max_rel(g_sum.b_in, b64),
            "b_in_cpu_vs_f64": max_rel(c_sum.b_in, b64),
            "ranks_card_vs_f64": max_rel(card_ranks, r64),
            "ranks_cpu_vs_f64": max_rel(c_ranks, r64),
            "ranks_card_vs_cpu": max_rel(card_ranks, c_ranks),
            "card_replay_bitwise": bool(torch.equal(g_ranks, card_ranks))})
        emit(forced[-1])
        torch.testing.assert_close(g_sum.b_in.double(), b64, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(card_ranks.double(), r64.to(dev),
                                   rtol=1e-5, atol=1e-5)

    emit(host_sync_cost(g_sum_first, holder["inputs"][chosen[0]]["ranks"]))
    del sess, engine, holder, g_sum_first
    torch.cuda.empty_cache()

    by_path["main-path"] = {"spmv_push": launches}
    # ---- 5. traversal path: SSSP, widest path, connected components --------
    rows, ek_check, reduce_launches, reduce_pushes = traversal_path(
        stream, dev, rng)
    for row in rows:
        emit(row)
    emit(ek_check)
    reduce_rows.append(ek_check)
    emit({"phase": "traversal-path-total", "kernel_launches": reduce_launches,
          "pushes": reduce_pushes})
    torch.cuda.empty_cache()

    by_path["traversal"] = {"spmv_reduce_push": reduce_launches}
    # ---- 6. serving path: serve_session, slot-batched waves ---------------
    rows, serve_checks, serve_counts, plan = serving_path(
        stream, src, dst, spec.nodes, dev, rng)
    for row in rows + serve_checks:
        emit(row)
        if row["phase"] == "kernel-check":
            checks.append(row)
        elif row["phase"] == "reduce-kernel-check":
            reduce_rows.append(row)
        elif row["phase"] == "batched-kernel-check":
            batched_rows.append(row)

    by_path["serving"] = serve_counts
    # ---- 6b. closed-loop control: sessions and serving lanes -------------
    rows, by_path["control"] = control_path(stream, dev)
    for row in rows:
        emit(row)
    rows, by_path["control-serving"] = control_serving_path(stream, plan, dev)
    for row in rows:
        emit(row)

    # ---- 6c. the async rebuild: sessions and serving waves ---------------
    rows, by_path["async"] = async_path(stream, dev)
    for row in rows:
        emit(row)
    rows, by_path["async-serving"] = async_serving_path(stream, plan, dev)
    for row in rows:
        emit(row)

    # ---- 6d. narrow weights and tuned tiles through the front doors -------
    rows, paths = tuned_sessions(stream, plan, main_rows, dev, rng)
    by_path.update(paths)
    for row in rows:
        emit(row)

    # ---- 6e. the sharded engine on a 1-rank mesh ---------------------------
    rows, by_path["sharded"], (sums, reduces, batched), nd, refs = \
        sharded_path(stream, plan, dev, np.random.default_rng(SHARDED_SEED))
    for row in rows + sums + reduces + batched:
        emit(row)
    # the dry run's n-D mesh: its sessions ran last in the sharded group
    nd_rows, by_path["dryrun-nd-mesh"] = nd
    for row in nd_rows:
        emit(row)
    checks += sums
    reduce_rows += reduces
    batched_rows += batched

    # ---- 6e'. the mesh engine across four ranks of the card ---------------
    # after the sharded phase has destroyed its 1-rank group
    rows, by_path["mesh-ranks"] = mesh_ranks_path(stream, refs, dev)
    for row in rows:
        emit(row)
    del refs
    torch.cuda.empty_cache()

    # ---- 6e''. the two examples ---------------------------------------------
    rows, by_path["examples"] = examples_path()
    for row in rows:
        emit(row)
    torch.cuda.empty_cache()

    # ---- 6f. the analysis gates and the kernels' ops wrappers -------------
    rows, by_path["analysis"] = analysis_path(dev)
    for row in rows:
        emit(row)
    rows, ops_counts = ops_path(dev)
    by_path["ops"] = ops_counts
    for row in rows:
        emit(row)
    torch.cuda.empty_cache()

    for row in attention_bounds():
        emit(row)
    del stream, src, dst
    torch.cuda.empty_cache()

    # ---- 7. attention kernels at the LM serving path's shapes --------------
    # f32 products in full precision, as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn_rows = []
    for tag, family, shape in ATTENTION_CHECKS:
        attn_rows.append(check_attention_kernel(tag, family, shape, rng, dev))
        emit(attn_rows[-1])
    flash_main, decode_main = attn_rows[0], attn_rows[4]
    frontend_rng = np.random.default_rng(FRONTEND_SEED)
    for tag, family, shape in FRONTEND_ATTENTION_CHECKS:
        attn_rows.append(check_attention_kernel(tag, family, shape,
                                                frontend_rng, dev))
        emit(attn_rows[-1])
    # the rows and phases below draw from a generator of their own
    granite_yi_rng = np.random.default_rng(GRANITE_YI_SEED)
    for tag, family, shape in DENSE_ATTENTION_CHECKS:
        attn_rows.append(check_attention_kernel(tag, family, shape,
                                                granite_yi_rng, dev))
        if family == "decode":
            # a row chunk of the kernel's grid per 8 heads of a group, each
            # reading the whole cache
            attn_rows[-1]["cache_reads_per_call"] = DA.launch_grid(
                1, shape[2], shape[3])[1] // shape[3]
        emit(attn_rows[-1])

    # ---- 8. LM serving: Qwen2-0.5B at full width ---------------------------
    t0 = time.perf_counter()
    lm_row, engine, prompts, lm_counts = lm_serve_path(dev, rng)
    emit(lm_row)

    # ---- 9. wave 0 replayed through the plain attention versions -----------
    emit(lm_teacher_forced(engine, prompts, dev))
    emit({"phase": "lm-path-total", "wall_s": time.perf_counter() - t0})
    del engine
    torch.cuda.empty_cache()

    # ---- 9b. the flash backward against its plain version -----------------
    bwd_rows = []
    mqa_rng = np.random.default_rng(MQA_BWD_SEED)
    for tag, shape, dtype, timed in FLASH_BWD_CHECKS:
        # Mixtral's and the MQA rows draw from generators of their own, so
        # that the phases after them see the stream they saw before them
        row_rng = (np.random.default_rng(SEED) if shape == MIXTRAL_BWD_SHAPE
                   else mqa_rng if shape in MQA_BWD_SHAPES else rng)
        bwd_rows.append(check_flash_backward(tag, shape, dtype, row_rng, dev,
                                             timed))
        emit(bwd_rows[-1])
    for tag, shape, dtype, timed in FRONTEND_BWD_CHECKS:
        bwd_rows.append(check_flash_backward(tag, shape, dtype, frontend_rng,
                                             dev, timed))
        emit(bwd_rows[-1])
    torch.cuda.empty_cache()

    # ---- 9b'. blocked_attention's dynamic offsets -------------------------
    t0 = time.perf_counter()
    reset_launch_counts()
    dynamic_rows, dynamic_counts = attention_dynamic_path(dev, granite_yi_rng)
    for row in dynamic_rows:
        emit(row)
    emit({"phase": "attention-dynamic-total", "launches": dynamic_counts,
          "host_reads": sum(r["host_reads"] for r in dynamic_rows),
          "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # ---- 9c. LM training: Qwen2-0.5B at full width -------------------------
    # then the sharding substrate on its checkpoint
    t0 = time.perf_counter()
    sharding_rows = []
    train_rows, train_counts = lm_train_path(
        dev, on_checkpoint=lambda ckpt, step: sharding_rows.extend(
            sharding_path(ckpt, step, dev)))
    for row in train_rows + sharding_rows:
        emit(row)
    emit({"phase": "lm-train-total", "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # ---- 9d. the MoE, SSM, hybrid and MLA families at full width ----------
    family_counts = {}
    for phase, arch, *shape in FAMILY_SERVING:
        t0 = time.perf_counter()
        rows, family_counts[f"{phase}:{arch}"] = FAMILY_PATHS[phase](
            arch, *shape, dev, rng)
        for row in rows:
            emit(row)
        emit({"phase": f"{phase}-total", "model": arch,
              "wall_s": time.perf_counter() - t0})

    # ---- 9d'. the encoder-decoder and vision families, serving -----------
    for phase, arch, *shape in FRONTEND_SERVING:
        t0 = time.perf_counter()
        rows, family_counts[f"{phase}:{arch}"] = lm_serve_frontend_path(
            phase, arch, *shape, dev, rng)
        for row in rows:
            emit(row)
        emit({"phase": f"{phase}-total", "model": arch,
              "wall_s": time.perf_counter() - t0})

    # ---- 9e. training the MoE, SSM, hybrid, MLA, encoder-decoder and vision
    # families -------------------------------------------------------------
    for phase, arch, *shape in FAMILY_TRAINING + FRONTEND_TRAINING:
        t0 = time.perf_counter()
        rows, family_counts[f"{phase}:{arch}"] = lm_train_family_path(
            phase, arch, *shape, dev)
        for row in rows:
            emit(row)
        emit({"phase": f"{phase}-total", "model": arch,
              "wall_s": time.perf_counter() - t0})

    # ---- 9f. Granite-34B and Yi-9B served whole ----------------------------
    for phase, arch in DENSE_SERVING:
        t0 = time.perf_counter()
        rows, family_counts[f"{phase}:{arch}"] = lm_serve_dense_path(
            phase, arch, dev, granite_yi_rng)
        for row in rows:
            emit(row)
        emit({"phase": f"{phase}-total", "model": arch,
              "wall_s": time.perf_counter() - t0})

    # ---- 9g. the pod-scale dry run ----------------------------------------
    # the graph cell at full size as rank 0 of a fake group of 256, then
    # Qwen2-0.5B's cells on DTensor parameters over a 1 x 1 NCCL mesh
    t0 = time.perf_counter()
    rows, by_path["dryrun-graph"] = dryrun_graph_path(dev)
    for row in rows:
        emit(row)
    rows, family_counts["dryrun-lm"] = dryrun_lm_path(dev)
    for row in rows:
        emit(row)
    emit({"phase": "dryrun-total", "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # ---- 10. summary --------------------------------------------------------
    main_check, reduce_main = checks[0], reduce_rows[0]

    def entries(rows):
        """Each entry's checks: the worst error and the slowest device time
        over its shapes, and its bound and plain time at that shape."""
        out = {}
        for r in rows:
            e = out.setdefault(r["entry"], {"entry": r["entry"], "checks": 0,
                                            "max_abs_err": 0.0,
                                            "kernel_device_ms": 0.0})
            e["checks"] += 1
            e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
            if r["kernel_device_ms"] >= e["kernel_device_ms"]:
                e.update(kernel_device_ms=r["kernel_device_ms"],
                         bound_ms=r["bound_ms"], plain_ms=r["plain_ms"],
                         shape=r["shape"])
        return sorted(out.values(), key=lambda e: e["entry"])

    def tiles(reduce):
        """Each tile's device time on the sweep's layouts of ``reduce``."""
        return {r["layout"]: {str(t["tile"]): t["device_ms"]
                              for t in r["tiles"]}
                for r in tile_rows if ("min_plus" in r["layout"]) == reduce}

    def total(kernel):
        """A kernel's launches over the graph paths, with the launches of
        each path beside it."""
        per = {path: c[kernel] for path, c in by_path.items()
               if c.get(kernel)}
        return {"launches": sum(per.values()), "launches_by_path": per}

    timed = next(r for r in dynamic_rows if "fwd" in r)
    # the script's own time, its builds included, against its 1,200 s
    emit({"phase": "script-total", "wall_s": time.perf_counter() - t_start})
    sums = [r for r in batched_rows if r["kernel"] == "spmv_push_batched"]
    mins = [r for r in batched_rows
            if r["kernel"] == "spmv_reduce_push_batched"]
    emit({"kernels": [{
        "name": "spmv_push", "route": "cuda",
        "source": "src/repro_torch/kernels/spmv/csrc/spmv_push.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:305",
        **total("spmv_push"),
        "check": "pass",
        "max_abs_err": max(c["max_abs_err"] for c in checks + narrow_sums),
        "ms": main_check["kernel_ms"], "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": main_check["library_ms"],
        "entries": entries(checks + entry_sum_rows + narrow_sums),
        "tile_device_ms": tiles(False)}, {
        "name": "spmv_reduce_push", "route": "cuda",
        "source": "src/repro_torch/kernels/spmv/csrc/spmv_reduce_push.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:338",
        **total("spmv_reduce_push"),
        "check": "pass (bitwise)",
        "max_abs_err": max(c["max_abs_err"] for c in
                           reduce_rows + entry_reduce_rows + narrow_reduces),
        "ms": reduce_main["kernel_ms"], "plain_ms": reduce_main["plain_ms"],
        "bound_ms": reduce_main["bound_ms"],
        "bound_by": reduce_main["bound_by"],
        "library_ms": reduce_main["library_ms"],
        "entries": entries(reduce_rows + entry_reduce_rows + narrow_reduces),
        "tile_device_ms": tiles(True)}, {
        "name": "spmv_push_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/spmv/csrc/spmv_push.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:458",
        **total("spmv_push_batched"),
        "check": "pass (each row bitwise vs spmv_push)",
        "max_abs_err": max(c["max_abs_err"] for c in sums),
        "ms": sums[0]["kernel_ms"], "plain_ms": sums[0]["plain_ms"],
        "bound_ms": sums[0]["bound_ms"], "bound_by": sums[0]["bound_by"],
        "library_ms": sums[0]["library_ms"], "entries": entries(sums)}, {
        "name": "spmv_reduce_push_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/spmv/csrc/spmv_reduce_push.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:517",
        **total("spmv_reduce_push_batched"),
        "check": "pass (bitwise, each row vs spmv_reduce_push)",
        "max_abs_err": max(c["max_abs_err"] for c in mins),
        "ms": mins[0]["kernel_ms"], "plain_ms": mins[0]["plain_ms"],
        "bound_ms": mins[0]["bound_ms"], "bound_by": mins[0]["bound_by"],
        "library_ms": mins[0]["library_ms"], "entries": entries(mins)}, *[{
        "name": row["kernel"], "route": "cuda", "source": source,
        "replaces": replaces, **device_kernels,
        "launches": lm_counts[row["kernel"]]
        + train_counts[row["kernel"]] + sum(
            c[row["kernel"]] for c in family_counts.values()),
        "launches_by_path": {"lm-serve": lm_counts[row["kernel"]],
                             "lm-train": train_counts[row["kernel"]],
                             **{path: c[row["kernel"]]
                                for path, c in family_counts.items()},
                             "ops": ops_counts[row["kernel"]]},
        "check": "pass (f32 and bf16 vs the f64 plain version)",
        "max_abs_err": max(r["f32_max_abs_err_vs_f64"] for r in attn_rows
                           if r["kernel"] == row["kernel"]),
        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shapes": [{"shape": r["shape"], "ms": r["kernel_ms"],
                    "eager_ms": r["kernel_eager_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]}
                   for r in attn_rows if r["kernel"] == row["kernel"]]}
        for row, source, replaces, device_kernels in (
            (flash_main, "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:85",
             FLASH_DEVICE_KERNELS),
            (decode_main, "src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:68", {}))], {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:174",
        "launches": train_counts["flash_attention_bwd"] + sum(
            c["flash_attention_bwd"] for c in family_counts.values()),
        "launches_by_path": {
            "lm-serve": lm_counts["flash_attention_bwd"],
            "lm-train": train_counts["flash_attention_bwd"],
            **{path: c["flash_attention_bwd"]
               for path, c in family_counts.items()}},
        "check": "pass (dq, dk, dv and the forward's lse, f32 and bf16, vs "
                 "the f64 plain version)",
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": bwd_rows[0]["kernel_ms"], "plain_ms": bwd_rows[0]["plain_ms"],
        "bound_ms": bwd_rows[0]["bound_ms"],
        "bound_by": bwd_rows[0]["bound_by"],
        "library_ms": bwd_rows[0]["library_ms"],
        "library": bwd_rows[0]["library"],
        "fwd_lse_ms": bwd_rows[0]["fwd_lse_ms"],
        "fwd_ms": bwd_rows[0]["fwd_ms"],
        "shapes": [{"shape": r["shape"], "ms": r["kernel_ms"],
                    "eager_ms": r["kernel_eager_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "roofline_share": r["roofline_share"],
                    "fwd_lse_ms": r["fwd_lse_ms"],
                    "fwd_lse_bound_ms": r["fwd_lse_bound"]["bound_ms"],
                    "library_fwd_ms": r["library_fwd_ms"]}
                   for r in bwd_rows if "kernel_ms" in r]}, *[{
        "name": name, "route": "cuda", "source": source,
        "defines": list(FA.DYNAMIC_DEFINES), "replaces": replaces,
        **(FLASH_DEVICE_KERNELS if part == "fwd" else {}),
        "reference_path": "src/repro/models/layers.py:308 "
                          "(_blocked_attention_ref, the dynamic-offset path)",
        "launches": dynamic_counts[name],
        "launches_by_path": {"attention-dynamic": dynamic_counts[name]},
        "host_reads": sum(r["host_reads"] for r in dynamic_rows),
        "check": check,
        "max_abs_err": max(r[err] for r in dynamic_rows),
        "ms": timed[part]["kernel_ms"], "plain_ms": timed[part]["plain_ms"],
        "bound_ms": timed[part]["bound_ms"],
        "bound_by": timed[part]["bound_by"],
        "library_ms": timed[part]["library_ms"],
        "shapes": [{"shape": r["shape"], "ms": r[part]["kernel_ms"],
                    "eager_ms": r[part]["kernel_eager_ms"],
                    "plain_ms": r[part]["plain_ms"],
                    "bound_ms": r[part]["bound_ms"],
                    "bound_by": r[part]["bound_by"],
                    "library_ms": r[part]["library_ms"],
                    "roofline_share": r[part]["roofline_share"]}
                   for r in dynamic_rows if part in r]}
        for name, part, err, source, replaces, check in (
            ("flash_attention_dynamic", "fwd", "fwd_max_abs_err",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:85",
             "pass (the f32 output and lse, f32 and bf16, vs the f64 plain "
             "version; the layer's call bitwise the wrapper's)"),
            ("flash_attention_bwd_dynamic", "bwd", "max_abs_err",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_bwd.cu", "src/repro/models/layers.py:174",
             "pass (dq, dk, dv, f32 and bf16, vs the f64 plain version; "
             "the layer's autograd bitwise the wrapper's)"))]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
