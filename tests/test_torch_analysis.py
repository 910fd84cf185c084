"""The port's analysis gates (``repro_torch.analysis``), on the CPU.

Three parts, mirroring ``tests/test_analysis.py`` for the JAX package:

- **Injected violations** — one per rule (DSP-F64, DSP-WIDEN,
  DSP-UNSORTED-SCATTER, DSP-EN-MATERIALIZE, DSP-HOST-SYNC, MEM-TEMP,
  RB-REBUILD and the five AST rules), each caught with a precise
  diagnostic that the committed baseline does not allow, beside a clean
  case.
- **Clean tree** — the shipped source and the committed baseline agree:
  the AST pass, the catalog's hot programs and the two canned engine loops
  give no finding the baseline does not allow on the CPU, and
  ``tools/analyze_torch.py --all --device cpu`` exits 0.
- **Parity with the reference** — the same numpy inputs through both
  packages: every one-device program of ``repro.analysis.programs.
  catalog`` (the reference at ``backend="segment_sum"``) against its port
  (integers, masks and min/max results bitwise, f32 sums rtol = atol =
  1e-6), and ``findings.check``/``render_report`` giving the same
  partitions.

The meshless sharded programs run against the reference's shard loop, and
``test_rebalance_decision_stays_on_device`` is ported.  The reference's HLO
collective tests (``test_hlo_catches_oversized_all_gather``,
``test_hlo_within_budget_is_clean``, ``test_hlo_catches_peak_temp``,
``test_spec_budgets_are_ordered``) hold the COL rules to a trace the
dispatch cost counter recorded on a fake process group; the mesh programs
join the catalog on one.
"""

import ast
import dataclasses
import importlib.util
import stat
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import findings as JF
from repro.analysis import hlo_audit as JH
from repro.analysis import programs as JPR
from repro_torch.analysis import BASELINE
from repro_torch.analysis import ast_lint
from repro_torch.analysis import dispatch_lint as DL
from repro_torch.analysis import findings as F
from repro_torch.analysis import memory_audit as MA
from repro_torch.analysis import programs as PR
from repro_torch.analysis.rebuild import RebuildMonitor
from repro_torch.kernels import build
from repro_torch.launch.dispatch_cost import CostCounter
from repro_torch.launch.mesh import destroy_mesh, init_fake_mesh
from repro_torch.kernels.spmv import autotune as AT

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


def _new(found, device="cpu"):
    """The findings the committed baseline does not allow."""
    return F.check(found, F.load_baseline(BASELINE), device=device)[0]


def _record(fn, *args, name="fab", **thresholds):
    rec = DL.DispatchRecorder(name, **thresholds)
    with rec:
        out = fn(*args)
    rec.check_outputs(out)
    return rec.findings(), rec


def _rules(found):
    return [f.rule for f in found]


# ---------------------------------------------------------------------------
# finding / baseline model
# ---------------------------------------------------------------------------


def test_baseline_entries_require_reasons(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text('{"allow": [{"rule": "R1", "where": "p:op", "reason": " "}]}')
    with pytest.raises(ValueError, match="no reason"):
        F.load_baseline(p)
    p.write_text('{"allow": [{"rule": "R1", "where": "p:op", "reason": "ok",'
                 ' "device": "tpu"}]}')
    with pytest.raises(ValueError, match="device"):
        F.load_baseline(p)


def test_missing_baseline_is_empty():
    assert F.load_baseline(None) == []
    assert F.load_baseline(Path("/nonexistent/baseline.json")) == []


def test_check_partitions_new_allowlisted_stale():
    found = [F.Finding("ast", "R1", "a:b", "d1"),
             F.Finding("ast", "R2", "c:d", "d2")]
    baseline = [F.BaselineEntry("R1", "a:b", "known"),
                F.BaselineEntry("R3", "e:f", "fixed long ago")]
    new, matched, stale = F.check(found, baseline)
    assert [f.key for f in new] == ["R2::c:d"]
    assert [f.key for f in matched] == ["R1::a:b"]
    assert [e.key for e in stale] == ["R3::e:f"]
    report = F.render_report(found, baseline, passes_run=["ast"])
    assert report["ok"] is False
    assert report["allowlisted"][0]["reason"] == "known"


def test_stale_scoped_to_passes_run():
    # an AST-only run must not declare the dispatch allowlist obsolete
    baseline = [F.BaselineEntry("DSP-UNSORTED-SCATTER", "p:f.py:g", "known"),
                F.BaselineEntry("AST-HOST-SYNC", "f.py:g", "fixed")]
    _, _, stale = F.check([], baseline, passes_run=["ast"])
    assert [e.key for e in stale] == ["AST-HOST-SYNC::f.py:g"]
    _, _, stale = F.check([], baseline, passes_run=["ast", "dispatch"])
    assert {e.rule for e in stale} == {"DSP-UNSORTED-SCATTER",
                                      "AST-HOST-SYNC"}
    assert F.pass_of_rule("MEM-TEMP") == "memory"
    assert F.pass_of_rule("RB-REBUILD") == "rebuild"
    assert F.pass_of_rule("DSP-F64") == "dispatch"
    assert F.pass_of_rule("UNKNOWN-RULE") is None


def test_device_scoped_entries_hold_on_their_device_only():
    found = [F.Finding("dispatch", "DSP-HOST-SYNC", "p:k.py:_rows", "d")]
    baseline = [F.BaselineEntry("DSP-HOST-SYNC", "p:k.py:_rows",
                                "plain version", device="cpu"),
                F.BaselineEntry("DSP-HOST-SYNC", "p:e.py:read", "card copy",
                                device="cuda")]
    new, matched, stale = F.check(found, baseline, device="cpu")
    assert (new, [f.key for f in matched], stale) == (
        [], ["DSP-HOST-SYNC::p:k.py:_rows"], [])
    new, matched, stale = F.check(found, baseline, device="cuda")
    assert [f.key for f in new] == ["DSP-HOST-SYNC::p:k.py:_rows"]
    assert [e.key for e in stale] == ["DSP-HOST-SYNC::p:e.py:read"]
    # no device: every entry applies, as in the reference
    assert F.check(found, baseline)[0] == []


@pytest.mark.parametrize("passes", [None, ("dispatch",), ("ast",)])
def test_check_and_report_match_reference(passes):
    """The same findings and baseline give the same partitions and report
    in both packages (the rule prefixes map JXP → DSP, RT → RB)."""
    rows = [("JXP-F64", "DSP-F64", "p:a"), ("JXP-WIDEN64", "DSP-WIDEN", "p:b"),
            ("RT-RETRACE", "RB-REBUILD", "loop:f"),
            ("AST-HOST-SYNC", "AST-HOST-SYNC", "f.py:g"),
            ("AST-SEGMENT-REDUCE", "AST-SEGMENT-REDUCE", "f.py:h")]
    allow = {"p:a": "known", "f.py:g": "boundary", "f.py:zz": "fixed",
             "p:zz": "fixed too"}
    ref_rule = {w: j for j, _, w in rows}
    ref_rule.update({"f.py:zz": "AST-HOST-SYNC", "p:zz": "JXP-F64"})
    port_rule = {w: t for _, t, w in rows}
    port_rule.update({"f.py:zz": "AST-HOST-SYNC", "p:zz": "DSP-F64"})
    ref_pass = {"dispatch": "jaxpr", "ast": "ast"}
    jfound = [JF.Finding("x", j, w, "d") for j, _, w in rows]
    tfound = [F.Finding("x", t, w, "d") for _, t, w in rows]
    jbase = [JF.BaselineEntry(ref_rule[w], w, r) for w, r in allow.items()]
    tbase = [F.BaselineEntry(port_rule[w], w, r) for w, r in allow.items()]
    jpasses = None if passes is None else [ref_pass[p] for p in passes]
    jparts = JF.check(jfound, jbase, passes_run=jpasses)
    tparts = F.check(tfound, tbase, passes_run=passes)
    for j, t in zip(jparts, tparts):
        assert [x.where for x in j] == [x.where for x in t]
    jrep = JF.render_report(jfound, jbase, passes_run=jpasses or ["x"])
    trep = F.render_report(tfound, tbase, passes_run=passes or ["x"])
    assert jrep["ok"] == trep["ok"]
    for part in ("new", "allowlisted", "stale_baseline_entries"):
        assert [(r["where"], r.get("reason")) for r in jrep[part]] == \
            [(r["where"], r.get("reason")) for r in trep[part]]


# ---------------------------------------------------------------------------
# injected dispatch violations
# ---------------------------------------------------------------------------


def test_dispatch_catches_injected_f64():
    found, _ = _record(lambda x: (x.double() * 2.0).float(),
                       torch.ones(128), name="fab[f64]")
    f64 = [f for f in found if f.rule == "DSP-F64"]
    assert f64, "injected float64 op not caught"
    assert "float64" in f64[0].detail and f64[0].where.startswith("fab[f64]:")
    assert _new(f64)
    clean, _ = _record(lambda x: x * 2.0, torch.ones(128))
    assert "DSP-F64" not in _rules(clean)


def test_dispatch_catches_widened_state():
    # int64 or f64 in a program's stored outputs
    found, _ = _record(lambda x: {"ids": x.long(), "w": x.double()},
                       torch.ones(8, dtype=torch.int32), name="fab[widen]")
    widen = {f.where: f for f in found if f.rule == "DSP-WIDEN"}
    assert set(widen) == {"fab[widen]:<output>:out.ids",
                          "fab[widen]:<output>:out.w"}
    assert "torch.int64" in widen["fab[widen]:<output>:out.ids"].detail
    assert _new(list(widen.values()))
    # an edge-scale int64 temporary is counted by site; a chunk-scale one
    # (degree bookkeeping over an apply chunk) is not
    found, _ = _record(lambda x: x.long().sum().to(torch.int32),
                       torch.ones(4096, dtype=torch.int32),
                       edge_threshold=1024)
    assert [f for f in found if f.rule == "DSP-WIDEN"
            and "(4096,)" in f.detail]
    found, _ = _record(lambda x: x.long().sum().to(torch.int32),
                       torch.ones(64, dtype=torch.int32), edge_threshold=1024)
    assert "DSP-WIDEN" not in _rules(found)


@pytest.mark.parametrize("op", ["index_add_", "scatter_add_",
                                "scatter_reduce_", "index_put_accumulate"])
def test_dispatch_catches_unsorted_edge_scale_scatter(op):
    def unsorted_push(v, seg):
        out = torch.zeros(64)
        if op == "index_add_":
            return out.index_add_(0, seg, v)
        if op == "scatter_add_":
            return out.scatter_add_(0, seg, v)
        if op == "scatter_reduce_":
            return out.scatter_reduce_(0, seg, v, reduce="amax")
        return out.index_put_((seg,), v, accumulate=True)

    found, _ = _record(unsorted_push, torch.ones(4096),
                       torch.zeros(4096, dtype=torch.long),
                       name="fab[scatter]", edge_threshold=1024)
    hits = [f for f in found if f.rule == "DSP-UNSORTED-SCATTER"]
    assert hits, f"edge-scale {op} not caught"
    assert "4096" in hits[0].detail  # names the measured index size
    assert _new(hits)


def test_dispatch_scatter_rule_exempts_chunk_scale():
    # degree bookkeeping over an apply chunk is not the O(E) failure class
    found, _ = _record(
        lambda deg, idx: deg.index_add_(0, idx, torch.ones(64,
                                                           dtype=torch.int32)),
        torch.zeros(1024, dtype=torch.int32),
        torch.zeros(64, dtype=torch.long), edge_threshold=8192)
    assert "DSP-UNSORTED-SCATTER" not in _rules(found)


_SYNCS = {
    "item": lambda x: x.sum().item(),
    "float": lambda x: float(x.max()),
    "int": lambda x: int(x.argmax()),
    "bool": lambda x: bool((x > 3).any()),
    "nonzero": lambda x: torch.nonzero(x),
    "masked_select": lambda x: torch.masked_select(x, x > 3),
    "unique": lambda x: torch.unique(x),
    "boolean mask": lambda x: x[x > 3],
    "repeat_interleave": lambda x: torch.repeat_interleave(
        torch.tensor([1, 2, 3])),
    "equal": lambda x: torch.equal(x, x),
}


@pytest.mark.parametrize("kind", sorted(_SYNCS))
def test_dispatch_catches_host_sync(kind):
    found, rec = _record(_SYNCS[kind], torch.arange(10.0), name="fab[sync]")
    hits = [f for f in found if f.rule == "DSP-HOST-SYNC"]
    assert hits, f"{kind} not caught"
    assert "host waits for the device" in hits[0].detail
    assert sum(rec.sync_sites.values()) >= 1
    assert _new(hits)


def test_dispatch_host_sync_clean_forms():
    # a sized repeat_interleave and an on-device select read nothing
    found, rec = _record(
        lambda x: (torch.repeat_interleave(torch.tensor([1, 2, 3]),
                                           output_size=6),
                   torch.where(x > 3, x, 0.0)), torch.arange(10.0))
    assert "DSP-HOST-SYNC" not in _rules(found) and not rec.sync_sites


def test_dispatch_flags_blocking_copies_between_host_and_card():
    cuda, cpu = (SimpleNamespace(device=torch.device(d))
                 for d in ("cuda", "cpu"))
    assert DL._host_copy("_to_copy", (cuda,), {"device": "cpu"}) \
        == "device→host"
    assert DL._host_copy("_to_copy", (cpu,), {"device": "cuda"}) \
        == "host→device"
    assert DL._host_copy("_to_copy", (cuda,), {"device": "cpu",
                                               "non_blocking": True}) is None
    assert DL._host_copy("_to_copy", (cuda,), {"dtype": torch.int64}) is None
    assert DL._host_copy("copy_", (cpu, cuda), {}) == "device→host"
    assert DL._host_copy("copy_", (cuda, cuda), {}) is None


def test_dispatch_catches_edge_node_materialization():
    found, _ = _record(lambda e, n: e[:, None] * n[None, :],
                       torch.zeros(512), torch.zeros(256), name="fab[EN]",
                       en_threshold=512 * 256 // 2)
    hits = [f for f in found if f.rule == "DSP-EN-MATERIALIZE"]
    assert hits, "[E, N] outer-product intermediate not caught"
    assert "131072" in hits[0].detail  # the materialized element count
    assert _new(hits)


def test_dispatch_attributes_findings_to_the_port_frame():
    from repro_torch.core.pagerank import _power_loop

    found, rec = _record(lambda r: _power_loop(lambda x: x * 0.5, r, 3, 0.0),
                         torch.ones(8), name="fab[loop]")
    where = {f.where for f in found if f.rule == "DSP-HOST-SYNC"}
    assert where == {"fab[loop]:src/repro_torch/core/pagerank.py:_power_loop"}
    assert rec.sync_sites == {"src/repro_torch/core/pagerank.py:_power_loop":
                              3}
    assert "[3 occurrences]" in found[0].detail


# ---------------------------------------------------------------------------
# injected memory violations
# ---------------------------------------------------------------------------


def test_memory_catches_peak_temp():
    budgets = MA.CollectiveBudgets(temp_bytes_max=1e6)
    found = MA.audit_memory(budgets, program="fab[temp]", largest_bytes=10,
                            peak_bytes=2e9)
    assert [f.rule for f in found] == ["MEM-TEMP"]
    assert "2.000e+09" in found[0].detail and _new(found)
    # the dispatch record's largest new tensor: a 16 MiB scratch buffer
    # against the spec's 8 MiB
    spec = PR.GraphSpec()
    _, rec = _record(lambda x: (x[:, None] * torch.ones(4096)).sum(0),
                     torch.ones(1024))
    assert rec.largest_bytes == 1024 * 4096 * 4
    found = MA.audit_memory(MA.budgets_for_spec(spec), program="fab[temp]",
                            largest_bytes=rec.largest_bytes,
                            largest_at=rec.largest_at)
    assert [f.where for f in found] == ["fab[temp]:temp"]
    assert "aten.mul" in found[0].detail and _new(found)


def test_memory_within_budget_is_clean():
    budgets = MA.CollectiveBudgets(temp_bytes_max=1e9)
    assert MA.audit_memory(budgets, program="fab", largest_bytes=1e6,
                           peak_bytes=1e6) == []
    assert MA.audit_memory(MA.CollectiveBudgets(), program="fab",
                           largest_bytes=1e12) == []
    # views and in-place results are not new memory
    _, rec = _record(lambda x: x.view(-1).add_(1.0)[:4], torch.ones(64, 64))
    assert rec.largest_bytes == 0


def test_spec_budgets_and_thresholds_match_reference():
    spec, ref = PR.GraphSpec(), JPR.GraphSpec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
    assert spec.edge_threshold == ref.edge_threshold == spec.edge_capacity // 2
    assert spec.en_threshold == ref.en_threshold == (
        spec.edge_capacity * spec.node_capacity // 2)
    # every budget the reference derives, the collective ones too
    assert dataclasses.asdict(MA.budgets_for_spec(spec)) == \
        dataclasses.asdict(JH.budgets_for_spec(ref))
    for e_cap in (16384, 2**30):
        assert dataclasses.asdict(MA.budgets_for_graph(e_cap)) == \
            dataclasses.asdict(JH.budgets_for_graph(e_cap))


# ---------------------------------------------------------------------------
# injected collective violations (recorded on a fake group of four ranks)
# ---------------------------------------------------------------------------


@pytest.fixture
def gather_trace():
    """The cost of one all-gather of a 128 KiB int32 buffer from each of
    four ranks (512 KiB: an edge stream of 16,384 slots replicated 8x),
    recorded by the dispatch cost counter as rank 0 of a fake group."""
    import torch.distributed as dist

    init_fake_mesh((4,), ("shards",), device_type="cpu")
    try:
        x = torch.zeros(32768, dtype=torch.int32)
        out = torch.empty(4 * 32768, dtype=torch.int32)
        with CostCounter() as cc:
            dist.all_gather_into_tensor(out, x)
        yield cc.cost
    finally:
        destroy_mesh()


def test_col_catches_oversized_all_gather(gather_trace):
    # budget: one 4-byte edge buffer at E_cap = 16384, 64 KiB
    budgets = MA.CollectiveBudgets(all_gather_max=4.0 * 16384)
    found = MA.audit_cost(gather_trace, budgets, program="fab[ag]")
    assert len(found) == 1 and found[0].rule == "COL-ALLGATHER-BYTES"
    assert found[0].pass_id == "collective"
    assert "5.243e+05" in found[0].detail  # measured bytes
    assert "6.554e+04" in found[0].detail  # the budget it broke
    assert _new(found)


def test_col_within_budget_is_clean(gather_trace):
    budgets = MA.CollectiveBudgets(all_gather_max=1e9)
    assert MA.audit_cost(gather_trace, budgets, program="fab[ag]") == []
    assert MA.audit_cost(gather_trace, MA.CollectiveBudgets(),
                         program="fab[ag]") == []


def test_col_catches_peak_temp(gather_trace):
    budgets = MA.CollectiveBudgets(temp_bytes_max=1e6)
    found = MA.audit_cost(gather_trace, budgets, program="fab[temp]",
                          temp_bytes=2e9)
    assert [f.rule for f in found] == ["MEM-TEMP"]


def test_col_spec_budgets_are_ordered():
    spec = PR.GraphSpec()
    b = MA.budgets_for_spec(spec)
    # bucket exchange << edge buffer << temp scratch: the budgets separate
    assert b.all_to_all_max < b.all_gather_max < b.temp_bytes_max
    assert spec.edge_threshold == spec.edge_capacity // 2
    assert spec.en_threshold == spec.edge_capacity * spec.node_capacity // 2
    assert F.pass_of_rule("COL-ALLGATHER-BYTES") == "collective"


# ---------------------------------------------------------------------------
# injected rebuild violations
# ---------------------------------------------------------------------------

_H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def timing_stub(monkeypatch):
    """The tuner's timing on the CPU: each candidate's time from a table
    (the real one times CUDA graphs on the card)."""
    monkeypatch.setattr(AT, "_time_candidate",
                        lambda key, tile, *, sample: 1.0 / tile)
    AT.clear_cache()
    yield
    AT.clear_cache()


def _key(e_pad=16384):
    return AT.TuneKey(e_pad=e_pad, n=1024, b=1, dtype="float32",
                      reduce="sum", platform=_H100)


def test_rebuild_catches_per_iteration_retune(timing_stub):
    with RebuildMonitor() as mon:
        AT.tune(_key(), "full", sample=object())
        warm = mon.snapshot()
        for _ in range(3):
            # a fabricated cache drop: every iteration searches again
            AT.clear_cache()
            AT.tune(_key(), "full", sample=object())
    found = mon.check_warm(warm, scenario="fab-loop")
    search = [f for f in found if ":autotune-search:" in f.where]
    assert search and search[0].rule == "RB-REBUILD"
    assert "3×" in search[0].detail  # one search per post-warm-up iteration
    timings = [f for f in found if ":autotune-timing:" in f.where]
    assert len(timings) == len(AT.candidates(_key()))
    assert _new(found)


def test_rebuild_stable_loop_is_clean(timing_stub):
    with RebuildMonitor() as mon:
        AT.tune(_key(), "full", sample=object())
        warm = mon.snapshot()
        for _ in range(3):
            AT.tune(_key(), "full", sample=object())  # a cache hit
    assert mon.check_warm(warm, scenario="fab-stable") == []
    assert mon.totals(mon.events)["autotune-search"] == 1


def test_rebuild_budget_contract(timing_stub):
    with RebuildMonitor() as mon:
        for _ in range(4):
            AT.clear_cache()
            AT.tune(_key(), "full", sample=object())
    name = f"autotune-search:{_key().as_str()}"
    found = mon.check({name: 1}, scenario="fab-budget")
    hits = [f for f in found if f.where == f"fab-budget:{name}"]
    assert hits and "4×" in hits[0].detail and "budget 1" in hits[0].detail
    assert _new(hits)


def test_rebuild_counts_compiles_not_cached_builds(tmp_path, monkeypatch):
    """A build ticks once, when the compiler runs: a second call of the
    same source and defines finds the library and compiles nothing."""
    nvcc = tmp_path / "fake_nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    src = tmp_path / "fab" / "csrc" / "fab.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// nothing\n")
    with RebuildMonitor() as mon:
        lib = build.build_library(src, ("MERGE_ITEMS=7",))
        warm = mon.snapshot()
        assert build.build_library(src, ("MERGE_ITEMS=7",)) == lib
    assert dict(warm) == {"build:fab.cu[MERGE_ITEMS=7]": 1}
    assert mon.check_warm(warm, scenario="fab") == []
    with RebuildMonitor() as mon:
        src.write_text("// edited\n")  # an edited source builds anew
        build.build_library(src, ("MERGE_ITEMS=7",))
    assert mon.check(default_max=0, scenario="fab")[0].rule == "RB-REBUILD"


@pytest.mark.parametrize("run", [PR.run_rebuild_scenario,
                                 PR.run_async_rebuild_scenario],
                         ids=["sync", "async"])
def test_rebuild_scenarios_clean_on_cpu(run):
    report = {}
    found = run(device="cpu", report=report)
    assert report["events_after_warm"] == {}
    assert not [f for f in found if f.rule == "RB-REBUILD"]
    assert _new(found) == [], "\n".join(map(str, _new(found)))
    # the engine loop's host reads are the baseline's sync sites
    assert "src/repro_torch/core/pagerank.py:_power_loop" in \
        report["host_sync_sites"]


@pytest.fixture
def tuned_on_cpu(timing_stub, monkeypatch):
    """The tuner as on the card: keys carry the H100's name (a CPU key
    always gets the default tile and never searches) and the candidates'
    times come from the stub (the largest tile is the fastest)."""
    monkeypatch.setattr(AT, "platform_of", lambda device: _H100)


@pytest.mark.parametrize("run", [PR.run_rebuild_scenario,
                                 PR.run_async_rebuild_scenario],
                         ids=["sync", "async"])
def test_rebuild_scenarios_tune_only_in_warm_up(tuned_on_cpu, run):
    report = {}
    found = run(device="cpu", report=report, autotune="full")
    assert report["warm_events"] == {
        "autotune-search": 1,
        "autotune-timing": len(AT.TILE_CANDIDATES)}
    assert report["events_after_warm"] == {}
    assert report["tiles"] == {"plus_times@b1": max(AT.TILE_CANDIDATES)}
    assert not [f for f in found if f.rule == "RB-REBUILD"]


def test_rebuild_scenario_cached_takes_the_loaded_tile(tuned_on_cpu,
                                                       tmp_path):
    PR.run_rebuild_scenario(device="cpu", autotune="full")
    path = tmp_path / "tiles.json"
    AT.save_cache(path)
    AT.clear_cache()
    assert AT.load_cache(path) == 1
    report = {}
    found = PR.run_rebuild_scenario(device="cpu", report=report,
                                    autotune="cached")
    assert report["warm_events"] == report["events_after_warm"] == {}
    assert report["tiles"] == {"plus_times@b1": max(AT.TILE_CANDIDATES)}
    assert AT.cache_hits() >= 1
    assert not [f for f in found if f.rule == "RB-REBUILD"]


def test_async_rebuild_scenario_catches_per_epoch_retune(tuned_on_cpu,
                                                         monkeypatch):
    from repro_torch.core.engine import VeilGraphEngine

    resolve = VeilGraphEngine._resolve_tiles

    def forgetful(self):
        # a fabricated fault: the engine's tiles and the tuner's cache are
        # dropped before every epoch's build, so each epoch searches again
        self._tiles.clear()
        AT.clear_cache()
        resolve(self)

    monkeypatch.setattr(VeilGraphEngine, "_resolve_tiles", forgetful)
    report = {}
    found = PR.run_async_rebuild_scenario(device="cpu", report=report,
                                          autotune="full")
    # rounds 3 and 4 each dispatch one epoch, and each epoch re-tunes
    assert report["events_after_warm"]["autotune-search"] == 2
    rb = [f for f in found if f.rule == "RB-REBUILD"]
    assert {f.where.split(":")[1] for f in rb} == {"autotune-search",
                                                    "autotune-timing"}
    assert all(f.where.startswith("engine-loop[pagerank,async]:")
               for f in rb)
    assert _new(rb) == rb


# ---------------------------------------------------------------------------
# injected AST violations
# ---------------------------------------------------------------------------


def _lint_source(rel: str, source: str, *, plugin_bases=None):
    linter = ast_lint._Linter(rel, source,
                              plugin_bases=plugin_bases
                              if plugin_bases is not None
                              else {"StreamingAlgorithm"})
    linter.visit(ast.parse(source))
    return linter.findings


def test_ast_catches_plugin_violations(tmp_path):
    bad = tmp_path / "fab_plugins.py"
    bad.write_text(
        "from dataclasses import dataclass\n"
        "import numpy as np\n"
        "import torch\n"
        "class NotFrozen(StreamingAlgorithm):\n"
        "    pass\n"
        "@dataclass(frozen=True)\n"
        "class HoldsTensor(StreamingAlgorithm):\n"
        "    weights: torch.Tensor\n"
        "    table: np.ndarray = None\n"
        "@dataclass(frozen=True)\n"
        "class TensorDefault(StreamingAlgorithm):\n"
        "    ranks = torch.zeros(4)\n"
        "class Transitive(NotFrozen):\n"
        "    pass\n")
    found = ast_lint.lint_files([bad], plugin_bases={"StreamingAlgorithm"})
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f)
    frozen = by_rule.get("AST-PLUGIN-FROZEN", [])
    assert {f.where.split(":")[-1] for f in frozen} == {
        "NotFrozen", "Transitive"}
    arrays = by_rule.get("AST-PLUGIN-ARRAY-FIELD", [])
    details = " | ".join(f.detail for f in arrays)
    # both fields of HoldsTensor: one finding per scope, with its count
    assert "weights" in details and "[2 occurrences]" in details
    assert "torch.zeros" in details
    assert _new(found)
    # the shipped plugins are frozen and tensor-free
    shipped = ast_lint.lint_files(
        [REPO / "src/repro_torch/core/algorithm.py"])
    assert not [f for f in shipped if f.rule.startswith("AST-PLUGIN")]


def test_ast_catches_hot_module_host_sync():
    # lint a fabricated source *as if* it were a hot module
    rel = "src/repro_torch/core/fused.py"
    found = _lint_source(rel, (
        "import numpy as np\n"
        "import torch\n"
        "def hot_step(x):\n"
        "    a = x.sum().item()\n"
        "    b = x.tolist()\n"
        "    c = x.cpu()\n"
        "    d = x.numpy()\n"
        "    torch.cuda.synchronize()\n"
        "    e = float(x.max())\n"
        "    f = bool((x > 0).any())\n"
        "    g = int(x[0])\n"
        "    h = np.asarray(x)\n"
        "    return a, b, c, d, e, f, g, h\n"))
    assert _rules(found).count("AST-HOST-SYNC") == 9
    assert all("hot_step" in f.where for f in found)
    assert _new(ast_lint.lint_files([]) + found, device=None)
    # the orchestration boundary is not a hot module
    assert _lint_source("src/repro_torch/core/engine.py",
                        "def read(x):\n    return x.tolist()\n") == []


def test_ast_inline_waiver_suppresses():
    rel = "src/repro_torch/core/fused.py"
    found = _lint_source(rel, (
        "def hot_step(s):\n"
        "    # analysis: allow(AST-HOST-SYNC): fabricated waiver test\n"
        "    return s.zero.item()\n"))
    assert found == []


def test_ast_catches_direct_segment_reduce_in_core():
    found = _lint_source("src/repro_torch/core/fake_algo.py", (
        "import torch\n"
        "def sweep(v, seg, out):\n"
        "    out.index_add_(0, seg, v)\n"
        "    out.scatter_reduce_(0, seg, v, reduce='amin')\n"
        "    return torch.segment_reduce(v, 'sum', lengths=seg)\n"))
    assert _rules(found) == ["AST-SEGMENT-REDUCE"] * 3
    assert _new(found)
    # ... the backend and the semiring's reduce are the dispatch points, and
    # a semiring's own segment_reduce is what the rule asks for
    for rel in ("src/repro_torch/core/backend.py",
                "src/repro_torch/core/semiring.py"):
        assert _lint_source(rel, (
            "def push(out, seg, v):\n"
            "    return out.index_add_(0, seg, v)\n")) == []
    assert _lint_source("src/repro_torch/core/fake_algo.py", (
        "def sweep(s, v, seg):\n"
        "    return s.segment_reduce(v, seg, num_segments=8)\n")) == []


def test_ast_catches_hardcoded_kernel_geometry():
    found = _lint_source("src/repro_torch/core/fused.py", (
        "import dataclasses\n"
        "from repro_torch.kernels.spmv.kernel import spmv_push, tile_defines\n"
        "def sweep(v, lay, src, w, ro):\n"
        "    lay = dataclasses.replace(lay, merge_tile=768)\n"
        "    d = tile_defines(3840)\n"
        "    e = ('MERGE_ITEMS=7',)\n"
        "    return spmv_push(v, src, w, ro, tile=768)\n"))
    assert _rules(found) == ["AST-KERNEL-GEOMETRY"] * 4
    details = " | ".join(f.detail for f in found)
    assert "merge_tile=768" in details and "tile=768" in details
    assert "tile 3840" in details and "MERGE_ITEMS=7" in details
    assert _new(found)
    # a tuned tile through a variable is the intended route, and the
    # kernel modules define geometry
    assert _lint_source("src/repro_torch/core/fused.py", (
        "def sweep(v, src, w, ro, lay):\n"
        "    return spmv_push(v, src, w, ro, tile=lay.merge_tile)\n")) == []
    assert _lint_source("src/repro_torch/kernels/spmv/autotune.py", (
        "def f(v, src, w, ro):\n"
        "    return spmv_push(v, src, w, ro, tile=768)\n")) == []


def test_ast_skip_list_excludes_lm_substrate():
    files = {p.as_posix() for p in ast_lint.iter_source_files()}
    assert not any("/models/" in f or "/train/" in f
                   or "flash_attention" in f for f in files)
    assert any(f.endswith("core/backend.py") for f in files)
    assert any(f.endswith("kernels/spmv/ops.py") for f in files)
    assert all((REPO / m).exists() for m in ast_lint.HOT_MODULES)


# ---------------------------------------------------------------------------
# clean tree vs the committed baseline
# ---------------------------------------------------------------------------


def test_baseline_entries_are_reasoned_and_known():
    baseline = F.load_baseline(BASELINE)
    names = {p.name for p in PR.catalog(device="cpu")} | {
        "engine-loop[pagerank]", "engine-loop[pagerank,async]"}
    for e in baseline:
        assert len(e.reason) > 40 and "TODO" not in e.reason, e.key
        assert F.pass_of_rule(e.rule) is not None, e.key
        if e.rule.startswith("DSP-"):
            assert e.where.split(":", 1)[0] in names, e.key
        if e.rule.startswith("AST-"):
            assert e.device is None, e.key
            assert (REPO / e.where.split(":", 1)[0]).exists(), e.key
    # the host reads ROADMAP entry 16 lists each have their entry
    keys = {e.key for e in baseline}
    for site in ("core/pagerank.py:_power_loop",
                 "core/pagerank.py:_power_loop_batched", "core/hits.py:hits",
                 "core/hits.py:_summarized_sweep",
                 "core/traversal.py:_fixed_point",
                 "core/hotset.py:select_hot_set",
                 "core/fused.py:_cold_coverage"):
        assert f"AST-HOST-SYNC::src/repro_torch/{site}" in keys, site


def test_ast_pass_clean_against_baseline():
    baseline = F.load_baseline(BASELINE)
    found = ast_lint.lint_files()
    new, _, stale = F.check(found, baseline, passes_run=["ast"])
    assert new == [], "new AST findings:\n" + "\n".join(map(str, new))
    assert stale == [], [e.key for e in stale]


def test_dispatch_pass_clean_on_hot_programs():
    cat = [p for p in PR.catalog(device="cpu")
           if p.name.startswith(("push[", "push_coo", "build_summary",
                                 "engine_apply", "epoch"))]
    assert len(cat) >= 7
    found = DL.lint_programs(cat)
    new, matched, _ = F.check(found, F.load_baseline(BASELINE),
                              device="cpu")
    assert new == [], "new dispatch findings:\n" + "\n".join(map(str, new))
    # the unsorted fallback is *in* the baseline, not silently unflagged
    assert any(f.where.startswith("push_coo") for f in matched)
    # the sorted push programs find nothing outside the kernels' plain
    # versions (which the card never runs on its path)
    assert all("kernels/spmv/kernel.py" in f.where for f in found
               if f.where.startswith(("push[", "push_batched[")))
    # the apply steps and the epoch counts are clean
    assert not [f for f in found if f.where.startswith(("engine_apply",
                                                        "epoch"))]


def _load_front_door():
    spec = importlib.util.spec_from_file_location(
        "analyze_torch", REPO / "tools" / "analyze_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analyze_torch_all_cpu_exits_zero(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert _load_front_door().main(["--all", "--device", "cpu", "--report",
                                    str(report)]) == 0
    out = capsys.readouterr().out
    # the collective pass ran the mesh programs (a fake group of four)
    assert "analyze: OK" in out and "push_sharded[pallas,mesh]" in out
    import json
    rep = json.loads(report.read_text())
    assert rep["ok"] and rep["device"] == "cpu" and rep["new"] == []
    assert rep["stale_baseline_entries"] == []


def test_analyze_torch_defaults_to_the_card():
    # no silent CPU fallback: without --device it needs a card
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_front_door().main(["--pass", "dispatch"])


# ---------------------------------------------------------------------------
# the catalog against the reference's, program for program
# ---------------------------------------------------------------------------

#: the port's program for each one-device reference program: the port has
#: one push per semiring (the device picks the kernel or its plain version)
PORT_OF = {"push[segment_sum,plus_times]": "push[plus_times]",
           "push[pallas,plus_times]": "push[plus_times]",
           "push[segment_sum,min_plus]": "push[min_plus]",
           "push[pallas,min_plus]": "push[min_plus]",
           "push_batched[pallas,plus_times]": "push_batched[plus_times]",
           "push_sharded[segment_sum,loop]": "push_sharded[loop]"}
BITWISE = ("push[min_plus]", "fused_query_step[sssp]")
#: the reference's mesh programs the port runs meshless, on the shard loop
MESHLESS = ("build_summary[sharded]", "fused_query_step[pagerank,sharded]")


def test_catalog_covers_the_reference_on_one_device():
    ref = [p.name for p in JPR.catalog(JPR.GraphSpec())]
    port = [p.name for p in PR.catalog(device="cpu")]
    assert len(port) == len(set(port)) == 17
    want = {PORT_OF.get(n, n) for n in ref if n not in PR.OMITTED}
    assert set(port) == want | set(MESHLESS)
    assert "push_sharded[segment_sum,loop]" in ref
    # nothing waits: the reference's mesh programs join the catalog given a
    # mesh of two or more ranks (a fake group of four here)
    assert PR.OMITTED == ()
    mesh = init_fake_mesh((2, 2), ("data", "model"), device_type="cpu")
    try:
        meshed = [p.name for p in PR.catalog(device="cpu", mesh=mesh)]
    finally:
        destroy_mesh()
    assert meshed[:17] == port
    assert set(meshed[17:]) == {
        "push_sharded[segment_sum,mesh]", "push_sharded[pallas,mesh]",
        "build_summary[sharded,mesh]",
        "fused_query_step[pagerank,sharded,mesh]"}


@pytest.fixture(scope="module")
def catalogs():
    ref = {p.name: p for p in JPR.catalog(JPR.GraphSpec())
           if "pallas" not in p.name}
    port = {p.name: p for p in PR.catalog(device="cpu")}
    return ref, port


def _leaves(obj, path="out"):
    """``{path: numpy array or python scalar}`` of a result of either
    package (NamedTuples, dicts, dataclasses, tuples; strings skipped)."""
    if isinstance(obj, (torch.Tensor, jax.Array, np.ndarray)):
        return {path: np.asarray(obj.numpy() if isinstance(obj, torch.Tensor)
                                 else obj)}
    if obj is None or isinstance(obj, str):
        return {}
    if isinstance(obj, (bool, int, float)):
        return {path: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = ((k, getattr(obj, k)) for k in obj._fields)
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = enumerate(obj)
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}.{k}"))
    return out


def _fresh(args):
    """Copies of a reference program's arrays: its apply step donates."""
    return jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True) if isinstance(x, jax.Array) else x,
        args)


@pytest.mark.parametrize("ref_name", [
    "push[segment_sum,plus_times]", "push[segment_sum,min_plus]",
    "push_batched[pallas,plus_times]", "push_coo[plus_times]",
    "push_sharded[segment_sum,loop]",
    "build_summary", "fused_query_step[pagerank]", "fused_query_step[sssp]",
    "fused_query_step[pagerank,drift]", "serving_wave[pagerank,batched]",
    "serving_wave[pagerank,batched,drift]", "serving_wave[ppr,seed-cold]",
    "engine_apply[add_edges]", "engine_apply[add_edges,preserving]",
    "epoch[snapshot_counts]"])
def test_catalog_program_matches_reference(catalogs, ref_name):
    ref_cat, port_cat = catalogs
    port = port_cat[PORT_OF.get(ref_name, ref_name)]
    if ref_name.startswith("push_batched"):
        # the reference's batched program forces the Pallas kernel (which
        # raises on this jax): its segment_sum push of the same bank
        rp = ref_cat["push[segment_sum,plus_times]"]
        from repro.core import backend as JB
        ranks, lay = rp.args
        want = JB.push(jnp.tile(ranks[None, :], (port.spec.batch, 1)), lay,
                       semiring="plus_times", backend="segment_sum")
    else:
        rp = ref_cat[ref_name]
        want = rp.fn(*_fresh(rp.args))
    _assert_same_leaves(port.run(), want, bitwise=port.name in BITWISE)


def _assert_same_leaves(got, want, *, bitwise: bool,
                        ignore: tuple = ()) -> None:
    """Every leaf of a port result against the reference's: integers and
    masks bitwise, floats bitwise or at ``TOL``.  Reference leaves named
    in ``ignore`` (metadata the port does not carry) are left out."""
    w, g = _leaves(want), _leaves(got)
    w = {k: v for k, v in w.items() if k.rsplit(".", 1)[-1] not in ignore}
    assert set(g) == set(w), (sorted(g), sorted(w))
    for k in w:
        a, b = g[k], w[k]
        if not isinstance(a, np.ndarray):
            # a host scalar of the port (an iteration count, a drift of a
            # step without drift) against the reference's 0-d array
            np.testing.assert_array_equal(np.asarray(b).item(), a, err_msg=k)
        elif b.dtype.kind != "f" or bitwise:
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)


@pytest.mark.parametrize("name", MESHLESS)
def test_meshless_sharded_program_matches_reference(catalogs, name):
    # the reference runs these two on a mesh only: here its flat program
    # of the same inputs, handed the reference's meshless shard loop
    from repro.graph.partition import build_sharded_layout as jbuild

    ref_cat, port_cat = catalogs
    port = port_cat[name]
    rp = ref_cat[name.split("[")[0] if name.startswith("build")
                 else "fused_query_step[pagerank]"]
    lay = jbuild(rp.args[0], num_shards=port.spec.num_shards,
                 weight="inv_out", semiring="plus_times")
    kw = ({"layout": lay} if name.startswith("build")
          else {"layouts": (lay,)})
    # the reference stamps the layout's chunk on a sharded summary; the
    # port's summaries keep the kernels' default geometry
    _assert_same_leaves(port.run(), rp.fn(*_fresh(rp.args), **kw),
                        bitwise=False, ignore=("tile_chunk",))


def test_rebalance_decision_stays_on_device():
    from repro_torch.graph.generators import gnm_edges
    from repro_torch.graph.graph import from_edges
    from repro_torch.graph.partition import (rebalance_decision,
                                             rebalance_sharded_layout,
                                             shard_slots)

    src, dst = gnm_edges(64, 256, seed=3)
    state = from_edges(src, dst, 64, 1024, device="cpu")
    slots = torch.from_numpy(shard_slots(state.edge_capacity, 4))
    should, imb = rebalance_decision(state, slots, 1.0)
    # the verdict pair is a device computation, not a host float
    assert isinstance(should, torch.Tensor) and should.dtype == torch.bool
    assert isinstance(imb, torch.Tensor) and imb.dtype == torch.float32
    # the wrapper agrees with the raw decision
    _, rebalanced, imbalance = rebalance_sharded_layout(
        state, num_shards=4, slots=slots, threshold=1.0)
    assert rebalanced == bool(should)
    assert imbalance == pytest.approx(float(imb))


def test_in_place_apply_gets_fresh_inputs(catalogs):
    _, port_cat = catalogs
    prog = port_cat["engine_apply[add_edges]"]
    state = prog.args[0]
    before = state.num_edges.clone()
    a, b = prog.run(), prog.run()
    assert torch.equal(state.num_edges, before)  # the catalog's state kept
    assert torch.equal(a.num_edges, b.num_edges)
    assert int(a.num_edges) == prog.spec.num_edges + prog.spec.apply_chunk
