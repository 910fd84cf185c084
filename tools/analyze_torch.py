#!/usr/bin/env python3
"""Front door for the repro_torch.analysis passes.

    PYTHONPATH=src python tools/analyze_torch.py --all --device cpu
    PYTHONPATH=src python tools/analyze_torch.py --pass ast --device cpu
    PYTHONPATH=src python tools/analyze_torch.py --all --report FILE.json

Runs the selected passes (default ``--all``: the dispatch lint and the
memory audit over the program catalog, the collective audit over its
mesh programs, the rebuild monitor and the dispatch lint over the two
canned engine loops, each untuned and under ``autotune="full"``, and the
AST lint), compares
every finding against ``src/repro_torch/analysis/baseline.json`` (the
entries that apply to the run's device type), and exits non-zero iff any
finding is NOT allowlisted there.  Stale baseline entries (fixed
violations) are warnings — delete them.

``--device`` defaults to the card, as every entry point of the port does,
and raises where there is none; ``--device cpu`` runs the catalog through
the kernels' plain versions.  The collective pass runs the catalog's mesh
programs as rank 0 of a fake process group of four ranks, a 2 x 2
``("data", "model")`` mesh on the device's type (the collectives move no
data; their sizes are what it audits), under a dispatch cost counter, and
holds the largest collective of each kind to the spec's budgets
(``COL-*``).  ``--update-baseline`` rewrites the
baseline to accept the current findings (scoped to the run's device type
where an entry is new) — review the diff and fill in the reason strings
before committing.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

_PASSES = ("dispatch", "memory", "collective", "rebuild", "ast")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="VeilGraph port: static and dispatch analysis passes")
    ap.add_argument("--all", action="store_true", help="every pass")
    ap.add_argument("--pass", dest="passes", type=str, default=None,
                    help=f"comma-separated subset of {_PASSES}")
    ap.add_argument("--device", type=str, default=None,
                    help="where the programs run (default: the card)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="default: src/repro_torch/analysis/baseline.json")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the JSON findings report here")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline accepting current findings "
                         "(fill in reason strings before committing)")
    args = ap.parse_args(argv)

    passes = (list(_PASSES) if args.all or not args.passes
              else [p.strip() for p in args.passes.split(",") if p.strip()])
    for p in passes:
        if p not in _PASSES:
            ap.error(f"unknown pass {p!r}; expected subset of {_PASSES}")

    from repro_torch.analysis import BASELINE
    from repro_torch.analysis import findings as F
    from repro_torch.device import resolve_device

    baseline_path = args.baseline or BASELINE
    device = resolve_device(args.device)
    all_findings = []
    notes = []

    if {"dispatch", "memory"} & set(passes):
        from repro_torch.analysis import dispatch_lint, memory_audit
        from repro_torch.analysis import programs as PR

        spec = PR.GraphSpec()
        cat = PR.catalog(spec, device=device)
        print(f"program catalog: {len(cat)} programs at "
              f"N={spec.node_capacity} E={spec.edge_capacity} "
              f"B={spec.batch} on {device}")
        for prog in cat:
            rec, _ = dispatch_lint.record_program(prog)
            got = []
            if "dispatch" in passes:
                got += rec.findings()
            if "memory" in passes:
                peak = None
                if device.type == "cuda":
                    peak = memory_audit.cuda_peak_bytes(
                        prog.fn, *prog.inputs())[1]
                got += memory_audit.audit_memory(
                    prog.budgets, program=prog.name,
                    largest_bytes=rec.largest_bytes,
                    largest_at=rec.largest_at, peak_bytes=peak)
            all_findings.extend(got)
            print(f"  {prog.name}: {rec.ops} ops, largest intermediate "
                  f"{rec.largest_bytes} B, {len(got)} finding(s)")

    if "collective" in passes:
        from repro_torch.analysis import memory_audit
        from repro_torch.analysis import programs as PR
        from repro_torch.launch.dispatch_cost import CostCounter
        from repro_torch.launch.mesh import destroy_mesh, init_fake_mesh

        spec = PR.GraphSpec()
        mesh = init_fake_mesh((2, 2), ("data", "model"),
                              device_type=device.type)
        try:
            progs = [p for p in PR.catalog(spec, device=device, mesh=mesh)
                     if p.name.endswith(",mesh]")]
            for prog in progs:
                inputs = prog.inputs()
                with CostCounter() as cc:
                    prog.fn(*inputs)
                got = memory_audit.audit_cost(cc.cost, prog.budgets,
                                              program=prog.name)
                all_findings.extend(got)
                print(f"  {prog.name}: collectives "
                      f"{dict(cc.cost.coll_counts)}, largest "
                      f"{dict(cc.cost.coll_max)} B, {len(got)} finding(s)")
        finally:
            destroy_mesh()

    if {"rebuild", "dispatch"} & set(passes):
        from repro_torch.analysis import programs as PR
        # untuned, then tuned from the process's empty tuner cache (on the
        # card the warm-up times the served key; a later search is RB-REBUILD)
        for mode in ("off", "full"):
            for run in (PR.run_rebuild_scenario,
                        PR.run_async_rebuild_scenario):
                report = {}
                got = [f for f in run(device=device, report=report,
                                      autotune=mode)
                       if f.pass_id in passes]
                all_findings.extend(got)
                print(f"  {report['scenario']} autotune={mode}: events in "
                      f"warm-up {report['warm_events']}, after "
                      f"{report['events_after_warm']}, {len(got)} "
                      f"finding(s)")

    if "ast" in passes:
        from repro_torch.analysis import ast_lint
        files = ast_lint.iter_source_files()
        got = ast_lint.lint_files(files)
        all_findings.extend(got)
        print(f"  ast    {len(files)} files: {len(got)} finding(s)")

    baseline = F.load_baseline(baseline_path)
    report = F.render_report(all_findings, baseline, passes_run=passes,
                             device=device.type)
    report["device"] = device.type
    report["notes"] = notes

    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1),
                               encoding="utf-8")
        print(f"report -> {args.report}")

    if args.update_baseline:
        kept = [e for e in baseline if not e.applies_to(device.type)
                or F.pass_of_rule(e.rule) not in passes]
        existing = {e.key: e for e in baseline if e.applies_to(device.type)}
        rows = [{"rule": e.rule, "where": e.where, "reason": e.reason,
                 **({"device": e.device} if e.device else {})} for e in kept]
        for f in sorted({f.key: f for f in all_findings}.values(),
                        key=lambda f: f.key):
            e = existing.get(f.key)
            rows.append({"rule": f.rule, "where": f.where,
                         "reason": e.reason if e else "TODO: justify or fix",
                         **({"device": e.device} if e and e.device else
                            {} if e or f.pass_id == "ast"
                            else {"device": device.type})})
        rows.sort(key=lambda r: (r["rule"], r["where"], r.get("device", "")))
        baseline_path.write_text(
            json.dumps({"allow": rows}, indent=1, ensure_ascii=False) + "\n",
            encoding="utf-8")
        print(f"baseline rewritten with {len(rows)} entr(ies) -> "
              f"{baseline_path}")
        return 0

    new, matched, stale = F.check(all_findings, baseline, passes_run=passes,
                                  device=device.type)
    for f in matched:
        print(f"  allowlisted: {f.key}")
    for e in stale:
        print(f"  STALE baseline entry (violation fixed — delete it): "
              f"{e.key}")
    for note in notes:
        print(f"  note: {note}")
    if new:
        print(f"\nanalyze: {len(new)} NEW finding(s) not in baseline:")
        for f in new:
            print(f"  {f}")
        return 1
    print(f"\nanalyze: OK — {len(all_findings)} finding(s), all "
          f"allowlisted; passes: {', '.join(passes)}; device: {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
