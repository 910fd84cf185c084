"""Project AST lint: source-level convention checks for the engine surface
(PyTorch port of ``repro.analysis.ast_lint``).

Pure-stdlib (``ast``) rules over ``src/repro_torch``, scoped to the
VeilGraph engine — the LM substrate (:data:`SKIP_LIST`) is excluded so the
pass maps exactly to the graph system:

- **AST-SEGMENT-REDUCE** — no direct ``scatter_reduce``/``scatter_add``/
  ``index_add`` (method or function) or ``torch.segment_reduce`` in
  ``core/`` outside ``backend.py`` and ``semiring.py``: every sweep goes
  through :func:`repro_torch.core.backend.push` (or the semiring's one
  reduce, ``Semiring.segment_reduce``), so layouts, masks and sortedness
  cannot drift per call site.
- **AST-PLUGIN-FROZEN** / **AST-PLUGIN-ARRAY-FIELD** — every
  ``StreamingAlgorithm`` subclass must be a ``@dataclass(frozen=True)``
  (a hashable, immutable description of the workload) and must never
  declare a ``torch.Tensor``/``np.ndarray`` field or an array default:
  per-query state belongs in ``per_query_params``/``init_state``, never on
  the plugin.
- **AST-HOST-SYNC** — no ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize`` and the
  event and stream forms), ``np.asarray(...)`` or ``float(...)``/
  ``int(...)``/``bool(...)`` of a computed value inside the hot modules
  (:data:`HOT_MODULES`): each is a device→host read that stalls the
  launch queue.  The engine/serving orchestration layers are the
  designated host boundary and are deliberately not in the hot list.
  ``.tolist()`` and ``.numpy()`` of a CPU tensor dispatch no aten op, so
  this rule, not the dispatch lint, is what sees them.
- **AST-KERNEL-GEOMETRY** — call sites must not hardcode a literal
  merge-path tile (``tile=``/``merge_tile=`` on a kernel wrapper,
  ``EdgeLayout`` or a ``replace`` of one, ``tile_defines(<int>)``) or a
  ``"MERGE_ITEMS=<n>"`` define outside the kernel/tuner modules and the
  backend: the tile flows from the tuner through the layout
  (``EngineConfig.autotune`` → ``EdgeLayout.merge_tile`` → ``push``), so a
  literal at a call site silently pins an untuned shape.

Intentional violations are either allowlisted in
``src/repro_torch/analysis/baseline.json`` (with a reason) or waived inline
with a ``# analysis: allow(RULE): reason`` comment on the offending line
(or the line above).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.findings import Finding

REPO_ROOT = Path(__file__).resolve().parents[3]

#: the LM substrate — transformer models, their training/serving drivers
#: and the attention kernels.  Excluded so the lint's scope is exactly the
#: VeilGraph engine surface; paths are repo-relative prefixes.
SKIP_LIST: tuple = (
    "src/repro_torch/models/",
    "src/repro_torch/train/",
    "src/repro_torch/configs/",
    "src/repro_torch/data/",
    "src/repro_torch/kernels/decode_attention/",
    "src/repro_torch/kernels/flash_attention/",
    "src/repro_torch/launch/train.py",     # LM training driver
    "src/repro_torch/launch/serve.py",     # LM serving driver
    "src/repro_torch/serve/engine.py",     # LM continuous batching
)

#: modules where a hidden device→host read is a hot-path bug, not a
#: convenience: the propagation primitives, the fused query/summary path,
#: the layout builder and the SpMV kernels' wrappers — everything that runs
#: per query or per applied update batch.  ``core/engine.py`` and
#: ``serve/graph.py`` are the host orchestration boundary and
#: intentionally absent.
HOT_MODULES: tuple = (
    "src/repro_torch/core/backend.py",
    "src/repro_torch/core/epoch.py",
    "src/repro_torch/core/fused.py",
    "src/repro_torch/core/hits.py",
    "src/repro_torch/core/hotset.py",
    "src/repro_torch/core/katz.py",
    "src/repro_torch/core/pagerank.py",
    "src/repro_torch/core/semiring.py",
    "src/repro_torch/core/traversal.py",
    "src/repro_torch/graph/csr.py",
    "src/repro_torch/graph/partition.py",
    "src/repro_torch/kernels/spmv/kernel.py",
    "src/repro_torch/kernels/spmv/ops.py",
)

#: ``core/`` modules allowed to scatter-reduce directly: the propagation
#: backend and the semiring's one reduce
SEGMENT_REDUCE_ALLOWED: tuple = ("src/repro_torch/core/backend.py",
                                 "src/repro_torch/core/semiring.py")

#: callees whose ``tile=``/``merge_tile=`` must come from the tuner (a
#: variable or a layout stamp), never a literal at the call site
_GEOMETRY_CALLEES = {
    "spmv_push", "spmv_push_batched", "spmv_reduce_push",
    "spmv_reduce_push_batched", "semiring_push", "pagerank_push",
    "EdgeLayout", "replace", "_replace", "tile_defines",
}
_GEOMETRY_KWARGS = {"tile", "merge_tile"}
#: a whole ``-D`` define string fixing the merge items a thread
_MERGE_ITEMS_RE = re.compile(r"-?D?MERGE_ITEMS\s*=\s*\d+")
#: modules that *define* geometry: the kernels, their tuner, and the
#: backend's layout builders
_GEOMETRY_ALLOWED: tuple = (
    "src/repro_torch/kernels/spmv/",
    "src/repro_torch/core/backend.py",
)

_SCATTER_FNS = {"scatter_reduce", "scatter_reduce_", "scatter_add",
                "scatter_add_", "index_add", "index_add_"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

_WAIVER_RE = re.compile(r"#\s*analysis:\s*allow\(([A-Z0-9\-, ]+)\)")

_ARRAY_ANNOTATIONS = re.compile(
    r"\b(torch\.Tensor|Tensor|np\.ndarray|numpy\.ndarray|ArrayLike)\b")
_ARRAY_FACTORIES = {"tensor", "as_tensor", "from_numpy", "array", "asarray",
                    "zeros", "ones", "full", "arange", "linspace", "empty",
                    "zeros_like", "ones_like", "full_like", "rand", "randn"}


def _rel(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def _skipped(rel: str) -> bool:
    return any(rel == s or rel.startswith(s) for s in SKIP_LIST)


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _waivers(source: str) -> Dict[int, Set[str]]:
    """Line → waived rule ids, from ``# analysis: allow(RULE): reason``."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = rules
    return out


class _ScopeVisitor(ast.NodeVisitor):
    """Tracks the enclosing def/class name for stable ``where`` keys."""

    def __init__(self):
        self.scope: List[str] = []

    def _scope_name(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def visit_FunctionDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()


class _Linter(_ScopeVisitor):
    def __init__(self, rel: str, source: str, *,
                 plugin_bases: Set[str]):
        super().__init__()
        self.rel = rel
        self.findings: List[Finding] = []
        self.waivers = _waivers(source)
        self.plugin_bases = plugin_bases
        self.in_core = rel.startswith("src/repro_torch/core/")
        self.is_hot = rel in HOT_MODULES
        self.segment_ok = rel in SEGMENT_REDUCE_ALLOWED
        self.geometry_ok = any(rel == g or rel.startswith(g)
                               for g in _GEOMETRY_ALLOWED)

    def _emit(self, rule: str, node: ast.AST, detail: str) -> None:
        line = getattr(node, "lineno", 0)
        for waived_line in (line, line - 1):
            if rule in self.waivers.get(waived_line, set()):
                return
        self.findings.append(Finding(
            pass_id="ast", rule=rule,
            where=f"{self.rel}:{self._scope_name()}",
            detail=f"line {line}: {detail}"))

    # -- AST-SEGMENT-REDUCE / AST-HOST-SYNC / AST-KERNEL-GEOMETRY ----------

    def _segment_reduce(self, node: ast.AST, name: str,
                        dotted: str) -> None:
        if not self.in_core or self.segment_ok:
            return
        if name in _SCATTER_FNS or dotted in (
                "torch.segment_reduce", "torch._segment_reduce",
                "segment_reduce"):
            self._emit(
                "AST-SEGMENT-REDUCE", node,
                f"direct {dotted or name} in core/ — route the reduce "
                f"through repro_torch.core.backend.push (or the semiring's "
                f"segment_reduce) so sortedness/masking can't drift per "
                f"site")

    def visit_Call(self, node: ast.Call):
        name = _call_name(node)
        dotted = _dotted(node.func)

        if self.is_hot:
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS:
                self._emit(
                    "AST-HOST-SYNC", node,
                    f".{node.func.attr}() in a hot module — a device→host "
                    f"read that stalls the launch queue; keep the value on "
                    f"the device and read once at the engine/serving "
                    f"boundary")
            elif dotted in ("np.asarray", "numpy.asarray"):
                self._emit(
                    "AST-HOST-SYNC", node,
                    "np.asarray() in a hot module forces a device→host "
                    "copy when handed a device tensor; keep hot-path data "
                    "in torch")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and node.args
                  and isinstance(node.args[0],
                                 (ast.Call, ast.Subscript))):
                self._emit(
                    "AST-HOST-SYNC", node,
                    f"{node.func.id}(...) of a computed value in a hot "
                    f"module — an implicit device→host read; compare on "
                    f"device and transfer one verdict instead")

        if not self.geometry_ok and name in _GEOMETRY_CALLEES:
            lits = [f"{kw.arg}={kw.value.value}" for kw in node.keywords
                    if kw.arg in _GEOMETRY_KWARGS
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, int)]
            if name == "tile_defines" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, int):
                lits.append(f"tile {node.args[0].value}")
            for lit in lits:
                self._emit(
                    "AST-KERNEL-GEOMETRY", node,
                    f"{name}({lit}) hardcodes the merge-path tile at the "
                    f"call site — route it through the tuner "
                    f"(repro_torch.kernels.spmv.autotune.tune_for_push) or "
                    f"the layout's stamped merge_tile")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        # references count too: stashing Tensor.index_add_ in a dispatch
        # table is still a direct scatter at this site
        self._segment_reduce(node, node.attr, _dotted(node))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        # a bare imported name (``from torch import segment_reduce``)
        if node.id in _SCATTER_FNS or node.id == "segment_reduce":
            self._segment_reduce(node, node.id, node.id)

    def visit_Constant(self, node: ast.Constant):
        if (not self.geometry_ok and isinstance(node.value, str)
                and _MERGE_ITEMS_RE.fullmatch(node.value.strip())):
            self._emit(
                "AST-KERNEL-GEOMETRY", node,
                f"{node.value!r} hardcodes the merge items a thread at the "
                f"call site — build through "
                f"repro_torch.kernels.spmv.kernel.tile_defines of a tuned "
                f"tile")

    # -- AST-PLUGIN-FROZEN / AST-PLUGIN-ARRAY-FIELD -------------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        base_names = {_dotted(b) or getattr(b, "id", "") for b in node.bases}
        base_names = {b.split(".")[-1] for b in base_names if b}
        is_plugin = bool(base_names & self.plugin_bases)
        if is_plugin:
            self.plugin_bases.add(node.name)  # transitive subclasses
        self.scope.append(node.name)
        if is_plugin:
            self._check_plugin(node)
        self.generic_visit(node)
        self.scope.pop()

    def _check_plugin(self, node: ast.ClassDef) -> None:
        frozen = False
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and \
                    _dotted(dec.func).split(".")[-1] == "dataclass":
                for kw in dec.keywords:
                    if kw.arg == "frozen" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is True:
                        frozen = True
        if not frozen:
            self._emit(
                "AST-PLUGIN-FROZEN", node,
                f"StreamingAlgorithm subclass {node.name!r} is not a "
                f"@dataclass(frozen=True) — a plugin is a hashable, "
                f"immutable description of the workload; a mutable one "
                f"silently goes stale between queries")
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and \
                    isinstance(item.target, ast.Name):
                ann = ast.unparse(item.annotation)
                if _ARRAY_ANNOTATIONS.search(ann):
                    self._emit(
                        "AST-PLUGIN-ARRAY-FIELD", item,
                        f"plugin field {item.target.id!r} annotated "
                        f"{ann!r} — plugins must never store tensors; "
                        f"per-query state belongs in "
                        f"init_state/per_query_params")
                value = item.value
            elif isinstance(item, ast.Assign):
                value = item.value
            else:
                continue
            if isinstance(value, ast.Call):
                mod = _dotted(value.func)
                if (_call_name(value) in _ARRAY_FACTORIES
                        and mod.split(".")[0] in ("torch", "np", "numpy")):
                    self._emit(
                        "AST-PLUGIN-ARRAY-FIELD", item,
                        f"plugin field default calls {mod}() — an array "
                        f"default makes the plugin unhashable (and leaks "
                        f"one tensor across every query); use "
                        f"init_state/per_query_params")


def iter_source_files(root: Path = REPO_ROOT) -> List[Path]:
    """Every lint-scoped python file: ``src/repro_torch`` minus the
    skip-list."""
    out = []
    for p in sorted((root / "src" / "repro_torch").rglob("*.py")):
        if not _skipped(_rel(p)):
            out.append(p)
    return out


def lint_files(paths: Optional[Iterable[Path]] = None,
               *, plugin_bases: Optional[Set[str]] = None) -> List[Finding]:
    """Run every AST rule over ``paths`` (default: the scoped tree).

    ``plugin_bases`` seeds the ``StreamingAlgorithm`` lineage (tests pass
    it to lint fabricated files in isolation); subclasses found during the
    walk extend it, so transitive plugins in later files are covered.
    """
    findings: List[Finding] = []
    bases = plugin_bases if plugin_bases is not None else {
        "StreamingAlgorithm"}
    for path in (iter_source_files() if paths is None else list(paths)):
        source = Path(path).read_text(encoding="utf-8")
        try:
            tree = ast.parse(source)
        except SyntaxError as e:  # pragma: no cover - tree is parseable
            findings.append(Finding(
                pass_id="ast", rule="AST-SYNTAX",
                where=f"{_rel(Path(path))}:<module>",
                detail=f"unparseable: {e}"))
            continue
        linter = _Linter(_rel(Path(path)), source, plugin_bases=bases)
        linter.visit(tree)
        findings.extend(linter.findings)
    # aggregate repeats of one (rule, scope): the key is what baselines
    # match on, so N sites in one scope are one finding with a count
    seen: Dict[str, Finding] = {}
    counts: Dict[str, int] = {}
    for f in findings:
        if f.key not in seen:
            seen[f.key] = f
            counts[f.key] = 1
        else:
            counts[f.key] += 1
    out = []
    for key, f in seen.items():
        if counts[key] > 1:
            f = Finding(f.pass_id, f.rule, f.where,
                        f"{f.detail} [{counts[key]} occurrences]")
        out.append(f)
    return out
