"""Dispatch lint: every aten op a program dispatches, held to the hot
path's contracts (the PyTorch counterpart of ``repro.analysis.jaxpr_lint``).

PyTorch runs eagerly, so there is no program text to walk: a
:class:`DispatchRecorder` (a ``TorchDispatchMode``) sees each aten op as it
runs, with its operands and results, and applies the rules there:

- **DSP-F64** — no float64/complex128 tensor anywhere: the engine is an
  f32 (bf16-weight) system, and one stray wide dtype doubles the bytes.
- **DSP-WIDEN** — no int64 or float64 tensor among a program's outputs
  (the stored state), and every *edge-scale* int64 temporary
  (``spec.edge_threshold`` elements or more) counted by site: PyTorch's
  gathers and scatters want int64 indices, and the port casts at the op,
  never in the stored state.  The baseline lists those casts.
- **DSP-UNSORTED-SCATTER** — no ``scatter_add``, ``scatter_reduce``,
  ``index_add`` or accumulating ``index_put`` with an index of
  ``spec.edge_threshold`` elements or more: an edge-scale scatter (O(E)
  random writes) means some sweep bypassed the sorted layouts.  PyTorch
  has no sortedness flag, so the plain push's sorted reduce is flagged
  too and allowed by location.
- **DSP-EN-MATERIALIZE** — no tensor of ``spec.en_threshold`` elements or
  more: an ``[E, N]``-class buffer is the quadratic blowup a push-based
  system exists to avoid.
- **DSP-HOST-SYNC** — no op that reads the device from the host:
  ``_local_scalar_dense`` (``.item()`` and ``float()``/``int()``/
  ``bool()`` of a tensor), ``equal``, ``nonzero``, ``masked_select``,
  ``unique``, boolean-mask indexing, ``repeat_interleave`` without
  ``output_size`` (each sizes its output from the data), and blocking
  copies between the host and the card (``_to_copy``/``copy_``).

The kernels launch through ``ctypes`` (:mod:`repro_torch.kernels.build`),
so they are invisible here: only the torch work around them is seen.
``.tolist()`` and ``.numpy()`` of a CPU tensor dispatch nothing; the AST
lint (:mod:`~repro_torch.analysis.ast_lint`) is what catches them.

Every finding is attributed to the innermost frame under
``src/repro_torch/`` (outside this package) that led to the op, as
``program:file:function``, and aggregated per key with a count: the CPU
and the card report the same sites.  :attr:`DispatchRecorder.
largest_bytes` is the largest single new tensor the program made, which
:mod:`~repro_torch.analysis.memory_audit` budgets.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

_HERE = Path(__file__).resolve().parent
PORT_ROOT = _HERE.parent
REPO_ROOT = _HERE.parents[2]

#: dtypes banned outright on the hot path
_WIDE_DTYPES = (torch.float64, torch.complex128)
#: dtypes the stored state must never hold
_STATE_WIDE = (torch.int64, torch.float64)
#: scatters that reduce (plain ``index_put`` without accumulate and
#: ``scatter``/``index_copy`` overwrite and are order-independent)
_SCATTER_OPS = {"scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "index_add", "index_add_"}
_INDEX_PUT_OPS = {"index_put", "index_put_", "_index_put_impl_"}
#: ops whose result size or value needs the data on the host
_SYNC_OPS = {"_local_scalar_dense", "equal", "nonzero", "masked_select",
             "_unique", "_unique2", "unique_dim", "unique_consecutive",
             "unique_dim_consecutive"}

_MISS = object()
_LABELS: Dict[object, Optional[str]] = {}


def _label_of(code) -> Optional[str]:
    """``src/repro_torch/core/pagerank.py:_power_loop`` for a code object
    of the port (outside this package), else None."""
    try:
        path = Path(code.co_filename).resolve()
    except (OSError, ValueError):
        return None
    if PORT_ROOT not in path.parents or _HERE in path.parents \
            or path.parent == _HERE:
        return None
    qual = getattr(code, "co_qualname", code.co_name)
    qual = ".".join(p for p in qual.split(".") if p != "<locals>")
    try:
        rel = path.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        rel = path.as_posix()
    return f"{rel}:{qual}"


def caller_site(depth: int = 2) -> str:
    """The innermost port frame on the stack above ``depth``, as
    ``file:function`` (``<caller>`` when no port code is on the stack)."""
    f = sys._getframe(depth)
    while f is not None:
        code = f.f_code
        label = _LABELS.get(code, _MISS)
        if label is _MISS:
            label = _LABELS[code] = _label_of(code)
        if label is not None:
            return label
        f = f.f_back
    return "<caller>"


def _tensors(obj) -> Iterator[torch.Tensor]:
    """The tensors among an op's operands or results (lists included)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def output_leaves(obj, path: str = "out") -> Iterator[Tuple[str, object]]:
    """``(path, tensor)`` for every tensor in a program's result: tuples,
    named tuples, lists, dicts and dataclasses are walked."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from output_leaves(v, f"{path}.{k}")
    elif hasattr(obj, "_fields"):
        for k in obj._fields:
            yield from output_leaves(getattr(obj, k), f"{path}.{k}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for fld in dataclasses.fields(obj):
            yield from output_leaves(getattr(obj, fld.name),
                                     f"{path}.{fld.name}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from output_leaves(v, f"{path}[{i}]")


def _device_type(d) -> Optional[str]:
    return None if d is None else torch.device(d).type


def _host_copy(name: str, args, kwargs) -> Optional[str]:
    """``"device→host"``/``"host→device"`` for a blocking copy between
    the CPU and another device, else None."""
    if name == "_to_copy":
        src = args[0].device.type
        dst = _device_type(kwargs.get("device")) or src
        blocking = not kwargs.get("non_blocking", False)
    elif name == "copy_":
        dst, src = args[0].device.type, args[1].device.type
        blocking = not (args[2] if len(args) > 2
                        else kwargs.get("non_blocking", False))
    else:
        return None
    if not blocking or src == dst or "cpu" not in (src, dst):
        return None
    return "device→host" if dst == "cpu" else "host→device"


def _bool_index(indices) -> bool:
    return any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in indices)


@dataclasses.dataclass
class _Agg:
    finding: Finding
    count: int = 1


class DispatchRecorder(TorchDispatchMode):
    """Record every aten op run under it and apply the DSP rules.

    ``en_threshold``/``edge_threshold`` (elements) come from the
    program's :class:`~repro_torch.analysis.programs.GraphSpec`; ``None``
    disarms the ``[E, N]`` and the int64 rules and, as in the reference,
    flags every reducing scatter whatever its size.  After the run,
    :meth:`findings` gives one finding per (rule, site) with its count;
    ``ops`` counts the ops,
    ``largest_bytes``/``largest_at`` give the largest new tensor an op
    made (views and in-place results are not new) and ``sync_sites`` the
    host-read sites with their counts.
    """

    def __init__(self, program: str, *, en_threshold: Optional[int] = None,
                 edge_threshold: Optional[int] = None):
        super().__init__()
        self.program = program
        self.en_threshold = en_threshold
        self.edge_threshold = edge_threshold
        self.ops = 0
        self.largest_bytes = 0
        self.largest_at = ""
        self.sync_sites: collections.Counter = collections.Counter()
        self._agg: Dict[str, _Agg] = {}

    # -- bookkeeping ------------------------------------------------------

    def _emit(self, rule: str, where: str, detail: str) -> None:
        f = Finding(pass_id="dispatch", rule=rule,
                    where=f"{self.program}:{where}", detail=detail)
        agg = self._agg.get(f.key)
        if agg is None:
            self._agg[f.key] = _Agg(f)
        else:
            agg.count += 1

    def findings(self) -> List[Finding]:
        """One finding per key, the first occurrence's detail with the
        count appended when it repeats."""
        out = []
        for agg in self._agg.values():
            f = agg.finding
            if agg.count > 1:
                f = dataclasses.replace(
                    f, detail=f"{f.detail} [{agg.count} occurrences]")
            out.append(f)
        return out

    def check_outputs(self, result) -> None:
        """DSP-WIDEN over a program's result (the state it stores)."""
        for path, t in output_leaves(result):
            if t.dtype in _STATE_WIDE:
                self._emit(
                    "DSP-WIDEN", f"<output>:{path}",
                    f"output {path} is {t.dtype} {tuple(t.shape)}; the "
                    f"stored state is int32/f32 (cast to int64 at the op "
                    f"that needs it, not in the state)")

    # -- the rules ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        self._inspect(func.overloadpacket.__name__, func, args, kwargs, out)
        return out

    def _inspect(self, name, func, args, kwargs, out) -> None:
        site = None

        def where() -> str:
            nonlocal site
            if site is None:
                site = caller_site(4)
            return site

        ins = list(_tensors(args)) + list(_tensors(list(kwargs.values())))
        outs = list(_tensors(out))
        for role, ts in (("operand", ins), ("result", outs)):
            for t in ts:
                if t.dtype in _WIDE_DTYPES:
                    self._emit("DSP-F64", where(),
                               f"{role} of aten.{name} is {t.dtype} "
                               f"{tuple(t.shape)}; the hot path is f32 "
                               f"(bf16/f16 weights) only")
                    break
        in_ptrs = {t.untyped_storage().data_ptr() for t in ins
                   if t.layout == torch.strided}
        for t in outs:
            n = t.numel()
            if (self.edge_threshold is not None and t.dtype == torch.int64
                    and n >= self.edge_threshold):
                self._emit("DSP-WIDEN", where(),
                           f"aten.{name} makes an edge-scale int64 tensor "
                           f"{tuple(t.shape)} (threshold "
                           f"{self.edge_threshold}); 8 bytes an edge where "
                           f"the stored ids take 4")
            if self.en_threshold is not None and n >= self.en_threshold:
                self._emit("DSP-EN-MATERIALIZE", where(),
                           f"aten.{name} materializes {tuple(t.shape)} = "
                           f"{n} elements >= [E, N]-class threshold "
                           f"{self.en_threshold}; edge×vertex "
                           f"intermediates defeat the push formulation")
            if t.layout != torch.strided \
                    or t.untyped_storage().data_ptr() in in_ptrs:
                continue  # a view or an in-place result: nothing new
            nbytes = n * t.element_size()
            if nbytes > self.largest_bytes:
                self.largest_bytes = nbytes
                self.largest_at = f"{where()}:aten.{name}"

        idx_n = None
        if name in _SCATTER_OPS and len(args) > 2:
            idx_n = args[2].numel()
        elif name in _INDEX_PUT_OPS and (
                args[3] if len(args) > 3
                else kwargs.get("accumulate", False)):
            idx_n = max((t.numel() for t in args[1] if t is not None),
                        default=0)
        if idx_n is not None and (self.edge_threshold is None
                                  or idx_n >= self.edge_threshold):
            self._emit("DSP-UNSORTED-SCATTER", where(),
                       f"aten.{name} over {idx_n} indices (edge-scale "
                       f"threshold {self.edge_threshold}): an O(E) "
                       f"scatter; hot sweeps push through destination-"
                       f"sorted layouts")

        sync = None
        if name in _SYNC_OPS:
            sync = f"aten.{name}"
        elif name == "repeat_interleave" and \
                kwargs.get("output_size") is None and len(args) == 1:
            sync = "aten.repeat_interleave without output_size"
        elif name in ("index", "index_put", "index_put_",
                      "_index_put_impl_") and _bool_index(args[1]):
            sync = f"aten.{name} with a boolean mask"
        else:
            copy = _host_copy(name, args, kwargs)
            if copy is not None:
                sync = f"a blocking {copy} aten.{name}"
        if sync is not None:
            self.sync_sites[where()] += 1
            self._emit("DSP-HOST-SYNC", where(),
                       f"{sync}: the host waits for the device; compare "
                       f"on the device and read one verdict per query")


def record_program(prog, args: Optional[tuple] = None
                   ) -> Tuple[DispatchRecorder, object]:
    """Run one catalog :class:`~repro_torch.analysis.programs.Program`
    on ``args`` (default: fresh inputs from :meth:`~repro_torch.analysis.
    programs.Program.inputs`, made outside the recorder) under a recorder
    armed with its spec's thresholds; returns ``(recorder, result)``."""
    if args is None:
        args = prog.inputs()
    rec = DispatchRecorder(prog.name, en_threshold=prog.spec.en_threshold,
                           edge_threshold=prog.spec.edge_threshold)
    with rec:
        result = prog.fn(*args)
    rec.check_outputs(result)
    return rec, result


def lint_programs(programs: Iterable) -> List[Finding]:
    """The DSP findings of every program of a catalog (see
    :func:`repro_torch.analysis.programs.catalog`)."""
    findings: List[Finding] = []
    for prog in programs:
        findings.extend(record_program(prog)[0].findings())
    return findings
