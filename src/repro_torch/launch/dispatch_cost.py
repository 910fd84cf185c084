"""Dispatch-level cost model: the FLOPs, bytes and collective bytes of one
device, counted op by op as a program runs (the PyTorch counterpart of
``repro.launch.hlo_cost``, which parses XLA's partitioned HLO).

PyTorch runs eagerly, so there is no program text: a :class:`CostCounter`
(a ``TorchDispatchMode``) sees each aten op as it runs and applies the
reference's counting rules to the tensors it was given:

- flops: a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``) counts ``2·numel(out)·K``; an elementwise op ``numel(out)``; a
  reduction ``numel(in)``;
- bytes: every op reads its operands and writes its output; view ops are
  free; a gather counts the bytes it touches (its output twice and its
  indices), a scatter twice its updates;
- collectives, by kind (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``): an all-reduce counts twice its
  buffer, the others once, the buffer being the larger of what an op is
  given and what it returns (as the reference's analyzer takes
  ``max(operands, result)``; a process-group op, which is given its
  output, its largest tensor).  :attr:`Cost.coll_max` keeps the largest
  single op of each kind, :attr:`Cost.coll_counts` their counts.

On a ``DTensor`` the counter returns ``NotImplemented`` (as
``torch.distributed.tensor.debug.CommDebugMode`` does), so that DTensor
dispatches first and the counter sees what it issues: the ops on this
rank's local shards and the collectives of its redistributions.  So every
number is one device's, on the local tensors.  An eager loop dispatches
every iteration, so no trip count is needed.  The counter also keeps the
bytes of the tensors the run made that are still alive and their peak
(:attr:`Cost.peak_bytes`), the counterpart of XLA's temporary bytes.

Under a fake process group no collective moves data, and under
``FakeTensorMode`` no op computes: the counts are a model of the device,
never an answer and never a time.  :mod:`repro_torch.analysis.memory_audit`
holds the collective counts to their budgets, and
:mod:`repro_torch.launch.roofline` turns a :class:`Cost` into roofline
terms.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: collective ops by name: the process-group ops (``torch.ops.c10d``) and
#: the functional ones DTensor issues (``torch.ops._c10d_functional``)
_COLL_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}

_MATMUL_K = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1,
             "baddbmm": 1, "addmv": 1, "addbmm": 1}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "any", "all", "cumsum", "cumprod", "cummax", "cummin",
    "_log_softmax", "_softmax", "nansum", "count_nonzero", "sort", "topk",
    "_log_softmax_backward_data", "_softmax_backward_data",
}

_GATHERS = {"gather", "index", "index_select", "embedding", "take"}
_SCATTERS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_put",
             "index_put_", "_index_put_impl_", "index_add", "index_add_",
             "index_copy", "index_copy_", "embedding_dense_backward"}

#: ops that move no data: allocation without a fill, metadata, waits
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "wait_tensor",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "set_", "resize_",
         "_unsafe_view", "record_stream"}


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Cost:
    """One device's counts (the reference's ``hlo_cost.Cost``, with the
    memory counts of its ``memory_analysis``)."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the largest single op's buffer of each collective kind (bytes, not
    #: doubled): what shows that a whole sharded buffer crossed the mesh
    coll_max: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: bytes of the tensors made during the run still alive, and their peak
    live_bytes: int = 0
    peak_bytes: int = 0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def to_dict(self) -> dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "bytes": self.bytes, "ops": self.ops,
                "collective_bytes": self.collective_bytes,
                "coll": dict(self.coll),
                "coll_counts": dict(self.coll_counts),
                "coll_max": dict(self.coll_max),
                "peak_bytes": self.peak_bytes}


#: DTensor's sharding propagation runs each op once more on fake tensors
#: of the global shapes, to learn the output's shape; those calls are not
#: the device's work, and the counter skips them
_AT_GLOBAL_SHAPES = threading.local()


def _global_shape_pass(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _AT_GLOBAL_SHAPES.depth = getattr(_AT_GLOBAL_SHAPES, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _AT_GLOBAL_SHAPES.depth -= 1
    wrapped.__wrapped_by_cost_counter__ = True
    return wrapped


def _mark_global_shape_pass() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if not getattr(fn, "__wrapped_by_cost_counter__", False):
        ShardingPropagator._propagate_tensor_meta_non_cached = (
            _global_shape_pass(fn))


class CostCounter(TorchDispatchMode):
    """Count the ops run under it into :attr:`cost` (see the module
    docstring).  ``with CostCounter() as cc: step(...)`` then
    ``cc.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        _mark_global_shape_pass()

    def _free(self, n: int) -> None:
        self.cost.live_bytes -= n

    def _track(self, out, func) -> None:
        if func.is_view:
            return
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            if n == 0:
                continue
            try:
                weakref.finalize(t, self._free, n)
            except TypeError:
                continue
            c = self.cost
            c.live_bytes += n
            c.peak_bytes = max(c.peak_bytes, c.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_AT_GLOBAL_SHAPES, "depth", 0):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        c = self.cost
        c.ops += 1
        if func.is_view or name in _FREE:
            return
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        in_b, out_b = _nbytes(ins), _nbytes(outs)
        kind = _COLL_KIND.get(name)
        if kind is not None:
            # a process-group op takes its output buffer as an argument:
            # its buffer is its largest tensor; a functional one returns it
            raw = float(max((_nbytes([t]) for t in ins + outs), default=0)
                        if name.endswith("_") or name == "send"
                        else max(in_b, out_b))
            c.coll[kind] = c.coll.get(kind, 0.0) + (
                2.0 if kind == "all-reduce" else 1.0) * raw
            c.coll_counts[kind] = c.coll_counts.get(kind, 0.0) + 1
            c.coll_max[kind] = max(c.coll_max.get(kind, 0.0), raw)
            c.bytes += in_b + out_b
            return
        self._track(out, func)
        out_n = sum(t.numel() for t in outs)
        if name in _MATMUL_K:
            a = args[_MATMUL_K[name]]
            f = 2.0 * out_n * max(a.shape[-1], 1)
            c.flops += f
            c.matmul_flops += f
            c.bytes += in_b + out_b
        elif name in _GATHERS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            c.bytes += 2 * out_b + _nbytes(idx)
        elif name in _SCATTERS:
            upd = ins[1:]
            c.bytes += 2 * _nbytes(upd)
            if name.startswith(("scatter", "index_add", "index_put",
                                "_index_put")):
                c.flops += out_n
        elif name in _REDUCTIONS:
            c.flops += ins[0].numel() if ins else 0
            c.bytes += in_b + out_b
        elif torch.Tag.pointwise in func.tags:
            c.flops += out_n
            c.bytes += in_b + out_b
        else:
            c.bytes += in_b + out_b


__all__ = ["COLLECTIVES", "Cost", "CostCounter"]
