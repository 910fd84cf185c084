"""Carry the JAX package's state into the port.

The JAX package's "weights" are its graph buffers, its edge layouts and its
algorithm state (a serving lane's slot bank too), and an LM's parameter
tree and its AdamW state.  Handed over as numpy arrays (``np.asarray`` of
each JAX array), these functions rebuild the port's tensors byte for byte
on ``device`` (the card unless another device is named), so both packages
can be fed exactly the same buffers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.backend import EdgeLayout
from repro_torch.core.pagerank import SummaryBuffers
from repro_torch.device import resolve_device
from repro_torch.graph.graph import GraphState
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import param_shapes
from repro_torch.train.optimizer import AdamWState

_LAYOUT_ARRAYS = ("src", "dst", "weight", "valid", "row_offsets", "order",
                  "rank")
_SUMMARY_ARRAYS = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                   "ek_row_offsets", "num_ek", "b_in", "num_eb", "overflow")


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def graph_state_from_numpy(arrays: Mapping[str, np.ndarray],
                           device=None) -> GraphState:
    """A :class:`GraphState` from arrays keyed by ``GraphState._fields``
    (``edge_len`` may be absent or ``None``)."""
    device = resolve_device(device)
    missing = [k for k in GraphState._fields
               if k != "edge_len" and k not in arrays]
    if missing:
        raise KeyError(f"graph arrays missing {missing}")
    return GraphState(**{
        k: None if arrays.get(k) is None else _tensor(arrays[k], device)
        for k in GraphState._fields})


def algo_state_from_numpy(arrays: Mapping[str, np.ndarray],
                          device=None) -> dict:
    """An algorithm state dict (e.g. ``{"ranks": ...}``, or a serving slot
    bank with ``[B, ...]`` leaves) from arrays."""
    device = resolve_device(device)
    return {k: _tensor(v, device) for k, v in arrays.items()}


def edge_layout_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                           **meta) -> EdgeLayout:
    """An :class:`EdgeLayout` from its array fields (``order``/``rank`` may
    be absent or ``None``); ``meta`` carries ``weight_mode``, ``reverse``,
    ``pad_chunk`` and ``semiring``."""
    device = resolve_device(device)
    return EdgeLayout(**{
        k: None if arrays.get(k) is None else _tensor(arrays[k], device)
        for k in _LAYOUT_ARRAYS}, **meta)


def summary_buffers_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                               *, weight_mode: str,
                               semiring: str) -> SummaryBuffers:
    """A flat :class:`SummaryBuffers` from its array fields (the counts and
    ``overflow`` as 0-d arrays); ``weight_mode``/``semiring`` record how
    ``ek_w`` and ``b_in`` were baked.  ``b_in`` is ``[K_cap]``, or the
    per-query ``[B, K_cap]`` of a summary built from a slot bank."""
    device = resolve_device(device)
    missing = [k for k in _SUMMARY_ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"summary arrays missing {missing}")
    return SummaryBuffers(**{k: _tensor(arrays[k], device)
                             for k in _SUMMARY_ARRAYS},
                          weight_mode=weight_mode, semiring=semiring)


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device=None) -> dict:
    """The port's LM parameter tree from the JAX ``init_params`` tree as
    numpy (``np.asarray`` of each leaf): the same nested keys, stacked
    ``[L, ...]`` leaves, shapes and dtypes, checked against
    ``params.build_defs(cfg)``."""
    device = resolve_device(device)

    def rebuild(arrays, want, path):
        if set(arrays) != set(want):
            raise KeyError(f"LM params at {path or 'the root'}: keys "
                           f"{sorted(arrays)}, expected {sorted(want)}")
        out = {}
        for k, spec in want.items():
            if isinstance(spec, dict):
                out[k] = rebuild(arrays[k], spec, f"{path}/{k}")
                continue
            t = _tensor(arrays[k], device)
            if tuple(t.shape) != spec[0] or t.dtype != spec[1]:
                raise ValueError(f"LM params at {path}/{k}: "
                                 f"{t.dtype}{tuple(t.shape)}, expected "
                                 f"{spec[1]}{spec[0]}")
            out[k] = t
        return out

    return rebuild(tree, param_shapes(cfg), "")


def adamw_state_from_numpy(state, cfg: ModelConfig,
                           device=None) -> AdamWState:
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from
    the JAX ``adamw_init``/``adamw_update`` state as numpy: an object with
    ``step``, ``mu`` and ``nu`` (JAX's ``AdamWState`` with numpy leaves),
    or a mapping with those keys.  The moments are checked as the
    parameters are (f32, like ``params.build_defs(cfg)``)."""
    device = resolve_device(device)
    get = (state.__getitem__ if isinstance(state, Mapping)
           else lambda k: getattr(state, k))
    step = np.asarray(get("step"))
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"AdamW step: {step.dtype}{step.shape}, expected "
                         f"a 0-d int32")
    return AdamWState(step=_tensor(step, device),
                      mu=lm_params_from_numpy(get("mu"), cfg, device),
                      nu=lm_params_from_numpy(get("nu"), cfg, device))
