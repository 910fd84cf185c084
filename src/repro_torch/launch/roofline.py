"""The push roofline: one SpMV push's bytes and operations against the
card's rates, and the gate that keeps the modeled bytes from growing
(PyTorch port of the push part of ``repro.launch.roofline``).

The bytes and operations come from the tuner's own model
(:func:`repro_torch.kernels.spmv.autotune.modeled_push_cost`), so the
tuner, this gate and the bound ``chip_smoke.py`` prints count the same
bytes.  ``push_roofline_baseline.json`` beside this file pins the modeled
HBM bytes of a few shapes; :func:`check_push_baselines` re-models each and
raises when one grew by more than the tolerance::

    PYTHONPATH=src python -c "from repro_torch.launch.roofline import \\
        check_push_baselines; check_push_baselines()"

(``update=True`` rewrites the file after an intended change of the model
or the kernels).  The HLO and collective parts of the reference's module
are not ported (ROADMAP queue 1 entry 16).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels.spmv import autotune as AT
from repro_torch.kernels.spmv.kernel import DEFAULT_TILE

#: the committed baseline of pinned push shapes
BASELINE = Path(__file__).resolve().parent / "push_roofline_baseline.json"
#: the card the pinned shapes are modeled on
DEFAULT_PLATFORM = "NVIDIA H100 80GB HBM3"


def _itemsize(dtype: Optional[str], default: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype or default)
                       ).element_size()


def push_roofline_check(*, edge_capacity: int, num_segments: int,
                        batch: int = 1, reduce: str = "sum",
                        dtype: str = "float32",
                        weight_dtype: Optional[str] = None,
                        tile: Optional[int] = None, masked: bool = False,
                        n_src: Optional[int] = None,
                        platform: str = DEFAULT_PLATFORM,
                        measured_s: Optional[float] = None,
                        baseline: Optional[Dict] = None,
                        tolerance: float = 0.10) -> Dict:
    """The roofline record of one push of ``edge_capacity`` edges into
    ``num_segments`` rows (from ``n_src`` values a batch row, default the
    rows), with optional gates.

    ``weight_dtype`` is the stored weight's dtype (``None`` = ``dtype``),
    ``tile`` the merge tile (``None`` = the default), ``masked`` whether a
    mask byte is read per edge.  ``measured_s``, a device time of the
    push, adds ``fraction_of_peak`` = bound / measured.  ``baseline``, a
    dict with a committed ``hbm_bytes``, raises ``AssertionError`` when the
    model now exceeds it by more than ``tolerance``.
    """
    tile = DEFAULT_TILE if tile is None else tile
    cost = AT.modeled_push_cost(
        e_pad=edge_capacity, n=num_segments, b=batch,
        itemsize=_itemsize(dtype, dtype),
        w_itemsize=_itemsize(weight_dtype, dtype), reduce=reduce, tile=tile,
        masked=masked, n_src=n_src, spec=AT.device_spec(platform))
    rec = {
        "edge_capacity": edge_capacity, "num_segments": num_segments,
        "batch": batch, "reduce": reduce, "dtype": dtype,
        "weight_dtype": weight_dtype or dtype, "tile": tile,
        "masked": masked, "platform": platform,
        "hbm_bytes": cost.hbm_bytes, "flops": cost.flops,
        "smem_bytes": cost.smem_bytes, "blocks": cost.blocks,
        "memory_s": cost.memory_s, "compute_s": cost.compute_s,
        "bound_time_s": cost.bound_time_s,
        "bound_by": ("bytes" if cost.memory_s >= cost.compute_s
                     else "operations"),
    }
    if n_src is not None:
        rec["n_src"] = n_src
    if measured_s is not None:
        rec["measured_s"] = measured_s
        rec["fraction_of_peak"] = (cost.bound_time_s / measured_s
                                   if measured_s > 0 else 0.0)
    if baseline is not None:
        base = float(baseline["hbm_bytes"])
        ratio = cost.hbm_bytes / base if base else float("inf")
        rec["baseline_hbm_bytes"] = base
        rec["hbm_ratio_vs_baseline"] = ratio
        if ratio > 1.0 + tolerance:
            raise AssertionError(
                f"modeled HBM traffic regressed {100 * (ratio - 1):.1f}% "
                f"(> {100 * tolerance:.0f}%) for push shape "
                f"E={edge_capacity} N={num_segments} B={batch} "
                f"reduce={reduce} w={rec['weight_dtype']} tile={tile}: "
                f"{cost.hbm_bytes:.6e} B vs baseline {base:.6e} B")
    return rec


#: the parameters a pinned shape may give
_SHAPE_KEYS = ("edge_capacity", "num_segments", "batch", "reduce", "dtype",
               "weight_dtype", "tile", "masked", "n_src", "platform")


def check_push_baselines(baseline_path=BASELINE, *, update: bool = False,
                         tolerance: float = 0.10) -> Dict:
    """Gate every pinned push shape of a baseline JSON (``{"shapes":
    {name: {parameters..., "hbm_bytes": ...}}}``): each is re-modeled and
    checked by :func:`push_roofline_check`.  ``update=True`` writes the
    current ``hbm_bytes`` and ``flops`` instead of checking.  Returns
    ``{name: record}``."""
    path = Path(baseline_path)
    payload = json.loads(path.read_text())
    out = {}
    for name, entry in sorted(payload.get("shapes", {}).items()):
        params = {k: entry[k] for k in _SHAPE_KEYS if k in entry}
        rec = push_roofline_check(
            **params,
            baseline=None if update else {"hbm_bytes": entry["hbm_bytes"]},
            tolerance=tolerance)
        out[name] = rec
        if update:
            entry["hbm_bytes"] = rec["hbm_bytes"]
            entry["flops"] = rec["flops"]
    if update:
        path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return out


__all__ = ["BASELINE", "check_push_baselines", "push_roofline_check"]
