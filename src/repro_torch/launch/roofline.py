"""Roofline terms on the card (the PyTorch port of
``repro.launch.roofline``): one SpMV push's bytes and operations against
the card's rates with the gate that keeps the modeled bytes from growing,
and a dry run cell's per-device counts (:mod:`repro_torch.launch.
dispatch_cost`) as compute, memory and collective times.

The push's bytes and operations come from the tuner's own model
(:func:`repro_torch.kernels.spmv.autotune.modeled_push_cost`), so the
tuner, this gate and the bound ``chip_smoke.py`` prints count the same
bytes.  ``push_roofline_baseline.json`` beside this file pins the modeled
HBM bytes of a few shapes; :func:`check_push_baselines` re-models each and
raises when one grew by more than the tolerance::

    PYTHONPATH=src python -c "from repro_torch.launch.roofline import \\
        check_push_baselines; check_push_baselines()"

(``update=True`` rewrites the file after an intended change of the model
or the kernels).

A cell's :class:`Roofline` divides its counts by the card's peak rates,
NVIDIA's H100 SXM datasheet figures for NVIDIA H100 80GB HBM3 at 700.00 W
(not measured): :data:`PEAK_FLOPS_BF16` dense bf16 on the tensor cores,
:data:`HBM_BW` and :data:`NVLINK_BW` a direction.  A 256- or 512-card
mesh spans nodes, whose links are slower than NVLink, so the collective
term is a lower bound.
"""

from __future__ import annotations

import dataclasses
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
#: the card's dense bf16 tensor-core rate, FLOP/s (H100 SXM datasheet)
PEAK_FLOPS_BF16 = 989e12
#: its HBM3 rate, bytes/s (H100 SXM datasheet)
HBM_BW = 3.35e12
#: its NVLink rate a direction, bytes/s (H100 SXM datasheet: 900 GB/s
#: both ways)
NVLINK_BW = 450e9


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


# ---------------------------------------------------------------------------
# A dry run cell's roofline
# ---------------------------------------------------------------------------


def collective_bytes(cost) -> Dict[str, float]:
    """Per-kind collective bytes of one device from a recorded cost
    (:class:`~repro_torch.launch.dispatch_cost.Cost`: an all-reduce twice
    its buffer, the others once), with their counts under ``"counts"``."""
    return {**cost.coll, "counts": dict(cost.coll_counts)}


@dataclasses.dataclass
class Roofline:
    """One cell's per-device counts against the card's rates."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    model_flops: float              # 6·N_active·D analytic, global a step
    memory_stats: Optional[Dict[str, float]] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """Model flops over counted flops (global): the work remat and
        redundancy add."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """The model flops' compute time a device over the bound time."""
        useful_s = (self.model_flops / self.chips) / PEAK_FLOPS_BF16
        return useful_s / self.bound_time_s if self.bound_time_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_stats": self.memory_stats,
            "rates": {"card": DEFAULT_PLATFORM, "power_limit_w": 700.0,
                      "peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "source": "datasheet"},
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic model flops a step: 6·N_active·D in training, 2·N_active·D
    otherwise (forward only); a decode step counts its one new token a
    sequence."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def analyze(cost, *, arch: str, shape, mesh_name: str, chips: int, cfg,
            memory_stats: Optional[Dict[str, float]] = None) -> Roofline:
    """The :class:`Roofline` of one cell from its recorded per-device cost
    (:class:`~repro_torch.launch.dispatch_cost.Cost`); ``memory_stats``
    (argument, output and peak temporary bytes) rides along."""
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        collective_bytes_per_device=float(cost.collective_bytes),
        collective_breakdown=collective_bytes(cost),
        model_flops=model_flops_for(cfg, shape),
        memory_stats=memory_stats)


__all__ = ["BASELINE", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "Roofline",
           "analyze", "check_push_baselines", "collective_bytes",
           "model_flops_for", "push_roofline_check"]
