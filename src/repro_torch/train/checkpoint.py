"""Async, restartable checkpoints: the port of ``repro.train.checkpoint``,
with its on-disk layout for one process:

    <dir>/step_<N>/
        proc0.npz                # every leaf, as ``<key with '.'>__shard0``
        proc0_index.json         # {"shards": {key: [...]}, "meta": {...}}
    <dir>/step_<N>.COMMITTED     # commit marker, written last

Keys name each leaf by its path as ``jax.tree_util`` spells it (dict keys
in sorted order, NamedTuple field names, sequence indices, joined by
``/``), and a leaf is one shard covering the whole array.  So either
package restores what the other wrote: ``{"params": ..., "opt":
AdamWState(...)}`` has the same keys in both.

Saves snapshot every tensor to host memory at once and write on a
background thread (``wait()`` joins it and raises what it raised); a step
is visible only after its marker is written; ``keep_last_k`` keeps the
newest committed steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key segment, child) pairs of a container node in the reference's
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(name, getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf, keys as the reference names them."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for seg, child in kids:
        out += _flatten_with_paths(child, f"{prefix}{SEP}{seg}" if prefix
                                   else seg)
    return out


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    built = [_unflatten(child, leaves, f"{prefix}{SEP}{seg}" if prefix
                        else seg) for seg, child in kids]
    if isinstance(tree, dict):
        return {seg: b for (seg, _), b in zip(kids, built)}
    if hasattr(tree, "_fields"):
        return type(tree)(*built)
    return type(tree)(built)


def _to_host(leaf: Any) -> np.ndarray:
    """A copy of ``leaf`` in host memory that later writes to it do not
    reach."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bf16 tensors have no numpy dtype; "
                            "training state is f32 and int32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory, *, keep_last_k: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_k = keep_last_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        """Snapshot every leaf to host memory now, then write (on a
        background thread by default)."""
        self.wait()
        leaves = [(key, _to_host(leaf))
                  for key, leaf in _flatten_with_paths(tree)]

        def work():
            try:
                self._write(step, leaves)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def _write(self, step: int, leaves) -> None:
        step_dir = self.dir / f"step_{step:08d}"
        tmp_dir = self.dir / f".tmp_step_{step:08d}_p0"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        payload, shards, meta = {}, {}, {}
        for key, arr in leaves:
            name = f"{key.replace(SEP, '.')}__shard0"
            payload[name] = arr
            # one shard covering the array: a full slice per dimension
            shards[key] = [{"file_key": name,
                            "index": [[None, None, None]] * arr.ndim}]
            meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                         "pspec": None}
        np.savez(tmp_dir / "proc0.npz", **payload)
        (tmp_dir / "proc0_index.json").write_text(
            json.dumps({"shards": shards, "meta": meta}))
        step_dir.mkdir(parents=True, exist_ok=True)
        for f in tmp_dir.iterdir():
            os.replace(f, step_dir / f.name)
        tmp_dir.rmdir()
        (self.dir / f"step_{step:08d}.COMMITTED").write_text(
            json.dumps({"step": step, "time": time.time()}))
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {e}") from e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last_k] if self.keep_last_k else []:
            marker = self.dir / f"step_{s:08d}.COMMITTED"
            d = self.dir / f"step_{s:08d}"
            if marker.exists():
                marker.unlink()
            if d.exists():
                shutil.rmtree(d)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(f.stem.split("_")[1])
                      for f in self.dir.glob("step_*.COMMITTED"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device=None) -> Any:
        """New tensors with ``target``'s structure (a tree of tensors),
        each leaf read from the committed checkpoint of ``step`` and
        placed on ``device``, by default the target leaf's device.  The
        saved shape must be the target's; shards (a checkpoint written by
        several JAX processes) are assembled by their indices."""
        step_dir = self.dir / f"step_{step:08d}"
        if not (self.dir / f"step_{step:08d}.COMMITTED").exists():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        by_key: Dict[str, List[Tuple[Any, np.ndarray]]] = {}
        for idx_file in sorted(step_dir.glob("proc*_index.json")):
            proc = idx_file.name.split("_")[0]
            index = json.loads(idx_file.read_text())
            with np.load(step_dir / f"{proc}.npz") as data:
                for key, shards in index["shards"].items():
                    for sh in shards:
                        by_key.setdefault(key, []).append(
                            (sh["index"], data[sh["file_key"]]))
        out = {}
        for key, leaf in _flatten_with_paths(target):
            shards = by_key[key]
            shape = tuple(leaf.shape)
            full = np.zeros(shape, dtype=shards[0][1].dtype)
            for idx, arr in shards:
                if idx is None or len(shape) == 0:
                    full = np.asarray(arr)
                else:
                    full[tuple(slice(*s) for s in idx)] = arr
            if full.shape != shape:
                raise ValueError(f"checkpoint {key}: saved {full.shape}, "
                                 f"target {shape}")
            dev = device if device is not None else getattr(
                leaf, "device", "cpu")
            # np.array: a contiguous copy that keeps a 0-d leaf 0-d
            out[key] = torch.from_numpy(np.array(full)).to(dev)
        return _unflatten(target, out)
