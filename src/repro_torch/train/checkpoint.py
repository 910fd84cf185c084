"""Async, restartable checkpoints: the port of ``repro.train.checkpoint``,
with its on-disk layout:

    <dir>/step_<N>/
        proc<R>.npz              # this rank's shards, ``<key with '.'>__shard0``
        proc<R>_index.json       # {"shards": {key: [...]}, "meta": {...}}
    <dir>/step_<N>.COMMITTED     # commit marker, written last by rank 0

Keys name each leaf by its path as ``jax.tree_util`` spells it (dict keys
in sorted order, NamedTuple field names, sequence indices, joined by
``/``).  A plain tensor is one shard covering the whole array; a DTensor
leaf is written by each rank as its local shard with that shard's global
index (``[start, stop, step]`` per dim), as the reference writes a
``jax.Array``'s addressable shards.  So either package restores what the
other wrote: ``{"params": ..., "opt": AdamWState(...)}`` has the same keys
in both.

Saves snapshot every tensor to host memory at once and write on a
background thread (``wait()`` joins it and raises what it raised); a step
is visible only after its marker is written; ``keep_last_k`` keeps the
newest committed steps.  With more than one rank (an initialised
``torch.distributed`` group) a save is written at once, then the ranks
meet in a barrier and rank 0 commits: no collective runs on another
thread, and no rank's files are missing from a committed step.
``restore`` reassembles every leaf from all ranks' shards and, with
``shardings``, places it on a mesh (``elastic_reshard``: onto another mesh
than the one that saved it).
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
import torch.distributed as dist

from repro_torch.sharding.rules import NamedSharding, local_index, place

SEP = "/"


def _rank_and_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def _flatten_with_paths(tree: Any, prefix: str = "",
                        is_leaf=None) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf, keys as the reference names them;
    ``is_leaf(node)`` ends the walk at a node."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for seg, child in kids:
        out += _flatten_with_paths(child, f"{prefix}{SEP}{seg}" if prefix
                                   else seg, is_leaf)
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
    reach (a DTensor's: its local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
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
        """Snapshot every leaf to host memory now (a DTensor's local shard
        with its global index), then write (on a background thread by
        default, with one rank)."""
        from torch.distributed.tensor import DTensor

        self.wait()
        leaves = []
        for key, leaf in _flatten_with_paths(tree):
            idx = (local_index(leaf.shape, leaf.device_mesh, leaf.placements)
                   if isinstance(leaf, DTensor) else None)
            spec = str(tuple(leaf.placements)) if idx is not None else None
            leaves.append((key, _to_host(leaf), idx, list(leaf.shape), spec))

        def work():
            try:
                self._write(step, leaves)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        if self.async_save and _rank_and_world()[1] == 1:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def _write(self, step: int, leaves) -> None:
        rank, world = _rank_and_world()
        step_dir = self.dir / f"step_{step:08d}"
        tmp_dir = self.dir / f".tmp_step_{step:08d}_p{rank}"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        payload, shards, meta = {}, {}, {}
        for key, arr, idx, shape, spec in leaves:
            name = f"{key.replace(SEP, '.')}__shard0"
            payload[name] = arr
            # a plain tensor: one shard covering it, a full slice per dim
            index = ([[None, None, None]] * arr.ndim if idx is None
                     else [[s.start, s.stop, None] for s in idx])
            shards[key] = [{"file_key": name, "index": index}]
            meta[key] = {"shape": shape, "dtype": str(arr.dtype),
                         "pspec": spec}
        np.savez(tmp_dir / f"proc{rank}.npz", **payload)
        (tmp_dir / f"proc{rank}_index.json").write_text(
            json.dumps({"shards": shards, "meta": meta}))
        step_dir.mkdir(parents=True, exist_ok=True)
        for f in tmp_dir.iterdir():
            os.replace(f, step_dir / f.name)
        tmp_dir.rmdir()
        if world > 1:
            dist.barrier()
        if rank == 0:
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

    def restore(self, step: int, target: Any, device=None, *,
                shardings: Optional[Any] = None) -> Any:
        """New tensors with ``target``'s structure (a tree of tensors, on
        the ``meta`` device too: only shapes are read), each leaf read from
        the committed checkpoint of ``step``: every rank's shards (JAX
        processes' or the port's ranks') assembled by their indices.  The
        saved shape must be the target's.  ``shardings``, a tree of the
        same structure whose leaves are
        :class:`~repro_torch.sharding.rules.NamedSharding` (or None),
        makes each such leaf a DTensor on that mesh, this rank holding its
        own shard; the others are placed on ``device``, by default the
        target leaf's device."""
        step_dir = self.dir / f"step_{step:08d}"
        if not (self.dir / f"step_{step:08d}.COMMITTED").exists():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        leaves = _flatten_with_paths(target)
        wanted = {key for key, _ in leaves}
        by_key: Dict[str, List[Tuple[Any, np.ndarray]]] = {}
        for idx_file in sorted(step_dir.glob("proc*_index.json")):
            proc = idx_file.name.split("_")[0]
            index = json.loads(idx_file.read_text())
            with np.load(step_dir / f"{proc}.npz") as data:
                # only the target's leaves are read from the archive
                for key, shards in index["shards"].items():
                    if key not in wanted:
                        continue
                    for sh in shards:
                        by_key.setdefault(key, []).append(
                            (sh["index"], data[sh["file_key"]]))
        placed = (dict(_flatten_with_paths(shardings, is_leaf=_is_placement))
                  if shardings is not None else {})
        out = {}
        for key, leaf in leaves:
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
            if placed.get(key) is not None:
                out[key] = place(full, placed[key])
                continue
            dev = device if device is not None else getattr(
                leaf, "device", "cpu")
            # np.array: a contiguous copy that keeps a 0-d leaf 0-d
            out[key] = torch.from_numpy(np.array(full)).to(dev)
        return _unflatten(target, out)


def _is_placement(x) -> bool:
    """A ``shardings`` leaf: a ``NamedSharding`` or None."""
    return x is None or isinstance(x, NamedSharding)
