"""The rank body of ``tests/test_torch_sharding.py``'s two-rank test.

A module of its own, importing only numpy, torch and the port, so that each
spawned rank starts without loading JAX.  Each rank joins a gloo group of
two over a 1-D ``("data",)`` mesh and, from the same seeded numpy arrays:
takes the compressed mean of its own gradient leaves (``Shard(0)`` over
the axis, a ``(1, ...)`` shard each), places a batch with
``shard_batch``, and saves a tree of ``Shard(0)`` and replicated DTensors
through the checkpoint manager; it pickles its shards to ``{out}.{rank}``.
"""

import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from _sharded_ranks import TIMEOUT
from repro_torch.data.pipeline import shard_batch
from repro_torch.sharding.rules import NamedSharding
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import compressed_mean

RANKS = 2
#: each leaf's per-rank gradient shape
LEAVES = {"w": (3, 100), "b": (257,)}
#: the checkpoint's tree: Shard(0) leaves (rows split over the ranks,
#: 7 rows unevenly) and a replicated one
CKPT = {"emb": (7, 5), "w": (4, 6), "scale": (5,)}
STEP = 3


def arrays():
    """The two ranks' gradients and errors, the checkpoint's leaves and
    the batch, as numpy."""
    rng = np.random.default_rng(29)
    grads = {k: (rng.standard_normal((RANKS,) + s)
                 * rng.uniform(0.1, 10.0, (RANKS,) + s)).astype(np.float32)
             for k, s in LEAVES.items()}
    errs = {k: (0.01 * rng.standard_normal((RANKS,) + s)).astype(np.float32)
            for k, s in LEAVES.items()}
    ckpt = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in CKPT.items()}
    batch = {"tokens": rng.integers(0, 500, (4, 6), dtype=np.int32),
             "labels": rng.integers(0, 500, (4, 6), dtype=np.int32)}
    return grads, errs, ckpt, batch


def run(rank: int, init: str, out: str, ckpt_dir: str) -> None:
    """One rank of the two-rank run."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=RANKS, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (RANKS,), mesh_dim_names=("data",))
        grads, errs, ckpt, batch = arrays()
        own = lambda a: DTensor.from_local(
            torch.from_numpy(a[rank:rank + 1].copy()), mesh, (Shard(0),))
        mean, new_err = compressed_mean(
            {k: own(v) for k, v in grads.items()},
            {k: own(v) for k, v in errs.items()}, mesh, axis="data")
        placed = shard_batch(batch, {"tokens": NamedSharding(mesh,
                                                             ("data",))})
        tree = {k: DTensor.from_local(
            torch.from_numpy(v[rank * 4:rank * 4 + 4].copy()), mesh,
            (Shard(0),), shape=torch.Size(v.shape), stride=(v.shape[1], 1))
            for k, v in ckpt.items() if k == "emb"}
        tree["w"] = DTensor.from_local(
            torch.from_numpy(ckpt["w"][rank * 2:rank * 2 + 2].copy()), mesh,
            (Shard(0),))
        tree["scale"] = DTensor.from_local(torch.from_numpy(ckpt["scale"]),
                                           mesh, (Replicate(),))
        CheckpointManager(ckpt_dir).save(STEP, tree)
        res = {"mean": {k: v.to_local().numpy() for k, v in mean.items()},
               "err": {k: v.to_local().numpy() for k, v in new_err.items()},
               "tokens": placed["tokens"].to_local().numpy(),
               "labels_untouched": placed["labels"] is batch["labels"]}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
