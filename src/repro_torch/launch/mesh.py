"""Device meshes (the port of ``repro.launch.mesh``): torch.distributed
``DeviceMesh``es with the reference's axis names, built by functions, so
that importing this module touches no process group.

The production meshes need a world of 256 or 512 ranks.  The dry run
(:mod:`repro_torch.launch.dryrun`) runs one rank of such a world in one
process: :func:`init_fake_mesh` starts a fake process group of the mesh's
size (PyTorch's ``fake`` backend: every collective returns at once and
moves no data; an all-reduce leaves its buffer as it was, an all-to-all
and an all-gather copy this rank's data) and returns the mesh;
:func:`destroy_mesh` ends the group.

The reference's TPU v5e constants (peak flops, HBM and ICI rates) have no
place here: the card's figures are the roofline's
(:data:`CARD`, from :mod:`repro_torch.launch.roofline`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.spmv.autotune import device_spec
from repro_torch.launch.roofline import DEFAULT_PLATFORM

#: the card's figures (HBM rate, f32 rate, shared memory a block)
CARD = device_spec(DEFAULT_PLATFORM)

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the ranks of the
    initialised default process group; raises ``ValueError`` unless the
    world has exactly the ranks the mesh needs (256 or 512)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"mesh {shape} needs a world of {need} ranks; this "
                         f"one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1 x 1 ``("data", "model")`` mesh of this one rank (the
    reference's one-device mesh for smoke paths), on the card unless
    another device type is named.  Without a process group it starts a
    1-rank one from an in-process store (NCCL on the card, gloo on the
    CPU), which the caller destroys with
    ``torch.distributed.destroy_process_group()``; an initialised group
    must have one rank."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"the local mesh is one rank; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=SINGLE_POD[1])


def init_fake_mesh(shape: Sequence[int], names: Sequence[str], *,
                   device_type: str = "cuda") -> DeviceMesh:
    """The mesh ``shape`` with dim ``names`` as seen by rank 0 of a fake
    process group of the mesh's size, which this starts (no group may be
    initialised yet); :func:`destroy_mesh` ends it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("init_fake_mesh starts its own process group; "
                           "one is already initialised")
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def fake_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """:func:`make_production_mesh` as rank 0 of a fake group of 256 (or,
    with ``multi_pod``, 512) ranks, which this starts."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    init_fake_mesh(shape, names, device_type=device_type)
    return make_production_mesh(multi_pod=multi_pod, device_type=device_type)


def destroy_mesh() -> None:
    """End the default process group (a fake one, or a local one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """Each named mesh dim's size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
