"""Mesh construction (the port of ``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module opens no
process group. A process holds one default group, so building a mesh
of another world size first destroys the group that is there (``close``
destroys it at the end).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def close() -> None:
    """Destroy the default process group (and every group of its
    meshes), if one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _open(backend: str, store, rank: int, world: int, **kw) -> None:
    close()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu"):
    """16x16 = 256 chips a pod ('data','model'); 2 pods = 512 chips with a
    leading 'pod' federation axis. The mesh lives on torch's ``fake``
    backend: this process plays rank 0, and no collective moves data
    (``sharding.collectives`` still counts what each would move)."""
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _open("fake", FakeStore(), 0, math.prod(shape))
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device="cuda", *,
                   store=None, rank: int = 0):
    """A real mesh over the devices there are: NCCL on the card, gloo
    when the caller asks for the CPU. One process (world 1) takes a
    ``HashStore``; the ranks of a larger world each pass the ``store``
    they share (e.g. a ``FileStore``) and their ``rank``."""
    dev = resolve_device(device)
    world = math.prod(shape)
    if store is None:
        if world != 1:
            raise ValueError(f"a mesh of {world} ranks needs a shared store")
        store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        _open("nccl", store, rank, world)
    else:
        _open("gloo", store, rank, world)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)
