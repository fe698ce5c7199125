"""Production meshes as ``DeviceMesh``es.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; "pod" is the slow link
between pods, "data"/"model" the fast one inside a pod: the AVEC
link-hierarchy rule keeps tensor-parallel collectives inside a pod and only
(optionally compressed) gradient reductions cross pods.

The shapes are the reference's (``repro/launch/mesh.py``), so that the two
packages' plans compare.  The production meshes live on ranks of the
``fake`` process-group backend (``FakeStore``, device type ``cpu``): a rank
that is not there, as the reference's dry-run places its meshes on
placeholder host devices.  Their collectives move nothing; the dry-run
counts them.  The host mesh is (1, 1) over rank 0 of a one-rank group.

Meshes are built in functions, so importing this module starts no process
group."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils import resolve_device

#: ranks of the fake world the production meshes live on (both fit)
FAKE_WORLD = 512


@dataclass(frozen=True)
class Mesh:
    """A ``DeviceMesh`` with the reference mesh's ``axis_names`` and
    ``shape`` (axis name -> size), which the sharding rules read."""
    device_mesh: object
    axis_names: tuple
    shape: dict


def start_fake_world(world_size: int = FAKE_WORLD) -> None:
    """Start the ``fake`` process group as rank 0 of ``world_size``, unless
    one of at least that size is running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world_size:
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks is running; the production "
                               f"meshes need a fake world of {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cpu") -> Mesh:
    """A mesh of ``shape`` over the first ranks of the running process
    group."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return Mesh(DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes)), tuple(axes),
                dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    start_fake_world()
    return make_mesh(shape, axes)


def make_host_mesh(device="cuda") -> Mesh:
    """(1, 1) mesh over one real rank: rank 0 of the running process group,
    or of a one-rank group started here (NCCL on the card, gloo on the CPU,
    an in-process store: no network)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), dev.type)
