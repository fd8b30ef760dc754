"""Production, host and shared-card meshes (functions, not module-level
constants: a mesh needs the process group, which importing this module
never touches).

The caller starts the process group first, with the backend of the mesh's
device and an address of its own, e.g. on one card
``torch.distributed.init_process_group("nccl", init_method="tcp://localhost:<port>",
rank=0, world_size=1)``; NCCL for "cuda", gloo for "cpu" (``MeshCtx``
checks it). The exceptions are ``make_shared_card_mesh``: ranks that
share one card, over gloo, which NCCL refuses; and ``make_dryrun_mesh``,
which starts a fake process group itself: one rank of a production mesh,
traced on fake tensors with no card (``launch.dryrun``)."""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.sharding import DRYRUN, SHARED_CARD


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
    data=16, model=16) = 512 devices; "pod" is the outermost data-parallel
    axis. Raises, naming the world size it needs, in a process group of
    another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """The 1-device mesh (data=1, model=1) over a process group of size 1:
    the mesh-parameterized code paths on one card (or one CPU process)."""
    return _mesh(device, (1, 1), ("data", "model"))


def make_shared_card_mesh(shape: tuple[int, ...] = (1, 2)) -> DeviceMesh:
    """A CUDA mesh whose ranks are processes that share one card: (data,
    model), or (pod, data, model) for a 3-long ``shape``, over a gloo
    process group of ``prod(shape)`` ranks that the caller started, each
    rank on the same device (``torch.cuda.set_device``). NCCL refuses two
    ranks on one GPU, so this is the one CUDA mesh ``MeshCtx`` takes over
    gloo, which runs every collective of ``MeshCtx`` on CUDA tensors (in
    the card machine's torch 2.11: all-reduce with sum, avg and max,
    all-gather, reduce-scatter, all-to-all)."""
    if dist.is_initialized() and dist.get_backend() != "gloo":
        raise ValueError(f"a shared-card mesh runs over gloo; the process group's backend is "
                         f"{dist.get_backend()!r}")
    axes = ("pod", "data", "model")[3 - len(shape):]
    mesh = _mesh("cuda", tuple(shape), axes)
    setattr(mesh, SHARED_CARD, True)
    return mesh


def make_dryrun_mesh(*, multi_pod: bool = False, rank: int = 0,
                     device: str = "cuda") -> DeviceMesh:
    """``make_production_mesh``'s mesh as seen by rank ``rank``, over a
    fake process group of its 256 (or 512) ranks that this call starts
    (``torch.distributed``'s "fake" backend: its collectives return at once
    and move nothing), marked as the dry run's (``sharding.DRYRUN``):
    ``MeshCtx`` takes the fake backend on this mesh alone, and a step on it
    takes fake tensors only. The process group is the process's own, so a
    process traces one rank of one mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside the {world}-rank mesh")
    if dist.is_initialized():
        raise RuntimeError("a process group is already running: the dry run starts its own, "
                           "one a process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    setattr(mesh, DRYRUN, True)
    return mesh


def _mesh(device: str, shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("start torch.distributed first (init_process_group with 'nccl' for "
                           "a CUDA mesh, 'gloo' for a CPU one)")
    need, have = math.prod(shape), dist.get_world_size()
    if need != have:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs a process group of {need} "
                         f"ranks; this one has {have}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)
