"""Mesh context and sharding specs on a torch ``DeviceMesh``.

The port of the reference's ``repro.models.sharding``. Production meshes:
single-pod (data=16, model=16) and multi-pod (pod=2, data=16, model=16),
with the reference's logical axes:

  batch  -> ("pod", "data") or ("data",)     activations' batch dim
  seq    -> the batch axes, used instead of batch when global_batch is too
            small to fill them
  model  -> "model"                           TP/EP axis

A spec is the reference's: a tuple with one entry per tensor dim, each None,
an axis name, or a tuple of axis names. ``MeshCtx.ns`` turns it into the
DTensor placements on the mesh (one per mesh dim). Several axes on one
tensor dim shard it in mesh order, outermost first, so that the block a
rank holds is the reference's: on ("pod", "data") the index is
``data + pod * n_data``.

This slice runs data parallelism over the batch axes with ZeRO-1 moments.
Every step runs on this rank's blocks, so the model's code sees local
tensors; on a mesh with ``n_model > 1`` only the pure data-parallel models
run (their batch is sharded over every axis). Tensor and expert parallelism
over "model", and the sequence sharding of ``token_spec``, are later items
(ROADMAP A); their specs are computed all the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from repro_torch.tree import tree_map

TENSOR_PARALLEL = ("tensor and expert parallelism over the \"model\" axis for a model that is "
                   "not pure data-parallel (ROADMAP A, \"Tensor parallelism\")")
SEQUENCE_SHARDING = ("the sequence sharding of MeshCtx.token_spec, for a batch that does not "
                     "fill the batch axes (ROADMAP A, \"Sequence sharding\")")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices and no process group
    (the counterpart of ``jax.sharding.AbstractMesh``): a ``MeshCtx`` over
    it computes specs only, e.g. those of the (16, 16) production mesh."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``spec`` holds
    the axis names per tensor dim, ``placements`` the DTensor placement
    per mesh dim."""
    mesh: DeviceMesh | AbstractMesh = field(compare=False, repr=False)
    spec: tuple
    placements: tuple[Placement, ...]


@dataclass
class MeshCtx:
    mesh: DeviceMesh | AbstractMesh
    notes: list = field(default_factory=list)

    def __post_init__(self):
        self._groups: dict[tuple[str, ...], Any] = {}
        if isinstance(self.mesh, AbstractMesh):
            return
        names = self.mesh.mesh_dim_names
        if not names or "model" not in names or "data" not in names:
            raise ValueError(f"mesh dims {names}: need 'data' and 'model' (and maybe 'pod')")
        want = _BACKENDS.get(self.mesh.device_type)
        if want is None:
            raise ValueError(f"mesh device {self.mesh.device_type!r}: expected 'cuda' or 'cpu'")
        if want == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch was built without")
        backend = dist.get_backend(self.mesh.get_group(0))
        if want not in backend:
            raise ValueError(f"a {self.mesh.device_type} mesh runs over {want}; the process "
                             f"group's backend is {backend!r}")
        # every rank makes the same groups in the same order (each is a collective call)
        for axes in (self.batch_axes, (*self.batch_axes, "model"), ("model",)):
            sub = self.mesh[axes] if len(axes) > 1 else None
            group = sub._flatten().get_group() if sub is not None else self.mesh.get_group(axes[0])
            if dist.get_rank(group) != self.index(axes):
                raise RuntimeError(f"group over {axes}: rank {dist.get_rank(group)} is not the "
                                   f"flattened index {self.index(axes)}")
            self._groups[axes] = group

    # ----------------------------------------------------------- the mesh
    @property
    def axis_names(self) -> tuple[str, ...]:
        if isinstance(self.mesh, AbstractMesh):
            return self.mesh.axis_names
        return tuple(self.mesh.mesh_dim_names)

    @property
    def shape(self) -> dict[str, int]:
        sizes = (self.mesh.axis_sizes if isinstance(self.mesh, AbstractMesh)
                 else tuple(self.mesh.shape))
        return dict(zip(self.axis_names, sizes))

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def n_batch(self) -> int:
        return math.prod(self.shape[a] for a in self.batch_axes)

    @property
    def n_model(self) -> int:
        return int(self.shape["model"])

    def device_mesh(self) -> DeviceMesh:
        """The ``DeviceMesh``; raises on a spec-only context."""
        if isinstance(self.mesh, AbstractMesh):
            raise RuntimeError("this MeshCtx has no process group (an AbstractMesh computes "
                               "specs only); build it on a DeviceMesh to run a step")
        return self.mesh

    def group(self, axes: tuple[str, ...]):
        """The process group over ``axes`` (the batch axes; the batch axes
        and "model"; or "model"), ranked by ``index(axes)``."""
        self.device_mesh()
        return self._groups[tuple(axes)]

    def index(self, axes: tuple[str, ...]) -> int:
        """This rank's flattened index over ``axes``, the outermost first
        (on ("pod", "data"): data + pod * n_data)."""
        coord = dict(zip(self.axis_names, self.device_mesh().get_coordinate()))
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coord[a]
        return idx

    # ----------------------------------------------------------- specs
    def ns(self, *spec) -> NamedSharding:
        """The sharding of ``spec`` on this mesh. Raises for an axis the
        mesh lacks, an axis used twice, or axes of one dim out of mesh
        order (DTensor nests them in mesh order)."""
        names = self.axis_names
        placements: list[Placement] = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            order = [names.index(a) if a in names else -1 for a in axes]
            if -1 in order:
                raise ValueError(f"spec {spec}: an axis is not in the mesh {names}")
            if order != sorted(order):
                raise ValueError(f"spec {spec}: the axes of dim {dim} are not in mesh order")
            for i in order:
                if placements[i] != Replicate():
                    raise ValueError(f"spec {spec}: axis {names[i]} is used twice")
                placements[i] = Shard(dim)
        return NamedSharding(self.mesh, tuple(spec), tuple(placements))

    def replicated(self) -> NamedSharding:
        return self.ns()

    def token_spec(self, global_batch: int, extra_dims: int = 0) -> tuple:
        """(B, S, ...) activation spec: shard batch if it fills the batch
        axes, otherwise shard the sequence dim (context/sequence parallel)."""
        if global_batch >= self.n_batch and global_batch % self.n_batch == 0:
            return (self.batch_axes, None) + (None,) * extra_dims
        return (None, self.batch_axes) + (None,) * extra_dims

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's sharding constraint. The port's steps run on local
        blocks laid out by the batch's spec, so at ``n_model == 1`` this is
        the identity; a layout over "model" is tensor parallelism."""
        if self.n_model != 1:
            raise NotImplementedError(TENSOR_PARALLEL)
        return x

    def model_dim_choice(self, *dim_sizes: int) -> int:
        """Index of the first dim divisible by the model axis, else -1."""
        for i, d in enumerate(dim_sizes):
            if d % self.n_model == 0:
                return i
        return -1

    def local(self, x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
        """This rank's block of ``x`` laid out as ``sharding`` (``place``)."""
        return place(x, sharding).to_local()


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` laid out as ``sharding`` on its mesh (the counterpart of
    ``jax.device_put``): a DTensor is redistributed; a plain tensor is the
    global value, the same on every rank, of which each rank keeps its
    block (no communication)."""
    mesh = sharding.mesh
    if isinstance(mesh, AbstractMesh):
        raise RuntimeError("an AbstractMesh has no devices: build the MeshCtx on a DeviceMesh")
    if isinstance(x, DTensor):
        return x.redistribute(mesh, sharding.placements)
    return distribute_tensor(x, mesh, sharding.placements, src_data_rank=None)


def shard_map_compat(f: Callable, *, mesh: MeshCtx, in_specs: tuple, out_specs) -> Callable:
    """``f`` run on this rank's blocks (the counterpart of ``jax.shard_map``,
    whose name the reference's helper keeps): each argument, a tree of
    tensors (DTensors, or plain tensors holding the global value), is laid
    out as its tree of shardings in ``in_specs`` and ``f`` gets the local
    blocks; ``f``'s output, a tree of local blocks, becomes DTensors laid
    out as the tree ``out_specs``. ``f`` makes any collective itself."""
    def run(*args):
        local = [tree_map(mesh.local, a, s) for a, s in zip(args, in_specs)]
        return tree_map(lambda t, s: DTensor.from_local(t, mesh.device_mesh(), s.placements,
                                                        run_check=False), f(*local), out_specs)

    return run


def spec_with_model_on(shape: tuple[int, ...], ctx: MeshCtx, candidates: list[int]) -> tuple:
    """Build a spec placing "model" on the first candidate dim divisible by
    the model-axis size (fallback: replicated)."""
    spec: list = [None] * len(shape)
    for dim in candidates:
        if shape[dim] % ctx.n_model == 0:
            spec[dim] = "model"
            return tuple(spec)
    return tuple(spec)
