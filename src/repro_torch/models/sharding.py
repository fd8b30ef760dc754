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

Every step runs on this rank's blocks, so the model's code sees local
tensors and makes its layout changes itself, as named collectives of
``MeshCtx`` (counted by kind in ``MeshCtx.counts``): over "model" the
sequence's gather (``gather_seq``) and reduce-scatter (``scatter_seq``),
``psum_model``, ``reduce_model`` and ``all_to_all``; the optimizer's
reduce-scatter and all-gather over the batch axes. Each of the model's
collectives is differentiable, with the reference's Megatron-SP layout in
mind: between blocks the hidden state is sharded over the sequence on
"model"; what a rank computes from a gathered (replicated) tensor gets a
partial gradient, which the collective's backward sums. Data parallelism runs over the batch
axes with ZeRO-1 moments; tensor and expert parallelism over "model" for
every family: on the heads, FFN, experts, ``d_inner`` and SSM heads where
they divide it, with the embedding and head on d_model where the vocab
does not; where they do not, the reference's fallback layouts (head_dim
sharded, or the leaf replicated), which the model gathers whole and runs
on the rank's block of the sequence (``LM.tp_ctx``).

A batch that does not fill the batch axes (the reference's ``long_500k``,
B = 1) shards the sequence dim over them instead (``token_spec``,
``seq_sharded``): a rank holds the contiguous block of the sequence at its
flattened index over the batch axes, pod outermost (``seq_rank``), split
again over "model" where Megatron-SP runs. The model then crosses the
ranks' blocks with the sequence collectives over the batch axes: the keys'
gather (``gather_seq(axes=batch_axes)``), the halo of the previous rank's
last rows (``halo``), the rank-to-rank relay of a carried state in
sequence order (``relay_in``/``relay_out``), and the f32 max and sum over
them (``all_reduce(op="max")``, ``seq_sum``). Sequence-sharded serving and
training run for every family (``LM.seq_ctx``), in every layout over
"model", the fallback layouts included: the sequence's gather over "model"
within a sequence rank's block composes with the keys' gather over the
batch axes, and a "model" rank's halo and relay run over its own group of
the batch axes, so the composition adds no collective of its own. The MoE
layer gathers its tokens over the batch axes too (the reference routes
the whole sequence together), and the encoder-decoder its encoder's output
(every cross-attention reads all the frames): gathers of the kind above.

The halo, the relay and the keys' gather are differentiable, each on
every rank (the first and last ranks' moving nothing), so that every
rank's graph has the same shape and the backward's collectives come in
the same order everywhere. Their backward sums every rank's contribution:
the gradient of the rows a rank read goes back to the previous rank
(``halo_back``); the gradient of the state a rank received goes back to
the previous rank, in reverse sequence order (``relay_back``); the keys'
gradients are reduce-scattered. A layer that runs under
``torch.utils.checkpoint`` must not replay these in its recompute: rank
r's recompute would wait for rank r - 1's relay while rank r - 1 waits in
its backward for rank r's gradient. ``MeshCtx.recorded`` is the
checkpoint's ``context_fn`` that keeps what each hop over the batch axes
received in the forward and hands it to the recompute, which then moves
and counts nothing over them (the gathers over "model", within a
sequence rank's group, replay).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the attribute ``launch.mesh.make_shared_card_mesh`` sets on the CUDA mesh it
# builds over gloo (which takes every collective below for CUDA tensors in the
# card machine's torch 2.11)
SHARED_CARD = "repro_shared_card"
# the attribute ``launch.mesh.make_dryrun_mesh`` sets on the mesh it builds
# over a fake process group (``torch.distributed``'s "fake" backend, whose
# collectives move nothing): the one mesh ``MeshCtx`` takes over it, and on
# which a step takes fake tensors only (``require_fake``)
DRYRUN = "repro_dryrun"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "avg": dist.ReduceOp.AVG}
# ``reduce_scatter_tensor``/``all_gather_into_tensor`` took new names in torch 2.13
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


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
    """The mesh, its process groups, and the collectives the steps make on
    it. ``counts`` (kind -> calls) counts every collective this context
    made; ``waits`` (kind -> seconds) the time the relay's receives
    (``relay``, and ``relay_back`` in the backward) blocked; a caller may
    reset both."""
    mesh: DeviceMesh | AbstractMesh
    notes: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    waits: dict = field(default_factory=dict)

    def __post_init__(self):
        self._groups: dict[tuple[str, ...], Any] = {}
        self._tapes: list[_Tape] = []  # the checkpointed regions running (``recorded``)
        if isinstance(self.mesh, AbstractMesh):
            return
        names = self.mesh.mesh_dim_names
        if not names or "model" not in names or "data" not in names:
            raise ValueError(f"mesh dims {names}: need 'data' and 'model' (and maybe 'pod')")
        want = _BACKENDS.get(self.mesh.device_type)
        if want is None:
            raise ValueError(f"mesh device {self.mesh.device_type!r}: expected 'cuda' or 'cpu'")
        if getattr(self.mesh, DRYRUN, False):
            want = "fake"  # the dry run's mesh (make_dryrun_mesh): nothing runs on it
        elif getattr(self.mesh, SHARED_CARD, False) and self.mesh.device_type == "cuda":
            want = "gloo"  # ranks that share one card (make_shared_card_mesh): NCCL refuses them
        elif want == "nccl" and not dist.is_nccl_available():
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

    def seq_sharded(self, global_batch: int) -> bool:
        """Whether a batch of ``global_batch`` rows does not fill the batch
        axes (fewer rows than ranks, or a count they do not divide), so that
        the sequence dim is sharded over them instead."""
        return not (global_batch >= self.n_batch and global_batch % self.n_batch == 0)

    def token_spec(self, global_batch: int, extra_dims: int = 0) -> tuple:
        """(B, S, ...) activation spec: shard batch if it fills the batch
        axes, otherwise shard the sequence dim (context/sequence parallel:
        the rank's block is the one at ``seq_rank``)."""
        if not self.seq_sharded(global_batch):
            return (self.batch_axes, None) + (None,) * extra_dims
        return (None, self.batch_axes) + (None,) * extra_dims

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's sharding constraint: checks that ``spec`` names
        this mesh's axes and returns ``x``. The port's steps hold local
        blocks and make each layout change themselves, as the collectives
        below."""
        self.ns(*spec)
        return x

    def model_dim_choice(self, *dim_sizes: int) -> int:
        """Index of the first dim divisible by the model axis, else -1."""
        for i, d in enumerate(dim_sizes):
            if d % self.n_model == 0:
                return i
        return -1

    def local(self, x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
        """This rank's block of ``x`` laid out as ``sharding`` (``place``)."""
        return self.place(x, sharding).to_local()

    def place(self, x: torch.Tensor, sharding: NamedSharding) -> DTensor:
        """``place``, its gathers (``whole``'s) counted as "all_gather"."""
        return place(x, sharding, self.counts)

    # ----------------------------------------------------------- collectives
    def size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.shape[a] for a in axes)

    @property
    def model_rank(self) -> int:
        return self.index(("model",))

    @property
    def seq_rank(self) -> int:
        """This rank's place in the sequence where the sequence is sharded
        over the batch axes: its flattened index over them, pod outermost
        (where ``place`` puts ``Shard(1)`` of the spec ``(None,
        batch_axes)``)."""
        return self.index(self.batch_axes)

    def _comm(self, kind: str, axes: tuple[str, ...], x: torch.Tensor, fn) -> torch.Tensor:
        """``fn(x, group)`` over the group of ``axes``, counted by kind; over
        the batch axes inside a checkpointed region, kept for its recompute
        (``recorded``)."""
        require_fake(x, self.mesh)
        return self._received(tuple(axes), lambda: self._count(kind, fn(x.contiguous(),
                                                                         self.group(axes))))

    def _count(self, kind: str, out=None):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return out

    def _received(self, axes: tuple[str, ...], fn):
        """``fn()``, what a hop over ``axes`` receives. Over the batch axes
        inside a checkpointed region (``recorded``): kept in the forward,
        and in the recompute the kept tensor, with no communication and no
        count."""
        tape = self._tapes[-1] if self._tapes and axes == self.batch_axes else None
        if tape is not None and tape.replay:
            return tape.take()
        out = fn()
        if tape is not None:
            tape.keep(out)
        return out

    def recorded(self):
        """``torch.utils.checkpoint``'s ``context_fn`` for a region that
        crosses the sequence ranks: (the forward's context, which keeps
        what each hop over the batch axes receives; the recompute's, which
        hands the kept tensors back in the same order and sends nothing).
        The recompute then replays no communication over the batch axes:
        it holds the received tensors (the halo's rows, the relayed state,
        the gathered keys and values) from the forward to the backward."""
        tape = _Tape()
        return self._taping(tape, False), self._taping(tape, True)

    @contextlib.contextmanager
    def _taping(self, tape: "_Tape", replay: bool):
        tape.replay, tape.at = replay, 0
        self._tapes.append(tape)
        try:
            yield
        finally:
            self._tapes.pop()

    def all_reduce(self, x: torch.Tensor, axes: tuple[str, ...] = ("model",),
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``op``: sum, max or avg) over ``axes``, a new tensor."""
        def run(t, group):
            out = t.clone()
            dist.all_reduce(out, op=_OPS[op], group=group)
            return out

        return self._comm("all_reduce", tuple(axes), x, run)

    def all_gather(self, x: torch.Tensor, axes: tuple[str, ...] = ("model",),
                   dim: int = 0) -> torch.Tensor:
        """The blocks of ``axes``' ranks concatenated along ``dim``, in the
        order of ``index(axes)``."""
        return self._gather("all_gather", x, tuple(axes), dim)

    def _gather(self, kind: str, x: torch.Tensor, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
        """``all_gather``, counted as ``kind``."""
        n = self.size(axes)

        def run(t, group):
            out = t.new_empty((n * t.shape[0], *t.shape[1:]))
            _all_gather(out, t, group=group)
            return out

        return self._comm(kind, axes, x.movedim(dim, 0), run).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axes: tuple[str, ...] = ("model",),
                       dim: int = 0, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over ``axes``; this rank's block of it along ``dim``."""
        n = self.size(tuple(axes))

        def run(t, group):
            out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
            _reduce_scatter(out, t, op=_OPS[op], group=group)
            return out

        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        return self._comm("reduce_scatter", tuple(axes), x.movedim(dim, 0), run).movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axes: tuple[str, ...] = ("model",)) -> torch.Tensor:
        """Block p of ``x``'s dim 0 goes to rank p of ``axes``; block p of the
        result came from rank p (the reference's tiled ``all_to_all`` with
        split and concat axis 0)."""
        def run(t, group):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=group)
            return out

        return self._comm("all_to_all", tuple(axes), x, run)

    # the sequence over the batch axes (module docstring)
    def halo(self, x: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
        """The last ``k`` rows along ``dim`` of the previous sequence rank's
        ``x`` (zeros on the first rank): what a causal window of k + 1 rows
        reads before this rank's block. Every rank's last rows are
        all-gathered (k rows a rank: a point-to-point exchange would save
        nothing at this size). Backward (``halo_back``, an all-gather too):
        the gradient of the rows a rank read is added to the previous
        rank's last rows; the last rank's get none."""
        return _Halo.apply(x.narrow(dim, x.shape[dim] - k, k), self, dim)

    def relay_in(self, start: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
        """The tensor that the previous sequence rank passes on with
        ``relay_out`` (a state carried in sequence order), or ``start`` on
        the first rank; shaped and typed like ``start``. Each rank calls
        ``relay_in``, computes, then ``relay_out``: rank r waits for rank
        r - 1 alone, so the hops run in sequence order. Backward
        (``relay_back``): the received state's gradient is sent back to
        rank r - 1, whose ``relay_out`` adds it to the gradient of the state
        it passed on, in reverse sequence order. ``after`` is a tensor of
        this rank's graph that the gradient must leave by (it gets none):
        the backward of everything ``after`` depends on, the halo's
        collective included, waits for the send, so that no rank enters a
        collective while the next rank waits for its gradient."""
        return _RelayIn.apply(start, after, self)

    def relay_out(self, state: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``state`` sent to the next sequence rank (its ``relay_in``);
        nothing on the last rank. Counted once a relay on every rank.
        Returns ``y`` as it is (a view): the node whose backward receives
        the gradient of ``state`` from the next rank (zeros on the last)."""
        return _RelayOut.apply(y, state, self)

    def _send(self, x: torch.Tensor, to: int) -> None:
        """``x`` sent to the sequence rank ``to``."""
        require_fake(x, self.mesh)
        group, x = self.group(self.batch_axes), x.contiguous()  # a gradient may be strided
        dist.send(x.cpu() if _on_host(x, group) else x, dst=dist.get_global_rank(group, to),
                  group=group)

    def _recv(self, like: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        """A tensor shaped and typed like ``like`` from the sequence rank
        ``src``; the time it blocked added to ``waits[kind]``."""
        require_fake(like, self.mesh)
        group = self.group(self.batch_axes)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if _on_host(like, group) else like.device)
        t0 = time.perf_counter()
        dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
        self.waits[kind] = self.waits.get(kind, 0.0) + time.perf_counter() - t0
        return buf.to(like.device)

    def seq_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 sum over the batch axes of each rank's ``x``, added in
        sequence order (rank 0's first): every rank's part is all-gathered
        and added here, so that the order is fixed, where an all-reduce's
        is the backend's. f32."""
        parts = self.all_gather(x.float()[None], self.batch_axes).unbind(0)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    # the model's layout changes over "model", differentiable (module docstring)
    def gather_seq(self, x: torch.Tensor, dim: int = 1,
                   axes: tuple[str, ...] = ("model",)) -> torch.Tensor:
        """The sequence's blocks (or those of another ``dim``) gathered over
        "model" (or over ``axes``; backward: their gradients summed and
        scattered back)."""
        return _GatherSeq.apply(x, self, dim, tuple(axes))

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Partial sums over "model" added in f32 and scattered along the
        sequence, in ``x``'s dtype (backward: the gradient gathered)."""
        return _ScatterSeq.apply(x, self, dim)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over "model" added in f32, in ``x``'s dtype, on every
        rank; each rank's use of the sum gives a partial gradient, so the
        backward sums them too."""
        return _PsumModel.apply(x, self)

    def reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over "model" added in f32, in ``x``'s dtype, where
        every rank uses the sum alike (the head's logits, whose loss is the
        same on every rank): the backward hands each rank the gradient as it
        is, the whole gradient of its own partial sum."""
        return _ReduceModel.apply(x, self)

    def all_to_all_model(self, x: torch.Tensor) -> torch.Tensor:
        """``all_to_all`` over "model" (backward: the gradient sent back)."""
        return _AllToAll.apply(x, self)

    def shared_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is, where every rank of the model group computes it
        whole from the same gathered inputs (the MoE's auxiliary loss over
        the gathered tokens): the backward hands each rank 1 / n_model of
        its gradient, so that the collectives' backward sums, and the sum
        over "model" of the replicated leaves' gradients, count it once."""
        return _SharedModel.apply(x, self)

    def pmean_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over every axis (the reference's ``pmean`` over the
        mesh's axis names) in f32. Every rank of a model group holds the
        same loss, and the step averages the gradients over the batch axes,
        so the backward scales by 1 / n_model."""
        return _PmeanAll.apply(x, self)


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether a point-to-point transfer of ``x`` on ``group`` is staged
    through host memory: a CUDA tensor over gloo (a shared-card mesh),
    whose send and receive take host tensors."""
    return x.is_cuda and "gloo" in dist.get_backend(group)


def _f32_sum(op, x: torch.Tensor, *args, axes: tuple[str, ...] = ("model",)) -> torch.Tensor:
    """``op`` (a sum over "model", or over ``axes``) of ``x`` taken in f32
    (an f64 ``x`` in f64), in ``x``'s dtype."""
    return op(x if x.dtype == torch.float64 else x.float(), axes, *args).to(x.dtype)


class _Tape:
    """What the hops over the batch axes of one checkpointed region
    received, in order (``MeshCtx.recorded``)."""

    def __init__(self):
        self.kept: list[torch.Tensor] = []
        self.replay, self.at = False, 0

    def keep(self, x: torch.Tensor) -> None:
        self.kept.append(x.detach())

    def take(self) -> torch.Tensor:
        self.at += 1
        return self.kept[self.at - 1].detach()


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, tail, ctx: MeshCtx, dim: int):
        fctx.ctx, fctx.dim = ctx, dim
        every = ctx._gather("halo", tail, ctx.batch_axes, dim)
        r, k = ctx.seq_rank, tail.shape[dim]
        return every.narrow(dim, (r - 1) * k, k) if r else torch.zeros_like(tail)

    @staticmethod
    def backward(fctx, g):
        ctx, dim = fctx.ctx, fctx.dim
        every = ctx._gather("halo_back", g, ctx.batch_axes, dim)
        r, k = ctx.seq_rank, g.shape[dim]
        last = r == ctx.n_batch - 1
        return (torch.zeros_like(g) if last else every.narrow(dim, (r + 1) * k, k)), None, None


class _RelayIn(torch.autograd.Function):
    @staticmethod
    def forward(fctx, start, after, ctx: MeshCtx):
        require_fake(start, ctx.mesh)
        fctx.ctx = ctx
        r = ctx.seq_rank
        if r == 0:
            return start.clone()
        return ctx._received(ctx.batch_axes, lambda: ctx._recv(start, r - 1, "relay"))

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        ctx._count("relay_back")
        if ctx.seq_rank > 0:
            ctx._send(g, ctx.seq_rank - 1)
        return None, None, None


class _RelayOut(torch.autograd.Function):
    @staticmethod
    def forward(fctx, y, state, ctx: MeshCtx):
        require_fake(state, ctx.mesh)
        fctx.ctx, fctx.like = ctx, (state.shape, state.dtype, state.device)
        replay = ctx._tapes and ctx._tapes[-1].replay
        if not replay:  # the recompute sends nothing, and counts nothing
            ctx._count("relay")
            if ctx.seq_rank < ctx.n_batch - 1:
                ctx._send(state, ctx.seq_rank + 1)
        return y.view_as(y)

    @staticmethod
    def backward(fctx, g):
        ctx, (shape, dtype, device) = fctx.ctx, fctx.like
        like = torch.zeros(shape, dtype=dtype, device=device)
        r = ctx.seq_rank
        return g, (like if r == ctx.n_batch - 1 else ctx._recv(like, r + 1, "relay_back")), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx, dim: int, axes: tuple[str, ...]):
        fctx.ctx, fctx.dim, fctx.axes = ctx, dim, axes
        return ctx.all_gather(x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return _f32_sum(fctx.ctx.reduce_scatter, g, fctx.dim, axes=fctx.axes), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx, dim: int):
        fctx.ctx, fctx.dim = ctx, dim
        return _f32_sum(ctx.reduce_scatter, x, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.all_gather(g, ("model",), fctx.dim), None, None


class _PsumModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx):
        fctx.ctx = ctx
        return _f32_sum(ctx.all_reduce, x)

    @staticmethod
    def backward(fctx, g):
        return _f32_sum(fctx.ctx.all_reduce, g), None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx):
        return _f32_sum(ctx.all_reduce, x)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _SharedModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx):
        fctx.n = ctx.n_model
        return x.clone()

    @staticmethod
    def backward(fctx, g):
        return g / fctx.n, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx):
        fctx.ctx = ctx
        return ctx.all_to_all(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.all_to_all(g), None


class _PmeanAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: MeshCtx):
        fctx.ctx = ctx
        axes = (*ctx.batch_axes, "model")
        return ctx.all_reduce(x.float(), axes) / ctx.size(axes)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.ctx.n_model, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Each position's f32 cross-entropy from this rank's block of the vocab
    (``logits`` (..., V/n) f32, the vocab split over "model" in rank order),
    the same on every rank of the model group: the max and the sum of exp
    reduced over "model", the label's logit from the rank that holds it.
    The backward gives each rank its own block's gradient."""
    return _VocabParallelCE.apply(logits, labels, ctx)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, ctx: MeshCtx):
        V = logits.shape[-1]
        m = ctx.all_reduce(logits.amax(dim=-1), op="max")
        e = torch.exp(logits - m[..., None])
        local = labels.long() - ctx.model_rank * V
        own = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1)[..., None]
        ll = torch.where(own, logits.gather(-1, idx)[..., 0], 0.0)
        sums = ctx.all_reduce(torch.stack([e.sum(dim=-1), ll]))
        fctx.save_for_backward(e / sums[0][..., None], idx, own)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(fctx, g):
        p, idx, own = fctx.saved_tensors
        grad = p.scatter_add(-1, idx, -own[..., None].to(p.dtype))
        return grad * g[..., None], None, None


def place(x: torch.Tensor, sharding: NamedSharding, counts: dict | None = None) -> DTensor:
    """``x`` laid out as ``sharding`` on its mesh (the counterpart of
    ``jax.device_put``): a plain tensor is the global value, the same on
    every rank, of which each rank keeps its block (no communication); a
    DTensor laid out otherwise is gathered whole first (``whole``, its
    gathers counted in ``counts`` where given)."""
    mesh = sharding.mesh
    if isinstance(mesh, AbstractMesh):
        raise RuntimeError("an AbstractMesh has no devices: build the MeshCtx on a DeviceMesh")
    require_fake(x, mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(sharding.placements):
            return x
        x = whole(x, counts)
    return distribute_tensor(x, mesh, sharding.placements, src_data_rank=None)


def require_fake(x: torch.Tensor, mesh) -> None:
    """Raises where ``mesh`` is the dry run's (``DRYRUN``) and ``x`` holds
    data: its fake process group moves nothing, so a step on it would
    compute from what no other rank sent."""
    if getattr(mesh, DRYRUN, False):
        local = x.to_local() if isinstance(x, DTensor) else x
        if not isinstance(local, FakeTensor):
            raise RuntimeError("a real tensor reached a step on the dry run's mesh, whose fake "
                               "process group moves no data: trace it on fake tensors")


def whole(x: torch.Tensor, counts: dict | None = None) -> torch.Tensor:
    """A DTensor's global value, on every rank: its blocks gathered over each
    mesh dim that shards it, the innermost first, so that blocks nested on
    one tensor dim come back in mesh order; a plain tensor as it is. The
    gathers are ``torch.distributed``'s own: DTensor's ``full_tensor`` and
    ``redistribute`` run its functional collectives, which crashed (SIGSEGV)
    over gloo with CUDA tensors, a shared-card mesh, on the card's torch
    2.11."""
    if not isinstance(x, DTensor):
        return x
    mesh, t = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            src = t.movedim(p.dim, 0).contiguous()
            out = src.new_empty((mesh.size(i) * src.shape[0], *src.shape[1:]))
            if counts is not None:
                counts["all_gather"] = counts.get("all_gather", 0) + 1
            _all_gather(out, src, group=mesh.get_group(i))
            t = out.movedim(0, p.dim)
    return t.contiguous()


def on_model(sharding: NamedSharding) -> bool:
    """Whether ``sharding`` shards a dim over "model"."""
    return any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in sharding.spec)


def spec_with_model_on(shape: tuple[int, ...], ctx: MeshCtx, candidates: list[int]) -> tuple:
    """Build a spec placing "model" on the first candidate dim divisible by
    the model-axis size (fallback: replicated)."""
    spec: list = [None] * len(shape)
    for dim in candidates:
        if shape[dim] % ctx.n_model == 0:
            spec[dim] = "model"
            return tuple(spec)
    return tuple(spec)
