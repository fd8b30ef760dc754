"""Counts of one step, taken as it runs: FLOPs, HBM bytes, collectives by
kind, and the bytes live at its peak.

The counterpart of the reference's ``repro.roofline.hlo_parse``, which reads
the same quantities off compiled HLO text (``analyze``, ``parse_blocks``,
``top_byte_contributors``). The port compiles nothing: a step is eager
PyTorch, so ``count_step`` runs it under two dispatch modes and counts each
operation as it is dispatched. Run under ``FakeTensorMode`` (the dry run,
``launch.dryrun``) the step computes nothing and needs no card; run on real
tensors it counts the same, which is how the tests and ``chip_smoke.py``
hold the trace against the step. Eager execution runs every layer, so there
is no loop body to weight by its trip count.

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (2 M N K a matrix
  product), with the flash-attention operator's own formula
  (``kernels/flash_attention/ops.py``: 4 B H hd times its unmasked pairs).
- **HBM bytes**: every operation that moves data reads its tensor inputs and
  writes its outputs, each once. Not counted: views and aliases, allocations
  (``empty``), collectives (their own term below). An operation that
  gathers rows (``embedding``, ``index_select``, ``gather``, indexing) reads
  the rows it returns, not its whole source; one that writes rows in place
  (``index_put_``, ``index_copy_``, ``scatter_``, ...) writes the rows of
  its source, and a copy or fill does not read its destination. A 0-d
  tensor moves no bytes (a scalar rides in a kernel's arguments). Flash
  reads q, the K/V rows its masks reach and writes its output
  (``work.hbm_bytes``). No operation is assumed to stay in cache.
- **Collective bytes**, the reference's wire model per kind: all-gather,
  all-to-all and point-to-point (a send's operand, a receive's result)
  count their result bytes, reduce-scatter its operand bytes, all-reduce 2x
  its result bytes. Calls are counted by kind as well, so that a test can
  hold them against ``MeshCtx.counts`` (``ctx_calls``).
- **Memory**: every tensor storage the step allocates is followed until it
  is freed (``weakref.finalize`` on the storage); the storages reachable
  from the step's arguments are live from the start. The peak is the most
  bytes live at once, and the largest storages live then are listed with
  the operation that made each and the innermost function of the port that
  called it.
"""
from __future__ import annotations

import sys
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import work

_PORT = str(Path(__file__).resolve().parents[1])  # src/repro_torch
_HERE = str(Path(__file__).resolve().parent)
# the mesh layer's collectives and the tree walk: a buffer is named for the code that called them
_SKIP = ("models/sharding.py", "repro_torch/tree.py")
_C10D = "torch/distributed/distributed_c10d.py"
# what makes a storage and moves no data
_ALLOCATE = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
             "_unsafe_view", "lift_fresh", "_local_scalar_dense"}
# gathers of rows: read what they return (and their indices), not their whole source
_GATHER_ROWS = {"embedding", "index_select", "index", "gather"}
# writes of rows in place: write (and read) the rows of their source only
_WRITE_ROWS = {"index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_",
               "scatter_reduce_", "masked_scatter_", "_index_put_impl_"}
# writes that do not read their destination
_OVERWRITE = {"copy_", "fill_", "zero_"}
# the c10d operations ``MeshCtx`` and ``sharding.whole`` make -> (kind, the
# argument whose tensors carry the wire bytes, factor); any other raises
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0, 2),
    "_allgather_base_": ("all-gather", 0, 1),  # (output, input): the result
    "_reduce_scatter_base_": ("reduce-scatter", 1, 1),  # (output, input): the operand
    "alltoall_base_": ("all-to-all", 0, 1),  # (output, input): the result
    "send": ("send", 0, 1),
    "recv_": ("recv", 0, 1),  # the buffer received into: the result
}
# ``MeshCtx.counts`` kind -> the c10d kind its collective dispatches as
_CTX_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather", "halo": "all-gather",
              "halo_back": "all-gather", "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all"}
# c10d kind -> the reference's name of its wire bytes (point-to-point: "collective-permute")
_WIRE = {"all-reduce": "all-reduce", "all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
         "all-to-all": "all-to-all", "send": "collective-permute", "recv": "collective-permute"}


@dataclass
class StepCount:
    """What ``count_step`` counted (bytes and FLOPs of this process's rank)."""
    flops: int = 0
    hbm_bytes: int = 0
    bytes_by_op: dict = field(default_factory=dict)
    collective_bytes: dict = field(default_factory=dict)  # the reference's kind names
    collective_calls: dict = field(default_factory=dict)  # c10d kind -> calls
    flash: list = field(default_factory=list)  # one dict of its arguments a flash call
    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    top: list = field(default_factory=list)  # the largest storages live at the peak
    seconds: float = 0.0

    @property
    def collective_bytes_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def flash_calls(self) -> int:
        return len(self.flash)


def ctx_calls(counts: dict, seq_rank: int = 0, n_seq: int = 1) -> dict:
    """The c10d calls by kind that ``MeshCtx.counts`` stands for on a rank
    at place ``seq_rank`` of ``n_seq`` sequence ranks: each counted
    collective one call of its kind (the halo and its backward an
    all-gather each); a relay one receive on every rank but the first, one
    send on every rank but the last; its backward (``relay_back``, in
    reverse order) one send on every rank but the first, one receive on
    every rank but the last."""
    out: dict = {}
    for kind, n in counts.items():
        if kind in ("relay", "relay_back"):
            first, last = ("recv", "send") if kind == "relay" else ("send", "recv")
            if seq_rank > 0:
                out[first] = out.get(first, 0) + n
            if seq_rank < n_seq - 1:
                out[last] = out.get(last, 0) + n
            continue
        c10d = _CTX_KINDS[kind]
        out[c10d] = out.get(c10d, 0) + n
    return {k: v for k, v in out.items() if v}


def tensors_of(tree) -> list[torch.Tensor]:
    """The plain tensors of a tree (a DTensor's local block)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes through HBM; a 0-d tensor's none (a scalar rides in
    the kernel's arguments)."""
    return t.numel() * t.element_size() if t.dim() else 0


def _where() -> str:
    """The innermost function of the port (outside this module) on the
    stack: ``path/in/the/port.py:function``."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if name.startswith(_PORT) and not name.startswith(_HERE) and \
                not name.endswith(_SKIP):
            return f"{name[len(_PORT) + 1:]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


def _in_collective() -> bool:
    """Whether a ``torch.distributed`` collective is on the stack: a copy it
    makes itself (gloo's into the caller's buffer as its work completes)
    is the collective's traffic, counted in its own term, and the card's
    NCCL makes none."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith(_C10D):
            return True
        frame = frame.f_back
    return False


class _Counter(TorchDispatchMode):
    """HBM bytes, collectives and live storages of every operation dispatched."""

    WHERE_MIN = 1 << 20  # storages at least this large record who made them

    def __init__(self, args, top: int):
        super().__init__()
        self.c = StepCount()
        self.top_n = top
        self.live: dict[int, tuple] = {}  # storage key -> (bytes, op, where, shape, dtype)
        self.finalizers: list = []
        self.now = 0
        self.peak_pending = False
        for t in tensors_of(args):
            self._track(t, "argument", "argument")
        self.c.argument_bytes = self.c.peak_bytes = self.now

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor, op: str, where: str | None) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live:
            return
        n = s.nbytes()
        if where is None:
            where = _where() if n >= self.WHERE_MIN else ""
        self.live[key] = (n, op, where, tuple(t.shape), str(t.dtype).removeprefix("torch."))
        self.finalizers.append(weakref.finalize(s, self._free, key))
        self.now += n
        if self.now > self.c.peak_bytes:
            self.c.peak_bytes = self.now
            self.peak_pending = True

    def _free(self, key: int) -> None:
        if self.peak_pending:
            self._snapshot()
        n = self.live.pop(key)[0]
        self.now -= n

    def _snapshot(self) -> None:
        rows = sorted(self.live.values(), key=lambda r: -r[0])[:self.top_n]
        self.c.top = [{"bytes": n, "op": op, "where": where, "shape": list(shape),
                       "dtype": dtype} for n, op, where, shape, dtype in rows]
        self.peak_pending = False

    def close(self) -> None:
        if self.peak_pending:
            self._snapshot()
        for f in self.finalizers:
            f.detach()

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            self._collective(name, args)
            return out
        if func.is_view or ns not in ("aten", "repro_torch"):
            return out  # views, and metadata queries (``prim.device``)
        outs, op = tensors_of(out), func.overloadpacket.__name__
        returns = func._schema.returns
        for i, t in enumerate(outs):  # the outputs that are new storages, not aliases
            if i >= len(returns) or returns[i].alias_info is None:
                self._track(t, op, None)
        if name in _ALLOCATE or (name in _OVERWRITE and _in_collective()):
            return out
        n = self._bytes(func, name, args, kwargs, outs)
        self.c.hbm_bytes += n
        self.c.bytes_by_op[op] = self.c.bytes_by_op.get(op, 0) + n
        return out

    def _bytes(self, func, name: str, args, kwargs, outs: list[torch.Tensor]) -> int:
        if func._schema.name == "repro_torch::flash_attention":
            q, k = args[0], args[1]
            causal, window, q_offset = args[3], args[4], args[5]
            B, H, Sq, hd = q.shape
            self.c.flash.append({"B": B, "H": H, "Hkv": k.shape[1], "Sq": Sq, "Sk": k.shape[2],
                                 "hd": hd, "window": window, "causal": causal,
                                 "q_offset": q_offset})
            return work.hbm_bytes(B, H, k.shape[1], Sq, k.shape[2], hd, q.element_size(),
                                  window, causal, q_offset)
        ins = tensors_of((args, kwargs))
        # each tensor once, by identity (an operation may take one twice)
        seen: dict[int, torch.Tensor] = {}
        for t in ins:
            seen.setdefault(id(t), t)
        ins = list(seen.values())
        written = sum(_nbytes(t) for t in outs)
        if name in _GATHER_ROWS:
            # the rows returned, and the indices
            return 2 * written + sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        if name in _WRITE_ROWS:
            # the source's rows (and indices) read, those rows written
            rows = sum(_nbytes(t) for t in ins[1:] if t.is_floating_point())
            return sum(_nbytes(t) for t in ins[1:]) + rows
        if name in _OVERWRITE:
            return sum(_nbytes(t) for t in ins[1:]) + written
        return sum(_nbytes(t) for t in ins) + written

    def _collective(self, name: str, args) -> None:
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"c10d.{name}: no wire model for this collective")
        kind, carries, factor = _COLLECTIVES[name]
        wire = _WIRE[kind]
        self.c.collective_calls[kind] = self.c.collective_calls.get(kind, 0) + 1
        self.c.collective_bytes[wire] = self.c.collective_bytes.get(wire, 0.0) + factor * float(
            sum(t.numel() * t.element_size() for t in tensors_of(args[carries])))


def count_step(step: Callable, *args, top: int = 16) -> tuple[Any, StepCount]:
    """``step(*args)`` run under the counting modes; returns its result and
    the counts. ``args`` is what is live at the step's start (its
    arguments' storages); the step's result's storages that lie in them are
    its ``alias_bytes`` (a cache written in place)."""
    counter = _Counter(args, top)
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as flops, counter:
            out = step(*args)
        counter.c.seconds = time.perf_counter() - t0
        counter.c.flops = int(flops.get_total_flops())
        args_keys = {t.untyped_storage()._cdata for t in tensors_of(args)}
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors_of(out)}
        counter.c.output_bytes = sum(outs.values())
        counter.c.alias_bytes = sum(n for k, n in outs.items() if k in args_keys)
    finally:
        counter.close()
    return out, counter.c
