"""EC-coded, coverable, fragmented distributed checkpointing — the paper's
technique (CoARESF + EC-DAPopt) as the training stack's fault-tolerance layer.

Mapping (DESIGN.md §3, Adaptation 3):

  * each *host shard* of the train state serializes to one fragmented object
    (a "file") in a CoARESF store whose servers are the checkpoint hosts;
  * writes are **quorum** operations: the save completes once ⌈(n+k)/2⌉
    hosts ack per block — dead/straggling hosts do not block the train loop;
  * writes are **coverable**: tags are versions; a resurrected pre-empted
    trainer whose version is stale has its write degrade to a read (no
    clobber, no external lock service);
  * blocks are **content-defined** (gear CDC): unchanged state (frozen
    layers, optimizer hyperparams, data-pipeline state) re-writes nothing;
  * **recon** migrates all blocks to a new host set / DAP (elastic resize)
    while reads and writes continue.

The control plane runs on the deterministic sim network (virtual time), so
checkpoint latency/traffic are measurable and reproducible; the data plane
(serialization, CDC chunking and RS coding, on the CUDA kernels with
``device="cuda"``) is real compute on real bytes.

The port's trees are nested dicts, lists and tuples of tensors (a model's
state dict); ``restore`` returns tensors on the store's device.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.store import DSS, DSSParams
from repro_torch.device import host_tensor, resolve_device
from repro_torch.net.sim import LatencyModel
from repro_torch.tree import ordered_keys

Tree = Any


# ---------------------------------------------------------------- serialization
# A tree is nested dicts (keys taken in sorted order), lists and tuples, with
# None as an empty node; anything else is a leaf: a tensor, a numpy array or
# a Python/numpy scalar (stored as ``np.asarray`` of it). Leaves come out in
# the order the JAX package's tree flattening gives the same tree, so the
# array payload after the header is byte for byte its ``serialize_tree``'s
# for the same arrays. The header (structure, shapes, dtype names) is this
# package's own.
def _flatten(tree: Tree, leaves: list) -> Any:
    if isinstance(tree, dict):
        keys = ordered_keys(tree)
        return ("dict", tuple(keys), tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(x, leaves) for x in tree))
    if tree is None:
        return ("none",)
    leaves.append(tree)
    return ("leaf",)


def _unflatten(node: Any, leaves) -> Tree:
    kind = node[0]
    if kind == "dict":
        return {k: _unflatten(child, leaves) for k, child in zip(node[1], node[2])}
    if kind in ("list", "tuple"):
        items = [_unflatten(child, leaves) for child in node[1]]
        return items if kind == "list" else tuple(items)
    if kind == "none":
        return None
    return next(leaves)


def _leaf_bytes(x) -> tuple[tuple[int, ...], str, torch.Tensor]:
    """(shape, dtype name, flat uint8 tensor of the leaf's bytes on its own
    device). bf16 is read bit for bit through its storage, like any dtype."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        return arr.shape, arr.dtype.name, host_tensor(arr.reshape(-1).view(np.uint8))
    flat = x.detach().contiguous().reshape(-1)
    name = str(flat.dtype).removeprefix("torch.")
    return tuple(x.shape), name, flat.view(torch.uint8)


def serialize_tree(tree: Tree) -> bytes:
    """Tree -> bytes: pickled structure header + raw little-endian arrays.
    Leaves on a CUDA device are gathered on the card and copied to the host
    once."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    parts = [_leaf_bytes(x) for x in leaves]
    on_card = [i for i, (_, _, b) in enumerate(parts) if b.device.type != "cpu"]
    payload = [b for _, _, b in parts]
    if on_card:
        host = torch.cat([payload[i] for i in on_card]).cpu()
        off = 0
        for i in on_card:
            n = payload[i].numel()
            payload[i] = host[off:off + n]
            off += n
    header = pickle.dumps(
        {
            "tree": structure,
            "shapes": [shape for shape, _, _ in parts],
            "dtypes": [name for _, name, _ in parts],
        }
    )
    return b"".join(
        [len(header).to_bytes(8, "big"), header] + [memoryview(b.numpy()) for b in payload]
    )


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a checkpoint header")
    return dt


def deserialize_tree(blob: bytes, device: str | torch.device = "cpu") -> Tree:
    """bytes -> tree of tensors on ``device``: the payload is copied there
    once and every leaf is a view of that copy (or a copy of its slice,
    where the slice is not aligned for the leaf's dtype)."""
    hlen = int.from_bytes(blob[:8], "big")
    header = pickle.loads(blob[8 : 8 + hlen])
    flat = host_tensor(memoryview(blob)[8 + hlen :]).to(resolve_device(device), copy=True)
    leaves = []
    off = 0
    for shape, name in zip(header["shapes"], header["dtypes"]):
        dt = _torch_dtype(name)
        size = dt.itemsize
        n = int(np.prod(shape)) * size
        part = flat[off : off + n]
        if off % size:
            part = part.clone()
        leaves.append(part.view(dt).reshape(shape))
        off += n
    return _unflatten(header["tree"], iter(leaves))


# ---------------------------------------------------------------- the store
@dataclass
class CheckpointStats:
    step: int
    bytes_written: int
    blocks_total: int
    blocks_written: int
    virtual_seconds: float
    success: bool


class ECCheckpointStore:
    """Checkpoint store for one logical trainer over n checkpoint hosts.

    algorithm: any of repro_torch.core.store.ALGORITHMS — the paper's CoARESECF
    (fragmented + EC-DAPopt, the default) gives quorum writes, k-of-n
    restores, incremental block updates and live reconfiguration.
    coding_backend: GF(256) backend for the RS data plane ("numpy" |
    "kernel" | "auto"; see repro_torch.erasure.rs) — checkpoint shards are exactly
    the large-operand regime where the kernel path pays off.
    device: the data plane's device (``DSSParams.device``): "cuda" runs the
    CDC and RS kernels on the card, "cpu" their plain versions. Restored
    tensors land on it.
    """

    def __init__(
        self,
        n_hosts: int = 8,
        parity: int = 2,
        algorithm: str = "coaresecf",
        client_id: str = "trainer0",
        seed: int = 0,
        min_block: int = 1 << 16,
        avg_block: int = 1 << 18,
        max_block: int = 1 << 20,
        latency: LatencyModel | None = None,
        indexed: bool = True,
        coding_backend: str = "auto",
        device: str = "cuda",
    ):
        self.dss = DSS(
            DSSParams(
                algorithm=algorithm,
                n_servers=n_hosts,
                parity_m=parity,
                seed=seed,
                min_block=min_block,
                avg_block=avg_block,
                max_block=max_block,
                latency=latency or LatencyModel(),
                indexed=indexed,
                coding_backend=coding_backend,
                device=device,
            )
        )
        self.client = self.dss.client(client_id)
        self.client_id = client_id

    # --- save / restore ------------------------------------------------------
    # Checkpoint protocol: copy-on-write per trainer + atomic coverable
    # pointer flip. Each trainer writes its own fragmented object (keeps the
    # CDC incremental-dedup within a trainer), then flips a tiny meta object
    # (step, fid) with a coverable write — concurrent/stale flips degrade to
    # reads (paper §IV), so exactly one checkpoint wins and none tear.
    def _meta_id(self, shard_id: str) -> str:
        return f"ckptmeta/{shard_id}"

    def _read_meta(self, shard_id: str) -> tuple[int, str] | None:
        tag, raw = self.dss.net.run_op(
            self.client.dsm.cvr_read(self._meta_id(shard_id)), client=self.client_id
        )
        self.client.dsm.version[self._meta_id(shard_id)] = tag
        if not raw:
            return None
        obj = pickle.loads(bytes(raw))
        return int(obj["step"]), obj["fid"]

    def save(self, step: int, state: Tree, shard_id: str = "shard0") -> CheckpointStats:
        blob = serialize_tree({"step": step, "state": state})
        t0 = self.dss.net.now
        meta = self._read_meta(shard_id)
        if meta is not None and meta[0] >= step:
            # stale trainer: a newer checkpoint exists — degrade to no-op
            return CheckpointStats(step=step, bytes_written=0, blocks_total=0,
                                   blocks_written=0,
                                   virtual_seconds=self.dss.net.now - t0,
                                   success=False)
        fid = f"ckpt/{shard_id}/{self.client_id}"
        stats = self.dss.net.run_op(self.client.update(fid, blob),
                                    client=self.client_id)
        meta_raw = pickle.dumps({"step": step, "fid": fid})
        (_tag, _v), flag = self.dss.net.run_op(
            self.client.dsm.cvr_write(self._meta_id(shard_id), meta_raw),
            client=self.client_id,
        )
        ok = stats.get("success", False) and flag == "chg"
        return CheckpointStats(
            step=step,
            bytes_written=len(blob),
            blocks_total=stats.get("blocks", 1),
            blocks_written=stats.get("written", 1),
            virtual_seconds=self.dss.net.now - t0,
            success=ok,
        )

    def restore(self, shard_id: str = "shard0") -> tuple[int, Tree] | None:
        meta = self._read_meta(shard_id)
        if meta is None:
            return None
        _step, fid = meta
        blob = self.dss.net.run_op(self.client.read(fid), client=self.client_id)
        if not blob:
            return None
        obj = deserialize_tree(bytes(blob), self.dss.params.device)
        return int(obj["step"]), obj["state"]

    # --- fault tolerance -------------------------------------------------------
    def crash_hosts(self, host_ids: list[str]) -> None:
        self.dss.crash_servers(host_ids)

    def fault_budget(self) -> int:
        """Max simultaneous host crashes the store tolerates: ⌊(n-k)/2⌋ for
        EC, ⌊(n-1)/2⌋ for replication."""
        c = self.dss.c0
        if c.dap.startswith("ec"):
            return (c.n - c.k) // 2
        return (c.n - 1) // 2

    # --- elasticity -----------------------------------------------------------
    def reconfigure(
        self, shard_id: str = "shard0", *, n_hosts: int | None = None,
        parity: int | None = None, dap: str | None = None, fresh: bool = False,
    ) -> int:
        """ARES recon (Alg 3) of the shard's checkpoint onto a new host set:
        every block of the file the meta pointer names (this trainer's own
        file when there is no checkpoint yet), then the meta object itself.
        Returns the file's blocks moved.

        The JAX package's store reconfigures ``ckpt/{shard_id}``, a file its
        saves never write (they write ``ckpt/{shard_id}/{trainer}``), so there
        the recon moves one empty genesis block and the checkpoint stays on
        the old hosts. This store moves the checkpoint."""
        cfg = self.dss.make_config(
            dap=dap, n_servers=n_hosts, parity_m=parity, fresh_servers=fresh
        )
        meta = self._read_meta(shard_id)
        fid = meta[1] if meta is not None else f"ckpt/{shard_id}/{self.client_id}"
        moved = self.dss.net.run_op(self.client.recon(fid, cfg), client=self.client_id)
        self.dss.net.run_op(
            self.client.dsm.recon(self._meta_id(shard_id), cfg), client=self.client_id
        )
        return moved

    def new_trainer(self, client_id: str) -> "ECCheckpointStore":
        """A second (elastic / resurrected) trainer over the same hosts —
        coverability arbitrates concurrent saves."""
        twin = object.__new__(ECCheckpointStore)
        twin.dss = self.dss
        twin.client = self.dss.client(client_id)
        twin.client_id = client_id
        return twin
