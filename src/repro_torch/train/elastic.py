"""Elastic scaling: mesh resize as an ARES reconfiguration.

Scale-up/down procedure (the reference's ``repro.train.elastic``):
  1. quorum-checkpoint the current state to the EC store (cheap: CDC blocks);
  2. recon the store onto the new host set (ARES recon per block: the
     service stays readable during the move);
  3. restore, and place the state on the new mesh (``reshard_state`` with
     the new mesh's specs).

The store lives on rank 0, which saves the gathered (whole) state, as the
reference saves whole arrays, and restores it; every rank then receives the
restored state, so that each can take its block of it on the new mesh.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.sharding import place, whole
from repro_torch.train.checkpoint import ECCheckpointStore
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def reshard_state(state: Tree, spec_tree: Tree) -> Tree:
    """``state`` laid out as ``spec_tree``'s shardings, each on its mesh
    (``models.sharding.place``): a DTensor is redistributed; a plain tensor
    is the global value, the same on every rank, of which each rank keeps
    its block."""
    return tree_map(place, state, spec_tree)


def elastic_resize(
    store: ECCheckpointStore | None,
    state: Tree,
    step: int,
    *,
    new_hosts: int,
    new_parity: int | None = None,
    shard_id: str = "shard0",
) -> tuple[int, Tree, int]:
    """Checkpoint -> recon to the resized host set -> restore.

    ``state`` is a tree of DTensors (gathered whole first: a collective on
    their mesh) or plain tensors. ``store`` is rank 0's (unused, and may be
    None, on the other ranks). Returns (restored step, restored state,
    blocks moved) on every rank, the state whole, for ``reshard_state`` onto
    the new mesh."""
    full = tree_map(whole, state)
    many = dist.is_initialized() and dist.get_world_size() > 1
    if not many or dist.get_rank() == 0:
        st = store.save(step, full, shard_id)
        if not st.success:
            raise RuntimeError(f"elastic resize needs a successful checkpoint: {st}")
        moved = store.reconfigure(shard_id, n_hosts=new_hosts, parity=new_parity)
        restored = store.restore(shard_id)
        if restored is None:
            raise RuntimeError("elastic resize: the restore found no checkpoint")
        rstep, rstate = restored
        if not many:
            return rstep, rstate, moved
        head = [rstep, moved, tree_map(lambda x: (tuple(x.shape), x.dtype), rstate)]
    else:
        head = [None, None, None]
    # every rank gets the restored state from rank 0
    dist.broadcast_object_list(head, src=0)
    rstep, moved, shapes = head
    if dist.get_rank() != 0:
        device = next(x.device for x in tree_leaves(full))
        rstate = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device=device), shapes)
    for x in tree_leaves(rstate):
        dist.broadcast(x, src=0)
    return rstep, rstate, moved
