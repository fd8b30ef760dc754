"""ABD-DAP [6], [22] with the CoBFS [4] conditional-transfer optimization.

get-data: read (tag, value) from a majority, return the max. Clients send
their last-known tag; a server whose stored tag is not newer replies with
``(tag, None)`` (tag-only) — "avoids unnecessary object transmissions
between the clients and the servers" ([4], adopted by the paper's §VI as the
inspiration for EC-DAPopt). The client serves repeated reads of unchanged
blocks from its local copy, which is what makes CoABDF/CoARESABDF reads
O(changed blocks) instead of O(file).

put-data: write (tag, value) to a majority (servers keep the max).

Both primitives are implemented in their multi-object batch form (ISSUE 2):
one ``abd-get-batch`` / ``abd-put-batch`` fan-out carries N objects, and the
single-object calls ride a one-element batch (see ``dap/base.py``).
"""
from __future__ import annotations

from typing import Any, Generator, Iterable, Sequence

from repro_torch.core.dap.base import DapClient
from repro_torch.core.tags import TAG0, Tag
from repro_torch.net.sim import RPC


class AbdDap(DapClient):
    kind = "abd"

    # client-local (tag, value) cache per (obj, config) — same state the
    # EC-DAPopt keeps (Alg 4's c.tag/c.val)
    def _local(self, obj: str) -> tuple[Tag, Any]:
        return self.client_state.setdefault(
            ("abd", obj, self.config.cfg_id), (TAG0, None)
        )

    def _set_local(self, obj: str, tag: Tag, val: Any) -> None:
        self.client_state[("abd", obj, self.config.cfg_id)] = (tag, val)

    def get_tag(self, obj: str) -> Generator:
        replies = yield RPC(
            dests=self.config.servers,
            msg=("abd-get-tag", obj, self.cfg_idx),
            need=self.config.quorum(),
        )
        return max((r[1] for r in replies.values()), default=TAG0)

    def get_data_batch(self, objs: Iterable[str]) -> Generator:
        objs = list(objs)
        if not objs:
            return {}
        local = {o: self._local(o) for o in objs}
        replies = yield RPC(
            dests=self.config.servers,
            msg=("abd-get-batch", tuple((o, local[o][0]) for o in objs), self.cfg_idx),
            need=self.config.quorum(),
        )
        out: dict[str, tuple[Tag, Any]] = {}
        for pos, obj in enumerate(objs):
            pairs = [r[1][pos] for r in replies.values()]
            tag, val = max(pairs, key=lambda tv: tv[0])
            # If EVERY quorum reply already holds the max tag, a full quorum
            # stores it -> the read's propagation phase may be skipped soundly
            # (any later quorum intersects this one). Classic fast-read rule.
            if all(p[0] >= tag for p in pairs):
                self.client_state[("abd_safe", obj, self.config.cfg_id)] = tag
            local_tag, local_val = local[obj]
            if tag <= local_tag:
                out[obj] = (local_tag, local_val)  # nothing newer anywhere
            else:
                # tag > local_tag: that server shipped the value
                self._set_local(obj, tag, val)
                out[obj] = (tag, val)
        return out

    def put_data_batch(self, items: Sequence[tuple[str, Tag, Any]]) -> Generator:
        todo = []
        for obj, tag, value in items:
            safe = self.client_state.get(("abd_safe", obj, self.config.cfg_id), None)
            if safe is not None and tag <= safe:
                continue  # already quorum-stored; skip the write-back round
            todo.append((obj, tag, value))
        if todo:
            yield RPC(
                dests=self.config.servers,
                msg=("abd-put-batch", tuple(todo), self.cfg_idx),
                need=self.config.quorum(),
            )
        for obj, tag, value in todo:
            local_tag, _ = self._local(obj)
            if tag >= local_tag:
                self._set_local(obj, tag, value)
            safe = self.client_state.get(("abd_safe", obj, self.config.cfg_id), None)
            if safe is None or tag > safe:
                self.client_state[("abd_safe", obj, self.config.cfg_id)] = tag
        return None
