"""EC-DAP [10] and EC-DAPopt (paper §VI, Algorithms 4 & 5).

[n, k]-MDS Reed-Solomon over the configuration's servers: put-data encodes
the value into n coded fragments (one per server); get-data collects Lists
from ⌈(n+k)/2⌉ servers and returns the maximum tag that is (i) present in at
least k Lists and (ii) decodable from >= k coded elements.

EC-DAPopt changes (blue text in Alg 4/5):
  * queries carry the client's local tag ``c.tag``; servers reply only with
    pairs newer than it ((tag, ⊥) for the equal tag) — Alg 5:6-9;
  * the client skips decoding when ``c.tag == t_max_dec`` (it already holds
    the value) — Alg 4:10;
  * put-data is a no-op when the incoming tag is not newer than ``c.tag``
    (the servers are already up to date) — Alg 4:20;
  * put-data updates ``(c.tag, c.val)`` on completion — Alg 4:23-24.

Multi-object batching (ISSUE 2): the primitives are implemented in their
batch form — one ``ec-query-batch`` fan-out carries N objects' Lists and all
objects that become decodable in a round are decoded by ONE fused GF(256)
matmul (``RSCode.decode_bytes_batch``) instead of N kernel launches; one
``ec-put-batch`` ships each server its coded fragment of every object, with
the whole batch encoded by one ``encode_bytes_batch`` matmul. Single-object
``get_data``/``put_data`` ride a one-element batch (see ``dap/base.py``).

Liveness (Thm 18) holds for <= (n-k)/2 crashes and <= δ concurrent put-data;
a get-data round that races more writers than δ re-queries (bounded retries,
per object — objects already resolved are not re-sent).
"""
from __future__ import annotations

from typing import Any, Generator, Iterable, Sequence

from repro_torch.core.dap.base import DapClient
from repro_torch.core.tags import TAG0, Tag
from repro_torch.erasure.rs import RSCode, element_crc_ok
from repro_torch.net.sim import RPC, Sleep

_MAX_RETRIES = 200


class EcDap(DapClient):
    def __init__(self, net, client_id, config, cfg_idx, client_state, optimized: bool):
        super().__init__(net, client_id, config, cfg_idx, client_state)
        self.optimized = optimized
        self.kind = "ec_opt" if optimized else "ec"
        # coding_backend rides ambiently on the network handle (set from
        # DSSParams.coding_backend by DSS.__init__) so every DAP a client or
        # the recon engine builds — here, coares.py, repair — codes on the
        # same backend without threading a parameter through make_dap.
        self.code = RSCode(
            n=config.n, k=config.k,
            backend=getattr(net, "coding_backend", "numpy"),
            device=net.device,
        )

    # -- client-local (c.tag, c.val) state (Alg 4) ---------------------------
    def _local(self, obj: str) -> tuple[Tag, Any]:
        return self.client_state.setdefault(("ec", obj, self.config.cfg_id), (TAG0, None))

    def _set_local(self, obj: str, tag: Tag, val: Any) -> None:
        self.client_state[("ec", obj, self.config.cfg_id)] = (tag, val)

    # -- primitives -----------------------------------------------------------
    def get_tag(self, obj: str) -> Generator:
        # The optimized client's local (c.tag, c.val) is itself a witnessed,
        # decodable version (Alg 4 state) — without counting it, get_tag could
        # return a tag OLDER than the value the client already holds (e.g.
        # after δ-trimming), inconsistent with get_data's Alg 4:10 shortcut.
        local_tag, _ = self._local(obj)
        query_tag = local_tag if self.optimized else None
        replies = yield RPC(
            dests=self.config.servers,
            msg=("ec-query", obj, self.cfg_idx, query_tag),
            need=self.config.quorum(),
        )
        counts: dict[Tag, int] = {}
        for _, lst in replies.values():
            for t, _e in lst:
                counts[t] = counts.get(t, 0) + 1
        if self.optimized:
            counts[local_tag] = max(counts.get(local_tag, 0), self.config.k)
        good = [t for t, c in counts.items() if c >= self.config.k]
        return max(good, default=TAG0)

    def get_data_batch(self, objs: Iterable[str]) -> Generator:
        objs = list(objs)
        out: dict[str, tuple[Tag, Any]] = {}
        if not objs:
            return out
        k = self.config.k
        local = {o: self._local(o) for o in objs}
        pending = objs
        for _attempt in range(_MAX_RETRIES):
            items = tuple(
                (o, local[o][0] if self.optimized else None) for o in pending
            )
            replies = yield RPC(
                dests=self.config.servers,
                msg=("ec-query-batch", items, self.cfg_idx),
                need=self.config.quorum(),
            )
            decode_jobs: list[tuple[str, Tag, dict[int, Any]]] = []
            unresolved: list[str] = []
            for pos, obj in enumerate(pending):
                # tag -> #Lists containing it; tag -> {frag_idx: element}
                seen: dict[Tag, int] = {}
                frags: dict[Tag, dict[int, Any]] = {}
                for sid, (_kindtok, lists) in replies.items():
                    fidx = self.config.frag_index(sid)
                    for t, e in lists[pos]:
                        seen[t] = seen.get(t, 0) + 1
                        # verify the element's stored CRC in the same pass
                        # that gathers it: a bit-rotted fragment is treated
                        # as absent (the tag stays visible), so the decode
                        # below never sees corrupt rows and the repair loop
                        # later restores the holder.
                        if e is not None and element_crc_ok(e):
                            frags.setdefault(t, {})[fidx] = e
                local_tag, local_val = local[obj]
                if self.optimized:
                    # the client's own (c.tag, c.val) counts as decodable
                    seen[local_tag] = max(seen.get(local_tag, 0), k)
                    frags.setdefault(local_tag, {})
                t_max = max(seen, default=TAG0)
                # EC fast-read rule (mirror of the ABD one): if EVERY reply
                # in this quorum lists t_max with a coded element, a full
                # quorum durably stores it — any later quorum intersects this
                # one in >= k element-holders, so the read's put-back phase
                # may be skipped soundly (see ``put_data_batch``).
                if t_max > TAG0 and len(frags.get(t_max, {})) >= len(replies):
                    safe_key = ("ec_safe", obj, self.config.cfg_id)
                    if t_max > self.client_state.get(safe_key, TAG0):
                        self.client_state[safe_key] = t_max
                dec = {
                    t
                    for t in seen
                    if len(frags.get(t, {})) >= k
                    or (self.optimized and t == local_tag)
                    or t == TAG0
                }
                resolved = False
                if dec:
                    t_dec = max(dec)
                    if t_dec == t_max:
                        resolved = True
                        if self.optimized and t_dec == local_tag:
                            out[obj] = (local_tag, local_val)  # Alg 4:10 — no decode
                        elif t_dec == TAG0:
                            out[obj] = (TAG0, None)
                        else:
                            decode_jobs.append((obj, t_dec, frags[t_dec]))
                if not resolved:
                    unresolved.append(obj)
            if decode_jobs:
                # ONE fused GF(256) matmul for every object that resolved this
                # round (grouped by surviving-fragment index set inside).
                # hand RSCode every surviving fragment — it prefers the
                # all-systematic subset (no matmul) and groups the rest by
                # index set over one cached inverted generator each.
                values = self.code.decode_bytes_batch(
                    [
                        ({i: e[0] for i, e in fm.items()}, fm[min(fm)][1])
                        for _obj, _t, fm in decode_jobs
                    ]
                )
                for (obj, t_dec, _fm), value in zip(decode_jobs, values):
                    out[obj] = (t_dec, value)
                    # Alg 4:23-24 analogue for the skipped put-back: adopt the
                    # decoded pair as (c.tag, c.val) ONLY when the fast-read
                    # rule proved a full quorum stores it — the same durability
                    # a completed put-data would have established.
                    if (
                        self.optimized
                        and t_dec > local[obj][0]
                        and self.client_state.get(
                            ("ec_safe", obj, self.config.cfg_id), TAG0
                        ) >= t_dec
                    ):
                        self._set_local(obj, t_dec, value)
                yield Sleep(
                    self.net.latency.dec_per_byte * sum(len(v) for v in values)
                )
            if not unresolved:
                return out
            # liveness retry: a concurrent writer's tag was visible but not
            # yet decodable; re-query (paper: the read "does not complete" —
            # operationally we re-poll) for the unresolved objects only.
            pending = unresolved
            yield Sleep(float(self.net.rng.uniform(0.5e-3, 2e-3)))
        raise RuntimeError(
            f"ec get-data exceeded {_MAX_RETRIES} retries on {pending}"
        )

    # -- batched encode: a put batch encodes every uncached value with one
    # fused GF(256) matmul (RSCode.encode_bytes_batch, bit-identical to
    # per-value encoding). The FM can also pre-register an update's values
    # via client.precode() (ISSUE 1) so a SEQUENTIAL multi-block write —
    # one put_data at a time, non-indexed walk — still encodes the whole
    # update on its first block write and serves the rest from the cache.
    def _encode_values(
        self, values: Sequence[bytes]
    ) -> list[tuple[list[bytes], int, list[int]]]:
        ckey = ("_ecache", self.config.n, self.config.k)
        cache = self.client_state.get(ckey) or {}
        pending = self.client_state.get("_batch_values") or ()
        missing = sorted((set(values) | set(pending)) - cache.keys())
        # with_crc: per-fragment CRC-32s come out of the same traversal that
        # slices the coded rows into fragment bytes — shipped inside each
        # element so readers/repair can detect bit-rot without a second pass.
        if len(missing) == 1:
            fresh = {missing[0]: self.code.encode_bytes(missing[0], with_crc=True)}
        elif missing:
            fresh = dict(
                zip(missing, self.code.encode_bytes_batch(missing, with_crc=True))
            )
        else:
            fresh = {}
        if fresh and pending:
            # Persist ONLY the pre-registered update's values (the precode
            # contract: evicted by the next precode call). Ad-hoc values stay
            # local to this call, so long-lived clients that never precode
            # don't accumulate an unbounded plaintext->fragments cache.
            keep = {v: fresh[v] for v in pending if v in fresh}
            if keep:
                self.client_state[ckey] = {**cache, **keep}
        lookup = {**cache, **fresh}
        return [lookup[v] for v in values]

    def put_data_batch(self, items: Sequence[tuple[str, Tag, Any]]) -> Generator:
        todo = []
        for obj, tag, value in items:
            local_tag, _ = self._local(obj)
            if self.optimized and tag <= local_tag:
                continue  # Alg 4:20 — servers already up to date
            safe = self.client_state.get(("ec_safe", obj, self.config.cfg_id), TAG0)
            if tag <= safe:
                continue  # a full quorum already holds this tag's elements
            todo.append((obj, tag, value))
        if not todo:
            return None
        encoded = self._encode_values(
            [b"" if v is None else v for _o, _t, v in todo]
        )
        per_dest = {
            sid: (
                "ec-put-batch",
                tuple(
                    (
                        obj,
                        tag,
                        (
                            frags[self.config.frag_index(sid)],
                            orig,
                            crcs[self.config.frag_index(sid)],
                        ),
                    )
                    for (obj, tag, _v), (frags, orig, crcs) in zip(todo, encoded)
                ),
                self.cfg_idx,
                self.config.delta,
            )
            for sid in self.config.servers
        }
        yield RPC(
            dests=self.config.servers,
            msg=None,
            per_dest=per_dest,
            need=self.config.quorum(),
            pre_delay=self.net.latency.enc_per_byte
            * sum(0 if v is None else len(v) for _o, _t, v in todo),
        )
        for obj, tag, _value in todo:
            # the put waited for a quorum of acks -> a full quorum now holds
            # this tag's coded elements (same rule as the fast read above)
            safe_key = ("ec_safe", obj, self.config.cfg_id)
            if tag > self.client_state.get(safe_key, TAG0):
                self.client_state[safe_key] = tag
        if self.optimized:
            for obj, tag, value in todo:
                local_tag, _ = self._local(obj)
                if tag >= local_tag:
                    self._set_local(obj, tag, value)  # Alg 4:23-24
        return None
