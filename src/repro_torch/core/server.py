"""Replica server: ABD store, EC fragment Lists (Alg 5), nextC, consensus.

One server object hosts state for *every* (object, configuration-index) pair —
exactly the paper's model where a physical server participates in many
configurations and stores many blocks. State is created lazily with the
initial value ``(t0, v0 = None)`` / ``{(t0, Φ_i(v0))}``.

Message dispatch is a single dict lookup (ISSUE 7): ``handle`` used to scan a
~28-branch if/elif chain per message, a per-message cost that dominated at
10^5-session scale. Each op is a method; the ``_DISPATCH`` table maps the op
tag to it. Batch envelopes call the single-object methods directly — batching
still changes framing, never semantics.

Read-only requests (queries, gets, next-c reads, margin probes) are answered
from a per-server reply cache keyed on the request tuple itself, invalidated
whenever the state they read mutates. A zipfian read-heavy fleet asks every
server the same hot questions over and over; returning the *same reply
object* makes those answers identity-stable, which is what lets the
network's ``SizingMemo`` frame a repeated ec-list/tag-set reply once instead
of walking it per message (ISSUE 7). Values are unchanged — a cache hit is
byte-identical to recomputing — so fast/legacy traces are unaffected.
"""
from __future__ import annotations

from typing import Any

from repro_torch.net.sim import Server
from repro_torch.core.tags import TAG0, Tag
from repro_torch.erasure.rs import element_crc_ok


class _ObjState(dict):
    """Per-object mutable state that invalidates the owning server's cached
    read replies on ANY write — including direct fault injection from tests
    and benchmarks that bypass ``handle`` (deleting a fragment to simulate
    loss must evict the cached ec-list that still advertises it). Reads are
    plain ``dict`` reads (no override), so the hot path pays nothing."""

    __slots__ = ("_inval", "_obj")

    def __init__(self, inval, obj, *args):
        super().__init__(*args)
        self._inval = inval
        self._obj = obj

    def __setitem__(self, k, v):
        self._inval(self._obj)
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._inval(self._obj)
        dict.__delitem__(self, k)

    def pop(self, *args):
        self._inval(self._obj)
        return dict.pop(self, *args)

    def popitem(self):
        self._inval(self._obj)
        return dict.popitem(self)

    def clear(self):
        self._inval(self._obj)
        dict.clear(self)

    def update(self, *args, **kw):
        self._inval(self._obj)
        dict.update(self, *args, **kw)

    def setdefault(self, k, default=None):
        self._inval(self._obj)
        return dict.setdefault(self, k, default)


class _StateMap(dict):
    """``(obj, idx) -> state`` map with the same write-invalidation contract
    as :class:`_ObjState`; plain-dict values assigned in are wrapped so
    their own later mutations keep invalidating."""

    __slots__ = ("_inval",)

    def __init__(self, inval):
        super().__init__()
        self._inval = inval

    def __setitem__(self, key, value):
        self._inval(key[0])
        if type(value) is dict:
            value = _ObjState(self._inval, key[0], value)
        dict.__setitem__(self, key, value)

    def __delitem__(self, key):
        self._inval(key[0])
        dict.__delitem__(self, key)

    def pop(self, key, *default):
        self._inval(key[0])
        return dict.pop(self, key, *default)

    def clear(self):
        for key in self:
            self._inval(key[0])
        dict.clear(self)

    def update(self, *args, **kw):
        for key, value in dict(*args, **kw).items():
            self[key] = value

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return dict.__getitem__(self, key)


class StorageServer(Server):
    # Runtime-sanitizer hook (repro.analysis.sanitizer): when set, every
    # per-object invalidation that fires OUTSIDE ``handle`` — i.e. direct
    # state surgery by tests/fault injection through the tracked maps — is
    # reported as ``_mut_observer(sid, obj)`` so the sanitizer can drop its
    # high-water marks for that (server, object) instead of flagging the
    # injected loss as a protocol bug. None (the default) costs one
    # attribute read per handle() call and nothing per mutation.
    _mut_observer = None
    # Happens-before race-tracker hook (repro.analysis.races): when set,
    # EVERY per-object invalidation is reported as
    # ``_race_observer(sid, obj, in_handle)`` — in-handle mutations are the
    # writes the vector-clock tracker orders and checks; out-of-handle ones
    # are external surgery it forgives (mirroring ``_mut_observer``).
    _race_observer = None
    _in_handle = False

    def __init__(self, sid: str):
        super().__init__(sid)
        # ABD-DAP: (obj, cfg_idx) -> (tag, value)
        self.abd: dict[tuple, tuple[Tag, Any]] = _StateMap(self._invalidate)
        # EC-DAP: (obj, cfg_idx) -> {tag: element | None}; None = trimmed ⊥
        self.ec: dict[tuple, dict[Tag, Any]] = _StateMap(self._invalidate)
        # reconfiguration: (obj, cfg_idx) -> (config, status)
        self.next_c: dict[tuple, tuple[Any, str]] = _StateMap(self._invalidate)
        # consensus acceptor: (obj, cfg_idx) -> [promised, accepted_ballot, accepted_val]
        self.cons: dict[tuple, list] = {}
        # read-reply cache: request tuple -> reply object, with a per-object
        # key index so a mutation of one object only evicts the cached
        # answers that mention it (see module docstring).
        self._rcache: dict[tuple, Any] = {}
        self._rkeys: dict[Any, list[tuple]] = {}

    def on_recover(self) -> None:
        # Crash-recovery (ISSUE 10): the reply/identity cache is volatile —
        # it memoizes answers computed BEFORE the crash and must not survive
        # it (a wiped-then-restored replica serving a stale cached reply is
        # exactly the gray failure the satellite regression test pins).
        # Durable protocol state (abd/ec/next_c/cons) stays. In-place
        # ``clear()`` — rebinding the maps would bypass _StateMap tracking.
        self._rcache.clear()
        self._rkeys.clear()

    def _invalidate(self, obj: Any) -> None:
        keys = self._rkeys.pop(obj, None)
        if keys:
            cache = self._rcache
            for k in keys:
                cache.pop(k, None)
        obs = self._mut_observer
        if obs is not None and not self._in_handle:
            obs(self.sid, obj)
        robs = self._race_observer
        if robs is not None:
            robs(self.sid, obj, self._in_handle)

    # ------------------------------------------------------------------ state
    def _abd_state(self, key: tuple) -> tuple[Tag, Any]:
        if key not in self.abd:
            # lazy state creation is a mutation margin probes can observe;
            # the tracked map invalidates cached replies on the write
            self.abd[key] = (TAG0, None)
        return self.abd[key]

    def _ec_list(self, key: tuple) -> dict[Tag, Any]:
        # initial List = {(t0, Φ_i(v0))}; v0 = None encoded as the sentinel
        if key not in self.ec:
            self.ec[key] = {TAG0: ("", 0)}
        return self.ec[key]

    @staticmethod
    def _trim_list(lst: dict[Tag, Any], delta: int) -> None:
        # Alg 5:15-18: trim the *coded value* of the minimum tags while more
        # than δ+1 hold one (the (τ_min, ⊥) placeholders remain).
        full = [t for t, e in lst.items() if e is not None]
        while len(full) > delta + 1:
            tmin = min(full)
            lst[tmin] = None
            full.remove(tmin)

    # ---------------------------------------------------------------- handler
    def handle(self, sender: str, msg: tuple) -> Any:
        if self._mut_observer is None and self._race_observer is None:
            return self._handle(sender, msg)
        # sanitized/race-checked run: protocol-driven mutations inside the
        # handler must NOT be reported as external surgery
        self._in_handle = True
        try:
            return self._handle(sender, msg)
        finally:
            self._in_handle = False

    def _handle(self, sender: str, msg: tuple) -> Any:
        op = msg[0]
        objs = self._READ_ONLY.get(op)
        if objs is not None:
            try:
                reply = self._rcache.get(msg)
            except TypeError:  # unhashable payload: answer uncached
                return self._DISPATCH[op](self, sender, msg)
            if reply is not None:
                return reply
            reply = self._DISPATCH[op](self, sender, msg)
            if len(self._rcache) >= 4096:
                self._rcache.clear()
                self._rkeys.clear()
            self._rcache[msg] = reply
            rkeys = self._rkeys
            for o in objs(msg):
                rkeys.setdefault(o, []).append(msg)
            return reply
        fn = self._DISPATCH.get(op)
        if fn is None:
            raise ValueError(f"unknown message {op!r}")
        return fn(self, sender, msg)

    # ---- multi-object batch messages (ISSUE 2): one RPC fan-out carries
    # N objects' payloads; each item is handled exactly as its single-
    # object form, so batching changes framing, never semantics.
    def _h_ec_query_batch(self, sender: str, msg: tuple) -> Any:
        # ("ec-query-batch", ((obj, client_tag), ...), idx)
        _, items, idx = msg
        return ("ec-list-batch", tuple(
            self._h_ec_query(sender, ("ec-query", obj, idx, ctag))[1]
            for obj, ctag in items
        ))

    def _h_ec_put_batch(self, sender: str, msg: tuple) -> Any:
        # ("ec-put-batch", ((obj, tag, elem), ...), idx, delta) — elem
        # differs per destination server (its own coded fragment).
        _, items, idx, delta = msg
        for obj, tag, elem in items:
            self._h_ec_put(sender, ("ec-put", obj, idx, tag, elem, delta))
        return ("ack", len(items))

    def _h_abd_get_batch(self, sender: str, msg: tuple) -> Any:
        # ("abd-get-batch", ((obj, client_tag), ...), idx)
        _, items, idx = msg
        return ("abd-val-batch", tuple(
            self._h_abd_get(sender, ("abd-get", obj, idx, ctag))[1:]
            for obj, ctag in items
        ))

    def _h_abd_put_batch(self, sender: str, msg: tuple) -> Any:
        _, items, idx = msg
        for obj, tag, val in items:
            self._h_abd_put(sender, ("abd-put", obj, idx, tag, val))
        return ("ack", len(items))

    def _h_read_next_batch(self, sender: str, msg: tuple) -> Any:
        # ("read-next-batch", ((obj, idx), ...)) — indices may differ per
        # object (objects of one file can sit at different frontiers).
        _, items = msg
        return ("next-c-batch", tuple(
            self.next_c.get((obj, idx)) for obj, idx in items
        ))

    def _h_write_next_batch(self, sender: str, msg: tuple) -> Any:
        _, items = msg
        for obj, idx, cfg, status in items:
            self._h_write_next(sender, ("write-next", obj, idx, cfg, status))
        return ("ack", len(items))

    def _h_cons_p1_batch(self, sender: str, msg: tuple) -> Any:
        # One Paxos acceptor instance per (obj, idx); the ballot is shared
        # by the batch but promises are tracked per object.
        _, objs, idx, ballot = msg
        return ("p1-batch", tuple(
            self._h_cons_p1(sender, ("cons-p1", obj, idx, ballot))
            for obj in objs
        ))

    def _h_cons_p2_batch(self, sender: str, msg: tuple) -> Any:
        _, items, idx, ballot = msg
        return ("p2-batch", tuple(
            self._h_cons_p2(sender, ("cons-p2", obj, idx, ballot, value))
            for obj, value in items
        ))

    def _h_margin_batch(self, sender: str, msg: tuple) -> Any:
        # ("margin-batch", (obj, ...), idx) — tag-only health snapshot for
        # the reliability probes (ISSUE 3): per object, the ABD tag this
        # server stores (None when it never stored one), the EC List as
        # (tag, holds_element) pairs (None when no List exists), and the
        # status of any announced successor configuration at this index
        # ("P"/"F"/None) so probes can tell historical state from live
        # state. Never ships values/elements: probing N objects costs
        # O(N tags).
        _, objs, idx = msg
        out = []
        for obj in objs:
            ab = self.abd.get((obj, idx))
            lst = self.ec.get((obj, idx))
            nxt = self.next_c.get((obj, idx))
            out.append((
                ab[0] if ab is not None else None,
                tuple((t, e is not None) for t, e in lst.items())
                if lst is not None else None,
                nxt[1] if nxt is not None else None,
            ))
        return ("margin-batch", tuple(out))

    # ---- single-object messages
    def _h_abd_get(self, sender: str, msg: tuple) -> Any:
        # CoBFS [4] conditional transfer: ship the value only when newer
        # than the client's tag (tag-only reply otherwise).
        _, obj, idx, client_tag = msg
        tag, val = self._abd_state((obj, idx))
        if client_tag is not None and tag <= client_tag:
            return ("abd-val", tag, None)
        return ("abd-val", tag, val)

    def _h_abd_get_tag(self, sender: str, msg: tuple) -> Any:
        _, obj, idx = msg
        tag, _ = self._abd_state((obj, idx))
        return ("abd-tag", tag)

    def _h_abd_put(self, sender: str, msg: tuple) -> Any:
        _, obj, idx, tag, val = msg
        cur, _ = self._abd_state((obj, idx))
        if tag > cur:
            self.abd[(obj, idx)] = (tag, val)
        return ("ack",)

    def _h_ec_query(self, sender: str, msg: tuple) -> Any:
        # Alg 5:4-11. client_tag None => original EC-DAP (full List);
        # otherwise EC-DAPopt filtering: (> tag_b -> with element,
        # == tag_b -> (tag, ⊥), < tag_b -> omitted).
        _, obj, idx, client_tag = msg
        lst = self._ec_list((obj, idx))
        if client_tag is None:
            out = tuple(lst.items())
        else:
            acc = []
            for t, e in lst.items():
                if t > client_tag:
                    acc.append((t, e))
                elif t == client_tag:
                    acc.append((t, None))
            out = tuple(acc)
        return ("ec-list", out)

    def _h_ec_put(self, sender: str, msg: tuple) -> Any:
        # Alg 5:12-18: insert, then trim the *coded value* of the minimum
        # tag when |List| > δ+1 (the (τ_min, ⊥) placeholder remains).
        _, obj, idx, tag, elem, delta = msg
        lst = self._ec_list((obj, idx))
        lst[tag] = elem
        self._trim_list(lst, delta)
        return ("ack",)

    def _h_ec_repair_pull(self, sender: str, msg: tuple) -> Any:
        # Repair scan (beyond-paper, ISSUE 1): full List snapshot — every
        # tag this server knows, with its coded element where one is still
        # held (None = trimmed ⊥ / placeholder). Unlike ec-query this
        # never filters by a client tag: the repair controller needs to
        # see exactly what is missing or stale.
        _, obj, idx = msg
        lst = self._ec_list((obj, idx))
        return ("ec-repair-list", [(t, e) for t, e in lst.items()])

    def _h_ec_repair_push(self, sender: str, msg: tuple) -> Any:
        # Monotone repair insert: only ADDS a coded element for a tag this
        # server has never seen. It never resurrects a trimmed (tag, ⊥)
        # placeholder (the server already moved past that tag), and
        # re-applies the δ+1 trim so the List bound holds. The one
        # overwrite allowed (ISSUE 6) is an element whose bytes FAIL
        # their own stored checksum — bit-rot on this server; the pushed
        # replacement is the bit-identical coded row the writer would
        # have stored (MDS determinism), so healing is a pure restore.
        # A racing ec-put therefore can never be regressed by repair
        # traffic: newer tags stay, and a pushed tag older than the trim
        # window is trimmed right back out.
        _, obj, idx, tag, elem, delta = msg
        lst = self._ec_list((obj, idx))
        applied = False
        if tag not in lst:
            lst[tag] = elem
            applied = True
            self._trim_list(lst, delta)
        elif lst[tag] is not None and not element_crc_ok(lst[tag]):
            lst[tag] = elem
            applied = True
        return ("repair-ack", applied)

    def _h_read_next(self, sender: str, msg: tuple) -> Any:
        _, obj, idx = msg
        return ("next-c", self.next_c.get((obj, idx)))

    def _h_write_next(self, sender: str, msg: tuple) -> Any:
        # F overrides P; P never demotes F. Config value is unique per
        # index (consensus), so overwriting the config is idempotent.
        _, obj, idx, cfg, status = msg
        cur = self.next_c.get((obj, idx))
        if cur is None or (cur[1] == "P" and status == "F") or status == "F":
            self.next_c[(obj, idx)] = (cfg, status)
        return ("ack",)

    def _h_cons_p1(self, sender: str, msg: tuple) -> Any:
        _, obj, idx, ballot = msg
        st = self.cons.setdefault((obj, idx), [None, None, None])
        if st[0] is None or ballot > st[0]:
            st[0] = ballot
            return ("p1-ok", st[1], st[2])
        return ("p1-nack", st[0])

    def _h_cons_p2(self, sender: str, msg: tuple) -> Any:
        _, obj, idx, ballot, value = msg
        st = self.cons.setdefault((obj, idx), [None, None, None])
        if st[0] is None or ballot >= st[0]:
            st[0] = ballot
            st[1] = ballot
            st[2] = value
            return ("p2-ok",)
        return ("p2-nack", st[0])

    # requests answerable from the reply cache: they read server state but
    # never change it (lazy state creation inside counts as a mutation and
    # evicts through _invalidate, like every real mutation). Each entry maps
    # the op tag to an extractor of the object names the request reads, so
    # cached answers are indexed — and evicted — per object.
    _READ_ONLY = {
        "ec-query-batch": lambda m: (o for o, _t in m[1]),
        "abd-get-batch": lambda m: (o for o, _t in m[1]),
        "read-next-batch": lambda m: (o for o, _i in m[1]),
        "margin-batch": lambda m: m[1],
        "ec-query": lambda m: (m[1],),
        "abd-get": lambda m: (m[1],),
        "abd-get-tag": lambda m: (m[1],),
        "read-next": lambda m: (m[1],),
        "ec-repair-pull": lambda m: (m[1],),
    }

    _DISPATCH = {
        "ec-query-batch": _h_ec_query_batch,
        "ec-put-batch": _h_ec_put_batch,
        "abd-get-batch": _h_abd_get_batch,
        "abd-put-batch": _h_abd_put_batch,
        "read-next-batch": _h_read_next_batch,
        "write-next-batch": _h_write_next_batch,
        "cons-p1-batch": _h_cons_p1_batch,
        "cons-p2-batch": _h_cons_p2_batch,
        "margin-batch": _h_margin_batch,
        "abd-get": _h_abd_get,
        "abd-get-tag": _h_abd_get_tag,
        "abd-put": _h_abd_put,
        "ec-query": _h_ec_query,
        "ec-put": _h_ec_put,
        "ec-repair-pull": _h_ec_repair_pull,
        "ec-repair-push": _h_ec_repair_push,
        "read-next": _h_read_next,
        "write-next": _h_write_next,
        "cons-p1": _h_cons_p1,
        "cons-p2": _h_cons_p2,
    }
