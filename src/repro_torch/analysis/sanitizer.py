"""Runtime protocol sanitizer: live quorum/tag/vocabulary checks (ISSUE 8).

:class:`ProtocolSanitizer` attaches to a :class:`repro_torch.net.sim.Network`
(``DSSParams.sanitize=True`` or ``REPRO_SANITIZE=1``) and observes three
points the engine already passes through — it never draws randomness, never
schedules events, and never mutates protocol state, so a sanitized run
replays the *same* virtual-time trace as an unsanitized one:

* **every RPC fan-out** (``Network._run_rpc``): the quorum-intersection
  check. Any two quorums of one configuration must intersect — for
  majority-quorum ops that means ``need >= floor(B/2)+1`` over the ``B``
  destinations, and for EC data ops ``need >= ceil((n+k)/2)`` (the paper's
  §VII-A quorum). ``k`` is learned per server-set from every ``Config``
  that flows past (genesis, ``make_config``, decided recon values, gossip);
  when a server set is unknown the majority floor still applies. Ops
  addressed to *whoever is alive* (``need="alive"``: repair pulls, health
  probes, gossip) are reads of best-effort state, not quorum rounds, and
  are skipped.

* **every reply** (both fan-out engines, including replies arriving after
  the quorum resumed): per-``(server, object, index)`` tag monotonicity.
  A server's ABD tag and EC List maximum only ever grow (the List trims
  *values*, never tag keys), a finalized next-config announcement never
  regresses to proposed/none and never changes its config, and a Paxos
  acceptor's nack ballot never shrinks. Reply and request tags must come
  from the codec registries (``MESSAGE_TYPES``/``REPLY_TYPES``/gossip) —
  the live half of the registry-drift lint.

* **external state surgery** (``StorageServer._invalidate`` → the
  ``_mut_observer`` hook): tests and fault-injection harnesses mutate
  server state directly (deleting fragments, wiping disks, rotting bytes).
  Those writes go through the PR-6 tracked ``_StateMap``/``_ObjState``
  maps, which already fire per-object invalidation — outside ``handle``
  the sanitizer treats that as "this (server, object) legitimately lost
  state" and forgets its high-water marks, so deliberate fault injection
  is not reported as a protocol bug. A *buggy server* that loses state
  without going through its own tracked maps (or a seeded
  ``dict.__setitem__`` bypass in the sanitizer's own tests) IS caught.

Violations raise :class:`SanitizerError` immediately, failing the run at
the first bad fan-out/reply. Post-hoc history checking (Wing–Gong tag
order) lives in :mod:`repro_torch.analysis.linearize`; ``DSS.check_history`` and
the workload harness call it after a sanitized run.
"""
from __future__ import annotations

from typing import Any

from repro_torch.net.codec import (
    GOSSIP_REPLY_TYPES,
    GOSSIP_TYPES,
    MESSAGE_TYPES,
    REPLY_TYPES,
)


class SanitizerError(RuntimeError):
    """A protocol invariant was violated on live traffic."""


# ops whose fan-out must reach a majority of its destinations (any two
# majorities intersect; read-next/write-next/consensus use cfg.majority(),
# ABD data ops use the ABD quorum == majority)
_MAJORITY_OPS = frozenset({
    "abd-get", "abd-get-tag", "abd-put", "abd-get-batch", "abd-put-batch",
    "read-next", "write-next", "read-next-batch", "write-next-batch",
    "cons-p1", "cons-p2", "cons-p1-batch", "cons-p2-batch",
})
# EC data ops additionally need the §VII-A quorum ceil((n+k)/2) — checked
# when k is known for the destination server-set
_EC_DATA_OPS = frozenset({
    "ec-query", "ec-put", "ec-query-batch", "ec-put-batch",
})

_KNOWN_TAGS = MESSAGE_TYPES | GOSSIP_TYPES
_KNOWN_REPLIES = REPLY_TYPES | GOSSIP_REPLY_TYPES


def _max_tag(entries: Any) -> Any:
    """Max tag of an ``ec-list``-shaped ``((tag, elem), ...)``; None when
    empty (a filtered reply that shipped nothing proves no maximum)."""
    best = None
    for t, _e in entries:
        if best is None or t > best:
            best = t
    return best


class ProtocolSanitizer:
    """Observer for live ``Network`` traffic; raises :class:`SanitizerError`
    on the first violated invariant. See the module docstring."""

    def __init__(self) -> None:
        # EC parameter registry: frozenset(servers) -> smallest k seen.
        # Smallest k => smallest legal quorum, so an ambiguous server set
        # (two configs, same servers, different k) stays conservative:
        # a fan-out legal under EITHER config passes.
        self.known_k: dict[frozenset[str], int] = {}
        # (sid, obj) -> {("abd", idx): tag, ("ec", idx): tag,
        #                ("next", idx): (cfg_id, status),
        #                ("ballot", idx): ballot}
        self._hw: dict[tuple[str, Any], dict[Any, Any]] = {}
        self.checks = 0       # fan-outs + replies inspected
        self.forgets = 0      # external-mutation resets observed

    # ------------------------------------------------------------ wiring
    def attach(self, net: Any) -> "ProtocolSanitizer":
        """Install on a Network: hook the RPC/reply observation points and
        the external-mutation observer of every (current and future)
        server."""
        net.sanitizer = self
        for srv in net.servers.values():
            if hasattr(srv, "_mut_observer"):
                srv._mut_observer = self.forget
        return self

    def register_config(self, cfg: Any) -> None:
        """Learn a configuration's EC parameters (idempotent; non-EC and
        malformed values are ignored — the sanitizer only ever *observes*)."""
        servers = getattr(cfg, "servers", None)
        if not servers or getattr(cfg, "dap", "abd") not in ("ec", "ec_opt"):
            return
        key = frozenset(servers)
        k = int(cfg.k)
        cur = self.known_k.get(key)
        if cur is None or k < cur:
            self.known_k[key] = k

    def forget(self, sid: str, obj: Any) -> None:
        """External-mutation observer (``StorageServer._mut_observer``):
        state of ``obj`` on ``sid`` changed outside ``handle`` — fault
        injection, wipes — so its high-water marks no longer bind."""
        if self._hw.pop((sid, obj), None) is not None:
            self.forgets += 1

    # ------------------------------------------------------------ fan-out
    def on_rpc(self, rpc: Any, need: int | None) -> None:
        """Quorum-intersection check at issue time. ``need`` is the resolved
        numeric requirement (post ``min(need, len(dests))`` clamp); alive-
        mode fan-outs pass ``None`` and are skipped."""
        self.checks += 1
        msg = rpc.msg
        if msg is None and rpc.per_dest:
            msg = next(iter(rpc.per_dest.values()))
        if not (isinstance(msg, tuple) and msg and isinstance(msg[0], str)):
            return  # outside the protocol vocabulary (e.g. toy test servers)
        op = msg[0]
        if op not in _KNOWN_TAGS:
            raise SanitizerError(
                f"unknown message type {op!r} on the wire — handler/codec "
                "registry drift (see net/codec.py MESSAGE_TYPES)"
            )
        if need is None:
            return  # "alive"-addressed: not a quorum round
        B = len(rpc.dests)
        if B == 0:
            return
        if op in _MAJORITY_OPS or op in _EC_DATA_OPS:
            majority = B // 2 + 1
            if need < majority:
                raise SanitizerError(
                    f"{op} fan-out to {B} servers waits for only {need} "
                    f"replies < majority {majority}: two such quorums need "
                    "not intersect"
                )
        if op in _EC_DATA_OPS:
            k = self.known_k.get(frozenset(rpc.dests))
            if k is not None:
                q = -((B + k) // -2)  # ceil((n + k) / 2)
                if need < q:
                    raise SanitizerError(
                        f"{op} fan-out to n={B} servers (k={k}) waits for "
                        f"only {need} replies < EC quorum ceil((n+k)/2)="
                        f"{q}: two quorums need not intersect in k servers"
                    )

    # ------------------------------------------------------------- replies
    def on_reply(self, sid: str, msg: Any, reply: Any) -> None:
        """Per-reply monotonicity checks (called for EVERY processed
        arrival, including replies past the quorum)."""
        self.checks += 1
        if not (isinstance(reply, tuple) and reply
                and isinstance(reply[0], str)):
            return
        tag = reply[0]
        if tag not in _KNOWN_REPLIES:
            raise SanitizerError(
                f"unknown reply type {tag!r} from {sid} — handler/codec "
                "registry drift (see net/codec.py REPLY_TYPES)"
            )
        if not (isinstance(msg, tuple) and msg):
            return
        op = msg[0]
        if op == "abd-get" or op == "abd-get-tag":
            # ("abd-val", tag, val) / ("abd-tag", tag): the server's current
            # tag rides every reply, even conditional-transfer ones
            self._tag_floor(sid, msg[1], "abd", msg[2], reply[1])
        elif op == "abd-get-batch":
            # ("abd-val-batch", ((tag, val), ...)) in item order
            idx = msg[2]
            for (obj, _ctag), (t, _v) in zip(msg[1], reply[1]):
                self._tag_floor(sid, obj, "abd", idx, t)
        elif op == "abd-put":
            # ("ack",): the server now stores at least this tag
            self._raise_floor(sid, msg[1], "abd", msg[2], msg[3])
        elif op == "abd-put-batch":
            idx = msg[2]
            for obj, t, _v in msg[1]:
                self._raise_floor(sid, obj, "abd", idx, t)
        elif op == "ec-query":
            # ("ec-list", ((tag, elem), ...)): a non-empty (or unfiltered)
            # List reply reports the server's true max tag — trims keep tag
            # keys, and the DAPopt filter only hides tags below the client's
            obs = _max_tag(reply[1])
            if obs is not None:
                self._tag_floor(sid, msg[1], "ec", msg[2], obs)
        elif op == "ec-query-batch":
            idx = msg[2]
            for (obj, _ctag), entries in zip(msg[1], reply[1]):
                obs = _max_tag(entries)
                if obs is not None:
                    self._tag_floor(sid, obj, "ec", idx, obs)
        elif op == "ec-put":
            self._raise_floor(sid, msg[1], "ec", msg[2], msg[3])
        elif op == "ec-put-batch":
            idx = msg[2]
            for obj, t, _e in msg[1]:
                self._raise_floor(sid, obj, "ec", idx, t)
        elif op == "ec-repair-pull":
            # full snapshot — same floor logic as an unfiltered query
            obs = _max_tag(reply[1])
            if obs is not None:
                self._tag_floor(sid, msg[1], "ec", msg[2], obs)
        elif op == "margin-batch":
            idx = msg[2]
            for obj, (abd_tag, ec_items, _status) in zip(msg[1], reply[1]):
                if abd_tag is not None:
                    self._tag_floor(sid, obj, "abd", idx, abd_tag)
                if ec_items:
                    self._tag_floor(
                        sid, obj, "ec", idx,
                        max(t for t, _holds in ec_items),
                    )
        elif op == "read-next":
            self._next_c(sid, msg[1], msg[2], reply[1])
        elif op == "read-next-batch":
            for (obj, idx), ent in zip(msg[1], reply[1]):
                self._next_c(sid, obj, idx, ent)
        elif op == "write-next":
            self._next_c(sid, msg[1], msg[2], (msg[3], msg[4]), announced=True)
        elif op == "write-next-batch":
            for obj, idx, cfg, status in msg[1]:
                self._next_c(sid, obj, idx, (cfg, status), announced=True)
        elif op == "cons-p1" or op == "cons-p2":
            self._ballot(sid, msg[1], msg[2], reply)
        elif op == "cons-p1-batch":
            idx, objs = msg[2], msg[1]
            for obj, r in zip(objs, reply[1]):
                self._ballot(sid, obj, idx, r)
        elif op == "cons-p2-batch":
            idx = msg[2]
            for (obj, _val), r in zip(msg[1], reply[1]):
                self._ballot(sid, obj, idx, r)

    # ------------------------------------------------------- state tracking
    def _rec(self, sid: str, obj: Any) -> dict[Any, Any]:
        rec = self._hw.get((sid, obj))
        if rec is None:
            rec = self._hw[(sid, obj)] = {}
        return rec

    def _tag_floor(self, sid: str, obj: Any, kind: str, idx: Any, observed: Any) -> None:
        """Observed tag must not regress below the high-water; then raises
        the high-water to it."""
        rec = self._rec(sid, obj)
        key = (kind, idx)
        hw = rec.get(key)
        if hw is not None and observed < hw:
            raise SanitizerError(
                f"server {sid} reported {kind} tag {observed} for "
                f"{obj!r}@cfg{idx} after previously proving tag {hw}: "
                "per-server tag monotonicity violated"
            )
        if hw is None or observed > hw:
            rec[key] = observed

    def _raise_floor(self, sid: str, obj: Any, kind: str, idx: Any, tag: Any) -> None:
        """An acked put: the server stores >= tag from now on (no check —
        acks never reveal a regression, they only raise the floor)."""
        rec = self._rec(sid, obj)
        key = (kind, idx)
        hw = rec.get(key)
        if hw is None or tag > hw:
            rec[key] = tag

    def _next_c(self, sid: str, obj: Any, idx: Any, entry: Any, announced: bool = False) -> None:
        """Successor-config stickiness: once a server proves ⟨c, F⟩ at an
        index, later observations must stay exactly ⟨c, F⟩ (consensus makes
        the config unique; F never demotes). ``announced=True`` records an
        acked write-next without reading the reply (acks carry no state)."""
        if entry is None:
            cfg_id, status = None, None
        else:
            cfg, status = entry
            cfg_id = getattr(cfg, "cfg_id", cfg)
        rec = self._rec(sid, obj)
        key = ("next", idx)
        hw = rec.get(key)
        if hw is not None and hw[1] == "F":
            if not announced and (status != "F" or cfg_id != hw[0]):
                raise SanitizerError(
                    f"server {sid} reported next-config {entry!r} for "
                    f"{obj!r}@cfg{idx} after finalizing "
                    f"⟨{hw[0]}, F⟩: finalized successor regressed"
                )
            if announced and status == "F" and cfg_id != hw[0]:
                raise SanitizerError(
                    f"two different configs finalized at {obj!r}@cfg{idx} "
                    f"on {sid}: {hw[0]} then {cfg_id} (consensus uniqueness "
                    "violated)"
                )
            return
        if status is not None and (hw is None or status == "F"):
            rec[key] = (cfg_id, status)
        if entry is not None:
            self.register_config(entry[0])

    def _ballot(self, sid: str, obj: Any, idx: Any, r: Any) -> None:
        """Acceptor promise monotonicity: the ballot a nack reports is the
        server's current promise, which only ever grows."""
        if not (isinstance(r, tuple) and r and r[0] in ("p1-nack", "p2-nack")):
            return
        ballot = r[1]
        rec = self._rec(sid, obj)
        key = ("ballot", idx)
        hw = rec.get(key)
        if hw is not None and ballot < hw:
            raise SanitizerError(
                f"server {sid} nacked {obj!r}@cfg{idx} with ballot "
                f"{ballot} after promising {hw}: acceptor promise regressed"
            )
        if hw is None or ballot > hw:
            rec[key] = ballot

    # ------------------------------------------------------------- report
    def report(self) -> dict[str, int]:
        return {
            "checks": self.checks,
            "forgets": self.forgets,
            "tracked": len(self._hw),
            "known_server_sets": len(self.known_k),
        }
