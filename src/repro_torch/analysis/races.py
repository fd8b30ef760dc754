"""Vector-clock happens-before race tracker for the protocol sim (ISSUE 9).

The PR-7 sanitizer checks what servers *say* (reply monotonicity); this
module checks what servers *do*: every in-handle mutation of per-object
server state — observed through the tracked ``_StateMap``/``_ObjState``
maps' invalidation hook (``StorageServer._race_observer``) — is attributed
to the operation whose message is being handled and ordered against the
operation that last wrote that ``(server, object)``.

Happens-before is tracked with vector clocks indexed by **operation id**
(deliberately no per-server component: the server's serialization order is
exactly what a schedule explorer perturbs, so it must not be allowed to
order the clocks by itself):

* each RPC round an operation issues ticks its own clock component and
  snapshots the clock into the round (``on_issue``);
* handling an arrival joins that snapshot into the server's knowledge
  (``before_handle``);
* a *counted* reply delivery joins the server's knowledge back into the
  operation's clock (``on_reply``) — the only inter-operation edges, which
  is exactly the quorum protocol's real communication structure.

What is *checked* is not raw access overlap — quorum protocols see
concurrent same-object traffic constantly and that is fine — but the
monotone **semantic summary** of the object's state on that server: the
ABD tag, the EC List's maximum tag, and the next-config status. A handler
whose mutations make any of those regress has lost a write; the vector
clocks then classify the witness pair as an *ordered* regression (plain
bug) or an *unordered race* (two concurrent ops whose effects do not
commute), and the run fails with :class:`RaceError`. Mutations outside
``handle`` are deliberate fault injection and are forgiven, mirroring the
sanitizer's ``forget``.

Like the sanitizer the tracker is a pure observer: it draws no randomness
and schedules nothing. Enable with ``DSSParams.racecheck=True`` /
``REPRO_RACECHECK=1``, or attach directly; the schedule explorer
(:mod:`repro_torch.analysis.explore`) turns it on for every explored schedule.
(The plain-dict Paxos acceptor state ``StorageServer.cons`` has no
mutation hook and is covered only by the sanitizer's ballot checks.)
"""
from __future__ import annotations

from typing import Any

from repro_torch.analysis.sanitizer import SanitizerError

Clock = dict[int, int]


class RaceError(SanitizerError):
    """Conflicting (unordered or order-violating) state mutation detected."""


def _join(dst: Clock, src: Clock) -> None:
    for k, v in src.items():
        if dst.get(k, -1) < v:
            dst[k] = v


class RaceTracker:
    """Happens-before observer for live ``Network`` traffic; raises
    :class:`RaceError` on the first non-monotone in-handle mutation. See
    the module docstring."""

    def __init__(self) -> None:
        self.net: Any = None
        # op_id -> vector clock {op_id: tick}
        self._vc: dict[int, Clock] = {}
        # RPC round (identity-keyed _RpcState) -> issue-time clock snapshot
        self._issue: dict[Any, Clock] = {}
        # sid -> joined knowledge of every snapshot this server handled
        self._know: dict[str, Clock] = {}
        # sid -> (op_id, issue snapshot) of the arrival being handled
        self._cur: dict[str, tuple[int, Clock]] = {}
        # sid -> objects mutated during the current handle (checked after
        # the handler returns — the tracked maps fire BEFORE the write
        # lands, so summaries must be read post-handle)
        self._pending: dict[str, list[Any]] = {}
        # (sid, obj) -> monotone semantic summary of the object's state
        self._base: dict[tuple[str, Any], dict[tuple[str, Any], Any]] = {}
        # (sid, obj) -> (op_id, issue tick, issue snapshot) of last writer
        self._wlast: dict[tuple[str, Any], tuple[int, int, Clock]] = {}
        self.mutations = 0           # in-handle mutation events observed
        self.checks = 0              # post-handle summary checks
        self.forgets = 0             # external-surgery resets
        self.concurrent_writes = 0   # benign unordered write-after-write
        self.unattributed = 0        # mutations outside a sim handle bracket

    # ------------------------------------------------------------ wiring
    def attach(self, net: Any) -> "RaceTracker":
        """Install on a Network: hook the issue/handle/reply observation
        points and the mutation observer of every (current and future)
        server."""
        net.race_tracker = self
        self.net = net
        for srv in net.servers.values():
            if hasattr(srv, "_race_observer"):
                srv._race_observer = self.on_mutation
        return self

    # ------------------------------------------------------- sim hook points
    def on_issue(self, state: Any, rpc: Any) -> None:
        """An operation issued an RPC round: tick its clock and snapshot it
        into the round (``state`` is the round's ``_RpcState``)."""
        op = int(state.fut.op_id)
        vc = self._vc.get(op)
        if vc is None:
            vc = self._vc[op] = {op: 0}
        vc[op] += 1
        self._issue[state] = dict(vc)

    def before_handle(self, sid: str, state: Any) -> None:
        """An arrival of ``state``'s round is about to be handled by
        ``sid``: the server learns the round's issue-time snapshot."""
        snap = self._issue.get(state)
        if snap is None:  # round issued before the tracker attached
            snap = {}
        know = self._know.get(sid)
        if know is None:
            know = self._know[sid] = {}
        _join(know, snap)
        self._cur[sid] = (int(state.fut.op_id), snap)
        pend = self._pending.get(sid)
        if pend:
            # mutations recorded outside a bracket (direct handle() calls
            # in tests): check them now, unattributed
            self._flush(sid, None)

    def after_handle(self, sid: str) -> None:
        """The handler returned: check every object it mutated against the
        monotone summary baseline, attributing to the handled op."""
        ctx = self._cur.pop(sid, None)
        if self._pending.get(sid):
            self._flush(sid, ctx)

    def on_reply(self, sid: str, state: Any) -> None:
        """A *counted* reply delivery: the issuing operation learns the
        server's knowledge — the only edges that order distinct ops."""
        op = int(state.fut.op_id)
        vc = self._vc.get(op)
        if vc is None:
            vc = self._vc[op] = {op: 0}
        know = self._know.get(sid)
        if know:
            _join(vc, know)

    def on_mutation(self, sid: str, obj: Any, in_handle: bool) -> None:
        """``StorageServer._race_observer``: per-object state on ``sid``
        is being mutated. In-handle mutations queue for the post-handle
        summary check; out-of-handle ones are external surgery — forgiven,
        like the sanitizer's ``forget``."""
        if not in_handle:
            if self._base.pop((sid, obj), None) is not None:
                self.forgets += 1
            self._wlast.pop((sid, obj), None)
            return
        self.mutations += 1
        pend = self._pending.get(sid)
        if pend is None:
            pend = self._pending[sid] = []
        pend.append(obj)

    # ------------------------------------------------------------ checking
    def _summary(self, sid: str, obj: Any) -> dict[tuple[str, Any], Any]:
        """Monotone semantic summary of ``obj``'s state on ``sid``: per
        config index, the ABD tag, the EC List max tag, and the successor-
        config status. Healthy handlers only ever move these forward."""
        srv = self.net.servers[sid]
        out: dict[tuple[str, Any], Any] = {}
        for (o, idx), (tag, _val) in srv.abd.items():
            if o == obj:
                out[("abd", idx)] = tag
        for (o, idx), lst in srv.ec.items():
            if o == obj and lst:
                out[("ec", idx)] = max(lst)
        for (o, idx), ent in srv.next_c.items():
            if o == obj and ent is not None:
                # F=1 > P=0; the config itself must stay fixed once F
                cfg, status = ent
                cid = getattr(cfg, "cfg_id", cfg)
                out[("next", idx)] = (1 if status == "F" else 0, cid)
        return out

    def _flush(self, sid: str, ctx: tuple[int, Clock] | None) -> None:
        objs = self._pending.get(sid)
        if not objs:
            return
        self._pending[sid] = []
        for obj in dict.fromkeys(objs):
            self._check(sid, obj, ctx)

    def _check(self, sid: str, obj: Any, ctx: tuple[int, Clock] | None) -> None:
        self.checks += 1
        key = (sid, obj)
        new = self._summary(sid, obj)
        base = self._base.get(key)
        if base is not None:
            for k, old in base.items():
                cur = new.get(k)
                if k[0] == "next":
                    regressed = cur is None or cur[0] < old[0] or (
                        old[0] == 1 and cur[0] == 1 and cur[1] != old[1]
                    )
                else:
                    regressed = cur is None or cur < old
                if regressed:
                    self._raise(sid, obj, k, old, cur, ctx)
        last = self._wlast.get(key)
        if ctx is not None:
            op, snap = ctx
            if last is not None and last[0] != op:
                # unordered with the previous writer? (its issue event is
                # not in our snapshot) — benign while summaries stay
                # monotone, but worth counting: these are the real
                # concurrent write-write interleavings explored
                if snap.get(last[0], -1) < last[1]:
                    self.concurrent_writes += 1
            self._wlast[key] = (op, snap.get(op, 0), snap)
        else:
            self.unattributed += 1
        self._base[key] = new

    def _raise(
        self,
        sid: str,
        obj: Any,
        k: tuple[str, Any],
        old: Any,
        cur: Any,
        ctx: tuple[int, Clock] | None,
    ) -> None:
        last = self._wlast.get((sid, obj))
        if ctx is None:
            who = "an unattributed handler"
            rel = "unknown ordering"
        else:
            op, snap = ctx
            who = f"op {op}"
            if last is None:
                rel = "no prior writer tracked"
            elif snap.get(last[0], -1) >= last[1]:
                rel = (
                    f"ordered AFTER the writing op {last[0]} (happens-"
                    "before established): plain lost-update bug"
                )
            else:
                rel = (
                    f"UNORDERED with the writing op {last[0]} (no happens-"
                    "before path): write-write race"
                )
        raise RaceError(
            f"server {sid}: handling {who} regressed {k[0]} state of "
            f"{obj!r}@cfg{k[1]} from {old!r} to {cur!r}; {rel}"
        )

    # ------------------------------------------------------------- report
    def report(self) -> dict[str, int]:
        return {
            "mutations": self.mutations,
            "checks": self.checks,
            "forgets": self.forgets,
            "concurrent_writes": self.concurrent_writes,
            "unattributed": self.unattributed,
            "tracked": len(self._base),
            "ops": len(self._vc),
        }
