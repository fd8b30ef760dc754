"""Systematic schedule exploration over the protocol sim (ISSUE 9).

The PR-7 analyzer only ever observes the single schedule a fixed seed
produces; ARES's safety argument is about *all* interleavings. This module
adds the missing half, in the CHESS/dPOR tradition:

* :class:`ScheduleController` — hooks ``Network``'s event heap (both the
  ``_FanOut`` cursor path and the legacy per-destination path) and turns
  "which near-simultaneous pending event fires next" into an explicit,
  replayable decision, with crash/recover and message drops as additional
  schedulable choices (drawn from no RNG stream). A controller running the
  default ``fifo`` policy with no plan replays the exact uncontrolled
  trace — pinned by ``tests/test_explore.py``.

* :func:`explore` — bounded exhaustive DFS over decision prefixes with
  sleep-set-style (DPOR-lite) pruning on tiny configs, and seeded
  PCT / random-walk priority schedules for larger ones. Every explored
  schedule runs with the runtime sanitizer AND the vector-clock race
  tracker (:mod:`repro_torch.analysis.races`) attached, and closes with the
  Wing–Gong history check.

* repro bundles — any violating schedule serializes to JSON under
  ``runs/schedules/`` with the full ``(seed, params, engine, decisions)``
  stamp; ``python -m repro_torch.analysis.explore --replay …``
  (:func:`replay_bundle`) re-executes it
  byte-identically and verifies the same violation at the same trace
  fingerprint.

The pruning is the classic independence argument: an alternative "run
event *e* now instead" is skipped when *e* was executed later in the
observed schedule and every step between commutes with it (disjoint
server/endpoint, no RNG draw) — the reordering reaches the same state, so
the child schedule is Mazurkiewicz-equivalent to the one already run.
``--no-prune`` disables it for a ground-truth sweep.

Test-only fault hooks (positive controls, satellite of ISSUE 9):

* ``early-read-resume`` — ops whose kind starts with ``race:`` wait for
  one reply fewer than they asked for. The PR-7 static ``on_rpc`` check
  cannot see it (the honest need is checked at issue; the client resumes
  early), and most schedules still read fresh data — only the narrow
  interleaving where a lagging server answers first returns a stale read,
  which the Wing–Gong pass flags. The explorer must find it.
* ``ack-rollback`` — a server acks an ``abd-put``, but if that ack is
  dropped in flight it rolls the put back *bypassing its tracked maps*
  (so nothing forgives the regression). Found via a dropped-ack schedule
  plus the sanitizer's reply-monotonicity floor.
* ``unguarded-put`` — drops the ``tag > cur`` guard on ``abd-put``: two
  concurrent writers' puts landing out of tag order regress the register,
  which the race tracker reports as an UNORDERED write-write race.
* ``retry-dup-write`` (ISSUE 10) — applies a *retransmitted* ``abd-put``
  blindly instead of suppressing the duplicate: with the retry machinery
  armed, a crash plus a dropped ack force a retransmission whose replay
  can land after a rival's newer tag and regress the register. The real
  servers' ``tag > cur`` guard is exactly the suppression this control
  removes.
"""
from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import os
import random
from dataclasses import asdict, dataclass, field as dc_field
from typing import Any, Callable, Generator, Iterable

from repro_torch.analysis.sanitizer import SanitizerError

Action = tuple[Any, ...]          # ("ev", seq) | ("drop", seq) | ("crash", sid) | ("recover", sid)
Key = tuple[str, Any, str]        # (kind, server-or-None, client-endpoint)

_DROPPABLE = ("srv", "rpl")       # event kinds a controller may lose in flight


class ScheduleDivergence(RuntimeError):
    """A replayed plan no longer matches the schedule's decision points."""


def conflicts(k1: Key | None, k2: Key | None) -> bool:
    """May these two events' effects fail to commute? Conservative: unkeyed
    events and RNG-drawing fan-out sends conflict with everything; otherwise
    events conflict when they touch the same server or the same client
    endpoint (state, NIC rows, op bookkeeping)."""
    if k1 is None or k2 is None:
        return True
    if k1[0] == "snd" or k2[0] == "snd":
        return True
    if k1[1] is not None and k1[1] == k2[1]:
        return True
    return bool(k1[2] == k2[2])


class ScheduleController:
    """Event-loop pop policy for ``Network.controller`` (see net/sim.py).

    Each step it computes the *ready set* — the ``width`` earliest pending
    events within ``horizon`` virtual seconds of the earliest one — plus
    any budgeted crash/recover/drop choices; more than one candidate makes
    a decision point. Decisions are taken from ``plan`` while it lasts
    (replay), then from ``policy``:

    * ``fifo`` — always the earliest ``(t, seq)``: the uncontrolled trace.
    * ``random`` — seeded uniform walk (occasional injection when budgeted).
    * ``pct`` — seeded priorities per endpoint key with ``pct_changes``
      demotion points, à la probabilistic concurrency testing.

    The executed decision log (``decisions``) and full step trace
    (``trace``) are what the explorer branches on and what bundles record.
    """

    def __init__(
        self,
        plan: Iterable[Action] = (),
        policy: str = "fifo",
        seed: int = 0,
        width: int = 4,
        horizon: float = 1.0e-3,
        crash_budget: int = 0,
        drop_budget: int = 0,
        crashable: tuple[str, ...] = (),
        pct_changes: int = 3,
    ) -> None:
        self.plan: list[Action] = [tuple(a) for a in plan]
        self.pos = 0
        self.policy = policy
        self.width = width
        self.horizon = horizon
        self.crash_budget = crash_budget
        self.recover_budget = crash_budget
        self.drop_budget = drop_budget
        self.crashable = tuple(crashable)
        self.keys: dict[int, Key | None] = {}
        # decision log: {"actions": [...], "chosen": ..., "at": trace index}
        self.decisions: list[dict[str, Any]] = []
        # every executed step: ("ev"|"drop", seq, key) | ("crash"|"recover", sid, None)
        self.trace: list[tuple[str, Any, Key | None]] = []
        self.injections = 0
        self.steps = 0
        self._drop_pending = False
        self._rng = random.Random(seed)
        self._prio: dict[Any, float] = {}
        self._pct_left = pct_changes
        # optional fault-hook callback for dropped replies
        self.on_reply_dropped: Callable[[str, Any], None] | None = None

    # ---------------------------------------------------- Network-facing API
    def note(self, seq: int, key: Key | None) -> None:
        """``Network.schedule`` reports every scheduled event's key here."""
        self.keys[seq] = key

    def consume_drop(self) -> bool:
        """True exactly once for the event the controller chose to drop."""
        if self._drop_pending:
            self._drop_pending = False
            return True
        return False

    def reply_dropped(self, sid: str, reply: Any) -> None:
        cb = self.on_reply_dropped
        if cb is not None:
            cb(sid, reply)

    def step(self, net: Any) -> bool:
        events = net._events
        if not events:
            return False
        ready = self._ready(events)
        actions = self._actions(net, ready)
        if len(actions) > 1:
            chosen = self._choose(actions, ready)
            self.decisions.append(
                {"actions": actions, "chosen": chosen, "at": len(self.trace)}
            )
        else:
            chosen = actions[0]
        return self._apply(net, chosen, ready)

    # ------------------------------------------------------------- internals
    def _ready(self, events: list) -> list:
        w = self.width if self.width < len(events) else len(events)
        smallest = heapq.nsmallest(w, events)
        lim = smallest[0][0] + self.horizon
        return [e for e in smallest if e[0] <= lim]

    def _actions(self, net: Any, ready: list) -> list[Action]:
        acts: list[Action] = [("ev", e[1]) for e in ready]
        if self.drop_budget > 0:
            for e in ready:
                k = self.keys.get(e[1])
                if k is not None and k[0] in _DROPPABLE:
                    acts.append(("drop", e[1]))
        if self.crash_budget > 0:
            for sid in self.crashable:
                srv = net.servers.get(sid)
                if srv is not None and not srv.crashed:
                    acts.append(("crash", sid))
        if self.recover_budget > 0:
            for sid in self.crashable:
                srv = net.servers.get(sid)
                if srv is not None and srv.crashed:
                    acts.append(("recover", sid))
        return acts

    def _choose(self, actions: list[Action], ready: list) -> Action:
        if self.pos < len(self.plan):
            want = self.plan[self.pos]
            self.pos += 1
            if want not in actions:
                raise ScheduleDivergence(
                    f"plan step {self.pos - 1} wants {want!r} but the "
                    f"schedule offers {actions!r} — the bundle does not "
                    "match this build/config"
                )
            return want
        if self.policy == "fifo":
            return ("ev", ready[0][1])
        if self.policy == "random":
            injections = [a for a in actions if a[0] != "ev"]
            if injections and self._rng.random() < 0.25:
                return injections[self._rng.randrange(len(injections))]
            evs = [a for a in actions if a[0] == "ev"]
            return evs[self._rng.randrange(len(evs))]
        if self.policy == "pct":
            injections = [a for a in actions if a[0] != "ev"]
            if injections and self._rng.random() < 0.15:
                return injections[self._rng.randrange(len(injections))]
            best: Action | None = None
            best_pk: Key | None = None
            best_p = -1.0
            for e in ready:
                k = self.keys.get(e[1])
                pk = k if k is not None else ("?", e[1], "")
                p = self._prio.get(pk)
                if p is None:
                    p = self._prio[pk] = self._rng.random()
                if p > best_p:
                    best_p = p
                    best = ("ev", e[1])
                    best_pk = pk
            if (best_pk is not None and self._pct_left > 0
                    and self._rng.random() < 0.1):
                # change point: demote the currently-preferred endpoint
                self._prio[best_pk] = self._rng.random() - 1.0
                self._pct_left -= 1
            assert best is not None  # actions non-empty  # noqa: S101
            return best
        raise ValueError(f"unknown policy {self.policy!r}")

    def _apply(self, net: Any, chosen: Action, ready: list) -> bool:
        kind = chosen[0]
        self.steps += 1
        if kind == "crash":
            net.crash(chosen[1])
            self.crash_budget -= 1
            self.injections += 1
            self.trace.append(("crash", chosen[1], None))
            return True
        if kind == "recover":
            net.recover(chosen[1])
            self.recover_budget -= 1
            self.injections += 1
            self.trace.append(("recover", chosen[1], None))
            return True
        seq = chosen[1]
        entry = None
        for e in ready:
            if e[1] == seq:
                entry = e
                break
        if entry is None:  # pragma: no cover - _choose guarantees membership
            raise ScheduleDivergence(f"chosen event seq {seq} not ready")
        events = net._events
        events.remove(entry)
        heapq.heapify(events)
        t = entry[0]
        if t > net.now:
            net.now = t
        net.events_processed += 1
        self.trace.append((kind, seq, self.keys.get(seq)))
        if kind == "drop":
            self.drop_budget -= 1
            self.injections += 1
            self._drop_pending = True
        entry[2]()
        self._drop_pending = False  # defensive: droppable events consume it
        return True


# --------------------------------------------------------------- scenarios

def _scn_wr(dss: Any) -> list[tuple[str, str, Generator]]:
    """Two clients on one block: each writes then reads back — the tiny
    (3 servers / 2 clients / 1 block) exhaustive-DFS config."""
    h1, h2 = dss.client("c1"), dss.client("c2")

    def wseq(h: Any, payload: bytes) -> Generator:
        st = yield from h.update("f", payload)
        val = yield from h.read("f")
        return (bool(st["success"]), len(val))

    return [
        ("c1", "race:wr1", wseq(h1, b"A" * 48)),
        ("c2", "race:wr2", wseq(h2, b"B" * 48)),
    ]


def _scn_ww(dss: Any) -> list[tuple[str, str, Generator]]:
    """Two concurrent writers + a reader on one block: the write-write
    interleaving config the unguarded-put control races on."""
    h1, h2, h3 = dss.client("c1"), dss.client("c2"), dss.client("c3")

    def w(h: Any, payload: bytes) -> Generator:
        st = yield from h.update("f", payload)
        return bool(st["success"])

    def r(h: Any) -> Generator:
        val = yield from h.read("f")
        return len(val)

    return [
        ("c1", "race:w1", w(h1, b"A" * 48)),
        ("c2", "race:w2", w(h2, b"B" * 48)),
        ("c3", "race:r", r(h3)),
    ]


def _scn_ec_recon(dss: Any) -> list[tuple[str, str, Generator]]:
    """Larger config for the seeded PCT / random-walk modes: EC-coded
    writes racing a reader and a concurrent reconfiguration."""
    h1, h2, h3 = dss.client("c1"), dss.client("c2"), dss.client("c3")
    target = dss.make_config()

    def w(h: Any) -> Generator:
        st = yield from h.update("f", b"X" * 256)
        return bool(st["success"])

    def r(h: Any) -> Generator:
        val = yield from h.read("f")
        return len(val)

    def rc(h: Any) -> Generator:
        n = yield from h.recon("f", target)
        return int(n)

    return [
        ("c1", "race:w", w(h1)),
        ("c2", "race:r", r(h2)),
        ("c3", "recon", rc(h3)),
    ]


SCENARIOS: dict[str, Callable[[Any], list[tuple[str, str, Generator]]]] = {
    "wr": _scn_wr,
    "ww": _scn_ww,
    "ec-recon": _scn_ec_recon,
}

# per-scenario store shape (overridable from ExploreConfig/CLI)
SCENARIO_PARAMS: dict[str, dict[str, Any]] = {
    "wr": {"algorithm": "coabd", "n_servers": 3},
    "ww": {"algorithm": "coabd", "n_servers": 3},
    "ec-recon": {"algorithm": "coaresec", "n_servers": 5, "parity_m": 2},
}


# ------------------------------------------------------------- fault hooks

class _FaultHook:
    """Context manager base: install on __enter__, restore on __exit__."""

    def __init__(self, net: Any, ctrl: ScheduleController) -> None:
        self.net = net
        self.ctrl = ctrl

    def __enter__(self) -> "_FaultHook":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


class _EarlyReadResume(_FaultHook):
    """Seeded quorum off-by-one the static ``on_rpc`` check CANNOT see:
    ``_RpcState`` is built with one reply fewer than the (honest, already
    sanitizer-checked) need, for ops whose kind starts with ``race:``. The
    fan-out still goes to every server — only a schedule where a lagging
    server answers first surfaces the stale read (Wing–Gong)."""

    def __enter__(self) -> "_EarlyReadResume":
        from repro_torch.net import sim

        self._orig = sim._RpcState.__init__

        orig = self._orig

        def patched(s: Any, net: Any, gen: Any, fut: Any, on_done: Any,
                    acct: Any, src_i: Any, need: Any, alive: Any,
                    counted: Any) -> None:
            if (not alive and isinstance(need, int) and need > 1
                    and fut.kind.startswith("race:")):
                need -= 1
            orig(s, net, gen, fut, on_done, acct, src_i, need, alive, counted)

        sim._RpcState.__init__ = patched  # type: ignore[method-assign]
        return self

    def __exit__(self, *exc: Any) -> None:
        from repro_torch.net import sim

        sim._RpcState.__init__ = self._orig  # type: ignore[method-assign]


class _HandlerPatch(_FaultHook):
    """Base for faults that replace a StorageServer handler: patches BOTH
    the class attribute and the ``_DISPATCH`` entry (dispatch holds the raw
    function, not a bound lookup)."""

    op = ""

    def _install(self, fn: Callable[..., Any]) -> None:
        from repro_torch.core.server import StorageServer

        self._orig = StorageServer._DISPATCH[self.op]
        self._orig_attr = getattr(StorageServer, "_h_" + self.op.replace("-", "_"))
        StorageServer._DISPATCH[self.op] = fn
        setattr(StorageServer, "_h_" + self.op.replace("-", "_"), fn)

    def __exit__(self, *exc: Any) -> None:
        from repro_torch.core.server import StorageServer

        StorageServer._DISPATCH[self.op] = self._orig
        setattr(StorageServer, "_h_" + self.op.replace("-", "_"), self._orig_attr)


class _AckRollback(_HandlerPatch):
    """Dropped-ack tag regression: the server applies an ``abd-put`` (plain
    or batch) and acks — but if that ack is lost in flight it rolls the put
    back, through raw ``dict`` access so the tracked maps never report
    (= never forgive) the regression. Reply shapes are untouched; pending
    rollbacks are keyed by ack-object identity (the sim delivers the exact
    object the handler returned, and this table pins it alive). Caught by
    the sanitizer's reply-monotonicity floor on the next get this server
    answers."""

    def __enter__(self) -> "_AckRollback":
        from repro_torch.core.server import StorageServer

        # id(ack) -> (ack ref, server, [(key, prev_state), ...])
        self.pending: dict[int, tuple[Any, Any, list[tuple[tuple, Any]]]] = {}
        pending = self.pending
        self._saved = {
            op: StorageServer._DISPATCH[op]
            for op in ("abd-put", "abd-put-batch")
        }
        orig_put = self._saved["abd-put"]

        def put1(srv: Any, sender: str, msg: tuple) -> Any:
            key = (msg[1], msg[2])
            prev = dict.get(srv.abd, key)
            orig_put(srv, sender, msg)
            reply = tuple(["ack"])  # fresh object: identity keys the undo
            pending[id(reply)] = (reply, srv, [(key, prev)])
            return reply

        def putb(srv: Any, sender: str, msg: tuple) -> Any:
            _, items, idx = msg
            undo = []
            for obj, tag, val in items:
                key = (obj, idx)
                undo.append((key, dict.get(srv.abd, key)))
                orig_put(srv, sender, ("abd-put", obj, idx, tag, val))
            reply = ("ack", len(items))
            pending[id(reply)] = (reply, srv, undo)
            return reply

        StorageServer._DISPATCH["abd-put"] = put1
        StorageServer._DISPATCH["abd-put-batch"] = putb
        self.ctrl.on_reply_dropped = self._on_drop
        return self

    def __exit__(self, *exc: Any) -> None:
        from repro_torch.core.server import StorageServer

        for op, fn in self._saved.items():
            StorageServer._DISPATCH[op] = fn

    def _on_drop(self, sid: str, reply: Any) -> None:
        ent = self.pending.pop(id(reply), None)
        if ent is None:
            return
        _reply, srv, undo = ent
        from repro_torch.core.tags import TAG0

        for key, prev in reversed(undo):
            dict.__setitem__(
                srv.abd, key, prev if prev is not None else (TAG0, None)
            )
        dict.clear(srv._rcache)
        dict.clear(srv._rkeys)


class _UnguardedPut(_HandlerPatch):
    """Drops the ``tag > cur`` guard on ``abd-put``: last-arrival-wins.
    Two concurrent writers' puts landing out of tag order regress the
    register — an UNORDERED write-write race the vector-clock tracker
    reports at mutation time, before any reply could reveal it."""

    op = "abd-put"

    def __enter__(self) -> "_UnguardedPut":
        def patched(srv: Any, sender: str, msg: tuple) -> Any:
            _, obj, idx, tag, val = msg
            srv._abd_state((obj, idx))
            srv.abd[(obj, idx)] = (tag, val)  # guard dropped!
            return ("ack",)

        self._install(patched)
        return self


class _RetryDupWrite(_HandlerPatch):
    """Retry-duplicate write WITHOUT suppression (ISSUE 10 positive
    control): the first delivery of each distinct ``abd-put`` request runs
    the honest guarded handler, but a RE-delivery — the deadline machinery's
    retransmission of the same request after its ack was dropped — is
    applied blindly, last-write-wins. A schedule where a rival writer's
    newer tag lands between the original delivery and the retransmitted
    duplicate regresses the register: exactly the corruption duplicate
    suppression (tag guards + sid-keyed replies) exists to prevent. Needs
    ``retry=True`` plus a drop (and a crash to thin the quorum) so a
    retransmission actually fires."""

    op = "abd-put"

    def __enter__(self) -> "_RetryDupWrite":
        seen: set = set()

        def patched(srv: Any, sender: str, msg: tuple) -> Any:
            _, obj, idx, tag, val = msg
            key = (srv.sid, sender, obj, idx, tag)
            if key in seen:  # retransmitted duplicate: suppression dropped!
                srv._abd_state((obj, idx))
                srv.abd[(obj, idx)] = (tag, val)
                return ("ack",)
            seen.add(key)
            return self._orig(srv, sender, msg)

        self._install(patched)
        return self


FAULTS: dict[str, type[_FaultHook]] = {
    "early-read-resume": _EarlyReadResume,
    "ack-rollback": _AckRollback,
    "unguarded-put": _UnguardedPut,
    "retry-dup-write": _RetryDupWrite,
}


# ------------------------------------------------------------ one schedule

@dataclass
class ExploreConfig:
    """One exploration target: scenario + store shape + controller knobs +
    explorer budgets. Everything here is stamped into repro bundles."""

    scenario: str = "wr"
    algorithm: str = "coabd"
    n_servers: int = 3
    parity_m: int = 1
    delta: int = 8
    seed: int = 0
    fast_net: bool = True
    fault: str | None = None
    # arm the ISSUE 10 deadline/retransmit machinery (jitter pinned to 0 so
    # the retry stream draws nothing and replays stay byte-identical); ops
    # that exhaust the budget fail typed and count as incomplete.
    retry: bool = False
    # controller
    width: int = 4
    horizon: float = 1.0e-3
    crash_budget: int = 0
    drop_budget: int = 0
    # explorer
    mode: str = "dfs"           # dfs | pct | random
    budget: int = 1000          # max schedules
    branch_depth: int = 6       # DFS: decisions eligible for branching
    prune: bool = True
    policy_seed: int = 0
    stop_on_first: bool = True
    max_events: int = 200_000

    @classmethod
    def for_scenario(cls, scenario: str, **kw: Any) -> "ExploreConfig":
        base = dict(SCENARIO_PARAMS.get(scenario, {}))
        base.update(kw)
        return cls(scenario=scenario, **base)


@dataclass
class Outcome:
    violation: dict[str, str] | None
    decisions: list[dict[str, Any]]
    trace: list[tuple[str, Any, Key | None]]
    fingerprint: dict[str, Any]
    report: dict[str, Any] = dc_field(default_factory=dict)


def _fingerprint(dss: Any) -> dict[str, Any]:
    net = dss.net
    hist = repr([
        (r.kind, r.obj, r.client, r.tag, r.flag, r.start, r.end)
        for r in dss.history
    ])
    return {
        "now": net.now,
        "events": net.events_processed,
        "msgs": net.msg_count,
        "bytes": net.bytes_sent,
        "rounds": net.rpc_rounds,
        "history_sha": hashlib.sha256(hist.encode()).hexdigest(),
    }


def run_schedule(
    cfg: ExploreConfig,
    plan: Iterable[Action] = (),
    policy: str = "fifo",
    policy_seed: int = 0,
    device: str = "cuda",
) -> Outcome:
    """Run one scenario instance under one controlled schedule: sanitizer +
    race tracker live, Wing–Gong post-hoc. Returns the decision log and
    trace fingerprint; protocol violations land in ``Outcome.violation``
    (schedule divergence and genuine crashes still raise). ``device`` is
    the store's data-plane device (``DSSParams.device``); the schedule and
    its trace do not depend on it, so bundles do not record it."""
    from repro_torch.core.store import DSS, DSSParams
    from repro_torch.net.sim import QuorumUnavailableError, RetryPolicy

    params = DSSParams(
        algorithm=cfg.algorithm, n_servers=cfg.n_servers,
        parity_m=cfg.parity_m, delta=cfg.delta, seed=cfg.seed,
        fast_net=cfg.fast_net, sanitize=True, racecheck=True, device=device,
        retry=RetryPolicy(rpc_timeout=5e-3, jitter=0.0, max_attempts=2,
                          phase_retries=1, phase_backoff=1e-3)
        if cfg.retry else None,
    )
    dss = DSS(params)
    ctrl = ScheduleController(
        plan=plan, policy=policy, seed=policy_seed,
        width=cfg.width, horizon=cfg.horizon,
        crash_budget=cfg.crash_budget, drop_budget=cfg.drop_budget,
        crashable=tuple(f"s{i}" for i in range(cfg.n_servers)),
    )
    dss.net.controller = ctrl
    hook = FAULTS[cfg.fault](dss.net, ctrl) if cfg.fault else _FaultHook(dss.net, ctrl)
    violation: dict[str, str] | None = None
    futs: list[Any] = []
    unavailable: list[str] = []

    def _shield(kind: str, gen: Generator) -> Generator:
        # a retry budget exhausting mid-exploration is a LIVENESS outcome,
        # not a safety violation: record it (the op stays out of the strict
        # reads-from gate) instead of crashing the event loop.
        try:
            return (yield from gen)
        except QuorumUnavailableError:
            unavailable.append(kind)
            return None

    with hook:
        ops = SCENARIOS[cfg.scenario](dss)
        for cid, kind, gen in ops:
            futs.append(dss.net.spawn(_shield(kind, gen), kind=kind, client=cid))
        try:
            dss.net.run(max_events=cfg.max_events)
        except SanitizerError as e:  # includes RaceError / linearize errors
            violation = {"type": type(e).__name__, "message": str(e)}
    incomplete = sum(1 for f in futs if not f.done)
    if violation is None:
        strict = (incomplete == 0 and ctrl.injections == 0
                  and not unavailable and dss.net.op_retries == 0)
        try:
            dss.check_history(strict_reads=strict)
        except SanitizerError as e:
            violation = {"type": type(e).__name__, "message": str(e)}
    report = {
        "ops": len(futs),
        "ops_incomplete": incomplete,
        "ops_unavailable": len(unavailable),
        "injections": ctrl.injections,
        "retransmits": dss.net.retransmits,
        "sanitizer": dss.net.sanitizer.report(),
        "races": dss.net.race_tracker.report(),
    }
    return Outcome(
        violation=violation,
        decisions=ctrl.decisions,
        trace=ctrl.trace,
        fingerprint=_fingerprint(dss),
        report=report,
    )


# ---------------------------------------------------------------- explorer

def _prunable(alt: Action, d: int, out: Outcome) -> bool:
    """Sleep-set-style check: running ``alt`` at decision ``d`` instead is
    redundant when the observed schedule executed that same event later
    with only commuting steps in between (the reordering reaches the same
    state — Mazurkiewicz equivalence)."""
    if alt[0] != "ev":
        return False  # injections are never pruned
    seq = alt[1]
    start = out.decisions[d]["at"]
    alt_key: Key | None = None
    hit = -1
    for i in range(start, len(out.trace)):
        kind, ident, key = out.trace[i]
        if kind == "ev" and ident == seq:
            hit = i
            alt_key = key
            break
        if kind == "drop" and ident == seq:
            return False  # executed, but as a different action
    if hit < 0:
        return False  # never executed (crash swallowed it): must explore
    for i in range(start, hit):
        _kind, _ident, key = out.trace[i]
        if _kind in ("crash", "recover") or conflicts(key, alt_key):
            return False
    return True


@dataclass
class ExploreResult:
    schedules: int
    violations: list[dict[str, Any]]   # full bundles, in memory
    pruned: int
    exhausted: bool                    # DFS only: frontier drained

    @property
    def found(self) -> bool:
        return bool(self.violations)


def _bundle(cfg: ExploreConfig, out: Outcome, policy: str,
            policy_seed: int) -> dict[str, Any]:
    return {
        "version": 1,
        "config": asdict(cfg),
        "engine": "fast" if cfg.fast_net else "legacy",
        "seed_params": {
            "seed": cfg.seed, "algorithm": cfg.algorithm,
            "n_servers": cfg.n_servers, "parity_m": cfg.parity_m,
            "delta": cfg.delta, "fast_net": cfg.fast_net,
        },
        "policy": policy,
        "policy_seed": policy_seed,
        "schedule": [list(d["chosen"]) for d in out.decisions],
        "violation": out.violation,
        "fingerprint": out.fingerprint,
        "report": out.report,
    }


def explore(cfg: ExploreConfig,
            log: Callable[[str], None] = lambda s: None,
            device: str = "cuda") -> ExploreResult:
    """Drive :func:`run_schedule` per ``cfg.mode``; collect violating
    schedules as repro bundles (see :func:`write_bundle`)."""
    violations: list[dict[str, Any]] = []
    pruned = 0
    schedules = 0
    if cfg.mode in ("pct", "random"):
        for i in range(cfg.budget):
            out = run_schedule(cfg, (), policy=cfg.mode,
                               policy_seed=cfg.policy_seed + i, device=device)
            schedules += 1
            if out.violation is not None:
                violations.append(
                    _bundle(cfg, out, cfg.mode, cfg.policy_seed + i))
                if cfg.stop_on_first:
                    break
        return ExploreResult(schedules, violations, pruned, False)
    if cfg.mode != "dfs":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    frontier: list[tuple[Action, ...]] = [()]
    seen: set[tuple[Action, ...]] = {()}
    while frontier and schedules < cfg.budget:
        prefix = frontier.pop()
        out = run_schedule(cfg, prefix, device=device)
        schedules += 1
        if schedules % 500 == 0:
            log(f"  … {schedules} schedules, frontier {len(frontier)}")
        if out.violation is not None:
            violations.append(_bundle(cfg, out, "fifo", 0))
            if cfg.stop_on_first:
                return ExploreResult(schedules, violations, pruned, False)
            continue  # don't expand past a violating schedule
        chosen = [d["chosen"] for d in out.decisions]
        hi = min(len(out.decisions), cfg.branch_depth)
        for d in range(len(prefix), hi):
            for a in out.decisions[d]["actions"]:
                if a == out.decisions[d]["chosen"]:
                    continue
                if cfg.prune and _prunable(a, d, out):
                    pruned += 1
                    continue
                child = tuple(chosen[:d]) + (a,)
                if child not in seen:
                    seen.add(child)
                    frontier.append(child)
    return ExploreResult(schedules, violations, pruned, not frontier)


# ----------------------------------------------------------------- bundles

def write_bundle(bundle: dict[str, Any], out_dir: str, idx: int = 0) -> str:
    os.makedirs(out_dir, exist_ok=True)
    cfg = bundle["config"]
    name = (
        f"{cfg['scenario']}-{cfg['fault'] or 'clean'}-"
        f"{bundle['policy']}-{bundle['policy_seed']}-{idx:04d}.json"
    )
    path = os.path.join(out_dir, name)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(bundle, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def load_bundle(path: str) -> dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        bundle = json.load(fh)
    if bundle.get("version") != 1:
        raise ValueError(f"unknown bundle version in {path}")
    return bundle


def replay_bundle(bundle: dict[str, Any], device: str = "cuda") -> dict[str, Any]:
    """Re-execute a bundle's schedule and verify byte-identical outcome:
    same violation (type + message) at the same trace fingerprint. Returns
    ``{"reproduced": bool, ...}`` with both sides for diagnosis."""
    cfg = ExploreConfig(**bundle["config"])
    plan = [tuple(a) for a in bundle["schedule"]]
    out = run_schedule(cfg, plan, policy=bundle["policy"],
                       policy_seed=bundle["policy_seed"], device=device)
    same_violation = out.violation == bundle["violation"]
    same_fp = out.fingerprint == bundle["fingerprint"]
    return {
        "reproduced": same_violation and same_fp,
        "violation_matches": same_violation,
        "fingerprint_matches": same_fp,
        "violation": out.violation,
        "expected_violation": bundle["violation"],
        "fingerprint": out.fingerprint,
        "expected_fingerprint": bundle["fingerprint"],
    }


# --------------------------------------------------------------------- CLI

def _print(s: str) -> None:
    print(s)


def _run_explore(cfg: ExploreConfig, out_dir: str, device: str) -> int:
    res = explore(cfg, log=_print, device=device)
    tag = f"[{cfg.scenario}/{cfg.fault or 'clean'}/{cfg.mode}]"
    for i, b in enumerate(res.violations):
        path = write_bundle(b, out_dir, i)
        v = b["violation"]
        _print(f"{tag} VIOLATION ({v['type']}): {v['message']}")
        _print(f"{tag} repro bundle: {path}  "
               f"(replay: python -m repro_torch.analysis.explore --replay {path})")
    _print(
        f"{tag} {res.schedules} schedules explored, {res.pruned} pruned, "
        f"{len(res.violations)} violation(s)"
        + (", frontier exhausted" if res.exhausted else "")
    )
    return 1 if res.violations else 0


def _selftest(out_dir: str, budget: int, device: str) -> int:
    """Positive controls: each seeded fault MUST be found within budget
    (and its bundle must replay byte-identically); the detector is broken
    otherwise. Returns 0 on success."""
    controls: list[tuple[str, dict[str, Any]]] = [
        # the two deep interleaving bugs need the priority schedules (the
        # bounded DFS frontier can't reach decision ~30 within budget);
        # the write-write race falls out of the exhaustive pass directly
        ("early-read-resume", {"scenario": "wr", "mode": "pct"}),
        ("ack-rollback", {"scenario": "wr", "mode": "pct", "drop_budget": 1}),
        ("unguarded-put", {"scenario": "ww", "mode": "dfs"}),
        # ISSUE 10: a retransmitted write applied without duplicate
        # suppression — needs the retry machinery armed plus a crash (thins
        # the quorum) and a dropped ack (forces the retransmission)
        ("retry-dup-write", {"scenario": "ww", "mode": "pct",
                             "crash_budget": 1, "drop_budget": 1,
                             "retry": True}),
    ]
    ok = True
    for i, (fault, kw) in enumerate(controls):
        cfg = ExploreConfig.for_scenario(fault=fault, budget=budget, **kw)
        res = explore(cfg, device=device)
        if not res.found:
            _print(f"[selftest] FAIL: fault {fault!r} NOT found in "
                   f"{res.schedules} schedules")
            ok = False
            continue
        rep = replay_bundle(res.violations[0], device)
        if not rep["reproduced"]:
            _print(f"[selftest] FAIL: fault {fault!r} bundle does not "
                   f"replay byte-identically: {rep}")
            ok = False
            continue
        path = write_bundle(res.violations[0], out_dir, i)
        _print(f"[selftest] ok: {fault!r} found in {res.schedules} "
               f"schedule(s), bundle replays byte-identically -> {path}")
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explore",
        description="systematic schedule exploration + race detection",
    )
    ap.add_argument("--replay", metavar="BUNDLE", default=None,
                    help="re-execute a repro bundle and verify byte-identity")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded positive-control faults")
    ap.add_argument("--scenario", default="wr", choices=sorted(SCENARIOS))
    ap.add_argument("--mode", default="dfs", choices=("dfs", "pct", "random"))
    ap.add_argument("--fault", default=None, choices=sorted(FAULTS))
    ap.add_argument("--budget", type=int, default=1000)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--crash-budget", type=int, default=0)
    ap.add_argument("--drop-budget", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy-seed", type=int, default=0)
    ap.add_argument("--legacy-net", action="store_true",
                    help="explore the legacy per-destination engine")
    ap.add_argument("--no-prune", action="store_true")
    ap.add_argument("--keep-going", action="store_true",
                    help="collect every violation instead of stopping at one")
    ap.add_argument("--out", default=os.path.join("runs", "schedules"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the store's data-plane device (DSSParams.device)")
    args = ap.parse_args(argv)
    if args.replay:
        rep = replay_bundle(load_bundle(args.replay), args.device)
        if rep["reproduced"]:
            _print(f"replay ok: byte-identical ({args.replay})")
            return 0
        _print(f"replay MISMATCH: {json.dumps(rep, indent=1, default=str)}")
        return 2
    if args.selftest:
        return _selftest(args.out, args.budget, args.device)
    cfg = ExploreConfig.for_scenario(
        args.scenario, mode=args.mode, fault=args.fault,
        budget=args.budget, branch_depth=args.depth,
        crash_budget=args.crash_budget, drop_budget=args.drop_budget,
        seed=args.seed, policy_seed=args.policy_seed,
        fast_net=not args.legacy_net, prune=not args.no_prune,
        stop_on_first=not args.keep_going,
    )
    return _run_explore(cfg, args.out, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
