"""Deterministic discrete-event asynchronous network simulator.

The paper evaluates on Emulab (emulated LAN) and AWS EC2 (real WAN). This
module provides the third option used throughout this repo: a **virtual-time
event simulator** with per-message latency = base ~ U[lo, hi] + size/bandwidth
(+ optional jitter/drops), crash/recover injection, and size-aware payload
accounting. Virtual time makes every benchmark deterministic and lets the
test-suite check linearizability/coverability against recorded histories —
something a live testbed cannot do.

Programming model
-----------------
*Servers* are objects with a synchronous ``handle(sender, msg) -> reply``.
*Client operations* are Python generators that ``yield`` effects:

    replies = yield RPC(dests=[...], msg=(...), need=q)   # quorum round-trip
    yield Sleep(0.01)                                     # backoff

``yield from`` composes sub-protocols (a CoARES write yields from read-config,
which yields from per-config RPCs, ...). ``Network.spawn`` turns a generator
into an ``OpFuture``; ``Network.run`` drives the event loop to quiescence.
Replies arriving after a quorum resumed the generator are delivered to the
runner and ignored — exactly the paper's "wait for a quorum, ignore the rest".

Scale-out hot path (ISSUE 7)
----------------------------
At 10^5 sessions the driver itself — not the storage protocol — used to be
the bottleneck: every message paid a heapq push, a Python closure, a scalar
RNG draw and a codec walk. The engine now runs an allocation-light fan-out
path by default (``Network(fast=True)``, ``DSSParams.fast_net``):

* **one scheduled event per RPC fan-out** — a ``_FanOut`` cursor walks its
  pre-computed arrival schedule, inline-draining consecutive arrivals while
  they precede everything else in the heap, instead of one closure + heap
  entry per destination;
* **pooled RNG draws** — one ``rng.uniform(size=2B)`` per fan-out (outbound
  props then reply props, in destination order). Drop flags come from a
  dedicated ``_drop_rng`` stream and are *only drawn when ``drop_prob > 0``*,
  so toggling drops no longer perturbs every latency sample;
* **interned endpoints** — per-client [rounds, msgs, bytes] accounting and
  NIC busy-until tracking live in flat rows indexed by interned endpoint id
  (``client_counters`` survives as a read-only dict view), and fan-out
  destination tuples resolve to interned server lists once, not per round;
* **wire-size memo** — ``codec.SizingMemo`` frames immutable message
  subtrees once, not once per recipient/retry.

Determinism is the contract: for a fixed seed the fast path replays
*byte- and event-identical* traces versus the per-destination legacy path
(``fast=False``), which draws the same canonical per-fan-out stream but pays
the seed implementation's per-message costs. ``tests/test_scalepath.py``
pins trace identity on mixed workloads.

Schedule control (ISSUE 9)
--------------------------
``Network.controller`` (default ``None``) hands the event loop's pop policy
to an external scheduler — ``repro_torch.analysis.explore.ScheduleController`` —
so a model checker can turn "which pending delivery lands next" into an
explicit, replayable decision. With a controller attached:

* ``run``/``step`` call ``controller.step(net)`` instead of popping the
  heap min, and every ``schedule`` call reports its ``(seq, key)`` so the
  controller can reason about which events commute (``key`` labels the
  event's target endpoint: ``("srv", sid)`` for message arrivals,
  ``("rpl", client)`` for reply deliveries, ``("cli", client)`` for op
  resumes/timers);
* ``_FanOut`` stops inline-draining — every arrival re-enters the heap as
  its own event, so each delivery is its own decision point (the cursor's
  reserved sequence numbers are unchanged, so a controller that always
  picks the heap minimum replays the exact uncontrolled trace);
* the controller may mark the event it executes as *dropped*
  (``consume_drop``): a dropped arrival never reaches ``handle`` and a
  dropped reply never reaches the op — message loss as a schedulable
  choice, drawn from no RNG stream.

``Network.race_tracker`` (default ``None``) is a second pure observer —
``repro_torch.analysis.races.RaceTracker`` — fed from the same three points as
the sanitizer (RPC issue, arrival processing, counted reply delivery) plus
the tracked-map mutation hooks in ``core/server.py``; it maintains
vector clocks per operation and flags conflicting unordered writes to
per-object server state. Both attributes cost one ``is not None`` per
event when unset, and neither draws randomness nor schedules events.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from functools import partial
from time import perf_counter  # protocol-lint: allow-determinism (profile_protocol wall split only; virtual time never reads it)
from typing import Any, Callable, Generator

import numpy as np

from repro_torch.net.codec import CodecError, SizingMemo, try_wire_size


def nbytes(obj: Any) -> int:
    """Approximate wire size of a message payload (drives latency model).

    This is the legacy per-Python-object heuristic, kept as the FALLBACK for
    payloads outside the wire codec's vocabulary — protocol messages are
    charged their real framed size via ``msg_wire_size`` (ISSUE 3)."""
    if obj is None:
        return 1
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, str):
        # UTF-8 byte length, not code-point count (ISSUE 7): "héllo" is six
        # bytes on any real wire; len() undercounted every non-ASCII string.
        return len(obj) if obj.isascii() else len(obj.encode("utf-8"))
    if isinstance(obj, bool):  # before int: bool is an int subclass
        return 1
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, np.ndarray):
        # An ndarray nested inside an out-of-vocabulary container used to be
        # charged the legacy ``16 + nbytes`` guess; route it through the
        # codec's real ndarray framing instead (ISSUE 4) — the codec knows
        # the exact dtype/shape/payload frame, so containers that mix arrays
        # with un-frameable objects stop being over-charged per array.
        size = try_wire_size(obj)
        return 16 + int(obj.nbytes) if size is None else size
    if isinstance(obj, np.generic):
        return int(obj.nbytes)
    if isinstance(obj, (tuple, list, set, frozenset)):
        return 16 + sum(nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return 16 + sum(nbytes(k) + nbytes(v) for k, v in obj.items())
    if hasattr(obj, "wire_size"):
        return int(obj.wire_size())
    return 64


def msg_wire_size(obj: Any) -> int:
    """Bytes charged for one message on the wire: the codec's length-prefixed
    frame size when the payload is wire-encodable (every protocol message
    is — see ``repro_torch.net.codec``), else the ``nbytes`` heuristic."""
    size = try_wire_size(obj)
    return nbytes(obj) if size is None else size


@dataclass
class LatencyModel:
    """Virtual-time cost model (defaults roughly calibrated to a 1 GbE LAN —
    the paper's Emulab setup; see benchmarks for the AWS-ish WAN variant)."""

    base_lo: float = 0.2e-3          # per-message propagation floor (s)
    base_hi: float = 0.8e-3
    bandwidth: float = 125e6         # bytes/s (1 Gbit/s)
    drop_prob: float = 0.0
    # duplicate delivery (ISSUE 10): with probability ``dup_prob`` a request
    # message arrives TWICE — the handler runs again on the same payload
    # (at-least-once delivery), the duplicate's wire bytes are charged, and
    # its reply is discarded client-side. Draws come from a dedicated
    # ``_dup_rng`` stream only when > 0, so the default consumes nothing.
    dup_prob: float = 0.0
    server_compute: float = 20e-6    # per-message server handling (s)
    # client-side compute models (per byte, s):
    enc_per_byte: float = 0.6e-9     # RS encode  (§VI: encode faster ...)
    dec_per_byte: float = 1.2e-9     # RS decode  (... than decode)
    bi_per_byte: float = 1.0e-9      # FM block identification (rabin/gear+match)
    # Serialize transmissions per endpoint NIC (ISSUE 2): concurrent messages
    # share an endpoint's bandwidth instead of each enjoying the full line
    # rate. Without this, a B-way parallel fan-out of B·L bytes finishes as
    # fast as one L-byte message — physically impossible, and it hid exactly
    # the per-message overhead the paper's §VII-D read argument is about.
    serialize_links: bool = True

    def msg_delay(self, rng: np.random.Generator, size: int) -> float:
        return float(rng.uniform(self.base_lo, self.base_hi)) + size / self.bandwidth


class QuorumUnavailableError(RuntimeError):
    """Typed liveness failure (ISSUE 10): an operation could not assemble a
    quorum within its retry budget. Safety is unaffected — the op performed
    no externally visible partial effect a retry would not have been allowed
    to repeat — but the service was UNAVAILABLE for this op. Protocol phase
    wrappers raise this after exhausting ``RetryPolicy.phase_retries``."""


class RpcTimeout(QuorumUnavailableError):
    """One RPC round missed its per-attempt deadline chain: ``need`` distinct
    replies never arrived within ``RetryPolicy.max_attempts`` retransmissions.
    Thrown INTO the op generator at the pending ``yield RPC`` so protocol
    code can catch it and re-issue the phase against the current config."""


class DeadlineExceeded(RuntimeError):
    """``OpFuture.result(deadline=...)``: the op did not complete within the
    virtual-time deadline (or the network quiesced with the op still pending
    — a lost quorum with retries disabled). Carries ``Network.stuck_ops()``
    diagnostics in the message."""


@dataclass(frozen=True)
class RetryPolicy:
    """Failure-survival knobs (ISSUE 10), plumbed via ``DSSParams.retry``.

    ``None`` (the default everywhere) disables the whole machinery: no RNG
    stream is consumed, no timer events are scheduled, no sequence numbers
    are reserved — traces are bit-identical to a build without the feature.

    With a policy set, every quorum-mode RPC round arms a deterministic
    virtual-time deadline timer: on expiry the round retransmits to the
    destinations that have not replied (handlers are idempotent / guarded,
    and client-side replies are keyed by server id, so duplicates cannot
    double-count toward the quorum), with exponential backoff and seeded
    jitter from the dedicated ``_retry_rng`` stream. After ``max_attempts``
    the round throws :class:`RpcTimeout` into the op generator; the protocol
    tier retries whole phases ``phase_retries`` times against the current
    configuration before surfacing :class:`QuorumUnavailableError`."""

    rpc_timeout: float = 10e-3       # attempt 1 deadline (virtual s)
    backoff: float = 2.0             # per-attempt timeout multiplier
    jitter: float = 0.25             # timeout *= 1 + jitter*U[0,1) when > 0
    max_attempts: int = 4            # send attempts per RPC round
    # hedged duplicate send (tail-latency): ``hedge_after`` virtual seconds
    # into attempt 1, re-send to the laggards WITHOUT burning an attempt.
    hedge_after: float | None = None
    phase_retries: int = 2           # protocol-phase re-issues on RpcTimeout
    phase_backoff: float = 5e-3      # base phase backoff (linear x attempt)
    op_deadline: float = 60.0        # OpFuture.result default deadline


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` in crash | recover | partition | heal |
    heal-all | slow | unslow. ``peer`` is the partition/heal destination
    endpoint, ``extra`` the gray-failure added latency (s), ``wipe`` the
    crash-recovery volatile-state wipe flag."""

    at: float
    kind: str
    target: str = ""
    peer: str = ""
    extra: float = 0.0
    wipe: bool = True


@dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule (ISSUE 10): crash-stop, crash-recovery,
    asymmetric link partitions and gray failures as timed events, applied
    relative to ``net.now`` at :meth:`apply` time. Deterministic — no RNG."""

    events: tuple = ()

    def apply(self, net: "Network") -> None:
        for ev in self.events:
            net.schedule(ev.at, partial(self._fire, net, ev))

    @staticmethod
    def _fire(net: "Network", ev: FaultEvent) -> None:
        kind = ev.kind
        if kind == "crash":
            net.crash(ev.target)
        elif kind == "recover":
            net.recover(ev.target, wipe=ev.wipe)
        elif kind == "partition":
            net.partition(ev.target, ev.peer)
        elif kind == "heal":
            net.heal(ev.target, ev.peer)
        elif kind == "heal-all":
            net.heal()
        elif kind == "slow":
            net.slow(ev.target, ev.extra)
        elif kind == "unslow":
            net.unslow(ev.target)
        else:
            raise ValueError(f"unknown fault kind {kind!r}")


@dataclass
class RPC:
    """Send ``msg`` to every server in ``dests``; resume the op generator once
    ``need`` distinct servers replied. The generator receives ``{sid: reply}``.

    ``need`` may be the string ``"alive"``: it resolves to the number of
    destinations whose server is live at issue time (resuming immediately
    with ``{}`` when none are). This is the server-addressed pull the repair
    subsystem uses — "everyone who can answer", without hanging on crashed
    servers. A destination counted at issue that can no longer reply — it
    crashed before the message landed, declined to answer, or its message /
    reply was dropped — is *abandoned*: the required count shrinks so the op
    resumes with whatever the remaining live servers return instead of
    hanging (ISSUE 7; numeric ``need`` keeps the strict quorum-wait
    semantics).

    ``per_dest`` (optional) overrides ``msg`` per server — used by the EC
    put-data, which ships a *different coded fragment* to each server."""

    dests: tuple
    msg: Any
    need: int | str
    # extra client-side compute charged before sending (e.g. encode cost)
    pre_delay: float = 0.0
    per_dest: dict | None = None


@dataclass
class Sleep:
    duration: float


@dataclass
class Join:
    """Run child operation generators CONCURRENTLY; resume the parent with
    the list of their results (in order). Used by the indexed Fragmentation
    Module to issue block reads/writes in parallel (EXPERIMENTS.md §Perf,
    storage iteration)."""

    children: list


@dataclass
class OpFuture:
    op_id: int
    kind: str = ""
    client: str = ""
    start: float = 0.0
    end: float = 0.0
    done: bool = False
    result: Any = None

    @property
    def latency(self) -> float:
        """Virtual seconds from spawn to completion; ``nan`` while the op is
        still in flight (``end`` is not meaningful before ``done`` — the old
        ``end - start`` returned a nonsense negative value, ISSUE 7)."""
        return self.end - self.start if self.done else math.nan


class Server:
    """Base class: subclasses implement ``handle``; crash state lives here."""

    def __init__(self, sid: str):
        self.sid = sid
        self.crashed = False

    def handle(self, sender: str, msg: Any) -> Any:  # pragma: no cover
        raise NotImplementedError

    def on_recover(self) -> None:
        """Crash-recovery hook (ISSUE 10): wipe volatile state that must not
        survive a crash (reply/identity caches, in-flight handler scratch).
        Durable protocol state (tags, blocks, configs) stays. Base: no-op."""


class _RpcState:
    """Shared per-RPC bookkeeping for both send paths: reply collection,
    quorum resume, and ``need="alive"`` abandonment."""

    __slots__ = (
        "net", "gen", "fut", "on_done", "acct", "src_i",
        "need", "alive", "counted", "replies", "resumed",
        "rpc", "attempt", "hedged",
    )

    def __init__(self, net, gen, fut, on_done, acct, src_i, need, alive, counted):
        self.net = net
        self.gen = gen
        self.fut = fut
        self.on_done = on_done
        self.acct = acct
        self.src_i = src_i
        self.need = need
        self.alive = alive
        # alive mode only: destinations that were live at ISSUE time — only
        # these contributed to ``need``, so only these may abandon it.
        self.counted = counted
        self.replies: dict[str, Any] = {}
        self.resumed = False
        # retry machinery (ISSUE 10): set by _run_rpc only when a RetryPolicy
        # is active and the round is quorum-mode. ``attempt == 0`` means no
        # timer was armed (feature off / alive mode) — deadline callbacks
        # check the attempt generation, so stale timers are no-ops.
        self.rpc = None
        self.attempt = 0
        self.hedged = False

    def _resume(self, payload) -> None:
        self.resumed = True
        self.net._waiting.pop(id(self), None)
        self.net._step(self.gen, self.fut, payload, self.on_done)

    def deliver(self, sid: str, reply: Any) -> None:
        net = self.net
        ctrl = net.controller
        if ctrl is not None and ctrl.consume_drop():
            # the controller chose to lose this reply in flight: the op never
            # sees it (alive-mode needs shrink so the op cannot hang).
            ctrl.reply_dropped(sid, reply)
            if not self.resumed:
                self.abandon(sid)
            return
        if self.resumed:
            return  # late reply past the quorum: ignored
        rt = net.race_tracker
        if rt is not None:
            rt.on_reply(sid, self)
        # keyed by server id: a retransmission's duplicate reply OVERWRITES
        # the original instead of double-counting toward the quorum (ISSUE 10
        # duplicate suppression — ``len(replies)`` counts distinct servers).
        self.replies[sid] = reply
        if len(self.replies) >= self.need:
            self._resume(dict(self.replies))

    def abandon(self, sid: str) -> None:
        """A destination counted into an ``"alive"`` need can no longer
        reply; shrink the requirement so the op cannot hang (ISSUE 7)."""
        if self.resumed or not self.alive or sid not in self.counted:
            return
        self.need -= 1
        if len(self.replies) >= self.need:
            self._resume(dict(self.replies))

    def resume_empty(self) -> None:
        if not self.resumed:
            self._resume({})


class _FanOut:
    """One fan-out's pre-computed arrival schedule, processed by a single
    cursor event instead of one heap entry per destination (ISSUE 7).

    ``seq0 .. seq0+nd-1`` were reserved at send time, one per delivered
    arrival *in destination order* — exactly the sequence numbers the legacy
    path's per-destination ``schedule`` calls would have consumed — so heap
    tie-breaking (and therefore the whole trace) is identical. After
    processing an arrival the cursor inline-drains the next one while it
    still precedes every other pending event, advancing virtual time
    directly; otherwise it re-enters the heap at the next arrival's reserved
    (time, seq) slot."""

    __slots__ = (
        "net", "state", "sids", "srvs", "msgs", "shared_msg", "didx",
        "rprops", "rdrop", "dups", "arr", "order", "seq0", "pos", "nd",
    )

    def __init__(self, net, state, sids, srvs, msgs, shared_msg, didx,
                 rprops, rdrop, dups, arr, order, seq0):
        self.net = net
        self.state = state
        self.sids = sids
        self.srvs = srvs
        self.msgs = msgs            # per-dest payloads, or None when shared
        self.shared_msg = shared_msg
        self.didx = didx            # interned dest endpoint ids
        self.rprops = rprops        # reply propagation draws (pooled)
        self.rdrop = rdrop          # reply drop flags, or None when p == 0
        self.dups = dups            # duplicate-delivery flags, or None
        self.arr = arr              # arrival times, destination order
        self.order = order          # arrival processing order (stable sort)
        self.seq0 = seq0
        self.pos = 0
        self.nd = len(order)

    def fire(self) -> None:
        net = self.net
        if net.controller is not None:
            # Controlled mode: one arrival per heap event — no inline drain,
            # so every delivery is its own decision point. The cursor still
            # walks arrivals in arrival-time order under the reserved seqs;
            # since a fan-out's arrivals target DISTINCT servers, any
            # interleaving of them is Mazurkiewicz-equivalent to a
            # cursor-respecting one, so no schedules are lost to this.
            pos = self.pos
            j = self.order[pos]
            self.pos = pos + 1
            self._process(j)
            if self.pos < self.nd:
                nj = self.order[self.pos]
                heapq.heappush(
                    net._events, (self.arr[nj], self.seq0 + nj, self.fire)
                )
            return
        arr = self.arr
        order = self.order
        seq0 = self.seq0
        nd = self.nd
        events = net._events
        pos = self.pos
        while True:
            j = order[pos]
            pos += 1
            self.pos = pos
            self._process(j)
            if pos >= nd:
                return
            nj = order[pos]
            t = arr[nj]
            s = seq0 + nj
            if t > net._run_limit:
                heapq.heappush(events, (t, s, self.fire))
                return
            if events:
                top = events[0]
                if top[0] < t or (top[0] == t and top[1] < s):
                    heapq.heappush(events, (t, s, self.fire))
                    return
            net.now = t
            net.events_processed += 1

    def _process(self, j: int) -> None:
        net = self.net
        state = self.state
        srv = self.srvs[j]
        sid = self.sids[j]
        ctrl = net.controller
        if ctrl is not None and ctrl.consume_drop():
            # schedulable message loss: the arrival never reaches handle()
            state.abandon(sid)
            return
        if srv.crashed:
            state.abandon(sid)
            return
        msg = self.shared_msg if self.msgs is None else self.msgs[j]
        rt = net.race_tracker
        if rt is not None:
            rt.before_handle(sid, state)
        if net.profile_protocol:
            t0 = perf_counter()
            reply = srv.handle(state.fut.client, msg)
            net.protocol_time += perf_counter() - t0
        else:
            reply = srv.handle(state.fut.client, msg)
        if rt is not None:
            rt.after_handle(sid)
        if self.dups is not None and self.dups[j]:
            # at-least-once delivery (dup_prob): the SAME request frame
            # arrives twice, so the handler runs again on it; the duplicate's
            # reply is discarded client-side (its request bytes were charged
            # at send time). Idempotent handlers make this a no-op; buggy
            # ones corrupt state right here — visible to the race tracker.
            if rt is not None:
                rt.before_handle(sid, state)
            srv.handle(state.fut.client, msg)
            if rt is not None:
                rt.after_handle(sid)
        if reply is None:
            state.abandon(sid)
            return
        if net.sanitizer is not None:
            net.sanitizer.on_reply(sid, msg, reply)
        rsize = net._wire(reply)
        net.msg_count += 1
        net.bytes_sent += rsize
        net._acct_add(state.acct, 0, 1, rsize)
        client = state.fut.client
        deliver = self.rdrop is None or not self.rdrop[j]
        if deliver and net._partitions and net._blocked(sid, client):
            deliver = False  # reply direction of an asymmetric partition
        rdelay = net.latency.server_compute + net._transmit_prop(
            self.didx[j], state.src_i, rsize, self.rprops[j], deliver
        )
        if not deliver:
            state.abandon(sid)
            return
        gray = net._gray
        if gray:
            rdelay += gray.get(sid, 0.0) + gray.get(client, 0.0)
        net.schedule(
            rdelay, partial(state.deliver, sid, reply),
            ("rpl", None, client),
        )


class Network:
    def __init__(self, seed: int = 0, latency: LatencyModel | None = None,
                 fast: bool = True):
        self.rng = np.random.default_rng(seed)
        # Drop decisions draw from their OWN stream so that drop_prob == 0
        # consumes nothing and toggling drops never perturbs a latency sample
        # (ISSUE 7 — the old path burned one rng.random() per message even
        # with drops disabled).
        self._drop_rng = np.random.default_rng([int(seed), 0x5EED])
        # ISSUE 10 streams, same discipline as _drop_rng: constructed eagerly
        # (construction draws nothing) but consumed ONLY when the feature is
        # on, so the disabled ablation stays bit-identical. _retry_rng feeds
        # backoff jitter; _dup_rng feeds dup_prob duplicate-delivery flags.
        self._retry_rng = np.random.default_rng([int(seed), 0x7E7])
        self._dup_rng = np.random.default_rng([int(seed), 0xD0B])
        # active retry policy; DSS.__init__ copies DSSParams.retry here.
        # None (default) = timers/retransmits/hedges fully disabled.
        self.retry: RetryPolicy | None = None
        # asymmetric link partitions: set of (src, dst) directed pairs, "*"
        # wildcard on either side. Outbound messages are silently lost at
        # send time, replies at handle time — both at the same virtual
        # timestamps on either engine. Empty set = zero-cost checks.
        self._partitions: set = set()
        # gray failures: endpoint -> extra one-way propagation latency (s),
        # added deterministically (no RNG) to every message the endpoint
        # sends or receives while set.
        self._gray: dict[str, float] = {}
        # in-flight quorum bookkeeping for stuck_ops() diagnostics: every
        # un-resumed _RpcState, keyed by id. Pure bookkeeping — no events.
        self._waiting: dict = {}
        self.retransmits = 0
        self.hedges = 0
        self.rpc_timeouts = 0
        # protocol-phase re-issues (coares retry wrapper bumps this); the
        # workload harness gates Wing–Gong strict reads-from on it staying 0.
        self.op_retries = 0
        self.latency = latency or LatencyModel()
        # fast=True (default): vectorised one-event-per-fan-out engine.
        # fast=False: the seed implementation's per-destination closures —
        # the ablation baseline (DSSParams.fast_net). Both replay identical
        # traces for a fixed seed.
        self.fast_rpc = fast
        # store-wide GF(256) coding backend, read ambiently by every RSCode
        # consumer built against this network (EcDap, repair, recon
        # transfers). DSS.__init__ overrides it from DSSParams.coding_backend.
        self.coding_backend = "auto"
        # data-plane device of every RSCode and chunker built against this
        # network ("cuda" or "cpu"); DSS.__init__ sets it from DSSParams.device.
        self.device = "cuda"
        self.now = 0.0
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._run_limit = math.inf
        self.servers: dict[str, Server] = {}
        self.futures: list[OpFuture] = []
        self._op_ids = itertools.count()
        self.msg_count = 0
        self.bytes_sent = 0
        # driver-side work: every event the engine executed (heap pops plus
        # the fast path's inline-drained arrivals — identical totals on both
        # paths, so events/s is an honest cross-path throughput metric).
        self.events_processed = 0
        # quorum rounds: one per RPC effect issued (a fan-out + wait-for-need
        # counts once, however many servers it touches) — the unit the paper's
        # §VII-D read-overhead argument is about.
        self.rpc_rounds = 0
        # per-client [rounds, msgs, bytes] accounting lives in flat rows
        # indexed by interned endpoint id; both directions of an op's RPCs
        # are attributed to the issuing client, so the Session API can report
        # per-operation OpStats under concurrent multi-client workloads.
        # Plain int lists, not an ndarray: the hot path bumps one row's
        # scalars per message, where numpy element access costs ~1µs a touch.
        # ``client_counters`` exposes the legacy dict-of-list view.
        self._ep_idx: dict[str, int] = {}
        self._acct: list[list[int]] = [[0, 0, 0] for _ in range(64)]
        # NIC busy-until times, indexed by interned endpoint id. Plain lists,
        # not ndarrays: the hot path reads/writes them one scalar at a time.
        self._busy_out: list[float] = [0.0] * 64
        self._busy_in: list[float] = [0.0] * 64
        self._known_clients: dict[str, None] = {}  # insertion-ordered set
        # per-client resolved accounting target, invalidated by attribute():
        # ("s", row_index) for a lone client, ("m", index_array) with riders.
        self._rows_cache: dict[str, tuple[str, Any]] = {}
        # attribution map (ISSUE 4): endpoint -> rider clients. While set,
        # every RPC the endpoint issues ALSO advances each rider's counters —
        # how a gateway's merged round is attributed to the clients it serves
        # (each rider sees the shared round once, same semantics as OpStats
        # sharing under a coalesced Session batch).
        self.client_attribution: dict[str, tuple[str, ...]] = {}
        self._sizer = SizingMemo()
        # fan-out destination cache: cfg.servers tuples are reused across
        # thousands of rounds, so the existence filter + endpoint interning
        # is resolved once per distinct tuple (identity-keyed, tuple pinned;
        # invalidated when topology grows). Lists are never cached.
        self._dest_cache: dict[int, tuple] = {}
        # opt-in wall-clock split for benchmarks: with ``profile_protocol``
        # set, seconds spent inside protocol code — op-generator bodies and
        # ``Server.handle`` — accumulate here, so a driver can report
        # *driver* time (wall minus protocol) for the engine comparison
        # ISSUE 7 is about. Off by default: two perf_counter() calls per
        # event are noise the normal path shouldn't pay.
        self.profile_protocol = False
        self.protocol_time = 0.0
        # optional runtime invariant observer (repro_torch.analysis.sanitizer),
        # attached via ProtocolSanitizer.attach() behind DSSParams.sanitize /
        # REPRO_SANITIZE=1. Pure observer: it draws no randomness and
        # schedules nothing, so sanitized traces stay bit-identical. Cost
        # when unset is one ``is not None`` per fan-out/reply.
        self.sanitizer = None
        # optional schedule controller (repro_torch.analysis.explore) — see the
        # "Schedule control" section of the module docstring. While set, the
        # event loop's pop policy (and optional message loss) is the
        # controller's decision; unset, behavior is bit-identical to before.
        self.controller = None
        # optional happens-before race tracker (repro_torch.analysis.races): a pure
        # observer fed at RPC issue / arrival handle / counted reply delivery
        # plus the tracked-map mutation hooks in core/server.py.
        self.race_tracker = None

    # -- topology ------------------------------------------------------------
    def add_server(self, server: Server) -> None:
        self.servers[server.sid] = server
        self._dest_cache.clear()  # cached fan-outs may now resolve more dests
        if self.sanitizer is not None and hasattr(server, "_mut_observer"):
            server._mut_observer = self.sanitizer.forget
        if self.race_tracker is not None and hasattr(server, "_race_observer"):
            server._race_observer = self.race_tracker.on_mutation

    def crash(self, sid: str) -> None:
        self.servers[sid].crashed = True

    def recover(self, sid: str, wipe: bool = True) -> None:
        """Bring a crashed server back. ``wipe=True`` (crash-recovery, ISSUE
        10) invokes :meth:`Server.on_recover` so volatile state — reply /
        identity caches, handler scratch — does not survive the crash;
        ``wipe=False`` is the legacy flag-flip (server resumes with whatever
        it had, caches included)."""
        srv = self.servers[sid]
        srv.crashed = False
        if wipe:
            srv.on_recover()

    def alive(self) -> list[str]:
        return [s for s, srv in self.servers.items() if not srv.crashed]

    # -- fault surface (ISSUE 10) ---------------------------------------------
    def partition(self, src: str, dst: str, *, bidir: bool = False) -> None:
        """Block messages src -> dst (asymmetric by default). ``"*"`` on
        either side is a wildcard. Partitioned messages are lost silently —
        no drop-RNG draws, so traces without partitions are unperturbed."""
        self._partitions.add((src, dst))
        if bidir:
            self._partitions.add((dst, src))

    def heal(self, src: str | None = None, dst: str | None = None,
             *, bidir: bool = False) -> None:
        """Remove one directed partition (or, with no arguments, all)."""
        if src is None and dst is None:
            self._partitions.clear()
            return
        self._partitions.discard((src, dst))
        if bidir:
            self._partitions.discard((dst, src))

    def _blocked(self, src: str, dst: str) -> bool:
        p = self._partitions
        return (src, dst) in p or (src, "*") in p or ("*", dst) in p

    def slow(self, endpoint: str, extra: float) -> None:
        """Gray failure: add ``extra`` seconds of one-way latency to every
        message ``endpoint`` sends or receives, until :meth:`unslow`."""
        self._gray[endpoint] = float(extra)

    def unslow(self, endpoint: str) -> None:
        self._gray.pop(endpoint, None)

    def stuck_ops(self) -> list[dict]:
        """Diagnostics for the forever-pending-future leak (ISSUE 10
        satellite): every quorum/alive round still waiting for replies.
        Non-empty after the event queue drains means an op is stranded."""
        out = []
        for state in self._waiting.values():
            if state.resumed:
                continue
            fut = state.fut
            out.append({
                "op_id": fut.op_id,
                "kind": fut.kind,
                "client": fut.client,
                "need": state.need,
                "have": sorted(state.replies),
                "alive_mode": state.alive,
            })
        return out

    # -- event loop ------------------------------------------------------------
    def schedule(
        self, delay: float, fn: Callable[[], None], key: tuple | None = None
    ) -> None:
        # clamp: a negative (or NaN) delay must not reorder virtual time —
        # events fire no earlier than now (ISSUE 7).
        t = self.now + delay if delay > 0.0 else self.now
        s = self._seq
        self._seq = s + 1
        ctrl = self.controller
        if ctrl is not None:
            # ``key`` labels what the event touches — ("srv", sid, client)
            # for arrivals, ("rpl", None, client) for reply deliveries,
            # ("cli", None, client) for op resumes/timers, ("snd", None,
            # client) for RNG-drawing fan-out sends, None = conservative
            # "conflicts with everything".
            ctrl.note(s, key)
        heapq.heappush(self._events, (t, s, fn))

    def run(self, until: float | None = None, max_events: int = 50_000_000) -> None:
        limit = math.inf if until is None else until
        prev = self._run_limit
        self._run_limit = limit
        events = self._events
        n = 0
        ctrl = self.controller
        try:
            if ctrl is not None:
                # controlled mode: the controller picks which pending event
                # fires (and may drop it); the ``until`` window is judged on
                # the earliest pending time, same as the uncontrolled loop.
                while events and n < max_events:
                    if events[0][0] > limit:
                        break
                    if not ctrl.step(self):
                        break
                    n += 1
            else:
                while events and n < max_events:
                    t, _, fn = events[0]
                    if t > limit:
                        break
                    heapq.heappop(events)
                    self.now = t
                    self.events_processed += 1
                    fn()
                    n += 1
        finally:
            self._run_limit = prev
        if n >= max_events:  # pragma: no cover
            raise RuntimeError("simulator event budget exhausted (livelock?)")

    def step(self) -> bool:
        """Pop and run ONE event; False when the queue is empty. Lets callers
        (``api.OpFuture.result``) drive the loop until a condition holds
        without running unrelated traffic — e.g. a repair daemon — to
        quiescence."""
        ctrl = self.controller
        if ctrl is not None:
            return bool(self._events) and ctrl.step(self)
        if not self._events:
            return False
        t, _, fn = heapq.heappop(self._events)
        self.now = t
        self.events_processed += 1
        fn()
        return True

    # -- accounting ------------------------------------------------------------
    def _intern(self, endpoint: str) -> int:
        """Stable small-int id for an endpoint name; grows the flat
        accounting/busy arrays on demand (indices stay valid across growth)."""
        idx = self._ep_idx.get(endpoint)
        if idx is None:
            idx = len(self._ep_idx)
            self._ep_idx[endpoint] = idx
            if idx >= len(self._acct):
                self._acct.extend([0, 0, 0] for _ in range(len(self._acct)))
                self._busy_out.extend([0.0] * len(self._busy_out))
                self._busy_in.extend([0.0] * len(self._busy_in))
        return idx

    def _acct_rows(self, client: str) -> tuple[str, Any]:
        """Resolved accounting target for RPCs issued by ``client``: its own
        row plus any attributed riders' rows (captured at issue time, like
        the legacy path's ``setdefault`` list — late replies keep crediting
        the riders of the round that sent them)."""
        entry = self._rows_cache.get(client)
        if entry is None:
            i = self._intern(client)
            self._known_clients[client] = None
            riders = self.client_attribution.get(client)
            if riders:
                for r in riders:
                    self._known_clients[r] = None
                entry = ("m", (i, *(self._intern(r) for r in riders)))
            else:
                entry = ("s", i)
            self._rows_cache[client] = entry
        return entry

    def _acct_add(self, rows: tuple[str, Any], dr: int, dm: int, db: int) -> None:
        kind, v = rows
        a = self._acct
        if kind == "s":
            row = a[v]
            if dr:
                row[0] += dr
            if dm:
                row[1] += dm
                row[2] += db
        else:
            for i in v:
                row = a[i]
                if dr:
                    row[0] += dr
                if dm:
                    row[1] += dm
                    row[2] += db

    @property
    def client_counters(self) -> dict[str, list[int]]:
        """Read-only snapshot of per-client [rounds, msgs, bytes] — the
        legacy dict view over the flat accounting array. Mutations to the
        returned dict are NOT written back; use ``client_totals``."""
        a = self._acct
        out = {}
        for c in self._known_clients:
            out[c] = list(a[self._ep_idx[c]])
        return out

    def client_totals(self, client: str) -> tuple[int, int, int]:
        """(quorum rounds, messages, bytes) attributed to ``client`` so far."""
        i = self._ep_idx.get(client)
        if i is None:
            return (0, 0, 0)
        row = self._acct[i]
        return (row[0], row[1], row[2])

    def attribute(self, endpoint: str, riders=None) -> None:
        """Set (or clear, with ``riders=None``/empty) the attribution map for
        ``endpoint``: while set, counters of every listed rider advance with
        the endpoint's own on each RPC it issues. The gateway tier brackets
        each merged round with this so per-client OpStats stay meaningful."""
        riders = tuple(dict.fromkeys(r for r in (riders or ()) if r != endpoint))
        if riders:
            self.client_attribution[endpoint] = riders
        else:
            self.client_attribution.pop(endpoint, None)
        self._rows_cache.pop(endpoint, None)

    # -- message timing --------------------------------------------------------
    def transmit_delay(self, src: str, dst: str, size: int, deliver: bool = True) -> float:
        """Delay until a message sent NOW from ``src`` is delivered at ``dst``.

        Cut-through at the sender, store-and-forward bookkeeping at both
        NICs: the message occupies ``src``'s uplink and ``dst``'s downlink
        for size/bandwidth each, queuing behind earlier traffic on the same
        endpoint (``serialize_links``). On idle links this reduces exactly to
        the classic ``base + size/bandwidth``. ``deliver=False`` models a
        message lost in flight: the sender's uplink was still consumed, but
        nothing queues at (or arrives to) the receiver."""
        lat = self.latency
        prop = float(self.rng.uniform(lat.base_lo, lat.base_hi))
        return self._transmit_prop(
            self._intern(src), self._intern(dst), size, prop, deliver
        )

    def _transmit_prop(
        self, src_i: int, dst_i: int, size: int, prop: float, deliver: bool
    ) -> float:
        """``transmit_delay`` over interned endpoint ids with the propagation
        draw supplied by the caller (the fan-out paths pool their draws)."""
        lat = self.latency
        tx = size / lat.bandwidth
        if not lat.serialize_links:
            return prop + tx
        bo = self._busy_out
        now = self.now
        b = bo[src_i]
        t_send = now if now > b else b
        bo[src_i] = t_send + tx
        if not deliver:
            return 0.0
        bi = self._busy_in
        t0 = t_send + prop
        b2 = bi[dst_i]
        t_recv = t0 if t0 > b2 else b2
        bi[dst_i] = t_recv + tx
        return (t_recv + tx) - now

    def _wire(self, obj: Any) -> int:
        """Memoized ``msg_wire_size`` (fast path): codec frame size with
        immutable subtrees cached, ``nbytes`` heuristic outside the
        vocabulary."""
        try:
            return self._sizer.wire_size(obj)
        except CodecError:
            return nbytes(obj)

    # -- op driving ------------------------------------------------------------
    def spawn(
        self,
        gen: Generator,
        kind: str = "",
        client: str = "",
        delay: float = 0.0,
        on_done: Callable[[OpFuture], None] | None = None,
    ) -> OpFuture:
        fut = OpFuture(op_id=next(self._op_ids), kind=kind, client=client)
        self.futures.append(fut)

        def start() -> None:
            fut.start = self.now
            self._step(gen, fut, None, on_done)

        self.schedule(delay, start, ("cli", None, client))
        return fut

    def run_op(self, gen: Generator, **kw) -> Any:
        """Convenience: spawn one op, run to quiescence, return its result."""
        fut = self.spawn(gen, **kw)
        self.run()
        if not fut.done:
            raise RuntimeError(f"operation {fut.kind or fut.op_id} did not terminate")
        return fut.result

    # -- internals ------------------------------------------------------------
    def _step(
        self,
        gen: Generator,
        fut: OpFuture,
        send_value: Any,
        on_done: Callable[[OpFuture], None] | None,
        exc: BaseException | None = None,
    ) -> None:
        prof = self.profile_protocol
        if prof:
            t0 = perf_counter()
        try:
            # ``exc`` (ISSUE 10): a typed failure — RpcTimeout from the
            # deadline machinery — is THROWN into the generator at its
            # pending ``yield RPC``. Protocol phase wrappers catch it and
            # yield again (backoff Sleep, then a fresh attempt); the Session
            # tier's _instrumented wrapper catches whatever escapes and fails
            # the OpFuture typed instead of letting it crash the event loop.
            effect = gen.throw(exc) if exc is not None else gen.send(send_value)
        except StopIteration as stop:
            if prof:
                self.protocol_time += perf_counter() - t0
            fut.done = True
            fut.end = self.now
            fut.result = stop.value
            if on_done is not None:
                on_done(fut)
            return
        if prof:
            self.protocol_time += perf_counter() - t0
        if isinstance(effect, Sleep):
            self.schedule(
                effect.duration,
                lambda: self._step(gen, fut, None, on_done),
                ("cli", None, fut.client),
            )
        elif isinstance(effect, RPC):
            self._run_rpc(effect, gen, fut, on_done)
        elif isinstance(effect, Join):
            n = len(effect.children)
            if n == 0:
                self.schedule(
                    0.0,
                    lambda: self._step(gen, fut, [], on_done),
                    ("cli", None, fut.client),
                )
                return
            results = [None] * n
            state = {"left": n}

            def make_done(i):
                def done(child_fut):
                    results[i] = child_fut.result
                    state["left"] -= 1
                    if state["left"] == 0:
                        self._step(gen, fut, results, on_done)
                return done

            for i, child in enumerate(effect.children):
                self.spawn(child, client=fut.client, on_done=make_done(i))
        else:  # pragma: no cover
            raise TypeError(f"unknown effect {effect!r}")

    def _run_rpc(
        self,
        rpc: RPC,
        gen: Generator,
        fut: OpFuture,
        on_done: Callable[[OpFuture], None] | None,
    ) -> None:
        self.rpc_rounds += 1
        # the issuing client's account, plus any riders attributed to it
        # (``attribute``): a gateway's merged round counts once per rider.
        acct = self._acct_rows(fut.client)
        self._acct_add(acct, 1, 0, 0)
        if rpc.need == "alive":
            alive_mode = True
            need = sum(
                1
                for sid in rpc.dests
                if (srv := self.servers.get(sid)) is not None and not srv.crashed
            )
            counted = frozenset(
                sid
                for sid in rpc.dests
                if (srv := self.servers.get(sid)) is not None and not srv.crashed
            )
        else:
            alive_mode = False
            need = rpc.need
            counted = frozenset()
        need = min(need, len(rpc.dests))
        san = self.sanitizer
        if san is not None:
            san.on_rpc(rpc, None if alive_mode else need)
        state = _RpcState(
            self, gen, fut, on_done, acct, self._intern(fut.client),
            need, alive_mode, counted,
        )
        rt = self.race_tracker
        if rt is not None:
            rt.on_issue(state, rpc)
        # stuck-op bookkeeping (ISSUE 10): every round registers here and
        # deregisters on resume; whatever remains after the queue drains is a
        # stranded op — see stuck_ops(). Dict insert/pop only, no events.
        self._waiting[id(state)] = state
        send = self._fast_send if self.fast_rpc else self._legacy_send
        # "snd" events draw pooled RNG and touch shared NIC state: the
        # controller treats them as conflicting with everything.
        self.schedule(rpc.pre_delay, partial(send, rpc, state),
                      ("snd", None, fut.client))
        if need <= 0:
            # nothing can (or needs to) reply — messages still go out, but the
            # op resumes immediately with no replies (guarded against a
            # straggler reply re-resuming the generator).
            self.schedule(rpc.pre_delay, state.resume_empty,
                          ("cli", None, fut.client))
            return
        policy = self.retry
        if policy is not None and not alive_mode:
            # arm the per-attempt deadline chain. Quorum mode only: alive
            # mode structurally cannot hang (crashes/drops shrink ``need``),
            # and its rounds are fire-and-mostly-forget daemon traffic.
            state.rpc = rpc
            state.attempt = 1
            self._arm_timer(state, policy, rpc.pre_delay)

    # -- retry / deadline machinery (ISSUE 10) --------------------------------
    def _arm_timer(self, state: _RpcState, policy: RetryPolicy,
                   extra: float) -> None:
        att = state.attempt
        timeout = policy.rpc_timeout * (policy.backoff ** (att - 1))
        if policy.jitter > 0.0:
            # seeded jitter from the dedicated stream: deterministic, and
            # drawn only when a policy is armed (ablation draws nothing).
            timeout *= 1.0 + policy.jitter * float(self._retry_rng.random())
        self.schedule(extra + timeout, partial(self._rpc_deadline, state, att),
                      ("cli", None, state.fut.client))
        if att == 1 and policy.hedge_after is not None:
            self.schedule(extra + policy.hedge_after,
                          partial(self._rpc_hedge, state),
                          ("cli", None, state.fut.client))

    def _rpc_deadline(self, state: _RpcState, att: int) -> None:
        # stale-timer guard: the round resumed, or a retransmission already
        # superseded this attempt generation — this timer is a no-op.
        if state.resumed or state.attempt != att:
            return
        policy = self.retry
        if policy is None or att >= policy.max_attempts:
            self.rpc_timeouts += 1
            self._waiting.pop(id(state), None)
            state.resumed = True
            fut = state.fut
            missing = [s for s in state.rpc.dests if s not in state.replies]
            err = RpcTimeout(
                f"{fut.kind or 'op'}({fut.client}): {len(state.replies)}/"
                f"{state.need} replies after {att} attempt(s); "
                f"no reply from {missing}"
            )
            self._step(state.gen, fut, None, state.on_done, exc=err)
            return
        state.attempt = att + 1
        self.retransmits += 1
        self._resend(state)
        self._arm_timer(state, policy, 0.0)

    def _rpc_hedge(self, state: _RpcState) -> None:
        # hedged duplicate send: still in attempt 1, not yet resumed, fire
        # once — re-send to the laggards without burning a retry attempt.
        if state.resumed or state.attempt != 1 or state.hedged:
            return
        state.hedged = True
        self.hedges += 1
        self._resend(state)

    def _resend(self, state: _RpcState) -> None:
        """Idempotent retransmission: re-send the ORIGINAL payload to the
        destinations that have not replied. Replies are keyed by server id
        client-side and handlers are guarded server-side, so a duplicate
        cannot double-count a quorum or regress protocol state."""
        rpc = state.rpc
        missing = tuple(s for s in rpc.dests if s not in state.replies)
        if not missing:
            return
        per = None if rpc.per_dest is None else {
            s: rpc.per_dest[s] for s in missing
        }
        dup = RPC(dests=missing, msg=rpc.msg, need=state.need, per_dest=per)
        send = self._fast_send if self.fast_rpc else self._legacy_send
        # same _RpcState: no new sanitizer round, no rpc_rounds bump — this
        # is wire-level amplification of the SAME protocol round (it shows
        # up in msg_count/bytes_sent and the retransmits counter).
        self.schedule(0.0, partial(send, dup, state),
                      ("snd", None, state.fut.client))

    # Both send paths share one canonical RNG schedule per fan-out over the B
    # destinations that exist: 2B latency props from ``rng`` (outbound then
    # reply, destination order), then — only when drop_prob > 0 — 2B drop
    # draws from ``_drop_rng`` in the same layout. The fast path draws them
    # as two vectors; the legacy path draws the SAME values as 2B scalars
    # (numpy Generator streams are bit-identical either way), so the two
    # engines replay identical traces while paying very different driver
    # costs.

    def _fast_send(self, rpc: RPC, state: _RpcState) -> None:
        lat = self.latency
        dests = rpc.dests
        cache = self._dest_cache
        ent = cache.get(id(dests))
        if ent is not None and ent[0] is dests:
            sids, srvs, didx = ent[1], ent[2], ent[3]
        else:
            servers = self.servers
            sids = []
            srvs = []
            for sid in dests:
                srv = servers.get(sid)
                if srv is not None:
                    sids.append(sid)
                    srvs.append(srv)
            didx = [self._intern(s) for s in sids]
            if type(dests) is tuple:  # lists may mutate: never cache them
                if len(cache) >= 4096:
                    cache.clear()
                cache[id(dests)] = (dests, sids, srvs, didx)
        B = len(sids)
        if B == 0:
            return
        # frame sizes (broadcasts sized once) + bulk accounting
        if rpc.per_dest is None:
            msgs = None
            sizes = None
            shared = self._wire(rpc.msg)
            total = shared * B
        else:
            msgs = [rpc.per_dest[sid] for sid in sids]
            sizes = [self._wire(m) for m in msgs]
            shared = 0
            total = sum(sizes)
        self.msg_count += B
        self.bytes_sent += total
        self._acct_add(state.acct, 0, B, total)
        # pooled draws (canonical stream, see above); everything downstream is
        # scalar arithmetic — at quorum-sized fan-outs (B ~ 5-15) a Python
        # loop over the pooled values beats vector ops, and it replays the
        # legacy path's per-message float sequence *by construction*.
        props = self.rng.uniform(lat.base_lo, lat.base_hi, 2 * B).tolist()
        p = lat.drop_prob
        flags = (self._drop_rng.random(2 * B) < p).tolist() if p > 0.0 else None
        dp = lat.dup_prob
        dups = (self._dup_rng.random(B) < dp).tolist() if dp > 0.0 else None
        client_ep = state.fut.client
        # gray failures (deterministic, no draws): pad the outbound
        # propagation samples; the reply direction pads rdelay in _process.
        gray = self._gray
        if gray:
            gc = gray.get(client_ep, 0.0)
            for j in range(B):
                g = gc + gray.get(sids[j], 0.0)
                if g:
                    props[j] += g
        # outbound loss = drop-RNG flag OR asymmetric partition block. The
        # merged ``lost`` view drives filtering; ``flags`` keeps feeding the
        # reply-drop half so the canonical draw layout never changes.
        if self._partitions:
            blk = [self._blocked(client_ep, s) for s in sids]
            if True not in blk:
                blk = None
        else:
            blk = None
        if blk is None:
            lost = flags  # 2B when drops on (first half read), else None
        elif flags is None:
            lost = blk
        else:
            lost = [flags[j] or blk[j] for j in range(B)]
        now = self.now
        bw = lat.bandwidth
        serialize = lat.serialize_links
        bi = self._busy_in
        if serialize:
            # sender uplink: each message queues behind the previous one;
            # ``busy`` never falls below ``now`` after the first max, so
            # hoisting the max out of the loop is exact.
            bo = self._busy_out
            src_i = state.src_i
            busy = bo[src_i]
            if now > busy:
                busy = now
        arr: list[float] = []
        if lost is None:
            # no losses (the common case): every message is delivered, so the
            # destination views ARE the originals — only arrivals to compute
            for j in range(B):
                tx = (shared if sizes is None else sizes[j]) / bw
                if serialize:
                    t_send = busy
                    busy = t_send + tx
                    t0 = t_send + props[j]
                    di = didx[j]
                    b2 = bi[di]
                    t_recv = t0 if t0 > b2 else b2
                    done = t_recv + tx
                    bi[di] = done
                    delay = done - now
                else:
                    delay = props[j] + tx
                arr.append(now + delay if delay > 0.0 else now)
            d_sids, d_srvs, d_msgs, d_didx = sids, srvs, msgs, didx
            d_rprops = props[B:]
            d_rdrop = None
            d_dups = dups
        else:
            # delivered arrivals (outbound losses still consume the uplink)
            d_sids = []
            d_srvs = []
            d_msgs = None if msgs is None else []
            d_didx = []
            d_rprops = []
            d_rdrop = None if flags is None else []
            d_dups = None if dups is None else []
            for j in range(B):
                tx = (shared if sizes is None else sizes[j]) / bw
                if serialize:
                    t_send = busy
                    busy = t_send + tx
                if lost[j]:
                    continue
                if serialize:
                    t0 = t_send + props[j]
                    di = didx[j]
                    b2 = bi[di]
                    t_recv = t0 if t0 > b2 else b2
                    done = t_recv + tx
                    bi[di] = done
                    delay = done - now
                else:
                    delay = props[j] + tx
                arr.append(now + delay if delay > 0.0 else now)
                d_sids.append(sids[j])
                d_srvs.append(srvs[j])
                if d_msgs is not None:
                    d_msgs.append(msgs[j])
                d_didx.append(didx[j])
                d_rprops.append(props[B + j])
                if d_rdrop is not None:
                    d_rdrop.append(flags[B + j])
                if d_dups is not None:
                    d_dups.append(dups[j])
        if serialize:
            bo[src_i] = busy
        # duplicated request frames (dup_prob): the extra copy of each
        # delivered, dup-flagged message is charged on the wire here; the
        # handler re-runs at arrival time and its reply is discarded.
        if dups is not None:
            ndup = 0
            dbytes = 0
            for j in range(B):
                if dups[j] and (lost is None or not lost[j]):
                    ndup += 1
                    dbytes += shared if sizes is None else sizes[j]
            if ndup:
                self.msg_count += ndup
                self.bytes_sent += dbytes
                self._acct_add(state.acct, 0, ndup, dbytes)
        nd = len(arr)
        if nd == 0:
            self._abandon_drops(state, sids, lost)
            return
        # reserve the arrival sequence numbers the legacy path would have
        # consumed (contiguous, destination order) and enter the heap at the
        # earliest arrival only.
        seq0 = self._seq
        self._seq = seq0 + nd
        ctrl = self.controller
        if ctrl is not None:
            client = state.fut.client
            for j in range(nd):
                ctrl.note(seq0 + j, ("srv", d_sids[j], client))
        order = [0] if nd == 1 else sorted(range(nd), key=arr.__getitem__)
        fan = _FanOut(
            self, state, d_sids, d_srvs, d_msgs,
            rpc.msg if msgs is None else None,
            d_didx, d_rprops, d_rdrop, d_dups, arr, order, seq0,
        )
        j0 = order[0]
        heapq.heappush(self._events, (arr[j0], seq0 + j0, fan.fire))
        self._abandon_drops(state, sids, lost)

    def _abandon_drops(self, state: _RpcState, sids: list[str], lost) -> None:
        """alive-mode bookkeeping for outbound losses — drops or partition
        blocks (after arrival seqs are reserved, so resume-triggered
        schedules order identically on both paths)."""
        if lost is None or not state.alive:
            return
        for j, sid in enumerate(sids):
            if lost[j]:
                state.abandon(sid)

    def _legacy_send(self, rpc: RPC, state: _RpcState) -> None:
        """Seed-style per-destination send: one closure + heap entry + scalar
        RNG draws + un-memoized codec walk per message. Kept as the ablation
        baseline (``fast=False`` / ``DSSParams.fast_net=False``); draws the
        same canonical per-fan-out stream as the fast path so traces are
        bit-identical — it just pays the seed implementation's per-message
        costs to earn them."""
        lat = self.latency
        pairs = [
            (sid, srv)
            for sid in rpc.dests
            if (srv := self.servers.get(sid)) is not None
        ]
        B = len(pairs)
        if B == 0:
            return
        lo, hi = lat.base_lo, lat.base_hi
        oprops = [float(self.rng.uniform(lo, hi)) for _ in range(B)]
        rprops = [float(self.rng.uniform(lo, hi)) for _ in range(B)]
        p = lat.drop_prob
        if p > 0.0:
            odrop = [bool(self._drop_rng.random() < p) for _ in range(B)]
            rdrop = [bool(self._drop_rng.random() < p) for _ in range(B)]
        else:
            odrop = rdrop = None
        dp = lat.dup_prob
        if dp > 0.0:
            dup = [bool(self._dup_rng.random() < dp) for _ in range(B)]
        else:
            dup = None
        shared = msg_wire_size(rpc.msg) if rpc.per_dest is None else None
        client = state.fut.client
        src_i = state.src_i
        gray = self._gray
        parted = bool(self._partitions)
        dropped_sids: list[str] = []
        for j, (sid, srv) in enumerate(pairs):
            msg = rpc.msg if rpc.per_dest is None else rpc.per_dest[sid]
            size = shared if shared is not None else msg_wire_size(msg)
            self.msg_count += 1
            self.bytes_sent += size
            self._acct_add(state.acct, 0, 1, size)
            lost = (odrop is not None and odrop[j]) or (
                parted and self._blocked(client, sid)
            )
            oprop = oprops[j]
            if gray:
                oprop += gray.get(client, 0.0) + gray.get(sid, 0.0)
            delay = self._transmit_prop(
                src_i, self._intern(sid), size, oprop, not lost
            )
            if lost:
                dropped_sids.append(sid)
                continue
            if dup is not None and dup[j]:
                self.msg_count += 1
                self.bytes_sent += size
                self._acct_add(state.acct, 0, 1, size)

            def arrive(
                srv=srv,
                sid=sid,
                msg=msg,
                rprop=rprops[j],
                rlost=rdrop is not None and rdrop[j],
                dupped=dup is not None and dup[j],
            ) -> None:
                ctrl = self.controller
                if ctrl is not None and ctrl.consume_drop():
                    state.abandon(sid)
                    return
                if srv.crashed:
                    state.abandon(sid)
                    return
                rt = self.race_tracker
                if rt is not None:
                    rt.before_handle(sid, state)
                if self.profile_protocol:
                    t0 = perf_counter()
                    reply = srv.handle(client, msg)
                    self.protocol_time += perf_counter() - t0
                else:
                    reply = srv.handle(client, msg)
                if rt is not None:
                    rt.after_handle(sid)
                if dupped:
                    # duplicate delivery — see _FanOut._process
                    if rt is not None:
                        rt.before_handle(sid, state)
                    srv.handle(client, msg)
                    if rt is not None:
                        rt.after_handle(sid)
                if reply is None:
                    state.abandon(sid)
                    return
                if self.sanitizer is not None:
                    self.sanitizer.on_reply(sid, msg, reply)
                rsize = msg_wire_size(reply)
                self.msg_count += 1
                self.bytes_sent += rsize
                self._acct_add(state.acct, 0, 1, rsize)
                rdeliver = not rlost and not (
                    self._partitions and self._blocked(sid, client)
                )
                rdelay = lat.server_compute + self._transmit_prop(
                    self._intern(sid), src_i, rsize, rprop, rdeliver
                )
                if not rdeliver:
                    state.abandon(sid)
                    return
                g = self._gray
                if g:
                    rdelay += g.get(sid, 0.0) + g.get(client, 0.0)
                self.schedule(rdelay, lambda: state.deliver(sid, reply),
                              ("rpl", None, client))

            self.schedule(delay, arrive, ("srv", sid, client))
        for sid in dropped_sids:
            state.abandon(sid)
