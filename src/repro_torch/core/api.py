"""Session/future client API with cross-file batched scheduling (ISSUE 3).

The public surface used to be "build a generator op, thread it through
``dss.net.run_op``, scrape whatever dict it returns". That drives ONE
operation at a time, so the PR-2 state-transfer engine — which batches all
blocks of one file into single quorum rounds — still pays O(F) quorum
rounds when a workload touches F files. This module replaces that surface:

* :class:`Session` — the per-client handle. ``submit(op)`` runs any raw
  generator op; ``write``/``read``/``recon``/``stat`` are the conveniences.
  Every call returns immediately with an :class:`OpFuture`.
* **Cross-file aggregation**: convenience ops do NOT dispatch one generator
  each. They queue as intents, and a per-session scheduler drains the queue
  after ``window`` virtual seconds: consecutive same-kind intents coalesce
  into ONE multi-file batch op (``ClientHandle.read_batch`` etc.), which
  rides the engine's multi-object RPCs. Config discovery, max-tag gathers
  and put-until-stable rounds for different FILES thus share the same
  ``read-next-batch``/``ec-query-batch``/``ec-put-batch`` fan-outs — an
  F-file fan-out completes in O(1) quorum rounds instead of O(F)
  (``benchmarks/bench_multifile.py`` measures exactly this).
* :class:`OpStats` — every future carries uniform stats (quorum rounds,
  messages, bytes, virtual-time latency, blocks) measured from the
  network's per-client counters, so benchmarks and tests stop scraping
  heterogeneous result dicts. Coalesced ops share their batch's totals
  (``batched_with`` says how many rode along).
* :class:`Workload` / :func:`gather` — run any mix of operations from any
  number of clients concurrently on the virtual-time network and collect
  results in submission order.

The old surface (``dss.client(cid)`` + ``dss.net.run_op``) keeps working as
a deprecation shim — the Session drives those same ``ClientHandle``
generator ops underneath — but new code and the examples use this API.

Program order note: intents of ONE session coalesce only within a same-kind
run, so ``write(f); read(f)`` from the same session still executes the
write group before the read group. Ops from different sessions are
concurrent, exactly like the paper's independent clients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generator

from repro_torch.core.tags import Config
from repro_torch.net.sim import DeadlineExceeded


@dataclass
class OpStats:
    """Uniform per-operation accounting (ISSUE 3).

    ``rounds``/``msgs``/``bytes`` come from the network's per-client
    counters — under a coalesced batch they are the BATCH's totals, shared
    by all ``batched_with`` riders (charging each rider the full fan-out
    would multi-count shared rounds; dividing would hide them). The same
    interval semantics apply to any ops of ONE client that overlap in
    virtual time (e.g. two concurrent ``submit`` loops): each op's stats
    include the client's traffic during its lifetime, so summing stats
    across overlapping same-client futures over-counts — sum
    ``Network.client_totals`` deltas instead for whole-workload totals."""

    rounds: int = 0
    msgs: int = 0
    bytes: int = 0
    latency: float = 0.0
    blocks: int = 0
    batched_with: int = 1
    # RPC retransmissions observed network-wide during this op's lifetime
    # (ISSUE 10). Coarse under concurrency — like rounds/msgs it is an
    # interval delta, so overlapping ops share amplification — but exact in
    # the common single-op-probe case and always 0 with retries disabled.
    retries: int = 0


class OpFuture:
    """Handle to an in-flight Session operation (concurrent.futures style:
    ``done()`` / ``result()``; ``result`` drives the event loop only as far
    as needed, so background daemons never block completion)."""

    def __init__(self, session: "Session", kind: str, fid: str | None):
        self.session = session
        self.kind = kind
        self.fid = fid
        self.client = session.cid
        self.stats: OpStats | None = None
        self._done = False
        self._result: Any = None
        self._error: BaseException | None = None

    # virtual-time deadline for ``result()`` when neither the caller nor an
    # active RetryPolicy (``op_deadline``) supplies one (ISSUE 10 — replaces
    # the old magic 50M-event budget with a real deadline error).
    DEFAULT_DEADLINE = 60.0

    def done(self) -> bool:
        return self._done

    def exception(self) -> BaseException | None:
        """What the operation raised, if it failed — ``None`` while pending
        or on success (concurrent.futures parity; lets a workload tally
        failures without re-raising through ``result``)."""
        return self._error

    def result(self, deadline: float | None = None) -> Any:
        """Step the virtual-time network until this operation completes,
        then return its result (or raise what the operation raised).

        ``deadline`` bounds how far VIRTUAL time may advance past the call
        (default: the active ``RetryPolicy.op_deadline``, else
        ``DEFAULT_DEADLINE``). A blown deadline — quorum lost with retries
        disabled, or only background traffic left — raises
        :class:`DeadlineExceeded` carrying ``Network.stuck_ops()``
        diagnostics instead of spinning on an event budget."""
        net = self.session.net
        if deadline is None:
            policy = getattr(net, "retry", None)
            deadline = policy.op_deadline if policy is not None \
                else self.DEFAULT_DEADLINE
        t0 = net.now
        while not self._done and net.step():
            if net.now - t0 > deadline:
                raise DeadlineExceeded(
                    f"{self.kind}({self.fid!r}) missed its {deadline}s "
                    f"virtual deadline; stuck rounds: {net.stuck_ops()!r}"
                )
        if not self._done:
            raise DeadlineExceeded(
                f"{self.kind}({self.fid!r}): network quiesced without "
                f"completing it; stuck rounds: {net.stuck_ops()!r}"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: Any, stats: OpStats) -> None:
        self._result = result
        self.stats = stats
        self._done = True

    def _fail(self, err: BaseException, stats: OpStats | None = None) -> None:
        self._error = err
        self.stats = stats
        self._done = True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "done" if self._done else "pending"
        return f"OpFuture({self.kind}, {self.fid!r}, {state})"


@dataclass
class _Intent:
    kind: str
    fid: str | None
    arg: Any
    fut: OpFuture


def _dispatch_group(handle, group: list[_Intent]) -> Generator:
    """Issue ONE merged batch operation for a same-kind intent group and
    return ``(payload, blocks)`` — ``payload[fid]`` is what each future
    resolves to, ``blocks[fid]`` feeds ``OpStats.blocks``. Shared by the
    Session scheduler and the gateway tier so the per-kind payload shapes
    can never diverge between the direct and aggregated paths. Repeated
    fids (a gateway merging same-file intents from several clients)
    dedupe here; the result is multicast by resolving every intent from
    the one payload entry."""
    kind = group[0].kind
    fids = list(dict.fromkeys(it.fid for it in group))
    if kind == "read":
        res = yield from handle.read_batch(fids)
        return ({f: content for f, (content, _n) in res.items()},
                {f: n for f, (_c, n) in res.items()})
    if kind == "write":
        res = yield from handle.update_batch({it.fid: it.arg for it in group})
        return res, {f: s["blocks"] for f, s in res.items()}
    if kind == "recon":
        # recon futures resolve to a real result dict; the raw {fid: n}
        # map feeds OpStats.blocks only (it used to be BOTH the payload
        # and the stats source, so the future's "result" was a bare
        # aliased int — ISSUE 4)
        res = yield from handle.recon_batch(fids, group[0].arg)
        payload = {
            f: {"blocks": n, "config": group[0].arg.cfg_id, "success": True}
            for f, n in res.items()
        }
        return payload, dict(res)
    res = yield from handle.stat_batch(fids)  # stat
    return res, {f: s["blocks"] for f, s in res.items()}


class Session:
    """Per-client handle of the submit/future API.

    ``window`` is the virtual-time coalescing window: convenience ops
    submitted within one window drain together and same-kind runs ride one
    multi-file batch. The default (0.5 ms virtual) sits under the sim's base
    RTT, so batching never costs a visible latency hit; ``window=0.0``
    still coalesces ops submitted back-to-back from ordinary Python code
    (virtual time only advances inside ``net.run``/``step``).

    ``via`` attaches the session to a :class:`repro_torch.core.gateway.Gateway`
    (ISSUE 4): convenience ops are then forwarded to the gateway, which
    coalesces them with in-flight intents from OTHER clients and issues one
    merged storage round on everyone's behalf (same-file reads from C
    clients dedupe to a single quorum fan-out). Raw ``submit`` ops always
    run directly under this session's own endpoint."""

    def __init__(self, dss, cid: str, *, window: float = 0.5e-3, via=None):
        self.dss = dss
        self.cid = cid
        self.net = dss.net
        self._handle = None  # built on first use (ISSUE 7): a gateway-
        # attached session that only issues convenience ops never needs its
        # own protocol client, and at 10^5 sessions eager construction is
        # most of the setup cost.
        self.window = window
        self.via = via
        if via is not None and via.net is not self.net:
            raise ValueError(
                f"gateway {via.gid!r} lives on a different Network than "
                f"session {cid!r}"
            )
        self._pending: list[_Intent] = []
        self._drain_scheduled = False

    @property
    def handle(self):
        """This session's own protocol client (lazily constructed)."""
        if self._handle is None:
            self._handle = self.dss.client(self.cid)
        return self._handle

    # ------------------------------------------------------------- raw ops
    def submit(self, op: Generator, *, kind: str = "op",
               fid: str | None = None) -> OpFuture:
        """Run an arbitrary generator op (e.g. a scripted loop driving
        ``self.handle``) under this session; returns its OpFuture. Raw
        submissions are NOT coalesced — they run as their own op."""
        fut = OpFuture(self, kind, fid)
        self.net.spawn(
            self._instrumented(op, fut, None), kind=kind, client=self.cid
        )
        return fut

    def _instrumented(self, op: Generator, fut: OpFuture,
                      blocks: int | None) -> Generator:
        r0, m0, b0 = self.net.client_totals(self.cid)
        t0 = self.net.now
        x0 = self.net.retransmits
        try:
            res = yield from op
        except Exception as err:  # noqa: BLE001 - delivered via the future
            fut._fail(err, self._delta(r0, m0, b0, t0, 0, 1, x0))
            return None
        fut._resolve(res, self._delta(r0, m0, b0, t0, blocks or 0, 1, x0))
        return res

    def _delta(self, r0, m0, b0, t0, blocks, width, x0=0) -> OpStats:
        r1, m1, b1 = self.net.client_totals(self.cid)
        return OpStats(rounds=r1 - r0, msgs=m1 - m0, bytes=b1 - b0,
                       latency=self.net.now - t0, blocks=blocks,
                       batched_with=width,
                       retries=self.net.retransmits - x0)

    # ------------------------------------------------------- convenience ops
    def write(self, fid: str, content: bytes) -> OpFuture:
        return self._enqueue("write", fid, content)

    def read(self, fid: str) -> OpFuture:
        return self._enqueue("read", fid, None)

    def recon(self, fid: str, new_config: Config) -> OpFuture:
        return self._enqueue("recon", fid, new_config)

    def stat(self, fid: str) -> OpFuture:
        """Per-object reliability: resolves to a dict with the surviving-
        fragment ``margin`` of the file's weakest block (see
        ``ClientHandle.stat_batch``)."""
        return self._enqueue("stat", fid, None)

    def _enqueue(self, kind: str, fid: str, arg: Any) -> OpFuture:
        fut = OpFuture(self, kind, fid)
        if self.via is not None:
            self.via._enqueue(_Intent(kind, fid, arg, fut))
            return fut
        self._pending.append(_Intent(kind, fid, arg, fut))
        if not self._drain_scheduled:
            self._drain_scheduled = True
            self.net.spawn(
                self._drain(), kind="session-drain", client=self.cid,
                delay=self.window,
            )
        return fut

    # ---------------------------------------------------------- the scheduler
    def _groups(self, batch: list[_Intent]) -> list[list[_Intent]]:
        """Maximal runs of consecutive same-kind intents — program order is
        preserved across kind changes. A run also breaks on a repeated fid
        (two writes to one file must stay two operations) and, for recons,
        on a different target configuration."""
        groups: list[list[_Intent]] = []
        fids: set = set()  # fids of the current (last) group, O(1) break check
        for it in batch:
            g = groups[-1] if groups else None
            if (
                g is None
                or g[0].kind != it.kind
                or it.fid in fids
                or (it.kind == "recon" and g[0].arg.cfg_id != it.arg.cfg_id)
            ):
                groups.append([it])
                fids = {it.fid}
            else:
                g.append(it)
                fids.add(it.fid)
        return groups

    def _drain(self) -> Generator:
        # NOTE ``_drain_scheduled`` stays armed for the whole drain: an op
        # enqueued while this generator is mid-flight (e.g. from code
        # reacting to an earlier future of the same batch) must NOT spawn a
        # CONCURRENT drain — it would race ahead of this drain's remaining
        # groups and break per-fid program order. The finally block re-arms
        # a fresh drain for anything that arrived meanwhile, so mid-flight
        # enqueues are never stranded either (the old code reset the flag on
        # entry, opening exactly that reorder/reschedule hazard — ISSUE 4).
        try:
            batch, self._pending = self._pending, []
            for group in self._groups(batch):
                r0, m0, b0 = self.net.client_totals(self.cid)
                t0 = self.net.now
                x0 = self.net.retransmits
                try:
                    payload, blocks = yield from _dispatch_group(
                        self.handle, group
                    )
                except Exception as err:  # noqa: BLE001 - delivered via futures
                    stats = self._delta(r0, m0, b0, t0, 0, len(group), x0)
                    for it in group:
                        it.fut._fail(err, stats)
                    continue
                for it in group:
                    it.fut._resolve(
                        payload[it.fid],
                        self._delta(r0, m0, b0, t0, blocks[it.fid],
                                    len(group), x0),
                    )
        finally:
            self._drain_scheduled = False
            if self._pending:
                self._drain_scheduled = True
                self.net.spawn(
                    self._drain(), kind="session-drain", client=self.cid,
                    delay=self.window,
                )
        return None


def gather(*futures: OpFuture) -> list:
    """Drive the (shared) virtual-time network until every future completes;
    returns their results in argument order. Raises the first failure.

    Every future must live on the SAME ``Network``: mixing futures of
    different ``DSS`` instances used to spin one store's event loop waiting
    for an operation that only the *other* store's loop could ever complete
    (burning the event budget before failing obscurely) — detected up front
    now (ISSUE 4)."""
    nets = {id(f.session.net) for f in futures}
    if len(nets) > 1:
        owners = sorted({f"{f.client}:{f.kind}" for f in futures})
        raise ValueError(
            "gather() futures span multiple DSS/Network instances "
            f"({len(nets)} networks across {owners}); gather each store's "
            "futures separately"
        )
    return [f.result() for f in futures]


class Workload:
    """Combinator for a mixed multi-client operation fan-out: one Session
    per client id (lazily created, all on the store's network), every
    convenience call recorded, ``run()`` == ``gather`` over everything
    submitted so far.

        wl = Workload(dss)
        for i, fid in enumerate(files):
            wl.write(f"w{i % 3}", fid, payloads[fid])
        results = wl.run()          # one O(1)-round fan-out per client
    """

    def __init__(self, dss, *, window: float = 0.5e-3, via=None):
        self.dss = dss
        self.window = window
        self.via = via  # optional Gateway: every session attaches through it
        self._sessions: dict[str, Session] = {}
        self.futures: list[OpFuture] = []

    def session(self, cid: str) -> Session:
        s = self._sessions.get(cid)
        if s is None:
            s = self._sessions[cid] = Session(
                self.dss, cid, window=self.window, via=self.via
            )
        return s

    def _track(self, fut: OpFuture) -> OpFuture:
        self.futures.append(fut)
        return fut

    def write(self, cid: str, fid: str, content: bytes) -> OpFuture:
        return self._track(self.session(cid).write(fid, content))

    def read(self, cid: str, fid: str) -> OpFuture:
        return self._track(self.session(cid).read(fid))

    def recon(self, cid: str, fid: str, new_config: Config) -> OpFuture:
        return self._track(self.session(cid).recon(fid, new_config))

    def stat(self, cid: str, fid: str) -> OpFuture:
        return self._track(self.session(cid).stat(fid))

    def submit(self, cid: str, op: Generator, **kw) -> OpFuture:
        return self._track(self.session(cid).submit(op, **kw))

    def run(self) -> list:
        """Complete every tracked future; results in submission order."""
        return gather(*self.futures)
