"""CoARES (§IV, Algorithm 1) + ARES reconfiguration (§III) + static CoABD.

All client operations are sim generators. ``CoAresClient`` maintains, per
object: the configuration sequence ``cseq`` (list of CSeqEntry), the writer's
``version`` tag (coverability state), and the EC-DAPopt local (c.tag, c.val)
pairs (inside ``dap_state``).

State-transfer engine (ISSUE 2)
-------------------------------
CoARES read, write and recon all run the same loop: discover the
configuration sequence, max-tag get-data over the configs μ..ν, put the
winner into the latest configuration, repeat until the sequence is stable.
That loop lives HERE, once, in multi-object batch form:

* ``read_config_batch``  — sequence traversal for N objects; each round one
  ``read-next-batch`` quorum RPC per distinct frontier configuration.
* ``gather_max``         — the μ..ν max-tag sweep, one ``get_data_batch``
  per configuration window entry (module function; the static clients drive
  it over their single fixed configuration).
* ``_put_until_stable``  — batched put-data into the newest configuration,
  re-traversing until no object's sequence grows (Alg 1:22-30).

``cvr_read`` / ``cvr_write`` / ``recon`` are one-element wrappers over the
batch forms, so the fragmented (FM) paths issue O(1) quorum rounds for a
B-block file instead of O(B). ``recon_batch`` finalization also spawns a
background repair pass of the newly installed configuration (the missing
redundancy-restoration step — see ``repro_torch.core.repair``).

Coding backend (ISSUE 6): every DAP this engine builds via ``make_dap``
receives the network handle, and EC DAPs read ``net.coding_backend``
("numpy" | "kernel" | "auto", set by ``DSS`` from
``DSSParams.coding_backend``) and ``net.device`` ("cuda" | "cpu", from
``DSSParams.device``) — so recon state transfer between configurations
decodes/re-encodes on the same GF(256) backend and device as foreground
reads and writes, with no extra plumbing through the engine.
"""
from __future__ import annotations

from typing import Any, Generator, Iterable, Mapping

from repro_torch.core.dap.base import DapClient, make_dap
from repro_torch.core.tags import TAG0, Config, CSeqEntry, F, OpRecord, P, Tag, digest, next_tag
from repro_torch.net.sim import RPC, QuorumUnavailableError, RpcTimeout, Sleep


def _with_phase_retry(net, kind: str, factory) -> Generator:
    """Phase-level retry (ISSUE 10): run ``factory()`` — a fresh generator
    per attempt — re-issuing the WHOLE operation against the then-current
    configuration whenever an RPC round times out, and surface a typed
    :class:`QuorumUnavailableError` (never a hang) once the budget runs dry.

    Re-execution is safe: discover/gather are read-only, and a repeated
    coverable put re-gathers first, so it either re-covers its own surviving
    tag (versions match → a fresh higher tag over the same value) or degrades
    to a read — the per-attempt generator is abandoned mid-flight only at a
    ``yield``, before its history record is written. Retried runs are flagged
    on ``net.op_retries`` so the workload harness relaxes the Wing–Gong
    strict reads-from check (orphan intermediate tags are expected)."""
    policy = net.retry
    if policy is None:
        return (yield from factory())
    attempts = max(1, policy.phase_retries + 1)
    last: Exception | None = None
    for attempt in range(attempts):
        try:
            return (yield from factory())
        except RpcTimeout as err:
            last = err
            if attempt + 1 >= attempts:
                break
            net.op_retries += 1
            # linear backoff with seeded jitter from the retry stream (the
            # RPC tier already did exponential per-attempt backoff; phase
            # re-issues mostly wait out crash-recovery windows).
            backoff = policy.phase_backoff * (attempt + 1)
            backoff *= 1.0 + float(net._retry_rng.random())
            yield Sleep(backoff)
    raise QuorumUnavailableError(
        f"{kind}: no quorum after {attempts} phase attempt(s); last: {last}"
    ) from last


def _register_precode(dap_state: dict, values) -> None:
    """Replace the client's pending batch-encode set: drop stale caches from
    the previous update, then register the new values (singletons and empty
    sets gain nothing from batching and are skipped)."""
    dap_state.pop("_batch_values", None)
    for key in [k for k in dap_state if isinstance(k, tuple) and k[:1] == ("_ecache",)]:
        del dap_state[key]
    vals = {v for v in values if v}
    if len(vals) > 1:
        dap_state["_batch_values"] = vals


def gather_max(daps: list[DapClient], objs: list[str]) -> Generator:
    """State-transfer gather: max-tag get-data over a window of DAPs (one per
    configuration μ..ν; a single-element window for the static algorithms).
    One batched quorum round per configuration, every object riding along.
    Returns ``{obj: (tag, val)}`` — the per-object maximum across the window.
    """
    best: dict[str, tuple[Tag, Any]] = {o: (TAG0, None) for o in objs}
    for dap in daps:
        res = yield from dap.get_data_batch(objs)
        for o, (t, v) in res.items():
            if t >= best[o][0]:
                best[o] = (t, v)
    return best


def apply_coverable(
    version: dict, client_id: str, gathered: Mapping[str, tuple[Tag, Any]],
    updates: Mapping[str, Any],
) -> tuple[dict, dict]:
    """Alg 1:16-21 per object: a writer holding the current version bumps the
    tag and installs its value (chg); a stale writer degrades to a read
    (unchg). Returns ``(results {obj: ((tag, val), flag)}, puts)``."""
    results: dict[str, tuple[tuple[Tag, Any], str]] = {}
    puts: dict[str, tuple[Tag, Any]] = {}
    for o, (tag, val) in gathered.items():
        if version.get(o, TAG0) == tag:
            flag = "chg"
            tag = next_tag(tag, client_id)
            val = updates[o]
        else:
            flag = "unchg"
        version[o] = tag
        puts[o] = (tag, val)
        results[o] = ((tag, val), flag)
    return results, puts


class CoAresClient:
    """A client process (reader / writer / reconfigurer) of CoARES."""

    def __init__(
        self,
        net,
        client_id: str,
        initial_config: Config,
        history: list | None = None,
        *,
        repair_on_recon: bool = True,
        recon_repair_delay: float = 0.0,
        on_recon=None,
    ):
        self.net = net
        self.client_id = client_id
        self.c0 = initial_config
        self.cseq: dict[str, list[CSeqEntry]] = {}
        self.version: dict[str, Tag] = {}   # writer coverability state
        self.dap_state: dict = {}            # EC-DAPopt (c.tag, c.val) per (obj, cfg)
        self.history = history if history is not None else []
        # recon finalization spawns a background repair of the newly installed
        # configuration (after ``recon_repair_delay`` virtual seconds).
        self.repair_on_recon = repair_on_recon
        self.recon_repair_delay = recon_repair_delay
        # recon-finalization callback ``(config, cfg_idx, objs) -> None``:
        # lets observers (the auto-retargeting RepairDaemon, via the DSS
        # notifier) follow reconfigurations without polling the history log.
        self.on_recon = on_recon

    # ------------------------------------------------------------- plumbing
    def _cseq(self, obj: str) -> list[CSeqEntry]:
        return self.cseq.setdefault(obj, [CSeqEntry(self.c0, F)])

    def _dap(self, cfg: Config, idx: int):
        return make_dap(self.net, self.client_id, cfg, idx, self.dap_state)

    def _record(self, **kw) -> None:
        self.history.append(OpRecord(**kw))

    def precode(self, values) -> None:
        """Register the byte values an imminent multi-block update will write.
        EC DAPs batch-encode the whole set with one fused GF(256) matmul on
        first use (bit-identical to per-value encoding, see
        ``RSCode.encode_bytes_batch``); ABD DAPs ignore the hint."""
        _register_precode(self.dap_state, values)

    @staticmethod
    def _groups(objs: list[str], cseqs: dict[str, list[CSeqEntry]]):
        """Group objects whose configuration sequences coincide (the common
        case: every block of a file), so each group shares one DAP window."""
        groups: dict[tuple, list[str]] = {}
        for o in objs:
            key = tuple((e.config.cfg_id, e.status) for e in cseqs[o])
            groups.setdefault(key, []).append(o)
        return list(groups.values())

    # ---------------------------------------------------- config discovery
    def read_config_batch(self, objs: Iterable[str]) -> Generator:
        """Sequence traversal for many objects at once: follow nextC pointers
        from each object's last finalized configuration until no successor is
        announced (§III). Objects sharing a frontier configuration share one
        ``read-next-batch`` quorum RPC per traversal step, so a whole file
        advances in O(len(cseq)) rounds, not O(#blocks · len(cseq)).
        Returns ``{obj: cseq}`` (the same mutable lists ``self.cseq`` holds).
        """
        objs = list(dict.fromkeys(objs))
        cseqs = {o: self._cseq(o) for o in objs}
        frontier = {
            o: max(j for j, e in enumerate(cseqs[o]) if e.status == F) for o in objs
        }
        active = objs
        while active:
            by_cfg: dict[str, list[str]] = {}
            cfg_of: dict[str, Config] = {}
            for o in active:
                cfg = cseqs[o][frontier[o]].config
                by_cfg.setdefault(cfg.cfg_id, []).append(o)
                cfg_of[cfg.cfg_id] = cfg
            advanced: list[str] = []
            for cfg_id, members in by_cfg.items():
                cfg = cfg_of[cfg_id]
                replies = yield RPC(
                    dests=cfg.servers,
                    msg=("read-next-batch", tuple((o, frontier[o]) for o in members)),
                    need=cfg.majority(),
                )
                for pos, o in enumerate(members):
                    nxt = None
                    for r in replies.values():
                        cand = r[1][pos]
                        if cand is None:
                            continue
                        c, status = cand
                        if nxt is None or (status == F and nxt[1] == P):
                            nxt = (c, status)
                    if nxt is None:
                        continue  # traversal done for o
                    cseq, i = cseqs[o], frontier[o]
                    c, status = nxt
                    if i + 1 < len(cseq):
                        # configuration uniqueness: same config; maybe upgrade
                        if status == F and cseq[i + 1].status == P:
                            cseq[i + 1].status = F
                    else:
                        cseq.append(CSeqEntry(c, status))
                    frontier[o] = i + 1
                    advanced.append(o)
            active = advanced
        return cseqs

    def read_config(self, obj: str) -> Generator:
        cseqs = yield from self.read_config_batch((obj,))
        return cseqs[obj]

    # ------------------------------------------------------------ consensus
    def _propose_batch(
        self, objs: list[str], idx: int, cfg_here: Config, value: Config
    ) -> Generator:
        """Single-decree Paxos per object (same index, same deciding
        configuration — c.Con of §II), rounds batched: one ``cons-p1-batch``
        / ``cons-p2-batch`` RPC carries every still-undecided object.
        Returns ``{obj: decided_config}``."""
        maj = cfg_here.majority()
        decided: dict[str, Config] = {}
        todo = list(objs)
        n_attempt = 0
        while todo:
            n_attempt += 1
            ballot = (n_attempt, self.client_id)
            replies = yield RPC(
                dests=cfg_here.servers,
                msg=("cons-p1-batch", tuple(todo), idx, ballot),
                need=maj,
            )
            vals: dict[str, Config] = {}
            ready: list[str] = []
            seen_ballot = 0
            for pos, o in enumerate(todo):
                oks = []
                for r in replies.values():
                    rr = r[1][pos]
                    if rr[0] == "p1-ok":
                        oks.append(rr)
                    else:
                        seen_ballot = max(seen_ballot, rr[1][0])
                if len(oks) >= maj:
                    # adopt the highest previously-accepted value, else our own
                    accepted = [(rr[1], rr[2]) for rr in oks if rr[1] is not None]
                    vals[o] = (
                        max(accepted, key=lambda bv: bv[0])[1] if accepted else value
                    )
                    ready.append(o)
            if ready:
                replies2 = yield RPC(
                    dests=cfg_here.servers,
                    msg=(
                        "cons-p2-batch",
                        tuple((o, vals[o]) for o in ready),
                        idx,
                        ballot,
                    ),
                    need=maj,
                )
                for pos, o in enumerate(ready):
                    acks = sum(
                        1 for r in replies2.values() if r[1][pos][0] == "p2-ok"
                    )
                    if acks >= maj:
                        decided[o] = vals[o]
            todo = [o for o in todo if o not in decided]
            if todo:
                n_attempt = max(n_attempt, seen_ballot)
                yield Sleep(float(self.net.rng.uniform(0.5e-3, 3e-3)) * n_attempt)
        return decided

    def _propose(self, obj: str, idx: int, cfg_here: Config, value: Config) -> Generator:
        decided = yield from self._propose_batch([obj], idx, cfg_here, value)
        return decided[obj]

    # --------------------------------------------------- transfer internals
    def _gather_grouped(self, objs: list[str], cseqs: dict) -> Generator:
        """μ..ν max-tag sweep per cseq-group (Alg 1:12-15): groups objects by
        configuration sequence, builds each group's DAP window, and drives the
        plain ``gather_max`` over it — always call THIS inside the client, not
        the module-level function (which knows nothing about cseq windows)."""
        best: dict[str, tuple[Tag, Any]] = {}
        for members in self._groups(objs, cseqs):
            cseq = cseqs[members[0]]
            mu = max(j for j, e in enumerate(cseq) if e.status == F)
            nu = len(cseq) - 1
            daps = [self._dap(cseq[j].config, j) for j in range(mu, nu + 1)]
            best.update((yield from gather_max(daps, members)))
        return best

    def _put_until_stable(
        self, objs: list[str], cseqs: dict, puts: Mapping[str, tuple[Tag, Any]]
    ) -> Generator:
        """Propagate (tag, val) into each object's newest configuration until
        its sequence stops growing (Alg 1:22-30)."""
        pending = list(objs)
        while pending:
            mark: dict[str, int] = {}
            for members in self._groups(pending, cseqs):
                cseq = cseqs[members[0]]
                nu = len(cseq) - 1
                dap = self._dap(cseq[nu].config, nu)
                yield from dap.put_data_batch(
                    [(o, puts[o][0], puts[o][1]) for o in members]
                )
                for o in members:
                    mark[o] = nu
            cseqs.update((yield from self.read_config_batch(pending)))
            pending = [o for o in pending if len(cseqs[o]) - 1 != mark[o]]
        return cseqs

    # ---------------------------------------------------------------- recon
    def recon_batch(self, objs: Iterable[str], new_config: Config) -> Generator:
        """ARES reconfiguration (§III), phase-retried — see
        :meth:`_recon_batch_impl`."""
        objs = list(dict.fromkeys(objs))  # materialize: retries re-iterate
        return (yield from _with_phase_retry(
            self.net, "recon", lambda: self._recon_batch_impl(objs, new_config)
        ))

    def _recon_batch_impl(self, objs: Iterable[str], new_config: Config) -> Generator:
        """ARES reconfiguration (§III) for many objects: traverse, propose
        (batched consensus), transfer (batched μ..ν sweep + one batched put
        into the decided configuration), finalize — then spawn a background
        repair of the newly installed configuration.
        Returns ``{obj: (decided_config, tag, val)}`` — the transferred pair
        rides along so callers (the FM walk) need not re-read each object."""
        t0 = self.net.now
        objs = list(dict.fromkeys(objs))
        out: dict[str, tuple[Config, Tag, Any]] = {}
        if not objs:
            return out
        cseqs = yield from self.read_config_batch(objs)
        for members in self._groups(objs, cseqs):
            cseq = cseqs[members[0]]
            nu = len(cseq) - 1
            last = cseq[nu]
            # 1) agree on the successor of the last configuration
            decided = yield from self._propose_batch(
                members, nu, last.config, new_config
            )
            san = getattr(self.net, "sanitizer", None)
            if san is not None:
                # consensus may have decided a rival proposer's config —
                # register whatever won so the EC-quorum registry stays
                # complete before traffic hits the new configuration
                for o in members:
                    san.register_config(decided[o])
            # 2) announce ⟨decided, P⟩ on a quorum of the last configuration
            yield RPC(
                dests=last.config.servers,
                msg=(
                    "write-next-batch",
                    tuple((o, nu, decided[o], P) for o in members),
                ),
                need=last.config.majority(),
            )
            for o in members:
                if len(cseqs[o]) == nu + 1:
                    cseqs[o].append(CSeqEntry(decided[o], P))
            # 3) transfer the maximum tag-value pair into the new configuration
            mu = max(j for j, e in enumerate(cseq) if e.status == F)
            daps = [self._dap(cseq[j].config, j) for j in range(mu, nu + 1)]
            best = yield from gather_max(daps, members)
            by_cfg: dict[str, list[str]] = {}
            for o in members:
                by_cfg.setdefault(decided[o].cfg_id, []).append(o)
            for group in by_cfg.values():
                dap = self._dap(decided[group[0]], nu + 1)
                yield from dap.put_data_batch(
                    [(o, best[o][0], best[o][1]) for o in group]
                )
            # 4) finalize on a quorum of the last old configuration
            yield RPC(
                dests=last.config.servers,
                msg=(
                    "write-next-batch",
                    tuple((o, nu, decided[o], F) for o in members),
                ),
                need=last.config.majority(),
            )
            for o in members:
                cseqs[o][nu + 1].status = F
                tag, val = best[o]
                out[o] = (decided[o], tag, val)
                self._record(
                    kind="recon", obj=o, client=self.client_id,
                    start=t0, end=self.net.now, tag=tag,
                    extra={"config": decided[o].cfg_id},
                )
            # 5) repair the configuration just installed (background): the
            # transfer put only waited for a quorum, so restore full
            # redundancy for these objects without blocking the recon.
            if self.repair_on_recon:
                for group in by_cfg.values():
                    self._spawn_repair(decided[group[0]], nu + 1, group)
            if self.on_recon is not None:
                for group in by_cfg.values():
                    self.on_recon(decided[group[0]], nu + 1, tuple(group))
        return out

    def recon(self, obj: str, new_config: Config) -> Generator:
        """Single-object reconfiguration; returns the decided configuration."""
        res = yield from self.recon_batch((obj,), new_config)
        return res[obj][0]

    def _spawn_repair(self, cfg: Config, cfg_idx: int, objs: list[str]) -> None:
        if cfg.dap not in ("ec", "ec_opt"):
            return  # ABD replicates whole values; nothing coded to rebuild
        from repro_torch.core.repair import RepairController

        rc = RepairController(
            self.net, cfg, cfg_idx,
            client_id=f"{self.client_id}:recon-repair", history=self.history,
        )
        # charged to its OWN client id: background repair traffic must not
        # pollute the reconfiguring client's per-op accounting (nor, through
        # the gateway's attribution map, every rider of a merged recon).
        self.net.spawn(
            rc.scan_and_repair(list(objs)),
            kind="recon-repair", client=f"{self.client_id}:recon-repair",
            delay=self.recon_repair_delay,
        )

    # ---------------------------------------------------------------- write
    def cvr_write_batch(self, updates: Mapping[str, Any]) -> Generator:
        """Alg 1:10-32, phase-retried — see :meth:`_cvr_write_batch_impl`."""
        return (yield from _with_phase_retry(
            self.net, "write", lambda: self._cvr_write_batch_impl(updates)
        ))

    def _cvr_write_batch_impl(self, updates: Mapping[str, Any]) -> Generator:
        """Alg 1:10-32 for many objects in one batched pass — coverable
        writes; each object independently degrades to a read when stale.
        Returns ``{obj: ((tag, val), flag)}``."""
        t0 = self.net.now
        objs = list(updates)
        if not objs:
            return {}
        cseqs = yield from self.read_config_batch(objs)            # l.11
        gathered = yield from self._gather_grouped(objs, cseqs)    # l.12-15
        results, puts = apply_coverable(                           # l.16-21
            self.version, self.client_id, gathered, updates
        )
        yield from self._put_until_stable(objs, cseqs, puts)       # l.22-30
        for o in objs:
            (tag, val), flag = results[o]
            self._record(
                kind="write", obj=o, client=self.client_id, start=t0,
                end=self.net.now, tag=tag, flag=flag, value_digest=digest(val),
            )
        return results

    def cvr_write(self, obj: str, value: Any) -> Generator:
        """Alg 1:10-32 — coverable write; degrades to a read when stale."""
        results = yield from self.cvr_write_batch({obj: value})
        return results[obj]

    # ----------------------------------------------------------------- read
    def cvr_read_batch(self, objs: Iterable[str]) -> Generator:
        """Alg 1:39-55, phase-retried — see :meth:`_cvr_read_batch_impl`."""
        objs = list(dict.fromkeys(objs))  # materialize: retries re-iterate
        return (yield from _with_phase_retry(
            self.net, "read", lambda: self._cvr_read_batch_impl(objs)
        ))

    def _cvr_read_batch_impl(self, objs: Iterable[str]) -> Generator:
        """Alg 1:39-55 for many objects in one batched pass.
        Returns ``{obj: (tag, val)}``."""
        t0 = self.net.now
        objs = list(dict.fromkeys(objs))
        if not objs:
            return {}
        cseqs = yield from self.read_config_batch(objs)
        best = yield from self._gather_grouped(objs, cseqs)
        yield from self._put_until_stable(objs, cseqs, best)
        for o in objs:
            self._record(
                kind="read", obj=o, client=self.client_id, start=t0,
                end=self.net.now, tag=best[o][0], value_digest=digest(best[o][1]),
            )
        return best

    def cvr_read(self, obj: str) -> Generator:
        """Alg 1:39-55."""
        best = yield from self.cvr_read_batch((obj,))
        return best[obj]


class StaticCoverableClient:
    """CoABD [21] (and a static-EC ablation): coverable reads/writes over one
    fixed configuration — the paper's non-reconfigurable baselines. Drives
    the same state-transfer engine (``gather_max`` / ``apply_coverable``)
    over a single-configuration window."""

    def __init__(self, net, client_id: str, config: Config, history: list | None = None):
        self.net = net
        self.client_id = client_id
        self.config = config
        self.version: dict[str, Tag] = {}
        self.dap_state: dict = {}
        self.history = history if history is not None else []

    def _dap(self):
        return make_dap(self.net, self.client_id, self.config, 0, self.dap_state)

    def _record(self, **kw) -> None:
        self.history.append(OpRecord(**kw))

    def precode(self, values) -> None:
        """See ``CoAresClient.precode``."""
        _register_precode(self.dap_state, values)

    def cvr_write_batch(self, updates: Mapping[str, Any]) -> Generator:
        return (yield from _with_phase_retry(
            self.net, "write", lambda: self._cvr_write_batch_impl(updates)
        ))

    def _cvr_write_batch_impl(self, updates: Mapping[str, Any]) -> Generator:
        t0 = self.net.now
        objs = list(updates)
        if not objs:
            return {}
        dap = self._dap()
        gathered = yield from gather_max([dap], objs)
        results, puts = apply_coverable(
            self.version, self.client_id, gathered, updates
        )
        yield from dap.put_data_batch([(o, puts[o][0], puts[o][1]) for o in objs])
        for o in objs:
            (tag, val), flag = results[o]
            self._record(
                kind="write", obj=o, client=self.client_id, start=t0,
                end=self.net.now, tag=tag, flag=flag, value_digest=digest(val),
            )
        return results

    def cvr_write(self, obj: str, value: Any) -> Generator:
        results = yield from self.cvr_write_batch({obj: value})
        return results[obj]

    def cvr_read_batch(self, objs: Iterable[str]) -> Generator:
        objs = list(dict.fromkeys(objs))  # materialize: retries re-iterate
        return (yield from _with_phase_retry(
            self.net, "read", lambda: self._cvr_read_batch_impl(objs)
        ))

    def _cvr_read_batch_impl(self, objs: Iterable[str]) -> Generator:
        t0 = self.net.now
        objs = list(dict.fromkeys(objs))
        if not objs:
            return {}
        dap = self._dap()
        best = yield from gather_max([dap], objs)
        yield from dap.put_data_batch([(o, best[o][0], best[o][1]) for o in objs])
        for o in objs:
            self._record(
                kind="read", obj=o, client=self.client_id, start=t0,
                end=self.net.now, tag=best[o][0], value_digest=digest(best[o][1]),
            )
        return best

    def cvr_read(self, obj: str) -> Generator:
        best = yield from self.cvr_read_batch((obj,))
        return best[obj]

    def recon_batch(self, objs, new_config: Config) -> Generator:
        raise NotImplementedError("static algorithms do not reconfigure")
        yield  # pragma: no cover

    def recon(self, obj: str, new_config: Config) -> Generator:
        raise NotImplementedError("static algorithms do not reconfigure")
        yield  # pragma: no cover
