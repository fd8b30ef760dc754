"""Cross-client gateway aggregation tier (ISSUE 4 tentpole).

PR 3 made an F-file fan-out O(1) quorum rounds *within* one session, but
every client is still its own network endpoint: C clients hammering the
same hot files pay C independent quorum fan-outs. DynoStore-style
deployments put a gateway/proxy tier in front of wide-area clients so
their traffic merges into shared storage rounds; this module brings that
tier to the ARES/COBFS reproduction.

:class:`Gateway` is a coordinator endpoint sessions attach to
(``gw = dss.gateway()``; ``dss.session(cid, via=gw)``). Attached sessions
forward their convenience-op intents to the gateway, which coalesces
in-flight same-kind intents from *multiple clients* within one
virtual-time window and issues ONE merged ``fm_read_batch`` /
``fm_update_batch`` / ``fm_reconfig_batch`` / ``stat_batch`` round on
their behalf:

* same-file reads (or stats, or same-target recons) from C clients dedupe
  to one entry of the merged batch — a single quorum fan-out — and the
  result is multicast back to every rider's future;
* per-client :class:`~repro_torch.core.api.OpStats` stay meaningful through the
  network's attribution map (``Network.attribute``): while the gateway's
  merged round is in flight, each rider client's counters advance with
  the gateway's, so a rider's stats show the shared round once (the same
  sharing semantics a coalesced Session batch already has);
* per-client program order is preserved: intents drain in arrival order
  and a kind change always breaks the merged run, so ``c1.write(f)``
  followed by anyone's ``read(f)`` executes write-then-read. Writes to
  the SAME fid from different clients never merge into one round (the
  second write needs the first one's tag to be a proper successor).

The gateway is also the natural host for configuration dissemination: it
subscribes to the store's recon-finalization notifications (so it sees
every configuration ANY client installs, plus the ones it installs
itself) and runs a lightweight anti-entropy loop gossiping its
``(cfg_idx, cfg_id, Config)`` coverage to registered
:class:`~repro_torch.core.repair.RepairDaemon`\\ s over a codec-framed
``gossip-configs`` message. Daemons ingest the entries additively
(``RepairDaemon.ingest_coverage``) and reply with their OWN coverage, so
knowledge flows both ways — a daemon whose local client never observed a
reconfiguration still acquires the new configuration and repairs it
(the ROADMAP's gossip/membership open item, in the spirit of D-Rex's
global reliability view).

Like the repair daemon, a gateway with registered listeners keeps a
periodic loop on the simulator: call :meth:`Gateway.stop` before
expecting ``net.run()`` to quiesce.
"""
from __future__ import annotations

from typing import Generator

from repro_torch.core.api import OpStats, _dispatch_group, _Intent
from repro_torch.core.tags import Config
from repro_torch.net.sim import RPC, Server, Sleep


class GossipListener(Server):
    """Network endpoint a RepairDaemon registers with a gateway: receives
    codec-framed ``gossip-configs`` pushes, feeds them to the daemon, and
    replies with the daemon's own coverage (symmetric anti-entropy)."""

    def __init__(self, sid: str, daemon):
        super().__init__(sid)
        self.daemon = daemon

    def handle(self, sender: str, msg: tuple):
        op = msg[0]
        if op == "gossip-configs":
            # ("gossip-configs", ((cfg_idx, cfg_id, Config), ...))
            _, entries = msg
            applied = self.daemon.ingest_coverage(
                [(idx, cfg) for idx, _cid, cfg in entries]
            )
            known = tuple(
                (idx, cid, cfg)
                for (idx, cid), cfg in sorted(self.daemon.targets.items())
            )
            return ("gossip-ack", applied, known)
        raise ValueError(f"unknown gossip message {op!r}")


class Gateway:
    """Coordinator endpoint merging many clients' ops into shared rounds.

    ``window`` is the cross-client coalescing window (virtual seconds);
    ``gossip_period`` paces the anti-entropy loop once a daemon is
    registered. The gateway drives a regular :class:`ClientHandle` under
    its own client id, so merged traffic rides the PR-2/PR-3 batched
    state-transfer engine unchanged — coverability writes through the
    gateway use the GATEWAY's version tags (it acts as one writer on the
    attached clients' behalf).
    """

    def __init__(self, dss, gid: str = "gw", *, window: float = 0.5e-3,
                 gossip_period: float = 0.02):
        self.dss = dss
        self.gid = gid
        self.net = dss.net
        self.handle = dss.client(gid)
        self.window = window
        self.gossip_period = gossip_period
        self._pending: list[_Intent] = []
        self._drain_scheduled = False
        # configuration coverage: (cfg_idx, cfg_id) -> Config. Seeded with
        # the genesis configuration; grows via recon-finalization
        # notifications (any client of this store) and gossip acks.
        self.coverage: dict[tuple[int, str], Config] = {(0, dss.c0.cfg_id): dss.c0}
        self._listeners: list[str] = []
        self._stopped = False
        self._gossip_fut = None
        self.stats = {"merged": 0, "groups": 0, "dedup_saved": 0,
                      "gossip_rounds": 0, "gossip_applied": 0,
                      "gossip_learned": 0}
        dss._recon_subs.append(self.observe_recon)

    # ------------------------------------------------------------- sessions
    def session(self, cid: str, **kw):
        """Open a Session attached to this gateway (``dss.session(cid,
        via=self)``)."""
        return self.dss.session(cid, via=self, **kw)

    def _enqueue(self, intent: _Intent) -> None:
        self._pending.append(intent)
        if not self._drain_scheduled:
            self._drain_scheduled = True
            self.net.spawn(
                self._drain(), kind="gateway-drain", client=self.gid,
                delay=self.window,
            )

    # ------------------------------------------------------------ scheduler
    @staticmethod
    def _groups(batch: list[_Intent]) -> list[list[_Intent]]:
        """Maximal runs of consecutive same-kind intents, like the Session
        scheduler — but a repeated fid only breaks a WRITE run (same-fid
        reads/stats dedupe and multicast; same-fid writes must stay two
        rounds). Recon runs still break on a different target config."""
        groups: list[list[_Intent]] = []
        fids: set = set()  # fids of the current (last) group, O(1) break check
        for it in batch:
            g = groups[-1] if groups else None
            if (
                g is None
                or g[0].kind != it.kind
                or (it.kind == "write" and it.fid in fids)
                or (it.kind == "recon" and g[0].arg.cfg_id != it.arg.cfg_id)
            ):
                groups.append([it])
                fids = {it.fid}
            else:
                g.append(it)
                fids.add(it.fid)
        return groups

    def _rider_stats(self, it: _Intent, snaps: dict, t0: float, blocks: int,
                     width: int, x0: int = 0) -> OpStats:
        r0, m0, b0 = snaps[it.fut.client]
        r1, m1, b1 = self.net.client_totals(it.fut.client)
        return OpStats(rounds=r1 - r0, msgs=m1 - m0, bytes=b1 - b0,
                       latency=self.net.now - t0, blocks=blocks,
                       batched_with=width,
                       retries=self.net.retransmits - x0)

    def _drain(self) -> Generator:
        # same reschedule discipline as the (fixed) Session drain: the flag
        # stays armed while this generator is mid-flight so late enqueues
        # never spawn a concurrent drain, and the exit path re-arms for them.
        try:
            batch, self._pending = self._pending, []
            for group in self._groups(batch):
                n_fids = len({it.fid for it in group})
                riders = list(dict.fromkeys(it.fut.client for it in group))
                snaps = {c: self.net.client_totals(c) for c in riders}
                t0 = self.net.now
                x0 = self.net.retransmits
                self.stats["groups"] += 1
                self.stats["merged"] += len(group)
                self.stats["dedup_saved"] += len(group) - n_fids
                self.net.attribute(self.gid, riders)
                try:
                    payload, blocks = yield from _dispatch_group(
                        self.handle, group
                    )
                except Exception as err:  # noqa: BLE001 - delivered via futures
                    for it in group:
                        it.fut._fail(
                            err,
                            self._rider_stats(it, snaps, t0, 0, len(group), x0),
                        )
                    continue
                finally:
                    self.net.attribute(self.gid, None)
                for it in group:
                    it.fut._resolve(
                        payload[it.fid],
                        self._rider_stats(
                            it, snaps, t0, blocks[it.fid], len(group), x0
                        ),
                    )
        finally:
            self._drain_scheduled = False
            if self._pending:
                self._drain_scheduled = True
                self.net.spawn(
                    self._drain(), kind="gateway-drain", client=self.gid,
                    delay=self.window,
                )
        return None

    # ---------------------------------------------------- config dissemination
    def observe_recon(self, config: Config, cfg_idx: int, objs=None) -> None:
        """Recon-finalization callback (subscribed on the DSS): every
        configuration ANY client of this store installs joins the gateway's
        gossip coverage."""
        if self._stopped:
            return
        self.coverage.setdefault((cfg_idx, config.cfg_id), config)
        san = getattr(self.net, "sanitizer", None)
        if san is not None:
            san.register_config(config)

    def register_daemon(self, daemon, sid: str | None = None) -> str:
        """Register a RepairDaemon for config gossip: a
        :class:`GossipListener` endpoint joins the network and the
        anti-entropy loop starts (if not already running). Returns the
        listener's server id."""
        sid = sid or f"{self.gid}:{daemon.client_id}"
        if sid in self.net.servers:
            raise ValueError(f"gossip listener {sid!r} already registered")
        self.net.add_server(GossipListener(sid, daemon))
        self._listeners.append(sid)
        if self._gossip_fut is None and not self._stopped:
            # NB its own client id: gossip rounds that interleave with an
            # in-flight merged round must never be attributed to that
            # round's riders (attribution keys on the issuing client).
            self._gossip_fut = self.net.spawn(
                self._gossip_loop(), kind="gateway-gossip",
                client=f"{self.gid}:gossip",
            )
        return sid

    def _gossip_loop(self) -> Generator:
        while not self._stopped:
            yield Sleep(self.gossip_period)
            if self._stopped:
                break
            if not self._listeners:
                continue
            entries = tuple(
                (idx, cid, cfg)
                for (idx, cid), cfg in sorted(self.coverage.items())
            )
            replies = yield RPC(
                dests=tuple(self._listeners),
                msg=("gossip-configs", entries),
                need="alive",
            )
            self.stats["gossip_rounds"] += 1
            san = getattr(self.net, "sanitizer", None)
            for _sid, (_tok, applied, known) in replies.items():
                self.stats["gossip_applied"] += applied
                for idx, cid, cfg in known:
                    if (idx, cid) not in self.coverage:
                        self.coverage[(idx, cid)] = cfg
                        self.stats["gossip_learned"] += 1
                        if san is not None:
                            san.register_config(cfg)
        return dict(self.stats)

    def stop(self) -> None:
        """End the anti-entropy loop (at its next wake-up) and detach from
        recon notifications, so ``net.run()`` can quiesce."""
        self._stopped = True
        if self.observe_recon in self.dss._recon_subs:
            self.dss._recon_subs.remove(self.observe_recon)
