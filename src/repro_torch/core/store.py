"""DSS facade — builds the six evaluated algorithms (§VII-A) on the sim.

    CoABD        static, ABD replication, whole-object
    CoABDF       static, ABD replication, fragmented
    CoARESABD    ARES (reconfigurable), ABD-DAP, whole-object
    CoARESABDF   ARES, ABD-DAP, fragmented
    CoARESEC     ARES, EC-DAPopt, whole-object
    CoARESECF    ARES, EC-DAPopt, fragmented
  (+ *-noopt variants running the original EC-DAP, for the §VI comparison)
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field as dc_field
from typing import Generator

from repro_torch.core.coares import CoAresClient, StaticCoverableClient
from repro_torch.core.fragment import FragmentationModule
from repro_torch.core.server import StorageServer
from repro_torch.core.tags import Config
from repro_torch.device import resolve_device
from repro_torch.erasure.rs import BACKENDS as CODING_BACKENDS
from repro_torch.net.sim import LatencyModel, Network, RetryPolicy

ALGORITHMS = {
    # name: (reconfigurable, dap, fragmented)
    "coabd": (False, "abd", False),
    "coabdf": (False, "abd", True),
    "coaresabd": (True, "abd", False),
    "coaresabdf": (True, "abd", True),
    "coaresec": (True, "ec_opt", False),
    "coaresecf": (True, "ec_opt", True),
    "coaresec-noopt": (True, "ec", False),
    "coaresecf-noopt": (True, "ec", True),
}


@dataclass
class DSSParams:
    algorithm: str = "coaresecf"
    n_servers: int = 6
    parity_m: int = 1          # m = n - k (EC); ignored for ABD
    delta: int = 8             # δ: max concurrent writers (EC List bound)
    seed: int = 0
    min_block: int = 512
    avg_block: int = 1024
    max_block: int = 4096
    indexed: bool = False  # beyond-paper: genesis holds the block index -> parallel block I/O
    # ISSUE 2 — unified state-transfer engine knobs:
    batched: bool = True       # multi-object batch RPCs on the indexed FM path
    recon_repair: bool = True  # recon finalization spawns repair of the new config
    recon_repair_delay: float = 0.0
    # ISSUE 6 — GF(256) coding backend for every EC code this store builds
    # (EcDap, repair, recon state transfer): "numpy" (byte-LUT), "kernel"
    # (the CUDA kernel, or its plain PyTorch version on device="cpu"), or
    # "auto" (size-based dispatch). See repro_torch.erasure.rs.
    coding_backend: str = "auto"
    # Data-plane device of the RS coding and the CDC chunker: "cuda" (the
    # hand-written kernels) or "cpu" (their plain PyTorch versions). A CUDA
    # device on a machine without one raises at construction.
    device: str = "cuda"
    # ISSUE 7 — vectorised one-event-per-fan-out network engine (trace-
    # identical to the per-destination legacy path; False = ablation).
    fast_net: bool = True
    # ISSUE 8 — runtime protocol sanitizer, and ISSUE 9 — happens-before race
    # tracker: pure observers in the reference (repro.analysis.sanitizer and
    # .races). Not ported yet (ROADMAP A7): True raises NotImplementedError.
    # The port does not read REPRO_SANITIZE / REPRO_RACECHECK.
    sanitize: bool = False
    racecheck: bool = False
    # ISSUE 10 — failure-survival layer: per-RPC deadlines with retransmit /
    # backoff / optional hedging at the network tier, plus phase-level retry
    # in the protocol tier surfacing QuorumUnavailableError when the budget
    # is exhausted. None (default) disables it all — traces bit-identical to
    # a build without the feature (the ablation the acceptance criteria pin).
    retry: RetryPolicy | None = None
    latency: LatencyModel = dc_field(default_factory=LatencyModel)


class ClientHandle:
    """Uniform client API over all algorithm variants (generator methods)."""

    def __init__(self, dss: "DSS", cid: str):
        self.dss = dss
        self.cid = cid
        reconf, dap, frag = ALGORITHMS[dss.params.algorithm]
        if reconf:
            self.dsm = CoAresClient(
                dss.net, cid, dss.c0, history=dss.history,
                repair_on_recon=dss.params.recon_repair,
                recon_repair_delay=dss.params.recon_repair_delay,
                on_recon=dss._notify_recon,
            )
        else:
            self.dsm = StaticCoverableClient(dss.net, cid, dss.c0, history=dss.history)
        self.fragmented = frag
        self.fm = (
            FragmentationModule(
                dss.net, self.dsm,
                min_block=dss.params.min_block,
                avg_block=dss.params.avg_block,
                max_block=dss.params.max_block,
                history=dss.history,
                indexed=dss.params.indexed,
                batched=dss.params.batched,
            )
            if frag
            else None
        )

    # --- uniform generator ops ------------------------------------------------
    @staticmethod
    def _whole_stats(tag, flag) -> dict:
        # a chg write whose new version is 1 created the object — the
        # gathered tag was TAG0, i.e. nothing was ever written before
        # (fixes the hardwired ``created: 0`` of the non-fragmented path).
        return {"written": int(flag == "chg"), "collided": int(flag != "chg"),
                "created": int(flag == "chg" and tag[0] == 1),
                "blocks": 1, "chunks": 1, "success": flag == "chg"}

    def update(self, fid: str, content: bytes) -> Generator:
        if self.fm is not None:
            return (yield from self.fm.fm_update(fid, content))
        (tag, _v), flag = yield from self.dsm.cvr_write(fid, content)
        self.dsm.version[fid] = tag
        return self._whole_stats(tag, flag)

    def read(self, fid: str) -> Generator:
        if self.fm is not None:
            content, _blocks = yield from self.fm.fm_read(fid)
            return content
        tag, val = yield from self.dsm.cvr_read(fid)
        self.dsm.version[fid] = tag
        return val if val is not None else b""

    def recon(self, fid: str, new_config: Config) -> Generator:
        if self.fm is not None:
            return (yield from self.fm.fm_reconfig(fid, new_config))
        yield from self.dsm.recon(fid, new_config)
        return 1

    # --- multi-FILE batch ops (ISSUE 3) ---------------------------------------
    # The Session scheduler lands coalesced same-kind operations here; each
    # returns a per-fid dict and rides the engine's multi-object batch RPCs,
    # so an F-file fan-out costs O(1) quorum rounds (see ``repro_torch.core.api``).
    def read_batch(self, fids) -> Generator:
        """``{fid: (content, n_blocks)}`` for many files in one batched pass."""
        fids = list(dict.fromkeys(fids))
        if self.fm is not None:
            res = yield from self.fm.fm_read_batch(fids)
            return {f: (content, len(blocks)) for f, (content, blocks) in res.items()}
        res = yield from self.dsm.cvr_read_batch(fids)
        out = {}
        for fid in fids:
            tag, val = res[fid]
            self.dsm.version[fid] = tag
            out[fid] = (val if val is not None else b"", 1)
        return out

    def update_batch(self, updates) -> Generator:
        """``{fid: stats}`` for many files written in one batched pass."""
        if self.fm is not None:
            return (yield from self.fm.fm_update_batch(dict(updates)))
        results = yield from self.dsm.cvr_write_batch(dict(updates))
        out = {}
        for fid, ((tag, _v), flag) in results.items():
            self.dsm.version[fid] = tag
            out[fid] = self._whole_stats(tag, flag)
        return out

    def recon_batch(self, fids, new_config: Config) -> Generator:
        """``{fid: n_blocks_moved}`` — many files to one new configuration."""
        fids = list(dict.fromkeys(fids))
        if self.fm is not None:
            return (yield from self.fm.fm_reconfig_batch(fids, new_config))
        yield from self.dsm.recon_batch(fids, new_config)
        return {f: 1 for f in fids}

    # --- reliability stat (ISSUE 3, à la D-Rex) --------------------------------
    def stat_batch(self, fids) -> Generator:
        """Surviving-fragment margin per file: ``{fid: stat}`` where ``stat``
        has ``margin`` (min over the file's genesis + data blocks; how many
        more server losses the newest version of the weakest block survives),
        ``blocks``, ``config``, ``tag`` (genesis) and ``worst`` (the weakest
        object). Costs one batched genesis read + one tag-only probe fan-out
        per distinct configuration — no data moves."""
        from repro_torch.core.fragment import genesis_id
        from repro_torch.core.repair import probe_health

        fids = list(dict.fromkeys(fids))
        if not fids:
            return {}
        # objects of each file: the fid itself (whole-object algorithms) or
        # genesis + indexed data blocks (fragmented ones; legacy files
        # without an index report the genesis margin only).
        objs_of: dict[str, list[str]] = {}
        if self.fm is not None:
            gids = [genesis_id(f) for f in fids]
            gres = yield from self.dsm.cvr_read_batch(gids)
            from repro_torch.core.fragment import decode_block_value, parse_genesis_meta

            for fid, g in zip(fids, gids):
                tag, raw = gres[g]
                self.dsm.version[g] = tag
                _ptr, meta = decode_block_value(raw)
                index = parse_genesis_meta(meta)
                objs_of[fid] = [g] + list(index or ())
        else:
            objs_of = {f: [f] for f in fids}
        all_objs = [o for objs in objs_of.values() for o in objs]
        # locate each object's current configuration: the latest finalized
        # entry of its sequence (static algorithms have one fixed config).
        read_cfg = getattr(self.dsm, "read_config_batch", None)
        placement: dict[tuple[str, int], tuple[Config, list[str]]] = {}
        if read_cfg is not None:
            cseqs = yield from read_cfg(all_objs)
            for o in all_objs:
                cseq = cseqs[o]
                idx = max(j for j, e in enumerate(cseq) if e.status == "F")
                cfg = cseq[idx].config
                placement.setdefault((cfg.cfg_id, idx), (cfg, []))[1].append(o)
        else:
            placement[(self.dsm.config.cfg_id, 0)] = (self.dsm.config, all_objs)
        health = {}
        cfg_of: dict[str, str] = {}
        for (cid, idx), (cfg, objs) in placement.items():
            health.update((yield from probe_health(cfg, idx, objs)))
            for o in objs:
                cfg_of[o] = cid
        out = {}
        for fid in fids:
            objs = objs_of[fid]
            worst = min(objs, key=lambda o: health[o].margin)
            out[fid] = {
                "margin": health[worst].margin,
                "worst": worst,
                "blocks": max(0, len(objs) - 1) if self.fm is not None else 1,
                "config": cfg_of[worst],
                "tag": health[objs[0]].tag,
                # data was written but some block no longer reaches k live
                # holders — the file cannot currently be read back in full
                "unreadable": any(health[o].unreadable for o in objs),
                "per_object": {o: health[o] for o in objs},
            }
        return out

    def stat(self, fid: str) -> Generator:
        res = yield from self.stat_batch((fid,))
        return res[fid]


class DSS:
    """One deployed storage service instance."""

    def __init__(self, params: DSSParams | None = None, **kw):
        self.params = params or DSSParams(**kw)
        p = self.params
        if p.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {p.algorithm!r}")
        if p.coding_backend not in CODING_BACKENDS:
            raise ValueError(
                f"unknown coding backend {p.coding_backend!r}; "
                f"expected one of {CODING_BACKENDS}"
            )
        if p.sanitize or p.racecheck:
            raise NotImplementedError(
                "sanitize/racecheck need the analysis stack, not ported to "
                "repro_torch yet (ROADMAP A7)"
            )
        resolve_device(p.device)
        self.net = Network(seed=p.seed, latency=p.latency, fast=p.fast_net)
        # ambient store-wide coding backend and device: every RSCode (and
        # chunker) built against this network (DAPs, repair controllers/
        # daemons, recon transfers, the Fragmentation Module) reads them
        self.net.coding_backend = p.coding_backend
        self.net.device = p.device
        self.net.retry = p.retry
        self.history: list = []
        sids = tuple(f"s{i}" for i in range(p.n_servers))
        for s in sids:
            self.net.add_server(StorageServer(s))
        _, dap, _ = ALGORITHMS[p.algorithm]
        k = max(1, p.n_servers - p.parity_m) if dap in ("ec", "ec_opt") else 1
        self.c0 = Config("c0", sids, dap=dap, k=k, delta=p.delta)
        self._cfg_counter = itertools.count(1)
        self._extra_servers = itertools.count(p.n_servers)
        # recon-finalization subscribers ``(config, cfg_idx, objs) -> None``
        # (e.g. the auto-retargeting RepairDaemon); every CoAresClient this
        # store hands out notifies them via ``_notify_recon``.
        self._recon_subs: list = []

    def _notify_recon(self, config: Config, cfg_idx: int, objs) -> None:
        for sub in list(self._recon_subs):
            sub(config, cfg_idx, objs)

    # --- clients ---------------------------------------------------------------
    def client(self, cid: str) -> ClientHandle:
        """Build the LEGACY generator-op client handle. Application code
        should prefer ``session(cid)`` — the Session/future API coalesces
        concurrent operations across files and reports uniform OpStats; this
        handle remains as the deprecation shim (and as the engine the
        Session drives underneath)."""
        return ClientHandle(self, cid)

    def session(self, cid: str, **kw) -> "Session":
        """Open a :class:`repro_torch.core.api.Session` for client ``cid`` — the
        submit/future client API (ISSUE 3). Keyword args (e.g. ``window``,
        ``via=gateway``) pass through to the Session constructor."""
        from repro_torch.core.api import Session

        return Session(self, cid, **kw)

    def gateway(self, gid: str = "gw", **kw):
        """The cross-client aggregation gateway of the reference (ISSUE 4)
        is not ported yet (ROADMAP A6)."""
        raise NotImplementedError(
            "the gateway tier is not ported to repro_torch yet (ROADMAP A6)"
        )

    # --- config construction (recon targets) -----------------------------------
    def make_config(
        self,
        dap: str | None = None,
        n_servers: int | None = None,
        parity_m: int | None = None,
        fresh_servers: bool = False,
    ) -> Config:
        """Build a recon target: switch DAP and/or change the server set
        (the paper's §VII-E scenarios)."""
        p = self.params
        dap = dap or self.c0.dap
        n = n_servers or p.n_servers
        if fresh_servers:
            sids = []
            for _ in range(n):
                s = f"s{next(self._extra_servers)}"
                self.net.add_server(StorageServer(s))
                sids.append(s)
            sids = tuple(sids)
        else:
            # only STORAGE servers are recon targets — the network may also
            # host gossip-listener endpoints (gateway tier) whose ids don't
            # follow the ``sN`` scheme and which store no replica state.
            have = sorted(
                (s for s, srv in self.net.servers.items()
                 if isinstance(srv, StorageServer)),
                key=lambda s: int(s[1:]),
            )
            while len(have) < n:
                s = f"s{next(self._extra_servers)}"
                self.net.add_server(StorageServer(s))
                have.append(s)
            sids = tuple(have[:n])
        m = parity_m if parity_m is not None else p.parity_m
        k = max(1, n - m) if dap in ("ec", "ec_opt") else 1
        cfg = Config(f"c{next(self._cfg_counter)}", sids, dap=dap, k=k, delta=p.delta)
        if self.net.sanitizer is not None:
            self.net.sanitizer.register_config(cfg)
        return cfg

    # --- crash injection ---------------------------------------------------------
    def crash_servers(self, ids: list[str]) -> None:
        for s in ids:
            self.net.crash(s)

    def recover_servers(self, ids: list[str], wipe: bool = True) -> None:
        """Crash-recovery: the server rejoins with whatever durable List
        state it had when it crashed — i.e. stale; run ``repair`` to restore
        redundancy. ``wipe=True`` (ISSUE 10) also clears volatile state —
        the per-server reply/identity cache — so a recovered replica never
        serves an answer memoized before the crash; ``wipe=False`` keeps the
        legacy flag-flip behavior."""
        for s in ids:
            self.net.recover(s, wipe=wipe)

    def wipe_servers(self, ids: list[str]) -> None:
        """Disk-loss recovery: drop all EC fragment state (the ABD register
        and config state survive — the interesting loss is the coded rows)."""
        for s in ids:
            self.net.servers[s].ec.clear()

    # --- repair -----------------------------------------------------------------
    def ec_objects(self, cfg_idx: int = 0) -> list[str]:
        """Names of every object holding EC state at configuration ``cfg_idx``
        (for fragmented algorithms these are the genesis + data blocks)."""
        objs: set[str] = set()
        for srv in self.net.servers.values():
            for obj, idx in getattr(srv, "ec", {}):
                if idx == cfg_idx:
                    objs.add(obj)
        return sorted(objs)

    def repair(self, objs=None, config: Config | None = None, cfg_idx: int = 0,
               client_id: str = "repair") -> list[dict]:
        """Run a full repair pass to quiescence and return per-object stats.
        Defaults to every EC object of the initial configuration; pass
        ``config``/``cfg_idx`` after a reconfiguration."""
        from repro_torch.core.repair import RepairController

        cfg = config or self.c0
        rc = RepairController(
            self.net, cfg, cfg_idx, client_id=client_id, history=self.history
        )
        todo = self.ec_objects(cfg_idx) if objs is None else list(objs)
        return self.net.run_op(
            rc.scan_and_repair(todo), kind="repair-pass", client=client_id
        )

    def start_repair_daemon(
        self,
        *,
        config: Config | None = None,
        cfg_idx: int = 0,
        period: float = 0.05,
        objs_per_cycle: int = 4,
        max_cycles: int | None = None,
        client_id: str = "repaird",
        order: str = "margin",
        auto_retarget: bool = True,
    ):
        """Launch the rate-limited background repair loop (``RepairDaemon``)
        over this store's EC objects. By default the daemon repairs the
        objects with the SMALLEST surviving-fragment margin first
        (``order="margin"``; ``"rr"`` = the old blind round-robin) and
        follows reconfigurations by itself (``auto_retarget``: it subscribes
        to this store's recon-finalization notifications, so the owner never
        calls ``retarget``). Returns the daemon; call ``stop_repair_daemon()``
        (or pass ``max_cycles``) before expecting ``net.run()`` to quiesce."""
        from repro_torch.core.repair import RepairDaemon

        daemon = RepairDaemon(
            self.net, config or self.c0, cfg_idx,
            discover=self.ec_objects, period=period,
            objs_per_cycle=objs_per_cycle, max_cycles=max_cycles,
            client_id=client_id, history=self.history,
            order=order, auto_retarget=auto_retarget,
        )
        # one managed daemon at a time: drop the previous daemon's
        # subscription so a replaced (or completed) daemon is no longer
        # notified — its observe_recon also self-guards once done.
        prev = getattr(self, "repair_daemon", None)
        if prev is not None and prev.observe_recon in self._recon_subs:
            self._recon_subs.remove(prev.observe_recon)
        daemon.start()
        if auto_retarget:
            self._recon_subs.append(daemon.observe_recon)
        self.repair_daemon = daemon
        return daemon

    def stop_repair_daemon(self) -> None:
        daemon = getattr(self, "repair_daemon", None)
        if daemon is not None:
            daemon.stop()
            if daemon.observe_recon in self._recon_subs:
                self._recon_subs.remove(daemon.observe_recon)

    def run(self, **kw) -> None:
        self.net.run(**kw)

    # --- post-hoc history checking (ISSUE 8) -------------------------------------
    def check_history(self, *, strict_reads: bool = True) -> dict:
        """Wing–Gong tag-order linearizability over the recorded history
        (``repro.analysis.linearize`` in the reference) is not ported yet
        (ROADMAP A7)."""
        raise NotImplementedError(
            "check_history needs the analysis stack, not ported to "
            "repro_torch yet (ROADMAP A7)"
        )
