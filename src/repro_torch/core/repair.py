"""Self-healing fragment repair & rebalance (beyond-paper, ISSUE 1 tentpole).

The paper's liveness guarantee for EC-DAPopt (Thm 18) holds only while
<= (n-k)/2 servers of a configuration have crashed — but nothing in ARES
ever *restores* redundancy: a server that recovers with a stale or wiped
List keeps serving old state until a full reconfiguration rewrites the
object. Liquid Cloud Storage (Luby et al., PAPERS.md) shows that lazy
background repair is what keeps erasure-coded stores durable at scale;
this module adds that missing loop.

``RepairController`` scans one configuration's servers for missing or
stale coded fragments (per object, per tag), pulls any k surviving
fragments with the ``ec-repair-pull`` server message, rebuilds the lost
rows (one decode + one fused GF(256) matmul via
``RSCode.reconstruct_fragments``) and pushes them back with
``ec-repair-push``. Everything is a sim generator: repair traffic rides
the same virtual-time latency model as foreground reads/writes, so the
benchmarks can measure interference (``benchmarks/bench_repair.py``).

Safety under concurrent writes
------------------------------
Repair never regresses a server's List to an older tag:

* ``ec-repair-push`` only *adds* an element for a tag the server has never
  seen; it never resurrects a trimmed ``(tag, ⊥)`` placeholder, and the
  only element it may overwrite is one whose bytes FAIL their own stored
  checksum (bit-rot healing, ISSUE 6) — the replacement is the bit-identical
  row the writer would have stored, so this is a pure restore, not a state
  change. Inserting cannot remove newer tags, and the handler re-applies
  the same δ+1 trim as ``ec-put``, so the List-length invariant (Alg 5) is
  preserved.
* The pushed element is the *bit-identical* coded row the writer would
  have sent (MDS determinism), so a reader that decodes with repaired
  fragments obtains exactly the written value — C2 is untouched.
* Repair writes no tags of its own, so tag uniqueness / monotonicity
  (the atomicity checkers in ``tests/checkers.py``) are unaffected.

A racing put-data can at worst make the repaired tag obsolete, in which
case the trim quietly drops it again — wasted work, never lost safety.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generator
import zlib

import numpy as np

from repro_torch.core.tags import TAG0, Config, OpRecord, Tag
from repro_torch.erasure.rs import RSCode, element_crc_ok
from repro_torch.net.sim import Join, RPC, Sleep


@dataclass
class ObjectHealth:
    """Surviving-fragment margin of one object at one configuration (D-Rex's
    reliability signal, ISSUE 3): how many more server losses the newest
    written version survives before it becomes undecodable/unreadable.

    ``margin = holders - k`` for EC configurations (holders = live servers
    whose List still carries a coded element at the newest decodable tag),
    ``holders - 1`` for ABD (live replicas storing the max tag). Data that
    WAS written but no longer reaches k live holders reports a NEGATIVE
    margin with ``unreadable=True`` (repair cannot rebuild it from this
    configuration, so ``needs_repair`` stays False — but it must never be
    confused with a healthy object). Only when nothing real was ever stored
    (``tag == TAG0``, no real tag seen anywhere) does the object report
    full margin. ``superseded`` means a quorum already finalized a successor
    configuration at this index — the state here is historical and repair
    effort belongs to the successor."""

    obj: str
    tag: Tag
    holders: int      # live servers holding the newest version
    alive: int        # live servers that answered the probe
    margin: int
    needs_repair: bool
    unreadable: bool = False
    superseded: bool = False


def probe_health(config: Config, cfg_idx: int, objs) -> Generator:
    """ONE tag-only ``margin-batch`` fan-out over the configuration's live
    servers; returns ``{obj: ObjectHealth}``. No values or coded elements
    move, so probing a whole store costs a few KB — cheap enough to run
    every daemon cycle (and per ``Session.stat`` call)."""
    objs = list(dict.fromkeys(objs))
    out: dict[str, ObjectHealth] = {}
    if not objs:
        return out
    ec = config.dap in ("ec", "ec_opt")
    k = config.k if ec else 1
    replies = yield RPC(
        dests=config.servers,
        msg=("margin-batch", tuple(objs), cfg_idx),
        need="alive",
    )
    alive = len(replies)
    for pos, obj in enumerate(objs):
        counts: dict[Tag, int] = {}
        seen: set[Tag] = set()
        superseded = False
        for _sid, (_kindtok, items) in replies.items():
            abd_tag, ec_items, next_status = items[pos]
            if next_status == "F":
                superseded = True
            if ec:
                for t, holds in ec_items or ():
                    if t > TAG0:
                        seen.add(t)
                    if holds:
                        counts[t] = counts.get(t, 0) + 1
            elif abd_tag is not None:
                if abd_tag > TAG0:
                    seen.add(abd_tag)
                counts[abd_tag] = counts.get(abd_tag, 0) + 1
        decodable = [t for t, c in counts.items() if c >= k and t > TAG0]
        if decodable:
            t_star = max(decodable)
            holders = counts[t_star]
            health = ObjectHealth(
                obj=obj, tag=t_star, holders=holders, alive=alive,
                margin=holders - k, needs_repair=holders < alive,
                superseded=superseded,
            )
        elif seen:
            # data WAS written here but fewer than k live holders remain:
            # unreadable from this configuration, margin is negative, and
            # repair cannot rebuild it — never report it healthy.
            best = max(
                ((counts.get(t, 0), t) for t in sorted(seen)), default=(0, TAG0)
            )
            health = ObjectHealth(
                obj=obj, tag=best[1], holders=best[0], alive=alive,
                margin=best[0] - k, needs_repair=False, unreadable=True,
                superseded=superseded,
            )
        else:
            health = ObjectHealth(
                obj=obj, tag=TAG0, holders=alive, alive=alive,
                margin=alive - k, needs_repair=False, superseded=superseded,
            )
        out[obj] = health
    return out


class RepairController:
    """Scans an erasure-coded configuration and restores lost redundancy.

    All public methods are sim generators (drive them with ``Network.spawn``
    / ``run_op``); ``DSS.repair`` wraps the common whole-store pass.
    """

    def __init__(
        self,
        net,
        config: Config,
        cfg_idx: int = 0,
        *,
        client_id: str = "repair",
        history: list | None = None,
        backend: str | None = None,
    ):
        if config.dap not in ("ec", "ec_opt"):
            raise ValueError(
                f"repair applies to erasure-coded configurations, not {config.dap!r}"
            )
        self.net = net
        self.config = config
        self.cfg_idx = cfg_idx
        self.client_id = client_id
        self.history = history if history is not None else []
        # None = inherit the store-wide coding backend riding on the network
        # handle (DSSParams.coding_backend), same as EcDap.
        if backend is None:
            backend = getattr(net, "coding_backend", "numpy")
        self.code = RSCode(n=config.n, k=config.k, backend=backend, device=net.device)

    # ----------------------------------------------------------------- probe
    def probe_health(self, objs) -> Generator:
        """Tag-only margin probe of this configuration (one fan-out for ALL
        objects); see module-level ``probe_health``."""
        return (yield from probe_health(self.config, self.cfg_idx, objs))

    # ------------------------------------------------------------------ scan
    def scan(self, obj: str) -> Generator:
        """Pull List snapshots from every live server of the configuration.

        Returns ``(replies, frags, holders, t_star)`` where ``frags`` maps
        tag -> {fragment index: element}, ``holders`` maps tag -> {sid}, and
        ``t_star`` is the maximum tag decodable from >= k surviving coded
        elements (TAG0 when nothing real is stored)."""
        replies = yield RPC(
            dests=self.config.servers,
            msg=("ec-repair-pull", obj, self.cfg_idx),
            need="alive",
        )
        frags: dict[Tag, dict[int, Any]] = {}
        holders: dict[Tag, set[str]] = {}
        for sid, (_kindtok, lst) in replies.items():
            fidx = self.config.frag_index(sid)
            for t, e in lst:
                # a stored element whose bytes fail their own CRC is treated
                # as lost: its server is NOT a holder, so it lands in
                # ``missing`` below and the push replaces the rotted element
                # (the server side overwrites only on a failed self-check).
                if e is not None and element_crc_ok(e):
                    frags.setdefault(t, {})[fidx] = e
                    holders.setdefault(t, set()).add(sid)
        decodable = [t for t, m in frags.items() if len(m) >= self.config.k]
        t_star = max(decodable, default=TAG0)
        return replies, frags, holders, t_star

    # ---------------------------------------------------------------- repair
    def repair_object(self, obj: str) -> Generator:
        """Restore every live server's coded element at the newest decodable
        tag. Returns a stats dict (scanned / missing / pushed / applied)."""
        t0 = self.net.now
        replies, frags, holders, t_star = yield from self.scan(obj)
        stats = {
            "obj": obj,
            "tag": t_star,
            "scanned": len(replies),
            "missing": 0,
            "pushed": 0,
            "applied": 0,
        }
        if t_star == TAG0:
            # only the initial sentinel (t0, Φ_i(v0)) exists — nothing real
            # was ever written (or too few fragments survive to rebuild).
            self._record(t0, stats)
            return stats
        missing = [s for s in replies if s not in holders.get(t_star, set())]
        stats["missing"] = len(missing)
        if not missing:
            self._record(t0, stats)
            return stats
        fmap = frags[t_star]
        idxs = sorted(fmap)[: self.config.k]
        orig = fmap[idxs[0]][1]
        mat = np.stack(
            [np.frombuffer(fmap[i][0], dtype=np.uint8) for i in idxs], axis=0
        )
        targets = [self.config.frag_index(s) for s in missing]
        rows = self.code.reconstruct_fragments(targets, mat, idxs)
        # charge the rebuild at the model's client-side coding rates
        yield Sleep(
            self.net.latency.dec_per_byte * mat.size
            + self.net.latency.enc_per_byte * rows.size
        )
        frag_bytes = [rows[j].tobytes() for j in range(len(missing))]
        per_dest = {
            sid: (
                "ec-repair-push",
                obj,
                self.cfg_idx,
                t_star,
                (fb, orig, zlib.crc32(fb)),
                self.config.delta,
            )
            for sid, fb in zip(missing, frag_bytes)
        }
        acks = yield RPC(
            dests=tuple(missing), msg=None, per_dest=per_dest, need="alive"
        )
        stats["pushed"] = len(missing)
        stats["applied"] = sum(1 for a in acks.values() if a[1])
        self._record(t0, stats)
        return stats

    def scan_and_repair(self, objs, *, parallel: bool = False) -> Generator:
        """Repair a set of objects; ``parallel=True`` overlaps them (Join),
        the default walks them sequentially (gentler on foreground traffic)."""
        objs = list(objs)
        if parallel:
            results = yield Join([self.repair_object(o) for o in objs])
            return results
        out = []
        for obj in objs:
            out.append((yield from self.repair_object(obj)))
        return out

    # --------------------------------------------------------------- record
    def _record(self, t0: float, stats: dict) -> None:
        self.history.append(
            OpRecord(
                kind="repair",
                obj=stats["obj"],
                client=self.client_id,
                start=t0,
                end=self.net.now,
                tag=stats["tag"],
                extra=dict(stats),
            )
        )


class RepairDaemon:
    """Rate-limited background repair loop (ISSUE 2) — the steady-state
    companion to the recon-triggered repair in ``CoAresClient.recon_batch``,
    replacing explicitly invoked ``DSS.repair`` passes.

    A periodic self-rescheduling generator on the sim: every ``period``
    virtual seconds one cycle repairs at most ``objs_per_cycle`` objects, so
    repair traffic is RATE-LIMITED and interferes boundedly with foreground
    reads/writes (Liquid Cloud Storage's lazy-repair argument: a slow steady
    repair flow is enough to keep MDS redundancy ahead of failures).

    Scheduling order (ISSUE 3, à la D-Rex): with ``order="margin"`` (the
    default) each cycle first runs ONE tag-only ``probe_health`` fan-out over
    everything ``discover(cfg_idx)`` returns, then repairs the objects with
    the SMALLEST surviving-fragment margin first — the most endangered data
    regains redundancy before comfortably-degraded data, and healthy objects
    are skipped entirely instead of wastefully re-scanned. ``order="rr"``
    keeps the old blind round-robin (the ablation baseline).

    The daemon covers a SET of configurations (``targets``): with
    ``auto_retarget=True`` its ``observe_recon`` callback (wired to the
    recon-finalization notifications by ``DSS.start_repair_daemon``) ADDS
    every newly finalized configuration it sees, while the configurations it
    already covers stay covered — a partial reconfiguration (some files
    moved, some not) never silently ends repair coverage for the objects
    left behind. Objects whose servers report a FINALIZED successor at an
    index (``ObjectHealth.superseded``) are historical state and are
    skipped. Non-EC targets idle (nothing coded to rebuild). An explicit
    ``retarget(config, cfg_idx)`` narrows coverage to exactly that one
    configuration (the pre-ISSUE-3 owner-driven contract). The loop runs
    until ``stop()`` (or ``max_cycles``); remember that ``Network.run()``
    drives the event loop to quiescence, so either bound the cycles, stop
    the daemon, or run with ``until=``.
    """

    def __init__(
        self,
        net,
        config: Config,
        cfg_idx: int = 0,
        *,
        discover,
        period: float = 0.05,
        objs_per_cycle: int = 4,
        max_cycles: int | None = None,
        client_id: str = "repaird",
        history: list | None = None,
        order: str = "margin",
        auto_retarget: bool = True,
    ):
        if order not in ("margin", "rr"):
            raise ValueError(f"unknown repair order {order!r}")
        self.net = net
        # configurations under repair coverage: (cfg_idx, cfg_id) -> Config.
        # Keyed by BOTH index and id — independent recons of different files
        # can install DIFFERENT configurations at the same sequence index,
        # and each must be probed against its own server set. The
        # ``config``/``cfg_idx`` properties expose the NEWEST target.
        self.targets: dict[tuple[int, str], Config] = {
            (cfg_idx, config.cfg_id): config
        }
        self.discover = discover          # cfg_idx -> iterable of object names
        self.period = period
        self.objs_per_cycle = max(1, objs_per_cycle)
        self.max_cycles = max_cycles
        self.client_id = client_id
        self.history = history if history is not None else []
        self.order = order
        self.auto_retarget = auto_retarget
        self.stats = {"cycles": 0, "objects": 0, "pushed": 0, "applied": 0,
                      "probed": 0, "retargets": 0, "pruned": 0, "gossip": 0}
        # targets pruned as fully superseded stay retired: config gossip
        # re-advertises old configurations forever (anti-entropy has no
        # tombstones), and re-ingesting one would start a prune/re-add
        # tug-of-war every cycle (ISSUE 4).
        self._retired: set[tuple[int, str]] = set()
        self._stopped = False
        self._cursor = 0
        self._fut = None

    @property
    def cfg_idx(self) -> int:
        return max(self.targets)[0]

    @property
    def config(self) -> Config:
        return self.targets[max(self.targets)]

    def covered_indices(self) -> list[int]:
        return sorted({idx for idx, _cid in self.targets})

    def start(self):
        """Spawn the loop onto the sim; returns the daemon's OpFuture."""
        self._fut = self.net.spawn(
            self._loop(), kind="repair-daemon", client=self.client_id
        )
        return self._fut

    def stop(self) -> None:
        """Ask the loop to exit at its next wake-up."""
        self._stopped = True

    def retarget(self, config: Config, cfg_idx: int) -> None:
        """Owner-driven narrowing: scan/repair exactly this configuration
        from the next cycle on (drops coverage of every other target; use
        ``observe_recon``/auto-retarget to ADD coverage instead)."""
        self.targets = {(cfg_idx, config.cfg_id): config}
        self._retired.discard((cfg_idx, config.cfg_id))  # explicit owner intent
        self._cursor = 0

    def observe_recon(self, config: Config, cfg_idx: int, objs=None) -> None:
        """Recon-finalization callback (``CoAresClient.on_recon`` shape): the
        daemon ADDS every newly installed configuration it sees to its
        coverage — the owner never has to call ``retarget`` (ISSUE 3). The
        configurations already covered stay covered: objects a partial recon
        left behind keep being repaired, and two files reconfigured to
        DIFFERENT configurations at the same index are both covered. Ignored
        once the daemon stopped or its loop completed (a stale subscription
        must not mutate it)."""
        if not self.auto_retarget or self._stopped:
            return
        if self._fut is not None and self._fut.done:
            return
        key = (cfg_idx, config.cfg_id)
        if key not in self.targets and key not in self._retired:
            self.targets[key] = config
            self.stats["retargets"] += 1

    def ingest_coverage(self, entries) -> int:
        """Gossip ingestion (ISSUE 4): ADD every ``(cfg_idx, Config)``
        coverage entry this daemon has not seen — how a daemon whose local
        client never ran (or observed) a reconfiguration still learns the
        configurations it should be repairing. Fed by the gateway tier's
        anti-entropy loop (``Gateway.register_daemon`` →
        ``gossip-configs``). Deliberately NOT gated on ``auto_retarget``:
        gossip is the membership channel that replaces the local recon
        callback, not an extension of it. Same staleness guards as
        ``observe_recon``; returns how many entries were new."""
        if self._stopped or (self._fut is not None and self._fut.done):
            return 0
        applied = 0
        for cfg_idx, config in entries:
            key = (cfg_idx, config.cfg_id)
            if key not in self.targets and key not in self._retired:
                self.targets[key] = config
                applied += 1
        self.stats["gossip"] += applied
        return applied

    def _ec_targets(self) -> list[tuple[int, Config]]:
        return [
            (idx, cfg)
            for (idx, _cid), cfg in sorted(self.targets.items())
            if cfg.dap in ("ec", "ec_opt")
        ]

    def _pick(self) -> Generator:
        """The (cfg_idx, config, obj) triples this cycle repairs — across
        ALL covered EC configurations, most endangered first (``margin``),
        or blind round-robin over the concatenated object lists (``rr``).

        An object probed under a same-index target it was never stored in
        simply reports nothing (tag TAG0) and is skipped there; its real
        health comes from its own configuration's probe. Margin mode also
        PRUNES stale targets: when every object a non-newest target
        discovers is superseded (a finalized successor exists), the target
        is dropped, so per-cycle probe traffic stays bounded as the store
        reconfigures over time."""
        if self.order == "rr":
            items = [
                (idx, cfg, obj)
                for idx, cfg in self._ec_targets()
                for obj in self.discover(idx)
            ]
            if not items:
                return []
            start = self._cursor % len(items)
            take = (items[start:] + items[:start])[: self.objs_per_cycle]
            self._cursor = (start + len(take)) % len(items)
            return take
        cands: list[tuple[int, str, int, Config]] = []
        newest = max(self.targets)
        for idx, cfg in self._ec_targets():
            objs = list(self.discover(idx))
            if not objs:
                continue
            health = yield from probe_health(cfg, idx, objs)
            self.stats["probed"] += len(health)
            if (idx, cfg.cfg_id) != newest and all(
                h.superseded for h in health.values()
            ):
                # everything here moved on to a finalized successor: stop
                # probing this configuration from the next cycle on (and
                # keep it retired — gossip re-advertises it forever)
                self.targets.pop((idx, cfg.cfg_id), None)
                self._retired.add((idx, cfg.cfg_id))
                self.stats["pruned"] += 1
                continue
            for h in health.values():
                # superseded state is historical (a finalized successor
                # exists at this index) — effort belongs to the successor
                if h.needs_repair and not h.superseded:
                    cands.append((h.margin, h.obj, idx, cfg))
        cands.sort(key=lambda c: (c[0], c[1], c[2]))
        return [(idx, cfg, obj) for _m, obj, idx, cfg in
                cands[: self.objs_per_cycle]]

    def _loop(self) -> Generator:
        while not self._stopped and (
            self.max_cycles is None or self.stats["cycles"] < self.max_cycles
        ):
            yield Sleep(self.period)
            if self._stopped:
                break
            take = yield from self._pick()
            by_target: dict[int, tuple[Config, list[str]]] = {}
            for idx, cfg, obj in take:
                by_target.setdefault(idx, (cfg, []))[1].append(obj)
            for idx, (cfg, objs) in by_target.items():
                rc = RepairController(
                    self.net, cfg, idx,
                    client_id=self.client_id, history=self.history,
                )
                results = yield from rc.scan_and_repair(objs)
                self.stats["objects"] += len(results)
                self.stats["pushed"] += sum(r["pushed"] for r in results)
                self.stats["applied"] += sum(r["applied"] for r in results)
            self.stats["cycles"] += 1
        return dict(self.stats)
