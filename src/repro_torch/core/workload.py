"""YCSB-style scale-out workload harness (ISSUE 7, ROADMAP item 5a).

The paper's evaluation drives tens of clients by hand (§VII); the ROADMAP
north star is heavy traffic from *millions*. ``WorkloadGen`` closes the gap
between those scales in the simulator: it plans a deterministic population of
lightweight sessions — zipfian file popularity, a read/write mix, arrival
churn over a virtual window, optional crash/recover storms landing mid-run —
and drives the plan through the existing ``Session``/``Gateway`` tiers, so a
10^5-session run exercises exactly the production surface (coalescing
windows, gateway merging, per-client accounting), not a side door.

Everything is drawn from one seeded ``numpy.random.Generator`` *before* the
clock starts, so a plan is a pure function of ``(spec, seed)`` and replays
identically on the fast and legacy network engines (``DSSParams.fast_net``).

    gen = WorkloadGen(WorkloadSpec(sessions=100_000, read_fraction=0.95))
    report = gen.run(dss)           # dss.net.run() to quiescence inside
    report["ops_done"], report["read_p99"], ...
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.api import Session


@dataclass(frozen=True)
class CrashStorm:
    """Crash a slice of the server fleet at virtual time ``at`` (seconds
    after the workload's sessions start arriving), recover it ``duration``
    later. By default the crash count is capped at ``n - quorum``
    live-tolerable failures so the storm degrades service without wedging
    every quorum — the churn-during-recon scenario ROADMAP 5a asks for, not
    a blackout. ``beyond_quorum=True`` (ISSUE 10) lifts the cap: with a
    ``DSSParams.retry`` policy armed, ops ride out the outage via
    deadline/retransmit and complete after recovery (or fail typed with
    ``QuorumUnavailableError``) — never hang. ``wipe`` selects
    crash-recovery (volatile caches cleared on rejoin) vs the legacy
    flag-flip."""

    at: float
    frac: float = 0.25          # fraction of servers to crash
    duration: float = 0.05      # virtual seconds until recovery
    beyond_quorum: bool = False  # lift the n - quorum crash cap
    wipe: bool = True           # crash-recovery: wipe volatile state on rejoin


@dataclass
class WorkloadSpec:
    sessions: int = 1000
    files: int = 64
    file_size: int = 1024       # bytes per pre-populated file
    read_fraction: float = 0.95
    zipf_s: float = 0.99        # zipf exponent (YCSB default skew)
    ops_per_session: int = 1
    think: float = 2e-3         # mean virtual think time between a session's ops
    span: float = 0.25          # session arrival window (virtual seconds)
    storms: tuple[CrashStorm, ...] = ()
    payload_variants: int = 8   # distinct write payloads cycled by writers
    collect_latencies: bool = True
    extra: dict = field(default_factory=dict)  # free-form, for bench labels


class WorkloadGen:
    """Deterministic zipfian workload planner + driver."""

    def __init__(self, spec: WorkloadSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    # ------------------------------------------------------------- planning
    def zipf_weights(self) -> np.ndarray:
        """P(file i) ∝ 1 / (i+1)^s — file 0 is the hottest."""
        ranks = np.arange(1, self.spec.files + 1, dtype=float)
        w = ranks ** -self.spec.zipf_s
        return w / w.sum()

    def plan(self) -> dict[str, np.ndarray]:
        """Pre-draw every random choice the run will make: per-op file ids,
        read/write flags, per-session arrival offsets and think times. All
        vector draws, all before virtual time starts — the run itself never
        touches this generator."""
        spec = self.spec
        rng = np.random.default_rng(self.seed)
        n_ops = spec.sessions * spec.ops_per_session
        fids = rng.choice(spec.files, size=n_ops, p=self.zipf_weights())
        is_read = rng.random(n_ops) < spec.read_fraction
        arrivals = rng.uniform(0.0, spec.span, spec.sessions)
        thinks = (
            rng.exponential(spec.think, n_ops)
            if spec.think > 0
            else np.zeros(n_ops)
        )
        payloads_seed = int(rng.integers(0, 2**31))
        return {
            "fids": fids,
            "is_read": is_read,
            "arrivals": arrivals,
            "thinks": thinks,
            "payloads_seed": payloads_seed,
        }

    def payloads(self, payloads_seed: int) -> list[bytes]:
        prng = np.random.default_rng(payloads_seed)
        return [
            prng.integers(0, 256, self.spec.file_size, dtype=np.uint8).tobytes()
            for _ in range(max(1, self.spec.payload_variants))
        ]

    # -------------------------------------------------------------- driving
    def _storm_plan(self, dss) -> list[tuple[CrashStorm, list[str]]]:
        """Resolve each storm to a concrete crash set, capped at the number
        of failures the initial configuration's quorum tolerates."""
        sids = sorted(
            (s for s in dss.net.servers if s.startswith("s")),
            key=lambda s: int(s[1:]),
        )[: dss.params.n_servers]
        out = []
        rng = np.random.default_rng([self.seed, 0x570])
        for storm in self.spec.storms:
            tolerable = (
                len(sids) if storm.beyond_quorum
                else max(0, len(sids) - dss.c0.quorum())
            )
            want = int(round(storm.frac * len(sids)))
            count = min(max(want, 1), tolerable)
            picks = sorted(rng.choice(len(sids), size=count, replace=False).tolist())
            out.append((storm, [sids[i] for i in picks]))
        return out

    def run(self, dss, *, via=None, window: float | None = None) -> dict[str, Any]:
        """Populate the files, launch every session on its arrival schedule,
        run the network to quiescence, and tally. ``via`` attaches every
        session through a Gateway; ``window`` overrides the Session
        coalescing window. Returns a flat metrics dict (all plain Python
        scalars, JSON-ready)."""
        spec = self.spec
        net = dss.net
        plan = self.plan()
        fnames = [f"f{i}" for i in range(spec.files)]
        payloads = self.payloads(plan["payloads_seed"])

        # pre-populate: distinct fids coalesce into one multi-file batch
        boot = dss.session("boot")
        for i, fname in enumerate(fnames):
            boot.write(fname, payloads[i % len(payloads)])
        net.run()

        kw: dict[str, Any] = {"via": via}
        if window is not None:
            kw["window"] = window
        base = net.now
        futures: list = []
        issue_times: list[float] = []  # per-future issue offset from base

        def launch(s: int) -> None:
            sess = Session(dss, f"u{s}", **kw)
            lo = s * spec.ops_per_session
            t = 0.0
            for o in range(spec.ops_per_session):
                i = lo + o
                fname = fnames[int(plan["fids"][i])]
                read = bool(plan["is_read"][i])
                pay = None if read else payloads[i % len(payloads)]

                def issue(sess=sess, fname=fname, read=read, pay=pay) -> None:
                    issue_times.append(net.now - base)
                    futures.append(
                        sess.read(fname) if read else sess.write(fname, pay)
                    )

                if spec.ops_per_session == 1:
                    issue()
                else:
                    net.schedule(t, issue)
                    t += float(plan["thinks"][i])

        for s in range(spec.sessions):
            net.schedule(float(plan["arrivals"][s]), lambda s=s: launch(s))
        for storm, crash_ids in self._storm_plan(dss):
            if not crash_ids:
                continue
            net.schedule(storm.at, lambda ids=crash_ids: dss.crash_servers(ids))
            net.schedule(
                storm.at + storm.duration,
                lambda ids=crash_ids, w=storm.wipe:
                    dss.recover_servers(ids, wipe=w),
            )
        net.run()

        ops = len(futures)
        ops_done = sum(1 for f in futures if f.done())
        ops_failed = sum(
            1 for f in futures if f.done() and f.exception() is not None
        )
        ops_ok = ops_done - ops_failed
        makespan = float(net.now - base)
        from repro_torch.net.sim import QuorumUnavailableError

        report: dict[str, Any] = {
            "sessions": spec.sessions,
            "ops": ops,
            "ops_done": ops_done,
            "ops_failed": ops_failed,
            "ops_stuck": ops - ops_done,
            "virtual_makespan": makespan,
            "rpc_rounds": net.rpc_rounds,
            "msg_count": net.msg_count,
            "bytes_sent": net.bytes_sent,
            "events": net.events_processed,
            # availability/goodput as first-class metrics (ISSUE 10): the
            # fraction of issued ops that completed successfully, and the
            # successful-op rate over the virtual makespan.
            "availability": ops_ok / ops if ops else 1.0,
            "goodput_ops_per_s": ops_ok / makespan if makespan > 0 else 0.0,
            # failure typing: with retries on, EVERY failure must be the
            # typed liveness error, never a hang or a stray exception.
            "quorum_unavailable": sum(
                1 for f in futures
                if f.done() and isinstance(f.exception(), QuorumUnavailableError)
            ),
            "stuck_rpcs": len(net.stuck_ops()),
            "retries": {
                "retransmits": net.retransmits,
                "rpc_timeouts": net.rpc_timeouts,
                "hedges": net.hedges,
                "op_retries": net.op_retries,
            },
        }
        if self.spec.storms:
            # post-recovery availability: ops issued after the LAST storm's
            # recovery point must essentially all succeed (the ≥99% gate the
            # chaos bench holds CI to).
            recovery_end = max(s.at + s.duration for s in self.spec.storms)
            after = [
                f for f, t in zip(futures, issue_times) if t >= recovery_end
            ]
            ok_after = sum(
                1 for f in after if f.done() and f.exception() is None
            )
            report["ops_after_recovery"] = len(after)
            report["availability_after_recovery"] = (
                ok_after / len(after) if after else 1.0
            )
        if getattr(net, "sanitizer", None) is not None:
            # sanitized run (ISSUE 8): every fan-out/reply was checked live;
            # close with the post-hoc Wing–Gong pass over the recorded
            # history. Reads-from is only provable when every op recorded
            # itself — crash storms leave failed/stuck writers whose tags
            # reads may legitimately observe.
            from repro_torch.analysis.linearize import check_tag_linearizable

            # phase retries leave orphan intermediate tags (an abandoned
            # attempt's put may land without its history record), so strict
            # reads-from is only provable on retry-free runs.
            strict = (
                ops_failed == 0 and ops - ops_done == 0
                and net.op_retries == 0
            )
            lin = check_tag_linearizable(dss.history, strict_reads=strict)
            report["sanitizer"] = dict(net.sanitizer.report(), **{
                "linearized_objects": lin["objects"],
                "linearized_ops": lin["ops"],
                "strict_reads": strict,
            })
        if getattr(net, "race_tracker", None) is not None:
            # race-checked run (ISSUE 9): every in-handle mutation was
            # ordered and summary-checked live; surface the counters.
            report["races"] = net.race_tracker.report()
        if spec.collect_latencies:
            lats = [
                f.stats.latency
                for f in futures
                if f.done() and f.exception() is None and f.stats is not None
            ]
            reads = [
                f.stats.latency
                for f in futures
                if f.kind == "read" and f.done() and f.exception() is None
                and f.stats is not None
            ]
            for label, xs in (("op", lats), ("read", reads)):
                if xs:
                    report[f"{label}_p50"] = float(np.percentile(xs, 50))
                    report[f"{label}_p99"] = float(np.percentile(xs, 99))
        return report
