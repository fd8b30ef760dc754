"""repro_torch's analysis stack against repro's: same verdicts, same schedules.

* The Wing–Gong linearizer, the protocol sanitizer and the race tracker
  raise the same error types, with the same messages, on the cases of
  ``tests/test_analysis.py``, ``tests/test_legacy_sanitize.py`` and
  ``tests/test_explore.py``, and stay silent where the reference does.
* The port's ``DSS`` attaches them as the reference's does
  (``sanitize=``/``racecheck=`` or ``REPRO_SANITIZE=1``/``REPRO_RACECHECK=1``),
  and a sanitized trace equals the unsanitized one.
* The lint pack of the port (``python -m repro_torch.analysis``) finds
  nothing over ``src/repro_torch``.
* The schedule explorer finds each of the four seeded faults in the same
  number of schedules as the reference's, with the same decision log,
  violation and fingerprint (the whole bundle is equal), and the port's
  bundle replays byte-identically. Its fault hooks patch the port's classes,
  not the reference's, and restore them.

The port runs its data plane on the CPU (``device="cpu"``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.analysis.explore as ref_explore
import repro.analysis.linearize as ref_lin
import repro.analysis.races as ref_races
import repro.analysis.sanitizer as ref_san
import repro.core.server as ref_server
import repro.core.store as ref_store
import repro.core.tags as ref_tags
import repro.net.sim as ref_sim
import repro_torch.analysis.explore as port_explore
import repro_torch.analysis.linearize as port_lin
import repro_torch.analysis.races as port_races
import repro_torch.analysis.sanitizer as port_san
import repro_torch.core.server as port_server
import repro_torch.core.store as port_store
import repro_torch.core.tags as port_tags
import repro_torch.net.sim as port_sim
from repro_torch.analysis import astlint, invariants

SRC = Path(__file__).resolve().parents[1] / "src"

REF = SimpleNamespace(lin=ref_lin, san=ref_san, races=ref_races, server=ref_server,
                      store=ref_store, tags=ref_tags, kw={})
PORT = SimpleNamespace(lin=port_lin, san=port_san, races=port_races, server=port_server,
                       store=port_store, tags=port_tags, kw=dict(device="cpu"))


def _outcome(fn):
    """("ok", value) or (error type name, message) of ``fn()``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return (type(e).__name__, str(e))


def _dss(P, **kw):
    return P.store.DSS(P.store.DSSParams(**kw, **P.kw))


# --------------------------------------------------------------- linearizer
HISTORIES = {
    # label: ([(kind, obj, client, start, end, tag, flag)], strict_reads)
    "legal": ([("write", "o", "w1", 0.0, 1.0, (1, "w1"), "chg"),
               ("read", "o", "r1", 1.5, 2.0, (1, "w1"), "chg"),
               ("write", "o", "w2", 1.8, 2.5, (2, "w2"), "chg"),
               ("read", "o", "r2", 3.0, 3.5, (2, "w2"), "chg"),
               ("recon", "o", "c", 0.0, 4.0, (2, "w2"), "chg")], True),
    "stale read": ([("write", "o", "w1", 0.0, 1.0, (1, "w1"), "chg"),
                    ("write", "o", "w2", 1.5, 2.0, (2, "w2"), "chg"),
                    ("read", "o", "r1", 2.5, 3.0, (1, "w1"), "chg")], True),
    "duplicate write tags": ([("write", "o", "w1", 0.0, 1.0, (1, "x"), "chg"),
                              ("write", "o", "w2", 2.0, 3.0, (1, "x"), "chg")], True),
    "unrecorded producer, strict": ([("write", "o", "w1", 0.0, 1.0, (1, "w1"), "chg"),
                                     ("read", "o", "r1", 1.5, 2.0, (2, "crashed"), "chg")],
                                    True),
    "unrecorded producer, relaxed": ([("write", "o", "w1", 0.0, 1.0, (1, "w1"), "chg"),
                                      ("read", "o", "r1", 1.5, 2.0, (2, "crashed"), "chg")],
                                     False),
    "concurrent any order": ([("write", "o", "w1", 0.0, 1.0, (1, "w1"), "chg"),
                              ("write", "o", "w2", 0.5, 3.0, (2, "w2"), "chg"),
                              ("read", "o", "r1", 1.6, 2.6, (2, "w2"), "chg"),
                              ("read", "o", "r2", 1.7, 2.5, (1, "w1"), "chg")], True),
}


LEGAL = ("legal", "unrecorded producer, relaxed", "concurrent any order")


@pytest.mark.parametrize("label", list(HISTORIES))
def test_linearizer_verdict_equals_reference(label):
    recs, strict = HISTORIES[label]
    got = []
    for P in (REF, PORT):
        hist = [P.tags.OpRecord(kind=k, obj=o, client=c, start=s, end=e, tag=t, flag=f)
                for k, o, c, s, e, t, f in recs]
        got.append(_outcome(lambda: P.lin.check_tag_linearizable(hist, strict_reads=strict)))
    assert got[1] == got[0]
    assert (got[1][0] == "ok") == (label in LEGAL)


# ---------------------------------------------------------------- sanitizer
class _Rpc:
    def __init__(self, dests, msg):
        self.dests, self.msg, self.per_dest = dests, msg, None


def _sanitizer_steps(P):
    five = tuple(f"s{i}" for i in range(5))
    t1, t2 = (1, "w"), (2, "w")
    cfg1 = P.tags.Config("c1", ("s0",), dap="abd", k=1, delta=8)
    cfg2 = P.tags.Config("c2", ("s0",), dap="abd", k=1, delta=8)
    return [
        lambda s: s.on_rpc(_Rpc(five, ("abd-get", "o", 0, None)), 3),
        lambda s: s.on_rpc(_Rpc(five, ("abd-get", "o", 0, None)), 2),
        lambda s: s.register_config(P.tags.Config("c1", five, dap="ec_opt", k=3, delta=8)),
        lambda s: s.on_rpc(_Rpc(five, ("ec-query", "o", 0, None)), 3),
        lambda s: s.on_rpc(_Rpc(five, ("ec-query", "o", 0, None)), 4),
        lambda s: s.on_rpc(_Rpc(five, ("margin-batch", ("o",), 0)), None),
        lambda s: s.on_rpc(_Rpc(five, ("not-a-real-op", 1)), 3),
        lambda s: s.on_reply("s0", ("abd-get", "o", 0, None), ("abd-val", t2, b"v")),
        lambda s: s.on_reply("s0", ("abd-get", "o", 0, None), ("abd-val", t1, b"v")),
        lambda s: s.forget("s0", "o"),
        lambda s: s.on_reply("s0", ("abd-get", "o", 0, None), ("abd-val", t1, b"v")),
        lambda s: s.on_reply("s0", ("abd-get", "o", 0, None), ("not-a-reply", 1)),
        lambda s: s.on_reply("s1", ("read-next", "o", 0), ("next-c", (cfg1, "F"))),
        lambda s: s.on_reply("s1", ("read-next", "o", 0), ("next-c", (cfg2, "P"))),
        lambda s: s.on_reply("s1", ("write-next", "o", 0, cfg2, "F"), ("ack",)),
        lambda s: s.report(),
    ]


def test_sanitizer_unit_verdicts_equal_reference():
    seen = []
    for P in (REF, PORT):
        san = P.san.ProtocolSanitizer()
        seen.append([_outcome(lambda step=step: step(san)) for step in _sanitizer_steps(P)])
    assert seen[1] == seen[0]
    kinds = [k for k, _ in seen[1]]
    assert kinds.count("SanitizerError") == 7 and kinds[-1] == "ok"


def _seeded_off_by_one(P, fast, monkeypatch):
    monkeypatch.setattr(P.tags.Config, "quorum", lambda self: len(self.servers) // 2)
    dss = _dss(P, algorithm="coaresecf", sanitize=True, fast_net=fast)
    dss.session("c1").write("f", b"x" * 256)
    return _outcome(dss.run)


def _bypassing_regression(P, fast, monkeypatch):
    dss = _dss(P, algorithm="coaresabd", n_servers=3, sanitize=True, fast_net=fast)
    sess = dss.session("c1")
    sess.write("f", b"v1")
    dss.run()
    sess.read("f")
    dss.run()
    srv = dss.net.servers["s0"]
    dict.__setitem__(srv.abd, ("f", 0), (P.tags.TAG0, None))
    dict.clear(srv._rcache)
    dict.clear(srv._rkeys)
    sess.read("f")
    return _outcome(dss.run)


def _tracked_injection_forgiven(P, fast, monkeypatch):
    dss = _dss(P, algorithm="coaresabd", sanitize=True, fast_net=fast)
    sess = dss.session("c1")
    sess.write("f", b"v1")
    dss.run()
    sess.read("f")
    dss.run()
    dss.net.servers["s0"].abd[("f", 0)] = (P.tags.TAG0, None)
    fut = sess.read("f")
    dss.run()
    assert dss.net.stuck_ops() == []
    return fut.result(), dss.net.sanitizer.report(), dss.net.sanitizer.forgets


def _recon_and_gateway(P, fast, monkeypatch):
    dss = _dss(P, algorithm="coaresecf", n_servers=5, parity_m=1, sanitize=True,
               racecheck=True, fast_net=fast)
    gw = dss.gateway("gw")
    s1, s2 = gw.session("c1"), gw.session("c2")
    s1.write("f", b"a" * 512)
    s2.write("g", b"b" * 512)
    dss.run()
    target = dss.make_config(n_servers=5, parity_m=2, fresh_servers=True)
    s1.recon("f", target)
    dss.run()
    reads = [s2.read("f"), s1.read("g")]
    dss.run()
    gw.stop()
    dss.run()
    assert dss.net.stuck_ops() == []
    san = dss.net.sanitizer
    assert san.known_k[frozenset(target.servers)] == target.k
    return ([f.result() for f in reads], dss.check_history(), san.report(),
            dss.net.race_tracker.report(), dss.net.events_processed, dss.net.bytes_sent)


def _fragmented_write_read(P, fast, monkeypatch):
    dss = _dss(P, algorithm="coaresecf", n_servers=4, seed=5, sanitize=True,
               racecheck=True, fast_net=fast)
    sess = dss.session("c1")
    sess.write("f", bytes(range(256)) * 24)
    dss.run()
    fut = sess.read("f")
    dss.run()
    assert fut.result() == bytes(range(256)) * 24 and dss.net.stuck_ops() == []
    return dss.check_history(), dss.net.race_tracker.report(), dss.net.sanitizer.report()


LIVE = [_seeded_off_by_one, _bypassing_regression, _tracked_injection_forgiven,
        _recon_and_gateway, _fragmented_write_read]
EXPECT = {"_seeded_off_by_one": "SanitizerError", "_bypassing_regression": "SanitizerError"}


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("case", [
    # the two seeded violations stop the run with a quorum round in flight
    pytest.param(c, marks=[pytest.mark.allow_stuck] if c.__name__ in EXPECT else [],
                 id=c.__name__.strip("_"))
    for c in LIVE])
def test_live_sanitizer_equals_reference(case, fast, monkeypatch):
    ref = case(REF, fast, monkeypatch)
    port = case(PORT, fast, monkeypatch)
    assert port == ref
    if case.__name__ in EXPECT:
        assert port[0] == EXPECT[case.__name__]
        assert "majority" in port[1] or "quorum" in port[1] or "monotonicity" in port[1]


def test_store_attaches_observers_like_the_reference(monkeypatch):
    dss = _dss(PORT, algorithm="coabd", n_servers=3, sanitize=True, racecheck=True)
    assert isinstance(dss.net.sanitizer, port_san.ProtocolSanitizer)
    assert isinstance(dss.net.race_tracker, port_races.RaceTracker)
    assert dss.net.servers["s0"]._race_observer is not None
    plain = _dss(PORT, algorithm="coabd", n_servers=3)
    assert plain.net.sanitizer is None and plain.net.race_tracker is None
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    monkeypatch.setenv("REPRO_RACECHECK", "1")
    env = _dss(PORT, algorithm="coabd", n_servers=3)
    assert env.net.sanitizer is not None and env.net.race_tracker is not None


# ------------------------------------------------------------- race tracker
def _tracker(P):
    class _Net:
        pass

    net = _Net()
    srv = P.server.StorageServer("s0")
    net.servers = {"s0": srv}
    net.race_tracker = None
    rt = P.races.RaceTracker()
    rt.net = net
    return rt, srv


class _FakeFut:
    def __init__(self, op_id):
        self.op_id, self.client, self.kind = op_id, f"c{op_id}", "t"


class _FakeState:
    def __init__(self, op_id):
        self.fut = _FakeFut(op_id)


def _put(rt, srv, state, tag):
    rt.before_handle("s0", state)
    srv.abd[("f", 0)] = (tag, b"v")
    rt.on_mutation("s0", "f", True)
    rt.after_handle("s0")


def _unordered(P):
    rt, srv = _tracker(P)
    s1, s2 = _FakeState(1), _FakeState(2)
    rt.on_issue(s1, None)
    rt.on_issue(s2, None)
    _put(rt, srv, s1, (2, "c1"))
    return _outcome(lambda: _put(rt, srv, s2, (1, "c2")))


def _ordered(P):
    rt, srv = _tracker(P)
    s1 = _FakeState(1)
    rt.on_issue(s1, None)
    _put(rt, srv, s1, (2, "c1"))
    s2q = _FakeState(2)
    rt.on_issue(s2q, None)
    rt.before_handle("s0", s2q)
    rt.after_handle("s0")
    rt.on_reply("s0", s2q)
    s2p = _FakeState(2)
    rt.on_issue(s2p, None)
    return _outcome(lambda: _put(rt, srv, s2p, (1, "c2")))


def _benign(P):
    rt, srv = _tracker(P)
    s1, s2 = _FakeState(1), _FakeState(2)
    rt.on_issue(s1, None)
    rt.on_issue(s2, None)
    _put(rt, srv, s1, (1, "c1"))
    _put(rt, srv, s2, (1, "c2"))
    return rt.concurrent_writes, rt.report()


@pytest.mark.parametrize("case", [_unordered, _ordered, _benign],
                         ids=["unordered", "ordered", "benign"])
def test_race_tracker_verdict_equals_reference(case):
    port = case(PORT)
    assert port == case(REF)
    if case is not _benign:
        assert port[0] == "RaceError"
        assert ("UNORDERED" if case is _unordered else "ordered AFTER") in port[1]


# ---------------------------------------------------------------- lint pack
def test_port_lint_pack_is_clean_over_the_port():
    assert invariants.package_root() == SRC / "repro_torch"
    findings = invariants.collect_findings()
    assert findings == [], "\n".join(map(str, findings))
    assert astlint.run_rules(SRC / "repro_torch", invariants.MODULE_RULES,
                             invariants.REPO_RULES) == []


def test_port_lint_cli_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout


# ----------------------------------------------------------------- explorer
FAULTS = {
    # the configs and budgets of tests/test_explore.py
    "early-read-resume": ("wr", dict(mode="pct", budget=500), "LinearizabilityError"),
    "ack-rollback": ("wr", dict(mode="pct", drop_budget=1, budget=500), "SanitizerError"),
    "unguarded-put": ("ww", dict(mode="dfs", budget=200, branch_depth=6), "RaceError"),
    "retry-dup-write": ("ww", dict(mode="pct", crash_budget=1, drop_budget=1, retry=True,
                                   budget=500), "RaceError"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_explorer_finds_fault_like_the_reference(fault, tmp_path):
    scenario, kw, expect = FAULTS[fault]
    ref = ref_explore.explore(ref_explore.ExploreConfig.for_scenario(scenario, fault=fault, **kw))
    before = dict(port_server.StorageServer._DISPATCH)
    ref_before = dict(ref_server.StorageServer._DISPATCH)
    port = port_explore.explore(
        port_explore.ExploreConfig.for_scenario(scenario, fault=fault, **kw), device="cpu")
    assert port.found and ref.found
    assert port.schedules == ref.schedules and port.pruned == ref.pruned
    pb, rb = port.violations[0], ref.violations[0]
    assert pb["violation"]["type"] == expect
    for key in ("schedule", "violation", "fingerprint", "report", "config", "seed_params"):
        assert pb[key] == rb[key], key
    assert pb == rb
    path = port_explore.write_bundle(pb, str(tmp_path))
    loaded = port_explore.load_bundle(path)
    assert loaded == json.loads(json.dumps(loaded))
    rep = port_explore.replay_bundle(loaded, device="cpu")
    assert rep["reproduced"] and rep["fingerprint_matches"], rep
    assert dict(port_server.StorageServer._DISPATCH) == before
    assert dict(ref_server.StorageServer._DISPATCH) == ref_before


def test_fault_hooks_patch_the_port_and_restore():
    port_put = port_server.StorageServer._DISPATCH["abd-put"]
    port_putb = port_server.StorageServer._DISPATCH["abd-put-batch"]
    ref_put = ref_server.StorageServer._DISPATCH["abd-put"]
    port_init, ref_init = port_sim._RpcState.__init__, ref_sim._RpcState.__init__
    for fault, kw in (("early-read-resume", {}), ("ack-rollback", {"drop_budget": 1}),
                      ("unguarded-put", {}),
                      ("retry-dup-write", {"crash_budget": 1, "drop_budget": 1,
                                           "retry": True})):
        cfg = port_explore.ExploreConfig.for_scenario("wr", fault=fault, **kw)
        hook = port_explore.FAULTS[fault]
        with hook(None, port_explore.ScheduleController()):
            port_now = dict(port_server.StorageServer._DISPATCH)
            ref_now = dict(ref_server.StorageServer._DISPATCH)
            if fault == "early-read-resume":
                assert port_sim._RpcState.__init__ is not port_init
                assert ref_sim._RpcState.__init__ is ref_init
            else:
                assert port_now["abd-put"] is not port_put
                assert ref_now["abd-put"] is ref_put
        port_explore.run_schedule(cfg, device="cpu")
        assert port_server.StorageServer._DISPATCH["abd-put"] is port_put
        assert port_server.StorageServer._DISPATCH["abd-put-batch"] is port_putb
        assert port_sim._RpcState.__init__ is port_init
        assert ref_server.StorageServer._DISPATCH["abd-put"] is ref_put


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_fifo_schedule_and_clean_sweep_equal_reference(fast):
    for mod, kw in ((ref_explore, {}), (port_explore, {"device": "cpu"})):
        out = mod.run_schedule(mod.ExploreConfig.for_scenario("wr", fast_net=fast), **kw)
        assert out.violation is None
    ref = ref_explore.run_schedule(ref_explore.ExploreConfig.for_scenario("wr", fast_net=fast))
    port = port_explore.run_schedule(port_explore.ExploreConfig.for_scenario("wr", fast_net=fast),
                                     device="cpu")
    assert (port.decisions, port.trace, port.fingerprint, port.report) == \
        (ref.decisions, ref.trace, ref.fingerprint, ref.report)
    assert port.report["ops_incomplete"] == 0  # the schedule's network drained
    cfg = dict(mode="pct", budget=12, stop_on_first=False, fast_net=fast)
    r = ref_explore.explore(ref_explore.ExploreConfig.for_scenario("ec-recon", **cfg))
    p = port_explore.explore(port_explore.ExploreConfig.for_scenario("ec-recon", **cfg),
                             device="cpu")
    assert (p.schedules, p.violations, p.pruned) == (r.schedules, r.violations, r.pruned) == \
        (12, [], 0)


def test_explorer_selftest_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.explore", "--selftest", "--device", "cpu",
         "--budget", "500", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("[selftest] ok:") == 4
    assert len(list(tmp_path.glob("*.json"))) == 4
