"""The gateway tier of repro_torch against repro's: the same scenarios, equal results.

Each scenario of ``tests/test_gateway.py`` runs on both packages from the
same seed and the same data (64 KiB files, 4/8/32 KiB blocks), on both
network engines: same-file read merging, per-rider attribution, cross-client
program order, same-fid writes, merged recon multicast, gossip-fed repair
and symmetric gossip, rider stats beside gossip and recon repair, a
two-session race through a recon, and a stat rider surviving a mid-flight
crash. The port runs its data plane on the CPU (``device="cpu"``, the plain
versions of its kernels). Everything a scenario returns must be equal:
the futures' results, each rider's ``OpStats``, the gateway's and the
daemons' counters, the recorded history and the network's counters. Each
scenario asserts ``stuck_ops() == []`` itself, since the suite's leak check
hooks only ``repro.net.sim.Network``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.server as ref_server
import repro_torch.core as port_core
import repro_torch.core.gateway as port_gateway
import repro_torch.core.server as port_server

FILE = 64 << 10
BLOCKS = dict(min_block=4 << 10, avg_block=8 << 10, max_block=32 << 10)

REF = SimpleNamespace(core=ref_core, server=ref_server, kw={})
PORT = SimpleNamespace(core=port_core, server=port_server,
                       kw=dict(device="cpu", coding_backend="kernel"))


def _blob(seed, size=FILE):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _dss(P, fast, alg="coaresecf", n=6, m=2, seed=0, blocks=True, **kw):
    return P.core.DSS(P.core.DSSParams(
        algorithm=alg, n_servers=n, parity_m=m, seed=seed, fast_net=fast,
        **(BLOCKS if blocks else {}), **P.kw, **kw))


def _stats(futs):
    return [dataclasses.astuple(f.stats) for f in futs]


def _plain(x):
    """``x`` with every dataclass (a package's own ``ObjectHealth``, say)
    replaced by its class name and fields, so both packages' results compare."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _trace(dss):
    net = dss.net
    assert net.stuck_ops() == []
    return {
        "history": [dataclasses.astuple(r) for r in dss.history],
        "net": (round(net.now, 12), net.events_processed, net.rpc_rounds, net.msg_count,
                net.bytes_sent, net.client_counters),
    }


# ---------------------------------------------------------------- scenarios
def merge_reads(P, fast, monkeypatch):
    out = {}
    for C in (2, 8):
        dss = _dss(P, fast, indexed=True, seed=11)
        doc = _blob(1)
        dss.session("boot").write("hot", doc).result()
        gw = dss.gateway()
        futs = [dss.session(f"c{i}", via=gw).read("hot") for i in range(C)]
        got = P.core.gather(*futs)
        assert got == [doc] * C
        direct = [dss.session(f"d{i}").read("hot") for i in range(C)]
        assert P.core.gather(*direct) == [doc] * C
        out[C] = {"stats": _stats(futs + direct), "gw": dict(gw.stats), **_trace(dss)}
    return out


def attribution(P, fast, monkeypatch):
    dss = _dss(P, fast, indexed=True, seed=13)
    dss.session("boot").write("f", _blob(2)).result()
    gw = dss.gateway()
    fa, fb = gw.session("a").read("f"), gw.session("b").read("f")
    P.core.gather(fa, fb)
    totals = [dss.net.client_totals(c) for c in ("a", "b", gw.gid)]
    assert totals[0] == totals[1] == totals[2] and not dss.net.client_attribution
    dss.session("solo").read("f").result()
    return {"totals": totals, "after": dss.net.client_totals("a"), "stats": _stats([fa, fb]),
            **_trace(dss)}


def program_order(P, fast, monkeypatch):
    dss = _dss(P, fast, indexed=True, seed=17)
    doc = _blob(3)
    gw = dss.gateway()
    wfut, rfut = gw.session("c1").write("f", doc), gw.session("c2").read("f")
    assert rfut.result() == doc
    return {"write": wfut.result(), "stats": _stats([wfut, rfut]), **_trace(dss)}


def same_fid_writes(P, fast, monkeypatch):
    dss = _dss(P, fast, indexed=True, seed=19)
    gw = dss.gateway()
    f1, f2 = gw.session("c1").write("f", _blob(4)), gw.session("c2").write("f", _blob(5))
    res = P.core.gather(f1, f2)
    assert f1.stats.batched_with == f2.stats.batched_with == 1
    assert dss.session("check").read("f").result() == _blob(5)
    return {"res": res, "stats": _stats([f1, f2]), **_trace(dss)}


def recon_multicast(P, fast, monkeypatch):
    dss = _dss(P, fast, n=7, m=3, indexed=True, seed=23)
    boot = dss.session("boot")
    P.core.gather(boot.write("x", _blob(6)), boot.write("y", _blob(7)))
    gw = dss.gateway()
    c1, c2 = gw.session("c1"), gw.session("c2")
    cfg1 = dss.make_config(n_servers=7)
    futs = [c1.recon("x", cfg1), c2.recon("x", cfg1), c2.recon("y", cfg1)]
    res = P.core.gather(*futs)
    assert res[0] == res[1] and futs[0].stats.batched_with == 3
    dss.net.run()
    assert dss.session("check").read("x").result() == _blob(6)
    return {"res": res, "stats": _stats(futs), **_trace(dss)}


def gossip_repair(P, fast, monkeypatch):
    dss = _dss(P, fast, alg="coaresec", n=6, m=4, seed=31, blocks=False, recon_repair=False)
    gw = dss.gateway()
    w = dss.client("w")
    dss.net.run_op(w.update("f", _blob(8)), client="w")
    dss.net.run()
    daemon = dss.start_repair_daemon(period=0.01, objs_per_cycle=2, auto_retarget=False)
    gw.register_daemon(daemon)
    cfg1 = dss.make_config()
    fut = dss.net.spawn(dss.client("g").recon("f", cfg1), client="g")
    dss.net.run(until=dss.net.now + 0.2)
    assert fut.done and (1, cfg1.cfg_id) in daemon.targets
    lst = dss.net.servers["s3"].ec[("f", 1)]
    t_star = max(t for t, e in lst.items() if e is not None)
    del lst[t_star]
    dss.net.run(until=dss.net.now + 0.3)
    dss.stop_repair_daemon()
    gw.stop()
    dss.net.run()
    repaired = dss.net.servers["s3"].ec[("f", 1)].get(t_star)
    assert repaired is not None
    return {"daemon": dict(daemon.stats), "gw": dict(gw.stats), "repaired": repaired,
            "targets": sorted(daemon.targets), **_trace(dss)}


def gossip_symmetric(P, fast, monkeypatch):
    dss = _dss(P, fast, alg="coaresec", n=6, m=4, seed=37, blocks=False, recon_repair=False)
    gw = dss.gateway()
    dss.net.run_op(dss.client("w").update("f", _blob(9, 1000)), client="w")
    daemon = dss.start_repair_daemon(period=0.01, objs_per_cycle=1)
    gw.register_daemon(daemon)
    cfg9 = dss.make_config()
    daemon.observe_recon(cfg9, 3)
    dss.net.run(until=dss.net.now + 0.1)
    dss.stop_repair_daemon()
    gw.stop()
    dss.net.run()
    assert (3, cfg9.cfg_id) in gw.coverage
    return {"gw": dict(gw.stats), "coverage": sorted(gw.coverage), **_trace(dss)}


def rider_stats_unpolluted(P, fast, monkeypatch):
    dss = _dss(P, fast, n=7, m=3, indexed=True, seed=53)
    doc = _blob(11)
    dss.session("boot").write("hot", doc).result()
    gw = dss.gateway("gw1", gossip_period=0.0005)
    daemon = dss.start_repair_daemon(period=0.01, objs_per_cycle=1, auto_retarget=False)
    gw.register_daemon(daemon)
    a, b = gw.session("a"), gw.session("b")
    fa, fb = a.read("hot"), b.read("hot")
    assert P.core.gather(fa, fb) == [doc, doc]
    cfg1 = dss.make_config(n_servers=7)
    f1, f2 = a.recon("hot", cfg1), b.recon("hot", cfg1)
    P.core.gather(f1, f2)
    dss.net.run(until=dss.net.now + 0.1)
    assert dss.net.client_totals("gw1:recon-repair")[0] > 0
    dss.stop_repair_daemon()
    gw.stop()
    dss.net.run()
    return {"stats": _stats([fa, fb, f1, f2]), "gossip": dss.net.client_totals("gw1:gossip"),
            "daemon": dict(daemon.stats), **_trace(dss)}


def race_through_recon(P, fast, monkeypatch):
    dss = _dss(P, fast, n=7, m=3, indexed=True, seed=43)
    files = ["f0", "f1", "f2"]
    docs = {f: _blob(50 + i) for i, f in enumerate(files)}
    boot = dss.session("boot")
    P.core.gather(*[boot.write(f, d) for f, d in docs.items()])
    gw = dss.gateway()
    daemon = dss.start_repair_daemon(period=0.01, objs_per_cycle=3, auto_retarget=False)
    gw.register_daemon(daemon)
    a, b = gw.session("a"), gw.session("b")
    edits = {f: _blob(60 + i) for i, f in enumerate(files)}
    cfg1 = dss.make_config(n_servers=7)
    futs = [a.write("f0", edits["f0"]), b.read("f0"), a.recon("f1", cfg1),
            b.write("f2", edits["f2"]), a.read("f2"), b.recon("f2", cfg1)]
    res = P.core.gather(*futs)
    dss.net.run(until=dss.net.now + 0.1)
    dss.stop_repair_daemon()
    gw.stop()
    dss.net.run()
    got = P.core.gather(*[dss.session("check").read(f) for f in files])
    assert got[0] == edits["f0"] and got[2] == edits["f2"] and got[1] == docs["f1"]
    return {"res": res, "got": got, "stats": _stats(futs), "daemon": dict(daemon.stats),
            **_trace(dss)}


def stat_rider_crash(P, fast, monkeypatch):
    dss = _dss(P, fast, indexed=True, seed=17)
    net = dss.net
    dss.session("boot").write("f", _blob(3)).result()
    gw = dss.gateway()
    a, b = gw.session("a"), gw.session("b")
    crashed, handled = [], []
    real = P.server.StorageServer.handle

    def spy(self, sender, msg):
        if msg and msg[0] == "margin-batch":
            handled.append(self.sid)
            if not crashed:
                victim = next(s for s in net.servers if s != self.sid and s not in handled)
                crashed.append(victim)
                net.crash(victim)
        return real(self, sender, msg)

    monkeypatch.setattr(P.server.StorageServer, "handle", spy)
    fa, fb = a.stat("f"), b.stat("f")
    res = P.core.gather(fa, fb)
    monkeypatch.undo()
    assert crashed and crashed[0] not in handled and res[0] == res[1]
    return {"res": res, "crashed": crashed, "stats": _stats([fa, fb]), **_trace(dss)}


SCENARIOS = [merge_reads, attribution, program_order, same_fid_writes, recon_multicast,
             gossip_repair, gossip_symmetric, rider_stats_unpolluted, race_through_recon,
             stat_rider_crash]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_gateway_scenario_equals_reference(scenario, fast, monkeypatch):
    ref = scenario(REF, fast, monkeypatch)
    port = scenario(PORT, fast, monkeypatch)
    assert port.keys() == ref.keys()
    for key in ref:
        assert _plain(port[key]) == _plain(ref[key]), key


def test_merged_reads_are_flat_in_clients():
    """The gateway's acceptance bar holds in the port: C riders of one hot
    file cost the rounds of one read, and C detached sessions C times that."""
    out = merge_reads(PORT, True, None)
    fields = list(port_core.OpStats.__dataclass_fields__)
    rounds, batched = fields.index("rounds"), fields.index("batched_with")
    for C in (2, 8):
        riders, direct = out[C]["stats"][:C], out[C]["stats"][C:]
        assert all(s[batched] == C and s[rounds] == riders[0][rounds] for s in riders)
        assert sum(s[rounds] for s in direct) == C * riders[0][rounds]
        assert out[C]["gw"]["dedup_saved"] == C - 1
    assert out[2]["stats"][0][rounds] == out[8]["stats"][0][rounds] > 0


def test_gateway_is_the_ports_own():
    dss = _dss(PORT, True, indexed=True)
    gw = dss.gateway()
    assert isinstance(gw, port_gateway.Gateway)
    assert port_core.Gateway is port_gateway.Gateway
    assert port_core.GossipListener is port_gateway.GossipListener
    sess = dss.session("c", via=gw)
    assert sess.via is gw
    gw.stop()
    dss.net.run()
    assert dss.net.stuck_ops() == []
