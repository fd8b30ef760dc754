"""``WorkloadGen.run`` on repro_torch and on repro: the same report, key for key.

The YCSB-style harness is copied verbatim into the port, so a plan drawn
from ``(spec, seed)`` must schedule the same events in the same order and
tally the same report. Each case runs on both packages and both network
engines, and every key of the report must be equal, as must the recorded
history and the network's counters:

* direct sessions and sessions attached through one ``dss.gateway()``;
* a tolerable ``CrashStorm`` (capped at n - quorum crashes), direct and
  through the gateway;
* ``benchmarks/bench_chaos.py``'s beyond-quorum storm under ``RetryPolicy()``
  at 40 sessions;
* ``sanitize=True, racecheck=True``, clean and under a storm, where the
  ``sanitizer`` and ``races`` sub-reports must be equal too, and the
  sanitized trace must equal the unsanitized one.

The port runs its data plane on the CPU (``device="cpu"``). Each case
asserts ``stuck_ops() == []`` where the storm leaves no quorum wedged.
"""
import dataclasses
from types import SimpleNamespace

import pytest

import repro.core as ref_core
import repro.net as ref_net
import repro_torch.core as port_core
import repro_torch.net as port_net

REF = SimpleNamespace(core=ref_core, net=ref_net, kw={})
PORT = SimpleNamespace(core=port_core, net=port_net,
                       kw=dict(device="cpu", coding_backend="kernel"))
BLOCKS = dict(min_block=256, avg_block=512, max_block=2048)
STORM = dict(at=0.05, frac=0.25, duration=0.03)
CHAOS = dict(at=0.05, frac=1.0, duration=0.05, beyond_quorum=True)  # bench_chaos.py


CASES = {
    # label: (DSSParams keywords, WorkloadSpec keywords, via gateway, seed)
    "direct": (dict(n_servers=6, parity_m=2, seed=5),
               dict(sessions=60, files=8, file_size=4096, read_fraction=0.7,
                    ops_per_session=2), False, 3),
    "gateway": (dict(n_servers=6, parity_m=2, seed=5),
                dict(sessions=60, files=8, file_size=4096, read_fraction=0.7,
                     ops_per_session=2), True, 3),
    "storm": (dict(n_servers=8, parity_m=2, seed=11),
              dict(sessions=60, files=8, file_size=2048, read_fraction=0.8,
                   storms="storm"), False, 11),
    "storm-gateway": (dict(n_servers=8, parity_m=2, seed=11),
                      dict(sessions=60, files=8, file_size=2048, read_fraction=0.8,
                           storms="storm"), True, 11),
    "chaos-retry": (dict(n_servers=5, parity_m=2, seed=7, retry=True),
                    dict(sessions=40, files=8, file_size=512, read_fraction=0.6,
                         ops_per_session=2, storms="chaos"), False, 23),
    "sanitized": (dict(n_servers=6, parity_m=2, seed=7, sanitize=True, racecheck=True),
                  dict(sessions=60, files=8, file_size=2048, read_fraction=0.8), False, 7),
    "sanitized-storm-gateway": (
        dict(n_servers=8, parity_m=2, seed=7, sanitize=True, racecheck=True),
        dict(sessions=60, files=8, file_size=2048, read_fraction=0.8, storms="storm"),
        True, 7),
}


def _run(P, case: str, fast: bool, **overrides) -> dict:
    params, spec, via, seed = CASES[case]
    params = dict(params, **overrides)
    if params.pop("retry", False):
        params["retry"] = P.net.RetryPolicy()
    spec = dict(spec)
    storms = {"storm": (P.core.CrashStorm(**STORM),), "chaos": (P.core.CrashStorm(**CHAOS),)}
    spec["storms"] = storms.get(spec.pop("storms", None), ())
    dss = P.core.DSS(P.core.DSSParams(algorithm="coaresecf", indexed=True, fast_net=fast,
                                      **BLOCKS, **params, **P.kw))
    gw = dss.gateway() if via else None
    report = P.core.WorkloadGen(P.core.WorkloadSpec(**spec), seed=seed).run(dss, via=gw)
    if gw is not None:
        gw.stop()
        dss.net.run()
    net = dss.net
    return {
        "report": report,
        "history": [dataclasses.astuple(r) for r in dss.history],
        "net": (round(net.now, 12), net.events_processed, net.rpc_rounds, net.msg_count,
                net.bytes_sent, net.retransmits, net.rpc_timeouts, net.client_counters),
        "stuck": net.stuck_ops(),
    }


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("case", list(CASES))
def test_workload_report_equals_reference(case, fast):
    ref = _run(REF, case, fast)
    port = _run(PORT, case, fast)
    assert port["report"].keys() == ref["report"].keys()
    for key in ref["report"]:
        assert port["report"][key] == ref["report"][key], key
    assert port["history"] == ref["history"]
    assert port["net"] == ref["net"]
    rep = port["report"]
    assert rep["ops_stuck"] == 0 and rep["stuck_rpcs"] == 0
    assert port["stuck"] == [] == ref["stuck"]
    if case == "chaos-retry":
        assert rep["retries"]["retransmits"] > 0
        assert rep["availability_after_recovery"] >= 0.99
    elif "storm" in case:
        assert rep["availability"] == 1.0
    else:
        assert rep["ops_done"] == rep["ops"] and rep["ops_failed"] == 0
    if case.startswith("sanitized"):
        assert rep["sanitizer"]["checks"] > 100 and rep["races"]["checks"] > 0
        assert rep["sanitizer"]["linearized_ops"] > 0


@pytest.mark.parametrize("case", ["sanitized", "sanitized-storm-gateway"])
def test_sanitized_trace_equals_unsanitized(case):
    """The port's sanitizer and race tracker are pure observers: the same
    run without them has the same history and counters."""
    on = _run(PORT, case, True)
    off = _run(PORT, case, True, sanitize=False, racecheck=False)
    assert on["history"] == off["history"] and on["net"] == off["net"]
    drop = ("sanitizer", "races")
    assert {k: v for k, v in on["report"].items() if k not in drop} == off["report"]


def test_plan_equals_reference():
    spec = dict(sessions=500, files=64, file_size=1 << 22, zipf_s=0.99, ops_per_session=2,
                read_fraction=0.95)
    a = ref_core.WorkloadGen(ref_core.WorkloadSpec(**spec), seed=9).plan()
    b = port_core.WorkloadGen(port_core.WorkloadSpec(**spec), seed=9).plan()
    assert a.keys() == b.keys()
    for key in a:
        assert (a[key] == b[key]).all() if hasattr(a[key], "shape") else a[key] == b[key]


def _boot_under_deadline(P, rpc_timeout: float | None):
    """16 files of 1 MiB on the Emulab deployment (n=11, k=6, 1 Gbit/s links,
    512 KiB blocks) under ``RetryPolicy(rpc_timeout=...)``, then every file
    read back by a fresh session: (report, read-back, files holding no
    written payload)."""
    lat = P.net.LatencyModel(base_lo=0.1e-3, base_hi=0.3e-3, bandwidth=125e6)
    retry = P.net.RetryPolicy() if rpc_timeout is None else P.net.RetryPolicy(
        rpc_timeout=rpc_timeout)
    dss = P.core.DSS(P.core.DSSParams(
        algorithm="coaresecf", n_servers=11, parity_m=5, seed=0, indexed=True,
        min_block=512 << 10, avg_block=512 << 10, max_block=1 << 20, latency=lat, retry=retry,
        **dict(P.kw, coding_backend="numpy")))
    spec = P.core.WorkloadSpec(sessions=16, files=16, file_size=1 << 20, read_fraction=0.95)
    gen = P.core.WorkloadGen(spec, seed=0)
    report = gen.run(dss)
    payloads = set(gen.payloads(gen.plan()["payloads_seed"]))
    back = P.core.gather(*[dss.session("check").read(f"f{i}") for i in range(16)])
    assert dss.net.stuck_ops() == []
    return report, back, sum(value not in payloads for value in back)


def test_boot_write_outlasting_the_retry_deadline_equals_reference():
    """A fault of the reference that the port keeps (ROADMAP C): the boot
    batch of 16 MiB takes ~0.25 s of virtual time on the client's 1 Gbit/s
    link, longer than ``RetryPolicy()``'s four deadlines (10 + 20 + 40 + 80
    ms), so it fails typed, ``WorkloadGen.run`` does not check it, and its
    report shows availability 1.0 while 14 of the 16 files read back empty. Both
    packages agree; with a deadline longer than the transfer every file
    holds a written payload."""
    ref = _boot_under_deadline(REF, None)
    port = _boot_under_deadline(PORT, None)
    assert port == ref
    assert port[0]["availability"] == 1.0 and port[2] == 14  # of 16 files
    assert _boot_under_deadline(PORT, 1.0)[2] == 0
