"""The quickstart sequence on repro and on repro_torch: trace-identical.

Both packages run the same CoARESECF deployment from the same seed and the
same data: a batched write of three files, read-back, a crashed DATA server
(s0, so reads must decode) with a fresh reader, a 16-byte edit, stat,
recovery + repair, recon (to ABD on fresh servers, or to a fresh EC
configuration), and a final read. The port runs its data plane on the CPU
(``device="cpu"``, the plain PyTorch versions of its kernels). Everything
must match exactly: read bytes, every future's ``OpStats``, the recorded
history, the coded elements on every server, and the network fingerprint
of ``tests/test_scalepath.py``. ``stuck_ops()`` is asserted empty here,
since the suite's leak check hooks only ``repro.net.sim.Network``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs.paper_store as ref_paper
import repro.core as ref_core
import repro.net as ref_net
import repro_torch.configs.paper_store as port_paper
import repro_torch.core as port_core
import repro_torch.net as port_net

FILE = 1 << 18


def _fingerprint(net):
    return (round(net.now, 12), net.events_processed, net.rpc_rounds, net.msg_count,
            net.bytes_sent, net.client_counters)


def _astuple(x):
    return dataclasses.astuple(x)


def _sequence(port: bool, *, fast: bool, retry: bool, recon: str, backend: str = "kernel"):
    core, net_mod = (port_core, port_net) if port else (ref_core, ref_net)
    kw = dict(device="cpu", coding_backend=backend) if port else {}
    dss = core.DSS(core.DSSParams(
        algorithm="coaresecf", n_servers=8, parity_m=2, seed=0,
        min_block=4096, avg_block=16384, max_block=65536, indexed=True,
        fast_net=fast, retry=net_mod.RetryPolicy() if retry else None, **kw,
    ))
    out: dict = {"reads": [], "stats": [], "stuck": []}

    def settle():
        dss.net.run()
        out["stuck"].append(dss.net.stuck_ops())

    alice, bob = dss.session("alice"), dss.session("bob")
    rng = np.random.default_rng(0)
    docs = {f"f{i}": rng.integers(0, 256, FILE, dtype=np.uint8).tobytes() for i in range(3)}
    futs = [alice.write(fid, doc) for fid, doc in docs.items()]
    out["write"] = core.gather(*futs)
    out["stats"] += [_astuple(f.stats) for f in futs]
    settle()
    reads = [bob.read(fid) for fid in docs]
    out["reads"].append(core.gather(*reads))
    out["stats"] += [_astuple(f.stats) for f in reads]
    settle()

    dss.crash_servers(["s0"])  # a data-fragment holder: reads must decode
    carol = dss.session("carol")
    fut = carol.read("f0")
    out["reads"].append(fut.result())
    out["stats"].append(_astuple(fut.stats))
    settle()
    edit = bytearray(docs["f0"])
    edit[100_000:100_016] = b"EDITED-IN-PLACE!"
    fut = alice.write("f0", bytes(edit))
    out["edit"] = fut.result()
    out["stats"].append(_astuple(fut.stats))
    settle()
    out["reads"].append(bob.read("f0").result())
    out["margin_down"] = alice.stat("f0").result()["margin"]
    settle()

    dss.recover_servers(["s0"])
    out["repair"] = dss.repair()
    out["margin_up"] = alice.stat("f0").result()["margin"]
    settle()
    if recon == "abd":
        cfg = dss.make_config(dap="abd", n_servers=5, fresh_servers=True)
    else:
        cfg = dss.make_config(n_servers=8, parity_m=2, fresh_servers=True)
    fut = dss.session("admin").recon("f0", cfg)
    out["recon"] = fut.result()
    out["stats"].append(_astuple(fut.stats))
    settle()
    fut = dss.session("dave").read("f0")
    out["reads"].append(fut.result())
    out["stats"].append(_astuple(fut.stats))
    settle()

    out["expected"] = [list(docs.values()), docs["f0"], bytes(edit), bytes(edit)]
    out["history"] = [_astuple(r) for r in dss.history]
    out["elements"] = {sid: dict(srv.ec) for sid, srv in sorted(dss.net.servers.items())}
    out["fingerprint"] = _fingerprint(dss.net)
    return out


@pytest.mark.parametrize("recon", ["ec", "abd"])
@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("fast", [True, False])
def test_quickstart_sequence_trace_identical(fast, retry, recon):
    ref = _sequence(False, fast=fast, retry=retry, recon=recon)
    port = _sequence(True, fast=fast, retry=retry, recon=recon)
    assert port["reads"] == ref["reads"] == port["expected"]
    assert port["edit"]["written"] < port["edit"]["blocks"]
    assert port["margin_up"] > port["margin_down"]
    assert all(s == [] for s in port["stuck"])
    for key in ("write", "stats", "edit", "margin_down", "margin_up", "repair", "recon",
                "history", "elements", "fingerprint", "stuck"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("backend", ["numpy", "auto"])
def test_other_coding_backends_trace_identical(backend):
    ref = _sequence(False, fast=True, retry=False, recon="ec")
    port = _sequence(True, fast=True, retry=False, recon="ec", backend=backend)
    for key in ("reads", "stats", "history", "elements", "fingerprint"):
        assert port[key] == ref[key], key


def test_device_rides_on_the_network():
    dss = port_core.DSS(port_core.DSSParams(device="cpu", coding_backend="kernel"))
    assert dss.net.device == "cpu" and dss.net.coding_backend == "kernel"
    client = dss.client("c")
    assert client.dsm.net.device == "cpu"
    assert port_core.DSSParams().device == "cuda"


def test_cuda_store_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_core.DSS(port_core.DSSParams())
    with pytest.raises(ValueError):
        port_core.DSS(port_core.DSSParams(device="tpu"))


def test_unknown_coding_backend_raises():
    with pytest.raises(ValueError):
        port_core.DSS(port_core.DSSParams(device="cpu", coding_backend="pallas"))


def test_sanitize_racecheck_gateway_and_check_history_work():
    """The observers, the gateway and the linearizability check, which the
    port lacked before its analysis and gateway slice, run on the CPU."""
    dss = port_core.DSS(port_core.DSSParams(device="cpu", sanitize=True, racecheck=True,
                                            n_servers=5, parity_m=1))
    assert dss.net.sanitizer is not None and dss.net.race_tracker is not None
    gw = dss.gateway()
    a, b = gw.session("a"), gw.session("b")
    a.write("f", b"x" * 3000).result()
    fa, fb = a.read("f"), b.read("f")
    assert port_core.gather(fa, fb) == [b"x" * 3000] * 2
    assert fa.stats.batched_with == 2
    gw.stop()
    dss.net.run()
    assert dss.check_history()["ops"] >= 3
    assert dss.net.sanitizer.report()["checks"] > 0
    assert dss.net.race_tracker.report()["checks"] > 0
    assert dss.net.stuck_ops() == []


def test_paper_store_descriptors_match():
    for name in ("EMULAB", "EMULAB_M1", "AWS"):
        assert dataclasses.astuple(getattr(port_paper, name)) == \
            dataclasses.astuple(getattr(ref_paper, name))
    dss = port_paper.make_dss(port_paper.EMULAB, seed=3, device="cpu", indexed=True)
    ref = ref_paper.make_dss(ref_paper.EMULAB, seed=3)
    assert (dss.c0.n, dss.c0.k, dss.c0.dap) == (ref.c0.n, ref.c0.k, ref.c0.dap) == (11, 6, "ec_opt")
    assert dss.params.indexed and dss.net.device == "cpu"
