"""repro_torch's EC checkpoint store and data pipeline against repro's.

* ``serialize_tree``: for the same arrays (f32, int32, int64 and bf16
  leaves, nested dicts, lists, tuples, None and Python scalars) the array
  payload after the header is byte-identical to the reference's. The header
  (structure, shapes, dtype names) is each package's own.
* ``ECCheckpointStore`` given the same blob (both packages' serializers
  replaced by one that returns it) gives the same ``CheckpointStats``, the
  same restored bytes, the same history and the same network counters as
  the reference, through save, restore, host crashes, an incremental save
  and a stale trainer. Its ``reconfigure`` moves the checkpoint, where the
  reference's moves a file no save writes (ROADMAP C).
* The port's store round-trips trees of tensors bit for bit: save/restore,
  host crashes within the fault budget, an incremental save that rewrites
  few blocks, a stale trainer degrading, concurrent meta flips, an elastic
  resize, and the state dict of a reduced qwen2-0.5b from the port's
  ``init_params``.
* ``SyntheticLM`` batches equal the reference's.

The port runs its data plane on the CPU (``device="cpu"``) and asserts
``stuck_ops() == []`` after each sequence.
"""
import dataclasses
import pickle

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.train.checkpoint as ref_ckpt
import repro.train.data as ref_data
import repro_torch.train.checkpoint as port_ckpt
import repro_torch.train.data as port_data
from repro_torch.configs import get_arch
from repro_torch.models.registry import build_model


def _arrays(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((n,)).astype(np.float32),
        "emb": rng.standard_normal((64, 16)).astype(np.float32),  # stored as bf16
        "step_count": np.int32(7),
        "nested": {"b": rng.standard_normal((33,)).astype(np.float32)},
    }


def _port_state(a):
    return {"w": torch.from_numpy(a["w"]),
            "emb": torch.from_numpy(a["emb"]).to(torch.bfloat16),
            "step_count": torch.tensor(int(a["step_count"]), dtype=torch.int32),
            "nested": {"b": torch.from_numpy(a["nested"]["b"])}}


def _ref_state(a):
    return {"w": jnp.asarray(a["w"]), "emb": jnp.asarray(a["emb"], jnp.bfloat16),
            "step_count": jnp.asarray(a["step_count"], jnp.int32),
            "nested": {"b": jnp.asarray(a["nested"]["b"])}}


def _payload(blob: bytes) -> bytes:
    return blob[8 + int.from_bytes(blob[:8], "big"):]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _equal(a, b) -> bool:
    """Same structure, and every leaf the same dtype, shape and bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if a is None:
        return b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.cpu().view(torch.uint8) if a.dtype == torch.bool else a.cpu(),
                            b.cpu().view(torch.uint8) if b.dtype == torch.bool else b.cpu()))


# ------------------------------------------------------------ serialization
def test_payload_is_byte_identical_to_reference():
    a = _arrays(3)
    extra_np = np.arange(5, dtype=np.int64)
    port = {"state": _port_state(a), "step": 12,
            "misc": [torch.from_numpy(extra_np), None, (torch.zeros(0), 2.5, True)]}
    ref = {"state": _ref_state(a), "step": 12,
           "misc": [extra_np, None, (np.zeros(0, np.float32), 2.5, True)]}
    pb, rb = port_ckpt.serialize_tree(port), ref_ckpt.serialize_tree(ref)
    assert _payload(pb) == _payload(rb)
    assert len(_payload(pb)) == 4 * 4096 + 2 * 64 * 16 + 4 + 4 * 33 + 8 + 8 * 5 + 8 + 1


def test_deserialize_roundtrip_and_reference_agree():
    a = _arrays(4)
    tree = {"state": _port_state(a), "step": 3, "t": (torch.ones(2, dtype=torch.bool), None)}
    blob = port_ckpt.serialize_tree(tree)
    back = port_ckpt.deserialize_tree(blob)
    assert back["step"].dtype == torch.int64 and int(back["step"]) == 3
    back["step"] = 3
    want = dict(tree, step=3)
    assert _equal(back["state"], want["state"]) and _equal(back["t"], want["t"])
    ref = ref_ckpt.deserialize_tree(ref_ckpt.serialize_tree({"state": _ref_state(a), "step": 3}))
    for p, r in zip(_leaves(back["state"]), _leaves(ref["state"])):
        r = np.asarray(r)
        assert str(p.dtype).removeprefix("torch.") == r.dtype.name and p.shape == r.shape
        assert p.reshape(-1).view(torch.uint8).numpy().tobytes() == r.tobytes()


def test_qwen2_reduced_state_dict_roundtrip_and_payload():
    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    store = port_ckpt.ECCheckpointStore(n_hosts=8, parity=2, seed=1, device="cpu",
                                        coding_backend="kernel", min_block=4096,
                                        avg_block=16384, max_block=65536)
    st = store.save(1, params)
    assert st.success and st.blocks_total > 1
    step, got = store.restore()
    assert step == 1 and _equal(got, params)
    assert store.dss.net.stuck_ops() == []

    def to_np(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    ref_tree = {"step": 1, "state": {k: v for k, v in _np_tree(params, to_np).items()}}
    assert _payload(port_ckpt.serialize_tree({"step": 1, "state": params})) == \
        _payload(ref_ckpt.serialize_tree(ref_tree))


def _np_tree(tree, fn):
    return {k: _np_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ----------------------------------------------- the store, on the same blob
def _blob(seed, size):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


STORE_KW = dict(n_hosts=8, parity=2, seed=2, min_block=4096, avg_block=8192,
                max_block=32768)


def _store_trace(mod, monkeypatch, blobs, *, crash=False, stale=False):
    """Save each blob in turn (both packages' serializers replaced by one that
    returns it), with optional host crashes and a stale second trainer;
    returns what a caller sees and the store's trace."""
    seq = iter(blobs)
    monkeypatch.setattr(mod, "serialize_tree", lambda tree: next(seq))
    monkeypatch.setattr(mod, "deserialize_tree", lambda blob, *a: {"step": -1, "state": blob})
    kw = dict(STORE_KW, device="cpu", coding_backend="kernel") if mod is port_ckpt else STORE_KW
    store = mod.ECCheckpointStore(**kw)
    out = {"stats": [], "restored": []}
    for i in range(len(blobs) - (1 if stale else 0)):
        out["stats"].append(dataclasses.astuple(store.save(i + 1, {})))
        out["restored"].append(store.restore())
    if stale:
        twin = store.new_trainer("trainer1")
        out["stats"].append(dataclasses.astuple(twin.save(1, {})))
    if crash:
        out["budget"] = store.fault_budget()
        store.crash_hosts([f"s{i}" for i in range(out["budget"])])
        out["restored"].append(store.restore())
    net = store.dss.net
    out["stuck"] = net.stuck_ops()
    out["history"] = [dataclasses.astuple(r) for r in store.dss.history]
    out["net"] = (round(net.now, 12), net.events_processed, net.rpc_rounds, net.msg_count,
                  net.bytes_sent, net.client_counters)
    monkeypatch.undo()
    return out


def _edited(blob, at, text):
    b = bytearray(blob)
    b[at:at + len(text)] = text
    return bytes(b)


BASE = _blob(5, 200_000)
SEQUENCES = {
    "save-restore": (dict(), [BASE]),
    "crash-within-budget": (dict(crash=True), [BASE]),
    "incremental": (dict(), [BASE, _edited(BASE, 150_000, b"NEW-STEP")]),
    "stale-trainer": (dict(stale=True), [BASE, _blob(6, 120_000)]),
    "two-saves": (dict(), [BASE, _edited(BASE, 10, b"!")]),
}


@pytest.mark.parametrize("label", list(SEQUENCES))
def test_store_on_the_same_blob_equals_reference(label, monkeypatch):
    flags, blobs = SEQUENCES[label]
    ref = _store_trace(ref_ckpt, monkeypatch, blobs, **flags)
    port = _store_trace(port_ckpt, monkeypatch, blobs, **flags)
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key] == ref[key], key
    assert port["stuck"] == []
    assert all(r == (-1, blob) for r, blob in zip(port["restored"], blobs))
    if label == "incremental":
        second = port["stats"][1]
        assert second[3] < second[2] // 4  # blocks_written < blocks_total / 4
    if label == "stale-trainer":
        assert port["stats"][-1][-1] is False


def test_reconfigure_moves_the_checkpoint_unlike_reference(monkeypatch):
    """A fault of the reference fixed in the port (ROADMAP C): its
    ``reconfigure`` recons ``ckpt/{shard}``, a file no save writes, so it
    moves one empty genesis block and leaves the checkpoint on the old hosts.
    The port moves the file the meta pointer names (genesis and every data
    block) and the meta object: the checkpoint restores with every old host
    down."""
    moved = {}
    for mod in (ref_ckpt, port_ckpt):
        monkeypatch.setattr(mod, "serialize_tree", lambda tree: BASE)
        monkeypatch.setattr(mod, "deserialize_tree", lambda blob, *a: {"step": -1, "state": blob})
        kw = dict(STORE_KW, device="cpu", coding_backend="kernel") if mod is port_ckpt else STORE_KW
        store = mod.ECCheckpointStore(**kw)
        st = store.save(1, {})
        moved[mod] = (store.reconfigure(n_hosts=11, parity=5, fresh=True), st.blocks_total)
    assert moved[ref_ckpt][0] == 1
    assert moved[port_ckpt][0] == moved[port_ckpt][1] + 1  # the data blocks and the genesis
    store.dss.net.run()
    store.crash_hosts([f"s{i}" for i in range(STORE_KW["n_hosts"])])
    assert store.restore() == (-1, BASE)
    assert store.dss.net.stuck_ops() == []


# ------------------------------------------------- the port's own round trips
def _store(**kw):
    return port_ckpt.ECCheckpointStore(device="cpu", coding_backend="kernel", **kw)


def _state(seed, n=4096):
    return _port_state(_arrays(seed, n))


def test_save_restore_and_crashes_within_budget():
    store = _store(n_hosts=8, parity=4, seed=2)
    st = store.save(5, _state(1))
    assert st.success and st.bytes_written > 0
    assert store.fault_budget() == 2
    store.crash_hosts([f"s{i}" for i in range(store.fault_budget())])
    step, got = store.restore()
    assert step == 5 and _equal(got, _state(1))
    assert store.dss.net.stuck_ops() == []


def test_incremental_save_rewrites_few_blocks():
    store = _store(n_hosts=6, parity=1, seed=3, min_block=4096, avg_block=8192,
                   max_block=32768)
    base = _state(4, n=200_000)
    s1 = store.save(1, base)
    assert s1.blocks_total > 4
    base2 = dict(base, step_count=torch.tensor(8, dtype=torch.int32))
    s2 = store.save(2, base2)
    assert s2.success and s2.blocks_written <= max(4, s2.blocks_total // 4)
    step, got = store.restore()
    assert step == 2 and _equal(got, base2)
    assert store.dss.net.stuck_ops() == []


def test_stale_trainer_degrades():
    store = _store(n_hosts=6, parity=2, seed=5)
    t2 = store.new_trainer("trainer1")
    assert store.save(5, _state(10)).success and store.save(8, _state(11)).success
    assert not t2.save(6, _state(99)).success
    step, got = store.restore()
    assert step == 8 and _equal(got, _state(11))
    assert t2.save(9, _state(12)).success
    step, got = store.restore()
    assert step == 9 and _equal(got, _state(12))
    assert store.dss.net.stuck_ops() == []


def test_concurrent_meta_flips_one_wins():
    store = _store(n_hosts=6, parity=2, seed=8)
    t2 = store.new_trainer("trainer1")
    store.save(1, _state(0))
    t2.restore()
    net = store.dss.net
    blob_a = port_ckpt.serialize_tree({"step": 2, "state": _state(1)})
    blob_b = port_ckpt.serialize_tree({"step": 2, "state": _state(2)})
    net.spawn(store.client.update("ckpt/shard0/trainer0", blob_a), client="trainer0")
    net.spawn(t2.client.update("ckpt/shard0/trainer1", blob_b), client="trainer1")
    net.run()
    meta_a = pickle.dumps({"step": 2, "fid": "ckpt/shard0/trainer0"})
    meta_b = pickle.dumps({"step": 2, "fid": "ckpt/shard0/trainer1"})
    ma = net.spawn(store.client.dsm.cvr_write("ckptmeta/shard0", meta_a), client="trainer0")
    mb = net.spawn(t2.client.dsm.cvr_write("ckptmeta/shard0", meta_b), client="trainer1")
    net.run()
    assert "chg" in (ma.result[1], mb.result[1])
    step, got = store.restore()
    assert step == 2 and (_equal(got, _state(1)) or _equal(got, _state(2)))
    assert net.stuck_ops() == []


def test_elastic_resize_preserves_state():
    """Save, recon onto 9 hosts with 3 parity, restore, save again: the
    sequence of the reference's ``train.elastic.elastic_resize``."""
    store = _store(n_hosts=5, parity=1, seed=6)
    state = _state(20, n=50_000)
    st = store.save(42, state)
    assert st.success
    moved = store.reconfigure(n_hosts=9, parity=3)
    step, got = store.restore()
    assert step == 42 and moved == st.blocks_total + 1 and _equal(got, state)
    assert store.save(43, state).success
    assert store.dss.net.stuck_ops() == []


def test_fresh_reconfigure_after_crashes_round_trips():
    store = _store(n_hosts=8, parity=2, seed=9)
    state = _state(21, n=30_000)
    assert store.save(1, state).success
    store.crash_hosts(["s0"])
    assert store.reconfigure(n_hosts=11, parity=5, fresh=True) > 1
    store.dss.net.run()
    store.crash_hosts([f"s{i}" for i in range(8)])  # every old host: the data moved
    step, got = store.restore()
    assert step == 1 and _equal(got, state)
    assert store.save(2, state).success
    assert store.dss.net.stuck_ops() == []


def test_store_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_ckpt.ECCheckpointStore()
    assert _store().dss.net.device == "cpu"


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_synthetic_lm_batches_equal_reference(hosts, host):
    cfgs = [mod.DataConfig(vocab=100, seq_len=16, global_batch=4, seed=9, n_hosts=hosts,
                           host_id=host) for mod in (ref_data, port_data)]
    ref, port = ref_data.SyntheticLM(cfgs[0]), port_data.SyntheticLM(cfgs[1])
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
    snap = port.state()
    after = port.next_batch()
    again = port_data.SyntheticLM(cfgs[1])
    again.restore(snap)
    np.testing.assert_array_equal(again.next_batch()["tokens"], after["tokens"])
