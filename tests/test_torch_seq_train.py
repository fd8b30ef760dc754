"""The port's sequence-sharded training on gloo CPU ranks against its own
one-device forms (JAX-free: the card's machine runs this file too).

A batch that does not fill the batch axes (B = 1) shards the sequence over
them (``LM.seq_ctx(ctx, B, train=True)``); the halo of the conv's rows, the
relay of the SSM state and the keys' gather over the batch axes then send
their gradients back to the ranks they came from (``MeshCtx``), and each
checkpointed layer keeps what they received for its recompute
(``MeshCtx.recorded``).

- Each hop alone, in f64, on 2 ranks (data=2) and 4 (pod=2, data=2): the
  gradient of a seeded random scalar function of the output of ``halo``,
  of the relay pair (``relay_in``/``relay_out``) and of
  ``gather_seq(axes=batch_axes)`` equals the unsharded autograd of the
  same function within 1e-12 (``_torch_mesh_ranks.seq_hop_losses``).
- One sequence-sharded train step of reduced mamba2-2.7b and zamba2-7b (2
  layers: one group of two Mamba2 layers and the shared block) in f32, B =
  1 x 256, on (data=2, model=1) and on (pod=2, data=2, model=1), whose
  middle ranks both send and receive: every gradient leaf within 1e-4
  relative L2 of the one-device step's. A dropped halo or relay gradient
  would move the conv's and the in-projections' gradients by ~1e-2 at 256
  rows.
- The collectives of its loss and gradients: ``relay``, ``relay_back``,
  ``halo`` and ``halo_back`` once a Mamba2 layer each, the keys' gather and
  its reduce-scatter once a shared-block application, and nothing else:
  the recompute replays no hop over the batch axes.
- The step keeps the contract of the batch-sharded step: parameters laid
  out as ``param_specs``, moments as ``adamw_specs``, one loss on every
  rank.
- The dry run traces the sequence-sharded train step of reduced mamba2 on
  a fake (data=2, model=1) mesh; its collectives by kind, FLOPs and peak
  equal those of the same step on two real gloo ranks.
- The MoE, VLM and encoder-decoder families' training at B = 1 is
  accepted too (``test_torch_mesh_seq_families.py`` runs it).

Every ``run_ranks`` call passes a timeout of 180 s, which the ranks' gloo
group takes as its own: a rank that waits for a hop that never comes fails
the test in minutes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.tree import named_leaves

from _torch_dryrun import FIELDS, run_fake_ranks  # noqa: I001  (tests/ helper)
from _torch_mesh_ranks import run_ranks, seq_hop_losses
from _torch_train_criteria import rel_l2

S, LR, TIMEOUT = 256, 3e-4, 180
MESHES = {"2x1": ((2, 1), ("data", "model")), "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# name -> (arch, overrides), in f32
ARCHS = {"mamba2_2_7b": ("mamba2_2_7b", {}), "zamba2_7b": ("zamba2_7b", {"n_layers": 2})}
GRAD_RTOL, HOP_TOL = 1e-4, 1e-12


def _model(arch: str, **overrides):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    model = build_model(cfg, max_pos=S, device="cpu")
    model.pure_dp = False
    return model


def _setup(name: str):
    """The f32 model, its parameters (seed 0) and a 1 x S train batch."""
    arch, overrides = ARCHS[name]
    model = _model(arch, dtype="float32", **overrides)
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_inputs(model.cfg, ShapeConfig("t", S, 1, "train"), seed=1, device="cpu")
    return model, params, batch


def _hop_inputs(world: int) -> dict:
    """The hops' f64 inputs on ``world`` sequence ranks (``seq_hop_losses``):
    x and a (2, world * 8, 3), the halo's 3 rows, each rank's weights."""
    rng = np.random.default_rng(world)
    L, C, k, Bn = 8, 3, 3, 2

    def draw(*shape_):
        return torch.from_numpy(rng.standard_normal(shape_))

    return dict(k=k, n=world, x=draw(Bn, world * L, C), a=draw(Bn, world * L, C) * 0.5,
                W_halo=[draw(Bn, k, C) for _ in range(world)],
                W_gather=[draw(Bn, world * L, C) for _ in range(world)],
                W_relay=[draw(Bn, L, C) for _ in range(world)],
                d=[draw(Bn, C) * 0.5 for _ in range(world)])


# ------------------------------------------------------------ each hop alone
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("hop", ["halo", "relay", "gather"])
def test_each_hops_backward_is_the_unsharded_gradient(steps, hop, world):
    args = _hop_inputs(world)
    ranks = [r["hops"] for r in steps["2x1" if world == 2 else "2x2x1"]]
    whole = args["a" if hop == "relay" else "x"].clone().requires_grad_()
    (want,) = torch.autograd.grad(seq_hop_losses(hop, whole, args, 0), (whole,))
    assert want.dtype == torch.float64
    kinds = {"halo": {"halo": 1, "halo_back": 1}, "gather": {"all_gather": 1, "reduce_scatter": 1},
             "relay": {"relay": 1, "relay_back": 1}}[hop]
    for r in ranks:
        L = whole.shape[1] // world
        block = want[:, r["seq_rank"] * L:(r["seq_rank"] + 1) * L]
        got = r["grads"][hop]
        assert got.dtype == torch.float64 and got.shape == block.shape
        assert float((got - block).abs().max()) <= HOP_TOL * float(block.abs().max()), \
            (hop, r["seq_rank"], float((got - block).abs().max()))
        assert r[f"counts_{hop}"] == kinds
    # the gradient crosses the ranks: a rank's block takes a later rank's part
    if hop != "gather":
        first = ranks[0]["grads"][hop]
        assert float(first.abs().max()) > 0


# ------------------------------------------------------------ one train step
@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """mesh -> each rank's results of one step of every arch (f32), and of
    the hops alone (``_hop_inputs``), one launch a mesh."""
    runs = {}
    for name in ARCHS:
        model, params, batch = _setup(name)
        arch, overrides = ARCHS[name]
        runs[name] = dict(arch=arch, overrides={**overrides, "dtype": "float32"}, params=params,
                          batch=batch)
    return {label: run_ranks("seq_train", int(np.prod(shape)),
                             tmp_path_factory.mktemp(f"seq_train{label}"),
                             dict(shape=shape, names=names, max_pos=S, lr=LR, runs=runs,
                                  hops=_hop_inputs(int(np.prod(shape)))),
                             timeout=TIMEOUT)
            for label, (shape, names) in MESHES.items()}


CASES = [(name, label) for label in MESHES for name in ARCHS]
IDS = [f"{name}-{label}" for name, label in CASES]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_seq_step_gradients_equal_the_one_device_steps(steps, name, mesh):
    model, params, batch = _setup(name)
    loss, grads = loss_and_grads(model, params, batch)
    want = dict(named_leaves(grads))
    for r in steps[mesh]:
        got = r[name]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss)), (got["loss"], loss)
        errs = {n: rel_l2(g, want[n]) for n, g in named_leaves(got["grads"])}
        assert errs.keys() == want.keys()
        assert max(errs.values()) <= GRAD_RTOL, sorted(errs.items(), key=lambda e: -e[1])[:3]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_seq_step_hops_once_a_layer_and_replays_none(steps, name, mesh):
    """The collectives of the loss and its gradients, on every rank: one
    halo, relay and backward of each a Mamba2 layer, one keys' gather and
    its reduce-scatter a shared-block application; none of them again in
    the recompute. The sequence ranks' relays wait on each other in the
    backward (``MeshCtx.waits``) on every rank but the last."""
    model, _, _ = _setup(name)
    n_mamba = model.cfg.n_layers
    n_attn = n_mamba // model.cfg.shared_attn_every if model.cfg.family == "hybrid" else 0
    want = {"halo": n_mamba, "halo_back": n_mamba, "relay": n_mamba, "relay_back": n_mamba}
    if n_attn:
        want.update({"all_gather": n_attn, "reduce_scatter": n_attn})
    ranks = steps[mesh]
    for r in ranks:
        assert r[name]["counts"]["model"] == want, r[name]["counts"]
    assert all(r[name]["waits"].get("relay_back", 0) > 0 for r in ranks[:-1])
    assert "relay_back" not in ranks[-1][name]["waits"]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_seq_step_keeps_the_batch_sharded_steps_contract(steps, name, mesh):
    ranks = steps[mesh]
    assert all(r[name]["misplaced"] == {} for r in ranks)
    assert len({r[name]["loss"] for r in ranks}) == 1
    assert all(int(r[name]["opt"]["step"]) == 1 for r in ranks)
    first = dict(named_leaves(ranks[0][name]["params"]))
    for r in ranks[1:]:
        assert all(torch.equal(v, first[n]) for n, v in named_leaves(r[name]["params"]))


# ------------------------------------------------------------ the dry run
def test_dry_run_traces_the_seq_train_step_as_two_gloo_ranks_run_it(tmp_path):
    """Reduced mamba2 (not pure data-parallel), B = 1 x 256 on (data=2,
    model=1): the fake trace of each rank equals the real step's counts on
    two gloo ranks (FLOPs, bytes, peak, collectives by kind; the relay's
    backward one send and one receive in reverse order)."""
    args = {"archs": ["mamba2_2_7b"], "kinds": ("train",), "mesh": MESHES["2x1"], "B": 1}
    fake = run_fake_ranks(args, tmp_path / "fake")
    real = run_ranks("dryrun_counts", 2, tmp_path / "real", args, timeout=TIMEOUT)
    for rank in range(2):
        got, want = fake[rank]["mamba2_2_7b", "train"], real[rank]["mamba2_2_7b", "train"]
        for field in FIELDS:
            assert got[field] == want[field], (rank, field, got[field], want[field])
        assert got["collective_calls"] == got["ctx_calls"] == want["ctx_calls"]
        hops = {k: got["mesh_counts"][k] for k in ("halo", "halo_back", "relay", "relay_back")}
        assert hops == dict.fromkeys(hops, 2)
        # a relay forward and back: the first rank sends then receives, the last the reverse
        p2p = {k: got["collective_calls"].get(k, 0) for k in ("send", "recv")}
        assert p2p == {"send": 2, "recv": 2}, p2p


# ------------------------------------------------------------ what raises
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_vl_7b", "whisper_base"])
def test_seq_training_raises_for_the_other_families(arch):
    """MoE, VLM and encoder-decoder training at B = 1 on two batch ranks, on
    a spec-only mesh: ``seq_ctx`` with ``train`` is the mesh, as for the
    dense, SSM and hybrid families, and the step stops only at the mesh's
    missing process group (``RuntimeError``, "AbstractMesh"); nothing is
    refused (the steps run on gloo ranks:
    ``test_torch_mesh_seq_families.py``)."""
    ctx = MeshCtx(AbstractMesh((2, 1), ("data", "model")))
    model = _model(arch)
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_inputs(model.cfg, ShapeConfig("t", S, 1, "train"), seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_train_step(model, ctx, AdamWConfig())(params, adamw_init(params), batch)
    for other in ("qwen2_0_5b", "gemma3_1b", "mamba2_2_7b", "zamba2_7b", arch):
        assert _model(other).seq_ctx(ctx, 1, train=True) is ctx
