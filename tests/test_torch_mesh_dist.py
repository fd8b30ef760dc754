"""The port's mesh layer on gloo CPU ranks against the port's own
single-device forms (JAX-free: the card's machine runs this file too).

Each case runs on 1, 2 or 4 spawned ranks (``_torch_mesh_ranks``), reduced
configs at B = 4, S = 256, so that the cross-entropy runs in its chunked
form (S > 128), on the meshes of the reference's multi-device test cut to
what the batch fills: (data=2, model=1) and (pod=2, data=2, model=1) for
qwen2-0.5b, olmoe-1b-7b and mamba2-2.7b, (data=2, model=2) for
whisper-base, whose batch is sharded over "model" too (pure data-parallel).

- The sharded train step against the single-device ``make_train_step``,
  held by ``_torch_train_criteria.hold_step`` (the SSD family with its
  one-ulp nudges). For the MoE family the single-device counterpart runs
  the step on each rank's block of the batch and averages the gradients:
  on a mesh each rank routes its own T_loc tokens with a capacity from
  T_loc, as the reference's expert-parallel branch does at model=1, and
  the drops differ from those of the whole batch.
- The sharded prefill's logits against the single-device prefill's (the
  MoE's on each block), bit for bit.
- ZeRO-1's update, the elastic resize, the host mesh and the
  batch-sharded decode: ``tests/test_torch_mesh_dist_state.py`` (split
  from this file for the suite's time, tests moved as they were).
- Nothing is refused: the MoE family's sequence sharding, serving or
  training, and the fallback layouts build, and stop on a spec-only mesh
  only at its missing process group.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import (
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.tree import named_leaves, tree_map

from _torch_encdec import draw_final_norms  # noqa: I001  (tests/ helper)
from _torch_mesh_ranks import run_ranks
from _torch_train_criteria import hold_step, ssd_nudged, step_metrics

B, S, LR, MAX_POS = 4, 256, 3e-4, 256
MESH_2 = ((2, 1), ("data", "model"))
MESH_POD = ((2, 2, 1), ("pod", "data", "model"))
CASES = [("qwen2_0_5b", MESH_2), ("olmoe_1b_7b", MESH_2), ("mamba2_2_7b", MESH_2),
         ("qwen2_0_5b", MESH_POD), ("olmoe_1b_7b", MESH_POD), ("mamba2_2_7b", MESH_POD),
         ("whisper_base", ((2, 2), ("data", "model")))]


def _setup(arch: str, seed: int = 0):
    """The reduced model, its parameters (from ``seed``; whisper's final
    norms drawn), a train batch and a prefill batch (``make_inputs``)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, max_pos=MAX_POS, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(seed))
    if cfg.family == "encdec":
        draw_final_norms(params, seed)
    batch = make_inputs(cfg, ShapeConfig("t", S, B, "train"), seed=1, device="cpu")
    prefill = {k: v for k, v in make_inputs(cfg, ShapeConfig("t", S, B, "prefill"), seed=2,
                                            device="cpu").items() if k != "labels"}
    return model, params, batch, prefill


def _blocks(batch: dict, n: int) -> list[dict]:
    """The batch's n blocks along its batch dim (dim 1 of ``positions``)."""
    return [{k: v.chunk(n, dim=1 if k == "positions" else 0)[i] for k, v in batch.items()}
            for i in range(n)]


def single_device_step(model: LM, params: dict, batch: dict, n_blocks: int):
    """``make_train_step(model)``; for the MoE family, the step of the n
    blocks' mean loss: each block's gradients from ``loss_and_grads``
    averaged in f32, then ``adamw_update``."""
    if model.cfg.family != "moe":
        return make_train_step(model, None, AdamWConfig(lr=LR))(params, adamw_init(params), batch)
    runs = [loss_and_grads(model, params, b) for b in _blocks(batch, n_blocks)]
    grads = tree_map(lambda *gs: (sum(g.float() for g in gs) / n_blocks).to(gs[0].dtype),
                     *[g for _, g in runs])
    p, o = adamw_update(params, grads, adamw_init(params), AdamWConfig(lr=LR))
    return p, o, sum(loss for loss, _ in runs) / n_blocks


def single_device_prefill(model: LM, params: dict, batch: dict, n_blocks: int):
    step = make_prefill_step(model)
    if model.cfg.family != "moe":
        return step(params, batch)
    return torch.cat([step(params, b) for b in _blocks(batch, n_blocks)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def run(arch, mesh):
        if (arch, mesh) not in cache:
            model, params, batch, prefill = _setup(arch)
            shape, names = mesh
            cache[arch, mesh] = run_ranks(
                "step", int(np.prod(shape)), tmp_path_factory.mktemp(arch),
                dict(arch=arch, shape=shape, names=names, max_pos=MAX_POS, params=params,
                     batch=batch, prefill=prefill, lr=LR))
        return cache[arch, mesh]

    return run


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{'x'.join(map(str, m[0]))}"
                                                 for a, m in CASES])
def test_sharded_step_holds_against_the_single_device_step(runs, arch, mesh):
    ranks = runs(arch, mesh)
    model, params, batch, prefill = _setup(arch)
    n = int(np.prod(mesh[0]))
    got = ranks[0]
    assert got["misplaced"] == {}
    assert all(r["loss"] == got["loss"] for r in ranks)
    p1, o1, loss = single_device_step(model, params, batch, n)
    assert abs(got["loss"] - float(loss)) <= 2e-2
    assert int(got["opt"]["step"]) == 1
    nudged = []
    if model.cfg.is_ssm:
        for to in (np.inf, -np.inf):
            with ssd_nudged(to):
                pn, on, _ = single_device_step(model, params, batch, n)
            nudged.append((step_metrics(pn, on, p1, o1, LR), None))
    held, verdict, failures = hold_step(step_metrics(got["params"], got["opt"], p1, o1, LR),
                                        nudged=nudged)
    assert held and not failures, (verdict, failures)
    for name, value in named_leaves(got["params"]):
        assert value.dtype == dict(named_leaves(params))[name].dtype, name


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{'x'.join(map(str, m[0]))}"
                                                 for a, m in CASES])
def test_sharded_prefill_equals_the_single_device_prefill(runs, arch, mesh):
    """Each rank runs its block with the whole weights; the gathered logits
    equal the single-device prefill's bit for bit on every rank."""
    ranks = runs(arch, mesh)
    model, params, _, prefill = _setup(arch)
    want = single_device_prefill(model, params, prefill, int(np.prod(mesh[0])))
    for r in ranks:
        assert r["logits"].shape == (B, model.cfg.vocab) and torch.equal(r["logits"], want)


# ------------------------------------------------------------- refusals
def test_abstract_mesh_computes_specs_only():
    """A context with no process group computes specs, and refuses to run."""
    ctx = MeshCtx(AbstractMesh((1, 1), ("data", "model")))
    model = LM(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_prefill_step(model, ctx)(params, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="process group"):
        ctx.group(ctx.batch_axes)
    assert ctx.constrain(tokens, ("data",), None) is tokens


@pytest.mark.parametrize("arch,n_model", [
    ("qwen2_vl_7b", 16),
    ("qwen2_0_5b", 4),
    ("gemma3_1b", 16),
    ("qwen2_0_5b", 16),
], ids=["qwen2_vl_7b-model16", "qwen2_0_5b-model4", "gemma3_1b-model16", "qwen2_0_5b-model16"])
def test_model_axis_refused_where_the_model_is_not_pure_dp(arch, n_model):
    """Where the heads do not divide "model" (qwen2-0.5b's 14 heads on
    model=4 and 16, qwen2-vl-7b's 28 and gemma3-1b's 4 on model=16) the
    reference shards head_dim, and so does the port (the fallback layout):
    nothing is refused any more, every step builder builds, and a step
    refuses to run only on a mesh without a process group (an
    ``AbstractMesh``). A pure data-parallel model (whisper-base) builds its
    train and prefill steps; ``constrain`` checks the spec and returns its
    input."""
    ctx = MeshCtx(AbstractMesh((2, n_model), ("data", "model")))
    model = LM(get_arch(arch), device="cpu")
    assert not model.pure_dp and model.tp_ctx(ctx) is ctx
    for build in (make_train_step, make_prefill_step, make_serve_step):
        assert callable(build(model, ctx))
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_prefill_step(model, ctx)({}, make_inputs(model.cfg, ShapeConfig("t", 32, 2, "prefill"),
                                                      device="cpu"))
    whisper = LM(get_arch("whisper_base"), max_pos=448, device="cpu")
    assert whisper.pure_dp and whisper.n_params() == 83440128
    assert make_train_step(whisper, ctx) and make_prefill_step(whisper, ctx)
    x = torch.zeros(2)
    assert ctx.constrain(x, "model") is x


def test_a_batch_that_does_not_fill_the_batch_axes_is_refused():
    """B = 2 on (pod=2, data=2): the reference shards the sequence there
    (``token_spec``). The port's dense, SSM and hybrid prefill, decode and
    training shard it too (``tests/test_torch_mesh_seq.py``,
    ``tests/test_torch_seq_train.py``; on this spec-only mesh they stop at
    its missing process group), and so do the MoE family's prefill, decode
    and training (``tests/test_torch_mesh_seq_families.py``): each stops at
    the missing process group alike."""
    ctx = MeshCtx(AbstractMesh((2, 2, 1), ("pod", "data", "model")))
    model = LM(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    assert ctx.token_spec(2) == (None, ("pod", "data"))
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_train_step(model, ctx)(params, {}, batch)
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_prefill_step(model, ctx)(params, {"tokens": batch["tokens"]})
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_serve_step(model, ctx)(params, model.init_cache(2, 8),
                                    {"token": batch["tokens"][:, 0], "cur_len": 0})
    moe = LM(get_arch("olmoe_1b_7b").reduced(), device="cpu")
    moe_params = moe.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_prefill_step(moe, ctx)(moe_params, {"tokens": batch["tokens"]})
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_serve_step(moe, ctx)(moe_params, moe.init_cache(2, 8),
                                  {"token": batch["tokens"][:, 0], "cur_len": 0})
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        make_train_step(moe, ctx)(moe_params, {}, batch)


def test_norm_nudge_moves_the_norms_by_one_rounding_at_most():
    """``norm_nudged`` (the conditioning probe of a step without an SSD,
    ``hold_step``'s policy): each RMS norm's bf16 output moves by at most
    one bf16 ulp, some do move, and the gradient passes through."""
    from _torch_train_criteria import bf16_ulp, norm_nudged

    from repro_torch.models import lm

    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 256), generator=g).bfloat16().requires_grad_()
    w = (torch.randn(256, generator=g) * 0.1).requires_grad_()
    want = lm.rms_norm(x, w)
    with norm_nudged(np.inf):
        got = lm.rms_norm(x, w)
        (gx,) = torch.autograd.grad(got.float().sum(), (x,))
    # the nudge adds a constant to the f32 norm: the gradient is the f32 norm's
    (wx,) = torch.autograd.grad(lm.rms_norm(x.float(), w).to(x.dtype).float().sum(), (x,))
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bf16_ulp(want.float())).all()) and bool((diff > 0).any())
    assert torch.equal(gx, wx)
