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
- ``adamw_update_sharded`` with the same whole gradients on every rank,
  where the clip does not bind, against ``adamw_update``: bit for bit, and
  each rank's block of the moments where the reference's flattened index
  puts it.
- ``elastic_resize`` from (data=2, model=2) to (data=4, model=1): every
  block of the new layout, ZeRO-1 moments included, byte for byte the
  saved state's; the next step equal, bit for bit, to the same step from
  the state before the save.
- The decode step with the cache sharded over the batch, and the host mesh
  (one rank), against the single-device forms.
- What the port refuses (sequence sharding for the MoE family, serving or
  training) raises ``NotImplementedError`` naming the ROADMAP item; the
  fallback layouts build.
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


def _adamw_tree(rng: np.random.Generator) -> dict:
    """Leaves whose ZeRO dim is 0, a trailing dim of a stacked (L, ...)
    leaf, none (no divisible dim), in bf16 and f32."""
    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    return {"embed": bf(8, 6), "layers": {"wq": bf(3, 8, 2, 4), "ln": torch.from_numpy(
        rng.standard_normal((3, 12)).astype(np.float32))},
        "odd": bf(3, 5), "final_ln": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}


@pytest.mark.parametrize("mesh", [MESH_2, MESH_POD], ids=["data2", "pod2xdata2"])
def test_adamw_update_sharded_equals_adamw_update_bit_for_bit(tmp_path, mesh):
    """Three steps with the same whole gradients on every rank (a clip of
    1e6 that does not bind; weight decay 0.1 on the ndim >= 2 leaves):
    parameters and moments bit for bit ``adamw_update``'s; each rank's
    block of a moment is the slice at ``data + pod * n_data``."""
    rng = np.random.default_rng(3)
    params = _adamw_tree(rng)
    grads = [tree_map(lambda p: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)).to(p.dtype), params) for _ in range(3)]
    shape, names = mesh
    n = int(np.prod(shape))
    ranks = run_ranks("adamw", n, tmp_path, dict(shape=shape, names=names, params=params,
                                                 grads=grads, cfg=dict(lr=1e-2, grad_clip=1e6)))
    for r in ranks:
        (p, st), (ps, sts) = r["plain"], r["sharded"]
        for want, got in ((p, ps), (st["m"], sts["m"]), (st["v"], sts["v"])):
            for name, value in named_leaves(want):
                g = dict(named_leaves(got))[name]
                assert g.dtype == value.dtype and torch.equal(g, value), name
        assert int(sts["step"]) == int(st["step"]) == 3
        idx = r["coord"]["data"] + r["coord"].get("pod", 0) * shape[names.index("data")]
        zspecs = dict(named_leaves(r["zspecs"]))
        dims = {}
        for name, local in named_leaves(r["local_m"]):
            whole = dict(named_leaves(st["m"]))[name]
            zdim = next((i for i, e in enumerate(zspecs[name]) if e is not None), None)
            dims[name] = zdim
            want = whole if zdim is None else whole.chunk(n, dim=zdim)[idx]
            assert torch.equal(local, want), name
        assert dims == {"embed": 0, "final_ln": 0, "layers.ln": 1, "layers.wq": 1, "odd": None}


def test_elastic_resize_restores_every_block_byte_for_byte(tmp_path):
    """Reduced qwen2-0.5b (pure data-parallel) steps on (data=2, model=2),
    then ``elastic_resize`` through rank 0's ``ECCheckpointStore`` (8 hosts,
    parity 2, to 10 hosts, parity 3) and ``reshard_state`` onto (data=4,
    model=1): every rank's blocks, the ZeRO-1 moments' quarters included,
    equal the saved state's byte for byte; the next step there equals,
    bit for bit, the same step from the state before the save."""
    model, params, batch, _ = _setup("qwen2_0_5b")
    batch2 = make_inputs(model.cfg, ShapeConfig("t", S, B, "train"), seed=3, device="cpu")
    ranks = run_ranks("elastic", 4, tmp_path, dict(
        arch="qwen2_0_5b", max_pos=MAX_POS, params=params, batch=batch, batch2=batch2, lr=LR,
        old=((2, 2), ("data", "model")), new=((4, 1), ("data", "model")),
        hosts=8, parity=2, new_hosts=10, new_parity=3))
    zero_dims = set()
    for r in ranks:
        assert r["step"] == 1 and r["moved"] > 0
        saved, local, specs = r["saved"], r["local"], r["specs"]
        for part in ("params", "opt"):
            spec = dict(named_leaves(specs[part]))
            for name, block in named_leaves(local[part]):
                whole = dict(named_leaves(saved[part]))[name]
                zdim = next((i for i, e in enumerate(spec[name]) if e is not None), None)
                want = whole if zdim is None else whole.chunk(4, dim=zdim)[r["index"]]
                zero_dims.add((part, zdim is not None))
                assert block.dtype == want.dtype and torch.equal(block, want), (part, name)
        assert np.isfinite(r["loss2"]) and r["loss2"] == r["loss3"]
        for a, b in zip(named_leaves(r["after"]), named_leaves(r["after_direct"])):
            assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    assert zero_dims == {("params", False), ("opt", True), ("opt", False)}


def test_host_mesh_runs_the_steps_on_one_rank(tmp_path):
    """``make_host_mesh("cpu")`` on a group of one: the production meshes
    refuse it, naming the ranks they need; the sharded train step holds
    against the single-device one, and the prefill and three decode steps
    equal theirs bit for bit."""
    model, params, batch, prefill = _setup("qwen2_0_5b")
    tokens = prefill["tokens"]
    (r,) = run_ranks("host", 1, tmp_path, dict(
        arch="qwen2_0_5b", max_pos=MAX_POS, params=params, batch=batch, prefill=prefill,
        lr=LR, tokens=tokens, cache_len=16, steps=3))
    assert r["shape"] == {"data": 1, "model": 1}
    assert "256" in r["errors"][0] and "512" in r["errors"][1] and len(r["errors"]) == 2
    p1, o1, loss = make_train_step(model, None, AdamWConfig(lr=LR))(params, adamw_init(params),
                                                                    batch)
    held, verdict, failures = hold_step(step_metrics(r["params"], r["opt"], p1, o1, LR))
    assert held and not failures and abs(r["loss"] - float(loss)) <= 2e-2, (verdict, failures)
    assert torch.equal(r["logits"], make_prefill_step(model)(params, prefill))
    assert all(torch.equal(a, b) for a, b in zip(r["decode"], _decode(model, params, tokens, 3)))


def _decode(model: LM, params: dict, tokens: torch.Tensor, steps: int) -> list:
    cache, serve, out = model.init_cache(tokens.shape[0], 16), make_serve_step(model), []
    for i in range(steps):
        logits, cache = serve(params, cache, {"token": tokens[:, i], "cur_len": i})
        out.append(logits)
    return out


def test_sharded_decode_equals_the_single_device_decode(tmp_path):
    """Reduced qwen2-0.5b on (pod=2, data=2, model=1): each rank decodes its
    block of the batch against its block of the cache (``cache_specs``,
    written in place); three steps' gathered logits equal the single-device
    decode's bit for bit."""
    model, params, _, prefill = _setup("qwen2_0_5b")
    tokens = prefill["tokens"]
    shape, names = MESH_POD
    ranks = run_ranks("serve", 4, tmp_path, dict(
        arch="qwen2_0_5b", max_pos=MAX_POS, params=params, shape=shape, names=names,
        tokens=tokens, cache_len=16, steps=3))
    want = _decode(model, params, tokens, 3)
    for r in ranks:
        assert all(torch.equal(a, b) for a, b in zip(r["decode"], want))


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
    its missing process group); the MoE family's prefill, decode and
    training raise ``NotImplementedError`` naming their ROADMAP item before
    any collective."""
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
    with pytest.raises(NotImplementedError, match="sequence sharding for the MoE"):
        make_prefill_step(moe, ctx)(moe_params, {"tokens": batch["tokens"]})
    with pytest.raises(NotImplementedError, match="sequence sharding for the MoE"):
        make_serve_step(moe, ctx)(moe_params, moe.init_cache(2, 8),
                                  {"token": batch["tokens"][:, 0], "cur_len": 0})
    with pytest.raises(NotImplementedError, match="sequence sharding for the MoE"):
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
