"""Tensor and expert parallelism over "model" on gloo CPU ranks, against
the port's single-device steps: the cases, the single-device counterparts
and the checks shared by ``test_torch_mesh_tp.py`` (qwen2-0.5b and the
unit tests) and ``test_torch_mesh_tp_moe_ssm.py`` (olmoe-1b-7b and
mamba2-2.7b), split for the test workers' time (JAX-free: the card's
machine runs both files too).
Each case runs reduced qwen2-0.5b, olmoe-1b-7b and mamba2-2.7b as models
that are not pure data-parallel (``pure_dp=False``: the reduced configs are
below ``PURE_DP_MAX_PARAMS``) on (data=1, model=2) and (data=2, model=2),
and qwen2-0.5b on (pod=2, data=2, model=2) (the reference's multi-device
test's (2, 4, 2) cut to 8 ranks), B = 4, S = 256 (the chunked
cross-entropy runs), in bf16 and in f32, one spawned process a rank
(``_torch_mesh_ranks``, case ``tp``):

- the sharded train step, in f32, against the single-device
  ``make_train_step``, held by ``_torch_train_criteria.hold_step`` (nudged
  by ``ssd_nudged`` for the SSM, ``norm_nudged`` for the others). From
  random weights the bf16 step is ill-conditioned in a way the one-ulp
  nudges do not show: the single-device and the sharded bf16 gradients
  both lie far from the f32 gradients of the same weights, and past the
  gradient criterion from each other, because the row-parallel products
  round their partial sums where one device rounds the whole sum; the bf16
  step is held against the reference's sharded step, to the reference's
  own bound, in ``test_torch_mesh_ref.py``;
- the gradients the step hands the optimizer: every leaf that
  ``param_specs`` does not shard over "model" (the norms, the router, the
  SSM's shared and per-head leaves) summed over "model", in f32 within the
  step's gradient tolerance of the single-device gradient (forgetting the
  sum leaves each with one rank's share of it);
- the prefill's logits and three decode steps' logits within the serving
  criterion (LOGIT_ATOL, 4 bf16 ulps at the logits' magnitude) in bf16,
  and within 1e-4 in f32; and in bf16 equal, bit for bit, to the
  single-device run with its row-parallel products rounded as the ranks
  round them (``_torch_train_criteria.tp_rounding``).

The MoE family's single-device counterpart runs ``moe_layer``'s
expert-parallel branch as the reference computes it, emulated on one
process (``ep_emulated``): each rank routes its T_loc = B/n_data * S/n_model
tokens with a capacity from T_loc, and the exchange reads the received
blocks as the reference's reshape does, which for n_model > 1 hands rows to
other experts than they were routed to (ROADMAP C;
``test_expert_parallel_exchange_keeps_the_references_layout``). A decode
step (S = 1) routes every token whole, as the single-device form does.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx, on_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import (
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.tree import named_leaves

from _torch_mesh_ranks import run_ranks  # noqa: I001  (tests/ helper)
from _torch_moe_criteria import ep_emulated
from _torch_train_criteria import (
    LOSS_ATOL,
    GRAD_RTOL,
    hold_step,
    norm_nudged,
    ssd_nudged,
    step_metrics,
    tp_rounding,
)

B, S, LR, MAX_POS, CACHE, STEPS = 4, 256, 3e-4, 256, 16, 3
LOGIT_ATOL = 4 * 2.0**-6  # tests/test_torch_models.py's serving criterion
F32_LOGIT_ATOL = 1e-4
NAMES = ("data", "model")
ARCHS = ("qwen2_0_5b", "olmoe_1b_7b", "mamba2_2_7b")
MESHES = {"1x2": ((1, 2), NAMES), "2x2": ((2, 2), NAMES),
          "2x2x2": ((2, 2, 2), ("pod", *NAMES))}
DTYPES = ("bfloat16", "float32")


def _setup(arch: str, dtype: str):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    model = build_model(cfg, max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_inputs(cfg, ShapeConfig("t", S, B, "train"), seed=1, device="cpu")
    prefill = {"tokens": make_inputs(cfg, ShapeConfig("t", S, B, "prefill"), seed=2,
                                     device="cpu")["tokens"]}
    return model, params, batch, prefill


def single(arch: str, dtype: str, mesh: tuple[int, int], train: bool = True) -> dict:
    """The single-device counterparts on an (n_batch, n_model) mesh: with
    ``train`` the train step (and its nudged twins) and the gradients; the
    prefill's and the decode steps' logits, plainly and (``rounded``) under
    ``tp_rounding``."""
    model, params, batch, prefill = _setup(arch, dtype)
    def ep():
        return ep_emulated(*mesh) if model.cfg.family == "moe" else contextlib.nullcontext()

    step = make_train_step(model, None, AdamWConfig(lr=LR))
    out = {}
    with ep():
        if train:
            out["step"] = step(params, adamw_init(params), batch)
            out["grads"] = dict(named_leaves(loss_and_grads(model, params, batch)[1]))
            nudge = ssd_nudged if model.cfg.is_ssm else norm_nudged
            out["nudged"] = []
            for to in (np.inf, -np.inf):
                with nudge(to):
                    pn, on, _ = step(params, adamw_init(params), batch)
                out["nudged"].append((step_metrics(pn, on, *out["step"][:2], LR), None))

    def serving() -> tuple:
        with ep():
            logits = make_prefill_step(model)(params, prefill)
        cache, serve, steps = model.init_cache(B, CACHE), make_serve_step(model), []
        for i in range(STEPS):
            step_logits, cache = serve(params, cache, {"token": prefill["tokens"][:, i],
                                                       "cur_len": i})
            steps.append(step_logits)
        return logits, steps

    out["logits"], out["decode"] = serving()
    with tp_rounding(mesh[1]):
        out["rounded"] = serving()
    return out


def make_runs(tmp_path_factory):
    """The test files' ``runs`` fixture: ``run(arch, mesh)`` -> the ranks'
    results by dtype and the single-device counterparts, each case run once
    a module."""
    cache = {}

    def run(arch: str, mesh: str):
        if (arch, mesh) not in cache:
            shape, names = MESHES[mesh]
            runs = {}
            for dtype in DTYPES:  # f32 trains and serves; bf16 serves
                _, params, batch, prefill = _setup(arch, dtype)
                runs[dtype] = dict(params=params, batch=batch, prefill=prefill,
                                   tokens=prefill["tokens"], train=dtype == "float32")
            out = run_ranks("tp", int(np.prod(shape)), tmp_path_factory.mktemp(f"{arch}-{mesh}"),
                            dict(arch=arch, shape=shape, names=names, max_pos=MAX_POS, lr=LR,
                                 cache_len=CACHE, steps=STEPS, runs=runs))
            n_model = shape[-1]
            cache[arch, mesh] = (
                {d: [r[d] for r in out] for d in DTYPES},
                {d: single(arch, d, (int(np.prod(shape)) // n_model, n_model),
                           train=d == "float32") for d in DTYPES})
        return cache[arch, mesh]

    return run




def tp_train_step_holds_against_the_single_device_step(runs, arch, mesh):
    ranks, want = runs(arch, mesh)
    got = ranks["float32"][0]
    assert got["misplaced"] == {}
    assert all(r["loss"] == got["loss"] for r in ranks["float32"])
    p1, o1, loss = want["float32"]["step"]
    assert abs(got["loss"] - float(loss)) <= LOSS_ATOL, (got["loss"], float(loss))
    assert int(got["opt"]["step"]) == 1
    for name, value in named_leaves(got["params"]):
        assert value.dtype == dict(named_leaves(p1))[name].dtype == torch.float32, name
    held, verdict, failures = hold_step(step_metrics(got["params"], got["opt"], p1, o1, LR),
                                        nudged=want["float32"]["nudged"])
    assert held and not failures, (verdict, failures)


def replicated_leaves_gradients_are_summed_over_model(runs, arch, mesh):
    """Every leaf, and by name the leaves no spec shards over "model", whose
    gradient each rank takes from its own tokens or heads alone: in f32
    within GRAD_RTOL of the single-device gradient."""
    ranks, want = runs(arch, mesh)
    model = build_model(get_arch(arch).reduced(), device="cpu")
    model.pure_dp = False
    specs = dict(named_leaves(model.param_specs(MeshCtx(AbstractMesh(*MESHES[mesh])))))
    replicated = {n for n, s in specs.items() if not on_model(s)}
    expect = {"qwen2_0_5b": {"final_ln", "layers.ln1", "layers.ln2"},
              "olmoe_1b_7b": {"final_ln", "layers.ln1", "layers.ln2", "layers.wr",
                              "layers.qn", "layers.kn"},
              "mamba2_2_7b": {"final_ln", "layers.ln", "layers.conv_w", "layers.wB",
                              "layers.wC", "layers.A_log", "layers.dt_bias", "layers.Dskip"}}
    assert replicated == expect[arch]
    grads = dict(named_leaves(ranks["float32"][0]["grads"]))
    for name, g in want["float32"]["grads"].items():
        err = float((grads[name] - g).norm() / g.norm())
        assert err <= GRAD_RTOL, (name, err)


def tp_prefill_and_decode_meet_the_serving_criterion(runs, arch, mesh):
    ranks, want = runs(arch, mesh)
    for dtype, atol in zip(DTYPES, (LOGIT_ATOL, F32_LOGIT_ATOL)):
        for r in ranks[dtype]:
            assert r["logits"].shape == (B, 256)
            torch.testing.assert_close(r["logits"], want[dtype]["logits"], rtol=0, atol=atol)
            for got, ref in zip(r["decode"], want[dtype]["decode"], strict=True):
                torch.testing.assert_close(got, ref, rtol=0, atol=atol)


def tp_serving_equals_the_ranks_rounding_on_one_device(runs, arch, mesh):
    """In bf16 the sharded prefill and decode equal, bit for bit, the
    single-device ones with the row-parallel products rounded as the ranks
    round them (``tp_rounding``; the MoE family's prefill through
    ``ep_emulated`` too): every other difference from the unsharded model
    is exact (the heads', FFN columns' and SSM heads' own products, the
    vocab's blocks, the sequence's gathers)."""
    ranks, want = runs(arch, mesh)
    logits, steps = want["bfloat16"]["rounded"]
    for r in ranks["bfloat16"]:
        assert torch.equal(r["logits"], logits)
        assert all(torch.equal(a, b) for a, b in zip(r["decode"], steps, strict=True))


def tp_steps_make_their_collectives_over_model(runs, arch, mesh):
    """The train step gathers and reduce-scatters the sequence, the MoE
    exchanges its buffers (two all-to-alls a layer, two more in the
    recompute and two in the backward); a decode step all-reduces the partial
    sums and gathers the vocab."""
    ranks, _ = runs(arch, mesh)
    counts = {**ranks["bfloat16"][0]["counts"], "train": ranks["float32"][0]["counts"]["train"]}
    L = get_arch(arch).reduced().n_layers
    assert counts["train"]["all_gather"] > 0 and counts["train"]["reduce_scatter"] > 0
    assert counts["train"].get("all_to_all", 0) == (6 * L if arch == "olmoe_1b_7b" else 0)
    assert counts["prefill"].get("all_to_all", 0) == (2 * L if arch == "olmoe_1b_7b" else 0)
    assert counts["decode"]["all_reduce"] > 0 and counts["decode"]["all_gather"] >= STEPS
    assert "all_to_all" not in counts["decode"]
