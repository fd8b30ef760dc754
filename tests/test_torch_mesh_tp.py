"""Tensor and expert parallelism over "model" on gloo CPU ranks, against
the port's single-device steps, for qwen2-0.5b on (data=1, model=2),
(data=2, model=2) and (pod=2, data=2, model=2), and the unit tests of the
KV heads' expansion and the expert-parallel exchange; olmoe-1b-7b and
mamba2-2.7b are in ``test_torch_mesh_tp_moe_ssm.py``. The cases, criteria
and single-device counterparts are ``tests/_torch_mesh_tp.py``'s
(JAX-free: the card's machine runs this file too)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.models.layers import moe_layer

import _torch_mesh_tp as _tp  # noqa: I001  (tests/ helper)
from _torch_mesh_tp import (
    B,
    CACHE,
    F32_LOGIT_ATOL,
    GRAD_RTOL,
    LR,
    MAX_POS,
    NAMES,
    STEPS,
    AbstractMesh,
    MeshCtx,
    named_leaves,
    run_ranks,
)
from _torch_moe_criteria import ep_moe

CASES = [("qwen2_0_5b", m) for m in ("1x2", "2x2", "2x2x2")]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _tp.make_runs(tmp_path_factory)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_train_step_holds_against_the_single_device_step(runs, arch, mesh):
    _tp.tp_train_step_holds_against_the_single_device_step(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_replicated_leaves_gradients_are_summed_over_model(runs, arch, mesh):
    _tp.replicated_leaves_gradients_are_summed_over_model(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_prefill_and_decode_meet_the_serving_criterion(runs, arch, mesh):
    _tp.tp_prefill_and_decode_meet_the_serving_criterion(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_serving_equals_the_ranks_rounding_on_one_device(runs, arch, mesh):
    _tp.tp_serving_equals_the_ranks_rounding_on_one_device(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_steps_make_their_collectives_over_model(runs, arch, mesh):
    _tp.tp_steps_make_their_collectives_over_model(runs, arch, mesh)


def test_kv_heads_expand_to_the_ranks_heads(tmp_path):
    """Reduced qwen2-0.5b (4 heads on 2 KV heads) on (data=1, model=4): the
    KV heads do not divide "model", so each rank expands them to its query
    head, as the reference's ``gqa_attention`` does, from the K/V weights
    and biases gathered over head_dim (the specs shard them there), and
    decodes from a cache sharded over head_dim. In f32 the step's
    gradients, the prefill and decode equal the single-device ones."""
    model, params, batch, prefill = _tp._setup("qwen2_0_5b", "float32")
    ctx = MeshCtx(AbstractMesh((1, 4), NAMES))
    specs = dict(named_leaves(model.param_specs(ctx)))
    assert specs["layers.wk"].spec == (None, None, None, "model")
    assert model.cache_specs(B, CACHE, ctx)["k"].spec == (None, ("data",), None, None, "model")
    ranks = [r["float32"] for r in run_ranks("tp", 4, tmp_path, dict(
        arch="qwen2_0_5b", shape=(1, 4), names=NAMES, max_pos=MAX_POS, lr=LR,
        cache_len=CACHE, steps=STEPS, runs={"float32": dict(
            params=params, batch=batch, prefill=prefill, tokens=prefill["tokens"],
            train=True)}))]
    want = _tp.single("qwen2_0_5b", "float32", (1, 4))
    for r in ranks:
        torch.testing.assert_close(r["logits"], want["logits"], rtol=0, atol=F32_LOGIT_ATOL)
        for got, ref in zip(r["decode"], want["decode"], strict=True):
            torch.testing.assert_close(got, ref, rtol=0, atol=F32_LOGIT_ATOL)
    grads = dict(named_leaves(ranks[0]["grads"]))
    for name, g in want["grads"].items():
        assert float((grads[name] - g).norm() / g.norm()) <= GRAD_RTOL, name


def test_expert_parallel_exchange_keeps_the_references_layout():
    """The reference's expert-parallel ``moe_layer`` reads the blocks it
    receives as (E/n, n*C, D) by a plain reshape (``src/repro/models/
    layers.py:292``): for n_model > 1 a row goes to the local expert of its
    place in the concatenation, not to the one it was routed to. The
    emulation of that exchange differs from routing the same blocks through
    the whole-array form, which it equals on one rank. The port keeps the
    reference's layout (ROADMAP C); the sharded steps above equal its
    emulation, and ``test_torch_mesh_ref.py`` the reference itself."""
    g = torch.Generator().manual_seed(0)
    D, E, F, K = 16, 4, 8, 2
    x = torch.randn((2, 32, D), generator=g)
    wr, wg, wu, wd = (torch.randn(s, generator=g) for s in ((D, E), (E, D, F), (E, D, F),
                                                            (E, F, D)))
    kw = dict(top_k=K, capacity_factor=4.0)
    ep, _ = ep_moe(x, wr, wg, wu, wd, n_batch=1, n_model=2, **kw)
    blocks = [moe_layer(x[:, m * 16:(m + 1) * 16], wr, wg, wu, wd, **kw)[0] for m in range(2)]
    assert not torch.allclose(ep, torch.cat(blocks, dim=1), atol=1e-3)
    one, _ = ep_moe(x, wr, wg, wu, wd, n_batch=1, n_model=1, **kw)
    torch.testing.assert_close(one, moe_layer(x, wr, wg, wu, wd, **kw)[0])
