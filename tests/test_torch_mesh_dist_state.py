"""The port's mesh layer on gloo CPU ranks against the port's own
single-device forms, its optimizer state and decode (JAX-free: the card's
machine runs this file too); moved from ``tests/test_torch_mesh_dist.py``,
whose set-up (``_setup``: reduced configs, B = 4, S = 256) it shares, so
that the two files run on two workers of the suite.

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
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import make_inputs
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.tree import named_leaves, tree_map

from _torch_mesh_ranks import run_ranks  # noqa: I001  (tests/ helper)
from _torch_train_criteria import hold_step, step_metrics
from test_torch_mesh_dist import B, LR, MAX_POS, MESH_2, MESH_POD, S, _setup


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
