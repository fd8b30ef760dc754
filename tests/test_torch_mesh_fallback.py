"""The fallback layouts of tensor parallelism over "model" on gloo CPU ranks,
against the port's single-device steps (JAX-free, like
``test_torch_mesh_tp.py``, whose criteria it applies).

Where a dim does not divide "model", the reference's ``param_specs`` shard
another (head_dim for the attention) or replicate the leaf, and the port
runs that layout (``LM`` module docstring). Reduced configs are made not to
divide model=4: 6 heads on 2 KV heads (1 for gemma3, 6 for whisper) at
head_dim 16, d_ff 90, 6 experts, 6 SSM heads (d_inner 96 of d_model 48,
head dim 16: d_inner divides, the heads do not), vocab 257 with d_model 66
(neither divides: the embedding and head replicated), with gemma3's
qk-norm and window and the VLM's M-RoPE on the head_dim-sharded attention.
Each runs as a model that is not pure data-parallel on (data=1, model=4),
and olmoe-1b-7b's also on (data=2, model=4) (its whole-array MoE layer
routes the global batch), B = 4, S = 256, in bf16 and in f32, one spawned
process a rank (``_torch_mesh_ranks``, case ``tp_families``):

- the sharded train step, in f32, held by ``hold_step`` against the
  single-device step;
- the gradients the step hands the optimizer, every leaf within GRAD_RTOL
  of the single-device gradient: the replicated leaves' summed over
  "model", the gathered head_dim-sharded ones' summed back by the gather's
  backward (once: not again with the replicated ones);
- the prefill's and three decode steps' logits within the serving
  criterion in bf16 and within 1e-4 in f32, and in bf16 equal, bit for bit,
  to the single-device run under ``tp_rounding`` (which rounds the decode's
  head_dim-sharded partial scores and out-projection as the ranks do);
- the collectives: a fallback attention makes no reduce-scatter of its
  own, and its decode sums its partial scores over "model".

``test_tp_ctx_runs_every_catalog_config_on_every_mesh`` holds that no
catalog config is refused on a (data, model) mesh from (1, 2) to (16, 16).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, all_archs, get_arch
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

from _torch_encdec import cross_kv, draw_final_norms  # noqa: I001  (tests/ helper)
from _torch_mesh_ranks import run_ranks
from _torch_train_criteria import (
    GRAD_RTOL,
    LOSS_ATOL,
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
MESHES = {"1x4": (1, 4), "2x4": (2, 4)}
DTYPES = ("bfloat16", "float32")
ODD = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16, "vocab": 257, "d_model": 66}
# id -> (arch, the reduced config's overrides)
FAMILIES = {
    "qwen2_0_5b": ("qwen2_0_5b", {**ODD, "d_ff": 90}),
    "gemma3_1b": ("gemma3_1b", {"n_heads": 6, "head_dim": 16}),
    "qwen2_vl_7b": ("qwen2_vl_7b", {"n_heads": 6, "head_dim": 16}),
    "olmoe_1b_7b": ("olmoe_1b_7b", {**ODD, "moe_experts": 6}),
    "mamba2_2_7b": ("mamba2_2_7b", {"d_model": 48, "vocab": 257}),
    "whisper_base": ("whisper_base", {**ODD, "n_kv_heads": 6, "d_ff": 90}),
}
CASES = [pytest.param(f, "1x4", id=f"{f}-1x4") for f in FAMILIES] + \
    [pytest.param("olmoe_1b_7b", "2x4", id="olmoe_1b_7b-2x4")]
# the leaves no spec shards over "model" at model=4
REPLICATED = {
    "qwen2_0_5b": {"embed", "final_ln", "layers.ln1", "layers.ln2", "layers.wd", "layers.wg",
                   "layers.wu"},
    "gemma3_1b": {"final_ln", "layers.kn", "layers.ln1", "layers.ln2", "layers.qn"},
    "qwen2_vl_7b": {"final_ln", "layers.ln1", "layers.ln2"},
    "olmoe_1b_7b": {"embed", "final_ln", "head", "layers.kn", "layers.ln1", "layers.ln2",
                    "layers.qn", "layers.w_down", "layers.w_gate", "layers.w_up", "layers.wr"},
    "mamba2_2_7b": {"final_ln", "layers.A_log", "layers.Dskip", "layers.conv_w",
                    "layers.dt_bias", "layers.ln", "layers.wB", "layers.wC", "layers.wdt"},
    "whisper_base": {"dec.b1", "dec.b2", "dec.b3", "dec.ln1", "dec.ln2", "dec.ln3", "dec.wd",
                     "dec.wg", "dec.wu", "embed", "enc.b1", "enc.b2", "enc.ln1", "enc.ln2",
                     "enc.wd", "enc.wg", "enc.wu", "enc_final_b", "enc_final_ln", "final_b",
                     "final_ln"},
}


def _cfg(family: str, dtype: str):
    arch, overrides = FAMILIES[family]
    return dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **overrides)


def _setup(family: str, dtype: str) -> tuple:
    """(model, params, train batch, prefill batch, decode feeds, the decode's
    starting cache or None), all from seeds."""
    cfg = _cfg(family, dtype)
    model = build_model(cfg, max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    params = model.init_params(torch.Generator().manual_seed(0))
    if cfg.family == "encdec":
        draw_final_norms(params, 3)
    batch = make_inputs(cfg, ShapeConfig("t", S, B, "train"), seed=1, device="cpu")
    prefill = {k: v for k, v in make_inputs(cfg, ShapeConfig("t", S, B, "prefill"), seed=2,
                                            device="cpu").items() if k != "labels"}
    rng = np.random.default_rng(4)
    cache = None
    if cfg.embeddings_input:
        feeds = [{"embed": torch.from_numpy(rng.standard_normal((B, cfg.d_model)) * 0.02
                                            ).to(torch.bfloat16)} for _ in range(STEPS)]
    else:
        feeds = [{"token": prefill["tokens"][:, i]} for i in range(STEPS)]
    if cfg.family == "encdec":  # the cross K/V of CACHE // 2 frames, from the encoder
        audio = torch.from_numpy(rng.standard_normal((B, CACHE // 2, cfg.d_model)) * 0.02
                                 ).to(torch.bfloat16)
        cache = model.init_cache(B, CACHE)
        cache["xk"], cache["xv"] = cross_kv(model, params, audio)
    return model, params, batch, prefill, feeds, cache


def _serving(model, params, prefill: dict, feeds: list, cache: dict | None) -> tuple:
    """The single-device prefill's logits and the decode steps' logits."""
    logits = make_prefill_step(model)(params, prefill)
    c = {k: v.clone() for k, v in (cache or model.init_cache(B, CACHE)).items()}
    serve, steps = make_serve_step(model), []
    for i, feed in enumerate(feeds):
        step_logits, c = serve(params, c, {**feed, "cur_len": i})
        steps.append(step_logits)
    return logits, steps


def single(family: str, dtype: str, n_model: int, train: bool) -> dict:
    """The single-device counterparts: with ``train`` the train step (and
    its nudged twins) and the gradients; the prefill's and the decode
    steps' logits, plainly and (``rounded``) under ``tp_rounding``."""
    model, params, batch, prefill, feeds, cache = _setup(family, dtype)
    out = {}
    if train:
        step = make_train_step(model, None, AdamWConfig(lr=LR))
        out["step"] = step(params, adamw_init(params), batch)
        out["grads"] = dict(named_leaves(loss_and_grads(model, params, batch)[1]))
        nudge = ssd_nudged if model.cfg.is_ssm else norm_nudged
        out["nudged"] = []
        for to in (np.inf, -np.inf):
            with nudge(to):
                pn, on, _ = step(params, adamw_init(params), batch)
            out["nudged"].append((step_metrics(pn, on, *out["step"][:2], LR), None))
    out["logits"], out["decode"] = _serving(model, params, prefill, feeds, cache)
    with tp_rounding(n_model):
        out["rounded"] = _serving(model, params, prefill, feeds, cache)
    return out


def _runs(family: str) -> dict:
    out = {}
    for dtype in DTYPES:
        _, params, batch, prefill, feeds, cache = _setup(family, dtype)
        out[dtype] = dict(params=params, batch=batch, prefill=prefill, feeds=feeds, cache=cache,
                          train=dtype == "float32")
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The single-device counterparts on one thread, as the ranks run (a
    thread pool a core oversubscribes the machine beside the suite's other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(family, mesh) -> (each dtype's rank results, each dtype's
    single-device counterparts); every family of a mesh in one launch of
    its ranks."""
    launched, cache = {}, {}

    def run(family: str, mesh: str):
        shape = MESHES[mesh]
        if mesh not in launched:
            names = [p.values[0] for p in CASES if p.values[1] == mesh]
            families = {f: dict(arch=FAMILIES[f][0], overrides=FAMILIES[f][1], runs=_runs(f))
                        for f in names}
            launched[mesh] = run_ranks(
                "tp_families", int(np.prod(shape)), tmp_path_factory.mktemp(mesh),
                dict(shape=shape, names=NAMES, max_pos=MAX_POS, lr=LR, cache_len=CACHE,
                     steps=STEPS, families=families), timeout=1200)
        if (family, mesh) not in cache:
            cache[family, mesh] = ({d: [r[family][d] for r in launched[mesh]] for d in DTYPES},
                                   {d: single(family, d, shape[-1], train=d == "float32")
                                    for d in DTYPES})
        return cache[family, mesh]

    return run


@pytest.mark.parametrize("family,mesh", CASES)
def test_fallback_train_step_holds_against_the_single_device_step(runs, family, mesh):
    ranks, want = runs(family, mesh)
    got = ranks["float32"][0]
    assert got["misplaced"] == {}
    assert all(r["loss"] == got["loss"] for r in ranks["float32"])
    p1, o1, loss = want["float32"]["step"]
    assert abs(got["loss"] - float(loss)) <= LOSS_ATOL, (got["loss"], float(loss))
    assert int(got["opt"]["step"]) == 1
    held, verdict, failures = hold_step(step_metrics(got["params"], got["opt"], p1, o1, LR),
                                        nudged=want["float32"]["nudged"])
    assert held and not failures, (verdict, failures)


@pytest.mark.parametrize("family,mesh", CASES)
def test_fallback_gradients_are_summed_once_over_model(runs, family, mesh):
    """The leaves no spec shards over "model" are those named (where the
    heads do not divide, every attention leaf but the norms is on head_dim),
    and every leaf's gradient, as the step hands it to AdamW, is in f32
    within GRAD_RTOL of the single-device gradient (whisper's unread ``wu``
    exactly 0): a gradient summed twice would be n times too large."""
    ranks, want = runs(family, mesh)
    model = build_model(_cfg(family, "float32"), max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    specs = dict(named_leaves(model.param_specs(MeshCtx(AbstractMesh(MESHES[mesh], NAMES)))))
    assert {n for n, s in specs.items() if not on_model(s)} == REPLICATED[family]
    for name in ("wq", "wk", "wv", "wo"):
        stack = next((k for k in ("layers", "dec") if f"{k}.{name}" in specs), None)
        if stack is not None and model.cfg.family != "ssm":
            assert specs[f"{stack}.{name}"].spec[-1 if name != "wo" else -2] == "model"
    grads = dict(named_leaves(ranks["float32"][0]["grads"]))
    for name, g in want["float32"]["grads"].items():
        if not bool(g.any()):
            assert not bool(grads[name].any()), name
            continue
        err = float((grads[name] - g).norm() / g.norm())
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("family,mesh", CASES)
def test_fallback_prefill_and_decode_meet_the_serving_criterion(runs, family, mesh):
    """The prefill's and each decode step's logits within the criterion
    (LOGIT_ATOL in bf16, 1e-4 in f32) of the single-device run under
    ``tp_rounding``, and of the plain single-device run wherever the
    rounded run meets it there too (``chip_smoke.py``'s ``tp_judge``
    policy)."""
    ranks, want = runs(family, mesh)
    vocab = _cfg(family, "float32").vocab
    for dtype, atol in zip(DTYPES, (LOGIT_ATOL, F32_LOGIT_ATOL)):
        plain = [want[dtype]["logits"], *want[dtype]["decode"]]
        rounded = [want[dtype]["rounded"][0], *want[dtype]["rounded"][1]]
        for r in ranks[dtype]:
            assert r["logits"].shape == (B, vocab)
            for got, ref, twin in zip([r["logits"], *r["decode"]], plain, rounded, strict=True):
                torch.testing.assert_close(got, twin, rtol=0, atol=atol)
                if float((twin - ref).abs().max()) <= atol:
                    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("family,mesh", CASES)
def test_fallback_serving_equals_the_ranks_rounding_on_one_device(runs, family, mesh):
    """In bf16 the sharded prefill and decode equal, bit for bit, the
    single-device ones rounded as the ranks round them (``tp_rounding``):
    the fallback's prefill rounds no partial sum of its own (the attention,
    a replicated MLP, mixer or head run whole on the rank's rows), its
    decode sums head_dim blocks' partial scores and out-projection."""
    ranks, want = runs(family, mesh)
    logits, steps = want["bfloat16"]["rounded"]
    for r in ranks["bfloat16"]:
        assert torch.equal(r["logits"], logits)
        assert all(torch.equal(a, b) for a, b in zip(r["decode"], steps, strict=True))


@pytest.mark.parametrize("family,mesh", CASES)
def test_fallback_collectives(runs, family, mesh):
    """A head_dim-sharded attention gathers its weights and the sequence
    and scatters nothing back (a model all of whose leaves fall back makes
    no reduce-scatter in its prefill); its decode step all-reduces the
    partial scores and out-projection; no whole-array MoE layer exchanges
    tokens (no all-to-all)."""
    ranks, _ = runs(family, mesh)
    counts = {**ranks["bfloat16"][0]["counts"], "train": ranks["float32"][0]["counts"]["train"]}
    assert counts["train"]["all_gather"] > 0
    for kind in ("train", "prefill", "decode"):
        assert "all_to_all" not in counts[kind], (kind, counts[kind])
    if family in ("qwen2_0_5b", "olmoe_1b_7b"):  # every leaf of the block falls back
        assert "reduce_scatter" not in counts["prefill"], counts["prefill"]
    if family != "mamba2_2_7b":
        assert counts["decode"]["all_reduce"] >= STEPS * _cfg(family, "float32").n_layers


MODEL_MESHES = [(d, m) for d in (1, 2, 4, 8, 16) for m in (2, 4, 8, 16)]


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_tp_ctx_runs_every_catalog_config_on_every_mesh(arch):
    """``LM.tp_ctx`` returns the mesh (for a pure data-parallel model: None
    to train, the mesh to serve) and raises for no catalog config on any
    (data, model) mesh from (1, 2) to (16, 16); where the heads do not
    divide "model" the attention's weights and the K/V cache are on
    head_dim (qwen2-0.5b on model=4, 8, 16; gemma3-1b and qwen2-vl-7b on 8,
    16; whisper-base on 16)."""
    cfg = get_arch(arch)
    model = build_model(cfg, max_pos=448 if cfg.family == "encdec" else 4096, device="cpu")
    fallback = []
    for shape in MODEL_MESHES:
        ctx = MeshCtx(AbstractMesh(shape, NAMES))
        assert model.tp_ctx(ctx) is (None if model.pure_dp else ctx)
        assert model.tp_ctx(ctx, serve=True) is ctx
        if cfg.family != "ssm" and cfg.n_heads % shape[1]:
            fallback.append(shape[1])
            specs = model.param_specs(ctx, serve=model.pure_dp)
            stack = specs["dec" if cfg.family == "encdec" else
                          "shared" if cfg.family == "hybrid" else "layers"]
            assert stack["wq"].spec[-1] == "model" and stack["wo"].spec[-2] == "model"
            cache = model.cache_specs(16, 64, ctx)
            assert cache["k"].spec[-1] == "model"
    want = {"qwen2_0_5b": {4, 8, 16}, "gemma3_1b": {8, 16}, "qwen2_vl_7b": {8, 16},
            "whisper_base": {16}}
    assert set(fallback) == want.get(arch, set())
