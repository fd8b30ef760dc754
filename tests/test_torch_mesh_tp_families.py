"""Tensor parallelism over "model" for the hybrid, VLM and encoder-decoder
families on gloo CPU ranks, against the port's single-device steps
(JAX-free, like ``test_torch_mesh_tp.py``, whose criteria it applies).

Reduced zamba2-7b, qwen2-vl-7b and whisper-base run as models that are not
pure data-parallel (``pure_dp=False``), and whisper-base once more with an
odd vocab (257, which no "model" axis divides: the embedding and the tied
head hold a block of d_model, the logits are the sum over "model" of each
rank's block product), each on (data=1, model=2) and (data=2, model=2),
B = 4, S = 256 (the chunked cross-entropy runs; whisper's encoder on S/2
frames), in bf16 and in f32, one spawned process a rank
(``_torch_mesh_ranks``, case ``tp_families``: every family of a mesh in
one launch of its ranks):

- the sharded train step, in f32, held by ``hold_step`` against the
  single-device step (nudged by ``ssd_nudged`` for the hybrid,
  ``norm_nudged`` for the others);
- the gradients the step hands the optimizer: every leaf ``param_specs``
  does not shard over "model" (the shared block's norms, the layer norms and
  their biases) summed over "model";
- the prefill's and three decode steps' logits within the serving criterion
  in bf16 and within 1e-4 in f32, and in bf16 equal, bit for bit, to the
  single-device run under ``tp_rounding``. The VLM decodes from embeddings;
  whisper's decode reads a cross K/V cache filled from the encoder
  (``cross_kv``);
- the collectives made over "model".

whisper-base as it is (pure data-parallel) decodes on (data=1, model=2) as
the reference's serve step does, tensor-parallel on its blocks of
``param_specs(ctx, serve=True)``: held against its single-device decode.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
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
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
DTYPES = ("bfloat16", "float32")
# id -> (arch, the reduced config's overrides)
FAMILIES = {"zamba2_7b": ("zamba2_7b", {}), "qwen2_vl_7b": ("qwen2_vl_7b", {}),
            "whisper_base": ("whisper_base", {}),
            "whisper_base-vocab257": ("whisper_base", {"vocab": 257})}
CASES = [(f, m) for f in FAMILIES for m in MESHES]
IDS = [f"{f}-{m}" for f, m in CASES]


def _cfg(family: str, dtype: str):
    arch, overrides = FAMILIES[family]
    return dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **overrides)


def _setup(family: str, dtype: str, pure_dp: bool = False) -> tuple:
    """(model, params, train batch, prefill batch, decode feeds, the decode's
    starting cache or None), all from seeds."""
    cfg = _cfg(family, dtype)
    model = build_model(cfg, max_pos=MAX_POS, device="cpu")
    model.pure_dp = pure_dp
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


def _rank_args(family: str, shape: tuple, runs: dict, **kw) -> dict:
    return dict(arch=FAMILIES[family][0], overrides=FAMILIES[family][1], shape=shape,
                names=NAMES, max_pos=MAX_POS, lr=LR, cache_len=CACHE, steps=STEPS, runs=runs,
                **kw)


def _runs(family: str, dtypes=DTYPES, pure_dp: bool = False) -> dict:
    out = {}
    for dtype in dtypes:
        _, params, batch, prefill, feeds, cache = _setup(family, dtype, pure_dp)
        out[dtype] = dict(params=params, batch=batch, prefill=prefill, feeds=feeds, cache=cache,
                          train=dtype == "float32" and not pure_dp)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The single-device counterparts on one thread, as the ranks run: the
    models are tiny, and beside the suite's other workers a thread pool a
    core oversubscribes the machine (two cases ran 20x slower so)."""
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
            families = {f: dict(arch=a, overrides=o, runs=_runs(f))
                        for f, (a, o) in FAMILIES.items()}
            launched[mesh] = run_ranks(
                "tp_families", int(np.prod(shape)), tmp_path_factory.mktemp(mesh),
                {**_rank_args(family, shape, {}), "families": families}, timeout=1200)
        if (family, mesh) not in cache:
            cache[family, mesh] = ({d: [r[family][d] for r in launched[mesh]] for d in DTYPES},
                                   {d: single(family, d, shape[-1], train=d == "float32")
                                    for d in DTYPES})
        return cache[family, mesh]

    return run


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_tp_train_step_holds_against_the_single_device_step(runs, family, mesh):
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


REPLICATED = {
    "zamba2_7b": {"final_ln", "layers.ln", "layers.conv_w", "layers.wB", "layers.wC",
                  "layers.A_log", "layers.dt_bias", "layers.Dskip", "shared.ln1", "shared.ln2"},
    "qwen2_vl_7b": {"final_ln", "layers.ln1", "layers.ln2"},
    "whisper_base": {"final_ln", "final_b", "enc_final_ln", "enc_final_b", "enc.ln1", "enc.ln2",
                     "enc.b1", "enc.b2", "dec.ln1", "dec.ln2", "dec.ln3", "dec.b1", "dec.b2",
                     "dec.b3"},
}


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_replicated_leaves_gradients_are_summed_over_model(runs, family, mesh):
    """The leaves no spec shards over "model" are those named (the shared
    block's norms, the layer norms and their biases; the odd vocab's
    embedding is on d_model), and every leaf's gradient, as the step hands
    it to AdamW, is in f32 within GRAD_RTOL of the single-device gradient
    (whisper's unread ``wu`` exactly 0)."""
    ranks, want = runs(family, mesh)
    model = build_model(_cfg(family, "float32"), max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    ctx = MeshCtx(AbstractMesh(MESHES[mesh], NAMES))
    specs = dict(named_leaves(model.param_specs(ctx)))
    assert {n for n, s in specs.items() if not on_model(s)} == REPLICATED[FAMILIES[family][0]]
    if family.endswith("vocab257"):
        assert specs["embed"].spec == (None, "model")
    grads = dict(named_leaves(ranks["float32"][0]["grads"]))
    for name, g in want["float32"]["grads"].items():
        if not bool(g.any()):
            assert not bool(grads[name].any()), name
            continue
        err = float((grads[name] - g).norm() / g.norm())
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_tp_prefill_and_decode_meet_the_serving_criterion(runs, family, mesh):
    """The prefill's and each decode step's logits within the criterion
    (LOGIT_ATOL in bf16, 1e-4 in f32) of the single-device run under
    ``tp_rounding``, and of the plain single-device run wherever the
    rounded run meets it there too (``chip_smoke.py``'s ``tp_judge``
    policy). Where it does not, the model carries the ranks' rounding
    alone past the criterion (ill-conditioned): from random weights the
    reduced VLM's bf16 prefill moves 0.117 under it, the reduced hybrid's
    (five layers) 1.55 in bf16 and ~2e-4 in f32."""
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


@pytest.mark.parametrize("family,mesh", [c for c in CASES if c[0] != "zamba2_7b"],
                         ids=[i for i in IDS if not i.startswith("zamba2")])
def test_tp_serving_equals_the_ranks_rounding_on_one_device(runs, family, mesh):
    """In bf16 the sharded prefill and decode equal, bit for bit, the
    single-device ones with the row-parallel products (and, on the odd
    vocab, the head's product over d_model) rounded as the ranks round them
    (``tp_rounding``). Not the hybrid, whose Mamba2 layers also sum their
    gated norm and run their conv and SSD on other shapes (its prefill
    differs from the rounded run by a bf16 ulp at reduced size)."""
    ranks, want = runs(family, mesh)
    logits, steps = want["bfloat16"]["rounded"]
    for r in ranks["bfloat16"]:
        assert torch.equal(r["logits"], logits)
        assert all(torch.equal(a, b) for a, b in zip(r["decode"], steps, strict=True))


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_tp_steps_make_their_collectives_over_model(runs, family, mesh):
    """The train step gathers and reduce-scatters the sequence, with no
    all-to-all; a decode step all-reduces the partial sums and gathers the
    vocab's blocks (or, on the odd vocab, the embedding's d_model blocks)."""
    ranks, _ = runs(family, mesh)
    counts = {**ranks["bfloat16"][0]["counts"], "train": ranks["float32"][0]["counts"]["train"]}
    assert counts["train"]["all_gather"] > 0 and counts["train"]["reduce_scatter"] > 0
    assert "all_to_all" not in counts["train"] and "all_to_all" not in counts["prefill"]
    assert counts["decode"]["all_reduce"] > 0 and counts["decode"]["all_gather"] >= STEPS
    assert "all_to_all" not in counts["decode"]


def test_pure_dp_whisper_decodes_tensor_parallel_on_model(tmp_path):
    """whisper-base as it is (pure data-parallel) on (data=1, model=2): its
    serve step runs the decode tensor-parallel on its blocks of
    ``param_specs(ctx, serve=True)`` (heads on "model", the embedding's
    vocab split), within the serving criterion of its single-device decode
    and equal to it under ``tp_rounding``; its prefill stays data-parallel
    over both axes, bit for bit."""
    model = build_model(get_arch("whisper_base").reduced(), max_pos=MAX_POS, device="cpu")
    assert model.pure_dp
    ctx = MeshCtx(AbstractMesh((1, 2), NAMES))
    assert model.tp_ctx(ctx) is None and model.tp_ctx(ctx, serve=True) is ctx
    assert on_model(model.param_specs(ctx, serve=True)["dec"]["wq"])
    (r0, r1) = [r["bfloat16"] for r in run_ranks("tp", 2, tmp_path, _rank_args(
        "whisper_base", (1, 2), _runs("whisper_base", ("bfloat16",), pure_dp=True),
        pure_dp=True))]
    _, params, _, prefill, feeds, cache = _setup("whisper_base", "bfloat16", pure_dp=True)
    want = _serving(model, params, prefill, feeds, cache)
    with tp_rounding(2):
        rounded = _serving(model, params, prefill, feeds, cache)
    for r in (r0, r1):
        assert torch.equal(r["logits"], want[0])
        for got, ref, exact in zip(r["decode"], want[1], rounded[1], strict=True):
            torch.testing.assert_close(got, ref, rtol=0, atol=LOGIT_ATOL)
            assert torch.equal(got, exact)
    assert r0["counts"]["decode"]["all_reduce"] > 0


def test_audio_frames_that_do_not_split_over_model_are_refused():
    """The encoder's frames are split over "model" like the tokens: 9 frames
    on model=2 raise ``ValueError`` naming them, before any collective."""
    model = build_model(_cfg("whisper_base", "float32"), max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    ctx = MeshCtx(AbstractMesh((1, 2), NAMES))
    batch = {"audio_embeds": torch.zeros((2, 9, model.cfg.d_model)),
             "tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
    with pytest.raises(ValueError, match="audio frames of 9"):
        make_train_step(model, ctx)({}, {}, batch)
    with pytest.raises(ValueError, match="audio frames of 9"):
        make_prefill_step(model, ctx)({}, {k: v for k, v in batch.items() if k != "labels"})
