"""Sequence sharding composed with the fallback layouts over "model", on
gloo CPU ranks, against the port's single-device steps (JAX-free, like
``test_torch_mesh_seq.py``).

A batch that does not fill the batch axes (B = 1, the reference's
``long_500k``) shards the sequence over them; where a dim does not divide
"model", the reference's ``param_specs`` shard head_dim or replicate the
leaf (gemma3-1b's 4 heads on model=16 is the production cell). The reduced
configs are made not to divide "model" (``_torch_seq_fallback``; qk-norm
and gemma3's window-32 local layer on the split head_dim). On (data=2,
model=4), (pod=2, data=1, model=2) and, mixing a fallback attention with
Megatron-SP's MLP and mixer, (data=2, model=2), each family runs as a
model that is not pure data-parallel, one spawned process a rank
(``_torch_mesh_ranks``, case ``seq_families``):

- the prefill of S = 128 tokens (a sequence rank's block of 64, a rank's
  rows 16 or 32) equals, bit for bit, the single-device prefill under
  ``tp_rounding(model, seq=ranks)``: the head_dim-sharded attention's
  queries attend at ``seq_rank * 64 + model_rank * rows`` against the
  whole sequence's keys, the replicated MLP and head run on the rank's
  rows, and the whole mixer relays its state over each "model" rank's own
  group of the batch axes;
- 4 decode steps against a 128-long cache drawn before position 62, at
  62..65 (from the first sequence rank's last slot to the next rank's
  first), on each rank's head_dim block of its sequence block of the
  cache: bit for bit the twin (the partial scores summed over "model" and
  rounded once, the max over the batch axes, the denominator and ``w . v``
  summed in the sequence ranks' order, the out-projection's partial sums
  over "model"), and within LOGIT_ATOL of the twin of the model partial
  sums alone and of the plain decode wherever that one is too;
- the collectives a step, by kind, and the fallback kinds each case runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx
from repro_torch.train.steps import make_prefill_step, make_serve_step

from _torch_mesh_ranks import run_ranks  # noqa: I001  (tests/ helper)
from _torch_seq_fallback import MIXED, MODEL2, MODEL4
from _torch_train_criteria import tp_rounding, tp_rows

B, S, CACHE, START, STEPS, MAX_POS = 1, 128, 128, 62, 4, 256
LOGIT_ATOL = 4 * 2.0**-6  # tests/test_torch_models.py's serving criterion
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
# mesh -> family -> the reduced config's overrides
FAMILIES = {"2x4": MODEL4, "2x1x2": MODEL2, "2x2": MIXED}
# mesh -> family -> the fallback layouts it runs (``kinds``)
KINDS = {
    "2x4": {"qwen2_0_5b": {"head_dim", "ffn", "head"}, "gemma3_1b": {"head_dim"},
            "mamba2_2_7b": {"mixer"}, "zamba2_7b": {"head_dim", "ffn", "mixer"}},
    "2x1x2": {"qwen2_0_5b": {"head_dim", "ffn", "head"}, "gemma3_1b": {"head_dim"},
              "mamba2_2_7b": {"mixer"}, "zamba2_7b": {"head_dim", "ffn", "mixer"}},
    "2x2": {"qwen2_0_5b": {"head_dim"}, "gemma3_1b": {"head_dim"}, "mamba2_2_7b": {"mixer"},
            "zamba2_7b": {"head_dim"}},
}
CASES = [pytest.param(f, m, id=f"{f}-{m}") for m in MESHES for f in FAMILIES[m]]
F32 = "-f32"  # the family's config in f32 (``dtype="float32"``), run beside it
F32_RTOL = 1e-5  # of the largest |logit|; the card's f32 witness is held to 1e-4


def _model(arch: str, overrides: dict):
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), **overrides),
                        max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    return model


def _setup(arch: str, overrides: dict) -> dict:
    """The family's params, B x S prefill, the decode's starting cache (K/V
    drawn before START, the SSM caches drawn) and its fed tokens."""
    model = _model(arch, overrides)
    cfg = model.cfg
    params = model.init_params(torch.Generator().manual_seed(0))
    prefill = {"tokens": make_inputs(cfg, ShapeConfig("t", S, B, "prefill"), seed=2,
                                     device="cpu")["tokens"]}
    rng = np.random.default_rng(5)
    cache = model.init_cache(B, CACHE)
    for name, c in cache.items():
        draw = torch.from_numpy(rng.standard_normal(c.shape, dtype=np.float32)).to(c.dtype)
        if name in ("k", "v"):
            c[:, :, :START] = draw[:, :, :START]
        else:
            c.copy_(draw * 0.1)
    feeds = [{"token": torch.from_numpy(rng.integers(0, cfg.vocab, (B,), dtype=np.int32))}
             for _ in range(STEPS)]
    return dict(arch=arch, overrides=overrides, params=params, prefill=prefill, cache=cache,
                feeds=feeds, start=START)


def single(setup: dict, n_model: int, n_seq: int) -> dict:
    """The single-device prefill and decode, plainly, under the model
    partial sums' rounding alone (``tp_rounding(n_model)``) and as the ranks
    round them (``tp_rounding(n_model, seq=n_seq)``)."""
    model = _model(setup["arch"], setup["overrides"])

    def serving() -> tuple:
        logits = make_prefill_step(model)(setup["params"], setup["prefill"])
        cache = {k: v.clone() for k, v in setup["cache"].items()}
        serve, steps = make_serve_step(model), []
        for i, feed in enumerate(setup["feeds"]):
            step_logits, cache = serve(setup["params"], cache, {**feed, "cur_len": START + i})
            steps.append(step_logits)
        return logits, steps

    if model.cfg.dtype == "float32":  # the f32 witness: the twin with the ranks' row blocks
        with tp_rounding(n_model, seq=n_seq), tp_rows(model.cfg, n_seq, n_model):
            return {"rows": serving()}
    out = {"plain": serving()}
    with tp_rounding(n_model):
        out["tp"] = serving()
    with tp_rounding(n_model, seq=n_seq):
        out["twin"] = serving()
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The single-device counterparts on one thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh -> (each rank's results, each family's single-device
    counterparts); every family of a mesh in one launch of its ranks."""
    done = {}

    def run(mesh: str):
        if mesh not in done:
            shape, names = MESHES[mesh]
            families = {f: _setup(f, o) for f, o in FAMILIES[mesh].items()}
            families.update({f + F32: _setup(f, {**o, "dtype": "float32"})
                             for f, o in FAMILIES[mesh].items()})
            ranks = run_ranks("seq_families", int(np.prod(shape)), tmp_path_factory.mktemp(mesh),
                              dict(shape=shape, names=names, max_pos=MAX_POS, families=families),
                              timeout=600)
            want = {f: single(s, shape[-1], int(np.prod(shape[:-1])))
                    for f, s in families.items()}
            done[mesh] = (ranks, want)
        return done[mesh]

    return run


def kinds(model, ctx: MeshCtx) -> set[str]:
    """The fallback layouts ``model`` runs on ``ctx``: a head_dim-sharded
    attention, a replicated MLP, Mamba2 mixer, or embedding and head."""
    cfg, tp = model.cfg, model.tp_ctx(ctx, serve=True)
    out = set()
    if cfg.family != "ssm" and model._hd_fallback(tp):
        out.add("head_dim")
    if cfg.family != "ssm" and not model._splits(tp, cfg.d_ff):
        out.add("ffn")
    if cfg.is_ssm and not model._splits(tp, cfg.ssm_heads):
        out.add("mixer")
    if model._head_whole(tp):
        out.add("head")
    return out


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_fallback_runs_the_fallback_layouts(family, mesh):
    """Each case runs the fallback layouts named in KINDS (on model=2 the
    (2, 2) mesh mixes the head_dim-sharded attention with Megatron-SP's MLP
    and mixer), sequence-sharded at B = 1; the head_dim-sharded attention's
    K/V cache holds head_dim on "model" and the sequence on the batch axes,
    as the reference's ``cache_specs`` lay out gemma3-1b's ``long_500k``."""
    shape, names = MESHES[mesh]
    ctx = MeshCtx(AbstractMesh(shape, names))
    model = _model(family, FAMILIES[mesh][family])
    assert model.seq_ctx(ctx, B) is ctx
    assert kinds(model, ctx) == KINDS[mesh][family]
    if "head_dim" in KINDS[mesh][family]:
        spec = model.cache_specs(B, CACHE, ctx)["k"].spec
        assert spec[2] == ctx.batch_axes and spec[4] == "model", spec


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_fallback_prefill_equals_its_twin(runs, family, mesh):
    """Every rank returns the whole batch's logits, equal bit for bit to the
    single-device prefill under ``tp_rounding(model, seq=ranks)`` (the
    fallbacks round no partial sum of their own in the prefill; on (2, 2)
    Megatron-SP's MLP and mixer do)."""
    ranks, want = runs(mesh)
    ref = want[family]["twin"][0]
    for r in ranks:
        got = r[family]["logits"]
        assert got.shape == (B, FAMILIES[mesh][family].get("vocab", 256))
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_fallback_decode_equals_its_twin_and_meets_the_serving_criterion(runs, family, mesh):
    """Each decode step's logits equal, bit for bit, the twin that sums the
    head_dim blocks' partial scores and out-projection and the sequence
    blocks' denominator and ``w . v`` in the ranks' order, and lie within
    LOGIT_ATOL of the twin of the model partial sums alone, and of the
    plain decode wherever that twin is too."""
    ranks, want = runs(mesh)
    plain, tp, twin = want[family]["plain"][1], want[family]["tp"][1], want[family]["twin"][1]
    for r in ranks:
        steps = r[family]["decode"]
        assert len(steps) == STEPS
        for i, (got, ref, tpr, tw) in enumerate(zip(steps, plain, tp, twin, strict=True)):
            assert torch.equal(got, tw), (i, float((got - tw).abs().max()))
            torch.testing.assert_close(got, tpr, rtol=0, atol=LOGIT_ATOL)
            if float((tpr - ref).abs().max()) <= LOGIT_ATOL:
                torch.testing.assert_close(got, ref, rtol=0, atol=LOGIT_ATOL)


def _expected_counts(family: str, mesh: str) -> tuple[dict, dict]:
    """The collectives of the prefill and of one decode step, by kind, on a
    rank: counted from the layout."""
    shape, names = MESHES[mesh]
    ctx = MeshCtx(AbstractMesh(shape, names))
    model = _model(family, FAMILIES[mesh][family])
    cfg, tp = model.cfg, ctx
    hd_fb, ffn_fb = model._hd_fallback(tp), not model._splits(tp, cfg.d_ff)
    mixer_fb = cfg.is_ssm and not model._splits(tp, cfg.ssm_heads)
    n_mamba = cfg.n_layers if cfg.is_ssm else 0
    n_attn = (cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
              else 0 if cfg.family == "ssm" else cfg.n_layers)
    pre: dict[str, int] = {}
    dec: dict[str, int] = {}

    def add(d: dict, kind: str, n: int) -> None:
        if n:
            d[kind] = d.get(kind, 0) + n

    # the step's weights gathered whole once (the fallback attention's
    # head_dim-sharded leaves, in the prefill only; the whole mixer's)
    specs = model.param_specs(ctx)
    attn = "shared" if cfg.family == "hybrid" else "layers"
    whole = [(attn, ("wq", "wk", "wv", "wo", "bq", "bk", "bv") if hd_fb and n_attn else ()),
             ("layers", ("wz", "wx", "wdt", "norm", "wo") if mixer_fb else ())]
    for path, leaves in whole:
        gathered = [n for n, s in specs[path].items()
                    if n in leaves and any(e is not None for e in s.spec)]
        add(pre, "all_gather", len(gathered))
        add(dec, "all_gather", len(gathered) if mixer_fb and path == "layers" else 0)
    # the embedding (and the decode's) and the last row, the logits
    if model._vocab_parallel(tp):
        add(pre, "reduce_scatter", 1)
        add(dec, "all_reduce", 1)
        add(pre, "all_gather", 1)
        add(dec, "all_gather", 1)
    elif not model._head_whole(tp):
        add(pre, "all_gather", 1)
        add(dec, "all_gather", 1)
        add(pre, "all_reduce", 1)
        add(dec, "all_reduce", 1)
    add(pre, "all_gather", 1)  # the last position's row, over the batch axes and "model"
    # each attention layer: x over "model" and K/V over the batch axes (the
    # fallback), or Megatron-SP's gather and scatter around one K/V gather
    add(pre, "all_gather", 2 * n_attn)
    add(pre, "reduce_scatter", 0 if hd_fb else n_attn)
    # its decode: q and k whole for qk-norm and RoPE, the partial scores, the
    # max, the denominator and w . v, the out-projection
    add(dec, "all_gather", (3 if hd_fb else 2) * n_attn)
    add(dec, "all_reduce", (3 if hd_fb else 2) * n_attn)
    # the MLP: replicated on the rank's rows, or Megatron-SP
    add(pre, "all_gather", 0 if ffn_fb else n_attn)
    add(pre, "reduce_scatter", 0 if ffn_fb else n_attn)
    add(dec, "all_reduce", 0 if ffn_fb else n_attn)
    # the Mamba2 layers: the halo and the relay, the rows gathered for the
    # mixer and scattered back (Megatron-SP) or the rank's block kept
    add(pre, "halo", n_mamba)
    add(pre, "relay", n_mamba)
    add(pre, "all_gather", n_mamba)
    if n_mamba and not mixer_fb:
        add(pre, "reduce_scatter", n_mamba)
        add(pre, "all_reduce", n_mamba)  # the gated norm's sum of squares
        add(dec, "all_gather", 2 * n_mamba)  # the conv's x channels and window
        add(dec, "all_reduce", 2 * n_mamba)  # the gated norm, the out-projection
    elif n_mamba:
        add(dec, "all_gather", n_mamba)  # the conv window's channels
    return pre, dec


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_fallback_collectives(runs, family, mesh):
    """The prefill's and a decode step's collectives on every rank, by kind,
    as the layout makes them: the fallback attention's weights gathered
    once, the sequence over "model" and its K/V over the batch axes a
    layer and no reduce-scatter; a decode step's partial scores and
    out-projection summed over "model" around the max, denominator and
    ``w . v`` over the batch axes; the whole mixer's halo and relay with
    no collective over "model" but the gather of its rows."""
    ranks, _ = runs(mesh)
    pre, dec = _expected_counts(family, mesh)
    for r in ranks:
        assert r[family]["counts"]["prefill"] == pre, (r[family]["counts"]["prefill"], pre)
        assert r[family]["counts"]["decode"] == dec, (r[family]["counts"]["decode"], dec)


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_fallback_f32_serving_meets_its_row_block_twin(runs, family, mesh):
    """The family's f32 config (the card's witness of the bf16 serving): the
    prefill and each decode step within F32_RTOL of the largest |logit| of
    the single-device run under ``tp_rounding(model, seq=ranks)`` with each
    product of the prefill on the ranks' row blocks of the sequence
    (``tp_rows``), the twin ``chip_smoke.py`` holds the f32 prefill to on
    the card. Not bit for bit: in f32 gloo's all-reduce over four ranks adds
    in another order than the twin, and the CPU's f32 products may round
    otherwise on a gathered copy of a weight (measured: at most 2.3e-6 of
    logits of ~2)."""
    ranks, want = runs(mesh)
    logits, steps = want[family + F32]["rows"]
    for r in ranks:
        got = r[family + F32]
        assert got["logits"].dtype == torch.float32
        for i, (a, b) in enumerate(zip([got["logits"], *got["decode"]], [logits, *steps],
                                       strict=True)):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= F32_RTOL, (i, err)
