"""Sequence sharding for serving on gloo CPU ranks, against the port's
single-device steps (JAX-free, like ``test_torch_mesh_tp.py``).

A batch that does not fill the batch axes (the reference's ``long_500k``,
B = 1) shards the sequence over them (``MeshCtx.token_spec``,
``LM.seq_ctx``). The dense (qwen2-0.5b, and gemma3-1b with its window-32
local layer and its global layer), SSM (mamba2-2.7b) and hybrid (zamba2-7b)
families' reduced configs run as models that are not pure data-parallel,
B = 1, on (data=2, model=1), (4, 1), (pod=2, data=2, model=1) and (2, 2),
one spawned process a rank, every family of a mesh in one launch
(``_torch_mesh_ranks``, case ``seq_families``):

- the prefill of S = 128 tokens (a rank's block 32 or 64: two or more SSM
  chunks of 16, and gemma3's window crossing a rank's edge) equals the
  single-device prefill bit for bit at model = 1 (the keys gathered, the
  flash kernel's plain version at the rank's offset, the conv's halo and
  the state's relay), and the single-device prefill under ``tp_rounding``
  on (2, 2);
- 4 decode steps against a 128-long cache drawn for the positions before
  62, at 62..65: the position crosses from a rank's last slot to the next
  rank's first, the ranks past it hold only masked keys, and on four ranks
  gemma3's local layer holds no key of the first rank in its window. The
  logits equal, bit for bit, the single-device decode's twin that sums the
  denominator and ``w . v`` in the ranks' order (``tp_rounding(model,
  seq=ranks)``), and lie within the serving criterion of the plain one;
- three rows on (4, 1), which do not fill its batch axes either: the same
  bit for bit;
- the collectives a step, by kind; the block order of ``ctx.local`` on
  (pod, data); the relay's one state a hop and the halo's K - 1 rows, and
  the mixer on a rank's block exact against the whole mixer's rows; the
  errors of what does not split; every family's steps accepted on a
  spec-only mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, all_archs, get_arch
from repro_torch.configs.base import shapes_for
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step

from _torch_mesh_ranks import run_ranks  # noqa: I001  (tests/ helper)
from _torch_train_criteria import tp_rounding

B, S, CACHE, START, STEPS, MAX_POS = 1, 128, 128, 62, 4, 256
B3 = 3  # a batch of three rows on four batch ranks is sequence-sharded too
LOGIT_ATOL = 4 * 2.0**-6  # tests/test_torch_models.py's serving criterion
MESHES = {"2x1": ((2, 1), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")), "2x2": ((2, 2), ("data", "model"))}
FAMILIES = {"qwen2_0_5b": {}, "gemma3_1b": {}, "mamba2_2_7b": {}, "zamba2_7b": {}}
CASES = [pytest.param(f, m, id=f"{f}-{m}") for m in MESHES for f in FAMILIES]


def _model(arch: str, **overrides):
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), **overrides),
                        max_pos=MAX_POS, device="cpu")
    model.pure_dp = False
    return model


def _setup(arch: str, B: int = B) -> dict:
    """The family's params, B x S prefill, the decode's starting cache
    (K/V drawn before START, the SSM caches drawn) and its fed tokens."""
    model = _model(arch, **FAMILIES[arch])
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
    return dict(arch=arch, overrides=FAMILIES[arch], params=params, prefill=prefill, cache=cache,
                feeds=feeds, start=START)


def single(arch: str, n_model: int, n_seq: int, B: int = B) -> dict:
    """The single-device prefill and decode, plainly and as the ranks round
    them (the prefill under ``tp_rounding(n_model)``, the decode under
    ``tp_rounding(n_model, seq=n_seq)``)."""
    model, setup = _model(arch, **FAMILIES[arch]), _setup(arch, B)

    def serving() -> tuple:
        logits = make_prefill_step(model)(setup["params"], setup["prefill"])
        cache = {k: v.clone() for k, v in setup["cache"].items()}
        serve, steps = make_serve_step(model), []
        for i, feed in enumerate(setup["feeds"]):
            step_logits, cache = serve(setup["params"], cache, {**feed, "cur_len": START + i})
            steps.append(step_logits)
        return logits, steps

    out = {"plain": serving()}
    with tp_rounding(n_model):
        out["tp"] = serving()
    with tp_rounding(n_model, seq=n_seq):
        out["decode_twin"] = serving()[1]
    return out


def _ragged(mesh: str) -> dict:
    """mamba2's prefill of 24 tokens a batch rank: not a whole number of its
    16-long chunks."""
    (shape, names) = MESHES[mesh]
    n_batch = int(np.prod(shape[:-1]))
    model = _model("mamba2_2_7b")
    tokens = torch.zeros((B, 24 * n_batch), dtype=torch.int32)
    return dict(arch="mamba2_2_7b", overrides={},
                params=model.init_params(torch.Generator().manual_seed(0)),
                prefill={"tokens": tokens})


def _mixer() -> dict:
    """One reduced mamba2 layer's mixer weights (its 1-D leaves drawn) and
    a (B, S, D) input."""
    model = _model("mamba2_2_7b")
    g = torch.Generator().manual_seed(3)
    layer = {k: v[0] for k, v in model.init_params(g)["layers"].items() if k != "ln"}
    for k in ("dt_bias", "A_log", "Dskip", "norm"):
        layer[k] = torch.randn(layer[k].shape, generator=g) * 0.5
    x = (torch.randn((B, S, model.cfg.d_model), generator=g)).to(torch.bfloat16)
    return {"p": layer, "x": x}


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
            families = {f: _setup(f) for f in FAMILIES}
            if mesh == "4x1":  # three rows, which four batch ranks cannot split either
                families["qwen2_0_5b-B3"] = _setup("qwen2_0_5b", B3)
            ranks = run_ranks("seq_families", int(np.prod(shape)), tmp_path_factory.mktemp(mesh),
                              dict(shape=shape, names=names, max_pos=MAX_POS, positions=S,
                                   families=families, ragged=_ragged(mesh), mixer=_mixer()),
                              timeout=600)
            n_seq = int(np.prod(shape[:-1]))
            want = {f: single(f, shape[-1], n_seq) for f in FAMILIES}
            if mesh == "4x1":
                want["qwen2_0_5b-B3"] = single("qwen2_0_5b", 1, n_seq, B3)
            done[mesh] = (ranks, want)
        return done[mesh]

    return run


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_prefill_equals_the_unsharded_prefill(runs, family, mesh):
    """Every rank returns the whole batch's logits, equal bit for bit to the
    single-device prefill's (on (2, 2) under ``tp_rounding(2)``, the
    Megatron-SP partial sums over "model"; the sequence's blocks round
    nothing of their own)."""
    ranks, want = runs(mesh)
    model_split = MESHES[mesh][0][-1] > 1
    ref = want[family]["tp" if model_split else "plain"][0]
    for r in ranks:
        got = r[family]["logits"]
        assert got.shape == (B, get_arch(family).reduced().vocab)
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_decode_equals_its_twin_and_meets_the_serving_criterion(runs, family, mesh):
    """Each decode step's logits equal, bit for bit, the single-device
    decode as the ranks round it (the softmax's denominator and ``w . v``
    summed over each rank's block of the keys, then in the ranks' order),
    and lie within LOGIT_ATOL of the single-device decode under the
    tensor-parallel rounding alone (``tp_rounding(model)``, the plain
    decode at model = 1), and of the plain decode wherever that run is too
    (``test_torch_mesh_fallback.py``'s policy: on (2, 2) reduced qwen2's and
    zamba2's bf16 decode moves past the criterion under the model
    partial sums' rounding alone, with no sequence sharding)."""
    ranks, want = runs(mesh)
    plain, tp, twin = want[family]["plain"][1], want[family]["tp"][1], want[family]["decode_twin"]
    for r in ranks:
        steps = r[family]["decode"]
        assert len(steps) == STEPS
        for i, (got, ref, tpr, tw) in enumerate(zip(steps, plain, tp, twin, strict=True)):
            assert torch.equal(got, tw), (i, float((got - tw).abs().max()))
            torch.testing.assert_close(got, tpr, rtol=0, atol=LOGIT_ATOL)
            if float((tpr - ref).abs().max()) <= LOGIT_ATOL:
                torch.testing.assert_close(got, ref, rtol=0, atol=LOGIT_ATOL)


def _layers(family: str) -> tuple[int, int]:
    """(Mamba2 layers, attention layers) of the reduced config."""
    cfg = get_arch(family).reduced()
    if cfg.family == "ssm":
        return cfg.n_layers, 0
    if cfg.family == "hybrid":
        return cfg.n_layers, cfg.n_layers // cfg.shared_attn_every
    return 0, cfg.n_layers


def test_seq_serving_of_three_rows_on_four_batch_ranks(runs):
    """B = 3 does not fill (4, 1)'s batch axes either: the sequence is
    sharded, every rank returns the three rows, the prefill equal to the
    single-device one and the decode to its twin, bit for bit."""
    ranks, want = runs("4x1")
    for r in ranks:
        got = r["qwen2_0_5b-B3"]
        assert got["logits"].shape == (B3, get_arch("qwen2_0_5b").reduced().vocab)
        assert torch.equal(got["logits"], want["qwen2_0_5b-B3"]["plain"][0])
        for a, b in zip(got["decode"], want["qwen2_0_5b-B3"]["decode_twin"], strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_collectives(runs, family, mesh):
    """The prefill gathers each attention layer's keys once over the batch
    axes, exchanges one halo and one relay a Mamba2 layer, and gathers the
    last position's row once; a decode step all-reduces each attention
    layer's row max and gathers its two partial sums (denominator and
    ``w . v``), and runs the SSM layers with no collective. On (2, 2) the
    Megatron-SP collectives over "model" come on top."""
    ranks, _ = runs(mesh)
    mamba, attn = _layers(family)
    model_split = MESHES[mesh][0][-1] > 1
    for r in ranks:
        pre, dec = r[family]["counts"]["prefill"], r[family]["counts"]["decode"]
        assert pre.get("halo", 0) == mamba and pre.get("relay", 0) == mamba, pre
        assert dec.get("halo", 0) == 0 and dec.get("relay", 0) == 0, dec
        if model_split:
            assert pre.get("all_gather", 0) > attn + 1, pre
            assert dec.get("all_reduce", 0) >= attn, dec
            continue
        want_pre = {"all_gather": attn + 1, "halo": mamba, "relay": mamba}
        assert pre == {k: v for k, v in want_pre.items() if v}, pre
        assert dec == ({"all_reduce": attn, "all_gather": 2 * attn} if attn else {}), dec


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_block_order_is_the_flattened_batch_index(runs, mesh):
    """``ctx.local`` under the spec (None, batch_axes) gives each rank the
    contiguous block at its ``seq_rank``, the flattened index over the
    batch axes with "pod" outermost (data + pod * n_data): the block the
    model's positions and the relay's order assume."""
    ranks, _ = runs(mesh)
    shape, names = MESHES[mesh]
    n = int(np.prod(shape[:-1]))
    seen = set()
    for rank, r in enumerate(ranks):
        coord = dict(zip(names, np.unravel_index(rank, shape)))
        want = int(coord["data"]) + int(coord.get("pod", 0)) * shape[names.index("data")]
        assert r["seq_rank"] == want
        block = S // n
        assert torch.equal(r["block"], torch.arange(want * block, (want + 1) * block)[None])
        seen.add(want)
    assert seen == set(range(n))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_mixer_relays_one_state_a_hop_and_a_halo_of_k_minus_1_rows(runs, mesh):
    """The Mamba2 mixer alone on a rank's block of 128 positions equals the
    whole sequence's mixer's rows bit for bit. Each rank but the last
    sends one (B, G, H, N, P) f32 state to the next and nothing else (not
    every chunk's state); the halo is the previous rank's last K - 1 rows
    of the conv's input (zeros on the first rank)."""
    ranks, _ = runs(mesh)
    cfg = get_arch("mamba2_2_7b").reduced()
    n = int(np.prod(MESHES[mesh][0][:-1]))
    state = (B, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)
    for r in ranks:
        m = r["mixer"]
        assert torch.equal(m["block"], m["whole"]), float((m["block"] - m["whole"]).abs().max())
        assert m["sent"] == ([] if r["seq_rank"] == n - 1 else [(state, torch.float32)])
        assert m["halo"].shape == (B, cfg.conv_kernel - 1, m["halo"].shape[-1])
        assert torch.equal(m["halo"], m["halo_want"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_prefill_refuses_a_block_of_partial_ssm_chunks(runs, mesh):
    """A sequence rank's block of 24 tokens is no whole number of mamba2's
    16-long chunks: ``ValueError`` naming the block and the whole length."""
    ranks, _ = runs(mesh)
    n = int(np.prod(MESHES[mesh][0][:-1]))
    for r in ranks:
        assert r["ragged"] is not None
        assert "sequence length 24 is not a multiple of the chunk 16" in r["ragged"]
        assert f"a sequence of {24 * n} sharded over {n} ranks" in r["ragged"]


# --------------------------------------------- what raises, on a spec-only mesh
def _abstract(shape=(2, 1), names=("data", "model")) -> MeshCtx:
    return MeshCtx(AbstractMesh(shape, names))


RAISES = {
    # id -> (arch, overrides, mesh shape, step kind): what raised
    # ``NotImplementedError`` until every family ran sequence-sharded
    "training": ("olmoe_1b_7b", {}, (2, 1), "train"),
    "moe": ("olmoe_1b_7b", {}, (2, 1), "prefill"),
    "moe-decode": ("olmoe_1b_7b", {}, (2, 1), "decode"),
    "vlm": ("qwen2_vl_7b", {}, (2, 1), "prefill"),
    "encdec": ("whisper_base", {}, (2, 1), "prefill"),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_seq_steps_raise_for_what_does_not_run_yet(case):
    """A B = 1 step on a spec-only mesh of two batch ranks: ``seq_ctx`` is
    the mesh for the MoE, VLM and encoder-decoder families, serving or
    training, as for the others, and each step builds and stops only at the
    mesh's missing process group (``RuntimeError``, "AbstractMesh"), as the
    dense family's does: nothing is refused (they run on gloo ranks:
    ``test_torch_mesh_seq_families.py``)."""
    arch, overrides, shape, kind = RAISES[case]
    model = _model(arch, **overrides)
    ctx = _abstract(shape)
    cfg = model.cfg
    assert model.seq_ctx(ctx, B, train=kind == "train") is ctx
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_inputs(cfg, ShapeConfig("t", 256, B, "train" if kind == "train" else "prefill"),
                        seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="AbstractMesh"):
        if kind == "train":
            make_train_step(model, ctx, AdamWConfig())(params, adamw_init(params), batch)
        elif kind == "prefill":
            make_prefill_step(model, ctx)(params, batch)
        else:
            make_serve_step(model, ctx)(params, model.init_cache(B, 64),
                                        {"token": torch.zeros((B,), dtype=torch.int32),
                                         "cur_len": 0})


@pytest.mark.parametrize("shape,S", [((4, 1), 130), ((2, 2), 130)])
def test_seq_prefill_refuses_a_sequence_that_does_not_split(shape, S):
    """``ValueError`` where the sequence does not split over the batch
    ranks (times "model" where Megatron-SP splits each block again)."""
    model = _model("qwen2_0_5b")
    with pytest.raises(ValueError, match=f"a sequence of {S} does not split"):
        make_prefill_step(model, _abstract(shape))(
            model.init_params(torch.Generator().manual_seed(0)),
            {"tokens": torch.zeros((B, S), dtype=torch.int32)})


def test_seq_serve_refuses_a_cache_that_does_not_split():
    model = _model("qwen2_0_5b")
    with pytest.raises(ValueError, match="a 66-long cache does not split over 4 batch ranks"):
        make_serve_step(model, _abstract((4, 1)))(
            model.init_params(torch.Generator().manual_seed(0)), model.init_cache(B, 66),
            {"token": torch.zeros((B,), dtype=torch.int32), "cur_len": 0})


def test_seq_ctx_and_specs_follow_the_references_token_spec():
    """``seq_ctx`` is the mesh exactly where ``token_spec`` puts the sequence
    on the batch axes (a batch that does not fill them, on more than one
    batch rank); ``cache_specs`` shards K/V's sequence dim there and leaves
    the conv and SSM caches replicated over the batch axes."""
    for shape, names in MESHES.values():
        ctx = MeshCtx(AbstractMesh(shape, names))
        n = ctx.n_batch
        for b in (1, n - 1, n, 2 * n, n + 1):
            seq = ctx.token_spec(b)[0] is None
            assert seq == ctx.seq_sharded(b)
            assert (_model("zamba2_7b").seq_ctx(ctx, b) is ctx) == seq
        specs = _model("zamba2_7b").cache_specs(1, 64, ctx)
        axes = ctx.batch_axes
        assert specs["k"].spec[2] == axes and specs["v"].spec[2] == axes
        assert all(axes not in s.spec for n_, s in specs.items() if n_ in ("conv", "ssm"))
    assert _model("qwen2_0_5b").seq_ctx(_abstract((1, 2)), 1) is None


PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [pytest.param(a, shape.name, m, id=f"{a}-{shape.name}-{m}")
         for m in PRODUCTION for a in sorted(all_archs()) for shape in shapes_for(get_arch(a))]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_every_production_cell_is_accepted(arch, shape, mesh):
    """Every cell of the reference's ``launch/dryrun.py`` (each catalog
    arch, each of its ``shapes_for`` shapes, on the production meshes) is
    accepted by ``tp_ctx`` and ``seq_ctx`` as its step asks them (the
    prefill and train steps' ``tp_ctx(ctx)``, the serve step's with
    ``serve``): none raises, a sequence-sharded cell's sequence splits over
    the batch ranks and "model", and ``gemma3_1b``'s ``long_500k`` (4 heads
    and 1 KV head on model=16: the head_dim fallback) lays out its cache with
    "model" on head_dim and the batch axes on the sequence, as the
    reference's ``cache_specs`` do."""
    cfg = get_arch(arch)
    cell = next(s for s in shapes_for(cfg) if s.name == shape)
    ctx = MeshCtx(AbstractMesh(*PRODUCTION[mesh]))
    model = build_model(cfg, max_pos=448 if cfg.family == "encdec" else 4096, device="cpu")
    tp = model.tp_ctx(ctx, serve=cell.kind == "decode")
    sp = model.seq_ctx(ctx, cell.global_batch, train=cell.kind == "train")
    assert sp is (ctx if ctx.seq_sharded(cell.global_batch) else None)
    if sp is not None:
        assert cell.seq_len % (ctx.n_batch * (ctx.n_model if tp is not None else 1)) == 0
    if (arch, shape) == ("gemma3_1b", "long_500k"):
        assert sp is ctx and model._hd_fallback(tp)
        spec = model.cache_specs(cell.global_batch, cell.seq_len, ctx)["k"].spec
        assert spec[2] == ctx.batch_axes and spec[4] == "model", spec
