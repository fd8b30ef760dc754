"""Sequence sharding of the MoE, VLM and encoder-decoder families on gloo
CPU ranks, against the port's single-device steps (JAX-free, like
``test_torch_mesh_seq.py``).

A batch that does not fill the batch axes (B = 1) shards the sequence over
them (``LM.seq_ctx``) for every family. Reduced olmoe-1b-7b and qwen2-vl-7b
run as models that are not pure data-parallel, reduced whisper-base as the
pure data-parallel model it is (its prefill and training on whole weights
on every "model" rank, its decode tensor-parallel on the serve specs, as
the reference's steps run it), on (data=2, model=1) and (data=2, model=2),
one spawned process a rank, every family of a mesh in one launch
(``_torch_mesh_ranks``, case ``seq_families``):

- the prefill of 1 x 256 (olmoe's tokens, qwen2-vl's embeddings and M-RoPE
  positions, whisper's 256 tokens on 128 audio frames) equals the
  single-device prefill bit for bit at model = 1, and on (2, 2) its twin:
  the single-device prefill under ``tp_rounding(2)`` (Megatron-SP's
  partial sums), olmoe's with its expert-parallel branch emulated on the
  two halves of the whole sequence (``ep_emulated(1, 2)``: each "model"
  rank routes its block of the whole sequence, the reference's layout);
  whisper's, whose prefill is pure data-parallel, the plain one;
- olmoe's dropped assignments in every MoE layer of the prefill equal the
  single-device run's: at model = 1 every rank routes the whole sequence,
  its capacity from it; on (2, 2) "model" rank m routes block m of the
  whole sequence and drops what the emulated branch drops there;
- 4 decode steps against a 128-long cache drawn for the positions before
  62, at 62..65 (a rank's last slot, then the next rank's first), whisper's
  with a drawn cross cache of 128 frames, 64 on each sequence rank: every
  step equals, bit for bit, the single-device decode's twin
  (``tp_rounding(model, seq=2)``: each attention's softmax over the ranks'
  blocks of its keys, the cross-attention's too);
- the collectives of the prefill and of a decode step, by kind;
- one f32 train step of each (B = 1 x 256): every gradient leaf within
  1e-4 relative L2 of the one-process step's (olmoe's on (2, 2) with its
  branch emulated), and the loss equal to the one-process loss within
  1e-5: the MoE's auxiliary loss, the same on every sequence rank, counted
  once;
- whisper-base's published 1500 frames split over 2 and 4 batch ranks and
  are refused on 16, by the prefill and by the serve step's cross cache
  (on a spec-only mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.models.sharding import AbstractMesh, MeshCtx
from repro_torch.train.steps import loss_and_grads, make_prefill_step, make_serve_step
from repro_torch.tree import named_leaves

from _torch_encdec import draw_final_norms  # noqa: I001  (tests/ helper)
from _torch_mesh_ranks import run_ranks
from _torch_moe_criteria import RouteLog, ep_emulated
from _torch_train_criteria import rel_l2, tp_rounding

B, S, CACHE, START, STEPS, MAX_POS, LR = 1, 256, 128, 62, 4, 256, 3e-4
GRAD_RTOL, LOSS_RTOL, TIMEOUT = 1e-4, 1e-5, 300
MESHES = {"2x1": ((2, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
# arch -> pure_dp (None: the model's own, whisper-base's True)
FAMILIES = {"olmoe_1b_7b": False, "qwen2_vl_7b": False, "whisper_base": None}
CASES = [pytest.param(f, m, id=f"{f}-{m}") for m in MESHES for f in FAMILIES]


def _model(arch: str, dtype: str = "bfloat16"):
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype=dtype),
                        max_pos=MAX_POS, device="cpu")
    if FAMILIES[arch] is not None:
        model.pure_dp = FAMILIES[arch]
    return model


def _params(model, seed: int = 0) -> dict:
    params = model.init_params(torch.Generator().manual_seed(seed))
    if model.cfg.family == "encdec":  # from the init rule its logits are exactly 0
        draw_final_norms(params, seed + 9)
    return params


def _setup(arch: str) -> dict:
    """The family's params, 1 x S prefill, the decode's starting cache (K/V
    drawn before START; whisper's cross cache drawn, 128 frames), its feeds
    (tokens, or the VLM's embeddings), and the f32 train step's params and
    1 x S batch."""
    model = _model(arch)
    cfg = model.cfg
    params = _params(model)
    prefill = make_inputs(cfg, ShapeConfig("t", S, B, "prefill"), seed=2, device="cpu")
    rng = np.random.default_rng(5)
    cache = model.init_cache(B, CACHE)
    for name in ("k", "v"):
        draw = rng.standard_normal(cache[name].shape, dtype=np.float32)
        cache[name][:, :, :START] = torch.from_numpy(draw).to(torch.bfloat16)[:, :, :START]
    if cfg.family == "encdec":
        shape = (cfg.n_layers, B, S // 2, cfg.n_kv_heads, cfg.hd)
        for name in ("xk", "xv"):
            cache[name] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                           ).to(torch.bfloat16)
    if cfg.embeddings_input:
        feeds = [{"embed": torch.from_numpy(rng.standard_normal((B, cfg.d_model),
                                                                dtype=np.float32) * 0.02
                                            ).to(torch.bfloat16)} for _ in range(STEPS)]
    else:
        feeds = [{"token": torch.from_numpy(rng.integers(0, cfg.vocab, (B,), dtype=np.int32))}
                 for _ in range(STEPS)]
    f32 = _model(arch, "float32")
    train = dict(overrides={"dtype": "float32"}, params=_params(f32, 1),
                 batch=make_inputs(f32.cfg, ShapeConfig("t", S, B, "train"), seed=1,
                                   device="cpu"))
    return dict(arch=arch, overrides={}, pure_dp=model.pure_dp, params=params, prefill=prefill,
                cache=cache, feeds=feeds, start=START, train=train)


def _emulated(arch: str, n_model: int):
    """The single-device counterpart of the expert-parallel branch on model >
    1: each "model" rank's block of the whole sequence routed alone."""
    if get_arch(arch).family == "moe" and n_model > 1:
        return ep_emulated(1, n_model)
    return contextlib.nullcontext()


def single(arch: str, setup: dict, n_model: int, n_seq: int) -> dict:
    """The single-device prefill (its drops, as host tuples), plainly and as
    the ranks compute it (the prefill's twin), the decode's twin, and the
    f32 step's loss and gradients (emulated likewise)."""
    model = _model(arch)
    ctx = MeshCtx(AbstractMesh((n_seq, n_model), ("data", "model")))
    tp_prefill = n_model if model.tp_ctx(ctx) is not None else 1
    tp_decode = n_model if model.tp_ctx(ctx, serve=True) is not None else 1

    def prefill() -> tuple:
        with RouteLog() as routes:
            logits = make_prefill_step(model)(setup["params"], setup["prefill"])
        return logits, [(int(c["routed"].sum() - c["kept"].sum()), int(c["routed"].sum()))
                        for c in routes.calls]

    def decode() -> list:
        cache = {k: v.clone() for k, v in setup["cache"].items()}
        serve, steps = make_serve_step(model), []
        for i, feed in enumerate(setup["feeds"]):
            logits, cache = serve(setup["params"], cache, {**feed, "cur_len": START + i})
            steps.append(logits)
        return steps

    out = {}
    with tp_rounding(tp_prefill), _emulated(arch, tp_prefill):
        out["prefill"] = prefill()
    with tp_rounding(tp_decode, seq=n_seq):
        out["decode"] = decode()
    f32, train = _model(arch, "float32"), setup["train"]
    with _emulated(arch, tp_prefill):
        loss, grads = loss_and_grads(f32, train["params"], train["batch"])
    out["loss"], out["grads"] = float(loss), dict(named_leaves(grads))
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
    """mesh -> (each rank's results, arch -> the single-device
    counterparts); every family of a mesh in one launch of its ranks."""
    done = {}

    def run(mesh: str):
        if mesh not in done:
            shape, names = MESHES[mesh]
            setups = {f: _setup(f) for f in FAMILIES}
            ranks = run_ranks("seq_families", int(np.prod(shape)), tmp_path_factory.mktemp(mesh),
                              dict(shape=shape, names=names, max_pos=MAX_POS, lr=LR,
                                   families=setups), timeout=TIMEOUT)
            done[mesh] = ranks, {f: single(f, setups[f], shape[1], shape[0]) for f in FAMILIES}
        return done[mesh]

    return run


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_prefill_equals_the_unsharded_prefill(runs, family, mesh):
    """Every rank returns the whole batch's logits, equal bit for bit to the
    single-device prefill computed as the ranks compute it (the plain one
    at model = 1)."""
    ranks, want = runs(mesh)
    ref = want[family]["prefill"][0]
    for r in ranks:
        got = r[family]["logits"]
        assert got.shape == (B, get_arch(family).reduced().vocab)
        assert torch.isfinite(got).all() and float(got.abs().max()) > 0
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_moe_drops_equal_the_unsharded_drops(runs, mesh):
    """olmoe's dropped assignments (and those routed), layer by layer: at
    model = 1 each rank routes the whole sequence (capacity from all 256
    tokens) and drops exactly what the single-device prefill drops; on
    (2, 2) "model" rank m routes block m of the whole sequence on both
    sequence ranks, and drops exactly what the emulated branch drops there
    (it routes the blocks in order, one route a block and layer)."""
    ranks, want = runs(mesh)
    n_model = MESHES[mesh][0][1]
    want_drops = want["olmoe_1b_7b"]["prefill"][1]
    assert len(want_drops) == n_model * get_arch("olmoe_1b_7b").reduced().n_layers
    assert sum(d for d, _ in want_drops) > 0  # the capacity binds
    for rank, r in enumerate(ranks):
        m = rank % n_model  # (data, model): the model index is innermost
        assert r["olmoe_1b_7b"]["drops"] == want_drops[m::n_model], (rank, want_drops)


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_decode_across_the_seam_equals_its_twin(runs, family, mesh):
    """Each decode step's logits (positions 62..65: rank 0's last slot, then
    rank 1's first) equal the single-device decode's twin bit for bit;
    whisper's cross-attention runs on each rank's 64 of the 128 frames."""
    ranks, want = runs(mesh)
    for r in ranks:
        steps = r[family]["decode"]
        assert len(steps) == STEPS
        for i, (got, tw) in enumerate(zip(steps, want[family]["decode"], strict=True)):
            assert torch.equal(got, tw), (i, float((got - tw).abs().max()))


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_collectives(runs, family, mesh):
    """The prefill gathers each attention layer's keys (whisper's encoder's
    and decoder's self-attention) and the last position's row over the batch
    axes; olmoe gathers each MoE layer's tokens too, whisper its encoder's
    output once. A decode step all-reduces each self- and cross-attention's
    row max and gathers its two partial sums. On (2, 2) the collectives
    over "model" come on top (whisper's prefill has none: pure
    data-parallel)."""
    ranks, _ = runs(mesh)
    cfg = get_arch(family).reduced()
    L = cfg.n_layers
    attn = L + (cfg.encoder_layers + 1 if cfg.family == "encdec" else 0)  # key gathers
    gathers = attn + (L if cfg.family == "moe" else 0) + 1
    decode_attn = 2 * L if cfg.family == "encdec" else L
    model_split = MESHES[mesh][0][1] > 1 and FAMILIES[family] is False
    for r in ranks:
        pre, dec = r[family]["counts"]["prefill"], r[family]["counts"]["decode"]
        if MESHES[mesh][0][1] > 1:
            assert dec.get("all_reduce", 0) >= decode_attn, dec
        if model_split:
            assert pre.get("all_gather", 0) > gathers, pre
            continue
        assert pre == {"all_gather": gathers}, pre
        if MESHES[mesh][0][1] == 1:
            assert dec == {"all_reduce": decode_attn, "all_gather": 2 * decode_attn}, dec


@pytest.mark.parametrize("family,mesh", CASES)
def test_seq_train_step_equals_the_one_process_step(runs, family, mesh):
    """The f32 step's gradients, as the sharded step hands its optimizer
    (averaged over the batch axes, summed over "model" where the spec does
    not shard the leaf), within 1e-4 relative L2 of the one-process step's
    at every leaf; the loss, the mean of the ranks' blocks' losses, equal
    to the one-process loss: the MoE's auxiliary loss enters once."""
    ranks, want = runs(mesh)
    w = want[family]
    for r in ranks:
        got = r[family]["train"]
        assert got["misplaced"] == {}
        assert abs(got["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (got["loss"], w["loss"])
        errs = {n: rel_l2(g, w["grads"][n]) for n, g in named_leaves(got["grads"])}
        assert errs.keys() == w["grads"].keys()
        assert max(errs.values()) <= GRAD_RTOL, sorted(errs.items(), key=lambda e: -e[1])[:3]


@pytest.mark.parametrize("n_batch", [2, 4, 16])
def test_whispers_frames_split_over_the_batch_ranks_or_are_refused(n_batch):
    """whisper-base's 1500 frames (and 448 tokens) at B = 1 on a spec-only
    mesh of ``n_batch`` batch ranks: on 2 and 4 they split, and the prefill
    and the serve step stop only at the mesh's missing process group; on
    16 the frames do not split (the tokens would), and both raise
    ``ValueError`` before any collective, as for any other sequence."""
    from repro_torch.train.steps import make_train_step

    model = build_model(get_arch("whisper_base"), max_pos=448, device="cpu")
    ctx = MeshCtx(AbstractMesh((n_batch, 1), ("data", "model")))
    audio = torch.zeros((B, 1500, model.cfg.d_model), dtype=torch.bfloat16)
    batch = {"audio_embeds": audio, "tokens": torch.zeros((B, 448), dtype=torch.int32)}
    cache = model.init_cache(B, 448)
    cache.update({k: torch.zeros((model.cfg.n_layers, B, 1500, model.cfg.n_kv_heads,
                                  model.cfg.hd), dtype=torch.bfloat16) for k in ("xk", "xv")})
    feed = {"token": torch.zeros((B,), dtype=torch.int32), "cur_len": 0}
    split = 1500 % n_batch == 0
    with pytest.raises(RuntimeError if split else ValueError,
                       match="AbstractMesh" if split else
                       f"audio frames of 1500 does not split over {n_batch} batch ranks"):
        make_prefill_step(model, ctx)({}, batch)
    with pytest.raises(RuntimeError if split else ValueError,
                       match="AbstractMesh" if split else
                       f"a cross cache of 1500 frames does not split over {n_batch}"):
        make_serve_step(model, ctx)({}, cache, feed)
    assert callable(make_train_step(model, ctx))
