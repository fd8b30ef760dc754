"""The port's training slice (reduced configs, on the CPU) against the reference,
piece by piece: AdamW and its clipping, decay and rounding order, the
state's shapes and tree order, the f32 config, the MoE loss and route
replay, ``hold_step``'s policy, the hybrid's training attention,
gradient compression, the chunked attention and the refusal of a leaf cut
off from the loss. The whole step of each family against the reference's
is ``test_torch_train_pair*.py`` (``_torch_train_pair``); several steps
and the launcher are ``test_torch_train_loop.py`` and
``test_torch_train_driver.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.train import compress as jax_compress
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.steps import training_state_shapes as jax_training_state_shapes
from repro_torch.configs import get_arch
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train import compress
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.train.steps import loss_and_grads, training_state_shapes
from repro_torch.tree import named_leaves

from _torch_train_pair import B, EMBED_ARCHS, S  # noqa: I001  (tests/ helper)
from _torch_train_criteria import (  # noqa: I001  (tests/ helper)
    LOSS_ATOL,
    bf16_ulp,
    rel_l2,
)


# ------------------------------------------------------------- optimizer
def test_adamw_matches_reference_math():
    """The reference test's toy problem on both packages: equal within rtol
    1e-6, and the hand-rolled AdamW within 1e-5."""
    cfg = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, grad_clip=1e9)
    p = np.asarray([[1.0, -2.0]], np.float32)
    g = np.asarray([[0.5, 0.5]], np.float32)
    jp, jst = jax_adamw_update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)},
                               jax_adamw_init({"w": jnp.asarray(p)}), JaxAdamWConfig(**cfg))
    tp, tst = adamw_update({"w": torch.from_numpy(p)}, {"w": torch.from_numpy(g)},
                           adamw_init({"w": torch.from_numpy(p)}), AdamWConfig(**cfg))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)
    for k in ("m", "v"):
        np.testing.assert_allclose(tst[k]["w"].numpy(), np.asarray(jst[k]["w"]), rtol=1e-6)
    mh, vh = 0.1 * 0.5 / (1 - 0.9), 0.01 * 0.25 / (1 - 0.99)
    np.testing.assert_allclose(tp["w"].numpy()[0, 0], 1.0 - 0.1 * mh / (np.sqrt(vh) + 1e-8),
                               rtol=1e-5)
    assert tst["step"].dtype == torch.int32 and tst["step"].shape == () and int(tst["step"]) == 1


def test_grad_clip_bounds_update():
    """A gradient of 1e6 clipped to norm 1e-3 (lr 1, no decay): finite, and
    equal to the reference's within rtol 1e-6."""
    cfg = dict(lr=1.0, weight_decay=0.0, grad_clip=0.001)
    p = np.ones((4,), np.float32)
    g = np.full((4,), 1e6, np.float32)
    jp, _ = jax_adamw_update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)},
                             jax_adamw_init({"w": jnp.asarray(p)}), JaxAdamWConfig(**cfg))
    tp, _ = adamw_update({"w": torch.from_numpy(p)}, {"w": torch.from_numpy(g)},
                         adamw_init({"w": torch.from_numpy(p)}), AdamWConfig(**cfg))
    assert torch.isfinite(tp["w"]).all()
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)


def test_adamw_decays_by_rank_and_keeps_the_rounding_order():
    """Three steps on a tree of bf16 and f32 leaves (a stacked (L, D) norm is
    decayed, a (D,) one is not), with the weight decay large enough to show:
    the moments within 1e-6 of the reference's, relative to each leaf's
    largest (m's running sums cancel, and the clip's norm sums the leaves in
    another order), the parameters within 1 ulp of their dtype (the
    reference's XLA may fuse the last rounding), the step equal."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, weight_decay=5.0)
    tree = {"ln": rng.standard_normal((2, 8)).astype(np.float32),
            "final_ln": rng.standard_normal(8).astype(np.float32),
            "w": np.asarray(jnp.asarray(rng.standard_normal((8, 16)), jnp.bfloat16))}
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jax_adamw_init(jp)
    tp = params_from_numpy(tree)
    tst = adamw_init(tp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
        jp, jst = jax_adamw_update(jp, jax.tree.map(jnp.asarray, g), jst, JaxAdamWConfig(**cfg))
        tp, tst = adamw_update(tp, params_from_numpy(g), tst, AdamWConfig(**cfg))
    for k in tree:
        want = np.asarray(jp[k], np.float32)
        got = tp[k].float().numpy()
        ulp = bf16_ulp(want) if tree[k].dtype.name == "bfloat16" else np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= ulp), k
        for name in ("m", "v"):
            want_m = np.asarray(jst[name][k])
            np.testing.assert_allclose(tst[name][k].numpy(), want_m, rtol=1e-6,
                                       atol=1e-6 * np.abs(want_m).max())
    assert int(tst["step"]) == int(jst["step"]) == 3
    # the decay rule itself: with a zero gradient only the decay moves a leaf
    zero = {k: np.zeros(v.shape, np.float32) for k, v in tree.items()}
    p1, _ = adamw_update(params_from_numpy(tree), params_from_numpy(zero),
                         adamw_init(params_from_numpy(tree)), AdamWConfig(**cfg))
    assert torch.equal(p1["final_ln"], torch.from_numpy(tree["final_ln"]))
    assert torch.allclose(p1["ln"], torch.from_numpy(tree["ln"]) * (1 - 1e-2 * 5.0))


@pytest.mark.parametrize("arch", ["gemma3_1b", "olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "zamba2_7b", *EMBED_ARCHS])
def test_training_state_shapes_match_reference(arch):
    cfg = jax_get_arch(arch).reduced()
    jps, jos = jax_training_state_shapes(JaxLM(cfg))
    tps, tos = training_state_shapes(build_model(get_arch(arch).reduced(), device="cpu"))
    as_pair = lambda sd: (tuple(sd.shape), jnp.dtype(sd.dtype).name)  # noqa: E731
    want = jax.tree.map(as_pair, jos)
    got = {k: ({n: (s, str(d).removeprefix("torch.")) for n, (s, d) in named_leaves(v)}
               if isinstance(v, dict) else (v[0], str(v[1]).removeprefix("torch.")))
           for k, v in tos.items()}
    assert got["step"] == want["step"] == ((), "int32")
    for k in ("m", "v"):
        assert got[k] == dict(named_leaves(want[k]))
        assert {n: s for n, (s, _) in got[k].items()} == {n: tuple(sd.shape)
                                                         for n, sd in named_leaves(jps)}


def test_tree_order_matches_jax_flattening():
    """``repro_torch.tree`` walks a parameter tree in ``jax.tree``'s order:
    the names and the leaves come out as jax flattens the same tree, and
    ``tree_map`` keeps the structure."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_arch("qwen2_0_5b").reduced()
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(params)
    assert [name for name, _ in named_leaves(params)] == [
        ".".join(k.key for k in path) for path, _ in paths]
    assert all(a is b for a, b in zip(tree_leaves(params), jax.tree.leaves(params)))
    shapes = tree_map(lambda t, u: (t.shape, u.dtype), params, params)
    assert jax.tree.structure(shapes, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.structure(params)


def test_float32_config_computes_the_step_in_f32(monkeypatch):
    """A ``dtype="float32"`` configuration (chip_smoke's precise witness)
    runs the whole step in f32: the embedding's output and the score chain
    too, while a bf16 configuration keeps the reference's bf16 chain. From
    the same (upcast) weights its loss is within the loss criterion (2e-2)
    of the bf16 step's, and its gradients are f32."""
    import dataclasses

    import repro_torch.models.lm as lm
    from repro_torch.tree import tree_leaves, tree_map

    seen = []
    real = lm.gqa_attention

    def spy(*a, **k):
        seen.append((a[0].dtype, k["score_dtype"]))
        return real(*a, **k)

    monkeypatch.setattr(lm, "gqa_attention", spy)
    cfg = get_arch("qwen2_0_5b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)).next_batch().items()}
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    loss, _ = loss_and_grads(build_model(cfg, device="cpu"), params, batch)
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}
    seen.clear()
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    loss32, grads = loss_and_grads(f32, tree_map(lambda p: p.float(), params), batch)
    assert set(seen) == {(torch.float32, torch.float32)}
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert abs(float(loss32) - float(loss)) <= LOSS_ATOL


def test_moe_loss_adds_the_layers_aux():
    """The MoE loss is ``ce + 0.01 * aux`` with aux the layers' ``moe_layer``
    auxiliary losses added in layer order (the reference's f32 carry), equal
    bit for bit; the dense loss is the cross-entropy alone."""
    import repro_torch.models.lm as lm

    for arch in ("olmoe_1b_7b", "qwen2_0_5b"):
        model = build_model(get_arch(arch).reduced(), device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
            vocab=model.cfg.vocab, seq_len=32, global_batch=2)).next_batch().items()}
        auxes, ces = [], []
        real_moe, real_ce = lm.moe_layer, lm.LM._cross_entropy

        def moe(*a, **k):
            y, aux = real_moe(*a, **k)
            auxes.append(aux)
            return y, aux

        def ce(self, *a, **k):
            ces.append(real_ce(self, *a, **k))
            return ces[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lm, "moe_layer", moe)
            mp.setattr(lm.LM, "_cross_entropy", ce)
            with torch.no_grad():
                loss = model.loss_fn(params, batch)
        (want,) = ces
        if model.cfg.family == "moe":
            assert len(auxes) == model.cfg.n_layers == 2 and all(float(a) > 0 for a in auxes)
            want = want + 0.01 * (auxes[0] + auxes[1])
        else:
            assert auxes == []
        assert loss.dtype == torch.float32 and torch.equal(loss, want), arch


def test_route_replay_routes_as_the_recorded_run():
    """``RouteReplay`` (the card's checks hold a step on the card's routes
    against the CPU's step on the same routes): replaying a run's own
    routes repeats its loss and gradients bit for bit; replaying routes with
    one token's experts changed in the first layer routes that token so in
    the forward and in the backward's recompute, and changes the gradients."""
    from _torch_moe_criteria import RouteLog, RouteReplay

    model = build_model(get_arch("olmoe_1b_7b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab=model.cfg.vocab, seq_len=32, global_batch=2)).next_batch().items()}
    with RouteLog() as own:
        loss, grads = loss_and_grads(model, params, batch)
    L, K = model.cfg.n_layers, model.cfg.moe_top_k
    assert len(own.calls) == 2 * L  # the forward, then the recompute from the last layer
    with RouteReplay(own.calls), RouteLog() as again:
        loss2, grads2 = loss_and_grads(model, params, batch)
    assert torch.equal(loss, loss2)
    for name, g in named_leaves(grads):
        assert torch.equal(g, dict(named_leaves(grads2))[name]), name
    for a, b in zip(own.calls, again.calls):
        assert all(np.array_equal(a[k], b[k]) for k in ("probs", "routed", "kept"))

    changed = [dict(c) for c in own.calls]
    row = changed[0]["routed"][5].copy()
    row[np.flatnonzero(row)[0]] = False  # swap one of token 5's experts for an unused one
    row[np.flatnonzero(~row)[0]] = True
    assert row.sum() == K and not np.array_equal(row, changed[0]["routed"][5])
    for i in (0, 2 * L - 1):  # layer 0's forward and its recompute
        changed[i]["routed"] = changed[i]["routed"].copy()
        changed[i]["routed"][5] = row
    with RouteReplay(changed), RouteLog() as swapped:
        _, grads3 = loss_and_grads(model, params, batch)
    for i in (0, 2 * L - 1):
        assert np.array_equal(swapped.calls[i]["routed"][5], row)
    assert not torch.equal(grads["embed"], grads3["embed"])


def test_hold_step_policy():
    """The one policy for an ill-conditioned step (``hold_step``): held to
    the criteria where every SSD-nudged step meets them; held to the
    criteria widened by the nudge's distance where it misses them by at most
    NUDGE_CAP tolerances; not held past that."""
    import _torch_train_criteria as crit

    def metrics(m, share=1.0):
        return {"w": {"m": m, "v": m, "share": share, "within": int(100 * share), "size": 100,
                      "ratio": 0.5}}

    got, grads = metrics(0.12), {"w": 0.12}
    held, verdict, failures = crit.hold_step(metrics(0.01), {"w": 0.01})
    assert held and verdict == "held" and not failures
    held, verdict, failures = crit.hold_step(got, grads, [(metrics(1e-4), {"w": 1e-4})])
    assert held and verdict == "held" and len(failures) == 2  # gradient and m beyond 5e-2
    near = [(metrics(1e-4), {"w": 1e-4}), (metrics(0.1), {"w": 0.1})]
    held, verdict, failures = crit.hold_step(got, grads, near)
    assert held and verdict.startswith("held, widened") and not failures
    far = [(metrics(0.25), {"w": 0.25})]  # 5 tolerances of m and of the gradient
    held, verdict, failures = crit.hold_step(got, grads, far)
    assert not held and verdict.startswith("ill-conditioned, not held") and not failures


def test_hybrid_training_attention_does_not_see_the_future(monkeypatch):
    """The loss of the first S-1 positions of reduced zamba2 (its shared
    block's attention in training: ``gqa_attention``, causal, no window),
    and its gradients, are equal bit for bit whatever the last token is.
    Passing the flash kernel's "no window" (0) to ``gqa_attention`` would
    mask every key and let every position attend to all of them, the last
    one included."""
    import repro_torch.models.lm as lm

    model = build_model(get_arch("zamba2_7b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab=model.cfg.vocab, seq_len=S, global_batch=B)).next_batch().items()}
    real_ce = lm.LM._cross_entropy
    monkeypatch.setattr(lm.LM, "_cross_entropy",
                        lambda self, p, h, labels, ctx=None, **k: real_ce(
                            self, p, h[:, :-1], labels[:, :-1], ctx, **k))
    seen = []
    for last in (0, 1):
        tokens = batch["tokens"].clone()
        tokens[:, -1] = (tokens[:, -1] + last) % model.cfg.vocab
        seen.append(loss_and_grads(model, params, {"tokens": tokens, "labels": batch["labels"]}))
    (l0, g0), (l1, g1) = seen
    assert torch.equal(l0, l1)
    for (name, a), (_, b) in zip(named_leaves(g0), named_leaves(g1)):
        assert torch.equal(a, b), name


# ------------------------------------------------------------- compression
def test_compress_matches_reference():
    """Seeded f32 gradients with a carried residual, leaf by leaf and as a
    tree: int8 q equal, scale and residual within 1 f32 ulp, the
    decompressed gradient in the leaf's dtype equal."""
    rng = np.random.default_rng(1)
    grads = {"a": (rng.standard_normal((16, 32)) * 1e-3).astype(np.float32),
             "b": {"c": rng.standard_normal(64).astype(np.float32),
                   # scale 1: the halves round to even
                   "d": np.asarray([127.0, 2.5, 3.5, -0.5, 0.5, -1.5], np.float32)}}
    res = {"a": (rng.standard_normal((16, 32)) * 1e-5).astype(np.float32),
           "b": {"c": np.zeros(64, np.float32), "d": np.zeros(6, np.float32)}}
    jq, js, jr = jax_compress.compress_tree(jax.tree.map(jnp.asarray, grads),
                                            jax.tree.map(jnp.asarray, res))
    tq, ts, tr = compress.compress_tree(params_from_numpy(grads), params_from_numpy(res))
    for name, want in named_leaves(jax.tree.map(np.asarray, jq)):
        got = dict(named_leaves(tq))[name]
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    for mine, ref in ((ts, js), (tr, jr)):
        for name, want in named_leaves(jax.tree.map(np.asarray, ref)):
            got = dict(named_leaves(mine))[name].numpy()
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32))), name
    back = compress.decompress_tree(tq, ts, params_from_numpy(grads))
    jback = jax_compress.decompress_tree(jq, js, jax.tree.map(jnp.asarray, grads))
    for name, want in named_leaves(jax.tree.map(np.asarray, jback)):
        np.testing.assert_allclose(dict(named_leaves(back))[name].numpy(), want, rtol=2e-7)
    assert compress.compressed_bytes(params_from_numpy(grads)) == \
        jax_compress.compressed_bytes(jax.tree.map(jnp.asarray, grads))
    q, scale, r = compress.compress_leaf(torch.from_numpy(grads["a"]))
    jq1, js1, jr1 = jax_compress.compress_leaf(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq1))
    assert abs(float(scale) - float(js1)) <= np.spacing(np.float32(js1))


# ------------------------------------------------------------- attention
def test_gqa_attention_q_chunk_equals_unchunked():
    """Sq = 64 in chunks of 16 (each under ``torch.utils.checkpoint``)
    against one chunk, forward and backward, on gemma3's sliding window:
    the output equal (rows are independent), the gradients within 1e-2
    relative L2 (dk and dv sum over the chunks in another order, in bf16)."""
    rng = np.random.default_rng(5)
    H, KV, hd = 4, 1, 16
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16))
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]
    pos = torch.arange(S, dtype=torch.int32)
    seen = []
    for q_chunk in (S, 16):
        q, k, v = (tensor_from_numpy(a).requires_grad_() for a in arrs[:3])
        out = layers.gqa_attention(q, k, v, q_pos=pos, k_pos=pos, window=32, q_chunk=q_chunk)
        seen.append((out.detach(), torch.autograd.grad(out, (q, k, v), tensor_from_numpy(arrs[3]))))
    (o1, g1), (o2, g2) = seen
    assert torch.equal(o1, o2)
    for a, b in zip(g2, g1):
        assert rel_l2(a.float().numpy(), b.float().numpy()) <= 1e-2
    # and the chunked form against the reference's own (q_chunk 16, under its remat)
    want = jax_layers.gqa_attention(*(jnp.asarray(a) for a in arrs[:3]), q_pos=jnp.asarray(pos),
                                    k_pos=jnp.asarray(pos), window=32, q_chunk=16)
    np.testing.assert_allclose(o2.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=2.0**-6)
    with pytest.raises(ValueError):
        layers.gqa_attention(*(tensor_from_numpy(a) for a in arrs[:3]), q_pos=pos, k_pos=pos,
                             q_chunk=24)


# ------------------------------------------------------------- loss, step
def test_loss_and_grads_refuses_a_leaf_cut_off_from_the_loss(monkeypatch):
    """A leaf outside ``LM.unread_leaves()`` that gets no gradient (here
    reduced qwen2's ``final_ln``, detached inside the head: a bug that cuts
    it off from the loss) makes ``loss_and_grads`` raise, rather than train
    it on zeros; the expected set is empty but for whisper's ``wu``."""
    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cpu")
    assert model.unread_leaves() == set()
    assert build_model(get_arch("whisper_base").reduced(), device="cpu").unread_leaves() == {
        "dec.wu", "enc.wu"}
    params = model.init_params(torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=16, global_batch=1))
    batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
    real = model._head
    monkeypatch.setattr(model, "_head",
                        lambda p, h, tp=None: real({**p, "final_ln": p["final_ln"].detach()}, h,
                                                   tp))
    with pytest.raises(RuntimeError, match="final_ln"):
        loss_and_grads(model, params, batch)
