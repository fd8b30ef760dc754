"""The port's training slice (reduced configs, on the CPU) against the reference.

Both packages start from the reference's parameters
(``init_params(PRNGKey(0))``, carried across with ``params_from_numpy``) and
the same ``SyntheticLM`` batch (B=2, S=64), and take one step of
``make_train_step(model, None)`` (``AdamWConfig()``: lr 3e-4), for every
family: dense (qwen2-0.5b, gemma3-1b), MoE (olmoe-1b-7b,
qwen3-moe-30b-a3b: the loss adds ``0.01 * aux``, through the backward of
the dispatch), SSM (mamba2-2.7b), hybrid (zamba2-7b: the backward of
``models/ssd.py`` and of the shared block), encoder-decoder (whisper-base:
the encoder's non-causal attention, the cross-attention and the GELU MLPs;
its unused ``wu`` gets zero gradients, as in jax) and VLM (qwen2-vl-7b:
M-RoPE and the reference's mask by the temporal positions' values). The
last two take the reference's ``make_inputs`` of a train step instead
(audio frames or embeddings and positions; seeds 0 and 1), and their 1-D
leaves (zero by the init rule) drawn from a seeded rng (std 0.1; whisper's
layer norms' weights about 1). Whisper's layer norms scale by w, not 1 + w:
from the init rule's zeros its encoder output and logits would be 0 and
only its final norm would learn.

The oracle is the reference's jitted step. XLA compiles it by default with
``xla_allow_excess_precision``, which lets a fusion skip the bf16 roundings
that the code writes between ops. The port, like the reference run op by op
(``jax.disable_jit``), rounds at every op. So each comparison is made twice:

- against the same jitted step compiled with ``xla_allow_excess_precision``
  off (``exact_jit``), at the tolerances below, on every config;
- against the default compile. On reduced gemma3-1b, olmoe, qwen3-moe and
  mamba2 that meets the same tolerances. On reduced qwen2-0.5b it does not,
  and it is as far from its own exact compile as from the port: its random
  QKV biases (std 1/sqrt(H) = 0.5) make the attention sharp, and the
  skipped roundings move the gradients by up to 9.5 % (relative L2; ``m``
  9.5 %, ``v`` 13.6 %; 3 of bq's 128 updated elements more than 1 ulp off).
  On reduced zamba2 the default compile is 104 % from its exact one in the
  gradients (``m`` 125 %, ``v`` 318 %, 86.4 % of the parameters within 1
  ulp): its sharp shared attention turns the skipped roundings into another
  step. The reference run op by op agrees with its exact compile to within
  1 % and with the port to the same degree. There the port is held to the
  default compile's own distance from the exact one, plus the tolerance.

Tolerances: the slice's acceptance criteria, in ``_torch_train_criteria``
(loss 2e-2 absolute; gradients and ``m`` 5e-2, ``v`` 1e-1 relative L2;
updated parameters within 1 bf16 ulp + 2 lr, and within 1 ulp on 98 % of
each leaf). Measured against the exact compile (loss; gradients, ``m``,
``v`` at most; parameters within 1 ulp): qwen2 5e-7; 9.6e-3, 9.6e-3,
2.0e-2; 99.96 %. gemma3 0; 1.4e-2, 1.4e-2, 1.7e-2; 99.93 %. olmoe 0;
1.4e-2, 1.4e-2, 1.9e-2; 99.94 %. qwen3-moe 1.0e-5; 1.3e-2, 1.3e-2,
2.3e-2; 99.93 %. mamba2 3.1e-5; 3.9e-3, 3.9e-3, 7.9e-3; 99.99 %. zamba2
2.8e-4; 3.1e-2, 3.1e-2, 3.7e-2; 99.64 %. whisper 9.5e-7; 4.3e-2, 4.2e-2,
6.5e-2; 99.91 % (the encoder's small gradients, which reach the loss only
through the cross-attention, sum terms that cancel: its default compile is
15.4 % from the exact one). qwen2-vl 4.8e-7; 1.3e-2, 1.2e-2, 1.8e-2;
99.96 % (like qwen2, its random QKV biases put the default compile 17.3 %
from the exact one). Both are held to the default compile's distance plus
the tolerance there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import layers as jax_layers
from repro.models import ssd as jax_ssd
from repro.models.lm import LM as JaxLM
from repro.models.registry import make_inputs as jax_make_inputs
from repro.train import compress as jax_compress
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.steps import make_train_step as jax_make_train_step
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
from repro_torch.train.steps import loss_and_grads, make_train_step, training_state_shapes
from repro_torch.tree import named_leaves

from _torch_encdec import norm_draw  # noqa: I001  (tests/ helper)
from _torch_train_criteria import (  # noqa: I001  (tests/ helper)
    GRAD_RTOL,
    LOSS_ATOL,
    assert_step_close,
    bf16_ulp,
    hold_step,
    meets,
    rel_l2,
    step_metrics,
    to_np,
)

EMBED_ARCHS = ["whisper_base", "qwen2_vl_7b"]  # batches of audio frames, patch embeddings
ARCHS = ["qwen2_0_5b", "gemma3_1b", "olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b", "zamba2_7b",
         *EMBED_ARCHS]
B, S = 2, 64
LR = AdamWConfig().lr


def exact_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


class TrainPair:
    """One reduced arch on both sides: the reference's parameters, one batch,
    the loss, gradients and one step of each package."""

    def __init__(self, arch: str):
        self.cfg = jax_get_arch(arch).reduced()
        jm = JaxLM(self.cfg)
        self.jm = jm
        self.jp = jm.init_params(jax.random.PRNGKey(0))
        if arch in EMBED_ARCHS:
            # the init rule's zero 1-D leaves perturbed, as in test_torch_models:
            # whisper's layer norms scale by w (not 1 + w), so from zeros its
            # encoder output and logits would be 0 and only the final norm learn
            self.jp = _perturb_1d(self.jp, np.random.default_rng(1), self.cfg.family == "encdec")
        self.np_params = jax.tree.map(np.asarray, self.jp)
        if arch in EMBED_ARCHS:
            # the reference's make_inputs of a B x S train step (audio frames and
            # tokens, or embeddings and M-RoPE positions drawn in [0, S); labels)
            self.batches = [{k: np.asarray(v) for k, v in jax_make_inputs(
                self.cfg, JaxShapeConfig("train", S, B, "train"), seed=i).items()}
                for i in range(2)]
        else:
            data = JaxSyntheticLM(JaxDataConfig(vocab=self.cfg.vocab, seq_len=S, global_batch=B))
            self.batches = [data.next_batch(), data.next_batch()]
        jb = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        vg = jax.value_and_grad(lambda p, b: jm.loss_fn(p, b))
        self.j_loss_exact, self.j_grads_exact = exact_jit(vg, self.jp, jb)
        self.j_loss, self.j_grads = jax.jit(vg)(self.jp, jb)
        step = jax_make_train_step(jm, None)
        o0 = jax_adamw_init(self.jp)
        self.j_step_exact = exact_jit(step, self.jp, o0, jb)
        self.j_step = jax.jit(step)(self.jp, o0, jb)

        self.tm = build_model(get_arch(arch).reduced(), device="cpu")
        self.tp = params_from_numpy(self.np_params)
        tb = self.torch_batch(0)
        self.t_loss, self.t_grads = loss_and_grads(self.tm, self.tp, tb)
        self.t_step = make_train_step(self.tm)(self.tp, adamw_init(self.tp), tb)

    def torch_batch(self, i: int) -> dict:
        return {k: tensor_from_numpy(v) for k, v in self.batches[i].items()}


def _perturb_1d(tree, rng, one: bool = False):
    """The 1-D leaves drawn from ``rng``: std 0.1 about 0, or with ``one``
    about 1 for the layer norms' weights (``*_ln``: a layer norm's usual
    start is weight 1, bias 0)."""
    return {k: _perturb_1d(v, rng, one) if isinstance(v, dict)
            else jnp.asarray(norm_draw(rng, v.shape, one and k.endswith("ln")), v.dtype)
            if v.ndim == 1 else v
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request) -> TrainPair:
    return TrainPair(request.param)


def _default_is_exact(pair: TrainPair) -> bool:
    """Whether the default compile meets the criteria against the exact one
    (gemma3: yes; qwen2: no, see the module's docstring)."""
    return meets(step_metrics(*_np_step(pair.j_step_exact), *_np_step(pair.j_step), LR))


def _np_step(step):
    p, o = step[0], step[1]
    if isinstance(next(iter(jax.tree.leaves(p))), torch.Tensor):
        return to_np(p), to_np(o)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p), jax.tree.map(np.asarray, o)


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

        def ce(self, *a):
            ces.append(real_ce(self, *a))
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
                        lambda self, p, h, labels: real_ce(self, p, h[:, :-1], labels[:, :-1]))
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
                        lambda p, h: real({**p, "final_ln": p["final_ln"].detach()}, h))
    with pytest.raises(RuntimeError, match="final_ln"):
        loss_and_grads(model, params, batch)


def test_loss_matches_reference(pair):
    assert pair.t_loss.dtype == torch.float32 and pair.t_loss.shape == ()
    assert abs(float(pair.t_loss) - float(pair.j_loss_exact)) <= LOSS_ATOL
    assert abs(float(pair.t_loss) - float(pair.j_loss)) <= LOSS_ATOL


def test_grads_match_reference(pair):
    want_exact = dict(named_leaves(jax.tree.map(np.asarray, pair.j_grads_exact)))
    want = dict(named_leaves(jax.tree.map(np.asarray, pair.j_grads)))
    got = dict(named_leaves(pair.t_grads))
    assert got.keys() == want.keys()
    exact = _default_is_exact(pair)
    for name, g in got.items():
        assert g.dtype == dict(named_leaves(pair.tp))[name].dtype
        assert g.shape == want[name].shape
        g = g.float().numpy()
        assert rel_l2(g, want_exact[name]) <= GRAD_RTOL, name
        floor = 0.0 if exact else rel_l2(want_exact[name], want[name])
        assert rel_l2(g, want[name]) <= floor + GRAD_RTOL, name


def test_train_step_matches_reference(pair):
    tp, to, tl = pair.t_step
    assert abs(float(tl) - float(pair.j_step_exact[2])) <= LOSS_ATOL
    assert int(to["step"]) == int(pair.j_step[1]["step"]) == 1 and to["step"].dtype == torch.int32
    for name, value in named_leaves(tp):
        assert value.dtype == dict(named_leaves(pair.tp))[name].dtype
    got = _np_step((tp, to))
    assert_step_close(step_metrics(*got, *_np_step(pair.j_step_exact), LR))
    floor = None if _default_is_exact(pair) else step_metrics(
        *_np_step(pair.j_step_exact), *_np_step(pair.j_step), LR)
    assert_step_close(step_metrics(*got, *_np_step(pair.j_step), LR), floor)


def test_second_step_from_the_carried_state(pair, monkeypatch):
    """The reference's state after its (exact) first step carried across
    bit for bit (f32 moments, int32 step, bf16 and f32 parameters), then a
    second step on both sides with the next batch, where Adam's update is no
    longer a sign: the same criteria against the exact compile, but for the
    1-ulp share, taken over all parameters (measured 0.9997 on both).
    Leaf by leaf it can fall short on a small leaf: an element whose first
    two gradients nearly cancel in ``m`` moves by a different fraction of lr
    (2 of reduced qwen2's 64 ``bk`` elements, within 0.37 of ulp + 2 lr).

    Where the model has an SSD (mamba2, zamba2), the reference's own exact
    step with every SSD output moved one f32 ulp up, or down
    (``_ssd_nudged_step``), decides how the step is held (``hold_step``,
    the policy the card's checks keep): that flips a few bf16 roundings, as
    any other correct order of the SSD's f32 sums does. Here the step must
    be held. At these parameters reduced zamba2 is ill-conditioned: its
    shared attention is sharp, and the nudge up moves the reference's ``m``
    by up to 16.4 % (``shared.ln2``; ``v`` 20.2 %: 3.27 tolerances, within
    the cap of 4), the port's step is 16.6 % from it (``v`` 16.6 %), held
    to the criteria widened by that distance. mamba2: the nudge down moves
    ``m`` by 0.25 %, within the criteria, so they are not widened."""
    jp1, jo1, _ = pair.j_step_exact
    np_p, np_o = jax.tree.map(np.asarray, jp1), jax.tree.map(np.asarray, jo1)
    tp1, to1 = params_from_numpy(np_p), params_from_numpy(np_o)
    assert to1["step"].dtype == torch.int32 and to1["step"].shape == () and int(to1["step"]) == 1
    for tree, src in ((tp1, np_p), (to1["m"], np_o["m"]), (to1["v"], np_o["v"])):
        for name, value in named_leaves(tree):
            arr = dict(named_leaves(src))[name]
            assert value.dtype in (torch.float32, torch.bfloat16)
            np.testing.assert_array_equal(value.view(torch.int16 if value.dtype == torch.bfloat16
                                                     else torch.int32).numpy(),
                                          arr.view(np.int16 if value.dtype == torch.bfloat16
                                                   else np.int32))
    jb = {k: jnp.asarray(v) for k, v in pair.batches[1].items()}
    want = exact_jit(jax_make_train_step(pair.jm, None), jp1, jo1, jb)
    got = make_train_step(pair.tm)(tp1, to1, pair.torch_batch(1))
    assert abs(float(got[2]) - float(want[2])) <= LOSS_ATOL
    assert int(got[1]["step"]) == 2
    nudged = [(step_metrics(*_np_step(_ssd_nudged_step(pair, (jp1, jo1, jb), to, monkeypatch)),
                            *_np_step(want), LR), None)
              for to in ((np.inf, -np.inf) if pair.cfg.is_ssm else ())]
    held, verdict, failures = hold_step(step_metrics(*_np_step(got), *_np_step(want), LR),
                                        nudged=nudged, pooled=True)
    assert held and not failures, (verdict, failures)


def _ssd_nudged_step(pair: TrainPair, args: tuple, to: float, monkeypatch):
    """The reference's exact step with every ``_ssd_chunked`` output moved
    one f32 ulp toward ``to`` (the gradient passes through unchanged)."""
    real = jax_ssd._ssd_chunked

    def nudged(*a, **kw):
        y = real(*a, **kw)
        ys = jax.lax.stop_gradient(y)
        return y + (jnp.nextafter(ys, jnp.asarray(to, y.dtype)) - ys)

    with monkeypatch.context() as m:
        m.setattr(jax_ssd, "_ssd_chunked", nudged)
        return exact_jit(jax_make_train_step(pair.jm, None), *args)


def test_train_step_leaves_the_served_parameters_alone():
    """Parameters registered for serving (``load_params``: frozen) are not
    modified, and stay frozen, by a train step."""
    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(0)))
    before = {n: v.clone() for n, v in named_leaves(params)}
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab=model.cfg.vocab, seq_len=32, global_batch=2)).next_batch().items()}
    new, opt, loss = make_train_step(model)(params, adamw_init(params), batch)
    for name, value in named_leaves(params):
        assert not value.requires_grad and torch.equal(value, before[name])
    assert not any(torch.equal(v, before[n]) for n, v in named_leaves(new) if v.ndim >= 2)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "zamba2_7b"])
def test_train_loop_reduces_loss(arch):
    """12 steps at lr 2e-3 on the reduced config (the reference's
    ``test_train_loop_reduces_loss``, which trains qwen2, olmoe and
    mamba2): finite losses, the last four below the first four on average."""
    model = build_model(get_arch(arch).reduced(), max_pos=64, device="cpu")
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=64, global_batch=4, seed=0))
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=2e-3))
    losses = []
    for _ in range(12):
        batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert int(opt["step"]) == 12


# ------------------------------------------------------------- launcher
DRIVER_ARGS = ["--arch", "qwen2_0_5b", "--steps", "12", "--ckpt-every", "5", "--crash-at", "8",
               "--kill-hosts", "1", "--ckpt-hosts", "6", "--ckpt-parity", "2", "--batch", "2",
               "--seq", "32"]


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b", "zamba2_7b"])
def test_train_driver_crash_restore_is_bit_for_bit(monkeypatch, arch):
    """The reference test's driver run (crash at 8, one host down, restore
    from the step-5 checkpoint) on the port, for the dense, MoE and hybrid
    families: two saves at least; the restored state equals the saved one
    bit for bit (parameters, AdamW state, data state); the replayed steps
    6-8 repeat their losses bit for bit (the MoE recompute routes as its
    forward did)."""
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import ECCheckpointStore

    saved, restored = {}, []
    real_save, real_restore = ECCheckpointStore.save, ECCheckpointStore.restore

    def save(self, step, state, *a, **kw):
        saved[step] = {"params": {n: v.clone() for n, v in named_leaves(state["params"])},
                       "opt": {n: v.clone() for n, v in named_leaves(state["opt"])},
                       "data": dict(state["data"])}
        return real_save(self, step, state, *a, **kw)

    def restore(self, *a, **kw):
        out = real_restore(self, *a, **kw)
        restored.append(out)
        return out

    monkeypatch.setattr(ECCheckpointStore, "save", save)
    monkeypatch.setattr(ECCheckpointStore, "restore", restore)
    args = list(DRIVER_ARGS)
    args[args.index("--arch") + 1] = arch
    out = train.main(args + ["--device", "cpu"])
    assert len(out["ckpts"]) >= 2 and all(st.success for st in out["ckpts"])
    assert [st.step for st in out["ckpts"]] == [5, 10]
    losses = out["losses"]
    assert len(losses) == 8 + 7 and all(np.isfinite(losses))
    assert losses[5:8] == losses[8:11]  # steps 6-8, before the crash and replayed
    (step, state), = restored
    want = saved[step]
    assert step == 5
    for part in ("params", "opt"):
        got = dict(named_leaves(state[part]))
        assert got.keys() == want[part].keys()
        for name, value in want[part].items():
            assert got[name].dtype == value.dtype and torch.equal(got[name], value), name
    assert {k: int(v) for k, v in state["data"].items()} == want["data"] == {"seed": 0, "step": 5}
    assert state["opt"]["step"].dtype == torch.int32


def test_train_driver_matches_reference_driver():
    """The port's driver started from the reference driver's parameters
    against the reference driver (``repro.launch.train.main``), same flags:
    the same checkpoint steps and successes; the first loss within 2e-2
    (measured 9.9e-4); every loss within 5e-2 (measured at most 0.0231: over
    12 AdamW steps at lr 1e-3 the runs drift apart, since each element
    whose gradient sign differs moves 2 lr the other way)."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    want = jax_main(list(DRIVER_ARGS))
    cfg = jax_get_arch("qwen2_0_5b").reduced()
    params = params_from_numpy(jax.tree.map(
        np.asarray, JaxLM(cfg, max_pos=32).init_params(jax.random.PRNGKey(0))))
    got = main(DRIVER_ARGS + ["--device", "cpu"], params=params)
    assert [(s.step, s.success) for s in got["ckpts"]] == [(s.step, s.success)
                                                           for s in want["ckpts"]]
    assert len(got["losses"]) == len(want["losses"])
    assert abs(got["losses"][0] - want["losses"][0]) <= 2e-2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=5e-2)


def test_train_driver_with_compressed_grads():
    """``--compress-grads`` (error-feedback int8): finite losses that fall,
    within 5e-2 of the reference driver's with the same flag and weights."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    args = ["--arch", "qwen2_0_5b", "--steps", "8", "--ckpt-every", "4", "--batch", "2",
            "--seq", "32", "--compress-grads"]
    want = jax_main(list(args))
    cfg = jax_get_arch("qwen2_0_5b").reduced()
    params = params_from_numpy(jax.tree.map(
        np.asarray, JaxLM(cfg, max_pos=32).init_params(jax.random.PRNGKey(0))))
    got = main(args + ["--device", "cpu"], params=params)
    assert all(np.isfinite(got["losses"])) and len(got["ckpts"]) == 2
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_train_driver_refuses_the_embedding_families(arch):
    """The launcher's data source (``SyntheticLM``, as the reference's)
    makes only tokens: it refuses whisper and qwen2-vl, whose batches hold
    audio frames or patch embeddings, with a clear error, before it builds
    anything."""
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="make_train_step"):
        main(["--arch", arch, "--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embedding_families_train_through_make_train_step(arch):
    """What the launcher refuses trains through ``make_train_step``: 12 steps
    at lr 2e-3 alternating two ``make_inputs`` batches on the reduced
    config, from ``init_params``: finite losses, the last four below the
    first four on average."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.registry import make_inputs

    model = build_model(get_arch(arch).reduced(), max_pos=64, device="cpu")
    shape = ShapeConfig("train", 64, 4, "train")
    batches = [make_inputs(model.cfg, shape, seed=i, device="cpu") for i in range(2)]
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=2e-3))
    losses = []
    for i in range(12):
        params, opt, loss = step(params, opt, batches[i % 2])
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


def test_train_driver_defaults_to_the_card():
    from repro_torch.launch.train import main

    args = ["--arch", "qwen2_0_5b", "--steps", "1", "--ckpt-every", "0"]
    if torch.cuda.is_available():
        assert np.isfinite(main(args)["losses"]).all()
    else:
        with pytest.raises(RuntimeError):
            main(args)

