"""The port's dense LM (reduced configs, on the CPU) against the reference.

The reference's parameters (``init_params(PRNGKey(0))``, with the 1-D norm
weight ``final_ln`` perturbed by a seeded rng so that it is not all zero)
are carried across with ``params_from_numpy``; both sides then see the same
weights and the same seeded tokens.

Tolerances. Logits are bf16 products rounded to bf16, of magnitude up to
~3.3 here, so one bf16 ulp is 2**-6 at most; the two frameworks round
the bf16 projections after sums taken in another order, and XLA may skip
intermediate bf16 roundings inside a fusion. LOGIT_ATOL = 4 ulps at that
magnitude (the largest difference seen is 0.045 on qwen2 decode).

What is compared with what:
- decode: both sides attend with ``gqa_attention`` (bf16 score chain);
- prefill: the port attends with the flash kernel's plain version (f32
  scores), so the reference's prefill body runs with its ``gqa_attention``
  swapped, in this test only, for its own ``flash_attention_ref``;
- one unswapped comparison (qwen3) bounds how far the two attentions drift.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jax_lm
from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.models.registry import make_inputs as jax_make_inputs
from repro_torch.configs import SHAPES, get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.train.steps import make_prefill_step

ARCHS = ["qwen2_0_5b", "qwen3_0_6b", "gemma3_1b", "chatglm3_6b"]
LOGIT_ATOL = 4 * 2.0**-6
B, S = 2, 64


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else (rng.standard_normal(v.shape) * 0.1).astype(np.float32) if v.ndim == 1
            else np.asarray(v)
            for k, v in tree.items()}


class Pair:
    """One reduced arch on both sides, with the same weights."""

    def __init__(self, arch: str):
        self.cfg = jax_get_arch(arch).reduced()
        self.jm = JaxLM(self.cfg)
        np_params = _perturb(jax.tree.map(np.asarray, self.jm.init_params(jax.random.PRNGKey(0))),
                             np.random.default_rng(1))
        self.jp = jax.tree.map(jnp.asarray, np_params)
        self.tm = build_model(get_arch(arch).reduced(), device="cpu")
        self.tp = self.tm.load_params(params_from_numpy(np_params))
        self.tokens = np.random.default_rng(2).integers(0, self.cfg.vocab, (B, S), dtype=np.int32)

    def jax_prefill(self, swap_attention: bool) -> np.ndarray:
        """The body of the reference's ``make_prefill_step`` with ``ctx=None``
        (its mesh form does not run on this JAX: see ROADMAP C)."""
        jm, sw = self.jm, self.cfg.sliding_window

        def attention(q, k, v, *, q_pos, k_pos, causal=True, window=None, ctx=None, **_):
            G = q.shape[2] // k.shape[2]
            qh, kh, vh = (x.transpose(0, 2, 1, 3) for x in
                          (q, jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2)))

            def ref(w):
                return jax_flash_ref(qh, kh, vh, causal=causal, window=w).transpose(0, 2, 1, 3)
            # the window is traced (the stack is a scan): it is S + 1 (no
            # limit under the causal mask) or the arch's sliding window
            return ref(0) if not sw else jax.lax.cond(window == sw, lambda: ref(sw),
                                                      lambda: ref(0))

        def body(params, tokens):
            h = params["embed"][tokens].astype(jnp.bfloat16)
            positions = jnp.arange(S, dtype=jnp.int32)[None].repeat(B, 0)
            h, _ = jm._run_decoder_stack(params, h, positions=positions, ctx=None)
            return jm._head(params, h[:, -1:])[:, 0].astype(jnp.float32)

        orig = jax_lm.gqa_attention
        jax_lm.gqa_attention = attention if swap_attention else orig
        try:
            return np.asarray(jax.jit(body)(self.jp, jnp.asarray(self.tokens)))
        finally:
            jax_lm.gqa_attention = orig

    def torch_prefill(self) -> np.ndarray:
        step = make_prefill_step(self.tm)
        return step(self.tp, {"tokens": torch.from_numpy(self.tokens)}).numpy()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request) -> Pair:
    return Pair(request.param)


def _assert_logits_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    # greedy tokens agree wherever the reference's top two are apart by
    # more than the tolerance (random weights leave near-ties)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


# ------------------------------------------------------------------ layers
def test_rms_norm_matches(pair):
    """f32 within 1e-5 (rsqrt of another library); bf16 within 1 ulp."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8, pair.cfg.d_model)).astype(np.float32) * 3
    w = rng.standard_normal(pair.cfg.d_model).astype(np.float32) * 0.1
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 2.0**-7)):
        want = jax_layers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), pair.cfg.norm_eps)
        got = layers.rms_norm(tensor_from_numpy(np.asarray(jnp.asarray(x, dtype))),
                              torch.from_numpy(w), pair.cfg.norm_eps)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=1e-6)


def test_layer_norm_matches():
    """f32 within 1e-5; bf16 within 1 ulp."""
    rng = np.random.default_rng(6)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((B, 8, 64), (64,), (64,)))
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 2.0**-7)):
        want = jax_layers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
        got = layers.layer_norm(tensor_from_numpy(np.asarray(jnp.asarray(x, dtype))),
                                torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=1e-5)


def test_rope_matches(pair):
    """cos/sin and the rotation in f32: within 2e-5 (cos and sin of angles
    up to 64 rad, from pow and cos of another library)."""
    cfg = pair.cfg
    n_freq = int(cfg.hd * cfg.rope_fraction) // 2
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jc, js = jax_layers.rope_cos_sin(jnp.asarray(pos), n_freq, cfg.rope_theta)
    tc, ts = layers.rope_cos_sin(torch.from_numpy(pos), n_freq, cfg.rope_theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    x = np.random.default_rng(4).standard_normal((B, S, cfg.n_heads, cfg.hd)).astype(np.float32)
    want = jax_layers.apply_rope(jnp.asarray(x), jc, js, cfg.rope_fraction)
    got = layers.apply_rope(torch.from_numpy(x), tc, ts, cfg.rope_fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_gqa_attention_matches(pair):
    """The bf16 score chain on both sides, at the arch's heads and window:
    within 2 bf16 ulps of outputs of magnitude ~1 (2**-6)."""
    cfg = pair.cfg
    rng = np.random.default_rng(5)
    shapes = [(B, S, cfg.n_heads, cfg.hd), (B, S, cfg.n_kv_heads, cfg.hd),
              (B, S, cfg.n_kv_heads, cfg.hd)]
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)) for s in shapes]
    pos = np.arange(S, dtype=np.int32)
    window = cfg.sliding_window or S + 1
    want = jax_layers.gqa_attention(*(jnp.asarray(a) for a in arrs), q_pos=jnp.asarray(pos),
                                    k_pos=jnp.asarray(pos), window=window)
    got = layers.gqa_attention(*(tensor_from_numpy(a) for a in arrs),
                               q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
                               window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=2.0**-6)


# ------------------------------------------------------------ whole model
def test_param_tree_matches_reference(pair):
    jt = jax.tree.map(lambda sd: (tuple(sd[0]), jnp.dtype(sd[1]).name), pair.jm.param_template(),
                      is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    tt = jax.tree.map(lambda sd: (tuple(sd[0]), str(sd[1]).removeprefix("torch.")),
                      pair.tm.param_template(),
                      is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    assert tt == jt
    assert pair.tm.n_params() == pair.jm.n_params()
    jc = {k: (s, jnp.dtype(d).name) for k, (s, d) in pair.jm.cache_template(B, S).items()}
    tc = {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in
          pair.tm.cache_template(B, S).items()}
    assert tc == jc


def test_decode_matches_reference(pair):
    """4 teacher-forced decode steps from a zero cache: logits within
    LOGIT_ATOL; the caches within one bf16 ulp of their largest entries
    (|k| up to ~22: 2**-3), since a bias added to a projection rounded
    one ulp apart keeps that ulp even where the sum is near 0."""
    jm, tm = pair.jm, pair.tm
    jcache = {k: jnp.zeros(s, d) for k, (s, d) in jm.cache_template(B, S).items()}
    tcache = tm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    for i in range(4):
        tok = pair.tokens[:, i]
        jl, jcache = step(pair.jp, jcache, {"token": jnp.asarray(tok),
                                            "cur_len": jnp.asarray(i, jnp.int32)})
        tl, tcache = tm.decode_step(pair.tp, tcache, {"token": torch.from_numpy(tok),
                                                      "cur_len": i})
        _assert_logits_close(tl.numpy(), np.asarray(jl))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), rtol=2.0**-7,
                                   atol=2.0**-3)


def test_prefill_matches_reference_on_its_flash_oracle(pair):
    """Prefill last-position logits against the reference's prefill body
    with its attention swapped for ``flash_attention_ref``: the same
    function on both sides, within LOGIT_ATOL."""
    got = pair.torch_prefill()
    assert got.shape == (B, pair.cfg.vocab) and got.dtype == np.float32
    _assert_logits_close(got, pair.jax_prefill(swap_attention=True))


def test_prefill_against_unswapped_reference_qwen3():
    """The port's prefill (f32 flash scores) against the unmodified
    reference prefill (bf16 score chain), on reduced qwen3-0.6b, whose
    qk-norm bounds the scores: max |diff| <= 0.1 (measured 0.02 of a max
    |logit| of 1.47).

    On reduced qwen2-0.5b the two attentions drift much further: its
    random QKV biases (std 1/sqrt(H)) push the scores high, where bf16
    rounding of the score chain changes the softmax. Measured with the
    reference alone (its flash oracle swapped in, against its unmodified
    prefill; norms perturbed; B=2, S=64, logits at every position): max
    |diff| 0.99 of a max |logit| of 4.06, mean 0.030, greedy agreement
    93 %. With this file's weights and tokens, at the last position, the
    port against the unmodified reference differs by 0.07 of 1.67."""
    pair = Pair("qwen3_0_6b")
    got, want = pair.torch_prefill(), pair.jax_prefill(swap_attention=False)
    assert np.abs(got - want).max() <= 0.1


def test_prefill_uses_the_flash_wrapper_once_per_layer(pair, monkeypatch):
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v, *, causal=True, window=0):
        calls.append(window)
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr("repro_torch.models.lm.flash_attention", spy)
    pair.torch_prefill()
    assert calls == pair.tm._windows(S)
    assert len(calls) == pair.cfg.n_layers


# ------------------------------------------------------------- the slice
def test_serve_loop_matches_reference_decode_loop():
    """The whole slice: the port's serve loop (``decode_loop``) against the
    reference's ``decode_step`` loop as ``repro.launch.serve`` runs it, on
    the same carried-over weights of reduced qwen2-0.5b. The port is
    teacher-forced with the reference's greedy tokens, so that one flip of
    a near-tie cannot derail the rest; every step's logits agree within
    LOGIT_ATOL."""
    from repro_torch.launch.serve import decode_loop

    pair = Pair("qwen2_0_5b")
    jm, steps, cache_len = pair.jm, 8, 32
    jcache = {k: jnp.zeros(s, d) for k, (s, d) in jm.cache_template(B, cache_len).items()}
    step = jax.jit(jm.decode_step)
    first = pair.tokens[:, 0]
    batch = {"token": jnp.asarray(first)}
    jtoks, jlogits = [], []
    for i in range(steps):
        batch["cur_len"] = jnp.asarray(i, jnp.int32)
        logits, jcache = step(pair.jp, jcache, batch)
        nxt = jnp.argmax(logits, axis=-1)
        jtoks.append(np.asarray(nxt))
        jlogits.append(np.asarray(logits))
        batch["token"] = nxt.astype(jnp.int32)
    jtoks = np.stack(jtoks, axis=1)
    feed = np.concatenate([first[:, None], jtoks[:, :-1]], axis=1)
    toks, logits = decode_loop(pair.tm, pair.tp, pair.tm.init_cache(B, cache_len),
                               {"token": torch.from_numpy(first)}, steps, feed=feed)
    assert toks.shape == (B, steps)
    for got, want in zip(logits, jlogits):
        _assert_logits_close(got.numpy(), want)


# ------------------------------------------------------- construction
def test_build_model_defaults_to_the_card():
    cfg = get_arch("qwen2_0_5b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            build_model(cfg)
        with pytest.raises(RuntimeError):
            make_inputs(cfg, SHAPES["train_4k"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "zamba2_7b", "whisper_base", "qwen2_vl_7b"])
def test_unported_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        build_model(get_arch(arch).reduced(), device="cpu")


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_make_inputs_equal_reference(shape):
    cfg = get_arch("qwen2_0_5b").reduced()
    small = SHAPES[shape].__class__(shape, 64, 3, SHAPES[shape].kind)
    got = make_inputs(cfg, small, seed=7, device="cpu")
    want = jax_make_inputs(jax_get_arch("qwen2_0_5b").reduced(), small, seed=7)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_params_from_numpy_is_exact_for_bf16():
    x = jnp.asarray(np.random.default_rng(8).standard_normal((3, 5)), jnp.bfloat16)
    tree = {"a": np.asarray(x), "b": {"c": np.arange(4, dtype=np.float32)}}
    got = params_from_numpy(tree)
    assert got["a"].dtype == torch.bfloat16 and got["b"]["c"].dtype == torch.float32
    np.testing.assert_array_equal(got["a"].float().numpy(), np.asarray(x, np.float32))
    np.testing.assert_array_equal(got["b"]["c"].numpy(), tree["b"]["c"])


def test_init_params_follow_the_reference_rule():
    """Zeros for 1-D leaves, std 1/sqrt(fan_in) otherwise; reproducible."""
    model = LM(get_arch("qwen2_0_5b").reduced(), device="cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    assert torch.equal(a["final_ln"], torch.zeros_like(a["final_ln"]))
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    wq = a["layers"]["wq"].float()  # (L, D, H, hd): fan-in H
    assert abs(wq.std().item() - 1 / np.sqrt(wq.shape[-2])) < 0.05
