"""The port's dense and MoE LMs (reduced configs, on the CPU) against the
reference.

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

The MoE family (olmoe, qwen3-moe) routes each token to its top-k experts,
which is discontinuous: hidden states a few ulps apart can swap an expert
where two router probabilities nearly tie. Its reference runs are compiled
with ``xla_allow_excess_precision`` off (the port, like that compile,
rounds at every op): the default compile's skipped roundings move reduced
olmoe's router probabilities by up to 5.1e-3, the exact compile's by at
most 2.3e-4 from the port's. Every MoE layer's route sets are recorded on
both sides (``Routes``) and must agree at every token whose reference
margin (k-th minus (k+1)-th router probability) is at least ROUTE_DELTA;
logits are compared at every sequence whose routes agree in every layer.

The SSM (mamba2) and hybrid (zamba2) families are compared against the
exact compile too: the default one skips the bf16 roundings that the
Mamba2 mixer writes between ops (the gate, the conv's output) and moves
reduced zamba2's decode logits by up to 0.46 after 4 steps, where the port
and the exact compile agree bit for bit in logits, conv windows and K/V.
Their f32 SSM state differs in the last bits (sums over keys and state
entries in another order, ``exp`` of another library): within
STATE_ULPS = 32 f32 ulps of its largest entry (measured: 1).
"""
import contextlib
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
from repro_torch.configs import SHAPES, ShapeConfig, get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.train.steps import make_prefill_step
from repro_torch.tree import named_leaves

from _torch_encdec import cross_kv, norm_draw  # noqa: I001  (tests/ helper)

MOE_ARCHS = ["olmoe_1b_7b", "qwen3_moe_30b_a3b"]
SSM_ARCHS = ["mamba2_2_7b", "zamba2_7b"]
EMBED_ARCHS = ["whisper_base", "qwen2_vl_7b"]  # inputs: audio frames, patch embeddings
ATTN_ARCHS = ["qwen2_0_5b", "qwen3_0_6b", "gemma3_1b", "chatglm3_6b", *MOE_ARCHS]
ARCHS = [*ATTN_ARCHS, *SSM_ARCHS, *EMBED_ARCHS]
LOGIT_ATOL = 4 * 2.0**-6
STATE_ULPS = 32  # the SSD's Q + N terms, one ulp each (tests/test_torch_ssd.py)
ROUTE_DELTA = 1e-3  # 4x the largest router-probability difference seen (2.3e-4)
B, S = 2, 64


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else norm_draw(rng, v.shape, False).astype(np.float32) if v.ndim == 1
            else np.asarray(v)
            for k, v in tree.items()}


class Pair:
    """One reduced arch on both sides, with the same weights and inputs: the
    seeded tokens, or for whisper and qwen2-vl the reference's
    ``make_inputs`` of a B x S prefill (audio frames and tokens; embeddings
    and M-RoPE positions drawn in [0, S))."""

    def __init__(self, arch: str):
        self.cfg = jax_get_arch(arch).reduced()
        self.jm = JaxLM(self.cfg)
        np_params = _perturb(jax.tree.map(np.asarray, self.jm.init_params(jax.random.PRNGKey(0))),
                             np.random.default_rng(1))
        self.np_params = np_params
        self.jp = jax.tree.map(jnp.asarray, np_params)
        self.tm = build_model(get_arch(arch).reduced(), device="cpu")
        self.tp = self.tm.load_params(params_from_numpy(np_params))
        self.tokens = np.random.default_rng(2).integers(0, self.cfg.vocab, (B, S), dtype=np.int32)
        self.inputs = {"tokens": self.tokens}
        if self.cfg.family == "encdec" or self.cfg.embeddings_input:
            made = jax_make_inputs(self.cfg, ShapeConfig("prefill", S, B, "prefill"), seed=2)
            self.inputs = {k: np.asarray(v) for k, v in made.items() if k != "labels"}
        self.moe = self.cfg.family == "moe"
        # the bf16 chains of the MoE, SSM, encoder-decoder (GELU, layer
        # norms) and VLM families are compared with every rounding kept
        self.exact = self.moe or self.cfg.is_ssm or arch in EMBED_ARCHS

    def compile(self, fn, *args):
        """``jax.jit(fn)`` compiled for ``args``; for the MoE, SSM, hybrid,
        encoder-decoder and VLM families with every bf16 rounding kept
        (``xla_allow_excess_precision`` off)."""
        lowered = jax.jit(fn).lower(*args)
        if self.exact:
            return lowered.compile(compiler_options={"xla_allow_excess_precision": False})
        return lowered.compile()

    def jax_prefill(self, swap_attention: bool, inputs: dict | None = None) -> np.ndarray:
        """The body of the reference's ``make_prefill_step`` with ``ctx=None``
        (its mesh form does not run on this JAX: see ROADMAP C), on
        ``inputs`` (default: the pair's). Swapped, every attention is the
        reference's ``flash_attention_ref``, which masks by index."""
        jm, sw, cfg = self.jm, self.cfg.sliding_window, self.cfg

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

        def body(params, batch):
            if cfg.family == "encdec":
                h, _ = jm._run_encdec(params, batch, None)
                return jm._head(params, h[:, -1:])[:, 0].astype(jnp.float32)
            if cfg.embeddings_input:
                h, positions = batch["embeds"].astype(jnp.bfloat16), batch["positions"]
            else:
                h = params["embed"][batch["tokens"]].astype(jnp.bfloat16)
                positions = jnp.arange(S, dtype=jnp.int32)[None].repeat(B, 0)
            if cfg.family == "ssm":
                h, _ = jm._run_ssm_stack(params, h, None)
            elif cfg.family == "hybrid":
                h, _ = jm._run_hybrid_stack(params, h, positions=positions, ctx=None)
            else:
                h, _ = jm._run_decoder_stack(params, h, positions=positions, ctx=None)
            return jm._head(params, h[:, -1:])[:, 0].astype(jnp.float32)

        orig = jax_lm.gqa_attention
        jax_lm.gqa_attention = attention if swap_attention else orig
        try:
            args = (self.jp, jax.tree.map(jnp.asarray, inputs or self.inputs))
            return np.asarray(self.compile(body, *args)(*args))
        finally:
            jax_lm.gqa_attention = orig

    def torch_prefill(self, inputs: dict | None = None) -> np.ndarray:
        step = make_prefill_step(self.tm)
        batch = {k: tensor_from_numpy(v) for k, v in (inputs or self.inputs).items()}
        return step(self.tp, batch).numpy()

    def decode_batches(self, steps: int) -> list[tuple[dict, dict]]:
        """Teacher-forced decode inputs of ``steps`` steps from position 0,
        (the reference's, the port's): token i of the pair's tokens, or for
        the VLM its embedding at position i."""
        out = []
        for i in range(steps):
            if self.cfg.embeddings_input:
                x = {"embed": self.inputs["embeds"][:, i]}
            else:
                x = {"token": self.tokens[:, i]}
            out.append(({**{k: jnp.asarray(v) for k, v in x.items()},
                         "cur_len": jnp.asarray(i, jnp.int32)},
                        {**{k: tensor_from_numpy(v) for k, v in x.items()}, "cur_len": i}))
        return out

    def caches(self, cache_len: int) -> tuple[dict, dict]:
        """Zero decode caches of ``cache_len`` on both sides; for whisper
        with the cross-attention's ``xk``/``xv`` filled from each side's own
        encoder output on the pair's audio frames (``cross_kv``)."""
        jcache = {k: jnp.zeros(s, d) for k, (s, d) in self.jm.cache_template(B, cache_len).items()}
        tcache = self.tm.init_cache(B, cache_len)
        if self.cfg.family == "encdec":
            audio = self.inputs["audio_embeds"][:, :cache_len // 2]
            jcache["xk"], jcache["xv"] = jax_cross_kv(self, audio)
            xk, xv = torch_cross_kv(self.tm, self.tp, tensor_from_numpy(audio))
            tcache["xk"].copy_(xk)
            tcache["xv"].copy_(xv)
        return jcache, tcache


def jax_enc_out(pair: Pair, audio: np.ndarray):
    """The reference's encoder output for ``audio``: the output of its final
    layer norm over the encoder (``enc_final_ln``), recorded from the
    reference's own ``_run_encdec`` (the exact compile)."""
    seen = {}
    real = jax_lm.layer_norm

    def spy(x, w, b, *a):
        y = real(x, w, b, *a)
        if w is seen.get("w"):
            seen["out"] = y
        return y

    def enc(params, audio):
        seen["w"] = params["enc_final_ln"]
        tokens = jnp.zeros((audio.shape[0], 1), jnp.int32)
        pair.jm._run_encdec(params, {"audio_embeds": audio, "tokens": tokens}, None)
        return seen["out"]

    jax_lm.layer_norm = spy
    try:
        args = (pair.jp, jnp.asarray(audio))
        return pair.compile(enc, *args)(*args)
    finally:
        jax_lm.layer_norm = real


def jax_cross_kv(pair: Pair, audio: np.ndarray):
    """xk/xv (L, B, Sa, KV, hd) of the reference's encoder output: ``enc_out
    @ xwk``, ``enc_out @ xwv`` for every decoder layer, in bf16."""
    enc = jax_enc_out(pair, audio)
    dec = pair.jp["dec"]
    return tuple(jnp.einsum("bsd,ldhk->lbshk", enc, dec[w]) for w in ("xwk", "xwv"))


def torch_cross_kv(model: LM, params: dict, audio: torch.Tensor):
    """The same formula on the port's encoder output (``LM._encode``), its
    attention the reference's (``gqa_attention``, bf16 score chain: the
    training form) rather than the prefill's flash kernel."""
    return cross_kv(model, params, audio, train=True)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request) -> Pair:
    return Pair(request.param)


class Routes(contextlib.AbstractContextManager):
    """Records every MoE layer call's router probabilities on both sides, in
    call order: the port's from ``layers._route``, the reference's through
    a ``jax.debug.callback`` around its ``moe_layer`` (computed as its
    ``_moe_tokens`` does)."""

    def __init__(self, top_k: int):
        self.k, self.port, self.ref = top_k, [], []

    def __enter__(self):
        self._route, self._moe = layers._route, jax_lm.moe_layer

        def port_route(xt, wr, **kw):
            r = self._route(xt, wr, **kw)
            self.port.append(r.probs.numpy().copy())
            return r

        def ref_moe(x, wr, *a, **kw):
            logits = jnp.einsum("td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                                wr.astype(jnp.float32))
            jax.debug.callback(lambda p: self.ref.append(np.asarray(p)),
                               jax.nn.softmax(logits, axis=-1), ordered=True)
            return self._moe(x, wr, *a, **kw)

        layers._route, jax_lm.moe_layer = port_route, ref_moe
        return self

    def __exit__(self, *exc):
        layers._route, jax_lm.moe_layer = self._route, self._moe

    def flipped(self, n_seq: int) -> set[int]:
        """The sequences (of ``n_seq`` per call) that hold a token whose
        route sets differ in some layer; asserts each such token is a
        near-tie (reference margin below ROUTE_DELTA). Clears the record."""
        assert len(self.port) == len(self.ref) > 0
        out: set[int] = set()
        for p, r in zip(self.port, self.ref):
            top = np.sort(-r, axis=-1)
            margin = top[:, self.k] - top[:, self.k - 1]
            sets = [np.sort(np.argsort(-a, axis=-1, kind="stable")[:, :self.k], axis=-1)
                    for a in (p, r)]
            differ = (sets[0] != sets[1]).any(-1)
            assert (margin[differ] < ROUTE_DELTA).all(), margin[differ]
            out |= {int(t) * n_seq // len(p) for t in np.flatnonzero(differ)}
        self.port.clear()
        self.ref.clear()
        return out


def _routes(pair: Pair):
    return Routes(pair.cfg.moe_top_k) if pair.moe else contextlib.nullcontext()


def _assert_logits_close(got: np.ndarray, want: np.ndarray, routes: Routes | None = None) -> None:
    """Within LOGIT_ATOL; with ``routes`` (MoE), at the sequences whose
    route sets agreed in every layer (at least one)."""
    if routes is not None:
        flipped = routes.flipped(len(want))
        rows = [i for i in range(len(want)) if i not in flipped]
        assert rows, "every sequence holds a routing near-tie"
        got, want = got[rows], want[rows]
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


@pytest.mark.parametrize("arch", [*ATTN_ARCHS, "zamba2_7b"])
def test_gqa_attention_matches(arch):
    """The bf16 score chain on both sides, at the arch's heads and window:
    within 2 bf16 ulps of outputs of magnitude ~1 (2**-6). (mamba2 has no
    attention.)"""
    cfg = jax_get_arch(arch).reduced()
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
    assert pair.tm.n_active_params() == pair.jm.n_active_params()
    # params_from_numpy carried every leaf (the MoE experts' 4-D ones too) bit for bit
    want = dict(named_leaves(pair.np_params))
    for name, got in named_leaves(pair.tp):
        assert got.detach().contiguous().view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(want[name]).tobytes(), name
    jc = {k: (s, jnp.dtype(d).name) for k, (s, d) in pair.jm.cache_template(B, S).items()}
    tc = {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in
          pair.tm.cache_template(B, S).items()}
    assert tc == jc


def test_decode_matches_reference(pair):
    """4 teacher-forced decode steps from a zero cache (whisper's ``xk``/``xv``
    filled from each side's encoder: ``Pair.caches``; qwen2-vl fed its
    embeddings): logits within LOGIT_ATOL; the bf16 caches (K/V, conv
    windows, whisper's cross K/V) within one bf16 ulp of their largest
    entries (|k| up to ~22: 2**-3), since a bias added to a projection
    rounded one ulp apart keeps that ulp even where the sum is near 0; the
    f32 SSM state within STATE_ULPS f32 ulps of its largest entry."""
    jm, tm = pair.jm, pair.tm
    jcache, tcache = pair.caches(S)
    step = None
    with _routes(pair) as routes:
        for jb, tb in pair.decode_batches(4):
            args = (pair.jp, jcache, jb)
            step = step or pair.compile(jm.decode_step, *args)
            jl, jcache = step(*args)
            tl, tcache = tm.decode_step(pair.tp, tcache, tb)
            _assert_logits_close(tl.numpy(), np.asarray(jl), routes)
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        got, want = tcache[name].float().numpy(), np.asarray(jcache[name], np.float32)
        if name == "ssm":
            atol = STATE_ULPS * float(np.spacing(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-3)


def test_prefill_matches_reference_on_its_flash_oracle(pair):
    """Prefill last-position logits against the reference's prefill body
    with its attention swapped for ``flash_attention_ref``: the same
    function on both sides, within LOGIT_ATOL."""
    with _routes(pair) as routes:
        got = pair.torch_prefill()
        want = pair.jax_prefill(swap_attention=True)
    assert got.shape == (B, pair.cfg.vocab) and got.dtype == np.float32
    _assert_logits_close(got, want, routes)


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
    """Once per attention layer with its mask, (causal, window, Sq, Sk):
    every layer of the attention families (qwen2-vl's by index, causal),
    none in mamba2, once per group of zamba2 (its shared block, causal with
    no window), and for whisper once per encoder layer (non-causal over the
    S/2 frames) and twice per decoder layer: causal self-attention, then
    non-causal cross-attention of the S tokens against the S/2 frames."""
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v, *, causal=True, window=0):
        calls.append((causal, window, q.shape[2], k.shape[2]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr("repro_torch.models.lm.flash_attention", spy)
    pair.torch_prefill()
    cfg = pair.cfg
    if cfg.family == "ssm":
        assert calls == []
    elif cfg.family == "hybrid":
        assert calls == [(True, 0, S, S)] * (cfg.n_layers // cfg.shared_attn_every)
    elif cfg.family == "encdec":
        Sa = S // 2
        assert calls == ([(False, 0, Sa, Sa)] * cfg.encoder_layers
                         + [(True, 0, S, S), (False, 0, S, Sa)] * cfg.n_layers)
        assert len(calls) == 6  # 2 + 2 x 2 reduced; 6 + 2 x 6 = 18 at full depth
    else:
        assert calls == [(True, w, S, S) for w in pair.tm._windows(S)]
        assert len(calls) == cfg.n_layers


# ------------------------------------------------------------- the slice
def test_serve_loop_matches_reference_decode_loop():
    """The whole slice: the port's serve loop (``decode_loop``) against the
    reference's ``decode_step`` loop as ``repro.launch.serve`` runs it, on
    the same carried-over weights of reduced qwen2-0.5b. The port is
    teacher-forced with the reference's greedy tokens, so that one flip of
    a near-tie cannot derail the rest; every step's logits agree within
    LOGIT_ATOL."""
    _serve_loop_case("qwen2_0_5b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_loop_matches_reference_decode_loop_moe(arch):
    """The same for the MoE family, against the reference's exact compile;
    a sequence in which a near-tie swapped an expert at some step is not
    compared at any step (its cache holds that step's K/V)."""
    _serve_loop_case(arch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_loop_matches_reference_decode_loop_ssm(arch):
    """The same for the SSM and hybrid families (the caches carry conv
    windows and SSM states), against the reference's exact compile."""
    _serve_loop_case(arch)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_serve_loop_matches_reference_decode_loop_encdec_vlm(arch):
    """The same for whisper (from a zero cache, its ``xk``/``xv`` left at
    zero, as the reference's serve CLI decodes) and qwen2-vl (every step fed
    the same embedding, greedy tokens not fed back, as the reference's CLI
    does), against the reference's exact compile."""
    _serve_loop_case(arch)


def _serve_loop_case(arch: str) -> None:
    from repro_torch.launch.serve import decode_loop

    pair = Pair(arch)
    jm, steps, cache_len = pair.jm, 8, 32
    jcache = {k: jnp.zeros(s, d) for k, (s, d) in jm.cache_template(B, cache_len).items()}
    first = pair.tokens[:, 0]
    if pair.cfg.embeddings_input:
        embed = pair.inputs["embeds"][:, 0]
        batch = {"embed": jnp.asarray(embed), "cur_len": jnp.asarray(0, jnp.int32)}
    else:
        batch = {"token": jnp.asarray(first), "cur_len": jnp.asarray(0, jnp.int32)}
    jtoks, jlogits = [], []
    with _routes(pair) as routes:
        step = pair.compile(jm.decode_step, pair.jp, jcache, batch)
        for i in range(steps):
            batch["cur_len"] = jnp.asarray(i, jnp.int32)
            logits, jcache = step(pair.jp, jcache, batch)
            nxt = jnp.argmax(logits, axis=-1)
            jtoks.append(np.asarray(nxt))
            jlogits.append(np.asarray(logits))
            if "token" in batch:
                batch["token"] = nxt.astype(jnp.int32)
        jtoks = np.stack(jtoks, axis=1)
        if pair.cfg.embeddings_input:
            toks, logits = decode_loop(pair.tm, pair.tp, pair.tm.init_cache(B, cache_len),
                                       {"embed": tensor_from_numpy(embed)}, steps)
            np.testing.assert_array_equal(toks, jtoks)
        else:
            feed = np.concatenate([first[:, None], jtoks[:, :-1]], axis=1)
            toks, logits = decode_loop(pair.tm, pair.tp, pair.tm.init_cache(B, cache_len),
                                       {"token": torch.from_numpy(first)}, steps, feed=feed)
    assert toks.shape == (B, steps)
    flipped = routes.flipped(B) if routes is not None else set()
    rows = [i for i in range(B) if i not in flipped]
    assert rows, "every sequence holds a routing near-tie"
    for got, want in zip(logits, jlogits):
        _assert_logits_close(got.numpy()[rows], want[rows])


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


def test_lm_raises_only_for_an_unknown_family():
    """Every family of the catalog builds; an unknown one is refused."""
    import dataclasses

    from repro_torch.configs import all_archs

    assert {build_model(c.reduced(), device="cpu").cfg.family for c in all_archs().values()} == \
        {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_arch("qwen2_0_5b"), family="rnn"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_counts_equal_reference(arch):
    """Total and active (MoE: top_k of E experts) parameters at full width,
    from the templates alone."""
    model = build_model(get_arch(arch), device="cpu")
    ref = JaxLM(jax_get_arch(arch))
    assert (model.n_params(), model.n_active_params()) == (ref.n_params(), ref.n_active_params())


@pytest.mark.parametrize("arch,n", [("mamba2_2_7b", 2830951936), ("zamba2_7b", 6750539856)])
def test_ssm_full_width_parameter_counts(arch, n):
    """mamba2-2.7b's and zamba2-7b's counts at full width (zamba2's one
    shared block counted once)."""
    assert build_model(get_arch(arch), device="cpu").n_params() == n


@pytest.mark.parametrize("arch,max_pos,n", [("whisper_base", 2048, 84259328),
                                            ("whisper_base", 448, 83440128),
                                            ("qwen2_vl_7b", 2048, 7070619136)])
def test_encdec_vlm_full_width_parameter_counts(arch, max_pos, n):
    """whisper-base's count at the serve CLI's ``max_pos`` (``dec_pos`` is
    (max_pos, 512), ``wu`` counted though unused) and the reference's at
    the same ``max_pos``; qwen2-vl-7b's, which has no ``embed`` (its inputs
    are embeddings) and so no ``max_pos`` in it."""
    got = build_model(get_arch(arch), max_pos=max_pos, device="cpu").n_params()
    assert got == n == JaxLM(jax_get_arch(arch), max_pos=max_pos).n_params()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_the_moe_family(arch):
    """``python -m repro_torch.launch.serve --arch <moe> --device cpu``:
    greedy tokens from finite logits, on the reduced config."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--cache-len", "16",
                      "--tokens", "4"])
    assert out["finite"] and out["tokens"].shape == (2, 4)
    assert out["model"].cfg.family == "moe"


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_cli_runs_the_ssm_families(arch):
    """``python -m repro_torch.launch.serve --arch <mamba2|zamba2> --device
    cpu``: greedy tokens from finite logits, on the reduced config."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--cache-len", "16",
                      "--tokens", "4"])
    assert out["finite"] and out["tokens"].shape == (2, 4)
    assert out["model"].cfg.family == get_arch(arch).family


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_serve_cli_runs_the_encdec_and_vlm_families(arch, monkeypatch):
    """``python -m repro_torch.launch.serve --arch <whisper_base|qwen2_vl_7b>
    --device cpu``: greedy tokens from finite logits, on the reduced config;
    whisper's cache holds ``xk``/``xv`` of cache-len // 2 frames (left at
    zero) and its ``dec_pos`` cache-len rows; qwen2-vl's steps are each fed
    the same seeded (B, D) bf16 embedding, x 0.02, and no token."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM

    seen = []
    real = LM.decode_step

    def spy(self, params, cache, batch):
        seen.append(({k: v for k, v in batch.items() if k != "cur_len"},
                     {k: tuple(v.shape) for k, v in cache.items()}))
        return real(self, params, cache, batch)

    monkeypatch.setattr(LM, "decode_step", spy)
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--cache-len", "16",
                      "--tokens", "4"])
    assert out["finite"] and out["tokens"].shape == (2, 4)
    cfg = out["model"].cfg
    assert cfg.family == get_arch(arch).family and len(seen) == 1 + 4  # warm-up + 4 steps
    if cfg.family == "encdec":
        assert seen[-1][1]["xk"] == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
        assert out["params"]["dec_pos"].shape == (16, cfg.d_model)
        assert all(set(b) == {"token"} for b, _ in seen)
    else:
        want = np.random.default_rng(0).standard_normal((2, cfg.d_model)) * 0.02
        for b, _ in seen:
            assert set(b) == {"embed"} and b["embed"].dtype == torch.bfloat16
            np.testing.assert_array_equal(b["embed"].float().numpy(),
                                          torch.from_numpy(want).bfloat16().float().numpy())


# ------------------------------------------------- encoder-decoder, VLM
def test_gelu_matches_reference_bit_for_bit():
    """The tanh-approximate GELU op by op in bf16 with jax's bf16-rounded
    constants: every output equal to ``jax.nn.gelu(approximate=True)``'s,
    under the default and the exact compile, on 200k values of std 3. In
    f32 (tanh of another library) within 2e-6 (measured 9.5e-7)."""
    x = np.asarray(jnp.asarray(np.random.default_rng(9).standard_normal(200_000) * 3,
                               jnp.bfloat16))
    fn = jax.jit(lambda a: jax.nn.gelu(a, approximate=True))
    got = layers._gelu_tanh(tensor_from_numpy(x)).float().numpy()
    for options in ({}, {"xla_allow_excess_precision": False}):
        want = fn.lower(jnp.asarray(x)).compile(compiler_options=options)(jnp.asarray(x))
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    xf = x.astype(np.float32)
    np.testing.assert_allclose(layers._gelu_tanh(torch.from_numpy(xf)).numpy(),
                               np.asarray(fn(jnp.asarray(xf))), rtol=0, atol=2e-6)


def test_gelu_mlp_matches_reference():
    """``gelu_mlp`` at whisper's reduced widths in bf16, with random biases:
    against the reference's exact compile, every output within 2 bf16 ulps
    of the largest |output| of its row, room for the products' bf16
    roundings after sums in another order (measured: equal bit for bit)."""
    rng = np.random.default_rng(10)
    D, F = 64, 128
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    arrs = [bf(rng.standard_normal((B, S, D))), bf(rng.standard_normal((D, F)) / 8),
            bf(rng.standard_normal(F) * 0.1), bf(rng.standard_normal((F, D)) / 11),
            bf(rng.standard_normal(D) * 0.1)]
    args = [jnp.asarray(a) for a in arrs]
    want = np.asarray(jax.jit(jax_layers.gelu_mlp).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args), np.float32)
    got = layers.gelu_mlp(*(tensor_from_numpy(a) for a in arrs))
    assert got.dtype == torch.bfloat16
    row_ulp = 2.0**(np.floor(np.log2(np.abs(want).max(-1, keepdims=True))) - 7)
    d = np.abs(got.float().numpy() - want)
    assert np.all(d <= 2 * row_ulp)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_cos_sin_matches_reference(sections):
    """M-RoPE's cos/sin from (3, B, S) positions drawn in [0, S) (each slot
    group from its own stream), and the rotation they drive, in f32: within
    2e-5 (cos and sin of angles up to 64 rad, from pow and cos of another
    library), at qwen2-vl-7b's sections and the reduced config's."""
    pos = np.random.default_rng(11).integers(0, S, (3, B, S), dtype=np.int32)
    jc, js = jax_layers.mrope_cos_sin(jnp.asarray(pos), sections, 1e6)
    tc, ts = layers.mrope_cos_sin(torch.from_numpy(pos), sections, 1e6)
    assert tc.shape == (B, S, sum(sections)) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    # slot group g turns with stream g alone
    g1 = slice(sections[0], sections[0] + sections[1])
    moved = pos.copy()
    moved[1] += 1
    tc2, _ = layers.mrope_cos_sin(torch.from_numpy(moved), sections, 1e6)
    changed = (tc2 != tc).any(0).any(0).numpy()
    assert changed[g1].any() and not changed[:sections[0]].any() and \
        not changed[g1.stop:].any()
    hd = 2 * sum(sections)
    x = np.random.default_rng(12).standard_normal((B, S, 2, hd)).astype(np.float32)
    np.testing.assert_allclose(layers.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               np.asarray(jax_layers.apply_rope(jnp.asarray(x), jc, js)),
                               atol=2e-5)


def test_cross_attention_matches_reference():
    """``gqa_attention`` at whisper's cross-attention (non-causal, S queries
    against S/2 keys, no window), the bf16 score chain on both sides: within
    2 bf16 ulps of outputs of magnitude ~1 (2**-6)."""
    cfg = jax_get_arch("whisper_base").reduced()
    rng = np.random.default_rng(13)
    shapes = [(B, S, cfg.n_heads, cfg.hd), (B, S // 2, cfg.n_kv_heads, cfg.hd),
              (B, S // 2, cfg.n_kv_heads, cfg.hd)]
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)) for s in shapes]
    qp, kp = np.arange(S, dtype=np.int32), np.arange(S // 2, dtype=np.int32)
    want = jax_layers.gqa_attention(*(jnp.asarray(a) for a in arrs), q_pos=jnp.asarray(qp),
                                    k_pos=jnp.asarray(kp), causal=False)
    got = layers.gqa_attention(*(tensor_from_numpy(a) for a in arrs), q_pos=torch.from_numpy(qp),
                               k_pos=torch.from_numpy(kp), causal=False)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=2.0**-6)


def test_whisper_cross_cache_matches_reference():
    """``xk``/``xv`` filled from the encoder (``enc_out @ xwk``, ``@ xwv``)
    on both sides, the test's own formula over each side's encoder (both
    attending with the bf16 score chain): within one bf16 ulp of the
    largest entry of each (measured: equal bit for bit; the layer norms,
    GELU chains and products round alike)."""
    pair = Pair("whisper_base")
    jcache, tcache = pair.caches(S)
    for name in ("xk", "xv"):
        want = np.asarray(jcache[name], np.float32)
        got = tcache[name].float().numpy()
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0**(np.floor(np.log2(np.abs(want).max())) - 7))


def _vlm_inputs(pair: Pair, temporal: np.ndarray | None = None) -> dict:
    out = {k: v.copy() for k, v in pair.inputs.items()}
    if temporal is not None:
        out["positions"][0] = temporal
    return out


def test_vlm_prefill_in_sequence_order_matches_unswapped_reference():
    """qwen2-vl's prefill on inputs whose temporal stream is 0..S-1 (the
    other two keep ``make_inputs``' random values), where masking by index
    (the port's flash kernel) and by the temporal values (the reference)
    agree. Against the reference's unmodified prefill, whose attention runs
    the bf16 score chain where the kernel keeps f32 scores, the port is as
    far as the reference's own body with its flash oracle swapped in (its
    random QKV biases make the attention sharp, as on qwen2-0.5b: see
    ``test_prefill_against_unswapped_reference_qwen3``): within that
    distance + LOGIT_ATOL at every logit (measured: the same 0.244 of a max
    |logit| of 3.78), and within 0.1 on average (measured 0.045)."""
    pair = Pair("qwen2_vl_7b")
    seq = _vlm_inputs(pair, np.tile(np.arange(S, dtype=np.int32), (B, 1)))
    got, want = pair.torch_prefill(seq), pair.jax_prefill(swap_attention=False, inputs=seq)
    own = np.abs(pair.jax_prefill(swap_attention=True, inputs=seq) - want)
    assert np.all(np.abs(got - want) <= own + LOGIT_ATOL)
    assert np.abs(got - want).mean() <= 0.1


def test_vlm_prefill_masks_by_index_not_by_position_values():
    """The divergence on purpose (ROADMAP C): on ``make_inputs``' random
    positions the port's prefill masks causally by sequence index. It
    equals the reference's prefill body with the index-masked attention
    (``flash_attention_ref``) within LOGIT_ATOL (measured: equal), and the
    reference's own prefill, which masks by the temporal stream's values,
    differs from it by more than 0.5 on average (measured 0.775, max 2.875,
    no greedy token equal; in sequence order the same comparison gives
    0.045: ``test_vlm_prefill_in_sequence_order_matches_unswapped_reference``)."""
    pair = Pair("qwen2_vl_7b")
    assert not np.array_equal(pair.inputs["positions"][0, 0], np.arange(S))
    got = pair.torch_prefill()
    _assert_logits_close(got, pair.jax_prefill(swap_attention=True))
    assert np.abs(got - pair.jax_prefill(swap_attention=False)).mean() > 0.5


@pytest.mark.parametrize("arch,n", [("whisper_base", 2 + 2 * 2), ("qwen2_vl_7b", 2)])
def test_train_loss_attends_with_gqa_and_the_reference_masks(arch, n, monkeypatch):
    """The training loss attends with ``gqa_attention``: whisper non-causal
    in the encoder and the cross-attention, causal in the decoder's
    self-attention; qwen2-vl causal by the temporal stream's values (the
    reference's mask). The flash kernel is not used."""
    import repro_torch.models.lm as lm
    from repro_torch.train.steps import loss_and_grads

    calls = []
    real = lm.gqa_attention

    def spy(q, k, v, *, q_pos, k_pos, causal=True, **kw):
        calls.append((causal, q_pos.clone(), k.shape[1]))
        return real(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, **kw)

    monkeypatch.setattr(lm, "gqa_attention", spy)
    monkeypatch.setattr(lm, "flash_attention", None)
    pair = Pair(arch)
    batch = {k: tensor_from_numpy(v) for k, v in pair.inputs.items()}
    batch["labels"] = torch.from_numpy(pair.tokens)
    loss, _ = loss_and_grads(pair.tm, pair.tp, batch)
    assert torch.isfinite(loss)
    fwd = calls[:n]  # then the checkpointed layers' recompute
    if arch == "whisper_base":
        assert [(c, sk) for c, _, sk in fwd] == [(False, S // 2)] * 2 + [(True, S), (False, S // 2)] * 2
    else:
        assert all(c and torch.equal(p, batch["positions"][0, 0]) for c, p, _ in fwd)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_make_inputs_equal_reference(shape):
    cfg = get_arch("qwen2_0_5b").reduced()
    small = SHAPES[shape].__class__(shape, 64, 3, SHAPES[shape].kind)
    got = make_inputs(cfg, small, seed=7, device="cpu")
    want = jax_make_inputs(jax_get_arch("qwen2_0_5b").reduced(), small, seed=7)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", EMBED_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_make_inputs_equal_reference_encdec_vlm(shape, arch):
    """Audio frames (B, S/2, D), embeddings (B, S, D) and M-RoPE positions
    (3, B, S), bf16 bit for bit."""
    cfg = get_arch(arch).reduced()
    small = SHAPES[shape].__class__(shape, 64, 3, SHAPES[shape].kind)
    got = make_inputs(cfg, small, seed=7, device="cpu")
    want = jax_make_inputs(jax_get_arch(arch).reduced(), small, seed=7)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


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
