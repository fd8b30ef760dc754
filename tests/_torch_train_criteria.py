"""The criteria one train step is held to against another (JAX-free, so the
card's tests and ``chip_smoke.py`` use them too).

- loss within 2e-2 absolute;
- each gradient leaf within 5e-2 relative L2 error (bf16 gradients, summed
  in another order);
- after the step each ``m`` leaf within 5e-2 and each ``v`` leaf within 1e-1
  relative L2 (``v`` squares the gradient's error); ``step`` equal;
- every updated parameter within 1 bf16 ulp of itself plus 2 lr of the
  other's, and within 1 ulp on at least 98 % of each leaf's elements:
  Adam's first step moves each parameter by +-lr wherever |g| >> eps, so an
  element whose gradient is near 0 can move the other way (2 lr apart).

Where a step is ill-conditioned (reduced zamba2's sharp shared attention:
a bf16 rounding flipped anywhere moves its gradients by tens of percent),
two correct computations cannot meet these criteria. ``ssd_nudged`` makes
a third one on one device, with every SSD output moved by one f32 ulp,
which shows whether the criteria can hold there (``norm_nudged``, every
RMS norm's output, does so for a model without an SSD); ``hold_step`` is
the one policy that decides, from it, whether and how a step is held.
``tp_rounding`` rounds the unsharded model's row-parallel products as n
ranks of tensor parallelism round them: the probe, and the one-device
counterpart, of the sharded serving steps. ``tp_rows`` runs the prefill's
products on the row blocks of the sequence that the ranks of a
sequence-sharded mesh hold: with it, an f32 witness of the sharded prefill
has a one-device twin on the card too.
"""
import contextlib
import math

import numpy as np
import torch

from repro_torch.tree import named_leaves

LOSS_ATOL, GRAD_RTOL, M_RTOL, V_RTOL, ULP_SHARE = 2e-2, 5e-2, 5e-2, 1e-1, 0.98
# ``hold_step`` widens a criterion by the nudge's distance up to this many
# times the criterion's own tolerance (0.2 in gradients and m, 0.4 in v);
# past it the widened check would pass a backward that is wrong by tens of
# percent, and the step is not held
NUDGE_CAP = 4


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` (numpy, bf16 numpy from JAX included, or a tensor) as a tensor,
    on ``device`` if given."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16" or not a.flags.writeable:  # JAX's arrays are read-only
            a = a.astype(np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        x = torch.from_numpy(a)
    return x if device is None else x.to(device)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64, numpy or tensors (on got's device)."""
    g = _tensor(got).double()
    w = _tensor(want, g.device).double()
    return float(torch.linalg.vector_norm(g - w) / max(float(torch.linalg.vector_norm(w)), 1e-30))


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), for numpy or a tensor:
    2 ** (floor(log2 |x|) - 7), the exponent read exactly (``frexp``)."""
    if isinstance(x, torch.Tensor):
        e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))[1]
        return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))[1]
    return np.ldexp(np.float32(1), e - 8)


def to_np(tree):
    """A nested dict of tensors (any device) as numpy, bf16 as f32."""
    return {k: to_np(v) if isinstance(v, dict)
            else (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in tree.items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Each gradient leaf's relative L2 error (trees of numpy or tensors)."""
    want = dict(named_leaves(want))
    return {name: rel_l2(g, want[name]) for name, g in named_leaves(got)}


def step_metrics(got_p, got_o, want_p, want_o, lr: float) -> dict:
    """Per-leaf distances of one step's (params, opt state) from another's
    (trees of numpy or tensors; computed on ``got``'s device): m and v
    relative L2, the share of parameters within 1 bf16 ulp, and the largest
    |diff| / (ulp + 2 lr)."""
    out = {}
    tp, wp = dict(named_leaves(got_p)), dict(named_leaves(want_p))
    tm, wm = dict(named_leaves(got_o["m"])), dict(named_leaves(want_o["m"]))
    tv, wv = dict(named_leaves(got_o["v"])), dict(named_leaves(want_o["v"]))
    for name in wp:
        a = _tensor(tp[name]).float()
        b = _tensor(wp[name], a.device).float()
        d = (a - b).abs()
        ulp = bf16_ulp(b)
        close = d <= ulp
        out[name] = {"m": rel_l2(tm[name], wm[name]), "v": rel_l2(tv[name], wv[name]),
                     "share": float(close.double().mean()), "within": int(close.sum()),
                     "size": d.numel(), "ratio": float((d / (ulp + 2 * lr)).max())}
    return out


def assert_step_close(got: dict, floor: dict | None = None, pooled: bool = False) -> None:
    """``got`` (``step_metrics``) meets the criteria; with ``floor`` (the
    same metrics of one reference against another), each criterion is
    widened by that distance (the 1-ulp share over all parameters only where
    the floor itself misses it). ``pooled`` takes the 1-ulp share over all
    parameters instead of leaf by leaf."""
    for name, g in got.items():
        f = floor[name] if floor else {"m": 0.0, "v": 0.0, "share": 1.0}
        assert g["m"] <= f["m"] + M_RTOL, (name, g, f)
        assert g["v"] <= f["v"] + V_RTOL, (name, g, f)
        assert pooled or g["share"] >= f["share"] - (1 - ULP_SHARE), (name, g, f)
        assert g["ratio"] <= max(1.0, f.get("ratio", 0.0)), (name, g, f)
    need = ULP_SHARE
    if floor and _share(floor) < ULP_SHARE:
        need = _share(floor) - (1 - ULP_SHARE)
    assert _share(got) >= need, (_share(got), need)


def _share(metrics: dict) -> float:
    """The share of all parameters within 1 bf16 ulp (``step_metrics``)."""
    return sum(g["within"] for g in metrics.values()) / sum(g["size"] for g in metrics.values())


def widest(metrics: list[dict]) -> dict:
    """Leaf by leaf, the farthest of several ``step_metrics`` (largest m, v
    and ratio, least share): a floor for ``assert_step_close``."""
    return {name: {"m": max(m[name]["m"] for m in metrics),
                   "v": max(m[name]["v"] for m in metrics),
                   "share": min(m[name]["share"] for m in metrics),
                   "within": min(m[name]["within"] for m in metrics),
                   "size": metrics[0][name]["size"],
                   "ratio": max(m[name]["ratio"] for m in metrics)} for name in metrics[0]}


def meets(got: dict, grad_errs: dict | None = None) -> bool:
    """Whether ``got`` (``step_metrics``) and the gradients' errors
    (``grad_errors``) meet the criteria."""
    try:
        assert_step_close(got)
    except AssertionError:
        return False
    return grad_errs is None or max(grad_errs.values()) <= GRAD_RTOL


def hold_step(got: dict, grads: dict | None = None, nudged: list = (),
              pooled: bool = False) -> tuple[bool, str, list[str]]:
    """Whether and how one step is held against another's: ``got`` and
    ``grads`` are its ``step_metrics`` and ``grad_errors`` (or None) against
    the other; ``nudged`` the other side's own step under the SSD nudges,
    each as (``step_metrics``, ``grad_errors`` or None) against itself
    (empty where the model has no SSD).

    - Every nudged step meets the criteria (or none was made): the step is
      well-conditioned and held to the criteria.
    - Some nudged step misses them, but no floor (leaf by leaf, the farther
      nudge) exceeds NUDGE_CAP times its tolerance: ill-conditioned, held
      to the criteria widened by the floor.
    - Farther: ill-conditioned, not held. A nudge either flips a rounding
      the sharp attention amplifies or flips none, so its distance jumps
      between ~1e-4 and tens of percent with the machine's f32 sums (and
      between the nudge up and down); a floor that wide holds nothing.

    ``pooled`` takes the 1-ulp share over all parameters. Returns (held,
    the verdict to print, the criteria the step misses where held)."""
    floor = gfloor = None
    verdict = "held"
    if not all(meets(m, g) for m, g in nudged):
        floor = widest([m for m, _ in nudged])
        gs = [g for _, g in nudged if g is not None]
        gfloor = {n: max(g[n] for g in gs) for n in gs[0]} if gs else {}
        far = max([max(f["m"] for f in floor.values()) / M_RTOL,
                   max(f["v"] for f in floor.values()) / V_RTOL]
                  + [e / GRAD_RTOL for e in gfloor.values()])
        if far > NUDGE_CAP:
            return False, (f"ill-conditioned, not held (a one-ulp nudge moves the step "
                           f"{far:.2f} tolerances, past the cap of {NUDGE_CAP})"), []
        verdict = (f"held, widened by the nudge's distance (ill-conditioned: {far:.2f} "
                   f"tolerances, within the cap of {NUDGE_CAP})")
    failures = [f"gradient {n}: {e} > {GRAD_RTOL} + {(gfloor or {}).get(n, 0.0)}"
                for n, e in (grads or {}).items()
                if e > GRAD_RTOL + (gfloor or {}).get(n, 0.0)]
    try:
        assert_step_close(got, floor, pooled=pooled)
    except AssertionError as e:
        failures.append(f"step: {e}")
    return True, verdict, failures


@contextlib.contextmanager
def ssd_nudged(to: float):
    """While active, every output of the port's ``models.ssd._ssd_chunked``
    moves one f32 ulp toward ``to`` (+-inf); the gradient passes through
    unchanged. That flips the few bf16 roundings of the mixer's output that
    lie within an f32 ulp of a rounding boundary, as another correct order
    of the SSD's f32 sums does."""
    from repro_torch.models import ssd

    real = ssd._ssd_chunked

    def nudged(*a):
        y = real(*a)
        ys = y.detach()
        return y + (torch.nextafter(ys, torch.full_like(ys, to)) - ys)

    ssd._ssd_chunked = nudged
    try:
        yield
    finally:
        ssd._ssd_chunked = real


@contextlib.contextmanager
def norm_nudged(to: float):
    """While active, every RMS norm of the port's LM (``models.lm.rms_norm``)
    moves its f32 output one f32 ulp toward ``to`` before rounding it to its
    input's dtype; the gradient passes through unchanged. That flips the few
    bf16 roundings of the norms' outputs that lie within an f32 ulp of a
    rounding boundary, as another correct order of their f32 sums does: the
    counterpart of ``ssd_nudged`` for the models without an SSD."""
    from repro_torch.models import lm

    real = lm.rms_norm

    def nudged(x, w, eps=1e-6):
        y = real(x.float(), w, eps)
        ys = y.detach()
        return (y + (torch.nextafter(ys, torch.full_like(ys, to)) - ys)).to(x.dtype)

    lm.rms_norm = nudged
    try:
        yield
    finally:
        lm.rms_norm = real


@contextlib.contextmanager
def chunked_ce():
    """While active, the one-device loss (``LM.loss_fn`` with no mesh)
    takes its cross-entropy in the chunked form a mesh's step takes
    (``LM._cross_entropy``: CE_CHUNK positions a chunk, each under
    ``torch.utils.checkpoint``, their sums added in f32), where one device
    takes it from the whole logits. The head's weight (gemma3's tied
    embedding too) then gets one bf16 product a chunk, summed by autograd
    in the weight's dtype, as on a mesh, where one device rounds a single
    product over every position: the counterpart, on one device, of that
    rounding of a mesh's step (``hold_step``'s probe of it)."""
    from repro_torch.models import lm

    real = lm.LM._cross_entropy

    class _OneRank:  # a mesh of one rank, as ``_cross_entropy`` reads it
        n_model = 1

    def chunked(self, params, h, labels, ctx=None, **kw):
        return real(self, params, h, labels, _OneRank() if ctx is None else ctx, **kw)

    lm.LM._cross_entropy = chunked
    try:
        yield
    finally:
        lm.LM._cross_entropy = real


@contextlib.contextmanager
def embed_rows(n: int):
    """While active, the one-device embedding lookup (``LM._embed`` with no
    mesh) runs on the ``n`` contiguous blocks of the sequence that ``n``
    sequence ranks hold, one after another: its backward then adds each
    block's positions into the embedding's gradient on its own, and the
    blocks' gradients are summed, as the ranks' are. Repeated tokens (the
    Zipf data's: a fifth of the positions are one token) make that bf16
    sum ill-conditioned, and a tied head's gradient, which nearly cancels
    it, more so: the probe, on one device, of the sequence ranks'
    order."""
    from repro_torch.models import lm

    real = lm.LM._embed

    def by_blocks(self, params, tokens, tp=None, decode=False):
        if tp is not None or decode or tokens.shape[1] % n:
            return real(self, params, tokens, tp, decode)
        return torch.cat([real(self, params, t, tp, decode) for t in tokens.chunk(n, dim=1)],
                         dim=1)

    lm.LM._embed = by_blocks
    try:
        yield
    finally:
        lm.LM._embed = real


@contextlib.contextmanager
def tp_rounding(n: int, seq: int = 1):
    """While active, every product that tensor parallelism splits into
    partial sums over "model" (the attention's out-projection over its
    heads, SwiGLU's and the GELU MLP's down-projections over d_ff, the
    Mamba2 mixer's out-projection over d_inner, and the head's product over
    d_model where the vocab does not divide ``n``; in the prefill and the
    decode step) runs as ``n`` partial products over contiguous blocks,
    each rounded to its dtype, added in f32 and rounded again: how ``n``
    ranks round it (``scatter_seq``, ``psum_model``, ``reduce_model``), on
    one device. It shows how far the unsharded model carries that
    rounding. Where a dim does not divide ``n`` the ranks run the reference's
    fallback layout, and so does this: the replicated FFN, mixer or head
    whole; the attention, where the heads do not divide ``n`` and head_dim
    does, whole in the prefill, and in the decode step (one query) on the
    head_dim blocks: its f32 partial scores added in f32 in rank order and
    rounded once, its out-projection as ``n`` partial products over the
    head_dim block of every head.

    With ``seq`` > 1 the decode step's attention (one query) also runs as
    ``seq`` ranks of a sequence-sharded cache run it
    (``gqa_attention(seq_split=)``): each contiguous block of the keys
    scored in the bf16 chain, the max over the blocks, each block's f32
    denominator and ``w . v`` summed over its keys, then added in f32 in
    the blocks' order (``MeshCtx.seq_sum``); the prefill rounds nothing of
    its own there (each rank's rows are the whole sequence's). Composed
    with the head_dim fallback (``hd_split`` and ``seq_split`` together),
    in this order: each block's f32 partial scores of the ``n`` head_dim
    blocks added in rank order and rounded once, the row max over the key
    blocks, the denominator and ``w . v`` in the blocks' order, then the
    out-projection's ``n`` partial products."""
    from repro_torch.models import layers, lm, ssd

    def split(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """y (..., K) @ w (K, D) as n partial products summed in f32."""
        k = y.shape[-1] // n
        parts = [(y[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]).float() for i in range(n)]
        return sum(parts[1:], parts[0]).to(y.dtype)

    def out_proj(self, lp, o):
        B, S, H, hd = o.shape
        if H % n == 0:
            return split(o.reshape(B, S, -1), lp["wo"].reshape(-1, self.cfg.d_model))
        if S > 1 or hd % n:  # the fallback: the prefill's and a replicated head_dim's whole
            return real[0](self, lp, o)
        c, wo = hd // n, lp["wo"]
        parts = [(o[..., i * c:(i + 1) * c].reshape(B, S, -1)
                  @ wo[:, i * c:(i + 1) * c].reshape(-1, wo.shape[-1])).float() for i in range(n)]
        return sum(parts[1:], parts[0]).to(o.dtype)

    class _Summed:
        """``gqa_attention``'s ``hd_split`` for one device: the partial
        scores of the head_dim blocks, summed beforehand, stand for the sum
        over "model"; head_dim is whole (its scale)."""
        n_model = 1

        def __init__(self, s: torch.Tensor):
            self.s = s

        def psum_model(self, _):
            return self.s

    def seq_gqa(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                score_dtype=torch.bfloat16, **_):
        B, Sq, H, hd = q.shape
        KV = k.shape[2]
        scale = layers._rounded(1.0 / math.sqrt(hd), score_dtype)
        qg = q.reshape(B, Sq, KV, H // KV, hd).float()
        c = k.shape[1] // seq
        blocks = [slice(i * c, (i + 1) * c) for i in range(seq)]
        # the head_dim fallback's blocks of the partial scores (one block without it)
        d = hd // n if n > 1 and H % n and hd % n == 0 else hd
        dims = [slice(j * d, (j + 1) * d) for j in range(hd // d)]

        def scores(b: slice) -> torch.Tensor:
            kb = k[:, b].contiguous()
            parts = [torch.einsum("bqkgd,bskd->bkgqs", qg[..., j], kb[..., j].float())
                     for j in dims]
            return sum(parts[1:], parts[0]).to(score_dtype)

        s = [scores(b) * scale + layers._mask_bias(q_pos, k_pos[b], window, causal).to(score_dtype)
             for b in blocks]
        m = s[0].amax(dim=-1, keepdim=True)
        for sb in s[1:]:
            m = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        e = [torch.exp(sb - m) for sb in s]

        def in_order(parts):
            out = parts[0]
            for part in parts[1:]:
                out = out + part
            return out

        den = in_order([eb.sum(dim=-1, keepdim=True, dtype=torch.float32) for eb in e])
        out = in_order([torch.einsum("bkgqs,bskd->bqkgd", (eb / den.to(score_dtype)).float(),
                                     v[:, b].contiguous().float()) for eb, b in zip(e, blocks)])
        return out.to(q.dtype).reshape(B, Sq, H, hd)

    def gqa(q, k, v, *, hd_split=None, **kw):
        B, Sq, H, hd = q.shape
        if seq > 1 and Sq == 1 and hd_split is None:
            return seq_gqa(q, k, v, **kw)
        if Sq > 1 or hd_split is not None or H % n == 0 or hd % n:
            return real[6](q, k, v, hd_split=hd_split, **kw)
        c, KV = hd // n, k.shape[2]
        qg = q.reshape(B, Sq, KV, H // KV, hd)
        parts = [torch.einsum("bqkgd,bskd->bkgqs", qg[..., i * c:(i + 1) * c].float(),
                              k[..., i * c:(i + 1) * c].float()) for i in range(n)]
        return real[6](q, k, v, hd_split=_Summed(sum(parts[1:], parts[0])), **kw)

    def mlp(x, wi_gate, wi_up, wo):
        if wo.shape[0] % n:
            return real[1](x, wi_gate, wi_up, wo)
        h = torch.nn.functional.silu((x @ wi_gate).float()).to(x.dtype) * (x @ wi_up)
        return split(h, wo)

    def identity_wo(p: dict) -> dict:
        """``p`` with an identity out-projection: the mixer's own output,
        exactly (each product adds one term and zeros)."""
        d = p["wo"].shape[0]
        return {**p, "wo": torch.eye(d, dtype=p["wo"].dtype, device=p["wo"].device)}

    def gelu(x, wi, bi, wo, bo):
        if wo.shape[0] % n:
            return real[5](x, wi, bi, wo, bo)
        return split(layers._gelu_tanh(x @ wi + bi).to(x.dtype), wo) + bo

    def head(self, params, h, tp=None):
        if self.cfg.vocab % n == 0 or self.cfg.d_model % n:
            return real[4](self, params, h, tp)
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return split(self._final_norm(params, h), w)

    real = (lm.LM._out_proj, lm.swiglu_mlp, ssd.mamba2_mixer, ssd.mamba2_decode_step,
            lm.LM._head, lm.gelu_mlp, lm.gqa_attention)

    def mixer(p, x, cfg, tp=None, **kw):
        if cfg.ssm_heads % n:
            return real[2](p, x, cfg, tp, **kw)
        return split(real[2](identity_wo(p), x, cfg, tp, **kw), p["wo"])

    def step(p, x, conv, state, cfg, tp=None):
        if cfg.ssm_heads % n:
            return real[3](p, x, conv, state, cfg, tp)
        y, conv, state = real[3](identity_wo(p), x, conv, state, cfg, tp)
        return split(y, p["wo"]), conv, state

    patched = (out_proj, mlp, mixer, step, head, gelu, gqa)

    def install(fns: tuple) -> None:
        (lm.LM._out_proj, lm.swiglu_mlp, ssd.mamba2_mixer, ssd.mamba2_decode_step, lm.LM._head,
         lm.gelu_mlp, lm.gqa_attention) = fns

    install(patched)
    try:
        yield
    finally:
        install(real)


class _Sequence:
    """The sequence ranks' exchanges of the Mamba2 mixer (``MeshCtx.halo``,
    ``relay_in``, ``relay_out``) for one device that runs the ranks' blocks
    one after another, in sequence order: each block's halo is the previous
    block's last rows (zeros for the first), its entering state the state
    the previous block ended with."""

    def __init__(self, n_batch: int):
        self.n_batch, self.tail, self.state = n_batch, None, None

    def halo(self, x: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
        tail = x.narrow(dim, x.shape[dim] - k, k)
        before = torch.zeros_like(tail) if self.tail is None else self.tail
        self.tail = tail
        return before

    def relay_in(self, start: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
        return start if self.state is None else self.state

    def relay_out(self, state: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self.state = state
        return y


@contextlib.contextmanager
def tp_rows(cfg, n_seq: int, n_model: int = 1):
    """While active, the prefill of ``cfg`` runs each product over the
    sequence's rows on the contiguous blocks of rows that the ranks of a
    sequence-sharded mesh hold, each block a contiguous copy, one after
    another: ``n_seq`` blocks (a sequence rank's) for what a rank runs on
    its sequence rank's block (the K/V projections, Megatron-SP's
    gathered products, the GELU MLP), ``n_seq * n_model`` (a rank's rows)
    for what it runs on its own rows (the RMS and layer norms of the hidden state,
    and where the fallback layouts run: the query projection, the flash
    kernel's queries at their offsets and the out-projection of a
    head_dim-sharded attention, a replicated MLP). The Mamba2 mixer runs
    whole on each sequence rank's block, its halo and relay handed on from
    the previous block (``_Sequence``). A cross-attention's keys and values
    are projected from the encoder's whole output, as every rank projects
    them. In f32, cuBLAS may pick
    another algorithm for a block's shape, whose sums differ in the last
    bit, which ``tp_rounding`` and ``tp_columns`` (the column blocks) do
    not model: entered inside them, it makes the unsharded prefill compute
    as the ranks compute it. A product over one row (the decode's, the
    head's) runs as it is. Each patch wraps what is installed when it is
    entered."""
    from repro_torch.models import lm, ssd

    coarse, fine = n_seq, n_seq * n_model
    hd_fb = n_model > 1 and cfg.family != "ssm" and cfg.n_heads % n_model != 0
    ffn_fb = n_model > 1 and cfg.family != "ssm" and cfg.d_ff % n_model != 0

    def blocks(x: torch.Tensor, n: int, dim: int = 1) -> list[torch.Tensor] | None:
        """x's n contiguous blocks along ``dim`` (copies), or None where it
        has one row or does not split."""
        if x.ndim < 3 or x.shape[dim] == 1 or x.shape[dim] % n:
            return None
        return [b.contiguous() for b in x.chunk(n, dim=dim)]

    def by_rows(fn, x: torch.Tensor, n: int, *rest, dim: int = 1):
        parts = blocks(x, n, dim)
        return fn(x, *rest) if parts is None else torch.cat([fn(b, *rest) for b in parts], dim)

    query = [None]  # the weight of the query projection being made
    # whether its keys and values come from a whole sequence of their own (a
    # cross-attention's: every rank projects the encoder's gathered output)
    whole_kv = [False]

    def qkv(self, lp, x, cos, sin, kv=None, *a, **k):
        query[0], whole_kv[0] = lp["wq"], kv is not None and not hd_fb
        try:
            return real["qkv"](self, lp, x, cos, sin, kv, *a, **k)
        finally:
            query[0], whole_kv[0] = None, False

    def proj(x, w):
        if whole_kv[0] and w is not query[0]:
            return real["proj"](x, w)
        return by_rows(real["proj"], x, fine if hd_fb and w is query[0] else coarse, w)

    def out_proj(self, lp, o):
        return by_rows(lambda b: real["out_proj"](self, lp, b), o, fine if hd_fb else coarse)

    def mlp(x, *w):
        return by_rows(real["mlp"], x, fine if ffn_fb else coarse, *w)

    def norm(x, w, eps=1e-6):
        return by_rows(real["norm"], x, fine, w, eps)

    def layer_norm(x, w, b, eps=1e-6):
        return by_rows(real["layer_norm"], x, fine, w, b, eps)

    def gelu(x, *w):
        return by_rows(real["gelu"], x, fine if ffn_fb else coarse, *w)

    def flash(q, k, v, *, q_offset: int = 0, **kw):
        parts = blocks(q, fine if hd_fb else coarse, dim=2)
        if parts is None:
            return real["flash"](q, k, v, q_offset=q_offset, **kw)
        rows = parts[0].shape[2]
        return torch.cat([real["flash"](b, k, v, q_offset=q_offset + i * rows, **kw)
                          for i, b in enumerate(parts)], dim=2)

    def mixer(p, x, cfg_, tp=None, sp=None):
        parts = blocks(x, coarse) if sp is None else None
        if parts is None:
            return real["mixer"](p, x, cfg_, tp, sp=sp)
        seq = _Sequence(coarse)
        return torch.cat([real["mixer"](p, b, cfg_, tp, sp=seq) for b in parts], dim=1)

    targets = {"qkv": (lm.LM, "_qkv", qkv), "proj": (lm, "_proj", proj),
               "out_proj": (lm.LM, "_out_proj", out_proj), "mlp": (lm, "swiglu_mlp", mlp),
               "norm": (lm, "rms_norm", norm), "layer_norm": (lm, "layer_norm", layer_norm),
               "gelu": (lm, "gelu_mlp", gelu), "flash": (lm, "flash_attention", flash),
               "mixer": (ssd, "mamba2_mixer", mixer)}
    real = {k: getattr(owner, name) for k, (owner, name, _) in targets.items()}
    for owner, name, fn in targets.values():
        setattr(owner, name, fn)
    try:
        yield
    finally:
        for k, (owner, name, _) in targets.items():
            setattr(owner, name, real[k])
