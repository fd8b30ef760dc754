"""Layer library of the LM families: norms, RoPE (and Qwen2-VL's M-RoPE),
GQA attention, MLPs (SwiGLU, Whisper's GELU), top-k MoE.

Plain PyTorch copies of the reference's ``repro.models.layers``, with its
conventions: activations bf16, reductions, softmax and norms in f32. Weight
trees are nested dicts of tensors; stacked-layer weights carry a leading L
axis. With a ``MeshCtx`` whose "model" axis is larger than 1 (``ctx``),
``moe_layer`` runs the reference's expert-parallel branch,
``expand_kv_to_local_heads`` is its attention's KV-to-heads expansion, each
on this rank's blocks, ``gqa_attention(hd_split=)`` attends on the
rank's block of head_dim, and ``gqa_attention(seq_split=)`` on the rank's
block of a cache whose sequence is sharded over the batch axes.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import TYPE_CHECKING, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

if TYPE_CHECKING:
    from repro_torch.models.sharding import MeshCtx

NEG = -1e30


def dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm scaled by ``1 + w`` (1-D weights start at 0)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return ((x32 * inv) * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_cos_sin(positions: torch.Tensor, n_freq: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin (..., S, n_freq) f32."""
    exps = torch.arange(n_freq, dtype=torch.float32, device=positions.device) / n_freq
    freqs = 1.0 / (float(theta) ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, sections: tuple[int, ...],
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's M-RoPE: positions (3, B, S) int, the temporal, height and
    width streams -> cos/sin (B, S, sum(sections)) f32. The frequency slots
    are split into ``sections``; slot group g takes its angle from stream g."""
    n_freq = sum(sections)
    exps = torch.arange(n_freq, dtype=torch.float32, device=positions.device) / n_freq
    freqs = 1.0 / (float(theta) ** exps)
    ang_all = positions.float()[..., None] * freqs  # (3, B, S, n_freq)
    bounds = [0, *itertools.accumulate(sections)]
    ang = torch.cat([ang_all[g, ..., bounds[g]:bounds[g + 1]] for g in range(len(sections))],
                    dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd_rot/2). Half-split (LLaMA) style.
    ``fraction < 1`` (chatglm3): rotate only the first ``hd * fraction``
    dims and pass the rest through."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    half = rot // 2
    x1, x2 = x[..., :half].float(), x[..., half:rot].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rot < hd:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


# ------------------------------------------------------------- attention
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None,
               causal: bool) -> torch.Tensor:
    """Additive f32 bias (Sq, Sk): 0 where attendable, -1e30 elsewhere."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, 0.0, NEG).float()


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
                  window: int | None = None, q_chunk: int = 1024,
                  score_dtype: torch.dtype = torch.bfloat16,
                  hd_split: "MeshCtx | None" = None,
                  seq_split: "MeshCtx | None" = None) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, hd); k/v (B, Sk, KV, hd).

    The reference's jnp attention, with its score chain in ``score_dtype``
    (bf16): the score product is rounded to bf16, max and exp run in bf16,
    and only the softmax denominator sums in f32. The port's decode step and
    its training stack use it; the prefill uses the flash kernel (f32 scores)
    instead.

    Above ``q_chunk`` queries (``Sq`` a multiple of it) the chain runs chunk
    by chunk, each chunk under ``torch.utils.checkpoint``: the score buffers
    are bounded to (B, KV, G, q_chunk, Sk) and recomputed in the backward,
    as the reference's ``jax.checkpoint(nothing_saveable)`` over ``lax.map``
    does.

    With ``hd_split`` (a ``MeshCtx``) q, k and v hold this rank's block of
    head_dim (the decode over a head_dim-sharded cache, the reference's
    fallback layout where neither the heads nor the KV heads divide
    "model"): each rank's f32 partial scores are summed over "model" and
    rounded to ``score_dtype`` once, as the reference's single product
    rounds them, the scale is that of the whole head_dim, and the output is
    the rank's block of head_dim.

    With ``seq_split`` (a ``MeshCtx``) k and v hold this rank's block of
    the keys, the sequence sharded over the batch axes (the decode over a
    sequence-sharded cache; ``k_pos`` their global positions): each rank
    scores its own keys in the same chain; the row max is the max over the
    batch axes (exact), so that every rank's bf16 ``exp(s - m)`` rounds as
    the unsharded chain's does; the f32 denominator is the sum of the ranks'
    partial sums, ``w = e / den`` is taken in bf16, and ``w . v`` is summed
    in f32 over each rank's keys, then over the ranks, and rounded once
    (``MeshCtx.seq_sum``: in sequence order). A rank whose keys are all
    masked adds exactly 0.

    Both together (the head_dim fallback on a sequence-sharded cache: a
    rank holds its head_dim block of its block of the keys), in this fixed
    order: the f32 partial scores summed over "model" and rounded once, the
    row max over the batch axes, the f32 denominator and ``w . v`` summed
    over the batch axes in sequence order; the output is the rank's
    head_dim block, whose out-projection the caller sums over "model"."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    # the scale rounded to score_dtype, kept as a Python float: no host-to-
    # device copy (and no stream sync) per call
    whole_hd = hd * (hd_split.n_model if hd_split is not None else 1)
    scale = _rounded(1.0 / math.sqrt(whole_hd), score_dtype)

    def attend(q_blk: torch.Tensor, qp_blk: torch.Tensor) -> torch.Tensor:
        # q_blk (B, Sc, KV, G, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), k.float())
        if hd_split is not None:
            s = hd_split.psum_model(s)
        s = s.to(score_dtype)
        bias = _mask_bias(qp_blk, k_pos, window, causal).to(score_dtype)
        s = s * scale + bias
        m = s.amax(dim=-1, keepdim=True)
        if seq_split is not None:
            m = seq_split.all_reduce(m.float(), seq_split.batch_axes, "max").to(m.dtype)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
        if seq_split is not None:
            den = seq_split.seq_sum(den)
        w = e / den.to(score_dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", w.float(), v.float())
        if seq_split is not None:
            out = seq_split.seq_sum(out)
        return out.to(q.dtype)

    qg = q.reshape(B, Sq, KV, G, hd)
    if Sq <= q_chunk:
        out = attend(qg, q_pos)
    else:
        if Sq % q_chunk:
            raise ValueError(f"{Sq} queries are not a multiple of q_chunk={q_chunk}")
        out = torch.cat([checkpoint(attend, qg[:, i:i + q_chunk], q_pos[i:i + q_chunk],
                                    use_reentrant=False)
                         for i in range(0, Sq, q_chunk)], dim=1)
    return out.reshape(B, Sq, H, hd)


def expand_kv_to_local_heads(k: torch.Tensor, v: torch.Tensor, heads: int,
                             ctx: "MeshCtx") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's KV-to-heads expansion (``gqa_attention``'s ctx
    branch, where the KV heads do not divide "model" and the heads do), on
    this rank's heads: k/v (B, S, KV, hd) hold every KV head, the rank's
    query heads are the ``heads`` from ``model_rank * heads``; returns k/v
    (B, S, heads, hd), query head j reading the KV head of its global index
    (``jnp.repeat(k, H // KV, axis=2)`` cut to the rank's heads)."""
    G = heads * ctx.n_model // k.shape[2]
    idx = (ctx.model_rank * heads + torch.arange(heads, device=k.device)) // G
    return k[:, :, idx], v[:, :, idx]


# ------------------------------------------------------------------ MLP
def swiglu_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    g = x @ wi_gate
    u = x @ wi_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ wo


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor, wo: torch.Tensor,
             bo: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: tanh-approximate GELU of ``x @ wi + bi``, then ``@ wo +
    bo``, in x's dtype (``_gelu_tanh``)."""
    h = _gelu_tanh(x @ wi + bi)
    return h.to(x.dtype) @ wo + bo


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` op by op in x's dtype, its
    constants rounded to that dtype as jax rounds them:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``. In bf16
    this rounds where the reference does (every output equal to the
    reference's on 200k values of std 3, either compile);
    ``F.gelu(approximate="tanh")`` computes in f32 and rounds once, which
    differs in 43 % of them."""
    inner = x + _rounded(0.044715, x.dtype) * (x * x * x)
    return x * (0.5 * (1 + torch.tanh(_rounded(math.sqrt(2 / math.pi), x.dtype) * inner)))


@functools.lru_cache
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (through f32), as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


# ------------------------------------------------------------------ MoE
class Route(NamedTuple):
    """One block of tokens' routing (``_route``): T tokens, E experts, top K,
    capacity C. The T*K (token, choice) assignments are sorted by expert,
    stably; ``se``, ``st``, ``sw`` are the sorted assignments' expert,
    token and renormalised gate; ``slot`` is each one's row of the
    (E*C + 1)-row buffer, the last row (E*C) the drop bin, and ``keep``
    says which fit under the capacity."""
    probs: torch.Tensor      # (T, E) f32 router softmax
    se: torch.Tensor         # (T*K,) int64
    st: torch.Tensor         # (T*K,) int64
    sw: torch.Tensor         # (T*K,) f32
    slot: torch.Tensor       # (T*K,) int64
    keep: torch.Tensor       # (T*K,) bool
    me: torch.Tensor         # (E,) f32 mean router probability
    ce: torch.Tensor         # (E,) f32 share of the assignments


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, equal values lower index first. A stable descending sort gives
    that order on every device; ``torch.topk`` does not promise it."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt: torch.Tensor, wr: torch.Tensor, *, top_k: int, capacity: int) -> Route:
    """The reference's sort-based routing of a flat token block xt (T, D)
    over wr (D, E): f32 router logits and softmax, top-k, the gates
    renormalised (``+ 1e-9``), a stable sort of the assignments by expert,
    each group's start by ``searchsorted``, and capacity C per expert
    (``pos < C``; the rest go to the drop bin E*C). Every step is a sort, a
    gather or elementwise: nothing depends on the order of an atomic."""
    T = xt.shape[0]
    E = wr.shape[1]
    C = capacity
    logits = xt.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    me = probs.mean(dim=0)
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // top_k                 # the token of flat assignment t*K + k
    sw = gate_vals.reshape(-1)[order]
    bounds = torch.searchsorted(se, torch.arange(E + 1, dtype=se.dtype, device=se.device),
                                side="left")
    # each expert's assignments, a count: the reference's scatter-add of
    # ones, exact in f32 either way
    ce = (bounds[1:] - bounds[:-1]).float() / (T * top_k)
    pos = torch.arange(T * top_k, device=se.device) - bounds[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    return Route(probs, se, st, sw, slot, keep, me, ce)


def _combine(contrib: torch.Tensor, token: torch.Tensor, expert: torch.Tensor, T: int,
             E: int) -> torch.Tensor:
    """y (T, D): each token's K contributions (rows of ``contrib``, with
    their ``token`` and ``expert``) added in its dtype one at a time, in
    ascending expert order, from zero. These are the reference's roundings:
    its scatter-add ``zeros.at[st].add(contrib)`` over the expert-sorted
    assignments adds a token's contributions in that order. The rows are
    first put in (token, expert) order by a sort of unique keys, so the
    result does not depend on the order of the rows, and nothing is summed
    by atomics (``index_add_`` on the card adds bf16 in no fixed order)."""
    D = contrib.shape[1]
    idx = torch.argsort(token * E + expert)
    parts = contrib[idx].reshape(T, -1, D)
    y = torch.zeros((T, D), dtype=contrib.dtype, device=contrib.device)
    for k in range(parts.shape[1]):
        y = y + parts[:, k]
    return y


def _moe_tokens(xt: torch.Tensor, wr: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, *, top_k: int,
                capacity: int) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The reference's ``_moe_tokens``: sort-based dispatch over a flat token
    block xt (T, D) bf16. Routes (``_route``), copies each kept assignment's
    token into its row of an (E, C, D) buffer, runs the three expert
    products as batched matmuls over E (silu in f32, cast back), gathers
    each assignment's output row (the drop bin's is zero), scales it by its
    gate in bf16 and adds each token's contributions (``_combine``).
    Returns (y (T, D), (me, ce)) for the auxiliary loss."""
    T, D = xt.shape
    E = wr.shape[1]
    C = capacity
    r = _route(xt, wr, top_k=top_k, capacity=C)
    yb = _experts(_dispatch(xt, r, E * C).reshape(E, C, D), w_gate, w_up, w_down)
    return _combine(_contrib(yb.reshape(E * C, D), r, xt.dtype), r.st, r.se, T, E), (r.me, r.ce)


def _dispatch(xt: torch.Tensor, r: Route, rows: int) -> torch.Tensor:
    """The (rows, D) buffer, E*C rows: each kept assignment's token in its
    slot, zeros elsewhere."""
    buf = torch.zeros((rows + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf[r.slot] = xt[r.st]   # rows are unique but for the drop bin, which is discarded
    return buf[:-1]


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The three expert products over buf (E, C, D), batched over E (silu in
    f32, cast back)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down)


def _contrib(yb: torch.Tensor, r: Route, dtype: torch.dtype) -> torch.Tensor:
    """Each assignment's output row of yb (E*C, D) (the drop bin's is zero),
    scaled by its gate in ``dtype``."""
    ybf = torch.cat([yb, yb.new_zeros((1, yb.shape[1]))])
    contrib = ybf[r.slot] * r.sw[:, None].to(dtype)
    return torch.where(r.keep[:, None], contrib, 0)


def _capacity(T: int, top_k: int, E: int, cf: float) -> int:
    """Slots per expert: ceil(T*K/E * cf), rounded up to a multiple of 8,
    at least 8 (the reference's ``_capacity``)."""
    C = int(math.ceil(T * top_k / E * cf))
    return max(8, -(-C // 8) * 8)


def moe_layer(x: torch.Tensor, wr: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, *, top_k: int, capacity_factor: float,
              ctx: "MeshCtx | None" = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity and dropping (GShard-style), the reference's
    ``moe_layer``: x (B, S, D); wr (D, E); w_gate/w_up (E, D, F); w_down (E,
    F, D). Returns (y (B, S, D), aux = E * sum(me * ce)).

    Without ``ctx`` the whole-array form (on a (..., model=1) mesh each rank
    calls it on its own tokens, which is what the expert-parallel branch
    computes there). With ``ctx`` ("model" > 1) the expert weights are this
    rank's E/n experts and x its tokens: for S > 1 the expert-parallel
    branch (``_moe_expert_parallel``), for S == 1 (decode, x the same on
    every rank of the model group) the whole-array routing with each rank
    applying its own experts (``_moe_decode_sharded``)."""
    B, S, D = x.shape
    E = wr.shape[1]
    C = _capacity(B * S, top_k, E, capacity_factor)
    xt = x.reshape(B * S, D)
    if ctx is None:
        y, (me, ce) = _moe_tokens(xt, wr, w_gate, w_up, w_down, top_k=top_k, capacity=C)
        return y.reshape(B, S, D), E * torch.sum(me * ce)
    r = _route(xt, wr, top_k=top_k, capacity=C)
    if S == 1:
        y = _moe_decode_sharded(xt, r, w_gate, w_up, w_down, E, C, ctx)
        return y.reshape(B, S, D), E * torch.sum(r.me * r.ce)
    y = _moe_expert_parallel(xt, r, w_gate, w_up, w_down, E, C, ctx)
    return y.reshape(B, S, D), ctx.pmean_all(E * torch.sum(r.me * r.ce))


def _moe_expert_parallel(xt: torch.Tensor, r: Route, w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, E: int, C: int, ctx: "MeshCtx") -> torch.Tensor:
    """The reference's expert-parallel branch on this rank's T_loc tokens,
    routed here with C from T_loc: the (E*C, D) buffer's block of each
    rank's experts is sent to it by an all-to-all over "model", the experts
    run on what this rank received, and a second all-to-all sends the
    outputs back for the combine, in the reference's order. The received
    blocks (one per sending rank, each (E/n, C, D)) are read as (E/n, n*C,
    D) by a plain reshape, as the reference's ``recv.reshape`` reads them:
    for n > 1 that hands a row to a local expert by its place in the
    concatenation, not by the expert it was routed to (ROADMAP C). The port
    keeps it, so that it computes the reference's sharded step."""
    D = xt.shape[1]
    E_loc, n = w_gate.shape[0], ctx.n_model
    recv = ctx.all_to_all_model(_dispatch(xt, r, E * C))
    yb = _experts(recv.reshape(E_loc, n * C, D), w_gate, w_up, w_down)
    back = ctx.all_to_all_model(yb.reshape(E * C, D))
    return _combine(_contrib(back, r, xt.dtype), r.st, r.se, xt.shape[0], E)


def _moe_decode_sharded(xt: torch.Tensor, r: Route, w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor, E: int, C: int, ctx: "MeshCtx") -> torch.Tensor:
    """The whole-array form with the experts over "model": every rank routes
    the same tokens, runs its own E/n experts' slots of the buffer, and
    fills the contributions of its experts' assignments; their sum over
    "model" (each row from the one rank that holds its expert: exact) goes
    to the combine, as the whole-array form's would."""
    D = xt.shape[1]
    E_loc = w_gate.shape[0]
    mine = slice(ctx.model_rank * E_loc * C, (ctx.model_rank + 1) * E_loc * C)
    yb = xt.new_zeros((E * C, D))
    yb[mine] = _experts(_dispatch(xt, r, E * C)[mine].reshape(E_loc, C, D), w_gate, w_up,
                        w_down).reshape(-1, D)
    contrib = ctx.psum_model(_contrib(yb, r, xt.dtype))
    return _combine(contrib, r.st, r.se, xt.shape[0], E)


# ----------------------------------------------------------- init helpers
def dense_init(generator: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal weights with std ``1/sqrt(fan_in)`` (fan-in: ``shape[-2]``),
    drawn in f32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return out.mul_(s).to(dtype)
