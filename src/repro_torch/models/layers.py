"""Layer library of the LM families: norms, RoPE (and Qwen2-VL's M-RoPE),
GQA attention, MLPs (SwiGLU, Whisper's GELU), top-k MoE.

Plain PyTorch copies of the reference's ``repro.models.layers``, with its
conventions: activations bf16, reductions, softmax and norms in f32. Weight
trees are nested dicts of tensors; stacked-layer weights carry a leading L
axis. ``moe_layer``'s expert-parallel branch is not ported yet (ROADMAP A3).
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

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
                  score_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
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
    does."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    # the scale rounded to score_dtype, kept as a Python float: no host-to-
    # device copy (and no stream sync) per call
    scale = _rounded(1.0 / math.sqrt(hd), score_dtype)

    def attend(q_blk: torch.Tensor, qp_blk: torch.Tensor) -> torch.Tensor:
        # q_blk (B, Sc, KV, G, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), k.float()).to(score_dtype)
        bias = _mask_bias(qp_blk, k_pos, window, causal).to(score_dtype)
        s = s * scale + bias
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
        w = e / den.to(score_dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", w.float(), v.float())
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
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[r.slot] = xt[r.st]   # rows are unique but for the drop bin, which is discarded
    buf = buf[:-1].reshape(E, C, D)
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = torch.nn.functional.silu(g.float()).to(xt.dtype) * u
    yb = torch.bmm(h, w_down)
    ybf = torch.cat([yb.reshape(E * C, D), yb.new_zeros((1, D))])
    contrib = ybf[r.slot] * r.sw[:, None].to(xt.dtype)
    contrib = torch.where(r.keep[:, None], contrib, 0)
    return _combine(contrib, r.st, r.se, T, E), (r.me, r.ce)


def _capacity(T: int, top_k: int, E: int, cf: float) -> int:
    """Slots per expert: ceil(T*K/E * cf), rounded up to a multiple of 8,
    at least 8 (the reference's ``_capacity``)."""
    C = int(math.ceil(T * top_k / E * cf))
    return max(8, -(-C // 8) * 8)


def moe_layer(x: torch.Tensor, wr: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity and dropping (GShard-style), the reference's
    whole-array ``moe_layer``: x (B, S, D); wr (D, E); w_gate/w_up (E, D,
    F); w_down (E, F, D). Returns (y (B, S, D), aux = E * sum(me * ce)).
    The expert-parallel branch (``shard_map`` with all_to_all over the
    model axis) belongs to the mesh layer (ROADMAP A3): this takes no
    mesh."""
    B, S, D = x.shape
    E = wr.shape[1]
    C = _capacity(B * S, top_k, E, capacity_factor)
    y, (me, ce) = _moe_tokens(x.reshape(B * S, D), wr, w_gate, w_up, w_down, top_k=top_k,
                              capacity=C)
    return y.reshape(B, S, D), E * torch.sum(me * ce)


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
