"""Layer library of the dense LM family: norms, RoPE, GQA attention, MLP.

Plain PyTorch copies of the reference's ``repro.models.layers``, with its
conventions: activations bf16, reductions, softmax and norms in f32. Weight
trees are nested dicts of tensors; stacked-layer weights carry a leading L
axis. ``mrope_cos_sin``, ``gelu_mlp`` and ``moe_layer`` are not ported yet.
"""
from __future__ import annotations

import math

import torch

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
                  window: int | None = None,
                  score_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, hd); k/v (B, Sk, KV, hd).

    The reference's jnp attention, with its score chain in ``score_dtype``
    (bf16): the score product is rounded to bf16, max and exp run in bf16,
    and only the softmax denominator sums in f32. The port's decode path
    uses it; the prefill uses the flash kernel (f32 scores) instead."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    # the scale rounded to score_dtype, kept as a Python float: no host-to-
    # device copy (and no stream sync) per call
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32).to(score_dtype))
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()).to(score_dtype)
    bias = _mask_bias(q_pos, k_pos, window, causal).to(score_dtype)
    s = s * scale + bias
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    w = e / den.to(score_dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.float(), v.float())
    return out.to(q.dtype).reshape(B, Sq, H, hd)


# ------------------------------------------------------------------ MLP
def swiglu_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    g = x @ wi_gate
    u = x @ wi_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ wo


# ----------------------------------------------------------- init helpers
def dense_init(generator: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal weights with std ``1/sqrt(fan_in)`` (fan-in: ``shape[-2]``),
    drawn in f32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return (out * s).to(dtype)
