"""The LM of the dense family (pre-norm GQA attention + SwiGLU MLP).

The port of the reference's ``repro.models.lm.LM`` for ``family="dense"``,
with the options its dense block carries: QKV bias (qwen2), qk-norm
(qwen3), sliding-window layers with a global layer every
``global_every`` (gemma3) and partial RoPE (chatglm3).

Parameters are a nested dict of tensors with the reference's names and
shapes, stacked layers included (leading L axis); every method takes them
explicitly, as the reference's do. ``load_params`` also registers them on
the module. The prefill (``_run_decoder_stack``) runs a Python loop over
the layers and computes each layer's attention with the flash-attention
kernel (f32 scores; one launch per layer on the card). The decode step
writes the new K/V into the cache in place and attends with the plain
``gqa_attention`` (bf16 score chain), as the reference does: its query sits
at ``cur_len`` against an S-long cache, which the kernel's positions (both
from 0) cannot express.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    dt,
    gqa_attention,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)

Params = dict[str, Any]  # name -> tensor, or name -> dict of stacked-layer tensors

_NOT_PORTED = {
    "moe": "the MoE family waits for moe_layer (ROADMAP A9)",
    "ssm": "the SSM family waits for models/ssd.py (ROADMAP A9)",
    "hybrid": "the hybrid family waits for models/ssd.py (ROADMAP A9)",
    "encdec": "the encoder-decoder family waits for its stack (ROADMAP A9)",
    "vlm": "the VLM family waits for mrope and embeddings input (ROADMAP A9)",
}


def _leaves(tree: dict, prefix: str = ""):
    for name in sorted(tree):
        value = tree[name]
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, max_pos: int = 4096, device: str = "cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {_NOT_PORTED.get(cfg.family, f'unknown family {cfg.family!r}')}")
        self.cfg = cfg
        self.max_pos = max_pos
        self.device = resolve_device(device)

    # ------------------------------------------------------------- template
    def param_template(self) -> dict:
        """Nested dict of (shape, dtype), the reference's tree for the dense
        family."""
        cfg = self.cfg
        bf, f32 = dt(cfg), torch.float32
        L, D, H, KV, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.d_ff)
        blk = {"wq": ((L, D, H, hd), bf), "wk": ((L, D, KV, hd), bf),
               "wv": ((L, D, KV, hd), bf), "wo": ((L, H, hd, D), bf),
               "ln1": ((L, D), f32), "ln2": ((L, D), f32),
               "wg": ((L, D, F), bf), "wu": ((L, D, F), bf), "wd": ((L, F, D), bf)}
        if cfg.qkv_bias:
            blk.update({"bq": ((L, H, hd), bf), "bk": ((L, KV, hd), bf),
                        "bv": ((L, KV, hd), bf)})
        if cfg.qk_norm:
            blk.update({"qn": ((L, hd), bf), "kn": ((L, hd), bf)})
        t: dict = {"final_ln": ((D,), f32), "layers": blk, "embed": ((cfg.vocab, D), bf)}
        if not cfg.tie_embeddings:
            t["head"] = ((D, cfg.vocab), bf)
        return t

    def n_params(self) -> int:
        return sum(math.prod(shape) for _, (shape, _) in _leaves(self.param_template()))

    def init_params(self, generator: torch.Generator) -> Params:
        """Random parameters by the reference's rule: zeros for 1-D leaves
        (norm weights scale by ``1 + w``), ``dense_init`` otherwise. Leaves
        are drawn in sorted-name order from ``generator`` (on its device)
        and moved to the model's device."""
        out: Params = {}
        for name, (shape, dtype) in _leaves(self.param_template()):
            if len(shape) == 1:
                value = torch.zeros(shape, dtype=dtype)
            else:
                value = dense_init(generator, shape, dtype)
            node = out
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value.to(self.device)
        return out

    def load_params(self, params: Params) -> Params:
        """Register ``params`` (moved to the model's device) on the module;
        returns them as the nested dict every method takes."""
        def register(module: nn.Module, tree: dict) -> dict:
            out = {}
            for name, value in tree.items():
                if isinstance(value, dict):
                    child = nn.Module()
                    module.add_module(name, child)
                    out[name] = register(child, value)
                else:
                    p = nn.Parameter(value.to(self.device), requires_grad=False)
                    module.register_parameter(name, p)
                    out[name] = p
            return out

        return register(self, params)

    # ------------------------------------------------------------- forward
    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n_freq = int(cfg.hd * cfg.rope_fraction) // 2
        return rope_cos_sin(positions, n_freq, cfg.rope_theta)

    def _windows(self, S: int) -> list[int]:
        """Each layer's attention window: ``sliding_window`` on local
        layers, S + 1 (no limit) on global ones."""
        cfg = self.cfg
        if not cfg.global_every:
            return [S + 1] * cfg.n_layers
        return [S + 1 if i % cfg.global_every == cfg.global_every - 1 else cfg.sliding_window
                for i in range(cfg.n_layers)]

    def _qkv(self, lp: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """Projections, bias, qk-norm and RoPE: q (B,S,H,hd), k/v (B,S,KV,hd)."""
        cfg = self.cfg
        B, S, D = x.shape
        flat = x.reshape(B * S, D)
        q = (flat @ lp["wq"].reshape(D, -1)).reshape(B, S, cfg.n_heads, cfg.hd)
        k = (flat @ lp["wk"].reshape(D, -1)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = (flat @ lp["wv"].reshape(D, -1)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.qk_norm:
            q = rms_norm(q, lp["qn"], cfg.norm_eps)
            k = rms_norm(k, lp["kn"], cfg.norm_eps)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
        return q, k, v

    def _out_proj(self, lp: dict, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return (o.reshape(B * S, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)).reshape(B, S, -1)

    def _attn(self, lp: dict, x: torch.Tensor, *, cos, sin, window: int) -> torch.Tensor:
        q, k, v = self._qkv(lp, x, cos, sin)
        o = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=True, window=window)
        return self._out_proj(lp, o.transpose(1, 2))

    def _dense_block(self, lp: dict, h: torch.Tensor, *, cos, sin, window: int) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        h = h + self._attn(lp, x, cos=cos, sin=sin, window=window)
        x2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
        return h + swiglu_mlp(x2, lp["wg"], lp["wu"], lp["wd"])

    def _run_decoder_stack(self, params: Params, h: torch.Tensor, *,
                           positions: torch.Tensor) -> torch.Tensor:
        """The prefill's layer stack: h (B, S, D) bf16, positions (B, S).
        Query and key positions are ``positions[0]``, which the flash
        kernel takes to be 0..S-1."""
        S = h.shape[1]
        cos, sin = self._rope(positions)
        layers = params["layers"]
        for i, window in enumerate(self._windows(S)):
            lp = {name: w[i] for name, w in layers.items()}
            h = self._dense_block(lp, h, cos=cos, sin=sin, window=window)
        return h

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["head"]

    # ------------------------------------------------------------- serving
    def cache_template(self, B: int, S: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}

    def init_cache(self, B: int, S: int) -> dict[str, torch.Tensor]:
        """A zero cache of ``cache_template(B, S)`` on the model's device."""
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.cache_template(B, S).items()}

    def decode_step(self, params: Params, cache: dict[str, torch.Tensor],
                    batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One token for the whole batch against an S-long cache.

        batch: {"token": (B,) int, "cur_len": int}. Writes the new K/V at
        ``cur_len`` into ``cache`` in place (the reference returns a new
        cache; updating in place spares a copy of the whole cache per token)
        and returns (logits (B, V) f32, cache)."""
        cur = int(batch["cur_len"])
        S = cache["k"].shape[2]
        if not 0 <= cur < S:
            raise ValueError(f"cur_len {cur} outside the {S}-long cache")
        x = params["embed"][batch["token"]].to(torch.bfloat16)
        h = self._decode_dense(params, cache, x[:, None, :], cur)
        return self._head(params, h)[:, 0].float(), cache

    def _decode_attn(self, lp: dict, h: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur: int, *, window: int, pos1: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        S = k_cache.shape[1]  # the per-layer cache is (B, S, KV, hd)
        q, k_new, v_new = self._qkv(lp, h, cos, sin)
        k_cache[:, cur] = k_new[:, 0]
        v_cache[:, cur] = v_new[:, 0]
        k_pos = torch.arange(S, dtype=torch.int32, device=h.device)
        o = gqa_attention(q, k_cache, v_cache, q_pos=pos1, k_pos=k_pos, causal=True,
                          window=window)
        return self._out_proj(lp, o)

    def _decode_dense(self, params: Params, cache: dict[str, torch.Tensor],
                      h: torch.Tensor, cur: int) -> torch.Tensor:
        cfg = self.cfg
        layers = params["layers"]
        # every layer rotates by the same position: compute its RoPE once
        pos1 = torch.full((1,), cur, dtype=torch.int32, device=h.device)
        cos, sin = self._rope(pos1[None].expand(h.shape[0], 1))
        for i, window in enumerate(self._windows(cache["k"].shape[2])):
            lp = {name: w[i] for name, w in layers.items()}
            x = rms_norm(h, lp["ln1"], cfg.norm_eps)
            h = h + self._decode_attn(lp, x, cache["k"][i], cache["v"][i], cur, window=window,
                                      pos1=pos1, cos=cos, sin=sin)
            x2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
            h = h + swiglu_mlp(x2, lp["wg"], lp["wu"], lp["wd"])
        return h
