"""The LM of the dense, MoE, SSM and hybrid families.

The port of the reference's ``repro.models.lm.LM`` for ``family="dense"``
(pre-norm GQA attention, then a SwiGLU MLP), with the options its dense
block carries: QKV bias (qwen2), qk-norm (qwen3), sliding-window layers
with a global layer every ``global_every`` (gemma3) and partial RoPE
(chatglm3); for ``family="moe"`` (olmoe, qwen3-moe), whose block swaps the
MLP for ``moe_layer`` (sort-based top-k dispatch with capacity drops);
for ``family="ssm"`` (mamba2), a stack of Mamba2 mixers
(``models/ssd.py``) with no attention; and for ``family="hybrid"``
(zamba2), groups of ``shared_attn_every`` Mamba2 layers, each followed by
the one shared attention + SwiGLU block (its weights reused), then the
trailing layers with none. The training loss of every family is the
reference's: cross-entropy, plus ``0.01`` times the MoE layers' summed
auxiliary loss, which serving drops.

Parameters are a nested dict of tensors with the reference's names and
shapes, stacked layers included (leading L axis); every method takes them
explicitly, as the reference's do. ``load_params`` also registers them on
the module. The layer stacks are Python loops over the layers. The prefill
computes each attention with the flash-attention kernel (f32 scores; one
launch per attention layer on the card, and per group for the hybrid). The
training loss (``loss_fn``) attends with the plain ``gqa_attention`` (bf16
score chain), as the reference's ``_attn`` does, since the kernel has no
backward, and runs each layer (each Mamba2 layer and each application of
the hybrid's shared block) under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint(nothing_saveable)`` over its
layer scans. The decode step writes the new K/V, conv windows and SSM
states into the cache in place and attends with ``gqa_attention`` too, as
the reference does: its query sits at ``cur_len`` against an S-long cache,
which the kernel's positions (both from 0) cannot express.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import ssd
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    dt,
    gqa_attention,
    moe_layer,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
from repro_torch.tree import named_leaves

Params = dict[str, Any]  # name -> tensor, or name -> dict of stacked-layer tensors

_NOT_PORTED = {
    "encdec": "the encoder-decoder family waits for its stack and gelu_mlp (ROADMAP A2)",
    "vlm": "the VLM family waits for mrope and embeddings input (ROADMAP A2)",
}

def _attn_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    """The attention's weights, each with the leading dims ``lead`` ((L,)
    for a stack, () for the hybrid's shared block)."""
    bf = dt(cfg)
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    out = {"wq": ((*lead, D, H, hd), bf), "wk": ((*lead, D, KV, hd), bf),
           "wv": ((*lead, D, KV, hd), bf), "wo": ((*lead, H, hd, D), bf)}
    if cfg.qkv_bias:
        out.update({"bq": ((*lead, H, hd), bf), "bk": ((*lead, KV, hd), bf),
                    "bv": ((*lead, KV, hd), bf)})
    if cfg.qk_norm:
        out.update({"qn": ((*lead, hd), bf), "kn": ((*lead, hd), bf)})
    return out


def _mlp_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    bf, D, F = dt(cfg), cfg.d_model, cfg.d_ff
    return {"wg": ((*lead, D, F), bf), "wu": ((*lead, D, F), bf), "wd": ((*lead, F, D), bf)}


def _norm_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    return {n: ((*lead, cfg.d_model), torch.float32) for n in ("ln1", "ln2")}


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, max_pos: int = 4096, device: str = "cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name}: {_NOT_PORTED.get(cfg.family, f'unknown family {cfg.family!r}')}")
        self.cfg = cfg
        self.max_pos = max_pos
        self.device = resolve_device(device)

    # ------------------------------------------------------------- template
    def param_template(self) -> dict:
        """Nested dict of (shape, dtype), the reference's tree. A dense block
        holds the attention and SwiGLU weights; a MoE block has the router
        ``wr`` (L, D, E) and the experts ``w_gate``/``w_up`` (L, E, D, F)
        and ``w_down`` (L, E, F, D) in place of ``wg``/``wu``/``wd``. The
        SSM family stacks ``mamba2_param_shapes`` and a norm ``ln``; the
        hybrid adds the one ``shared`` block (attention, SwiGLU MLP, ``ln1``,
        ``ln2``), unstacked."""
        cfg = self.cfg
        bf, f32 = dt(cfg), torch.float32
        L, D = cfg.n_layers, cfg.d_model
        t: dict = {"final_ln": ((D,), f32), "embed": ((cfg.vocab, D), bf)}
        if not cfg.tie_embeddings:
            t["head"] = ((D, cfg.vocab), bf)
        if cfg.is_ssm:
            blk = {k: ((L, *shape), dtype)
                   for k, (shape, dtype) in ssd.mamba2_param_shapes(cfg).items()}
            blk["ln"] = ((L, D), f32)
            t["layers"] = blk
            if cfg.family == "hybrid":
                t["shared"] = {**_attn_shapes(cfg, ()), **_mlp_shapes(cfg, ()),
                               **_norm_shapes(cfg, ())}
            return t
        blk = {**_attn_shapes(cfg, (L,)), **_norm_shapes(cfg, (L,))}
        if cfg.family == "moe":
            E, Fe = cfg.moe_experts, cfg.moe_d_ff
            blk.update({"wr": ((L, D, E), bf), "w_gate": ((L, E, D, Fe), bf),
                        "w_up": ((L, E, D, Fe), bf), "w_down": ((L, E, Fe, D), bf)})
        else:
            blk.update(_mlp_shapes(cfg, (L,)))
        t["layers"] = blk
        return t

    def n_params(self) -> int:
        return sum(math.prod(shape) for _, (shape, _) in named_leaves(self.param_template()))

    def n_active_params(self) -> int:
        """Parameters a token runs through: for MoE, top_k of the E experts."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.family != "moe":
            return total
        blk = self.param_template()["layers"]
        expert = sum(math.prod(blk[k][0]) for k in ("w_gate", "w_up", "w_down"))
        return total - expert + expert // cfg.moe_experts * cfg.moe_top_k

    def init_params(self, generator: torch.Generator) -> Params:
        """Random parameters by the reference's rule: zeros for 1-D leaves
        (norm weights scale by ``1 + w``), ``dense_init`` otherwise. Leaves
        are drawn in sorted-name order from ``generator`` (on its device)
        and moved to the model's device."""
        out: Params = {}
        for name, (shape, dtype) in named_leaves(self.param_template()):
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

    def _attn(self, lp: dict, x: torch.Tensor, *, cos, sin, window: int | None,
              train_pos: torch.Tensor | None) -> torch.Tensor:
        """The layer's attention: the flash kernel (``window`` 0 for none),
        or with ``train_pos`` (the query and key positions) the
        differentiable ``gqa_attention`` (``window`` None for none)."""
        q, k, v = self._qkv(lp, x, cos, sin)
        if train_pos is not None:
            o = gqa_attention(q, k, v, q_pos=train_pos, k_pos=train_pos, causal=True,
                              window=window, score_dtype=dt(self.cfg))
            return self._out_proj(lp, o)
        o = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=True, window=window)
        return self._out_proj(lp, o.transpose(1, 2))

    def _dense_block(self, lp: dict, h: torch.Tensor, *, cos, sin, window: int | None,
                     train_pos: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(h, the MLP's auxiliary loss: ``_mlp``)."""
        cfg = self.cfg
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        h = h + self._attn(lp, x, cos=cos, sin=sin, window=window, train_pos=train_pos)
        y, aux = self._mlp(lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        return h + y, aux

    def _mlp(self, lp: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The block's MLP and its auxiliary loss: SwiGLU (None), or for MoE
        ``moe_layer`` (aux = E * sum(me * ce), f32)."""
        cfg = self.cfg
        if cfg.family == "moe":
            return moe_layer(x, lp["wr"], lp["w_gate"], lp["w_up"], lp["w_down"],
                             top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        return swiglu_mlp(x, lp["wg"], lp["wu"], lp["wd"]), None

    def _mamba_layer(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        return h + ssd.mamba2_mixer(lp, rms_norm(h, lp["ln"], self.cfg.norm_eps), self.cfg)

    def _run_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                   train: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The family's layer stack over the embedded tokens h (B, S, D),
        positions (B, S): (h, the MoE layers' summed auxiliary loss, None
        for the other families)."""
        family = self.cfg.family
        if family == "ssm":
            return self._run_ssm_stack(params, h, train=train), None
        if family == "hybrid":
            return self._run_hybrid_stack(params, h, positions=positions, train=train), None
        return self._run_decoder_stack(params, h, positions=positions, train=train)

    def _run_decoder_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                           train: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layer stack: h (B, S, D) bf16, positions (B, S). Query and key
        positions are ``positions[0]``, which the flash kernel takes to be
        0..S-1. With ``train``, every layer attends with ``gqa_attention``
        and runs under ``torch.utils.checkpoint`` (its activations are
        recomputed in the backward). Returns (h, aux): the MoE layers'
        auxiliary losses added in layer order (the reference's f32 carry
        from 0), None for the dense family."""
        S = h.shape[1]
        cos, sin = self._rope(positions)
        train_pos = {"train_pos": positions[0]} if train else {}
        aux = None
        for lp, window in zip(_layers(params["layers"]), self._windows(S)):
            h, a = _checkpointed(self._dense_block, lp, h, train=train, cos=cos, sin=sin,
                                 window=window, **train_pos)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    def _run_ssm_stack(self, params: Params, h: torch.Tensor, *,
                       train: bool = False) -> torch.Tensor:
        """The SSM stack: h + mamba2_mixer(rms_norm(h)) for each layer; with
        ``train``, each layer under ``torch.utils.checkpoint``."""
        for lp in _layers(params["layers"]):
            h = _checkpointed(self._mamba_layer, lp, h, train=train)
        return h

    def _run_hybrid_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                          train: bool = False) -> torch.Tensor:
        """Zamba2: after every ``shared_attn_every`` Mamba2 layers, the one
        shared block (causal, unwindowed attention, then its SwiGLU MLP); the
        trailing ``n_layers mod shared_attn_every`` layers run with no shared
        block after them. The shared block attends with the flash kernel, or
        with ``train`` with ``gqa_attention``; then each Mamba2 layer and
        each application of the shared block runs under
        ``torch.utils.checkpoint`` (the reference checkpoints per group and
        per layer: the same numbers)."""
        cos, sin = self._rope(positions)
        E = self.cfg.shared_attn_every
        # "no window" is 0 for the flash kernel, None for gqa_attention (to
        # which 0 would mask every key)
        attn = dict(cos=cos, sin=sin, window=None, train_pos=positions[0]) if train else \
            dict(cos=cos, sin=sin, window=0)
        for i, lp in enumerate(_layers(params["layers"])):
            h = _checkpointed(self._mamba_layer, lp, h, train=train)
            if (i + 1) % E == 0:
                h, _ = _checkpointed(self._dense_block, params["shared"], h, train=train, **attn)
        return h

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["head"]

    # ------------------------------------------------------------- training
    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        """The training loss (f32 0-d) of ``batch`` = {"tokens", "labels"}
        (B, S) int: the reference's ``loss_fn`` with ``ctx=None``, the mean
        next-token cross-entropy, plus ``0.01 * aux`` for the MoE family (aux
        summed over its layers). The dense, SSM and hybrid families have no
        auxiliary loss and return the cross-entropy (the reference adds
        ``0.01 * 0``). The embedding's output and the attention's score
        chain take the configuration's dtype: bf16 for every configuration
        of the catalog, as in the reference. A ``dtype="float32"``
        configuration thus computes the whole step in f32 (the reference
        keeps both in bf16 there), which makes it a precise witness of a
        bf16 step from the same weights.

        The MoE forward is deterministic (stable sorts, no atomics), so the
        recompute in the backward routes exactly as the forward did."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = params["embed"][tokens].to(dt(self.cfg))
        positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
        h, aux = self._run_stack(params, h, positions=positions, train=True)
        ce = self._cross_entropy(params, h, batch["labels"])
        return ce if aux is None else ce + 0.01 * aux

    def _cross_entropy(self, params: Params, h: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
        """CE over the vocab from the full (B, S, V) f32 logits, as the
        reference's single-device form (its chunked form needs a mesh)."""
        logits = self._head(params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None].long())[..., 0]
        return (lse - ll).mean()

    # ------------------------------------------------------------- serving
    def cache_template(self, B: int, S: int) -> dict:
        """The decode cache's (shape, dtype), the reference's: K/V (L, B, S,
        KV, hd) bf16 for the attention families; for the SSM family each
        layer's conv window (L, B, K-1, conv_dim) bf16 and state (L, B, G,
        H, N, P) f32; the hybrid adds K/V of its shared block, one per
        group (n_groups, B, S, KV, hd)."""
        cfg = self.cfg
        bf = torch.bfloat16
        kv = (B, S, cfg.n_kv_heads, cfg.hd)
        L = cfg.n_layers
        if not cfg.is_ssm:
            return {"k": ((L, *kv), bf), "v": ((L, *kv), bf)}
        conv_dim = cfg.d_inner + 2 * ssd.G * cfg.ssm_state
        out = {"conv": ((L, B, cfg.conv_kernel - 1, conv_dim), bf),
               "ssm": ((L, B, ssd.G, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                       torch.float32)}
        if cfg.family == "hybrid":
            n_groups = L // cfg.shared_attn_every
            out.update({"k": ((n_groups, *kv), bf), "v": ((n_groups, *kv), bf)})
        return out

    def init_cache(self, B: int, S: int) -> dict[str, torch.Tensor]:
        """A zero cache of ``cache_template(B, S)`` on the model's device."""
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.cache_template(B, S).items()}

    def decode_step(self, params: Params, cache: dict[str, torch.Tensor],
                    batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One token for the whole batch against the cache.

        batch: {"token": (B,) int, "cur_len": int}. Writes the new K/V at
        ``cur_len``, and each Mamba2 layer's new conv window and SSM state,
        into ``cache`` in place (the reference returns a new cache; updating
        in place spares a copy of the whole cache per token) and returns
        (logits (B, V) f32, cache). The SSM family reads no ``cur_len``. The
        embedding's output takes the configuration's dtype, as in the prefill
        and ``loss_fn``."""
        cur = int(batch["cur_len"])
        if "k" in cache and not 0 <= cur < cache["k"].shape[2]:
            raise ValueError(f"cur_len {cur} outside the {cache['k'].shape[2]}-long cache")
        h = params["embed"][batch["token"]].to(dt(self.cfg))[:, None, :]
        family = self.cfg.family
        if family == "ssm":
            h = self._decode_ssm(params, cache, h)
        elif family == "hybrid":
            h = self._decode_hybrid(params, cache, h, cur)
        else:
            h = self._decode_dense(params, cache, h, cur)
        return self._head(params, h)[:, 0].float(), cache

    def _decode_attn(self, lp: dict, h: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur: int, *, window: int | None,
                     pos1: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        S = k_cache.shape[1]  # the per-layer cache is (B, S, KV, hd)
        q, k_new, v_new = self._qkv(lp, h, cos, sin)
        k_cache[:, cur] = k_new[:, 0]
        v_cache[:, cur] = v_new[:, 0]
        k_pos = torch.arange(S, dtype=torch.int32, device=h.device)
        o = gqa_attention(q, k_cache, v_cache, q_pos=pos1, k_pos=k_pos, causal=True,
                          window=window)
        return self._out_proj(lp, o)

    def _decode_block(self, lp: dict, h: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur: int, **attn) -> torch.Tensor:
        """A pre-norm attention block's decode step: attention against its
        cache, then its MLP."""
        x = rms_norm(h, lp["ln1"], self.cfg.norm_eps)
        h = h + self._decode_attn(lp, x, k_cache, v_cache, cur, **attn)
        return h + self._mlp(lp, rms_norm(h, lp["ln2"], self.cfg.norm_eps))[0]

    def _decode_rope(self, h: torch.Tensor, cur: int) -> dict:
        """Position ``cur`` and its RoPE, the same for every layer."""
        pos1 = torch.full((1,), cur, dtype=torch.int32, device=h.device)
        cos, sin = self._rope(pos1[None].expand(h.shape[0], 1))
        return {"pos1": pos1, "cos": cos, "sin": sin}

    def _decode_dense(self, params: Params, cache: dict[str, torch.Tensor],
                      h: torch.Tensor, cur: int) -> torch.Tensor:
        rope = self._decode_rope(h, cur)
        windows = self._windows(cache["k"].shape[2])
        for i, lp in enumerate(_layers(params["layers"])):
            h = self._decode_block(lp, h, cache["k"][i], cache["v"][i], cur, window=windows[i],
                                   **rope)
        return h

    def _decode_mamba(self, lp: dict, h: torch.Tensor, cache: dict[str, torch.Tensor],
                      i: int) -> torch.Tensor:
        """Mamba2 layer i's decode step; its conv window and state are
        written into the cache."""
        x = rms_norm(h, lp["ln"], self.cfg.norm_eps)
        y, conv, state = ssd.mamba2_decode_step(lp, x[:, 0], cache["conv"][i], cache["ssm"][i],
                                                self.cfg)
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(state)
        return h + y[:, None]

    def _decode_ssm(self, params: Params, cache: dict[str, torch.Tensor],
                    h: torch.Tensor) -> torch.Tensor:
        for i, lp in enumerate(_layers(params["layers"])):
            h = self._decode_mamba(lp, h, cache, i)
        return h

    def _decode_hybrid(self, params: Params, cache: dict[str, torch.Tensor],
                       h: torch.Tensor, cur: int) -> torch.Tensor:
        """The hybrid's decode step: the shared block after each group of
        Mamba2 layers attends against its group's K/V, with no window."""
        rope = self._decode_rope(h, cur)
        E = self.cfg.shared_attn_every
        for i, lp in enumerate(_layers(params["layers"])):
            h = self._decode_mamba(lp, h, cache, i)
            if (i + 1) % E == 0:
                g = i // E
                h = self._decode_block(params["shared"], h, cache["k"][g], cache["v"][g], cur,
                                       window=None, **rope)
        return h


def _layers(stacked: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Each layer's parameters, from the stacked (leading L axis) leaves.
    ``unbind``, not ``w[i]``: under autograd each ``w[i]`` adds a zero-padded
    copy of the whole leaf to its gradient (L of them a leaf), ``unbind``
    stacks the layers' gradients once."""
    per_leaf = {name: w.unbind(0) for name, w in stacked.items()}
    n = len(next(iter(per_leaf.values())))
    return [{name: ws[i] for name, ws in per_leaf.items()} for i in range(n)]


def _checkpointed(fn, *args, train: bool, **kw):
    """``fn(*args, **kw)``; with ``train``, under ``torch.utils.checkpoint``
    (its activations recomputed in the backward)."""
    if train:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)
