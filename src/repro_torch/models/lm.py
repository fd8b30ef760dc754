"""The LM of every family of the reference: dense, MoE, SSM, hybrid,
encoder-decoder and VLM.

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
trailing layers with none; for ``family="encdec"`` (whisper), a
bidirectional encoder over stub audio embeddings (layer norms, non-causal
attention, GELU MLP), then a decoder with learned positions whose layers
run causal self-attention, cross-attention against the encoder's output
and the GELU MLP, with no RoPE; and for ``family="vlm"`` (qwen2-vl), the
dense block over precomputed embeddings with M-RoPE on (3, B, S)
positions. The training loss of every family is the
reference's: cross-entropy, plus ``0.01`` times the MoE layers' summed
auxiliary loss, which serving drops.

Parameters are a nested dict of tensors with the reference's names and
shapes, stacked layers included (leading L axis); every method takes them
explicitly, as the reference's do. ``load_params`` also registers them on
the module. The layer stacks are Python loops over the layers. The prefill
computes each attention with the flash-attention kernel (f32 scores; one
launch per attention layer on the card, per group for the hybrid, and per
encoder layer plus two per decoder layer for the encoder-decoder). The
kernel masks by index: the VLM's prefill is causal in sequence order,
while the reference's (and the port's training loss) masks by the values
of the temporal position stream (ROADMAP C). The
training loss (``loss_fn``) attends with the plain ``gqa_attention`` (bf16
score chain), as the reference's ``_attn`` does, since the kernel has no
backward, and runs each layer (each Mamba2 layer and each application of
the hybrid's shared block) under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint(nothing_saveable)`` over its
layer scans. The decode step writes the new K/V, conv windows and SSM
states into the cache in place and attends with ``gqa_attention`` too, as
the reference does: its query sits at ``cur_len`` against an S-long cache,
which the kernel's positions (both from 0) cannot express. The
encoder-decoder's decode step attends across to the cache's ``xk``/``xv``,
which it never writes (the reference's API: its serve loop decodes from a
zero cache; a caller may fill them from the encoder's output).
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
    gelu_mlp,
    gqa_attention,
    layer_norm,
    moe_layer,
    mrope_cos_sin,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
from repro_torch.tree import named_leaves

Params = dict[str, Any]  # name -> tensor, or name -> dict of stacked-layer tensors

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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


def _norm_shapes(cfg: ArchConfig, lead: tuple[int, ...], names=("ln1", "ln2")) -> dict:
    """f32 (*lead, D) leaves: the norms' weights, or the layer norms' biases."""
    return {n: ((*lead, cfg.d_model), torch.float32) for n in names}


def _encdec_shapes(cfg: ArchConfig, max_pos: int) -> dict:
    """The encoder-decoder's tree (less ``final_ln``): the ``enc`` stack
    (attention, MLP, layer norms ``ln1``/``ln2`` with biases ``b1``/``b2``),
    the ``dec`` stack (the same with a third norm, plus the cross-attention's
    ``xwq``/``xwk``/``xwv``/``xwo``), the tied ``embed``, the decoder's
    learned positions ``dec_pos`` (max_pos, D) and the final layer norms'
    weights and biases. The MLP's ``wu`` is in the tree but unused, as in
    the reference."""
    bf, D = dt(cfg), cfg.d_model
    Le, Ld = (cfg.encoder_layers,), (cfg.n_layers,)
    dec = {**_attn_shapes(cfg, Ld), **_mlp_shapes(cfg, Ld),
           **_norm_shapes(cfg, Ld, ("ln1", "ln2", "ln3", "b1", "b2", "b3"))}
    dec.update({"x" + k: v for k, v in _attn_shapes(cfg, Ld).items()})
    return {"embed": ((cfg.vocab, D), bf), "dec_pos": ((max_pos, D), bf),
            "enc": {**_attn_shapes(cfg, Le), **_mlp_shapes(cfg, Le),
                    **_norm_shapes(cfg, Le, ("ln1", "ln2", "b1", "b2"))},
            **_norm_shapes(cfg, (), ("enc_final_ln", "enc_final_b", "final_b")),
            "dec": dec}


def _cross(lp: dict) -> dict:
    """A decoder layer's cross-attention weights, ``x``-prefix dropped."""
    return {k[1:]: v for k, v in lp.items() if k.startswith("x")}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, heads, hd) -> (B, S, heads, hd)."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:])


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, max_pos: int = 4096, device: str = "cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; have {FAMILIES}")
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
        ``ln2``), unstacked. The encoder-decoder's is ``_encdec_shapes``; the
        VLM (embeddings input) has no ``embed``."""
        cfg = self.cfg
        bf, f32 = dt(cfg), torch.float32
        L, D = cfg.n_layers, cfg.d_model
        t: dict = {"final_ln": ((D,), f32)}
        if cfg.family == "encdec":
            return {**t, **_encdec_shapes(cfg, self.max_pos)}
        if not cfg.embeddings_input:
            t["embed"] = ((cfg.vocab, D), bf)
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

    def unread_leaves(self) -> set[str]:
        """Dotted names of the template's leaves that no forward reads (the
        encoder-decoder's MLP ``wu``, as in the reference): their gradient
        is zero."""
        if self.cfg.family == "encdec":
            return {"dec.wu", "enc.wu"}
        return set()

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
    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """cos/sin of ``positions``: (B, S), or for M-RoPE (3, B, S); (None,
        None) where the config has no RoPE."""
        cfg = self.cfg
        if cfg.rope_style == "none":
            return None, None
        if cfg.rope_style == "mrope":
            return mrope_cos_sin(positions, cfg.mrope_sections, cfg.rope_theta)
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

    def _qkv(self, lp: dict, x: torch.Tensor, cos: torch.Tensor | None,
             sin: torch.Tensor | None, kv: torch.Tensor | None = None):
        """Projections, bias, qk-norm and RoPE (none where ``cos`` is None):
        q (B,S,H,hd) from x, k/v (B,Sk,KV,hd) from ``kv`` (cross-attention)
        or x."""
        cfg = self.cfg
        src = x if kv is None else kv
        q, k, v = _proj(x, lp["wq"]), _proj(src, lp["wk"]), _proj(src, lp["wv"])
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.qk_norm:
            q = rms_norm(q, lp["qn"], cfg.norm_eps)
            k = rms_norm(k, lp["kn"], cfg.norm_eps)
        if cos is not None:
            q = apply_rope(q, cos, sin, cfg.rope_fraction)
            k = apply_rope(k, cos, sin, cfg.rope_fraction)
        return q, k, v

    def _out_proj(self, lp: dict, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return (o.reshape(B * S, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)).reshape(B, S, -1)

    def _attn(self, lp: dict, x: torch.Tensor, *, cos=None, sin=None, window: int | None,
              train_pos: torch.Tensor | None, causal: bool = True,
              kv: torch.Tensor | None = None) -> torch.Tensor:
        """The layer's attention: the flash kernel (``window`` 0 for none),
        or with ``train_pos`` (the query positions, and the key positions
        but in cross-attention) the differentiable ``gqa_attention``
        (``window`` None for none). ``kv`` (B, Sk, D) is the source of the
        keys and values of a cross-attention (the reference's
        ``kv_override``; keys at 0..Sk-1)."""
        q, k, v = self._qkv(lp, x, cos, sin, kv)
        if train_pos is not None:
            k_pos = train_pos if kv is None else torch.arange(k.shape[1], device=k.device)
            o = gqa_attention(q, k, v, q_pos=train_pos, k_pos=k_pos, causal=causal,
                              window=window, score_dtype=dt(self.cfg))
            return self._out_proj(lp, o)
        o = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=causal, window=window)
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

    def _forward(self, params: Params, batch: dict, *,
                 train: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The family's stack over ``batch``'s inputs (the reference's
        ``input_specs``: ``tokens``; ``embeds`` and ``positions`` for the
        VLM; ``audio_embeds`` and ``tokens`` for the encoder-decoder):
        (h (B, S, D) before the final norm, the MoE layers' summed auxiliary
        loss or None)."""
        if self.cfg.family == "encdec":
            return self._run_encdec(params, batch, train=train), None
        h, positions = self._inputs(params, batch)
        return self._run_stack(params, h, positions=positions, train=train)

    def _inputs(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The stack's input in the configuration's dtype (bf16 for every
        configuration of the catalog, the reference's cast) and its
        positions: ``embeds`` and ``positions`` (3, B, S) given (embeddings
        input), or the embedded ``tokens`` at 0..S-1 (B, S), stacked three
        times for M-RoPE."""
        cfg = self.cfg
        if cfg.embeddings_input:
            return batch["embeds"].to(dt(cfg)), batch["positions"]
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = params["embed"][tokens].to(dt(cfg))
        positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
        if cfg.rope_style == "mrope":
            positions = positions[None].expand(3, B, S)
        return h, positions

    def _run_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                   train: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The family's layer stack (not the encoder-decoder's:
        ``_run_encdec``) over the embedded inputs h (B, S, D), positions
        (B, S) or for M-RoPE (3, B, S): (h, the MoE layers' summed auxiliary
        loss, None for the other families)."""
        family = self.cfg.family
        if family == "ssm":
            return self._run_ssm_stack(params, h, train=train), None
        if family == "hybrid":
            return self._run_hybrid_stack(params, h, positions=positions, train=train), None
        return self._run_decoder_stack(params, h, positions=positions, train=train)

    def _run_decoder_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                           train: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layer stack: h (B, S, D) bf16, positions (B, S), or (3, B, S)
        for M-RoPE. Query and key positions are ``positions[0]``, for M-RoPE
        the temporal stream's ``positions[0, 0]`` (as in the reference);
        the flash kernel masks by index instead, 0..S-1. With ``train``,
        every layer attends with ``gqa_attention``
        and runs under ``torch.utils.checkpoint`` (its activations are
        recomputed in the backward). Returns (h, aux): the MoE layers'
        auxiliary losses added in layer order (the reference's f32 carry
        from 0), None for the dense family."""
        S = h.shape[1]
        cos, sin = self._rope(positions)
        q_pos = positions[0, 0] if self.cfg.rope_style == "mrope" else positions[0]
        train_pos = {"train_pos": q_pos} if train else {}
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

    def _run_encdec(self, params: Params, batch: dict, *, train: bool = False) -> torch.Tensor:
        """Whisper: the encoder over ``batch["audio_embeds"]`` (B, Sa, D) in
        the configuration's dtype (its positions baked into the stub), its
        final layer norm, then the decoder over ``embed[tokens] +
        dec_pos[:St]`` (added in bf16). Attention by the flash kernel (no
        window), or with ``train`` by ``gqa_attention`` with each layer under
        ``torch.utils.checkpoint``. Returns the decoder's h (B, St, D)."""
        cfg = self.cfg
        enc_out = self._encode(params, batch["audio_embeds"], train=train)
        tokens = batch["tokens"]
        h = (params["embed"][tokens] + params["dec_pos"][:tokens.shape[1]]).to(dt(cfg))
        attn = _no_rope(h, train)
        for lp in _layers(params["dec"]):
            h = _checkpointed(self._dec_layer, lp, h, enc_out, train=train, **attn)
        return h

    def _encode(self, params: Params, audio: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        """The encoder's output (B, Sa, D): its layers over ``audio`` (B, Sa,
        D) in the configuration's dtype, then its final layer norm."""
        h = audio.to(dt(self.cfg))
        attn = _no_rope(h, train)
        for lp in _layers(params["enc"]):
            h = _checkpointed(self._enc_layer, lp, h, train=train, **attn)
        return layer_norm(h, params["enc_final_ln"], params["enc_final_b"], self.cfg.norm_eps)

    def _enc_layer(self, lp: dict, h: torch.Tensor, **attn) -> torch.Tensor:
        """An encoder layer: non-causal self-attention, then the GELU MLP,
        each after a layer norm (``attn``: ``_no_rope``)."""
        eps = self.cfg.norm_eps
        h = h + self._attn(lp, layer_norm(h, lp["ln1"], lp["b1"], eps), causal=False, **attn)
        return h + self._gelu(lp, layer_norm(h, lp["ln2"], lp["b2"], eps))

    def _dec_layer(self, lp: dict, h: torch.Tensor, enc_out: torch.Tensor,
                   **attn) -> torch.Tensor:
        """A decoder layer: causal self-attention, cross-attention against
        ``enc_out`` (non-causal), then the GELU MLP, each after a layer norm."""
        eps = self.cfg.norm_eps
        h = h + self._attn(lp, layer_norm(h, lp["ln1"], lp["b1"], eps), **attn)
        h = h + self._attn(_cross(lp), layer_norm(h, lp["ln2"], lp["b2"], eps), causal=False,
                           kv=enc_out, **attn)
        return h + self._gelu(lp, layer_norm(h, lp["ln3"], lp["b3"], eps))

    @staticmethod
    def _gelu(lp: dict, x: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder's MLP: ``gelu_mlp`` over ``wg`` and ``wd`` with
        zero biases, as the reference calls it."""
        zero = x.new_zeros(())
        return gelu_mlp(x, lp["wg"], zero, lp["wd"], zero)

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.family == "encdec":
            h = layer_norm(h, params["final_ln"], params["final_b"], self.cfg.norm_eps)
        else:
            h = rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["head"]

    # ------------------------------------------------------------- training
    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        """The training loss (f32 0-d) of ``batch`` = {"tokens", "labels"}
        (B, S) int ({"embeds", "positions", "labels"} for the VLM,
        {"audio_embeds", "tokens", "labels"} for the encoder-decoder): the
        reference's ``loss_fn`` with ``ctx=None``, the mean
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
        h, aux = self._forward(params, batch, train=True)
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
        group (n_groups, B, S, KV, hd); the encoder-decoder adds the
        cross-attention's ``xk``/``xv`` (L, B, S // 2, KV, hd)."""
        cfg = self.cfg
        bf = torch.bfloat16
        kv = (B, S, cfg.n_kv_heads, cfg.hd)
        L = cfg.n_layers
        if cfg.family == "encdec":
            xkv = (L, B, S // 2, *kv[2:])
            return {"k": ((L, *kv), bf), "v": ((L, *kv), bf), "xk": (xkv, bf), "xv": (xkv, bf)}
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

        batch: {"token": (B,) int, "cur_len": int}, or for embeddings input
        (the VLM) {"embed": (B, D), "cur_len"}. Writes the new K/V at
        ``cur_len``, and each Mamba2 layer's new conv window and SSM state,
        into ``cache`` in place (the reference returns a new cache; updating
        in place spares a copy of the whole cache per token) and returns
        (logits (B, V) f32, cache). The SSM family reads no ``cur_len``. The
        embedding's output takes the configuration's dtype, as in the prefill
        and ``loss_fn``; the encoder-decoder adds ``dec_pos[cur_len]``."""
        cfg = self.cfg
        cur = int(batch["cur_len"])
        if "k" in cache and not 0 <= cur < cache["k"].shape[2]:
            raise ValueError(f"cur_len {cur} outside the {cache['k'].shape[2]}-long cache")
        if cfg.embeddings_input:
            x = batch["embed"].to(dt(cfg))
        else:
            x = params["embed"][batch["token"]].to(dt(cfg))
        if cfg.family == "encdec":
            x = x + params["dec_pos"][cur]
        h = x[:, None, :]
        family = cfg.family
        if family == "ssm":
            h = self._decode_ssm(params, cache, h)
        elif family == "hybrid":
            h = self._decode_hybrid(params, cache, h, cur)
        elif family == "encdec":
            h = self._decode_encdec(params, cache, h, cur)
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
        """Position ``cur`` and its RoPE, the same for every layer (M-RoPE:
        ``cur`` on all three streams; none without RoPE)."""
        pos1 = torch.full((1,), cur, dtype=torch.int32, device=h.device)
        positions = pos1[None].expand(h.shape[0], 1)
        if self.cfg.rope_style == "mrope":
            positions = positions[None].expand(3, *positions.shape)
        cos, sin = self._rope(positions)
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

    def _decode_encdec(self, params: Params, cache: dict[str, torch.Tensor],
                       h: torch.Tensor, cur: int) -> torch.Tensor:
        """The decoder's step: causal self-attention against the K/V cache,
        then cross-attention of the query (at position 0, non-causal)
        against the cache's ``xk``/``xv``, then the GELU MLP."""
        eps = self.cfg.norm_eps
        rope = self._decode_rope(h, cur)
        Sa = cache["xk"].shape[2]
        q_pos = torch.zeros((1,), dtype=torch.int32, device=h.device)
        k_pos = torch.arange(Sa, dtype=torch.int32, device=h.device)
        for i, lp in enumerate(_layers(params["dec"])):
            x = layer_norm(h, lp["ln1"], lp["b1"], eps)
            h = h + self._decode_attn(lp, x, cache["k"][i], cache["v"][i], cur, window=None,
                                      **rope)
            q = _proj(layer_norm(h, lp["ln2"], lp["b2"], eps), lp["xwq"])
            o = gqa_attention(q, cache["xk"][i], cache["xv"][i], q_pos=q_pos, k_pos=k_pos,
                              causal=False)
            h = h + self._out_proj(_cross(lp), o)
            h = h + self._gelu(lp, layer_norm(h, lp["ln3"], lp["b3"], eps))
        return h


def _layers(stacked: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Each layer's parameters, from the stacked (leading L axis) leaves.
    ``unbind``, not ``w[i]``: under autograd each ``w[i]`` adds a zero-padded
    copy of the whole leaf to its gradient (L of them a leaf), ``unbind``
    stacks the layers' gradients once."""
    per_leaf = {name: w.unbind(0) for name, w in stacked.items()}
    n = len(next(iter(per_leaf.values())))
    return [{name: ws[i] for name, ws in per_leaf.items()} for i in range(n)]


def _no_rope(h: torch.Tensor, train: bool) -> dict:
    """The encoder-decoder's attention arguments (no RoPE, no window) for
    the sequence of h (B, S, D): the flash kernel's, or for ``train``
    ``gqa_attention``'s with the query positions 0..S-1."""
    if not train:
        return {"window": 0, "train_pos": None}
    return {"window": None, "train_pos": torch.arange(h.shape[1], device=h.device)}


def _checkpointed(fn, *args, train: bool, **kw):
    """``fn(*args, **kw)``; with ``train``, under ``torch.utils.checkpoint``
    (its activations recomputed in the backward)."""
    if train:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)
