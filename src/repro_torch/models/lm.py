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

Tensor and expert parallelism (``tp``, a ``MeshCtx`` whose "model" axis is
larger than 1, for a model of any family that is not pure data-parallel,
and for the decode of one that is; ``LM.tp_ctx``): the parameters are this
rank's blocks of ``param_specs`` and the layout is the reference's
Megatron-SP. Between blocks the hidden state holds this rank's block of
the sequence; a block gathers it at its entry (``MeshCtx.gather_seq``),
runs its column-parallel in-projections on the rank's heads, FFN columns
or SSM heads and its row-parallel out-projection, and reduce-scatters the
partial sums back to the sequence layout (``scatter_seq``); a decode step
(S = 1) all-reduces them instead (``psum_model``). The hybrid's shared
block and the encoder-decoder's attentions and GELU MLP run so too; the
encoder's output is gathered once for every cross-attention. The inputs
given as embeddings (the VLM's, the encoder's audio) are cut to the rank's
block of the sequence. Where the vocab divides "model", the embedding and
the head are vocab-parallel, and so is the cross-entropy
(``vocab_parallel_ce``); where it does not, they hold a block of d_model:
the embedding's rows are gathered over "model" and the logits are the sum
over "model" of each rank's block product (``reduce_model``), on which the
loss runs whole. The MoE block runs ``moe_layer``'s expert-parallel branch
on the rank's tokens.

Where a dim does not divide "model", the reference's fallback layout
(``param_specs``: head_dim for the attention, else the leaf replicated)
runs without Megatron-SP's gather and scatter around the part it holds
whole. The attention, where the heads do not divide, gathers its
head_dim-sharded weights once a step (their gradients summed back), its
K/V from the sequence gathered at the block's entry and its queries from
the rank's block alone, attends at the block's offset (the flash kernel's
``q_offset``) and projects with the whole ``wo``, which lands on the block
itself; its decode step runs on the rank's block of head_dim of a
head_dim-sharded cache (``gqa_attention(hd_split=)``, partial scores
summed over "model"; q and k gathered whole for qk-norm and RoPE). A
replicated FFN, embedding or head runs on the rank's own rows (the loss on
whole logits of them, summed over "model"); the MoE layer and the Mamba2
mixer run the reference's whole-array forms over the gathered tokens (the
MoE's over the global batch: its capacity and dispatch order are global)
and keep the rank's block.

Sequence sharding (``sp``, a ``MeshCtx`` whose batch axes the batch does
not fill: ``LM.seq_ctx``), for every family's serving and training: h
holds this rank's block of the sequence, the contiguous
block at its ``seq_rank`` (split again over "model" where Megatron-SP runs), at the
global positions from its offset; every layer's window comes from the whole
length. The attention computes q, k and v on the block, gathers the keys
and values over the batch axes (the whole sequence's: one all-gather a
layer, 33.5 MB for gemma3-1b's 32768 tokens; a windowed layer would need
only the previous window - 1 keys, but the flash kernel skips every
masked tile, so the extra keys cost the gather alone) and attends the
block's queries at their offset (the flash kernel's ``q_offset``; a masked
tile adds exactly 0, so the block's rows equal the whole sequence's). The
Mamba2 mixer reads the previous rank's conv rows and relays its state
(``models/ssd.py``). The decode step writes the new K/V on the rank that
owns ``cur_len``, attends on each rank's block of the cache
(``gqa_attention(seq_split=)``) and runs the SSM layers, whose conv and
state caches the batch axes do not shard, alike on every rank. Every layout
over "model" composes with it, the fallback layouts included (gemma3-1b's
``long_500k`` on model=16): the head_dim-sharded attention's queries, a
rank's rows of its sequence rank's block, attend at ``seq_rank * S/n_batch
+ model_rank * S/(n_batch * n_model)``; its decode runs on the rank's
head_dim block of its sequence block of the cache (``gqa_attention`` with
both ``hd_split`` and ``seq_split``); the replicated MLP and head run on the
rank's rows; the whole Mamba2 mixer runs on the sequence rank's block on
every "model" rank, each relaying over its own group of the batch axes.
In training the attention is ``gqa_attention`` over the gathered keys at
their global positions, the queries at the same offset; the halo, the
relay and the keys' gather send their gradients back (``MeshCtx``), and
each checkpointed layer keeps what they received for its recompute
(``MeshCtx.recorded``), which replays no hop over the batch axes; each
rank takes the cross-entropy of its own block on the global sequence's
chunk grid, and the step averages the ranks' losses and gradients. The
MoE layer routes what the reference's routes together (``_moe_seq``): the
whole sequence, gathered over the batch axes, with its global capacity and
dispatch order, or with its experts split over "model" each "model" rank's
contiguous block of the whole sequence through the expert-parallel branch;
every rank keeps its own rows, and the auxiliary loss, the same on every
sequence rank, enters the step's mean once. The VLM's embeddings and M-RoPE
positions arrive as the rank's block (its cos and sin from the block's
three streams); its training masks by the global batch's first temporal
stream, the queries read at their offset. The encoder-decoder's encoder
runs on the rank's block of the frames (its keys gathered), its output is
gathered over the batch axes once for every cross-attention, and the
decoder runs on the rank's block of the tokens; its decode step attends on
the rank's blocks of both caches, ``xk``/``xv``'s frames included.
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
    expand_kv_to_local_heads,
    gelu_mlp,
    gqa_attention,
    layer_norm,
    moe_layer,
    mrope_cos_sin,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
from repro_torch.models.sharding import (
    MeshCtx,
    NamedSharding,
    spec_with_model_on,
    vocab_parallel_ce,
)
from repro_torch.tree import named_leaves, tree_map

Params = dict[str, Any]  # name -> tensor, or name -> dict of stacked-layer tensors

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the leaves a rank gathers whole where its layout is a fallback (``_tp_layers``)
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
MIXER_LEAVES = ("wz", "wx", "wdt", "norm", "wo")
PURE_DP_MAX_PARAMS = 2.5e8  # below this, TP wastes the mesh: replicate
CE_CHUNK = 128  # tokens per chunk of the cross-entropy on a mesh


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
        # tiny models (whisper-base) are pure data-parallel: weights
        # replicated, the batch sharded over every mesh axis
        self.pure_dp = self.n_params() <= PURE_DP_MAX_PARAMS

    def _tok_spec(self, ctx: MeshCtx) -> tuple:
        if self.pure_dp:
            return ((*ctx.batch_axes, "model"), None, None)
        return (ctx.batch_axes, "model", None)

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

    # ------------------------------------------------------------- specs
    def param_specs(self, ctx: MeshCtx, serve: bool = False) -> dict:
        """Weight shardings, the reference's tree: a pure data-parallel
        model's weights are replicated; otherwise each weight has "model" on
        its heads, FFN or expert dim (or a fallback dim divisible by the
        model axis). ``serve=True`` also shards the MoE expert tensors over
        the batch axes (no gradient to replicate them for in inference)."""
        if self.pure_dp and not serve:
            return tree_map(lambda _: ctx.replicated(), self.param_template())

        def leaf_spec(path: tuple, shape: tuple) -> tuple:
            name = path[-1]
            stacked = len(path) >= 2 and path[0] in ("layers", "enc", "dec")
            off = 1 if stacked else 0
            body = shape[off:]
            if name in ("embed", "dec_pos"):
                return spec_with_model_on(shape, ctx, [0, 1])
            if name == "head":
                return spec_with_model_on(shape, ctx, [1, 0])
            base: tuple
            bare = name.lstrip("x")
            if bare in ("wq", "bq", "wo"):  # the heads dim, or head_dim as fallback
                base = spec_with_model_on(body, ctx, [0, 1] if bare != "wq" else [1, 2])
            elif bare in ("qn", "kn"):
                base = (None,) * len(body)
            elif bare in ("wk", "wv", "bk", "bv"):
                base = spec_with_model_on(body, ctx, [1, 2])
            elif name in ("wg", "wu", "wz", "wx", "wdt"):
                base = spec_with_model_on(body, ctx, [1])
            elif name in ("wd", "norm"):
                base = spec_with_model_on(body, ctx, [0])
            elif name in ("w_gate", "w_up", "w_down"):
                base = spec_with_model_on(body, ctx, [0])  # EP on experts
                if serve:
                    b2 = list(base)
                    for d in (1, 2):
                        if b2[d] is None and body[d] % ctx.n_batch == 0:
                            b2[d] = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
                            break
                    base = tuple(b2)
            else:  # wr, conv_w, the norms and biases
                base = (None,) * len(body)
            return ((None,) * off) + base if stacked else base

        def walk(tree: dict, path: tuple = ()) -> dict:
            out = {}
            for k, v in tree.items():
                p = path + (k,)
                if isinstance(v, dict):
                    out[k] = walk(v, p)
                elif k == "wo" and p[0] == "layers" and self.cfg.is_ssm:
                    out[k] = ctx.ns(None, *spec_with_model_on(v[0][1:], ctx, [0]))  # (d_inner, D)
                else:
                    out[k] = ctx.ns(*leaf_spec(p, v[0]))
            return out

        return walk(self.param_template())

    def tp_ctx(self, ctx: MeshCtx | None, serve: bool = False) -> MeshCtx | None:
        """``ctx`` where a step runs tensor and expert parallelism over
        "model" (a model that is not pure data-parallel, or with ``serve``
        any model, as the reference's serve step runs on ``param_specs(ctx,
        serve=True)``; on a mesh whose "model" axis is larger than 1), else
        None. Every layout of ``param_specs`` runs: KV heads that do not
        divide the axis take the reference's expansion to the rank's heads,
        a vocab that does not the embedding and head on d_model, and heads,
        FFN, experts, SSM heads, or a vocab with d_model, that do not the
        fallback layouts (module docstring)."""
        if ctx is None or ctx.n_model == 1 or (self.pure_dp and not serve):
            return None
        return ctx

    def seq_ctx(self, ctx: MeshCtx | None, global_batch: int,
                train: bool = False) -> MeshCtx | None:
        """``ctx`` where a step of ``global_batch`` rows shards the sequence
        over the batch axes (they are more than one, and the batch does not
        fill them: ``MeshCtx.token_spec``), else None: to serve, and with
        ``train`` to train, for every family. Every layout over "model"
        (``tp_ctx``) composes with it, the fallback layouts included."""
        if ctx is None or ctx.n_batch == 1 or not ctx.seq_sharded(global_batch):
            return None
        return ctx

    @staticmethod
    def _splits(tp: MeshCtx | None, dim: int) -> bool:
        """Whether tensor parallelism splits a dim of size ``dim`` over
        "model" (it divides the axis); False without ``tp``."""
        return tp is not None and dim % tp.n_model == 0

    def _hd_fallback(self, tp: MeshCtx | None) -> bool:
        """Whether the attention runs the fallback layout: ``tp``, and the
        heads do not divide "model" (nor, then, the KV heads). Its weights
        are head_dim-sharded where head_dim divides, else replicated."""
        return tp is not None and not self._splits(tp, self.cfg.n_heads)

    def _vocab_parallel(self, tp: MeshCtx | None) -> bool:
        """Whether ``param_specs`` puts "model" on the embedding's and the
        head's vocab dim (it divides the axis), not on d_model."""
        return self._splits(tp, self.cfg.vocab)

    def _head_whole(self, tp: MeshCtx | None) -> bool:
        """Whether the embedding and head are replicated on a ``tp`` mesh:
        neither the vocab nor d_model divides "model"."""
        return tp is not None and not self._vocab_parallel(tp) and \
            not self._splits(tp, self.cfg.d_model)

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
        layers, S + 1 (no limit) on global ones; S is the whole sequence's
        length (not a sequence rank's block: its global layers would be
        windowed)."""
        cfg = self.cfg
        if not cfg.global_every:
            return [S + 1] * cfg.n_layers
        return [S + 1 if i % cfg.global_every == cfg.global_every - 1 else cfg.sliding_window
                for i in range(cfg.n_layers)]

    def _qkv(self, lp: dict, x: torch.Tensor, cos: torch.Tensor | None,
             sin: torch.Tensor | None, kv: torch.Tensor | None = None, q_off: int = 0,
             hd_split: MeshCtx | None = None):
        """Projections, bias, qk-norm and RoPE (none where ``cos`` is None):
        q (B,Sq,H,hd) from x, k/v (B,Sk,KV,hd) from ``kv`` (cross-attention,
        or the fallback's gathered sequence) or x; cos/sin hold the keys'
        positions, the queries' from ``q_off``. Tensor-parallel, q holds
        this rank's heads and k/v its KV heads, or all of them where the
        rank expands them (``_tp_kv``). With ``hd_split`` the weights are
        this rank's blocks of head_dim: q and k are gathered whole over
        "model" for qk-norm and RoPE (a block holds neither the whole norm
        nor the rotation partners), then cut back to the block."""
        cfg = self.cfg
        src = x if kv is None else kv
        q, k, v = _proj(x, lp["wq"]), _proj(src, lp["wk"]), _proj(src, lp["wv"])
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        mixed = cfg.qk_norm or cos is not None
        if hd_split is not None and mixed:  # one gather for both
            q, k = hd_split.all_gather(torch.cat([q, k], dim=2), dim=-1).split(
                [q.shape[2], k.shape[2]], dim=2)
        if cfg.qk_norm:
            q = rms_norm(q, lp["qn"], cfg.norm_eps)
            k = rms_norm(k, lp["kn"], cfg.norm_eps)
        if cos is not None:
            rows = slice(q_off, q_off + q.shape[1])
            q = apply_rope(q, cos[:, rows], sin[:, rows], cfg.rope_fraction)
            k = apply_rope(k, cos, sin, cfg.rope_fraction)
        if hd_split is not None and mixed:
            q, k = (_rank_block(t, hd_split, dim=-1) for t in (q, k))
        return q, k, v

    def _expands(self, tp: MeshCtx | None) -> bool:
        """Whether a rank expands the KV heads to its query heads: the
        reference's rule, where the KV heads do not divide "model" and the
        heads do."""
        cfg = self.cfg
        return self._splits(tp, cfg.n_heads) and not self._splits(tp, cfg.n_kv_heads)

    def _tp_layers(self, layers: dict, tp: MeshCtx | None, path: str = "layers",
                   decode: bool = False) -> dict:
        """The weights of ``params[path]`` (stacked layers, or the hybrid's
        shared block) as this rank reads them, made once for every layer:
        where the heads divide "model", the K/V as its heads read them
        (``_tp_kv``); in a fallback layout, the leaves it runs whole
        gathered whole (``_whole``): the attention's to prefill and train
        (a decode step runs on its head_dim blocks), the experts, the
        Mamba2 mixer's. ``layers`` itself without ``tp``."""
        if tp is None:
            return layers
        cfg, names = self.cfg, []
        if "wq" in layers:
            if not self._hd_fallback(tp):
                layers = {**layers, **self._tp_kv(layers, tp)}
            elif not decode:
                names += [p + n for p in ("", "x") for n in ATTN_LEAVES]
        if "w_gate" in layers and not self._splits(tp, cfg.moe_experts):
            names += EXPERT_LEAVES
        if "wz" in layers and not self._splits(tp, cfg.ssm_heads):
            names += MIXER_LEAVES
        return self._whole(layers, tp, path, names, serve=decode and self.pure_dp)

    def _whole(self, tree: dict, tp: MeshCtx, path: str, names: list,
               serve: bool = False) -> dict:
        """``tree`` (``params[path]``, laid out as ``param_specs(tp,
        serve)``) with its leaves ``names`` whole: each dim their spec
        shards gathered over its axes (``gather_seq``: the gradients summed
        back to the blocks)."""
        if not names:
            return tree
        specs, out = self.param_specs(tp, serve)[path], dict(tree)
        for name in names:
            if name not in tree:
                continue
            w = tree[name]
            for dim, entry in enumerate(specs[name].spec):
                if entry is not None:
                    w = tp.gather_seq(w, dim=dim, axes=(entry,) if isinstance(entry, str)
                                      else tuple(entry))
            out[name] = w
        return out

    def _tp_kv(self, lp: dict, tp: MeshCtx) -> dict:
        """The K/V weights and biases (stacked or one layer's, the
        cross-attention's too) as this rank's heads read them: its block of
        the KV heads, or all of them where it expands them. The reference's
        specs shard the biases (and, where the KV heads do not divide
        "model", the weights) over head_dim: those are gathered over "model"
        (their gradients summed back: ``gather_seq``) and cut to the rank's
        KV heads."""
        cfg, out = self.cfg, {}
        kv = cfg.n_kv_heads // tp.n_model
        for name in ("wk", "wv", "bk", "bv", "xwk", "xwv", "xbk", "xbv"):
            if name not in lp:
                continue
            w = lp[name]
            if w.shape[-1] != cfg.hd:
                w = tp.gather_seq(w, dim=w.ndim - 1)
            if not self._expands(tp) and w.shape[-2] == cfg.n_kv_heads:
                w = w.narrow(-2, tp.model_rank * kv, kv)
            out[name] = w
        return out

    def _out_proj(self, lp: dict, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return (o.reshape(B * S, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)).reshape(B, S, -1)

    def _attn(self, lp: dict, x: torch.Tensor, *, cos=None, sin=None, window: int | None,
              train_pos: torch.Tensor | None, causal: bool = True,
              kv: torch.Tensor | None = None, tp: MeshCtx | None = None,
              sp: MeshCtx | None = None) -> torch.Tensor:
        """The layer's attention: the flash kernel (``window`` 0 for none),
        or with ``train_pos`` (the query positions, and the key positions
        but in cross-attention) the differentiable ``gqa_attention``
        (``window`` None for none). ``kv`` (B, Sk, D) is the source of the
        keys and values of a cross-attention (the reference's
        ``kv_override``; keys at 0..Sk-1). With ``tp``, on this rank's heads
        of the whole sequence: the out-projection's partial sums; in the
        fallback (``_hd_fallback``, the weights whole: ``_tp_layers``), on
        every head of the queries of x, this rank's block of the sequence,
        at its offset, against the keys of the sequence gathered (or of
        ``kv``): the block's own output. With ``sp`` the sequence rank's
        block (x, or in the fallback the x gathered over "model"; Megatron-SP
        gathers it before) and cos/sin its positions: its K/V are gathered
        over the batch axes (the whole sequence's keys, module docstring)
        and its queries attend at the block's offset, in the fallback
        ``seq_rank * S/n_batch + model_rank * S/(n_batch * n_model)``: the
        keys come out in sequence order, the gather over "model" within a
        sequence rank's block, then the one over the batch axes, seq rank
        outermost."""
        q_off, src = 0, kv
        if self._hd_fallback(tp):
            q_off = tp.model_rank * x.shape[1]
            if kv is None:
                src = tp.gather_seq(x)
        q, k, v = self._qkv(lp, x, cos, sin, src, q_off)
        if sp is not None:  # one gather for both
            k, v = sp.gather_seq(torch.cat([k, v], dim=2), axes=sp.batch_axes).split(
                [k.shape[2], v.shape[2]], dim=2)
            q_off += sp.seq_rank * (x if src is None else src).shape[1]
        if self._expands(tp):
            k, v = expand_kv_to_local_heads(k, v, q.shape[2], tp)
        if train_pos is not None:
            k_pos = train_pos if kv is None else torch.arange(k.shape[1], device=k.device)
            o = gqa_attention(q, k, v, q_pos=train_pos[q_off:q_off + q.shape[1]], k_pos=k_pos,
                              causal=causal, window=window, score_dtype=dt(self.cfg))
            return self._out_proj(lp, o)
        o = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=causal, window=window,
                            q_offset=q_off)
        return self._out_proj(lp, o.transpose(1, 2))

    def _attn_sp(self, lp: dict, x: torch.Tensor, tp: MeshCtx | None, **attn) -> torch.Tensor:
        """The attention sublayer of h's block x: Megatron-SP around the
        rank's heads (``_sp``), or in the fallback the block's own output
        (``_attn``)."""
        if self._hd_fallback(tp):
            return self._attn(lp, x, tp=tp, **attn)
        return _sp(lambda v: self._attn(lp, v, tp=tp, **attn), x, tp)

    def _dense_block(self, lp: dict, h: torch.Tensor, *, cos, sin, window: int | None,
                     train_pos: torch.Tensor | None = None, tp: MeshCtx | None = None,
                     sp: MeshCtx | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(h, the MLP's auxiliary loss: ``_mlp``). With ``tp``, h is this
        rank's block of the sequence, gathered for the attention; with
        ``sp``, of the sequence rank's block."""
        cfg = self.cfg
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        h = h + self._attn_sp(lp, x, tp, cos=cos, sin=sin, window=window, train_pos=train_pos,
                              sp=sp)
        y, aux = self._mlp(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), tp, sp=sp)
        return h + y, aux

    def _mlp(self, lp: dict, x: torch.Tensor, tp: MeshCtx | None = None,
             decode: bool = False,
             sp: MeshCtx | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The block's MLP and its auxiliary loss: SwiGLU (None), or for MoE
        ``moe_layer`` (aux = E * sum(me * ce), f32). With ``tp``: x is this
        rank's block of the sequence (gathered for SwiGLU's columns, the
        partial sums scattered back) or, with ``decode``, the whole token;
        the MoE layer runs its expert-parallel branch. Where d_ff (or the
        experts) do not divide "model", the replicated MLP runs on x as it
        is (the MoE layer: ``_moe_whole``). With ``sp`` the MoE layer routes
        the tokens the reference's routes (``_moe_seq``); SwiGLU runs on the
        block as it is."""
        cfg = self.cfg
        if cfg.family == "moe":
            if sp is not None and not decode:
                return self._moe_seq(lp, x, tp, sp)
            if tp is not None and not self._splits(tp, cfg.moe_experts):
                return self._moe_whole(lp, x, tp, decode)
            return moe_layer(x, lp["wr"], lp["w_gate"], lp["w_up"], lp["w_down"],
                             top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor, ctx=tp)

        def mlp(v: torch.Tensor) -> torch.Tensor:
            return swiglu_mlp(v, lp["wg"], lp["wu"], lp["wd"])

        if tp is not None and not self._splits(tp, cfg.d_ff):
            return mlp(x), None
        return (tp.psum_model(mlp(x)) if decode and tp is not None else _sp(mlp, x, tp)), None

    def _moe_whole(self, lp: dict, x: torch.Tensor, tp: MeshCtx,
                   decode: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's whole-array ``moe_layer`` where the experts do not
        divide "model" (the weights whole: ``_tp_layers``): over the global
        batch's tokens, x (this rank's block of the sequence, or with
        ``decode`` the whole token) gathered over "model" and the batch
        axes, so that the capacity and the dispatch order are the
        reference's; (this rank's block of y, the auxiliary loss, every
        rank's the same: ``shared_model``)."""
        cfg, B = self.cfg, x.shape[0]
        xg = x if decode else tp.gather_seq(x)
        if tp.n_batch > 1:
            xg = tp.gather_seq(xg, dim=0, axes=tp.batch_axes)
        y, aux = moe_layer(xg, lp["wr"], lp["w_gate"], lp["w_up"], lp["w_down"],
                           top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        y = y.narrow(0, tp.index(tp.batch_axes) * B, B)
        return (y if decode else _rank_block(y, tp)), tp.shared_model(aux)

    def _moe_seq(self, lp: dict, x: torch.Tensor, tp: MeshCtx | None,
                 sp: MeshCtx) -> tuple[torch.Tensor, torch.Tensor]:
        """The MoE layer of a sequence-sharded step, on the tokens the
        reference's ``moe_layer`` routes together where the batch does not
        fill the batch axes (its shard_map's batch dim then unsharded): x,
        this rank's block, gathered over "model" (with ``tp``) and over the
        batch axes into the whole sequence. Without ``tp``, or where the
        experts do not divide "model" (the weights whole: ``_tp_layers``),
        the whole-array layer over the whole sequence, its capacity and
        dispatch order global; with them split, the expert-parallel branch
        on "model" rank m's contiguous S / n_model block of the whole
        sequence (the same on every sequence rank; the reference's exchange,
        ROADMAP C), its output gathered over "model". Returns (this rank's
        rows of y, the auxiliary loss: the same on every sequence rank, so
        the step's mean over them counts it once; the gathers' backward
        sums each rank's gradient of it, which that mean divides back)."""
        cfg = self.cfg
        xs = x if tp is None else tp.gather_seq(x)  # the sequence rank's block
        xg = sp.gather_seq(xs, axes=sp.batch_axes)
        moe = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        w = (lp["wr"], lp["w_gate"], lp["w_up"], lp["w_down"])
        if tp is not None and self._splits(tp, cfg.moe_experts):
            n = xg.shape[1] // tp.n_model
            y, aux = moe_layer(xg.narrow(1, tp.model_rank * n, n), *w, ctx=tp, **moe)
            y = tp.gather_seq(y)
        else:
            y, aux = moe_layer(xg, *w, **moe)
            if tp is not None:
                aux = tp.shared_model(aux)
        first = sp.seq_rank * xs.shape[1] + (0 if tp is None else tp.model_rank * x.shape[1])
        return y.narrow(1, first, x.shape[1]).contiguous(), aux

    def _mamba_layer(self, lp: dict, h: torch.Tensor, tp: MeshCtx | None = None,
                     sp: MeshCtx | None = None) -> torch.Tensor:
        """h + the Mamba2 mixer of its norm: on the rank's SSM heads
        (Megatron-SP), or where they do not divide "model" the whole mixer
        (its leaves whole: ``_tp_layers``) over the sequence gathered, of
        which the rank keeps its block. With ``sp`` on the sequence rank's
        block (``models/ssd.py``); in the whole mixer every "model" rank of
        a sequence rank runs it, with the halo and the relay over its own
        group of the batch axes (the ranks that share its "model" index),
        so that no rank waits for another "model" rank's relay."""
        x = rms_norm(h, lp["ln"], self.cfg.norm_eps)
        if tp is not None and not self._splits(tp, self.cfg.ssm_heads):
            return h + _rank_block(ssd.mamba2_mixer(lp, tp.gather_seq(x), self.cfg, sp=sp), tp)
        return h + _sp(lambda v: ssd.mamba2_mixer(lp, v, self.cfg, tp, sp=sp), x, tp)

    def _forward(self, params: Params, batch: dict, *, train: bool = False,
                 tp: MeshCtx | None = None,
                 sp: MeshCtx | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The family's stack over ``batch``'s inputs (the reference's
        ``input_specs``: ``tokens``; ``embeds`` and ``positions`` for the
        VLM; ``audio_embeds`` and ``tokens`` for the encoder-decoder):
        (h (B, S, D) before the final norm, the MoE layers' summed auxiliary
        loss or None). With ``tp``, h is this rank's block of the sequence;
        with ``sp`` (``seq_ctx``) ``batch`` is the sequence rank's block of
        the tokens, and h its block (of which ``tp`` holds a block)."""
        if self.cfg.family == "encdec":
            return self._run_encdec(params, batch, train=train, tp=tp, sp=sp), None
        h, positions = self._inputs(params, batch, tp, sp)
        return self._run_stack(params, h, positions=positions, train=train, tp=tp,
                               q_pos=batch.get("mask_pos"), sp=sp)

    def _embed(self, params: Params, tokens: torch.Tensor, tp: MeshCtx | None = None,
               decode: bool = False) -> torch.Tensor:
        """The embedding's rows of ``tokens`` (B, S) in the configuration's
        dtype. With ``tp``, this rank's block of the sequence (B, S/n, D),
        or with ``decode`` the whole rows of the tokens (B,), on every rank.
        Where the vocab is split over "model", each rank looks up the rows
        its block holds (zeros for the others) and the sum over "model" is
        the embedding; where d_model is, each rank's block of every row is
        gathered over "model"; where neither is, the rows are whole."""
        emb, cast = params["embed"], dt(self.cfg)
        if tp is None:
            return emb[tokens].to(cast)
        if not self._vocab_parallel(tp):
            rows = emb[tokens].to(cast)
            if not self._head_whole(tp):
                rows = tp.gather_seq(rows, dim=-1)
            return rows if decode else _rank_block(rows, tp)
        V = emb.shape[0]
        local = tokens.long() - tp.model_rank * V
        own = ((local >= 0) & (local < V))[..., None]
        part = torch.where(own, emb[local.clamp(0, V - 1)], 0).to(cast)
        return tp.psum_model(part) if decode else tp.scatter_seq(part)

    def _dec_pos(self, params: Params, tp: MeshCtx | None = None) -> torch.Tensor:
        """The encoder-decoder's whole position table (max_pos, D): with
        ``tp`` each rank's block gathered over "model" on the dim
        ``param_specs`` splits (the positions where max_pos divides it),
        so that every position's row comes from the rank that holds it."""
        table = params["dec_pos"]
        full = (self.max_pos, self.cfg.d_model)
        split = [d for d in (0, 1) if table.shape[d] != full[d]]
        return tp.gather_seq(table, dim=split[0]) if split else table

    def _inputs(self, params: Params, batch: dict, tp: MeshCtx | None = None,
                sp: MeshCtx | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The stack's input in the configuration's dtype (bf16 for every
        configuration of the catalog, the reference's cast) and its
        positions: ``embeds`` and ``positions`` (3, B, S) given (embeddings
        input), or the embedded ``tokens`` at 0..S-1 (B, S), stacked three
        times for M-RoPE. With ``tp`` the input is this rank's block of the
        sequence (the positions stay whole). With ``sp`` the tokens are the
        sequence rank's block, at the global positions from its offset; the
        embeddings and their positions are the sequence rank's blocks
        (``batch_shardings``)."""
        cfg = self.cfg
        if cfg.embeddings_input:
            h = batch["embeds"].to(dt(cfg))
            return (h if tp is None else _rank_block(h, tp)), batch["positions"]
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens, tp)
        first = 0 if sp is None else sp.seq_rank * S
        positions = torch.arange(first, first + S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        if cfg.rope_style == "mrope":
            positions = positions[None].expand(3, B, S)
        return h, positions

    def _run_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                   train: bool = False, tp: MeshCtx | None = None,
                   q_pos: torch.Tensor | None = None,
                   sp: MeshCtx | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The family's layer stack (not the encoder-decoder's:
        ``_run_encdec``) over the embedded inputs h (B, S, D), positions
        (B, S) or for M-RoPE (3, B, S): (h, the MoE layers' summed auxiliary
        loss, None for the other families). With ``sp``, h and the
        positions are the sequence rank's block."""
        family = self.cfg.family
        if family == "ssm":
            return self._run_ssm_stack(params, h, train=train, tp=tp, sp=sp), None
        if family == "hybrid":
            return self._run_hybrid_stack(params, h, positions=positions, train=train,
                                          tp=tp, sp=sp), None
        return self._run_decoder_stack(params, h, positions=positions, train=train, tp=tp,
                                       q_pos=q_pos, sp=sp)

    def _run_decoder_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                           train: bool = False, tp: MeshCtx | None = None,
                           q_pos: torch.Tensor | None = None, sp: MeshCtx | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layer stack: h (B, S, D) bf16, positions (B, S), or (3, B, S)
        for M-RoPE. Query and key positions are ``positions[0]``, for M-RoPE
        the temporal stream's ``positions[0, 0]`` (as in the reference);
        the flash kernel masks by index instead, 0..S-1. With ``train``,
        every layer attends with ``gqa_attention``
        and runs under ``torch.utils.checkpoint`` (its activations are
        recomputed in the backward). Returns (h, aux): the MoE layers'
        auxiliary losses added in layer order (the reference's f32 carry
        from 0), None for the dense family. With ``tp``, h is this rank's
        block of the sequence, the positions whole. ``q_pos`` replaces the
        query and key positions (a batch's block on a mesh: the global
        batch's first temporal stream, which the reference masks every row
        by). With ``sp``, h and the positions are the sequence rank's block
        (the windows the whole sequence's)."""
        S = positions.shape[-1] * (1 if sp is None else sp.n_batch)
        cos, sin = self._rope(positions)
        if q_pos is None:
            q_pos = positions[0, 0] if self.cfg.rope_style == "mrope" else \
                _train_pos(positions, sp)
        train_pos = {"train_pos": q_pos} if train else {}
        aux = None
        layers = _layers(self._tp_layers(params["layers"], tp))
        for lp, window in zip(layers, self._windows(S)):
            h, a = _checkpointed(self._dense_block, lp, h, train=train, saves=sp, cos=cos,
                                 sin=sin, window=window, tp=tp, sp=sp, **train_pos)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    def _run_ssm_stack(self, params: Params, h: torch.Tensor, *, train: bool = False,
                       tp: MeshCtx | None = None, sp: MeshCtx | None = None) -> torch.Tensor:
        """The SSM stack: h + mamba2_mixer(rms_norm(h)) for each layer; with
        ``train``, each layer under ``torch.utils.checkpoint``."""
        for lp in _layers(self._tp_layers(params["layers"], tp)):
            h = _checkpointed(self._mamba_layer, lp, h, train=train, saves=sp, tp=tp, sp=sp)
        return h

    def _run_hybrid_stack(self, params: Params, h: torch.Tensor, *, positions: torch.Tensor,
                          train: bool = False, tp: MeshCtx | None = None,
                          sp: MeshCtx | None = None) -> torch.Tensor:
        """Zamba2: after every ``shared_attn_every`` Mamba2 layers, the one
        shared block (causal, unwindowed attention, then its SwiGLU MLP); the
        trailing ``n_layers mod shared_attn_every`` layers run with no shared
        block after them. The shared block attends with the flash kernel, or
        with ``train`` with ``gqa_attention``; then each Mamba2 layer and
        each application of the shared block runs under
        ``torch.utils.checkpoint`` (the reference checkpoints per group and
        per layer: the same numbers). With ``tp``, h is this rank's block of
        the sequence and the shared block's K/V weights are cut to the
        rank's heads once a step. With ``sp``, h is the sequence rank's
        block: each Mamba2 layer relays its state and the shared block
        gathers its keys over the batch axes."""
        cos, sin = self._rope(positions)
        E = self.cfg.shared_attn_every
        # "no window" is 0 for the flash kernel, None for gqa_attention (to
        # which 0 would mask every key)
        attn = dict(cos=cos, sin=sin, window=None, train_pos=_train_pos(positions, sp)) \
            if train else dict(cos=cos, sin=sin, window=0)
        shared = self._tp_layers(params["shared"], tp, "shared")
        for i, lp in enumerate(_layers(self._tp_layers(params["layers"], tp))):
            h = _checkpointed(self._mamba_layer, lp, h, train=train, saves=sp, tp=tp, sp=sp)
            if (i + 1) % E == 0:
                h, _ = _checkpointed(self._dense_block, shared, h, train=train, saves=sp, tp=tp,
                                     sp=sp, **attn)
        return h

    def _run_encdec(self, params: Params, batch: dict, *, train: bool = False,
                    tp: MeshCtx | None = None, sp: MeshCtx | None = None) -> torch.Tensor:
        """Whisper: the encoder over ``batch["audio_embeds"]`` (B, Sa, D) in
        the configuration's dtype (its positions baked into the stub), its
        final layer norm, then the decoder over ``embed[tokens] +
        dec_pos[:St]`` (added in bf16). Attention by the flash kernel (no
        window), or with ``train`` by ``gqa_attention`` with each layer under
        ``torch.utils.checkpoint``. Returns the decoder's h (B, St, D). With
        ``tp``, h is this rank's block of the sequence, and the encoder's
        output is gathered over "model" once for every cross-attention. With
        ``sp`` the frames and the tokens are the sequence rank's blocks: the
        encoder runs on its frames, its output is gathered over the batch
        axes once for every cross-attention, and the decoder runs on its
        tokens at their positions from the block's offset."""
        enc_out = self._encode(params, batch["audio_embeds"], train=train, tp=tp, sp=sp)
        if tp is not None:
            enc_out = tp.gather_seq(enc_out)
        if sp is not None:
            enc_out = sp.gather_seq(enc_out, axes=sp.batch_axes)
        tokens = batch["tokens"]
        St = tokens.shape[1]
        first = 0 if sp is None else sp.seq_rank * St
        pos = slice(first, first + St)
        if tp is None:
            h = (params["embed"][tokens] + params["dec_pos"][pos]).to(dt(self.cfg))
        else:
            h = self._embed(params, tokens, tp) + _rank_block(self._dec_pos(params, tp)[pos],
                                                             tp, dim=0)
        attn = _no_rope(St * (1 if sp is None else sp.n_batch), h.device, train)
        for lp in _layers(self._tp_layers(params["dec"], tp, "dec")):
            h = _checkpointed(self._dec_layer, lp, h, enc_out, train=train, saves=sp, tp=tp,
                              sp=sp, **attn)
        return h

    def _encode(self, params: Params, audio: torch.Tensor, *, train: bool = False,
                tp: MeshCtx | None = None, sp: MeshCtx | None = None) -> torch.Tensor:
        """The encoder's output (B, Sa, D): its layers over ``audio`` (B, Sa,
        D) in the configuration's dtype, then its final layer norm. With
        ``tp``, this rank's block of the frames (B, Sa/n, D). With ``sp``,
        ``audio`` is the sequence rank's block of the frames, and so is the
        output: the attention gathers the keys over the batch axes."""
        h = audio.to(dt(self.cfg))
        attn = _no_rope(h.shape[1] * (1 if sp is None else sp.n_batch), h.device, train)
        if tp is not None:
            h = _rank_block(h, tp)
        for lp in _layers(self._tp_layers(params["enc"], tp, "enc")):
            h = _checkpointed(self._enc_layer, lp, h, train=train, saves=sp, tp=tp, sp=sp,
                              **attn)
        return layer_norm(h, params["enc_final_ln"], params["enc_final_b"], self.cfg.norm_eps)

    def _enc_layer(self, lp: dict, h: torch.Tensor, tp: MeshCtx | None = None,
                   sp: MeshCtx | None = None, **attn) -> torch.Tensor:
        """An encoder layer: non-causal self-attention, then the GELU MLP,
        each after a layer norm (``attn``: ``_no_rope``)."""
        eps = self.cfg.norm_eps
        x = layer_norm(h, lp["ln1"], lp["b1"], eps)
        h = h + self._attn_sp(lp, x, tp, causal=False, sp=sp, **attn)
        return h + self._gelu(lp, layer_norm(h, lp["ln2"], lp["b2"], eps), tp)

    def _dec_layer(self, lp: dict, h: torch.Tensor, enc_out: torch.Tensor,
                   tp: MeshCtx | None = None, sp: MeshCtx | None = None,
                   **attn) -> torch.Tensor:
        """A decoder layer: causal self-attention, cross-attention against
        ``enc_out`` (non-causal; with ``tp`` or ``sp`` the whole gathered
        sequence: the cross-attention gathers nothing more), then the GELU
        MLP, each after a layer norm."""
        eps = self.cfg.norm_eps
        x = layer_norm(h, lp["ln1"], lp["b1"], eps)
        h = h + self._attn_sp(lp, x, tp, sp=sp, **attn)
        x = layer_norm(h, lp["ln2"], lp["b2"], eps)
        h = h + self._attn_sp(_cross(lp), x, tp, causal=False, kv=enc_out, **attn)
        return h + self._gelu(lp, layer_norm(h, lp["ln3"], lp["b3"], eps), tp)

    def _gelu(self, lp: dict, x: torch.Tensor, tp: MeshCtx | None = None,
              decode: bool = False) -> torch.Tensor:
        """The encoder-decoder's MLP: ``gelu_mlp`` over ``wg`` and ``wd`` with
        zero biases, as the reference calls it. With ``tp`` column-parallel
        on ``wg`` and row-parallel on ``wd`` (x this rank's block of the
        sequence, or with ``decode`` the whole token): each rank adds the
        zero bias to its partial sums, which leaves them as they are; where
        d_ff does not divide "model", replicated, on x as it is."""
        zero = x.new_zeros(())

        def mlp(v: torch.Tensor) -> torch.Tensor:
            return gelu_mlp(v, lp["wg"], zero, lp["wd"], zero)

        if tp is None or not self._splits(tp, self.cfg.d_ff):
            return mlp(x)
        return tp.psum_model(mlp(x)) if decode else _sp(mlp, x, tp)

    def _final_norm(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.family == "encdec":
            return layer_norm(h, params["final_ln"], params["final_b"], self.cfg.norm_eps)
        return rms_norm(h, params["final_ln"], self.cfg.norm_eps)

    def _head(self, params: Params, h: torch.Tensor, tp: MeshCtx | None = None) -> torch.Tensor:
        """The final norm of h (whole tokens), then the head's (or the tied
        embedding's) product; on a rank of a split vocab, its block of the
        logits; where ``tp`` splits d_model (the vocab does not divide
        "model"), the sum over "model" of each rank's block product: the
        whole logits; where it splits neither, the whole product."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        x = self._final_norm(params, h)
        if tp is None or self._vocab_parallel(tp) or self._head_whole(tp):
            return x @ w
        return tp.reduce_model(_rank_block(x, tp, dim=-1) @ w)

    def _logits(self, params: Params, h: torch.Tensor, tp: MeshCtx | None = None) -> torch.Tensor:
        """f32 logits (B, V) of h (B, 1, D); with ``tp`` on a split vocab,
        each rank's block of it gathered over "model"."""
        logits = self._head(params, h, tp)[:, 0].float()
        return tp.all_gather(logits, dim=-1) if self._vocab_parallel(tp) else logits

    # ------------------------------------------------------------- training
    def loss_fn(self, params: Params, batch: dict, ctx: MeshCtx | None = None,
                sp: MeshCtx | None = None) -> torch.Tensor:
        """The training loss (f32 0-d) of ``batch`` = {"tokens", "labels"}
        (B, S) int ({"embeds", "positions", "labels"} for the VLM,
        {"audio_embeds", "tokens", "labels"} for the encoder-decoder): the
        reference's ``loss_fn``, the mean next-token cross-entropy, plus
        ``0.01 * aux`` for the MoE family (aux summed over its layers). The
        dense, SSM and hybrid families have no auxiliary loss and return the
        cross-entropy (the reference adds ``0.01 * 0``). The embedding's
        output and the attention's score chain take the configuration's
        dtype: bf16 for every configuration of the catalog, as in the
        reference. A ``dtype="float32"`` configuration thus computes the
        whole step in f32 (the reference keeps both in bf16 there), which
        makes it a precise witness of a bf16 step from the same weights.

        With a mesh ``ctx`` the batch is this rank's block and the
        cross-entropy runs in chunks (``_cross_entropy``); the loss is this
        block's mean, which the train step averages over the ranks. Where
        the step is tensor-parallel (``tp_ctx``) the parameters are this
        rank's blocks, and every rank of a model group gets the same loss.
        With ``sp`` (``seq_ctx`` of the global batch: its sequence sharded
        over the batch axes) the batch is this rank's block of the
        sequence and the loss that block's mean, which the step averages
        over the batch axes into the whole sequence's.

        The MoE forward is deterministic (stable sorts, no atomics), so the
        recompute in the backward routes exactly as the forward did."""
        tp = self.tp_ctx(ctx)
        h, aux = self._forward(params, batch, train=True, tp=tp, sp=sp)
        ce = self._cross_entropy(params, h, batch["labels"], ctx, sp=sp)
        return ce if aux is None else ce + 0.01 * aux

    def _cross_entropy(self, params: Params, h: torch.Tensor, labels: torch.Tensor,
                       ctx: MeshCtx | None = None, chunk: int = CE_CHUNK,
                       sp: MeshCtx | None = None) -> torch.Tensor:
        """CE over the vocab. Without a mesh, or for S <= chunk, from the
        whole (B, S, V) f32 logits (the reference's single-device form).
        With a mesh the loss streams over sequence chunks, each under
        ``torch.utils.checkpoint``: the peak holds one chunk's f32 logits,
        and the head's product is recomputed chunk by chunk in the backward;
        the chunks' summed losses, over B * S. Where the mesh runs tensor
        parallelism (``tp_ctx``) the sequence is gathered first and each
        chunk's logits hold this rank's block of the vocab
        (``vocab_parallel_ce``), as the reference lays them out, or where
        d_model is split, the whole vocab (``_head``). Where neither is (a
        replicated head: ``_head_whole``), each rank takes the loss of its
        own block of the sequence on whole logits, and the sum over
        "model" (``reduce_model``) is the whole sequence's. With ``sp`` the
        sequence is this sequence rank's block of a sequence of S *
        n_batch, and the chunks are that sequence's (``_ce_pieces``): the
        mean over the block, which the step averages over the batch
        axes."""
        tp = self.tp_ctx(ctx)
        rows = self._head_whole(tp)
        if rows:
            labels = _rank_block(labels, tp)
        elif tp is not None:
            h = tp.gather_seq(h)
        B, S, _ = h.shape
        whole = S * tp.n_model if rows else S  # this sequence rank's block: all of it without sp
        total = whole * (sp.n_batch if sp is not None else 1)

        def summed(loss: torch.Tensor) -> torch.Tensor:
            return (tp.reduce_model(loss) if rows else loss) / (B * whole)

        if ctx is None or total <= chunk:
            loss = self._chunk_loss(params, h, labels, tp)
            return summed(loss.sum()) if rows else loss.mean()
        if total % chunk:
            raise ValueError(f"the chunked cross-entropy needs S ({total}) divisible by {chunk}")
        first = 0 if sp is None else sp.seq_rank * whole + (tp.model_rank * S if rows else 0)
        tot = h.new_zeros((), dtype=torch.float32)
        for i, n in _ce_pieces(first, S, chunk):
            hc, lc = h[:, i:i + n], labels[:, i:i + n]
            tot = tot + checkpoint(lambda x, y: self._chunk_loss(params, x, y, tp).sum(), hc, lc,
                                   use_reentrant=False)
        return summed(tot)

    def _chunk_loss(self, params: Params, h: torch.Tensor, labels: torch.Tensor,
                    tp: MeshCtx | None = None) -> torch.Tensor:
        """Each position's f32 cross-entropy (B, S): logsumexp minus the
        label's logit."""
        logits = self._head(params, h, tp).float()
        if self._vocab_parallel(tp):
            return vocab_parallel_ce(logits, labels, tp)
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, labels[..., None].long())[..., 0]

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

    def cache_specs(self, B: int, S: int, ctx: MeshCtx) -> dict[str, NamedSharding]:
        """The cache's shardings, the reference's: the batch dim over the
        batch axes where B fills them, else the sequence dim of K/V; "model"
        on the KV heads (else head_dim) of K/V, on the heads of the SSM
        state and on the conv window's channels where they divide."""
        out = {}
        batch_ok = B >= ctx.n_batch and B % ctx.n_batch == 0
        for name, (shape, _) in self.cache_template(B, S).items():
            spec: list = [None] * len(shape)
            if batch_ok:
                spec[1] = ctx.batch_axes
            if name in ("k", "v", "xk", "xv"):
                if shape[3] % ctx.n_model == 0:
                    spec[3] = "model"
                elif shape[4] % ctx.n_model == 0:
                    spec[4] = "model"
                if not batch_ok:
                    spec[2] = ctx.batch_axes  # sequence sharding
            elif shape[3] % ctx.n_model == 0:  # ssm: heads; conv: channels
                spec[3] = "model"
            out[name] = ctx.ns(*spec)
        return out

    def decode_step(self, params: Params, cache: dict[str, torch.Tensor], batch: dict,
                    ctx: MeshCtx | None = None, seq_sharded: bool = False
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One token for the whole batch against the cache.

        batch: {"token": (B,) int, "cur_len": int}, or for embeddings input
        (the VLM) {"embed": (B, D), "cur_len"}. Writes the new K/V at
        ``cur_len``, and each Mamba2 layer's new conv window and SSM state,
        into ``cache`` in place (the reference returns a new cache; updating
        in place spares a copy of the whole cache per token) and returns
        (logits (B, V) f32, cache). The SSM family reads no ``cur_len``. The
        embedding's output takes the configuration's dtype, as in the prefill
        and ``loss_fn``; the encoder-decoder adds ``dec_pos[cur_len]``.

        With ``ctx`` where the model is tensor-parallel (``tp_ctx`` with
        ``serve``: a pure data-parallel model too), the parameters and the
        cache are this rank's blocks (``param_specs``,
        ``cache_specs``: the KV heads, or head_dim where the rank expands
        them, the SSM state's heads, the conv window's channels), the token
        this rank's block of the batch, the same on every rank of a model
        group: the out-projections' partial sums are all-reduced over
        "model" and the logits gathered (or, on a split d_model, summed)
        over it. In the fallback layouts the attention runs on the rank's
        block of head_dim (its partial scores and out-projection summed
        over "model"), and a replicated MLP, MoE layer, mixer or head whole
        on every rank.

        With ``seq_sharded`` (the batch does not fill the batch axes:
        ``seq_ctx``, which the serve step checks), the token is the whole
        batch on every rank and the K/V cache this rank's block of the
        sequence (``cache_specs``): the rank that holds position
        ``cur_len`` writes the new K/V, each rank attends on its block
        (``gqa_attention(seq_split=)``; in the head_dim fallback on its
        head_dim block of it; the encoder-decoder's cross-attention on its
        block of ``xk``/``xv``'s frames), and the conv and SSM caches, which
        the batch axes do not shard, step alike on every rank."""
        cfg = self.cfg
        tp = self.tp_ctx(ctx, serve=True)
        sp = ctx if seq_sharded else None
        cur = int(batch["cur_len"])
        S = cache["k"].shape[2] * (1 if sp is None else sp.n_batch) if "k" in cache else 0
        if "k" in cache and not 0 <= cur < S:
            raise ValueError(f"cur_len {cur} outside the {S}-long cache")
        if cfg.embeddings_input:
            x = batch["embed"].to(dt(cfg))
        else:
            x = self._embed(params, batch["token"], tp, decode=True)
        if cfg.family == "encdec":
            x = x + self._dec_pos(params, tp)[cur]
        h = x[:, None, :]
        family = cfg.family
        if family == "ssm":
            h = self._decode_ssm(params, cache, h, tp)
        elif family == "hybrid":
            h = self._decode_hybrid(params, cache, h, cur, tp, sp)
        elif family == "encdec":
            h = self._decode_encdec(params, cache, h, cur, tp, sp)
        else:
            h = self._decode_dense(params, cache, h, cur, tp, sp)
        return self._logits(params, h, tp), cache

    def _decode_attn(self, lp: dict, h: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur: int, *, window: int | None,
                     pos1: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     tp: MeshCtx | None = None, sp: MeshCtx | None = None) -> torch.Tensor:
        """The attention of one token against its layer's cache (B, S, KV,
        hd), the new K/V written at ``cur``: its output, whole. With
        ``tp``, on this rank's heads (the out-projection's partial sums,
        all-reduced over "model"); where the rank expands the KV heads its
        cache holds a block of head_dim, gathered to read. In the fallback
        layout the weights and the cache hold this rank's block of head_dim
        (``_qkv`` with ``hd_split``; ``gqa_attention`` sums the partial
        scores), or all of it where head_dim does not divide "model". With
        ``sp`` the cache is this sequence rank's block (of head_dim in the
        fallback): the new K/V is written where the rank holds ``cur`` (its
        head_dim block), and the softmax runs over the ranks' blocks
        (``gqa_attention(seq_split=)``, in the order it states)."""
        S = k_cache.shape[1]  # the per-layer cache is (B, S, KV, hd), or a rank's block of S
        first = 0 if sp is None else sp.seq_rank * S
        mine = 0 <= cur - first < S  # this rank holds position cur
        hd_split = tp if self._hd_fallback(tp) and k_cache.shape[-1] != self.cfg.hd else None
        q, k_new, v_new = self._qkv(lp, h, cos, sin, hd_split=hd_split)
        k_pos = torch.arange(first, first + S, dtype=torch.int32, device=h.device)

        def written(c: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            """The cache with the new K or V at ``cur`` (where this rank holds
            it), whole along head_dim: where the rank expands the KV heads its
            cache holds a block of head_dim, written and gathered."""
            split = c.shape[-1] != new.shape[-1]
            if mine:
                c[:, cur - first] = new[:, 0].chunk(tp.n_model, dim=-1)[tp.model_rank] \
                    if split else new[:, 0]
            return tp.all_gather(c, dim=-1) if split else c

        k, v = written(k_cache, k_new), written(v_cache, v_new)
        if self._expands(tp):
            k, v = expand_kv_to_local_heads(k, v, q.shape[2], tp)
        o = gqa_attention(q, k, v, q_pos=pos1, k_pos=k_pos, causal=True, window=window,
                          hd_split=hd_split, seq_split=sp)
        return self._summed(self._out_proj(lp, o), tp, hd_split)

    def _summed(self, y: torch.Tensor, tp: MeshCtx | None,
                hd_split: MeshCtx | None) -> torch.Tensor:
        """A decode attention's out-projection ``y``, whole: all-reduced
        over "model" where it holds the partial sums of the rank's heads or
        block of head_dim (not where the fallback runs it whole)."""
        if tp is None or (self._hd_fallback(tp) and hd_split is None):
            return y
        return tp.psum_model(y)

    def _decode_block(self, lp: dict, h: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur: int, tp: MeshCtx | None = None,
                      sp: MeshCtx | None = None, **attn) -> torch.Tensor:
        """A pre-norm attention block's decode step: attention against its
        cache, then its MLP."""
        x = rms_norm(h, lp["ln1"], self.cfg.norm_eps)
        h = h + self._decode_attn(lp, x, k_cache, v_cache, cur, tp=tp, sp=sp, **attn)
        return h + self._mlp(lp, rms_norm(h, lp["ln2"], self.cfg.norm_eps), tp, decode=True)[0]

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
                      h: torch.Tensor, cur: int, tp: MeshCtx | None = None,
                      sp: MeshCtx | None = None) -> torch.Tensor:
        rope = self._decode_rope(h, cur)
        windows = self._windows(cache["k"].shape[2] * (1 if sp is None else sp.n_batch))
        for i, lp in enumerate(_layers(self._tp_layers(params["layers"], tp, decode=True))):
            h = self._decode_block(lp, h, cache["k"][i], cache["v"][i], cur, tp, sp,
                                   window=windows[i], **rope)
        return h

    def _decode_mamba(self, lp: dict, h: torch.Tensor, cache: dict[str, torch.Tensor],
                      i: int, tp: MeshCtx | None = None) -> torch.Tensor:
        """Mamba2 layer i's decode step; its conv window and state are
        written into the cache. Where the SSM heads do not divide "model",
        the whole mixer (its leaves whole: ``_tp_layers``) on every rank,
        the state replicated, the conv window gathered where ``cache_specs``
        splits its channels and the rank's block written back."""
        x = rms_norm(h, lp["ln"], self.cfg.norm_eps)
        conv = cache["conv"][i]
        if tp is not None and not self._splits(tp, self.cfg.ssm_heads):
            split = conv.shape[-1] != lp["conv_w"].shape[-1]
            y, new, state = ssd.mamba2_decode_step(
                lp, x[:, 0], tp.all_gather(conv, dim=-1) if split else conv, cache["ssm"][i],
                self.cfg)
            conv.copy_(_rank_block(new, tp, dim=-1) if split else new)
            cache["ssm"][i].copy_(state)
            return h + y[:, None]
        y, new, state = ssd.mamba2_decode_step(lp, x[:, 0], conv, cache["ssm"][i], self.cfg, tp)
        conv.copy_(new)
        cache["ssm"][i].copy_(state)
        return h + (y if tp is None else tp.psum_model(y))[:, None]

    def _decode_ssm(self, params: Params, cache: dict[str, torch.Tensor],
                    h: torch.Tensor, tp: MeshCtx | None = None) -> torch.Tensor:
        for i, lp in enumerate(_layers(self._tp_layers(params["layers"], tp, decode=True))):
            h = self._decode_mamba(lp, h, cache, i, tp)
        return h

    def _decode_hybrid(self, params: Params, cache: dict[str, torch.Tensor],
                       h: torch.Tensor, cur: int, tp: MeshCtx | None = None,
                       sp: MeshCtx | None = None) -> torch.Tensor:
        """The hybrid's decode step: the shared block after each group of
        Mamba2 layers attends against its group's K/V, with no window (with
        ``sp``, this sequence rank's block of it)."""
        rope = self._decode_rope(h, cur)
        E = self.cfg.shared_attn_every
        shared = self._tp_layers(params["shared"], tp, "shared", decode=True)
        for i, lp in enumerate(_layers(self._tp_layers(params["layers"], tp, decode=True))):
            h = self._decode_mamba(lp, h, cache, i, tp)
            if (i + 1) % E == 0:
                g = i // E
                h = self._decode_block(shared, h, cache["k"][g], cache["v"][g], cur, tp, sp,
                                       window=None, **rope)
        return h

    def _decode_encdec(self, params: Params, cache: dict[str, torch.Tensor],
                       h: torch.Tensor, cur: int, tp: MeshCtx | None = None,
                       sp: MeshCtx | None = None) -> torch.Tensor:
        """The decoder's step: causal self-attention against the K/V cache,
        then cross-attention of the query (at position 0, non-causal)
        against the cache's ``xk``/``xv``, then the GELU MLP. With ``tp``
        on this rank's heads, whose cross K/V the cache holds (where the
        rank expands the KV heads, a block of head_dim, gathered to read),
        or in the fallback on its block of head_dim; each sublayer's
        partial sums all-reduced over "model". With ``sp`` both attentions
        run on this sequence rank's block of their cache (``cache_specs``
        shards the frames of ``xk``/``xv`` too), their softmax over the
        ranks' blocks (``gqa_attention(seq_split=)``)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        rope = self._decode_rope(h, cur)
        Sa = cache["xk"].shape[2]
        first = 0 if sp is None else sp.seq_rank * Sa
        q_pos = torch.zeros((1,), dtype=torch.int32, device=h.device)
        k_pos = torch.arange(first, first + Sa, dtype=torch.int32, device=h.device)
        for i, lp in enumerate(_layers(self._tp_layers(params["dec"], tp, "dec", decode=True))):
            x = layer_norm(h, lp["ln1"], lp["b1"], eps)
            h = h + self._decode_attn(lp, x, cache["k"][i], cache["v"][i], cur, window=None,
                                      tp=tp, sp=sp, **rope)
            q = _proj(layer_norm(h, lp["ln2"], lp["b2"], eps), lp["xwq"])
            xk, xv = cache["xk"][i], cache["xv"][i]
            if self._expands(tp):
                xk, xv = expand_kv_to_local_heads(
                    *(c if c.shape[-1] == cfg.hd else tp.all_gather(c, dim=-1) for c in (xk, xv)),
                    q.shape[2], tp)
            hd_split = tp if self._hd_fallback(tp) and xk.shape[-1] != cfg.hd else None
            o = gqa_attention(q, xk, xv, q_pos=q_pos, k_pos=k_pos, causal=False,
                              hd_split=hd_split, seq_split=sp)
            h = h + self._summed(self._out_proj(_cross(lp), o), tp, hd_split)
            h = h + self._gelu(lp, layer_norm(h, lp["ln3"], lp["b3"], eps), tp, decode=True)
        return h


def _layers(stacked: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Each layer's parameters, from the stacked (leading L axis) leaves.
    ``unbind``, not ``w[i]``: under autograd each ``w[i]`` adds a zero-padded
    copy of the whole leaf to its gradient (L of them a leaf), ``unbind``
    stacks the layers' gradients once."""
    per_leaf = {name: w.unbind(0) for name, w in stacked.items()}
    n = len(next(iter(per_leaf.values())))
    return [{name: ws[i] for name, ws in per_leaf.items()} for i in range(n)]


def _ce_pieces(first: int, S: int, chunk: int) -> list[tuple[int, int]]:
    """(start, length) of the pieces of rows first..first+S-1 that the
    sequence's chunk grid (multiples of ``chunk``) cuts, starts counted
    from ``first``: the chunks themselves where the rows are whole chunks,
    a rank's part of each chunk its block cuts otherwise."""
    cuts = [first, *range((first // chunk + 1) * chunk, first + S, chunk), first + S]
    return [(a - first, b - a) for a, b in zip(cuts, cuts[1:])]


def _no_rope(S: int, device: torch.device, train: bool) -> dict:
    """The encoder-decoder's attention arguments (no RoPE, no window) for a
    sequence of S (the whole one, which attention sees): the flash
    kernel's, or for ``train`` ``gqa_attention``'s with the query positions
    0..S-1."""
    if not train:
        return {"window": 0, "train_pos": None}
    return {"window": None, "train_pos": torch.arange(S, device=device)}


def _rank_block(x: torch.Tensor, tp: MeshCtx, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (by default the sequence),
    split over "model" in rank order: no communication, x is whole on every
    rank. Contiguous: a reduction over the last dim of a strided block (the
    norms') may add in another order than over the whole tensor's rows."""
    n = x.shape[dim] // tp.n_model
    return x.narrow(dim, tp.model_rank * n, n).contiguous()


def _sp(fn, x: torch.Tensor, tp: MeshCtx | None) -> torch.Tensor:
    """``fn(x)``; with ``tp`` (Megatron-SP), ``fn`` over the sequence of x
    gathered over "model" and its partial sums reduce-scattered back to the
    rank's block."""
    return fn(x) if tp is None else tp.scatter_seq(fn(tp.gather_seq(x)))


def _checkpointed(fn, *args, train: bool, saves: MeshCtx | None = None, **kw):
    """``fn(*args, **kw)``; with ``train``, under ``torch.utils.checkpoint``
    (its activations recomputed in the backward): the counterpart of the
    reference's ``_remat_policy``, ``nothing_saveable`` for every model.
    With ``saves`` (a sequence-sharding context) the region keeps what its
    hops over the batch axes received, and the recompute replays none of
    them (``MeshCtx.recorded``)."""
    if not train:
        return fn(*args, **kw)
    if saves is not None:
        kw["context_fn"] = saves.recorded
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _train_pos(positions: torch.Tensor, sp: MeshCtx | None) -> torch.Tensor:
    """The training attention's query and key positions (S,) of a (B, S)
    ``positions``' first row; with ``sp`` (a sequence rank's block at its
    global positions), the whole sequence's 0..S*n_batch-1: the keys are
    gathered over the batch axes, and the queries are read at their
    offset."""
    if sp is None:
        return positions[0]
    return torch.arange(positions.shape[-1] * sp.n_batch, dtype=positions.dtype,
                        device=positions.device)
