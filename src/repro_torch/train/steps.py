"""train_step / prefill_step / serve_step builders + their shardings.

Without a mesh (``ctx=None``) a step runs on one device. With a ``MeshCtx``
it is data-parallel over the batch axes with ZeRO-1 moments: each rank runs
the model on its block of the batch (``batch_shardings``), and the
collectives are the gradients' reduce-scatter and the fresh parameters'
all-gather (``adamw_update_sharded``), the loss's mean, and the prefill's
and decode's logits gathered over the batch. A pure data-parallel model
(``LM.pure_dp``) runs with whole weights on any mesh, its batch sharded
over every axis where it divides them. Any other model on a mesh whose
"model" axis is larger than 1 runs tensor and expert parallelism over it
(``LM.tp_ctx``): each rank holds its blocks of ``param_specs`` (and, to
decode, of ``cache_specs``), the model makes its collectives over "model"
itself, and the gradient of every leaf that ``param_specs`` does not shard
over "model", which saw only this rank's tokens or heads, is summed over
"model" in f32 before the optimizer. A pure data-parallel model
(whisper-base) decodes on such a mesh as the reference's serve step does:
on its blocks of ``param_specs(ctx, serve=True)``, tensor-parallel. Where
heads, FFN, experts, SSM heads or the vocab with d_model do not divide
"model", the model runs the reference's fallback layouts (head_dim
sharded, or the leaf replicated: ``LM``); a gathered head_dim-sharded leaf
gets its gradient summed back by the gather's backward, a replicated one
by ``_sum_over_model``, each once. A batch that does not fill the batch
axes (the reference's ``long_500k``, B = 1) shards the sequence over them
to prefill, decode and train (``LM.seq_ctx``), in every layout over
"model", for every family: each rank runs its block of the sequence (of
the tokens, of the VLM's embeddings and M-RoPE positions, of the
encoder-decoder's audio frames, as ``batch_shardings`` cuts them); every
rank returns the logits of the whole batch, and the train step's loss and
gradients are the ranks' blocks' averaged over the batch axes (the
gradients once, by the optimizer's reduce-scatter).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.lm import LM, Params
from repro_torch.models.registry import input_specs
from repro_torch.models.sharding import (
    MeshCtx,
    NamedSharding,
    on_model,
)
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init_shapes,
    adamw_specs,
    adamw_update,
    adamw_update_sharded,
)
from repro_torch.tree import Tree, named_leaves, tree_map


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, ctx: MeshCtx,
                    model: LM | None = None) -> dict[str, NamedSharding]:
    """Each input's sharding (the reference's): the batch dim over the batch
    axes, and for a pure data-parallel model over "model" too where B
    divides them all; the sequence dim where B does not fill the batch
    axes; decode's token over the batch axes where it divides them."""
    B = shape.global_batch
    bspec = ctx.token_spec(B)  # (batch-ish, seq-ish)
    pure_dp = (model or LM(cfg, device="cpu")).pure_dp
    if pure_dp and B % (ctx.n_batch * ctx.n_model) == 0:
        bspec = ((*ctx.batch_axes, "model"), None)
    out = {}
    for k, (shp, _) in input_specs(cfg, shape).items():
        if k in ("tokens", "labels"):
            out[k] = ctx.ns(*bspec)
        elif k in ("embeds", "audio_embeds"):
            out[k] = ctx.ns(*bspec, None)
        elif k == "positions":
            out[k] = ctx.ns(None, *bspec)
        elif k in ("token", "embed"):
            sp = (ctx.batch_axes,) if B % ctx.n_batch == 0 and B >= ctx.n_batch else (None,)
            out[k] = ctx.ns(*sp, *([None] * (len(shp) - 1)))
        else:  # cur_len
            out[k] = ctx.replicated()
    return out


def loss_and_grads(model: LM, params: Params, batch: dict, ctx: MeshCtx | None = None,
                   sp: MeshCtx | None = None) -> tuple[torch.Tensor, Params]:
    """``(loss, grads)`` of ``model.loss_fn`` at ``params`` (``sp``: the
    step's sequence sharding, ``LM.seq_ctx``), grads shaped and typed like
    ``params``. The gradients are taken on detached views of the leaves,
    so ``params`` (e.g. the frozen parameters that ``LM.load_params``
    registers for serving) are left as they are."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(live, batch, ctx, sp=sp)
        names, leaves = zip(*named_leaves(live))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    unread = {n for n, g in zip(names, grads) if g is None}
    if unread != model.unread_leaves():
        raise RuntimeError(f"{model.cfg.name}: the loss reads none of {sorted(unread)}; "
                           f"expected {sorted(model.unread_leaves())}")
    # the leaves the reference does not read either (whisper's ``wu``) get
    # zeros, as ``jax.grad`` gives them
    flat = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(flat), live)


def make_train_step(model: LM, ctx: MeshCtx | None = None, opt_cfg: AdamWConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients, then one AdamW step; functional, like the
    reference's (new trees are returned, the inputs are not modified).

    With ``ctx``: ``params`` and ``opt_state`` are trees of DTensors (or
    plain tensors holding the global value, e.g. ``adamw_init``'s), laid
    out as ``training_state_specs`` or any other way; ``batch`` is the
    global batch, the same on every rank. The parameters are gathered to
    ``param_specs`` (replicated for a pure data-parallel model, else
    sharded over "model"), each rank takes the loss (its block's mean) and
    gradients of its block of the batch, which ``adamw_update_sharded``
    averages over the batch axes; the returned parameters are laid out as
    ``param_specs``, the moments as ``adamw_specs``, and the loss is the
    mean over the ranks. Where the batch does not fill the batch axes
    (``LM.seq_ctx``) each rank takes the loss and gradients of its block
    of the sequence, every rank's hops over the sequence adding the other
    ranks' contributions in the backward; they are averaged over the batch
    axes alike."""
    opt_cfg = opt_cfg or AdamWConfig()
    if ctx is None:
        def train_step(params: Params, opt_state: Tree, batch: dict):
            loss, grads = loss_and_grads(model, params, batch)
            params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, loss

        return train_step

    tp = model.tp_ctx(ctx)
    pspecs = model.param_specs(ctx)
    zspecs = adamw_specs(pspecs, model.param_template(), ctx)["m"]

    def sharded_train_step(params: Tree, opt_state: Tree, batch: dict):
        bspecs, dp_axes, sp = _batch_layout(model, ctx, batch, "train", tp)
        params = tree_map(ctx.place, params, pspecs)
        local = tree_map(lambda p: p.to_local(), params)
        block = {k: ctx.local(v, bspecs[k]) for k, v in batch.items()}
        # the reference masks every row by the global batch's first temporal stream
        if "positions" in batch:
            block["mask_pos"] = batch["positions"][0, 0]
        loss, grads = loss_and_grads(model, local, block, ctx, sp)
        if tp is not None:
            grads = _sum_over_model(grads, pspecs, ctx)
        elif "model" in dp_axes and ctx.n_model > 1:  # the batch is sharded over "model" too
            grads = tree_map(lambda g: _mean(g, ctx, ("model",)), grads)
        params, opt_state = adamw_update_sharded(params, grads, opt_state, opt_cfg, ctx,
                                                 pspecs, zspecs)
        # each sequence rank's loss is its block's mean: the mean over them is the sequence's
        return params, opt_state, _mean(loss, ctx, ctx.batch_axes if sp is not None else dp_axes)

    return sharded_train_step


def make_prefill_step(model: LM, ctx: MeshCtx | None = None):
    """``prefill_step(params, batch) -> (B, V) f32`` logits of the last
    position, on the model's device: the family's stack (attention, MoE,
    SSM, hybrid, encoder-decoder or VLM) over ``batch`` (``tokens`` (B, S);
    ``audio_embeds`` (B, Sa, D) and ``tokens`` for the encoder-decoder;
    ``embeds`` (B, S, D) and ``positions`` (3, B, S) for the VLM), as the
    reference's ``make_prefill_step`` dispatches it. The stack's input takes
    the configuration's dtype, as in ``LM.loss_fn``: bf16 for every
    configuration of the catalog, the reference's cast; a
    ``dtype="float32"`` configuration then serves in f32 throughout (the
    reference casts it to bf16).

    With ``ctx`` each rank runs its block of the global ``batch`` with its
    blocks of the weights (DTensors or plain tensors holding the global
    value; whole for a pure data-parallel model, else laid out as
    ``param_specs``, the last position's hidden state taken from the rank
    that holds it and the logits gathered over "model") and the logits are
    gathered over the batch's axes: every rank returns all B rows. Where
    the batch does not fill the batch axes (``LM.seq_ctx``) each rank runs
    its block of the sequence; the last position's hidden state is taken
    from the last sequence rank (of the model group's blocks, the last), and
    every rank returns the B rows whole."""
    @torch.no_grad()
    def local_prefill(params: Params, batch: dict, tp: MeshCtx | None = None,
                      sp: MeshCtx | None = None) -> torch.Tensor:
        h, _ = model._forward(params, batch, tp=tp, sp=sp)
        # the ranks that hold blocks of the sequence, in its order: the last one holds its end
        axes = (sp.batch_axes if sp is not None else ()) + (("model",) if tp is not None else ())
        last = h[:, -1:] if not axes else (tp or sp).gather_seq(h[:, -1:], axes=axes)[:, -1:]
        return model._logits(params, last, tp)

    if ctx is None:
        return local_prefill
    tp = model.tp_ctx(ctx)
    pspecs = model.param_specs(ctx) if tp is not None else None

    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        bspecs, dp_axes, sp = _batch_layout(model, ctx, batch, "prefill", tp)
        local = _local_params(params, pspecs, ctx)
        logits = local_prefill(local, {k: ctx.local(v, bspecs[k]) for k, v in batch.items()},
                               tp, sp)
        return logits if sp is not None else ctx.all_gather(logits, dp_axes)

    return prefill_step


def make_serve_step(model: LM, ctx: MeshCtx | None = None):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one decode
    step (``LM.decode_step``; the cache is updated in place).

    With ``ctx`` each rank decodes its block of the batch: ``cache`` is a
    tree of DTensors laid out as ``LM.cache_specs`` (its local blocks
    updated in place), ``batch`` the global token (or embedding) and
    ``cur_len``; where "model" is larger than 1 the parameters are this
    rank's blocks of ``param_specs`` (with ``serve=True`` for a pure
    data-parallel model, whose decode the reference runs tensor-parallel
    on them) and the cache's heads are sharded over it
    (``LM.decode_step``); the logits are gathered over the batch axes.
    Where the batch does not fill the batch axes (``LM.seq_ctx``) the token
    is whole on every rank, the K/V cache's sequence (and the
    encoder-decoder's cross cache's frames) is sharded over them
    (``cache_specs``), and every rank returns the B rows whole."""
    @torch.no_grad()
    def serve_step(params: Params, cache: dict, batch: dict):
        return model.decode_step(params, cache, batch)

    if ctx is None:
        return serve_step
    tp = model.tp_ctx(ctx, serve=True)
    pspecs = model.param_specs(ctx, serve=model.pure_dp) if tp is not None else None

    @torch.no_grad()
    def sharded_serve_step(params: Params, cache: dict, batch: dict):
        key = "embed" if "embed" in batch else "token"
        B, S = batch[key].shape[0], cache["k"].shape[2] if "k" in cache else 0
        sp = model.seq_ctx(ctx, B)
        frames = cache["xk"].shape[2] if "xk" in cache else 0
        if sp is not None and S % ctx.n_batch:
            raise ValueError(f"a {S}-long cache does not split over {ctx.n_batch} batch ranks")
        if sp is not None and frames % ctx.n_batch:
            raise ValueError(f"a cross cache of {frames} frames does not split over "
                             f"{ctx.n_batch} batch ranks")
        cspecs = model.cache_specs(B, S, ctx)
        blocks = {k: ctx.local(v, cspecs[k]) for k, v in cache.items()}
        rows = ctx.token_spec(B)[:1]  # the batch axes, or None: the token whole on every rank
        tok = ctx.local(batch[key], ctx.ns(*rows, *([None] * (batch[key].ndim - 1))))
        logits, _ = model.decode_step(_local_params(params, pspecs, ctx), blocks,
                                      {key: tok, "cur_len": batch["cur_len"]}, ctx,
                                      seq_sharded=sp is not None)
        return (logits if sp is not None else ctx.all_gather(logits, ctx.batch_axes)), cache

    return sharded_serve_step


def training_state_shapes(model: LM) -> tuple[dict, dict]:
    """(parameter, optimizer state) trees of (shape, dtype)."""
    ps = model.param_template()
    return ps, adamw_init_shapes(ps)


def training_state_specs(model: LM, ctx: MeshCtx) -> tuple[dict, dict]:
    """(parameter *storage* specs, optimizer specs), the reference's: the
    parameters stored in the ZeRO (batch-sharded) layout between steps,
    which the train step gathers to the compute layout."""
    ospecs = adamw_specs(model.param_specs(ctx), model.param_template(), ctx)
    return ospecs["m"], ospecs


def _local_params(params: Params, pspecs: Tree | None, ctx: MeshCtx) -> Params:
    """This rank's blocks of ``params`` laid out as ``pspecs``; whole where
    ``pspecs`` is None."""
    if pspecs is None:
        return tree_map(lambda p: ctx.local(p, ctx.replicated()), params)
    return tree_map(ctx.local, params, pspecs)


def _sum_over_model(grads: Tree, pspecs: Tree, ctx: MeshCtx) -> Tree:
    """The gradients of the leaves that ``pspecs`` does not shard over
    "model" (the norms, the router, the SSM's shared and per-head leaves:
    each rank's is that of its tokens or heads alone) summed over "model"
    in f32, in one all-reduce, and rounded back to their dtypes; the
    sharded leaves' as they are."""
    names = [n for n, s in named_leaves(pspecs) if not on_model(s)]
    flat = dict(named_leaves(grads))
    if names:
        summed = ctx.all_reduce(torch.cat([flat[n].float().reshape(-1) for n in names]))
        for n, part in zip(names, summed.split([flat[n].numel() for n in names])):
            flat[n] = part.view(flat[n].shape).to(flat[n].dtype)
    leaves = iter(flat[n] for n, _ in named_leaves(grads))
    return tree_map(lambda _: next(leaves), grads)


def _batch_layout(model: LM, ctx: MeshCtx, batch: dict, kind: str, tp: MeshCtx | None
                  ) -> tuple[dict[str, NamedSharding], tuple[str, ...], MeshCtx | None]:
    """The global ``batch``'s shardings (``batch_shardings``), the mesh axes
    its batch dim is sharded over, and the step's sequence-sharding context
    (``LM.seq_ctx``: None where the batch fills the batch axes, () its
    axes then; ``tp``, the step's tensor-parallel context, splits each
    sequence rank's block again over "model"); raises where a sequence
    (the tokens or embeddings, the encoder's audio frames) does not split
    over the axes that shard it."""
    seq = batch["tokens" if "tokens" in batch else "embeds"]
    B, S = seq.shape[:2]
    bspecs = batch_shardings(model.cfg, ShapeConfig("step", S, B, kind), ctx, model)
    dp_axes = bspecs["tokens" if "tokens" in bspecs else "embeds"].spec[0]
    sp = model.seq_ctx(ctx, B, train=kind == "train")
    lengths = {"a sequence": S}
    if "audio_embeds" in batch:
        lengths["audio frames"] = batch["audio_embeds"].shape[1]
    if sp is not None:
        n = ctx.n_batch * (ctx.n_model if tp is not None else 1)
        for what, m in lengths.items():
            if m % n:
                raise ValueError(f"{what} of {m} does not split over {ctx.n_batch} batch ranks"
                                 + (f" x model={ctx.n_model}" if tp is not None else ""))
        return {k: bspecs[k] for k in batch}, (), sp
    if "model" not in dp_axes and ctx.n_model > 1:
        for what, n in lengths.items():
            if n % ctx.n_model:
                raise ValueError(f"{what} of {n} does not split over model={ctx.n_model}")
    return {k: bspecs[k] for k in batch}, tuple(dp_axes), None


def _mean(x: torch.Tensor, ctx: MeshCtx, axes: tuple[str, ...]) -> torch.Tensor:
    """``x`` averaged over ``axes`` in f32, in ``x``'s dtype."""
    return ctx.all_reduce(x.float(), axes, "avg").to(x.dtype)
