"""AdamW on nested dicts of tensors (no ``torch.optim``), with ZeRO-1 style
sharding on a mesh.

The reference's ``repro.train.optimizer``: a global-norm clip in f32, f32
moments with bias correction, decoupled weight decay on leaves with
``ndim >= 2`` only (the stacked norms ``ln1``/``ln2`` (L, D) are decayed,
``final_ln`` (D,) is not), and the update rounded in the reference's order:
``p * decay`` in the parameter's dtype (the factor too), minus ``(lr *
delta)`` cast to that dtype. ``torch.optim.AdamW`` differs in the clip, the
decay rule and that rounding order.

The state is ``{"m": tree, "v": tree, "step": int32 0-d tensor}``. On a mesh
(``adamw_update_sharded``) the moments are sharded like their parameter
plus the batch axes on the first still-unsharded divisible dim
(``adamw_specs``): each rank keeps and updates its block of them, and the
only traffic is the gradients' reduce-scatter and the fresh parameters'
all-gather, over the batch axes (a parameter sharded over "model" too keeps
that block), made by the ``MeshCtx``'s counted collectives.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import MeshCtx, NamedSharding, on_model
from repro_torch.tree import Tree, named_leaves, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Tree) -> Tree:
    """Zero f32 moments shaped like ``params``, and step 0, on their device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_init_shapes(param_shapes: Tree) -> Tree:
    """The state's (shape, dtype) tree for a tree of (shape, dtype) leaves
    (``LM.param_template()``)."""
    f32 = lambda sd: (tuple(sd[0]), torch.float32)  # noqa: E731
    return {"m": tree_map(f32, param_shapes), "v": tree_map(f32, param_shapes),
            "step": ((), torch.int32)}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig) -> tuple[Tree, Tree]:
    """One AdamW step: returns ``(new params, new state)``; the inputs are
    not modified."""
    step = state["step"] + 1
    gnorm2 = sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads))
    scale, b1c, b2c = _factors(cfg, gnorm2, step)
    out = tree_map(lambda p, g, m, v: _upd(cfg, p, g, m, v, scale, b1c, b2c),
                   params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}


def _factors(cfg: AdamWConfig, gnorm2: torch.Tensor, step: torch.Tensor) -> tuple:
    """The clip's scale for the gradient's squared norm, and the bias
    corrections at ``step``."""
    scale = torch.clamp(cfg.grad_clip / (torch.sqrt(gnorm2) + 1e-9), max=1.0)
    return scale, 1.0 - cfg.b1 ** step.float(), 1.0 - cfg.b2 ** step.float()


def _upd(cfg: AdamWConfig, p, g, m, v, scale, b1c, b2c) -> tuple:
    """One leaf's (or one block's) update: (p, m, v)."""
    g32 = g.float() * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g32
    v2 = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
    mh = m2 / b1c
    vh = v2 / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps)
    step_term = (cfg.lr * delta).to(p.dtype)
    decay = (1.0 - cfg.lr * cfg.weight_decay) if p.ndim >= 2 else 1.0
    # the reference's Python scalar takes the parameter's dtype (JAX's weak
    # typing): in bf16 a decay above 1 - 2**-9 rounds to 1
    decay = float(torch.tensor(decay, dtype=torch.float32).to(p.dtype))
    return p * decay - step_term, m2, v2


def _zero1(spec_sharding: NamedSharding, shape: tuple[int, ...], ctx: MeshCtx) -> NamedSharding:
    """Add the batch axes on an unsharded dim divisible by them.

    For stacked per-layer params (ndim >= 3) dim0 is the layer axis; the
    reference prefers trailing dims there (its optimizer update sinks into
    the backward's layer scan, which slices dim0), and so does the port, so
    that the two shard the moments alike."""
    spec = list(spec_sharding.spec) + [None] * (len(shape) - len(spec_sharding.spec))
    used = {a for s in spec if s is not None for a in ((s,) if isinstance(s, str) else s)}
    if any(a in used for a in ctx.batch_axes):
        return spec_sharding
    nb = ctx.n_batch
    order = list(range(len(shape)))
    if len(shape) >= 3:
        order = order[1:] + [order[0]]
    for i in order:
        if spec[i] is None and shape[i] % nb == 0 and shape[i] >= nb:
            spec[i] = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
            return ctx.ns(*spec)
    return spec_sharding


def adamw_specs(param_specs: Tree, param_shapes: Tree, ctx: MeshCtx) -> Tree:
    """The state's shardings: each moment like its parameter plus
    ``_zero1``'s batch axes; ``step`` replicated. ``param_shapes`` is a
    tree of (shape, dtype) (``LM.param_template()``)."""
    mk = lambda ns, sd: _zero1(ns, tuple(sd[0]), ctx)  # noqa: E731
    return {"m": tree_map(mk, param_specs, param_shapes),
            "v": tree_map(mk, param_specs, param_shapes),
            "step": ctx.replicated()}


def _zero_dim(pspec: NamedSharding, zspec: NamedSharding) -> int | None:
    """Dim where the zero spec added the batch axes (None if unsharded)."""
    ps = list(pspec.spec) + [None] * 8
    zs = list(zspec.spec) + [None] * 8
    for i, (a, b) in enumerate(zip(ps, zs)):
        if a != b:
            return i
    return None


@torch.no_grad()
def adamw_update_sharded(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig, ctx: MeshCtx,
                         param_specs: Tree, zero_specs: Tree) -> tuple[Tree, Tree]:
    """AdamW with explicit ZeRO-1 over the batch axes of ``ctx``.

    ``params`` (laid out as ``param_specs``) and ``state`` (moments as
    ``zero_specs``, ``step`` replicated) are trees of DTensors, or of plain
    tensors holding the global value; ``grads`` are this rank's gradients of
    its own loss, shaped like its blocks of the parameters. Each gradient is
    averaged over the batch axes and reduce-scattered to its ZeRO dim (a
    leaf with no divisible dim is all-reduced whole), in f32 and rounded
    back to the gradient's dtype: the reference's compiled sharded step
    all-reduces its bf16 weights' gradients in f32. The global-norm clip
    sums the shards' squares, all-reduced over the batch axes, and for the
    leaves ``param_specs`` shards over "model" over that axis too. Each
    rank then runs ``adamw_update``'s update on its blocks (the same ops in
    the same order) and all-gathers its block of the new parameters over
    the batch axes.

    Returns ``(params, state)`` as DTensors laid out as the specs: the
    moments and ``step`` as this rank keeps them, the parameters whole
    again. Given the same whole gradients on every rank, and where the clip
    does not bind, the result equals ``adamw_update``'s bit for bit."""
    mesh, axes = ctx.device_mesh(), ctx.batch_axes
    n_dp, idx = ctx.n_batch, ctx.index(ctx.batch_axes)
    ps, zs = dict(named_leaves(param_specs)), dict(named_leaves(zero_specs))
    ms, vs = dict(named_leaves(state["m"])), dict(named_leaves(state["v"]))
    step = ctx.local(state["step"], ctx.replicated()) + 1
    blocks = {}
    for name, g in named_leaves(grads):
        zdim = _zero_dim(ps[name], zs[name])
        if zdim is None:
            g_s = ctx.all_reduce(g.float(), axes, "avg").to(g.dtype)
        else:
            g_s = ctx.reduce_scatter(g.float(), axes, zdim, "avg").to(g.dtype).contiguous()
        blocks[name] = (zdim, g_s)
    # each leaf's squared norm: its blocks summed over the ranks that split it
    sq = {name: torch.sum(g_s.float() ** 2) for name, (_, g_s) in blocks.items()}
    splits = [([n for n, (z, _) in blocks.items() if z is not None], axes)]
    if ctx.n_model > 1:
        splits.append(([n for n in blocks if on_model(ps[n])], ("model",)))
    for names, over in splits:
        if names:
            sq.update(zip(names, ctx.all_reduce(torch.stack([sq[n] for n in names]), over)))
    gnorm2 = sum(sq.values())
    scale, b1c, b2c = _factors(cfg, gnorm2, step)

    out = {}
    for name, p in named_leaves(params):
        zdim, g_s = blocks[name]
        p_l = ctx.local(p, ps[name])
        if zdim is not None:
            shard = p_l.shape[zdim] // n_dp
            p_l = p_l.narrow(zdim, idx * shard, shard)
        m_l, v_l = ctx.local(ms[name], zs[name]), ctx.local(vs[name], zs[name])
        p2, m2, v2 = _upd(cfg, p_l, g_s, m_l, v_l, scale, b1c, b2c)
        if zdim is not None:
            p2 = ctx.all_gather(p2, axes, zdim).contiguous()
        wrap = lambda t, s: DTensor.from_local(t, mesh, s.placements, run_check=False)  # noqa: E731
        out[name] = (wrap(p2, ps[name]), wrap(m2, zs[name]), wrap(v2, zs[name]))
    pick = lambda i: _unflatten(params, {n: t[i] for n, t in out.items()})  # noqa: E731
    step = DTensor.from_local(step, mesh, ctx.replicated().placements, run_check=False)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}


def _unflatten(like: Tree, values: dict, prefix: str = "") -> Tree:
    """A tree shaped like ``like`` whose leaves are ``values[dotted name]``."""
    if not isinstance(like, dict):
        return values[prefix.removesuffix(".")]
    return {k: _unflatten(like[k], values, f"{prefix}{k}.") for k in like}
