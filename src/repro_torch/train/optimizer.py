"""AdamW on nested dicts of tensors (one device; no ``torch.optim``).

The single-device form of the reference's ``repro.train.optimizer``: a
global-norm clip in f32, f32 moments with bias correction, decoupled weight
decay on leaves with ``ndim >= 2`` only (the stacked norms ``ln1``/``ln2``
(L, D) are decayed, ``final_ln`` (D,) is not), and the update rounded in the
reference's order: ``p * decay`` in the parameter's dtype (the factor too),
minus ``(lr * delta)`` cast to that dtype. ``torch.optim.AdamW`` differs in the
clip, the decay rule and that rounding order.

The state is ``{"m": tree, "v": tree, "step": int32 0-d tensor}``; the ZeRO-1
sharded forms (``adamw_specs``, ``adamw_update_sharded``) wait for the mesh
layer.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


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
    scale = torch.clamp(cfg.grad_clip / (torch.sqrt(gnorm2) + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m2 / b1c
        vh = v2 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        step_term = (cfg.lr * delta).to(p.dtype)
        decay = (1.0 - cfg.lr * cfg.weight_decay) if p.ndim >= 2 else 1.0
        # the reference's Python scalar takes the parameter's dtype (JAX's
        # weak typing): in bf16 a decay above 1 - 2**-9 rounds to 1
        decay = float(torch.tensor(decay, dtype=torch.float32).to(p.dtype))
        return p * decay - step_term, m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
