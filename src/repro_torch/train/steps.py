"""train_step / prefill_step / serve_step builders (one device: no mesh, no
sharding). ``batch_shardings`` and ``training_state_specs`` wait for the mesh
layer (ROADMAP A3)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import dt
from repro_torch.models.lm import LM, Params
from repro_torch.train.optimizer import AdamWConfig, adamw_init_shapes, adamw_update
from repro_torch.tree import Tree, tree_leaves, tree_map


def loss_and_grads(model: LM, params: Params, batch: dict) -> tuple[torch.Tensor, Params]:
    """``(loss, grads)`` of ``model.loss_fn`` at ``params``, grads shaped and
    typed like ``params``. The gradients are taken on detached views of the
    leaves, so ``params`` (e.g. the frozen parameters that
    ``LM.load_params`` registers for serving) are left as they are."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(live, batch)
        leaves = list(tree_leaves(live))
        flat = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(flat), live)


def make_train_step(model: LM, opt_cfg: AdamWConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients, then one AdamW step; functional, like the
    reference's (new trees are returned, the inputs are not modified)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params: Params, opt_state: Tree, batch: dict):
        loss, grads = loss_and_grads(model, params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step


def make_prefill_step(model: LM):
    """``prefill_step(params, batch) -> (B, V) f32`` logits of the last
    position of ``batch["tokens"]`` (B, S), on the model's device: the
    family's stack (attention, MoE, SSM or hybrid), as the reference's
    ``make_prefill_step`` dispatches it. The embedding's output takes the
    configuration's dtype, as in ``LM.loss_fn``: bf16 for every configuration
    of the catalog, the reference's cast; a ``dtype="float32"`` configuration
    then serves in f32 throughout (the reference casts it to bf16)."""
    @torch.no_grad()
    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = params["embed"][tokens].to(dt(model.cfg))
        positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
        h, _ = model._run_stack(params, h, positions=positions)
        return model._head(params, h[:, -1:, :])[:, 0].float()

    return prefill_step


def make_serve_step(model: LM):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one decode
    step (``LM.decode_step``; the cache is updated in place)."""
    @torch.no_grad()
    def serve_step(params: Params, cache: dict, batch: dict):
        return model.decode_step(params, cache, batch)

    return serve_step


def training_state_shapes(model: LM) -> tuple[dict, dict]:
    """(parameter, optimizer state) trees of (shape, dtype)."""
    ps = model.param_template()
    return ps, adamw_init_shapes(ps)
