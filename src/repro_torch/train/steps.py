"""prefill_step / serve_step builders (one device: no mesh, no sharding).

``make_train_step`` waits for the training slice (ROADMAP A10)."""
from __future__ import annotations

import torch

from repro_torch.models.lm import LM, Params


def make_prefill_step(model: LM):
    """``prefill_step(params, batch) -> (B, V) f32`` logits of the last
    position of ``batch["tokens"]`` (B, S), on the model's device."""
    @torch.no_grad()
    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
        h = model._run_decoder_stack(params, h, positions=positions)
        return model._head(params, h[:, -1:, :])[:, 0].float()

    return prefill_step


def make_serve_step(model: LM):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one decode
    step (``LM.decode_step``; the cache is updated in place)."""
    @torch.no_grad()
    def serve_step(params: Params, cache: dict, batch: dict):
        return model.decode_step(params, cache, batch)

    return serve_step
