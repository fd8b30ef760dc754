"""Serving layer. The decode/prefill model paths live in
``repro_torch.models.lm.LM`` (``decode_step``, ``cache_template``); the
batched driver is ``repro_torch.launch.serve``. This package re-exports the
public surface."""
from repro_torch.launch.serve import decode_loop
from repro_torch.launch.serve import main as serve_main
from repro_torch.train.steps import make_prefill_step, make_serve_step

__all__ = ["decode_loop", "make_prefill_step", "make_serve_step", "serve_main"]
