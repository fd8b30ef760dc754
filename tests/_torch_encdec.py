"""The encoder-decoder's helpers shared by the port's tests and
``chip_smoke.py`` (JAX-free).

From the reference's init rule every 1-D leaf is 0, and whisper's layer
norms scale by ``w``, not ``1 + w``: its encoder's output and every logit
are then exactly 0. ``norm_draw`` gives such leaves a layer norm's usual
start plus noise. The reference never fills the decode cache's
cross-attention K/V; ``cross_kv`` computes them from the encoder's output,
so that a decode's cross-attention does real work.
"""
import numpy as np
import torch

FINAL_NORMS = ("enc_final_ln", "final_ln", "enc_final_b", "final_b")


def norm_draw(rng: np.random.Generator, shape: tuple, about_one: bool) -> np.ndarray:
    """N(0, 0.1^2) noise of ``shape`` (f64), about 1 with ``about_one`` (a
    layer norm's weight), else about 0."""
    return rng.standard_normal(shape) * 0.1 + about_one


def draw_final_norms(params: dict, seed: int) -> dict:
    """Whisper's final layer norms' weights and biases (``FINAL_NORMS``)
    drawn in place by ``norm_draw`` from ``default_rng(seed)``, the weights
    about 1. Returns ``params``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in FINAL_NORMS:
            draw = norm_draw(rng, tuple(params[name].shape), name.endswith("ln"))
            params[name].copy_(torch.from_numpy(draw))
    return params


def cross_kv(model, params: dict, audio: torch.Tensor, *,
             train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode cache's ``xk``/``xv`` (L, B, Sa, KV, hd) for ``audio``
    (B, Sa, D): ``enc_out @ xwk`` and ``enc_out @ xwv`` for every decoder
    layer, ``enc_out`` the encoder's output (``LM._encode``; with ``train``
    its attention is the training form, ``gqa_attention``, not the
    prefill's flash kernel)."""
    with torch.no_grad():
        enc = model._encode(params, audio, train=train)
        return tuple(torch.einsum("bsd,ldhk->lbshk", enc, params["dec"][w])
                     for w in ("xwk", "xwv"))
