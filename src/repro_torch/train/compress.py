"""Error-feedback int8 gradient compression (data-parallel traffic reduction).

Gradients are quantized to int8 with one f32 scale per tensor; the
quantization residual is fed back into the next step (EF-SGD / 1-bit Adam
style), keeping convergence unbiased in practice. The plain-tensor port of
the reference's ``repro.train.compress``: ``torch.round``, like
``jnp.round``, rounds half to even.

Usage (``launch/train.py --compress-grads``): compress -> (all-reduce int8)
-> decompress.
"""
from __future__ import annotations

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


def compress_leaf(g: torch.Tensor, residual: torch.Tensor | None = None):
    """``(q int8, scale f32 0-d, new residual f32)`` of ``g`` plus ``residual``."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_residual = g32 - q.float() * scale
    return q, scale, new_residual


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_residuals(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_tree(grads: Tree, residuals: Tree):
    """``(qs, scales, residuals)``, three trees shaped like ``grads``."""
    out = tree_map(compress_leaf, grads, residuals)
    return tuple(tree_map(lambda t, i=i: t[i], out) for i in range(3))


def decompress_tree(qs: Tree, scales: Tree, like: Tree) -> Tree:
    return tree_map(lambda q, s, g: decompress_leaf(q, s, g.dtype), qs, scales, like)


def compressed_bytes(grads: Tree) -> tuple[int, int]:
    """(raw bytes, compressed bytes) for the data-parallel reduction."""
    leaves = list(tree_leaves(grads))
    raw = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() + 4 for g in leaves)  # int8 + scale
    return raw, comp
