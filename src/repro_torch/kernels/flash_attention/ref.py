"""Plain PyTorch version of the flash-attention kernel (f32 softmax).

The same function as the reference's ``flash_attention_ref`` (which has
no query offset: the port's ``q_offset`` shifts the queries' positions):
it materialises the f32 (Sq, Sk) scores, sets masked ones to -1e30 and takes a
softmax. Runs on whatever device its operands lie on. The wrapper in
``ops.py`` uses it for CPU tensors; on the card it is what the CUDA kernel
is held against.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd); k/v (B, Hkv, Sk, hd) with H % Hkv == 0 (query head
    h reads KV head h // (H / Hkv)) -> (B, H, Sq, hd) in q's dtype. Key
    positions start at 0, query positions at ``q_offset``: with an offset
    the rows equal those of the whole sequence's queries from it."""
    H, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[2]
    group = H // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= (q_pos - k_pos) < window
    s = torch.where(ok, s, NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
