"""Plain PyTorch version of the GF(256) matmul kernel (log/antilog LUT model).

Runs on whatever device its operands lie on. The wrapper in ``ops.py`` uses
it for CPU tensors; on the card it is what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from repro_torch.erasure.gf import EXP_TABLE, LOG_TABLE


def gf256_matmul_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C[i, j] = XOR_r A[i, r] * B[r, j] over GF(256). A: (m, k), B: (k, L)
    uint8; the result is (m, L) uint8 on B's device."""
    dev = B.device
    exp = torch.as_tensor(EXP_TABLE, device=dev)                    # (512,) uint8
    log = torch.as_tensor(LOG_TABLE, device=dev).to(torch.int64)    # (256,)
    A = A.to(device=dev, dtype=torch.uint8)
    B = B.to(torch.uint8)
    m, k = A.shape
    out = torch.zeros((m, B.shape[1]), dtype=torch.uint8, device=dev)
    log_a = log[A.to(torch.int64)]                                  # (m, k)
    for r in range(k):  # k is small: an XOR fold over the inner dimension
        b = B[r]
        prod = exp[log_a[:, r, None] + log[b.to(torch.int64)][None, :]]
        nz = (A[:, r, None] != 0) & (b[None, :] != 0)
        out ^= torch.where(nz, prod, 0)
    return out
