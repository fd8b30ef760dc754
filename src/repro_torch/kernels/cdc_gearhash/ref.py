"""Plain PyTorch version of the gear-hash CDC kernel.

PyTorch on the CPU has no uint32 ``<<``, ``>>`` or ``+``, so the arithmetic
runs in int64 with every intermediate masked to 32 bits. Runs on whatever
device its operand lies on; the wrapper in ``ops.py`` uses it for CPU
tensors, and on the card it is what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

WINDOW = 32
_M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """``v * c mod 2**32`` for int64 ``v`` and ``c`` below 2**32: the constant
    goes in 16-bit halves, so no product overflows int64."""
    lo = v * (c & 0xFFFF)
    hi = (v * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def gear_mix(x: torch.Tensor) -> torch.Tensor:
    """Deterministic byte -> uint32 mixer, as int64 values below 2**32."""
    v = x.to(torch.int64)
    v = _mul32((v + 0x9E3779B9) & _M32, 0x85EBCA6B)
    v = v ^ (v >> 15)
    v = _mul32(v, 0xC2B2AE35)
    v = v ^ (v >> 13)
    return v


def gearhash_ref(data: torch.Tensor, mask: int = 0xFFFF) -> tuple[torch.Tensor, torch.Tensor]:
    """data: (L,) uint8 -> (hash (L,) uint32, boundary (L,) uint8).

    h[i] = sum_{j<W} gear(x[i-j]) << j (mod 2**32), with x[<0] zero bytes.
    """
    data = data.to(torch.uint8)
    L = data.shape[0]
    # x[<0] are zero *bytes*; gear(0) != 0, so pad in byte space, then mix.
    padded = torch.cat([torch.zeros(WINDOW - 1, dtype=torch.uint8, device=data.device), data])
    gp = gear_mix(padded)
    h = torch.zeros(L, dtype=torch.int64, device=data.device)
    for j in range(WINDOW):
        # gear(x[i-j]) lives at gp[i + W-1 - j]
        h += (gp[WINDOW - 1 - j : WINDOW - 1 - j + L] << j) & _M32
    h &= _M32
    b = ((h & mask) == 0).to(torch.uint8)
    return h.to(torch.uint32), b
