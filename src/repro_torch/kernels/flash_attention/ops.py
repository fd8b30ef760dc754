"""Checked wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=..., window=...)`` computes fused
attention where the tensors lie: the CUDA kernel for CUDA tensors (one
launch, counted in ``launches``), the plain PyTorch version
(``ref.flash_attention_ref``) for CPU tensors. There is no fallback from one
to the other, and anything the kernel does not take raises on both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Kernel launches made by ``flash_attention`` since the count was last reset.
launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
_INT_MAX = 2**31 - 1


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, H, S, hd); got {q.shape}, {k.shape}, {v.shape}")
    if k.shape != v.shape:
        raise ValueError(f"k and v differ in shape: {tuple(k.shape)} vs {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] < 1 or H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[1]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: expected one of {DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.shape[2] < 1:
        raise ValueError("no keys: Sk must be at least 1")
    if not 0 <= window <= _INT_MAX or max(q.numel(), k.numel()) // hd > _INT_MAX:
        raise ValueError(f"window {window} or sizes out of the kernel's int range")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    global launches
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk,
                 hd, int(q.dtype == torch.bfloat16), int(causal), window, stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Fused attention. q (B, H, Sq, hd); k/v (B, Hkv, Sk, hd) with
    H % Hkv == 0 (query head h reads KV head h // (H / Hkv)); bf16 or f32,
    contiguous, hd in ``HEAD_DIMS``. ``window`` > 0 keeps keys with
    q_pos - k_pos < window; positions start at 0 for queries and keys.
    Returns (B, H, Sq, hd) in q's dtype."""
    window = int(window)
    _validate(q, k, v, window)
    if q.shape[2] == 0:
        return torch.empty_like(q)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}")
