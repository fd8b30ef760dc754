"""Checked wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=..., window=..., q_offset=...)`` computes
fused attention where the tensors lie: the CUDA kernel for CUDA tensors (one
launch, counted in ``launches``; bf16 runs on the tensor cores, f32 on the
CUDA cores), the plain PyTorch version (``ref.flash_attention_ref``) for
CPU tensors. There is no fallback from one to the other, and anything the
kernel does not take raises on both.

The CUDA launch is the custom operator ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``): its real body launches the kernel; its fake
body, which ``FakeTensorMode`` runs in place of it (the dry run, on tensors
with no data), returns an empty tensor of q's shape and dtype and launches
nothing; its flop formula, which ``FlopCounterMode`` counts, is
``work.flops``. A fake tensor takes that operator on any device: the dry
run's tensors stand for the card's, and a CPU-only torch cannot trace fake
CUDA tensors (its indexing and autograd engine take a CUDA device guard that
such a build lacks), so there they lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import work
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Kernel launches made by ``flash_attention`` since the count was last reset.
launches = 0

HEAD_DIMS = (16, 32, 64, 112, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
_INT_MAX = 2**31 - 1


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
              q_offset: int) -> None:
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
    if not 0 <= q_offset <= _INT_MAX:
        raise ValueError(f"q_offset {q_offset} outside [0, {_INT_MAX}]")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
            q_offset: int) -> torch.Tensor:
    """One kernel launch on CUDA tensors that ``flash_attention`` checked."""
    global launches
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the tensor maps of the TMA loads need 16-byte aligned bases
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk,
                 hd, q_offset, int(bf16), int(causal), window, stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out


@_launch.register_fake
def _launch_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
                 q_offset: int) -> torch.Tensor:
    """The launch's result under ``FakeTensorMode``: q's shape and dtype, no
    data; no kernel runs and ``launches`` does not move. Raises for a tensor
    with data: a real tensor always reaches the real body."""
    if not isinstance(q, FakeTensor) and q.device.type != "meta":
        raise RuntimeError("flash_attention's fake body was given a real tensor")
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _launch_flops(q_shape, k_shape, v_shape, causal: bool, window: int, q_offset: int, *,
                  out_shape=None, **kwargs) -> int:
    B, H, Sq, hd = q_shape
    return work.flops(B, H, Sq, k_shape[2], hd, window, causal, q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Fused attention. q (B, H, Sq, hd); k/v (B, Hkv, Sk, hd) with
    H % Hkv == 0 (query head h reads KV head h // (H / Hkv)); bf16 or f32,
    contiguous, hd in ``HEAD_DIMS``. ``window`` > 0 keeps keys with
    q_pos - k_pos < window. Key positions start at 0, query positions at
    ``q_offset`` (>= 0): query row i sits at ``q_offset + i`` for the
    causal mask and the window, as a rank's block of a sequence's queries
    does against the whole sequence's keys. Returns (B, H, Sq, hd) in q's
    dtype."""
    window, q_offset = int(window), int(q_offset)
    _validate(q, k, v, window, q_offset)
    if q.shape[2] == 0:
        return torch.empty_like(q)
    if q.device.type == "cuda" or isinstance(q, FakeTensor):
        # a fake tensor (the dry run's) stands for the card's: it takes the
        # kernel's operator, whose fake body runs and launches nothing
        return _launch(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    raise ValueError(f"unsupported device {q.device}")
