"""Checked wrappers: gear-hash stream, boundary bitmap, and chunk splitting.

``gearhash`` computes where its input lies: the CUDA kernel
(``csrc/cdc_gearhash.cu``, one launch counted in ``launches``) for a CUDA
tensor, the plain PyTorch version (``ref.gearhash_ref``) for a CPU tensor.
Host bytes or numpy input are first put on ``device``. ``gearhash_bitmap``
is the same with the bitmap alone: on the card, the kernel's bitmap-only
form, which is what the chunker launches.

``split_chunks`` is what the Fragmentation Module calls: device-computed
boundary candidates (only their indices, about L/avg of them, come back to
the host) + a cheap host pass enforcing min/avg/max chunk sizes (the paper's
rabin-fingerprint parameters)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import host_tensor, resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.cdc_gearhash.ref import WINDOW, gearhash_ref

__all__ = ["WINDOW", "boundary_bitmap", "gearhash", "gearhash_bitmap", "split_chunks"]

# Kernel launches made by ``gearhash`` and ``gearhash_bitmap`` since the count
# was last reset.
launches = 0


def _mask_for_avg(avg_size: int) -> int:
    """Boundary mask with P(boundary) = 1/avg -> expected chunk ~= avg."""
    bits = max(1, int(np.log2(max(2, avg_size))))
    return (1 << bits) - 1


def _launch(data: torch.Tensor, mask: int, *,
            with_hash: bool) -> tuple[torch.Tensor | None, torch.Tensor]:
    global launches
    L = data.shape[0]
    dev = data.device
    if data.data_ptr() % 16:  # the kernel reads the stream in aligned 16-byte words
        data = data.clone()
    fn = _build.load("cdc_gearhash").gearhash_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h = torch.empty(L, dtype=torch.uint32, device=dev) if with_hash else None
    b = torch.empty(L, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(data.data_ptr(), None if h is None else h.data_ptr(), b.data_ptr(), L, mask,
                 stream)
    _build.check(err, "cdc_gearhash")
    launches += 1
    return h, b


def _stream(data, mask: int, device: str) -> torch.Tensor:
    """``data`` as a contiguous 1-D uint8 tensor: a tensor stays where it
    lies; ``bytes`` or a numpy array are first copied to ``device``."""
    if not 0 <= mask <= 0xFFFFFFFF:
        raise ValueError(f"mask {mask:#x} does not fit in 32 bits")
    if not isinstance(data, torch.Tensor):
        data = host_tensor(data).to(resolve_device(device))
    if data.dtype != torch.uint8 or data.ndim != 1:
        raise ValueError(f"data must be a 1-D uint8 stream, got {data.dtype} {tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return data.contiguous()


def gearhash(
    data: torch.Tensor | np.ndarray | bytes, *, mask: int = 0xFFFF, device: str = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rolling gear hash + boundary bitmap for a byte stream.

    A tensor is hashed where it lies; ``bytes`` or a numpy array are first
    copied to ``device``. Returns ``(hash (L,) uint32, bitmap (L,) uint8)``
    on that device."""
    data = _stream(data, mask, device)
    if data.device.type == "cpu":
        return gearhash_ref(data, mask=mask)
    if data.shape[0] == 0:
        return (torch.empty(0, dtype=torch.uint32, device=data.device),
                torch.empty(0, dtype=torch.uint8, device=data.device))
    return _launch(data, mask, with_hash=True)


def gearhash_bitmap(
    data: torch.Tensor | np.ndarray | bytes, *, mask: int = 0xFFFF, device: str = "cuda"
) -> torch.Tensor:
    """The bitmap of ``gearhash`` alone, (L,) uint8 on the stream's device.
    On the card it launches the kernel's bitmap-only form, which writes no
    hash."""
    data = _stream(data, mask, device)
    if data.device.type == "cpu":
        return gearhash_ref(data, mask=mask)[1]
    if data.shape[0] == 0:
        return torch.empty(0, dtype=torch.uint8, device=data.device)
    return _launch(data, mask, with_hash=False)[1]


def boundary_bitmap(data, avg_size: int, **kw) -> np.ndarray:
    return gearhash_bitmap(data, mask=_mask_for_avg(avg_size), **kw).cpu().numpy()


def split_chunks(
    data: bytes,
    *,
    min_size: int,
    avg_size: int,
    max_size: int,
    device: str = "cuda",
) -> list[bytes]:
    """Content-defined chunking with min/avg/max enforcement.

    The device computes the boundary bitmap; only the candidate positions
    (|candidates| ~= L/avg) come back to the host, whose pass applies the
    min/max rules — O(L) on the device, O(L/avg) on the host.
    """
    if not data:
        return [b""]
    bitmap = gearhash_bitmap(data, mask=_mask_for_avg(avg_size), device=device)
    cand = torch.nonzero(bitmap).flatten().cpu().numpy()
    chunks: list[bytes] = []
    start = 0
    L = len(data)
    ci = 0
    while start < L:
        lo = start + min_size
        hi = start + max_size
        # first candidate >= lo (strictly inside the chunk) and < hi
        while ci < len(cand) and cand[ci] < lo:
            ci += 1
        if ci < len(cand) and cand[ci] < hi and cand[ci] + 1 < L:
            end = int(cand[ci]) + 1  # boundary position is *inclusive* end
            ci += 1
        else:
            end = min(hi, L)
        chunks.append(data[start:end])
        start = end
    return chunks
