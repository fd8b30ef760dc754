"""Checked wrappers for the GF(256) matmul kernel (``csrc/gf256_matmul.cu``).

``gf256_matmul(A, B)`` — the GF(256) product ``C = A (x) B`` of a small host
matrix A and a tensor B, computed where B lies: the CUDA kernel for a CUDA
tensor (one launch, counted in ``launches``), the plain PyTorch version
(``ref.gf256_matmul_ref``) for a CPU tensor. There is no fallback from one
to the other.
``gf256_coding_matmul(A, B, device=...)`` — what the storage data path's
"kernel"/"auto" coding backend dispatches to (``repro_torch.erasure.rs``):
host numpy in, the product on ``device``, host numpy out.
``rs_encode_parity(parity_matrix, data)`` — the RS encode hot path.

All paths are bit-identical to ``ref.gf256_matmul_ref`` and to the numpy
LUT reference ``erasure.gf.gf_matmul_np``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import host_tensor, resolve_device
from repro_torch.erasure.gf import EXP_TABLE, LOG_TABLE
from repro_torch.kernels import _build
from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref

# Kernel launches made by ``gf256_matmul`` since the count was last reset.
launches = 0

_ZERO_LOG = 511  # log of 0 in the kernel's tables: every sum with it hits EXP's zero half
_tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def kernel_is_native() -> bool:
    """Whether ``RSCode`` fuses decode groups into one block-diagonal launch.
    False: the port launches the kernel once per index-set group. A grouped
    launch over decode groups is still to be written, and the bytes are the
    same either way."""
    return False


def _validate_shapes(A: np.ndarray, B) -> None:
    # ValueError, not assert: shape bugs must not vanish under ``python -O``
    # and surface later as wrong-shaped kernel output.
    if A.ndim != 2:
        raise ValueError(f"A must be a 2-D (m, k) matrix, got shape {A.shape}")
    if getattr(B, "ndim", None) != 2:
        raise ValueError(f"B must be a 2-D (k, L) matrix, got shape {getattr(B, 'shape', None)}")
    if B.shape[0] != A.shape[1]:
        raise ValueError(
            f"inner dimensions disagree: A is {A.shape}, B is {tuple(B.shape)}"
        )


def _device_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's antilog table (1024 bytes, zero from index 509 on) and
    log table (256 x 16 bits, log(0) = 511), resident on ``dev``."""
    if dev not in _tables:
        exp = np.zeros(1024, dtype=np.uint8)
        exp[:509] = EXP_TABLE[:509]
        log = LOG_TABLE.astype(np.int16)
        log[0] = _ZERO_LOG
        _tables[dev] = (torch.from_numpy(exp).to(dev), torch.from_numpy(log).to(dev))
    return _tables[dev]


def _launch(A: np.ndarray, B: torch.Tensor) -> torch.Tensor:
    global launches
    if B.dtype != torch.uint8:
        raise ValueError(f"B must be uint8, got {B.dtype}")
    if not B.is_contiguous():
        raise ValueError("B must be contiguous")
    m, k = A.shape
    L = B.shape[1]
    dev = B.device
    lib = _build.load("gf256_matmul")
    fn = lib.gf256_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    exp, log = _device_tables(dev)
    a = host_tensor(A).to(dev)
    out = torch.empty((m, L), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), B.data_ptr(), out.data_ptr(), m, k, L,
                 exp.data_ptr(), log.data_ptr(), stream)
    _build.check(err, "gf256_matmul")
    launches += 1
    return out


def gf256_matmul(A, B: torch.Tensor | np.ndarray) -> torch.Tensor:
    """GF(256) matrix product C = A (x) B. A: (m, k) uint8 (host, small, at
    most 256 x 256); B: (k, L) uint8 tensor (a numpy B is taken as a CPU
    tensor). Returns (m, L) uint8 on B's device."""
    A = np.asarray(A, dtype=np.uint8)
    if isinstance(B, np.ndarray):
        B = host_tensor(B)
    _validate_shapes(A, B)
    m, k = A.shape
    L = B.shape[1]
    if m == 0 or L == 0 or k == 0:
        # degenerate shapes the storage path can produce (m == 0 codes,
        # empty values): the product is an empty/zero matrix — no launch.
        return torch.zeros((m, L), dtype=torch.uint8, device=B.device)
    if m > 256 or k > 256:
        raise ValueError(f"A is {A.shape}; the kernel takes at most 256 x 256")
    if B.device.type == "cuda":
        return _launch(A, B)
    if B.device.type == "cpu":
        return gf256_matmul_ref(host_tensor(A), B)
    raise ValueError(f"unsupported device {B.device}")


def gf256_coding_matmul(A: np.ndarray, B: np.ndarray, *, device: str = "cuda") -> np.ndarray:
    """GF(256) matmul as dispatched by the storage data path (RSCode backend
    "kernel"/"auto"): host numpy operands, the product on ``device`` (the
    CUDA kernel on "cuda", the plain version on "cpu"), host numpy result."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    _validate_shapes(A, B)
    m, k = A.shape
    L = B.shape[1]
    if m == 0 or L == 0 or k == 0:
        return np.zeros((m, L), dtype=np.uint8)
    dev = resolve_device(device)
    out = gf256_matmul(A, host_tensor(B).to(dev))
    return out.cpu().numpy()


def rs_encode_parity(parity_matrix: np.ndarray, data: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Parity rows for a systematic RS code: P = parity_matrix (x) data."""
    return gf256_matmul(parity_matrix, data)
