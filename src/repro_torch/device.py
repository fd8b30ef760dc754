"""The data plane's device: where the port's kernels and tensors live."""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch._guards


def host_tensor(buf) -> torch.Tensor:
    """A uint8 CPU tensor over ``buf`` (``bytes``, ``bytearray``, ``memoryview``
    or a numpy array) without a copy. ``bytes`` and ``np.frombuffer`` views
    are read-only; torch warns about that once, and the data plane only
    reads these tensors (to copy them to the device or into a kernel)."""
    arr = np.ascontiguousarray(
        np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf,
        dtype=np.uint8,
    )
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine without
    one: the data plane never falls back to the CPU behind the caller's back.
    The one exception is a ``FakeTensorMode`` (the dry run, which traces a
    step on tensors with no data): while one is active a CUDA device is
    accepted without a card, since nothing runs on it."""
    if str(device).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() and \
            torch._guards.detect_fake_mode() is None:
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
