"""Carry a parameter tree across from numpy (e.g. the reference's params,
converted with ``np.asarray``) into the port's nested dict of tensors.

bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses. They are found by their dtype's name and reinterpreted bit for bit
through uint16, so no ``ml_dtypes`` import is needed and the conversion is
exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import Params


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor equal to ``arr``, bit for bit (bf16 included)."""
    arr = np.array(arr, copy=True)  # writable, owned by the tensor
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: dict) -> Params:
    """The nested dict of CPU tensors for a nested dict of arrays (stacked
    layers included); ``LM.load_params`` moves it to the model's device."""
    return {name: params_from_numpy(value) if isinstance(value, dict) else tensor_from_numpy(value)
            for name, value in tree.items()}
