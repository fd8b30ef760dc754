"""Model construction + input specs per (arch, shape)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM


def build_model(cfg: ArchConfig, max_pos: int = 4096, device: str = "cuda") -> LM:
    """The LM of ``cfg`` on ``device`` ("cuda" unless the caller asks for the
    CPU; raises where there is no GPU)."""
    return LM(cfg, max_pos=max_pos, device=device)


def input_specs(cfg: ArchConfig,
                shape: ShapeConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input, as the reference's ``input_specs``
    gives them. Modality frontends are stubs: VLM/audio inputs are
    precomputed patch/frame embeddings."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"audio_embeds": ((B, S // 2, cfg.d_model), bf),
                    "tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if cfg.embeddings_input:
            return {"embeds": ((B, S, cfg.d_model), bf),
                    "positions": ((3, B, S), i32), "labels": ((B, S), i32)}
        return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    # decode: one new token against a seq_len cache
    out: dict = {"cur_len": ((), i32)}
    if cfg.embeddings_input:
        out["embed"] = ((B, cfg.d_model), bf)
    else:
        out["token"] = ((B,), i32)
    return out


def make_inputs(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                device: str = "cuda") -> dict[str, torch.Tensor]:
    """Random inputs matching ``input_specs``, drawn from numpy's
    ``default_rng(seed)`` in the reference's order, so that they equal the
    reference's ``make_inputs``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels", "token") else max(2, shape.seq_len)
            if k == "cur_len":
                arr = np.asarray(shape.seq_len // 2, np.int32)
            else:
                arr = rng.integers(0, hi, shp, dtype=np.int32)
        else:
            arr = rng.standard_normal(shp).astype(np.float32) * 0.02
        out[k] = torch.from_numpy(np.asarray(arr)).to(dev, dtype)
    return out
