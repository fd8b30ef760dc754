"""Batched serving CLI: prefill-free greedy decode from a zero cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b --full \
        --batch 4 --cache-len 2048 --tokens 32

Serves the dense, MoE, SSM (mamba2) and hybrid (zamba2) families. The
cache is K/V for the attention layers and, for the SSM and hybrid
families, each Mamba2 layer's conv window and state (``LM.cache_template``;
mamba2's holds no K/V, so ``--cache-len`` does not size it). Runs on the
GPU unless ``--device cpu`` is given; weights are random, from
``torch.Generator().manual_seed(--seed)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models.lm import LM, Params
from repro_torch.models.registry import build_model
from repro_torch.train.steps import make_serve_step


def decode_loop(model: LM, params: Params, cache: dict, batch: dict, tokens: int, *,
                feed: np.ndarray | None = None) -> tuple[np.ndarray, list[torch.Tensor]]:
    """``tokens`` decode steps from position 0, each fed the previous step's
    greedy token (or, teacher-forced, ``feed[:, i]`` at step i >= 1).
    ``batch["token"]`` is the first step's token. Returns the greedy tokens
    (B, tokens) and each step's logits (B, V) f32."""
    step = make_serve_step(model)
    out, logits_seen = [], []
    for i in range(tokens):
        if feed is not None and i > 0:
            batch["token"] = torch.as_tensor(feed[:, i], dtype=torch.int32, device=model.device)
        batch["cur_len"] = i
        logits, cache = step(params, cache, batch)
        nxt = logits.argmax(dim=-1)
        out.append(nxt)
        logits_seen.append(logits)
        batch["token"] = nxt.to(torch.int32)
    return torch.stack(out, dim=1).cpu().numpy(), logits_seen


def main(argv=None) -> dict:
    """Runs the CLI; returns the greedy tokens, the decode's wall seconds, the
    warm-up step's, whether every logit was finite, and the model and its
    weights (for a caller that goes on with them)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, max_pos=args.cache_len, device=args.device)
    params = model.load_params(model.init_params(torch.Generator().manual_seed(args.seed)))
    B, S = args.batch, args.cache_len
    cache = model.init_cache(B, S)
    rng = np.random.default_rng(args.seed)
    batch = {"token": torch.as_tensor(rng.integers(0, cfg.vocab, B), dtype=torch.int32,
                                      device=model.device)}
    # one untimed step from a scratch cache loads the kernels of the decode
    # shapes (lazy module loading, cuBLAS heuristics) before the clock starts
    t0 = time.perf_counter()
    decode_loop(model, params, model.init_cache(B, S), dict(batch), 1)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, logits = decode_loop(model, params, cache, batch, args.tokens)
    dt = time.perf_counter() - t0  # decode_loop ends in a device-to-host copy
    finite = bool(all(torch.isfinite(x).all() for x in logits))
    where = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
             else "CPU")
    print(f"[serve] {cfg.name}: {args.tokens} tokens x batch {B} in {dt:.3f}s "
          f"({args.tokens * B / dt:.1f} tok/s on {where}, "
          f"{'full' if args.full else 'reduced'} config, cache {S}; warm-up step {warm:.3f}s)")
    print("[serve] sample:", toks[0][:16].tolist())
    return {"tokens": toks, "seconds": dt, "warmup_seconds": warm, "finite": finite,
            "model": model, "params": params}


if __name__ == "__main__":
    main()
