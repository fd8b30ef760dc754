"""Batched serving CLI: prefill-free greedy decode from a zero cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_base --full \
        --batch 4 --cache-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_7b --full \
        --batch 4 --cache-len 2048 --tokens 32

Serves every family: dense, MoE, SSM (mamba2), hybrid (zamba2),
encoder-decoder (whisper) and VLM (qwen2-vl). The cache is K/V for the
attention layers; for the SSM and hybrid families, each Mamba2 layer's
conv window and state (``LM.cache_template``; mamba2's holds no K/V, so
``--cache-len`` does not size it); for whisper, also the cross-attention's
``xk``/``xv`` of ``--cache-len // 2`` audio frames, left at zero as the
reference leaves them (``--cache-len`` also sizes its learned positions).
The VLM takes embeddings, not tokens: each step is fed the same seeded
(B, D) embedding (normal x 0.02, bf16), as the reference's loop does, and
its greedy tokens are not fed back. Runs on the GPU unless ``--device cpu``
is given; weights are random, drawn on that device from
``torch.Generator(device).manual_seed(--seed)`` (so a seed gives other
weights on the GPU than on the CPU).
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
    ``batch["token"]`` is the first step's token; a batch with an
    ``"embed"`` (embeddings input) is fed that at every step instead.
    Returns the greedy tokens (B, tokens) and each step's logits (B, V)
    f32."""
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
        if "embed" not in batch:
            batch["token"] = nxt.to(torch.int32)
    return torch.stack(out, dim=1).cpu().numpy(), logits_seen


def main(argv=None) -> dict:
    """Runs the CLI; returns the greedy tokens, the decode's wall seconds, the
    warm-up step's, whether every logit was finite, the device's peak
    allocated bytes from the weights' load on (None on the CPU), and the
    model and its weights (for a caller that goes on with them)."""
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
    params = model.load_params(model.init_params(
        torch.Generator(model.device).manual_seed(args.seed)))
    if model.device.type == "cuda":  # the peak below leaves out the draw's f32 buffers
        torch.cuda.synchronize(model.device)
        torch.cuda.reset_peak_memory_stats(model.device)
    B, S = args.batch, args.cache_len
    cache = model.init_cache(B, S)
    rng = np.random.default_rng(args.seed)
    if cfg.embeddings_input:
        batch = {"embed": torch.from_numpy(rng.standard_normal((B, cfg.d_model)) * 0.02).to(
            model.device, torch.bfloat16)}
    else:
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
    peak = (torch.cuda.max_memory_allocated(model.device) if model.device.type == "cuda"
            else None)
    where = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
             else "CPU")
    print(f"[serve] {cfg.name}: {args.tokens} tokens x batch {B} in {dt:.3f}s "
          f"({args.tokens * B / dt:.1f} tok/s on {where}, "
          f"{'full' if args.full else 'reduced'} config, cache {S}; warm-up step {warm:.3f}s)")
    print("[serve] sample:", toks[0][:16].tolist())
    return {"tokens": toks, "seconds": dt, "warmup_seconds": warm, "finite": finite,
            "peak_bytes": peak, "model": model, "params": params}


if __name__ == "__main__":
    main()
