"""End-to-end training driver with EC-coded quorum checkpointing.

Reduced config by default, so that it runs on the CPU with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch gemma3_1b \\
      --steps 60 --ckpt-every 20 --crash-at 45 --kill-hosts 2 --ckpt-parity 4

trains an LM while it checkpoints the whole state (parameters, AdamW state,
data-pipeline state) to an ``ECCheckpointStore`` every ``--ckpt-every``
steps, crashes the trainer and ``--kill-hosts`` checkpoint hosts at
``--crash-at``, restores from the surviving hosts (k-of-n decode) and
finishes. ``--arch`` takes every ported family: dense (``qwen2_0_5b``,
``qwen3_0_6b``, ``gemma3_1b``, ``chatglm3_6b``), MoE (``olmoe_1b_7b``,
``qwen3_moe_30b_a3b``; the loss adds ``0.01`` times the auxiliary loss), SSM
(``mamba2_2_7b``) and hybrid (``zamba2_7b``). It refuses the
encoder-decoder (``whisper_base``) and the VLM (``qwen2_vl_7b``), whose
batches hold audio or patch embeddings: its data source, ``SyntheticLM``,
makes only tokens, as the reference's does; train those through
``make_train_step`` with such a batch. ``--full`` takes the
architecture at full width and depth, on the GPU (the default ``--device
cuda``; it raises where there is none), e.g. ``--arch qwen2_0_5b --full
--batch 4 --seq 2048``. At full depth the MoE, SSM and hybrid models do
not fit one 80 GB card: AdamW keeps f32 moments, and the old and the new
parameters and moments are alive together during the update (~22 bytes a
parameter with the bf16 gradients). There is no flag to cut the depth;
``chip_smoke.py`` trains them at full width with fewer layers.
Weights come from ``torch.Generator().manual_seed(0)``; ``main(argv,
params=...)`` starts from given parameters instead.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models.lm import Params
from repro_torch.models.registry import build_model
from repro_torch.train import compress as gc
from repro_torch.train.checkpoint import ECCheckpointStore
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.tree import tree_map


def main(argv=None, *, params: Params | None = None) -> dict:
    """Run the driver; returns ``{"losses": [float], "ckpts": [CheckpointStats]}``.
    ``params`` (a parameter tree, e.g. carried over from the reference)
    replaces the seeded initial weights."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-hosts", type=int, default=8)
    ap.add_argument("--ckpt-parity", type=int, default=2)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate trainer crash+restore at this step")
    ap.add_argument("--kill-hosts", type=int, default=0,
                    help="crash this many checkpoint hosts before restore")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-block", type=int, default=1 << 16)
    ap.add_argument("--avg-block", type=int, default=1 << 18)
    ap.add_argument("--max-block", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if cfg.family == "encdec" or cfg.embeddings_input:
        raise ValueError(
            f"{args.arch}: the launcher's SyntheticLM makes only tokens, and the {cfg.family} "
            f"family trains on embeddings (audio_embeds or embeds): train it through "
            f"repro_torch.train.steps.make_train_step with such a batch")
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, max_pos=args.seq, device=args.device)
    dev = model.device
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    params = tree_map(lambda p: p.detach().to(dev), params)
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=args.lr)
    if args.compress_grads:
        # error-feedback int8 gradient compression around the data-parallel
        # reduction (here on the single-device loop; at scale it wraps the
        # all-reduce, see train/compress.py). The residuals are the trainer's
        # own and are not checkpointed, as in the reference.
        residuals = gc.init_residuals(params)

        def step_fn(params, opt_state, batch):
            nonlocal residuals
            loss, grads = loss_and_grads(model, params, batch)
            qs, scales, residuals = gc.compress_tree(grads, residuals)
            grads = gc.decompress_tree(qs, scales, grads)
            params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, loss
    else:
        step_fn = make_train_step(model, opt_cfg)
    store = ECCheckpointStore(n_hosts=args.ckpt_hosts, parity=args.ckpt_parity,
                              min_block=args.min_block, avg_block=args.avg_block,
                              max_block=args.max_block, device=args.device)
    print(f"[train] {cfg.name} reduced={not args.full} params="
          f"{model.n_params()/1e6:.1f}M fault_budget={store.fault_budget()} hosts, on {dev}")

    losses = []
    ckpt_stats = []
    step = 0
    t0 = time.time()
    while step < args.steps:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.next_batch().items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        step += 1
        if args.ckpt_every and step % args.ckpt_every == 0:
            st = store.save(step, {"params": params, "opt": opt_state, "data": data.state()})
            ckpt_stats.append(st)
            print(f"[ckpt] step={step} {st.bytes_written/1e6:.2f} MB in "
                  f"{st.virtual_seconds*1e3:.1f} virtual-ms, "
                  f"{st.blocks_written}/{st.blocks_total} blocks rewritten")
        if args.crash_at and step == args.crash_at:
            print(f"[crash] trainer dies at step {step}; "
                  f"{args.kill_hosts} checkpoint hosts die too")
            if args.kill_hosts:
                store.crash_hosts([f"s{i}" for i in range(args.kill_hosts)])
            restored = store.restore()
            if restored is None:
                raise RuntimeError("restore failed: no checkpoint readable")
            step, state = restored
            params, opt_state = state["params"], state["opt"]
            data.restore(state["data"])
            print(f"[restore] resumed from step {step} (k-of-n decode OK)")
            args.crash_at = 0  # once
    dt = time.time() - t0
    print(f"[done] {args.steps} steps in {dt:.1f}s wall; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "ckpts": ckpt_stats}


if __name__ == "__main__":
    main()
