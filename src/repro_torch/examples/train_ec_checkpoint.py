"""End-to-end driver: train an LM with EC-coded quorum checkpointing,
crash the trainer AND two checkpoint hosts mid-run, restore, and finish.

  PYTHONPATH=src python -m repro_torch.examples.train_ec_checkpoint [--device cpu] [--steps 60]

``launch.train`` with the reference example's arguments (a reduced
gemma3-family config; ``--arch``/``--full`` and the other flags of
``launch/train.py`` follow and override them), on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import sys

from repro_torch.launch.train import main as train


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = train(["--arch", "gemma3_1b", "--steps", "60", "--ckpt-every", "20", "--crash-at", "45",
                 "--kill-hosts", "2", "--ckpt-hosts", "8", "--ckpt-parity", "4", *argv])
    losses = out["losses"]
    assert losses[-1] < losses[0], "training must make progress"
    print(f"example OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{len(out['ckpts'])} quorum checkpoints, survived trainer+2-host crash")
    return out


if __name__ == "__main__":
    main()
