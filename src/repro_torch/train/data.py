"""Synthetic LM data pipeline: deterministic, host-shardable, restartable.

Generates zipf-distributed token "documents" from a counter-based PRNG, so
any (host, step) batch is reproducible without materializing a dataset —
the pipeline state checkpoint is just ``(seed, step)`` (a few bytes), which
the EC checkpoint store treats as one tiny always-rewritten block.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self.step = 0

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, self.cfg.host_id, step])
        )

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = self._batch_rng(self.step)
        self.step += 1
        # zipf tokens clipped into vocab; shift-by-one LM objective
        toks = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len + 1))
        toks = (toks - 1) % cfg.vocab
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
