#!/usr/bin/env python3
"""Smoke run of repro_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Phases, each of which fails the run (non-zero exit) on any error:

1. card: print the GPU's name and power limit (``nvidia-smi``);
2. build: compile the hand-written CUDA kernels of ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it and at ragged, seam, windowed,
   top-left-causal and extreme-logit shapes, and a block of S/4 queries at
   the offsets 0, S/4 and 3S/4 (``FLASH_OFFSET_CASES``: gemma3-1b's windowed
   and global layers, and f32; phase 10 holds qwen2-0.5b's), and gemma3-1b's
   ``long_500k`` sequence rank blocks on the production meshes (2048 queries
   on 32768 keys at offsets 0, 16384 and 30720, window 512 and global; held
   and timed without running the model) (bf16 and f32 for attention;
   every row offset mod 16 for the GF(256) product; both forms of the gear
   hash), and time both (and, where one PyTorch call computes the same
   function, that call; each kernel's share of its bound, the GF(256)
   decode and the bitmap-only gear hash beside the path's forms);
4. storage path: drive the CoARESECF storage path of the paper's Emulab
   deployment (n=11, k=6, EC-DAPopt, fragmented, indexed; 512 KiB min/avg
   and 1 MiB max blocks; one file of ``--size-mib`` MiB made from ``--seed``)
   through ``DSS`` and ``Session``: write, read, degraded read with a data
   server down, a 16-byte edit, stat, recovery + repair, recon to a fresh EC
   configuration, read. The bytes must come back equal after every step,
   both kernels' launch counts must grow where the step runs them, and no
   quorum round may be left stuck. The path then runs once more under
   ``cProfile`` and ``torch.profiler`` for a host/device breakdown (the
   device's busy share, the costliest host functions; files in ``--out``).
   The same sequence on a small file must give the same bytes and the same
   trace on the card as with the plain versions on the CPU;
5. model path: qwen2-0.5b at full width and depth (24 layers, random
   weights from ``torch.Generator().manual_seed(--seed)``): a prefill of
   4 x 2048 tokens through ``make_prefill_step`` (one flash-attention launch
   per layer), then ``repro_torch.launch.serve`` with ``--full --batch 4
   --cache-len 2048 --tokens 32``. Logits must be finite. The same prefill
   at full width, 2 layers and 256 tokens, and one decode step from one
   cache, must agree between the card (kernel) and the CPU (plain versions);
5b. MoE serving: olmoe-1b-7b at full width and depth (random weights from
   the seed): ``repro_torch.launch.serve --arch olmoe_1b_7b --full --batch 4
   --cache-len 2048 --tokens 32``, then with its weights 3 timed prefills of
   4 x 2048 tokens (one flash-attention launch per layer, hd 128), the share
   of assignments dropped at capacity in the first and last layer, and a
   profile split by the MoE layer's parts. Card against CPU, the same
   weights: olmoe-1b-7b and qwen3-moe-30b-a3b at full width, 2 layers,
   2 x 256 tokens (routes agree above a router-logit margin, logits
   within 8 bf16 ulps where they do, greedy tokens >= 90 %), and
   ``moe_layer`` alone at olmoe's widths and 8192 tokens;
5c. SSM and hybrid serving: mamba2-2.7b and zamba2-7b at full width and
   depth, one at a time (random weights from the seed): ``repro_torch.launch.
   serve --arch <arch> --full --batch 4 --cache-len 2048 --tokens 32``, then
   3 timed prefills of 4 x 2048 tokens (zamba2: one flash-attention launch
   per group, hd 112; mamba2: none), peak device memory, the cache's bytes,
   and a profile split by the Mamba2 mixer's parts (the SSD's intra-chunk
   term and chunk states, the causal conv, GEMMs, elementwise; zamba2's
   shared block and flash) with the device operations of a decode step.
   Card against CPU at full width, 2 x 256 tokens, mamba2 at 2 layers and
   zamba2 at 7 (one group, the shared block, a trailing layer): prefill and
   4 decode steps' logits within 8 bf16 ulps, greedy tokens >= 90 %, each
   layer's SSM state within 8 bf16 ulps, each held where the CPU meets it
   against its own 1-ulp jitter; zamba2 in bf16 does not (its random
   shared attention is near-argmax), and is checked in f32 only
   (``SSM_CHECK_F32_ONLY``), held;
5d. encoder-decoder and VLM serving: whisper-base (6 encoder and 6 decoder
   layers) at its published context (1500 audio frames, at most 448
   tokens: ``max_pos`` 448) and qwen2-vl-7b at full width and depth, one
   at a time (random weights from the seed, drawn on the card): ``repro_torch.
   launch.serve --arch <arch> --full --batch 4 --cache-len <448 | 2048>
   --tokens 32`` (whisper's cross K/V left at zero, as the reference leaves
   them; the VLM fed one seeded embedding), then 3 timed prefills of batch 4
   (whisper: 1500 audio frames and 448 tokens, flash once per encoder layer
   and twice per decoder layer, 18 a prefill; qwen2-vl: ``make_inputs``'
   2048 embeddings and random M-RoPE positions, flash at GQA 7 and hd 128,
   28 a prefill), whisper's 32 decode steps with the cross K/V of the 1500
   frames filled from its encoder, peak device memory and a profile split
   by the layers' parts.
   Card against CPU at full width, 2 layers (2 + 2 for whisper), 2 x 256:
   prefill and 4 decode steps' logits within 8 bf16 ulps, greedy tokens
   >= 90 %, held where the CPU meets each against itself with every
   attention output moved one ulp, else held in f32;
6. the store's users, each path with the kernels' counts set to 0 before it
   and read after it, under ``torch.profiler`` (wall time, launches, the
   device's busy share), on the same Emulab deployment and blocks:
   (a) YCSB core workload B (95/5, zipfian 0.99, 2 ops a session) from 256
   sessions over 64 files of 4 MiB, all through one ``dss.gateway()``: clean
   (no op stuck or failed), then under a crash storm of 2 of 11 servers
   with retries (``storm_retry``; availability after recovery at least
   0.99; host profile in ``--out``), after which a fresh gateway reads every
   file with a data server down (written bytes back, decodes on the card);
   (b) the same through the sanitizer and race tracker, 64 sessions over 16
   files of 1 MiB (every recorded register op linearized); the spec of (a)
   at 32 sessions over 8 files of 3 MiB gives the same report on the card
   as on the CPU; (c) qwen2-0.5b's state dict (full width and depth, random
   weights from the seed) through ``ECCheckpointStore(device="cuda")`` on
   8 hosts with 2 parity: save, restore, an incremental save after one
   layer changes (few blocks rewritten), a restore with the fault budget's
   hosts down, and a recon to 11 fresh hosts with 5 parity (restored with
   every old host down), every restore bit for bit on the card. The storage
   kernels are first held against their plain versions, and timed, at a
   4 MiB file's and at the checkpoint's shapes.

7. training: qwen2-0.5b at full width, ``TRAIN_DEPTH`` (2) of its 24
   layers (a ``reduced:`` line; random weights from the seed), B=4 x 2048,
   AdamW at lr 1e-3 (``make_train_step``; the loss
   attends with ``gqa_attention``, every layer under
   ``torch.utils.checkpoint``), checkpointing its whole state (parameters,
   AdamW's f32 moments and step, the data state; ~1.66 GB) through
   ``ECCheckpointStore(device="cuda")`` on 8 hosts with 2 parity and the
   paper's blocks: steps 1-2, a save, steps 3-4, an incremental save, step
   5, then a crash of the trainer and of the fault budget's hosts, a restore
   checked bit for bit, and step 5 redone (its loss within 1e-3 of the
   first); train tokens/s, peak device memory, each save's and the
   restore's GB/s, blocks rewritten and the storage kernels' launches. The
   storage kernels are then held against their plain versions on the bytes
   of the step-4 save, and on them repeated past 2**32 positions, the save's blocks
   are accounted for (chunks, tombstones, bytes unchanged by leaf), the
   gradient's norm is printed by leaf, and one more step runs under
   ``torch.profiler``. One train step on the card
   against the CPU to the CPU parity criteria
   (``tests/_torch_train_criteria.py``): reduced qwen2-0.5b and gemma3-1b
   at 2 x 64 and at 1 x 2048 tokens (the chunked attention), and the model
   at full width, one layer, 1 x 2048 tokens in f32; at full width, 2
   layers, 2 x 256 in bf16, where the random weights make the gradients
   ill-conditioned and the criteria are not met, the step is printed and
   held only where it is well-conditioned (``train_card_vs_cpu``).

7b. training of the MoE, SSM and hybrid families: olmoe-1b-7b, mamba2-2.7b
   and zamba2-7b at their published widths, the depth cut for the
   script's time (``FAMILY_TRAIN_DEPTHS``: 2, 8 and 7 layers; one card's
   80 GB holds 5, 56 and 27; each cut printed as a ``reduced:`` line),
   weights drawn on the card from the seed, B=4 x 2048,
   AdamW at lr 1e-3: a warm-up and 3 timed steps (train tokens/s, peak
   device memory, finite losses), the gradient's norm (olmoe: the
   recompute routes as the forward did; the drop share of its first and
   last layer), one step under ``torch.profiler`` split into forward,
   recompute, backward and AdamW and by the family's parts. The backward of
   the MoE dispatch gather on identical inputs, bit for bit against the
   CPU. One train step on the card against the CPU: the four reduced
   configs at 2 x 64 in bf16 (MoE routes held to their criteria; where a
   route differs, the step held against the CPU's on the card's routes;
   the SSD families held, widened or printed as the CPU's own step under a
   one-ulp SSD nudge decides: ``hold_step``) and at full width in f32,
   olmoe and mamba2 at 1 layer, zamba2 at 7, at 1 x 256, held. Then
   ``repro_torch.launch.train`` at each family's reduced config, with
   checkpoints, a crash, one host down and a restore: bit for bit, the
   redone steps' losses equal; the storage kernels counted, then held
   against their plain versions on the restored save's bytes.

7c. training of the encoder-decoder and VLM families: whisper-base at full
   width and depth and qwen2-vl-7b at full width with the depth cut to 4
   layers (``EMBED_TRAIN_DEPTHS``; one card holds 8; a ``reduced:`` line;
   the allocator's segments
   expandable for the phase), weights drawn on the card, B=4 x 2048
   embeddings from ``make_inputs`` (whisper: 4 x 448 tokens, its published
   decoder context, and 1024 audio frames: the reference's training
   attention refuses 1500, ``WHISPER_TRAIN_FRAMES``), AdamW
   at lr 1e-3: as in 7b, a warm-up and 3 timed steps, the gradient's norm
   and a profile split into forward, recompute, backward and AdamW. One
   train step on the card against the CPU: the reduced configs at 2 x 64 in
   bf16, and one full-width layer (whisper: one of each stack) at 1 x 256
   in f32, held. Their launcher is not run: it refuses them (its
   ``SyntheticLM`` makes only tokens, as the reference's does).

8. the mesh layer: ``init_process_group("nccl", world_size=1)`` and
   ``make_host_mesh("cuda")``, the reference's (data=1, model=1) mesh on
   one card. qwen2-0.5b at full width, B=4 x 2048: the sharded train step
   (parameters stored in the ZeRO layout, the chunked cross-entropy,
   gradients reduce-scattered and parameters all-gathered through NCCL)
   against the unsharded step from the same weights and batch, as
   ``hold_step`` decides from the unsharded step's own distance under a
   one-ulp nudge of every RMS norm: printed at full depth in bf16
   (ill-conditioned from random weights), held at one layer in f32; 3
   sharded steps beside 3 unsharded ones (train tokens/s, peak device
   memory) and one under ``torch.profiler`` (NCCL's kernels counted: none
   fails); the sharded prefill of 4 x 2048 tokens (flash once per layer)
   bit for bit the unsharded one. whisper-base at full width and depth,
   4 x 384 tokens on 1024 frames (the chunked cross-entropy takes
   multiples of 128, as the reference's): 3 sharded steps beside 3
   unsharded ones and a profiled one, then ``elastic_resize`` from 8 hosts
   with parity 2 to 10 with parity 3 (save, recon and restore GB/s; the
   restored state byte for byte; the storage kernels counted, then held
   against their plain versions on its bytes at both configurations'
   shapes) and a step from the restored state bit for bit the same step
   from the state before the save.

9. tensor and expert parallelism over "model": the flash kernel against
   its plain version, and timed beside SDPA, at one rank's shapes of a
   (data=1, model=2) mesh (``TP_FLASH_CASES``: qwen2-0.5b's, olmoe-1b-7b's,
   zamba2-7b's, qwen2-vl-7b's and whisper-base's heads halved); then two
   processes of this script (``--tp-rank``), sharing the
   card over gloo on ``make_shared_card_mesh((1, 2))`` (NCCL refuses two
   ranks on one GPU: their times are two ranks time-sharing one card). For
   qwen2-0.5b, olmoe-1b-7b, mamba2-2.7b, zamba2-7b and qwen2-vl-7b at full
   width and the depth ``TP_SERVE_DEPTHS`` (4, 2, 4, 7, 4: ``reduced:``
   lines), and whisper-base at its published
   context (1500 frames, 448 tokens) twice, as it is (pure data-parallel:
   its prefill data-parallel over both axes, its decode tensor-parallel on
   the serve specs, as the reference's serve step runs it) and with tensor
   parallelism forced (weights drawn on the card from the seed, each rank
   keeping its blocks): a warm-up (4 x 256 tokens) and 3 counted prefills
   of 4 x 2048 tokens, timed by their median (``TP_PREFILL_RUNS``, as in
   phases 10-12; flash counted from 0 on each rank; collectives by
   kind; olmoe's expert-parallel drops in its first and last layer), 4
   sharded decode steps (greedy; qwen2-vl's fed the prefill's embeddings;
   whisper's with its cross K/V filled from the encoder) against a
   2048-long cache (whisper's 448); on rank 0 both against the unsharded ones on the card,
   held where the unsharded run meets the criterion against itself
   rounded as the ranks round (``tp_rounding``) and printed where it does
   not (ill-conditioned), and equal bit for bit to that rounded run where
   ``TP_EXACT`` says (qwen2-0.5b, olmoe-1b-7b's decode, qwen2-vl-7b's
   prefill); olmoe's
   expert-parallel prefill against the unsharded prefill with that branch
   emulated (``ep_emulated``), its decode compared where the routes agree;
   training at full width, the depth ``TP_TRAIN_DEPTHS`` (``reduced:``
   lines, each with its reason): a warm-up and 1 timed step (tokens/s,
   peak memory on each rank, collectives a step); qwen2-0.5b's one
   full-width f32 layer, sharded against unsharded, held (``mesh_hold``);
   and for each arch at full width, 2 layers (whisper's encoder too), the
   sharded prefill and 4 decode steps against the unsharded ones in bf16
   (held as at full depth) and in f32, the decode's K/V cache and score
   chain too (within 1e-4 of the largest |logit| of the unsharded run
   computed as the ranks compute it, rounded as they round and with their
   column blocks, and of the plain unsharded run wherever that twin is
   within it too; the SSM families' decode again with the conv window in
   f32: the sharded math's witness). A rank that fails fails the run.
10. the fallback layouts of tensor parallelism: the flash kernel held and
   timed at the four ranks' query offsets of qwen2-0.5b on model=4
   (``FB_FLASH_CASES``: 512 queries at 0, 512, 1024 and 1536 against 2048
   keys; SDPA with an explicit mask; the causal imbalance between them by
   device time alone, ``device_ms``), then four processes sharing the card
   on ``make_shared_card_mesh((1, 4))``, phase 9's steps for qwen2-0.5b at
   full width, 12 of its 24 layers (a ``reduced:`` line), whose 14 heads do
   not divide model=4 (head_dim
   sharded; ``TP_PHASES[10]``): the prefill (the median of 3; 12 flash
   launches a rank and prefill, each at its offset), 4 decode steps on the
   head_dim-sharded cache, both
   equal bit for bit to the unsharded run under ``tp_rounding(4)``, a train
   step at 2 layers, the f32 1-layer held step on 512 tokens a row, and the
   2-layer bf16 and f32 checks.
11. sequence sharding for serving (the reference's ``long_500k`` layout,
   B = 1, which does not fill the batch axes): the flash kernel held and
   timed at gemma3-1b's two sequence ranks' blocks, 16384 queries at
   offsets 0 and 16384 against 32768 keys, window 512 and none
   (``SEQ_FLASH_CASES``; device time alone; SDPA with an explicit mask),
   then two processes sharing the card on ``make_shared_card_mesh((2,
   1))`` (``--tp-phase 11``; rank 1's output in
   ``chiprun_out/chip_smoke/tp_ranks_11/``): gemma3-1b (26 layers),
   mamba2-2.7b (32 of 64) and zamba2-7b (7 of 81: ``reduced:`` lines) at full
   width, a sequence-sharded prefill of 1 x 32768 tokens (the median of 3;
   each rank's half; flash counted, collectives by kind) equal bit for bit to the unsharded
   prefill on rank 0, and 4 greedy decode steps against a 524288-long cache
   drawn for the positions before 524280 (its K/V half on each rank: 6.98
   GB for gemma3), equal bit for bit to the unsharded
   decode summed as the ranks sum (``tp_rounding(1, seq=2)``) and held to
   the plain one as phase 9 holds it; the same at 2 layers (zamba2 at 7)
   across the ranks' seam in bf16, and in f32 (its cache and score chain
   too) as phase 9's f32 witness, the prefill's twin running each product
   on the ranks' row blocks of the sequence
   (``_torch_train_criteria.tp_rows``). Then sequence-sharded training
   (``seq_train``): an f32 witness at 2 layers whose every gradient leaf
   lies within 1e-4 of the one-process step's (``hold_step``'s policy:
   widened by the probes' distance up to NUDGE_CAP tolerances; past that,
   ill-conditioned, within 1e-4 of the twin's, the one-process step
   computed as the ranks compute it), then one step of B = 1 x
   8192 at full width (gemma3-1b 2 layers, one windowed and one global,
   mamba2-2.7b 2, zamba2-7b 3, a group of two, the shared block and a
   trailing layer: a ``reduced:`` line each; the f32 witness's step stops
   once it has handed its optimizer the gradients; the probes run only
   where a step misses the plain criteria, which they can only widen) held
   on rank 0 against the one-process step as
   ``hold_step`` decides, both timed, with the collectives by kind (the
   backward's ``halo_back`` and ``relay_back`` too), the peak a rank and
   how long the relay's receives blocked (rank 0's in the backward).
12. sequence sharding composed with a fallback layout over "model": the
   flash kernel held and timed at the eight (sequence, model) ranks' query
   offsets of qwen2-0.5b on (data=2, model=4) (``SF_FLASH_CASES``: 4096
   queries at 0, 4096, ..., 28672 against 32768 keys; device time alone,
   the bound, SDPA with an explicit mask; each one-tile-off control
   missing), then eight processes sharing the card on
   ``make_shared_card_mesh((2, 4))`` (``--tp-phase 12``; ranks' output in
   ``chiprun_out/chip_smoke/tp_ranks_12/``): qwen2-0.5b at full width, 12
   of its 24 layers, its 14 heads head_dim-sharded, B = 1: the prefill of 1
   x 32768 tokens (the median of 3 after a warm-up; 12 flash launches a rank and
   prefill, each at its rank's offset) and 2 greedy decode steps (cut from
   8 for the script's time: a ``reduced:`` line) against a 524288-long
   cache (its head_dim block of its sequence block on each rank, 0.8 GB of
   K/V), both bit for bit the unsharded run under ``tp_rounding(4,
   seq=2)``; the 2-layer bf16 and f32 checks as phase 11's;
   sequence-sharded training as phase 11's, qwen2-0.5b at 2 layers (its
   head_dim-sharded attention, the fallback layout).
   Phases 9-12 run one driver (``tp_serve``, ``tp_shallow``), each with its
   shapes from ``TP_PHASES``; ``--tp-phase N`` (repeatable) runs the
   set-up and the kernels' build as the whole script does, then those
   phases alone, with no result line.
13. the dry run against the card (``launch.dryrun``, ``roofline.op_count``):
   qwen2-0.5b at full width, its prefill of 4 x 2048 (phase 5's, 24 layers)
   and its train step of 4 x 2048 (phase 7's, 2 layers), each traced on
   fake CUDA tensors, then run on the card: ``FlopCounterMode`` over the
   real step counts the trace's FLOPs exactly, the card's peak
   (``max_memory_allocated`` after a reset, the arguments resident) lies
   within 10 % of the trace's, the median of 3 steps is no faster than
   ``roofline_report(hw=H100)``'s lower bound allows (its share at most
   105 %), and the prefill launches flash as often as the trace called it;
   the dry run's CLI traces qwen2-0.5b's decode_32k cell at ranks 0 and 255
   of the (16, 16) mesh on this machine, which has no JAX; the four examples
   (``repro_torch.examples``) run with ``--device cuda``, quickstart and
   reconfigure_live printing what they print with ``--device cpu`` (run in
   subprocesses meanwhile), their storage kernels' launches joining the
   kernels' line. ``--dryrun-phase`` runs the set-up and the kernels' build,
   then this phase alone, with no result line.
14. sequence sharding for the MoE, VLM and encoder-decoder families, after
   phase 13: the flash kernel held and timed at each sequence rank's block
   and offset (``FAM_FLASH_CASES``: olmoe-1b-7b's 2048 queries at 0 and 2048
   on 4096 keys, qwen2-vl-7b's 16384 at 0 and 16384 on 32768 (GQA 7, its
   plain version in pieces, ``plain_flash``), whisper-base's encoder 750
   frames on 1500 (non-causal), decoder 224 tokens at 0 and 224 on 448,
   cross-attention 224 on 1500; each one-tile-off control missing; device
   time alone, the bound, SDPA with an explicit mask), then two processes
   sharing the card on ``make_shared_card_mesh((2, 1))`` (``--tp-phase
   14``; rank 1's output in ``chiprun_out/chip_smoke/tp_ranks_14/``), B = 1
   at each family's published context: olmoe-1b-7b (4 layers) on 1 x 4096
   tokens, qwen2-vl-7b (4 layers) on 1 x 32768 embeddings with M-RoPE
   positions, whisper-base at full depth on 1500 frames and 448 tokens (the
   pure data-parallel model, as the reference runs it): the prefill (the
   median of 3 after a warm-up; flash counted, collectives by kind) equal
   bit for bit to the unsharded prefill on rank 0, olmoe's drops equal to
   the unsharded drops layer by layer (each rank routes the whole
   sequence), and 4 decode steps from the first rank's last slot across
   the ranks' seam (whisper's cross K/V drawn per sequence block, 750
   frames a rank) equal bit for bit to the unsharded decode summed as the
   ranks sum (``tp_rounding(1, seq=2)``); then ``seq_train``'s f32 witness
   at 2 layers and one timed bf16 step (olmoe 2 layers x 4096, qwen2-vl 2
   layers x 8192, whisper 6 layers, 384 tokens on 1024 frames) held on
   rank 0 against the one-process step.

The line before the last holds the kernels' launches and times, the last
line ``{"ok": true, "device": {...}}``. With no CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed 0] [--size-mib 512] [--out chiprun_out/chip_smoke]
    python3 chip_smoke.py --tp-phase 12 [--tp-phase 11]   # those phases alone (9-12, 14)
    python3 chip_smoke.py --dryrun-phase                   # phase 13 alone
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
MIN_BLOCK, AVG_BLOCK, MAX_BLOCK = 512 << 10, 512 << 10, 1 << 20  # the paper's own
SMALL_FILE = 3 << 20  # the file of the card-vs-CPU trace check


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after one
    warm-up: the calls are queued behind a spin of the card
    (``torch.cuda._sleep``), so that the events bracket the card's work
    alone, where ``cuda_ms`` also counts the host's launch cost between
    calls shorter than it. The spin doubles until the host has queued every
    call before the card reaches the first."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25  # ~17 ms at the H100's 1.98 GHz
    for _ in range(6):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError(f"the card reached the queued calls before the host had queued them, "
                         f"after a spin of {cycles // 2} cycles")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2
def build(out_dir: Path) -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(
        "".join(f"== {name}\n{text}\n" for name, text in logs.items())
    )
    log(f"build: {len(logs)} kernel libraries in {dt:.3f} s "
        f"({', '.join(_build.library_path(n).name for n in logs)})")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"build: {name}: {entry}: {line.removeprefix('ptxas info    :').strip()}")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name: its last name component and
    its integer template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    targs = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[i:])
    args = re.findall(r"\d+", targs.group(1)) if targs else []
    return (parts[-1] if parts else mangled) + (f"<{', '.join(args)}>" if args else "")


# ---------------------------------------------------------------- phase 3
def _u8_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max()) if a.numel() else 0


def _u32_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if not a.numel():
        return 0
    m = 0xFFFFFFFF
    a64 = a.view(torch.int32).to(torch.int64) & m
    b64 = b.view(torch.int32).to(torch.int64) & m
    return int((a64 - b64).abs().max())


def check_gf256(path_L: int, rng: np.random.Generator, card: str) -> dict:
    from repro_torch.erasure.rs import _decoder_cached, _parity_cached
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref

    dev = torch.device("cuda")
    n, k = 11, 6
    enc = _parity_cached(n, k)                         # (5, 6): every encode
    dec = _decoder_cached(n, k, tuple(range(1, 7)))    # (6, 6): decode without s0
    worst = 0
    cases = [(enc, path_L), (dec, path_L)]
    for L in (1, 7, 15, 16, 17, 4095, 4096, 4097, 1_000_003):   # ragged and misaligned
        cases.append((enc, L))
    cases.append((rng.integers(0, 256, (16, 16), dtype=np.uint8), 65_537))
    cases.append((rng.integers(0, 256, (256, 256), dtype=np.uint8), 4_099))  # 32 x 32 tiles
    special = np.array([[0, 1, 2, 255], [128, 0, 3, 1]], dtype=np.uint8)       # edge values
    cases.append((special, 33))
    # 0s and 1s beside full entries, with an input row of units alone
    mixed = rng.integers(0, 256, (7, 6), dtype=np.uint8)
    mixed[rng.integers(0, 3, (7, 6)) == 0] = 0
    mixed[rng.integers(0, 3, (7, 6)) == 0] = 1
    mixed[:, 0] = 1
    block = 8 * 31 * 16  # a block's columns: 8 warps of 31 strips of 16
    for rem in range(1, 16):  # multi-block rows with every L % 16: every row offset
        L = 5 * block + 17 * rem
        cases += [(enc, L), (dec, L), (mixed, L)]
    for L in (495, 496, 497, block - 1, block, block + 1):  # warp and block seams
        cases.append((mixed, L))
    unaligned = len(cases)  # from here on, B's base is not 16-byte aligned
    cases += [(enc, 100_003), (dec, 4_097)]
    for n, (A, L) in enumerate(cases):
        B = torch.from_numpy(rng.integers(0, 256, (A.shape[1], L), dtype=np.uint8)).to(dev)
        if A is special:
            B[:, :8] = torch.tensor([0, 1, 2, 255, 128, 254, 0, 3], dtype=torch.uint8)
        if n >= unaligned:
            flat = torch.empty(B.numel() + 5, dtype=torch.uint8, device=dev)
            flat[5:] = B.reshape(-1)
            B = flat[5:].view(B.shape)
        got = gf.gf256_matmul(A, B)
        torch.cuda.synchronize()
        want = gf256_matmul_ref(torch.from_numpy(A), B)
        err = _u8_err(got, want)
        if err or got.shape != want.shape:
            raise AssertionError(
                f"gf256_matmul {A.shape} x (.., {L}) differs from the plain version")
        worst = max(worst, err)
    before = gf.launches
    for A, L in ((np.zeros((0, 6), np.uint8), 100), (np.zeros((5, 0), np.uint8), 100), (enc, 0)):
        out = gf.gf256_matmul(A, torch.zeros((A.shape[1], L), dtype=torch.uint8, device=dev))
        if out.shape != (A.shape[0], L) or out.numel() and int(out.max()):
            raise AssertionError(f"degenerate gf256_matmul {A.shape} x (.., {L}) is not zeros")
    if gf.launches != before:
        raise AssertionError("a degenerate gf256_matmul launched the kernel")
    log(f"kernels: gf256_matmul byte-identical (tolerance 0) to the plain version on "
        f"{len(cases)} shapes (encode and decode at L={path_L}; every L % 16 over several "
        f"blocks; 0/1/full coefficients; warp and block seams; unaligned B) and 3 degenerate ones")

    timings = {}
    for label, A in (("encode", enc), ("decode", dec)):
        B = torch.from_numpy(rng.integers(0, 256, (A.shape[1], path_L), dtype=np.uint8)).to(dev)
        At = torch.from_numpy(A)
        ms = cuda_ms(lambda: gf.gf256_matmul(A, B), 20)
        plain_ms = cuda_ms(lambda: gf256_matmul_ref(At, B), 2)
        bound_ms = (A.shape[0] + A.shape[1]) * path_L / HBM_BYTES_PER_S * 1e3
        timings[label] = (ms, plain_ms, bound_ms)
        log(f"kernels: gf256_matmul {label} {A.shape} x (6, {path_L}) "
            f"({int((A == 0).sum())} zero, {int((A == 1).sum())} unit coefficients): {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
            f"{100 * bound_ms / ms:.2f} % of its bound ({card})")
        del B
    ms, plain_ms, bound_ms = timings["encode"]
    return {"name": "gf256_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/gf256_matmul.cu",
            "replaces": "src/repro/kernels/gf256_matmul/kernel.py:67",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def check_gearhash(data: np.ndarray, rng: np.random.Generator, card: str) -> dict:
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.cdc_gearhash.ref import gearhash_ref

    dev = torch.device("cuda")
    path_mask = cdc._mask_for_avg(AVG_BLOCK)
    worst = 0
    span = 8192  # a warp's span: 16 steps of 512 positions
    seam = np.zeros(3 * span + 77, dtype=np.uint8)       # zeros across span seams
    seam[span - 8:span + 12] = rng.integers(0, 256, 20, dtype=np.uint8)
    cases = [(data, path_mask), (data[: 64 << 20], 0xFFFF), (seam, 0xFFFF), (seam, 0),
             (seam, 0xFFFFFFFF)]
    for L in (1, 31, 32, 33, 511, 512, 513, 2047, 2048, 2049, 4127,
              span - 1, span, span + 1, 2 * span + 1):
        cases.append((rng.integers(0, 256, L, dtype=np.uint8), 0xFF))
    unaligned = len(cases)  # from here on, the stream's base is not 16-byte aligned
    cases += [(rng.integers(0, 256, 100_003, dtype=np.uint8), 0xFF)]
    for n, (arr, mask) in enumerate(cases):
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        if n >= unaligned:
            x = torch.cat([x[:3], x])[3:]
        h, b = cdc.gearhash(x, mask=mask)
        b_only = cdc.gearhash_bitmap(x, mask=mask)
        torch.cuda.synchronize()
        hr, br = gearhash_ref(x, mask=mask)
        err = max(_u32_err(h, hr), _u8_err(b, br), _u8_err(b_only, br))
        if err:
            raise AssertionError(
                f"gearhash at L={x.shape[0]} mask={mask:#x} differs from the plain version")
        worst = max(worst, err)
        del x, h, b, b_only, hr, br
    log(f"kernels: gearhash hash and bitmap, and the bitmap-only form, byte-identical (tolerance "
        f"0) to the plain version on {len(cases)} inputs (the path's {data.size} bytes, position "
        f"0, step and span seams, masks 0 and 0xFFFFFFFF, an unaligned stream)")
    x = torch.from_numpy(data).to(dev)
    ms = cuda_ms(lambda: cdc.gearhash(x, mask=path_mask), 20)
    bitmap_ms = cuda_ms(lambda: cdc.gearhash_bitmap(x, mask=path_mask), 20)
    plain_ms = cuda_ms(lambda: gearhash_ref(x, mask=path_mask), 2)
    bound_ms = 6 * data.size / HBM_BYTES_PER_S * 1e3  # 1 byte in, 4 + 1 out
    bitmap_bound_ms = 2 * data.size / HBM_BYTES_PER_S * 1e3  # 1 byte in, 1 out
    log(f"kernels: gearhash L={data.size}: hash + bitmap {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes), {100 * bound_ms / ms:.2f} % of its bound; bitmap only "
        f"{bitmap_ms:.4f} ms, bound {bitmap_bound_ms:.4f} ms (bytes), "
        f"{100 * bitmap_bound_ms / bitmap_ms:.2f} % of its bound ({card})")
    return {"name": "cdc_gearhash", "route": "cuda",
            "source": "src/repro_torch/csrc/cdc_gearhash.cu",
            "replaces": "src/repro/kernels/cdc_gearhash/kernel.py:58",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


PREFILL_B, PREFILL_S = 4, 2048  # the model path's prefill: its flash kernel's shape
# whisper-base's published context (its n_audio_ctx and n_text_ctx): 30 s of
# audio are 1500 encoder frames, and the decoder holds at most 448 positions
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
# whisper's training frames: the reference's training attention
# (``gqa_attention``, q_chunk 1024) asserts that above 1024 queries their
# count is a multiple of 1024, and the port keeps that, so neither trains
# the encoder on 1500 frames; 1024 frames (20.48 s of audio) is the most
# both train below 2048
WHISPER_TRAIN_FRAMES = 1024
FLASH_CASES = (
    # (label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, input scale)
    ("path", PREFILL_B, 14, 2, PREFILL_S, PREFILL_S, 64, True, 0, torch.bfloat16, 1.0),
    # olmoe-1b-7b's prefill (phase 5b): hd 128, the two-consumer-warpgroup form
    ("olmoe path", PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 128, True, 0, torch.bfloat16, 1.0),
    # zamba2-7b's prefill (phase 5c): hd 112, padded to two 64-column chunks on the card
    ("zamba2 path", PREFILL_B, 32, 32, PREFILL_S, PREFILL_S, 112, True, 0, torch.bfloat16, 1.0),
    ("f32 hd 112 Sq<Sk GQA", 2, 8, 2, 320, 1111, 112, True, 0, torch.float32, 1.0),
    ("sliding window", 1, 4, 1, 2048, 2048, 256, True, 512, torch.bfloat16, 1.0),
    ("f32 Sq<Sk top-left causal", 2, 4, 2, 320, 1111, 128, True, 0, torch.float32, 1.0),
    ("extreme logits x30", 1, 2, 2, 256, 256, 32, True, 0, torch.float32, 30.0),
    # the bf16 (tensor-core) form where it is most fragile
    ("bf16 Sq<Sk top-left causal", 2, 4, 2, 320, 1111, 128, True, 0, torch.bfloat16, 1.0),
    ("bf16 extreme logits x30", 1, 2, 2, 256, 256, 32, True, 0, torch.bfloat16, 30.0),
    ("bf16 rows with no key", 1, 2, 2, 200, 50, 64, True, 16, torch.bfloat16, 1.0),
    ("bf16 non-causal ragged Sk", 1, 2, 2, 65, 2049, 64, False, 0, torch.bfloat16, 1.0),
    ("bf16 Sq=1", 2, 14, 2, 1, 77, 64, True, 0, torch.bfloat16, 1.0),
    ("bf16 hd 16 GQA", 2, 4, 2, 333, 333, 16, False, 0, torch.bfloat16, 1.0),
    # whisper-base's prefill (phase 5d) at its published context: the
    # encoder, non-causal over 1500 frames; the decoder's causal
    # self-attention over 448 tokens; its cross-attention, non-causal, 448
    # queries against the 1500 frames
    ("whisper encoder", PREFILL_B, 8, 8, WHISPER_FRAMES, WHISPER_FRAMES, 64, False, 0,
     torch.bfloat16, 1.0),
    ("whisper decoder", PREFILL_B, 8, 8, WHISPER_TOKENS, WHISPER_TOKENS, 64, True, 0,
     torch.bfloat16, 1.0),
    ("whisper cross", PREFILL_B, 8, 8, WHISPER_TOKENS, WHISPER_FRAMES, 64, False, 0,
     torch.bfloat16, 1.0),
    # non-causal with more queries than keys (the reference's make_inputs
    # convention of S tokens against S // 2 frames)
    ("bf16 non-causal Sq>Sk", PREFILL_B, 8, 8, PREFILL_S, PREFILL_S // 2, 64, False, 0,
     torch.bfloat16, 1.0),
    # qwen2-vl-7b's prefill (phase 5d): 7 query heads a KV head at hd 128
    ("qwen2-vl path", PREFILL_B, 28, 4, PREFILL_S, PREFILL_S, 128, True, 0, torch.bfloat16, 1.0),
)
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# a bf16 block of queries at an offset: every row within this many bf16 ulps
# of the row's largest |output| (``_torch_moe_criteria.row_ulps``). At a
# rank's block of 16384 rows against 32768 keys the outputs are ~0.011
# (largest ~0.06), so FLASH_TOL's 2e-2 would pass a kernel wrong by that
# much on every row; the kernel and its plain version each round the f32
# output to bf16 once, 1 ulp apart at most, and the kernel's bf16 P moves the
# sum by far less. ``hold_flash_offset`` also shows that the limit catches
# a kernel whose offset is one key tile off, or that drops the first tile
FLASH_ROW_ULPS = 4
# a rank's block of queries at its ``q_offset`` against all the keys (the
# fallback layout's attention): S/4 queries at 0, S/4 and 3S/4 of gemma3-1b's
# local layers (window 512, the form its model=8 and 16 ranks take) and global
# ones, and the f32 form; and gemma3-1b's ``long_500k`` cell on the production
# meshes, its prefill of 32768 tokens over 16 sequence ranks: a sequence
# rank's block of 2048 queries (its 16 "model" ranks attend 128 of them each,
# at their offsets within it) at the first, the middle and the last sequence
# rank's offsets, windowed and global: held here and timed
# (``GEMMA3_PRODUCTION_BLOCKS``) without running the model, whose 16 x 16
# ranks one card cannot host. qwen2-0.5b's at model=4 is phase
# 10's (``FB_FLASH_CASES``), its (sequence, model) ranks phase 12's
# (label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, offsets)
GEMMA3_PRODUCTION_BLOCKS = tuple(
    (f"gemma3 long_500k production sequence rank block {'window 512' if w else 'global'}",
     1, 4, 1,
     2048, 32768, 256, True, w, torch.bfloat16, (0, 16384, 30720)) for w in (512, 0))
FLASH_OFFSET_CASES = (
    ("gemma3 local block", PREFILL_B, 4, 1, PREFILL_S // 4, PREFILL_S, 256, True, 512,
     torch.bfloat16, (0, PREFILL_S // 4, 3 * PREFILL_S // 4)),
    ("gemma3 global block", PREFILL_B, 4, 1, PREFILL_S // 4, PREFILL_S, 256, True, 0,
     torch.bfloat16, (0, PREFILL_S // 4, 3 * PREFILL_S // 4)),
    ("f32 block", 2, 4, 2, 256, 1024, 128, True, 0, torch.float32, (0, 256, 768)),
    *GEMMA3_PRODUCTION_BLOCKS,
)
PATH_LABELS = ("path", "encoder", "decoder", "cross")  # the cases a model phase runs: timed
# timed only: gemma3-1b's prefill at 4 x 2048 (hd 256, 4 query heads on one
# KV head), its local layers' 512-key window and its global layers' none.
# No model phase runs it: gemma3 is served on the CPU in the tests only.
FLASH_TIMED = (
    ("gemma3 local layers", PREFILL_B, 4, 1, PREFILL_S, PREFILL_S, 256, True, 512,
     torch.bfloat16, 1.0),
    ("gemma3 global layers", PREFILL_B, 4, 1, PREFILL_S, PREFILL_S, 256, True, 0,
     torch.bfloat16, 1.0),
)


def check_flash(rng: np.random.Generator, card: str) -> dict:
    """The flash-attention kernel against its plain version on the cases
    above (tolerance 2e-2 in bf16: one bf16 rounding of outputs near 1;
    1e-4 in f32: sums in another order; the offset cases as
    ``hold_flash_offset`` holds them), then timed at the path shapes
    (qwen2-0.5b's hd 64, olmoe-1b-7b's hd 128, whisper-base's encoder,
    decoder and cross-attention, qwen2-vl-7b's GQA 7 at hd 128, zamba2-7b's
    hd 112) and
    at gemma3-1b's two (hd 256, ``FLASH_TIMED``) beside its plain version and
    ``scaled_dot_product_attention``. The JSON entry holds zamba2-7b's."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    worst = 0.0
    for label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, scale in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                   for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
        q, k, v = (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {label}: max |err| {err} > {tol}")
        log(f"kernels: flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} "
            f"{str(dtype).removeprefix('torch.')} causal={causal} window={window}: "
            f"max |err| {err:.3e} (tolerance {tol})")
        worst = max(worst, err) if label.endswith(PATH_LABELS) else worst
        del q, k, v, got, want

    for label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, offsets in FLASH_OFFSET_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                   for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
        for off in offsets:
            hold_flash_offset(label, q, k, v, causal, window, off)
        del q, k, v
    timed = {}
    for label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, offsets in GEMMA3_PRODUCTION_BLOCKS:
        for off in offsets:
            timed[label, off] = time_flash((f"{label} (q_offset {off})", B, H, Hkv, Sq, Sk, hd,
                                            causal, window, dtype, 1.0, off), rng, card)
    log("kernels: flash_attention at gemma3-1b's long_500k production sequence rank blocks, "
        "device time alone: " + "; ".join(f"{label.split(' block ')[-1]} q_offset {off} {t['device_ms']:.4f} ms "
                              f"(bound {t['bound_ms']:.4f} ms, SDPA with the mask "
                              f"{t['library_device_ms']:.4f} ms)"
                              for (label, off), t in timed.items()) + f" ({card})")

    for case in FLASH_CASES:
        if case[0].endswith(PATH_LABELS) and case[0] != "zamba2 path":
            time_flash(case, rng, card)
    for case in FLASH_TIMED:
        time_flash(case, rng, card)
    entry = time_flash(FLASH_CASES[2], rng, card)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
            "max_abs_err": worst, **entry}


PLAIN_SCORES = 1 << 32  # bytes of f32 scores the kernel's plain version makes at a time


def plain_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                window: int, q_offset: int = 0) -> torch.Tensor:
    """The kernel's plain version (``flash_attention_ref``), over pieces of the
    queries small enough that its f32 scores take at most PLAIN_SCORES bytes
    at a time: each KV head's group of query heads, a block of rows at a
    time at its own offset (a row's output is its own: the same function).
    qwen2-vl-7b's sequence rank block, 28 heads of 16384 queries on 32768
    keys, would take 60 GB of scores at once."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, H, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if B * H * Sq * Sk * 4 <= PLAIN_SCORES:
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    G = H // Hkv
    rows = max(1, PLAIN_SCORES // (B * G * Sk * 4))
    out = torch.empty_like(q)
    for g in range(Hkv):
        heads = slice(g * G, (g + 1) * G)
        for r0 in range(0, Sq, rows):
            out[:, heads, r0:r0 + rows] = flash_attention_ref(
                q[:, heads, r0:r0 + rows], k[:, g:g + 1], v[:, g:g + 1], causal=causal,
                window=window, q_offset=q_offset + r0)
    return out


def hold_flash_offset(label: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: int, off: int) -> float:
    """The kernel at ``q_offset`` ``off`` against its plain version
    (``plain_flash``): in bf16 every row within FLASH_ROW_ULPS bf16 ulps of
    its largest |output|, in f32 within FLASH_TOL. In bf16 the same limit
    must then fail the kernel run one key tile (64 keys at hd 256, else 128)
    off: at an offset one tile lower (higher at 0), and, where the offset is
    past the first tile and there is no window, with the first tile's keys
    dropped; a non-causal call without a window reads no offset, so there
    only with the first tile's keys dropped. Returns the max |err|."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_moe_criteria import row_ulps

    from repro_torch.kernels.flash_attention import ops as fa

    def kernel(q_off: int, skip: int = 0) -> torch.Tensor:
        out = fa.flash_attention(q, k[:, :, skip:].contiguous(), v[:, :, skip:].contiguous(),
                                 causal=causal, window=window, q_offset=q_off)
        torch.cuda.synchronize()
        return out

    got = kernel(off)
    want = plain_flash(q, k, v, causal=causal, window=window, q_offset=off)
    err = float((got.float() - want.float()).abs().max())
    what = (f"flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} "
            f"{str(q.dtype).removeprefix('torch.')} causal={causal} window={window} q_offset={off}")
    if q.dtype == torch.float32:
        if not err <= FLASH_TOL[q.dtype] or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: max |err| {err} > {FLASH_TOL[q.dtype]}")
        log(f"kernels: {what}: max |err| {err:.3e} (tolerance {FLASH_TOL[q.dtype]})")
        return err
    ulps = row_ulps(got, want)
    if not ulps <= FLASH_ROW_ULPS:
        raise AssertionError(f"{what}: a row {ulps} bf16 ulps of its largest |output| off "
                             f"(max |err| {err}), more than {FLASH_ROW_ULPS}")
    tile = 64 if q.shape[-1] > 128 else 128
    if not causal and not window:
        wrong = {f"its first {tile} keys dropped": kernel(off, tile)}
    else:
        wrong = {f"offset {tile} keys off": kernel(off - tile if off >= tile else off + tile)}
    if off >= tile and not window and causal:
        wrong[f"its first {tile} keys dropped"] = kernel(off - tile, tile)
    reach = {name: row_ulps(out, want) for name, out in wrong.items()}
    missed = [name for name, r in reach.items() if not r > FLASH_ROW_ULPS]
    if missed:
        raise AssertionError(f"{what}: the limit of {FLASH_ROW_ULPS} ulps a row passes the kernel "
                             f"run with {missed} ({reach})")
    log(f"kernels: {what}: max |err| {err:.3e} (largest |output| "
        f"{float(want.float().abs().max()):.3e}), the worst row {ulps:.3f} bf16 ulps of its "
        f"largest |output| (limit {FLASH_ROW_ULPS}); the kernel run with "
        + ", ".join(f"{name}: {r:.1f} ulps" for name, r in reach.items()) + " (missed the limit)")
    return err


def time_flash(case: tuple, rng: np.random.Generator, card: str) -> dict:
    """The kernel timed at a bf16 shape of ``FLASH_CASES``, ``FLASH_TIMED`` or
    a phase's rank shapes (``TP_PHASES``; a 12th entry, where there is one,
    is the queries' offset), beside its plain version,
    ``scaled_dot_product_attention`` (with a boolean mask where there is a
    window or an offset: its ``is_causal`` masks from position 0) and its
    bound. Where there is an offset, the kernel and SDPA are also timed by
    their device time alone (``device_ms``: ``"device_ms"``,
    ``"library_device_ms"``), since at a rank's block the host's launch
    cost can exceed the kernel's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import work

    dev = torch.device("cuda")
    label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, _, *offset = case
    off = offset[0] if offset else 0
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
               for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
    ke, ve = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    flops = work.flops(B, H, Sq, Sk, hd, window, causal, off)
    # q in and o out; the K and V rows the masks reach, each read once
    nbytes = work.hbm_bytes(B, H, Hkv, Sq, Sk, hd, q.element_size(), window, causal, off)
    flop_ms, byte_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"
    qp, kp = off + torch.arange(Sq, device=dev)[:, None], torch.arange(Sk, device=dev)[None]
    mask = None
    if window or (off and causal):
        mask = (kp <= qp) if causal else torch.ones_like(kp <= qp)
        if window:
            mask = mask & (qp - kp < window)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask, is_causal=causal and mask is None), 20)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off),
                 20)
    plain_ms = cuda_ms(lambda: plain_flash(q, k, v, causal=causal, window=window, q_offset=off),
                       2)
    timed = {}
    if offset:
        timed["device_ms"] = device_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=off), 20)
        timed["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask, is_causal=causal and mask is None), 20)
    log(f"kernels: flash_attention {label} q{tuple(q.shape)} k/v{tuple(k.shape)} bf16 "
        f"{'causal' if causal else 'non-causal'} window={window}"
        + (f" q_offset={off}" if off else "")
        + f": {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops} flops at 989 TFLOP/s "
        f"= {flop_ms:.4f} ms, {nbytes} bytes at 3.35 TB/s = {byte_ms:.4f} ms); "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.2f} % of its bound, "
        f"{ms / library_ms:.3f}x the time of scaled_dot_product_attention ({card})")
    if timed:
        dms, lms = timed["device_ms"], timed["library_device_ms"]
        log(f"kernels: flash_attention {label} device time alone (20 calls queued behind a spin): "
            f"{dms:.4f} ms, {100 * bound_ms / dms:.2f} % of its bound; "
            f"scaled_dot_product_attention {lms:.4f} ms, {dms / lms:.3f}x its time ({card})")
    del q, k, v, ke, ve
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **timed}


# ---------------------------------------------------------------- phase 4
def drive_path(data: bytes, *, device: str, seed: int, quiet: bool = False,
               card: str = "") -> dict:
    """The quickstart sequence on the Emulab deployment; returns what it saw.
    Raises on a wrong byte, a kernel that a step should run but did not, or
    a stuck quorum round."""
    from repro_torch.configs.paper_store import EMULAB, make_dss
    from repro_torch.core import gather
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf

    on_card = device == "cuda"
    say = (lambda *a: None) if quiet else log
    dss = make_dss(EMULAB, seed=seed, indexed=True, coding_backend="kernel", device=device,
                   min_block=MIN_BLOCK, avg_block=AVG_BLOCK, max_block=MAX_BLOCK)
    alice, bob, admin = dss.session("alice"), dss.session("bob"), dss.session("admin")
    seen: dict = {"steps": {}}

    def step(name: str, fn, *, cdc_runs: bool, gf_runs: bool):
        c0, g0 = cdc.launches, gf.launches
        t0 = time.perf_counter()
        out = fn()
        dss.net.run()  # drain background traffic (the recon's repair pass) before checking
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dc, dg = cdc.launches - c0, gf.launches - g0
        if on_card and ((cdc_runs and not dc) or (gf_runs and not dg)):
            raise AssertionError(f"{name}: expected kernel launches, got cdc={dc} gf={dg}")
        stuck = dss.net.stuck_ops()
        if stuck:
            raise AssertionError(f"{name}: stuck quorum rounds {stuck!r}")
        seen["steps"][name] = {"wall_s": dt, "cdc_launches": dc, "gf_launches": dg}
        say(f"path: {name}: {dt:.3f} s wall, launches cdc_gearhash +{dc} gf256_matmul +{dg}"
            + (f" ({card})" if card else ""))
        return out

    fid = "object.bin"

    def write_first():
        fut = alice.write(fid, data)
        st = gather(fut)[0]
        seen["write"] = (st, fut.stats)
        return st

    st = step("write", write_first, cdc_runs=True, gf_runs=True)
    say(f"path: write: {st['blocks']} blocks, {seen['write'][1]}")

    def read_back(tag, reader=bob):
        fut = reader.read(fid)
        got = fut.result()
        if got != want[0]:
            raise AssertionError(f"{tag}: read bytes differ from what was written")
        seen.setdefault("reads", []).append(fut.stats)

    want = [data]
    step("read", lambda: read_back("read"), cdc_runs=False, gf_runs=False)
    dss.crash_servers(["s0"])  # holds data fragment 0: reads must decode
    # a reader that holds no copy yet: EC-DAPopt ships no data to a client
    # that already has the newest tag, so bob would not decode here
    carol = dss.session("carol")
    step("degraded read (s0 down)", lambda: read_back("degraded read", carol),
         cdc_runs=False, gf_runs=True)

    edited = bytearray(data)
    at = len(data) // 2
    edited[at:at + 16] = b"EDITED-IN-PLACE!"
    want[0] = bytes(edited)
    st2 = step("edit 16 bytes", lambda: alice.write(fid, want[0]).result(),
               cdc_runs=True, gf_runs=True)
    if not st2["written"] < st2["blocks"]:
        raise AssertionError(f"edit rewrote every block: {st2}")
    say(f"path: edit: rewrote {st2['written']}/{st2['blocks']} blocks")
    seen["edit"] = st2
    step("read after edit", lambda: read_back("read after edit"), cdc_runs=False, gf_runs=True)

    margin_down = step("stat", lambda: alice.stat(fid).result()["margin"],
                       cdc_runs=False, gf_runs=False)
    dss.recover_servers(["s0"])
    rep = step("recover s0 + repair", lambda: dss.repair(), cdc_runs=False, gf_runs=True)
    margin_up = alice.stat(fid).result()["margin"]
    if not margin_up > margin_down:
        raise AssertionError(f"repair did not restore the margin: {margin_down} -> {margin_up}")
    say(f"path: stat margin {margin_down} with s0 down, {margin_up} after repair "
        f"({len(rep)} objects repaired)")
    seen["margins"] = (margin_down, margin_up)

    cfg = dss.make_config(n_servers=EMULAB.n_servers, parity_m=EMULAB.parity_m,
                          fresh_servers=True)
    moved = step("recon to a fresh EC config", lambda: admin.recon(fid, cfg).result(),
                 cdc_runs=False, gf_runs=True)
    step("read after recon", lambda: read_back("read after recon"), cdc_runs=False, gf_runs=False)
    say(f"path: recon moved {moved['blocks']} blocks to {cfg.cfg_id} {cfg.servers}")
    n = dss.net
    seen["fingerprint"] = (n.now, n.events_processed, n.rpc_rounds, n.msg_count, n.bytes_sent,
                           n.client_counters)
    seen["moved"] = moved
    return seen


KERNEL_KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("flash_attention", ("flash_fwd",)), ("gf256_matmul", ("gf256_matmul",)),
    ("cdc_gearhash", ("gearhash",)), ("cuBLAS GEMM", ("nvjet", "gemm", "Gemv", "cutlass")),
    ("copies and casts", ("copy",)),
)


def _kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other elementwise and reductions"


def device_busy(prof, trace: Path, wall: float, tag: str) -> list:
    """Write ``prof``'s trace to ``trace`` + ``.gz`` (gzip: the traces of
    every phase must fit what a run brings back) and print the device's
    busy time (kernels + copies + fills, summed from the trace) against
    ``wall``, its split by kind of kernel, and the costliest kernels.
    Returns the trace's events."""
    import gzip

    prof.export_chrome_trace(str(trace))
    text = trace.read_bytes()
    trace.with_name(trace.name + ".gz").write_bytes(gzip.compress(text, compresslevel=1))
    trace.unlink()
    busy: dict[str, float] = {}
    kinds: dict[str, list] = {}
    events = json.loads(text).get("traceEvents", [])
    for ev in events:
        cat = ev.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = ev["name"] if cat == "kernel" else cat
            sec = ev.get("dur", 0.0) * 1e-6
            busy[key] = busy.get(key, 0.0) + sec
            kind = kinds.setdefault(_kind(key) if cat == "kernel" else cat, [0.0, 0])
            kind[0] += sec
            kind[1] += 1
    total = sum(busy.values())
    log(f"{tag} device busy {total:.6f} s of {wall:.6f} s wall under the profiler "
        f"({100 * total / wall:.3f} %; idle {100 - 100 * total / wall:.3f} %), "
        f"{sum(n for _, n in kinds.values())} device operations")
    for kind, (sec, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"{tag} by kind {sec:.6f} s ({100 * sec / total:.2f} % of busy) in {n}: {kind}")
    for key, sec in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{tag} device {sec:.6f} s ({100 * sec / total:.2f} % of busy) {key[:90]}")
    return events


def profile_path(data: bytes, out_dir: Path, seed: int) -> None:
    """The main path once more, under ``cProfile`` (host) and
    ``torch.profiler`` (device). Writes ``host_profile.txt`` and
    ``path_trace.json.gz`` to ``out_dir`` and prints the device's busy share
    (kernels + copies + fills, summed from the trace) of the wall time and
    the host functions that took the most time."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dev:
        t0 = time.perf_counter()
        host.enable()
        drive_path(data, device="cuda", seed=seed, quiet=True)
        host.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_busy(dev, out_dir / "path_trace.json", wall, "profile:")
    text = io.StringIO()
    stats = pstats.Stats(host, stream=text)
    stats.sort_stats("tottime").print_stats(40)
    (out_dir / "host_profile.txt").write_text(text.getvalue())
    for (file, line, fn), row in stats.stats.items():
        if fn in ("gf256_coding_matmul", "split_chunks", "encode_bytes_batch",
                  "decode_bytes_batch") or fn.endswith(("crc32>", "sha1>")):
            log(f"profile: data plane {row[3]:.3f} s cumulative, {row[1]} calls: {fn}")
    for (file, line, fn), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]:
        log(f"profile: host {row[2]:.3f} s self, {row[3]:.3f} s cumulative, {row[1]} calls: "
            f"{Path(file).name}:{line} {fn}")


# ---------------------------------------------------------------- phase 6
# (a) YCSB core workload B (95 % reads, 5 % updates, zipfian 0.99) over the
# paper's 4 MB files (§VII), every session attached to one gateway
YCSB_B = dict(sessions=256, files=64, file_size=4 << 20, read_fraction=0.95, zipf_s=0.99,
              ops_per_session=2)
STORM = dict(at=0.05, frac=0.25, duration=0.05)  # capped at n - quorum = 2 of 11 crashes
# (b) the sanitized, race-checked run; and the card-vs-CPU check of (a)'s spec
SANITIZED = dict(YCSB_B, sessions=64, files=16, file_size=1 << 20)
SMALL_YCSB = dict(YCSB_B, sessions=32, files=8, file_size=3 << 20)


def storm_retry(spec_kw: dict):
    """The storm's ``RetryPolicy``: its first deadline is twice the transfer of
    the workload's largest RPC, the pre-population batch (every file, n/k
    coded, over the client's link). ``RetryPolicy()``'s 10 ms deadline is
    shorter than one batch of 4 MiB files at the Emulab bandwidth: that batch
    then fails typed, which ``WorkloadGen.run`` does not check, and the files
    read back empty (``tests/test_torch_workload.py``, ROADMAP C)."""
    from repro_torch.configs.paper_store import EMULAB
    from repro_torch.core import RetryPolicy

    n, k = EMULAB.n_servers, EMULAB.n_servers - EMULAB.parity_m
    transfer = spec_kw["files"] * spec_kw["file_size"] * n / k / EMULAB.bandwidth
    return RetryPolicy(rpc_timeout=2 * transfer)


def run_workload(spec_kw: dict, *, device: str, seed: int, storm: bool = False,
                 sanitize: bool = False):
    """``WorkloadGen(spec, seed).run`` on the Emulab deployment, every session
    attached through one ``dss.gateway()``; a tolerable crash storm under
    ``storm_retry`` with ``storm``, the sanitizer and race tracker with
    ``sanitize``. Returns the store, the report and the network's counters."""
    from repro_torch.configs.paper_store import EMULAB, make_dss
    from repro_torch.core import CrashStorm, WorkloadGen, WorkloadSpec

    dss = make_dss(EMULAB, seed=seed, indexed=True, coding_backend="kernel", device=device,
                   min_block=MIN_BLOCK, avg_block=AVG_BLOCK, max_block=MAX_BLOCK,
                   retry=storm_retry(spec_kw) if storm else None, sanitize=sanitize,
                   racecheck=sanitize)
    spec = WorkloadSpec(**spec_kw, storms=(CrashStorm(**STORM),) if storm else ())
    gw = dss.gateway()
    report = WorkloadGen(spec, seed=seed).run(dss, via=gw)
    gw.stop()
    dss.net.run()
    n = dss.net
    return dss, report, (n.now, n.events_processed, n.rpc_rounds, n.msg_count, n.bytes_sent,
                         n.client_counters)


def counted_phase(tag: str, fn, out_dir: Path, card: str, totals: dict):
    """``fn()`` under ``torch.profiler``, with the storage kernels' counts set
    to 0 just before it and read just after: fails if either kernel was not
    launched, adds the counts to ``totals``, and prints the wall time and the
    device's busy share (trace in ``out_dir``). Returns ``(fn(), wall)``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf

    torch.cuda.synchronize()
    cdc.launches = 0
    gf.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {"cdc_gearhash": cdc.launches, "gf256_matmul": gf.launches}
    for name, c in counts.items():
        if not c:
            raise AssertionError(f"{tag}: the path never launched {name}")
        totals[name] = totals.get(name, 0) + c
    log(f"{tag}: {wall:.3f} s wall under the profiler, launches cdc_gearhash {counts['cdc_gearhash']} "
        f"gf256_matmul {counts['gf256_matmul']} ({card})")
    device_busy(prof, out_dir / f"{tag.replace(' ', '_')}_trace.json", wall, f"profile {tag}:")
    return out, wall


class decode_launches:
    """Counts the ``gf256_matmul`` launches made inside ``RSCode._decode_flats``
    (the decodes of reads, repair and recon) while the block runs."""

    def __enter__(self):
        from repro_torch.erasure.rs import RSCode
        from repro_torch.kernels.gf256_matmul import ops as gf

        self.count, self._orig, self._cls = 0, RSCode._decode_flats, RSCode
        orig = self._orig

        def counted(code, jobs):
            before = gf.launches
            try:
                return orig(code, jobs)
            finally:
                self.count += gf.launches - before

        RSCode._decode_flats = counted
        return self

    def __exit__(self, *exc):
        self._cls._decode_flats = self._orig


def _ycsb_report_line(tag: str, rep: dict, wall: float, card: str) -> None:
    ops = rep["ops"]
    log(f"{tag}: {ops} ops ({rep['ops_done']} done, {rep['ops_failed']} failed, "
        f"{rep['ops_stuck']} stuck), {ops / wall:.2f} ops/s of host wall, availability "
        f"{rep['availability']}, virtual makespan {rep['virtual_makespan']:.6f} s, "
        f"read p50/p99 {rep.get('read_p50', 0.0):.6f}/{rep.get('read_p99', 0.0):.6f} s virtual, "
        f"{rep['rpc_rounds']} rounds, {rep['bytes_sent']} wire bytes, retries {rep['retries']}"
        + (f", availability after recovery {rep['availability_after_recovery']} of "
           f"{rep['ops_after_recovery']} ops" if "availability_after_recovery" in rep else "")
        + f" ({card})")


def drive_ycsb(seed: int, out_dir: Path, card: str, totals: dict) -> None:
    """Phase (a): YCSB-B through the gateway on the Emulab deployment, clean
    and then under a tolerable crash storm with retries (also under
    ``cProfile``: ``ycsb_host_profile.txt``)."""
    import cProfile
    import io
    import pstats

    from repro_torch.core import WorkloadGen, WorkloadSpec, gather

    (_, rep, _), wall = counted_phase("ycsb clean", lambda: run_workload(
        YCSB_B, device="cuda", seed=seed), out_dir, card, totals)
    _ycsb_report_line("ycsb clean", rep, wall, card)
    if rep["ops_stuck"] or rep["stuck_rpcs"] or rep["availability"] != 1.0:
        raise AssertionError(f"ycsb clean: stuck or failed ops: {rep}")

    gen = WorkloadGen(WorkloadSpec(**YCSB_B), seed=seed)
    payloads = set(gen.payloads(gen.plan()["payloads_seed"]))
    host = cProfile.Profile()
    walls = {}
    with decode_launches() as dec:
        def storm_run():
            host.enable()
            try:
                dss, rep, _ = run_workload(YCSB_B, device="cuda", seed=seed, storm=True)
            finally:
                host.disable()
            # Under one gateway the storm's reads rarely decode: the gateway's
            # client keeps the newest (tag, value) of every file it has read
            # or written (EC-DAPopt), so only its first read of a file fetches
            # fragments. A fresh gateway holds no copy: its riders read every
            # file with data server s0 down, and each of those reads decodes.
            t0 = time.perf_counter()
            dss.crash_servers(["s0"])
            gw = dss.gateway("gw-fresh")
            got = gather(*[gw.session(f"r{i}").read(f"f{i}") for i in range(YCSB_B["files"])])
            gw.stop()
            dss.recover_servers(["s0"])
            dss.net.run()
            torch.cuda.synchronize()
            walls["degraded"] = time.perf_counter() - t0
            return dss, rep, got

        (dss, rep, got), wall = counted_phase("ycsb storm", storm_run, out_dir, card, totals)
    _ycsb_report_line("ycsb storm (storm run under cProfile)", rep, wall - walls["degraded"], card)
    log(f"ycsb storm: then {len(got)} degraded reads (s0 down) through a fresh gateway in "
        f"{walls['degraded']:.3f} s; {dec.count} gf256_matmul launches were decodes")
    if rep["ops_stuck"] or rep["stuck_rpcs"] or dss.net.stuck_ops():
        raise AssertionError(f"ycsb storm: stuck ops: {rep}")
    if rep["availability_after_recovery"] < 0.99:
        raise AssertionError(f"ycsb storm: availability after recovery "
                             f"{rep['availability_after_recovery']} < 0.99")
    if any(value not in payloads for value in got):
        raise AssertionError("ycsb storm: a degraded read returned bytes no writer wrote")
    if not dec.count:
        raise AssertionError("ycsb storm: the degraded reads launched no gf256_matmul decode")
    text = io.StringIO()
    stats = pstats.Stats(host, stream=text)
    stats.sort_stats("tottime").print_stats(40)
    (out_dir / "ycsb_host_profile.txt").write_text(text.getvalue())
    for (file, line, fn), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"profile ycsb storm: host {row[2]:.3f} s self, {row[3]:.3f} s cumulative, "
            f"{row[1]} calls: {Path(file).name}:{line} {fn}")


def drive_sanitized(seed: int, out_dir: Path, card: str, totals: dict) -> None:
    """Phase (b): the sanitized, race-checked workload. Every register op the
    store recorded must have been linearized, strictly."""
    (dss, rep, _), wall = counted_phase("sanitized", lambda: run_workload(
        SANITIZED, device="cuda", seed=seed, sanitize=True), out_dir, card, totals)
    _ycsb_report_line("sanitized", rep, wall, card)
    san, races = rep["sanitizer"], rep["races"]
    recorded = sum(1 for r in dss.history if r.kind in ("read", "write") and r.tag is not None)
    log(f"sanitized: sanitizer {san}, races {races}; {recorded} register ops recorded")
    if san["linearized_ops"] != recorded or not san["strict_reads"] or rep["ops_done"] != rep["ops"]:
        raise AssertionError(f"sanitized: {san['linearized_ops']} ops linearized of {recorded} "
                             f"recorded (strict {san['strict_reads']}), {rep['ops_done']} of "
                             f"{rep['ops']} ops done")
    if not races["checks"] or dss.net.stuck_ops():
        raise AssertionError(f"sanitized: race tracker idle or stuck ops: {races}")


def ycsb_card_vs_cpu(seed: int) -> None:
    """(a)'s spec at a small size gives the same report and trace on the card
    as with the plain versions on the CPU."""
    seen = {dev: run_workload(SMALL_YCSB, device=dev, seed=seed)[1:] for dev in ("cuda", "cpu")}
    if seen["cuda"] != seen["cpu"]:
        raise AssertionError(f"small YCSB run differs between the card and the CPU: "
                             f"{seen['cuda']!r} != {seen['cpu']!r}")
    log(f"ycsb: {SMALL_YCSB['sessions']} sessions over {SMALL_YCSB['files']} files of "
        f"{SMALL_YCSB['file_size']} bytes give the same report and trace on the card as on "
        f"the CPU (virtual makespan {seen['cpu'][0]['virtual_makespan']})")


def _same_state(got, want, tag: str) -> None:
    from repro_torch.tree import named_leaves

    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    if got.keys() != want.keys():
        raise AssertionError(f"{tag}: restored leaves differ from the saved ones")
    for name, value in want.items():
        back = got[name]
        if not isinstance(value, torch.Tensor):  # a Python int of a data state
            same = int(back) == value
        else:
            same = (back.device == value.device and back.dtype == value.dtype
                    and torch.equal(back, value))
        if not same:
            raise AssertionError(f"{tag}: {name} is not restored bit for bit on the card")


PLAIN_SPAN = 1 << 27  # positions a plain version takes at once in the checks below


def _spans(n: int) -> list[tuple[int, int]]:
    return [(s, min(s + PLAIN_SPAN, n)) for s in range(0, n, PLAIN_SPAN)]


def _bitmap_ref(data: torch.Tensor, mask: int, s: int, e: int) -> torch.Tensor:
    """The plain gear-hash bitmap of ``data[s:e]``, from the window's 31
    bytes before it."""
    from repro_torch.kernels.cdc_gearhash.ref import gearhash_ref

    lo = max(0, s - 31)
    return gearhash_ref(data[lo:e], mask=mask)[1][s - lo:]


def check_storage_kernels_at(label: str, data: torch.Tensor, n_servers: tuple[int, ...],
                             card: str, worst: dict, k: int = 6,
                             blocks: tuple[int, int, int] = (MIN_BLOCK, AVG_BLOCK, MAX_BLOCK)
                             ) -> int:
    """The storage kernels at one of this slice's shapes, against their plain
    versions (tolerance 0), and timed beside them: the gear hash's
    bitmap-only form over ``data`` (what the chunker launches, at the
    ``blocks`` sizes min/avg/max), then the encode for each of ``n_servers``
    (k data fragments) and the decode without s0 of the first, all at the
    width of the file's one batch, the sum over its blocks of ceil(block /
    k). The plain versions run, and are compared and timed, in slices of
    ``PLAIN_SPAN`` positions: the memory of one slice, the bytes of the
    whole. Returns the blocks the chunker cuts ``data`` into."""
    from repro_torch.erasure.rs import _decoder_cached, _parity_cached
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref

    min_block, avg_block, max_block = blocks
    mask = cdc._mask_for_avg(avg_block)
    L = int(data.numel())
    got = cdc.gearhash_bitmap(data, mask=mask)
    torch.cuda.synchronize()
    err = max(_u8_err(got[s:e], _bitmap_ref(data, mask, s, e)) for s, e in _spans(L))
    worst["cdc_gearhash"] = max(worst["cdc_gearhash"], err)
    if err:
        raise AssertionError(f"gearhash bitmap at {label} differs from the plain version")
    cand = torch.nonzero(got).flatten().cpu().numpy()
    del got
    n_blocks, start, n = 0, 0, 0
    ci = 0
    while start < L:  # the chunker's min/max pass over the candidates
        lo, hi = start + min_block, start + max_block
        while ci < len(cand) and cand[ci] < lo:
            ci += 1
        if ci < len(cand) and cand[ci] < hi and cand[ci] + 1 < L:
            end = int(cand[ci]) + 1
            ci += 1
        else:
            end = min(hi, L)
        n += (end - start + k - 1) // k
        n_blocks += 1
        start = end

    def plain_bitmap():
        for s, e in _spans(L):
            _bitmap_ref(data, mask, s, e)

    ms = cuda_ms(lambda: cdc.gearhash_bitmap(data, mask=mask), 10)
    plain_ms = cuda_ms(plain_bitmap, 1)
    log(f"kernels: at {label}: gearhash bitmap only L={L} ({n_blocks} blocks): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {2 * L / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes); byte-identical "
        f"to the plain version ({card})")
    B = torch.empty((k, n), dtype=torch.uint8, device=data.device)
    B.view(-1)[:L] = data
    B.view(-1)[L:] = 0
    mats = [(f"encode n={m}", _parity_cached(m, k)) for m in n_servers]
    mats.append((f"decode n={n_servers[0]} without s0",
                 _decoder_cached(n_servers[0], k, tuple(range(1, k + 1)))))
    for name, A in mats:
        C = gf.gf256_matmul(A, B)
        torch.cuda.synchronize()
        At = torch.from_numpy(np.array(A))
        err = max(_u8_err(C[:, s:e], gf256_matmul_ref(At, B[:, s:e])) for s, e in _spans(n))
        worst["gf256_matmul"] = max(worst["gf256_matmul"], err)
        if err:
            raise AssertionError(f"gf256_matmul {name} at {label} differs from the plain version")
        del C

        def plain_product():
            for s, e in _spans(n):
                gf256_matmul_ref(At, B[:, s:e])

        ms = cuda_ms(lambda: gf.gf256_matmul(A, B), 10)
        plain_ms = cuda_ms(plain_product, 1)
        bound = (A.shape[0] + k) * n / HBM_BYTES_PER_S * 1e3
        log(f"kernels: at {label}: gf256_matmul {name} {A.shape} x ({k}, {n}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes), {100 * bound / ms:.2f} % of its "
            f"bound; byte-identical to the plain version ({card})")
    del B
    torch.cuda.empty_cache()
    return n_blocks


def drive_checkpoint(seed: int, out_dir: Path, card: str, totals: dict, worst: dict) -> None:
    """Phase (c): qwen2-0.5b's state dict (random weights from the seed, on the
    card) through ``ECCheckpointStore`` on the card: save, restore, an
    incremental save after one layer changes, crashes within the fault
    budget, and a recon to 11 fresh hosts with 5 parity (then every old host
    down), restoring bit for bit after each."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import ECCheckpointStore, serialize_tree

    cfg = get_arch(MODEL)
    t0 = time.perf_counter()
    model = build_model(cfg, max_pos=PREFILL_S, device="cuda")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(seed)))
    torch.cuda.synchronize()
    blob = serialize_tree({"state": params, "step": 1})
    log(f"checkpoint: {cfg.name} {model.n_params()} parameters ({cfg.n_layers} layers, full "
        f"width), serialized {len(blob)} bytes, made in {time.perf_counter() - t0:.3f} s")
    from repro_torch.device import host_tensor

    data = host_tensor(blob).to("cuda")
    del blob
    check_storage_kernels_at(f"the checkpoint ({data.numel()} bytes)", data, (8, 11), card,
                             worst)
    del data
    torch.cuda.empty_cache()

    steps: dict[str, float] = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        return out

    def sequence():
        store = ECCheckpointStore(n_hosts=8, parity=2, seed=seed, device="cuda",
                                  coding_backend="kernel", min_block=MIN_BLOCK,
                                  avg_block=AVG_BLOCK, max_block=MAX_BLOCK)
        st1 = timed("save step 1", lambda: store.save(1, params))
        step, got = timed("restore", store.restore)
        _same_state(got, params, "restore after step 1")
        del got
        with torch.no_grad():
            params["layers"]["wq"][cfg.n_layers // 2].mul_(-1.0)  # one layer's q projection
        st2 = timed("save step 2 (one layer changed)", lambda: store.save(2, params))
        if not (st1.success and st2.success) or st2.blocks_written * 10 > st2.blocks_total:
            raise AssertionError(f"checkpoint saves: {st1}, {st2}")
        budget = store.fault_budget()
        store.crash_hosts([f"s{i}" for i in range(budget)])
        step2, got = timed(f"restore with {budget} hosts down", store.restore)
        _same_state(got, params, "restore after crashes")
        del got
        moved = timed("recon to 11 fresh hosts, parity 5",
                      lambda: store.reconfigure(n_hosts=11, parity=5, fresh=True))
        store.dss.net.run()
        store.crash_hosts([f"s{i}" for i in range(8)])  # every old host: the data moved
        step3, got = timed("restore after recon, old hosts down", store.restore)
        _same_state(got, params, "restore after recon")
        del got
        if (step, step2, step3) != (1, 2, 2) or store.dss.net.stuck_ops():
            raise AssertionError(f"checkpoint: restored steps {(step, step2, step3)}, stuck "
                                 f"{store.dss.net.stuck_ops()}")
        return st1, st2, budget, moved

    (st1, st2, budget, moved), wall = counted_phase("checkpoint", sequence, out_dir, card, totals)
    gb = st1.bytes_written / 1e9
    for name, sec in steps.items():
        log(f"checkpoint: {name}: {sec:.3f} s wall under the profiler, {gb / sec:.4f} GB/s "
            f"of the {st1.bytes_written}-byte checkpoint ({card})")
    log(f"checkpoint: step 1 wrote {st1.blocks_written}/{st1.blocks_total} blocks; step 2 "
        f"rewrote {st2.blocks_written}/{st2.blocks_total} blocks "
        f"({100 * st2.blocks_written / st2.blocks_total:.3f} %); {budget} host(s) crashed; "
        f"recon moved {moved} blocks, then the 8 old hosts went down; every restore bit for bit "
        f"on the card")
    del model, params
    torch.cuda.empty_cache()


def check_ycsb_shapes(seed: int, card: str, worst: dict) -> None:
    """The storage kernels at (a)'s shapes: one 4 MiB file of the workload."""
    from repro_torch.core import WorkloadGen, WorkloadSpec

    gen = WorkloadGen(WorkloadSpec(**YCSB_B), seed=seed)
    payload = gen.payloads(gen.plan()["payloads_seed"])[0]
    data = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy()).to("cuda")
    check_storage_kernels_at(f"one YCSB file ({data.numel()} bytes)", data, (11,), card, worst)


# ---------------------------------------------------------------- phase 5
MODEL = "qwen2_0_5b"
SERVE_ARGS = ["--arch", MODEL, "--full", "--batch", "4", "--cache-len", "2048", "--tokens", "32"]
PREFILL_RUNS = 3
# card vs CPU: qwen2-0.5b at full width, 2 layers, B=2 x 256 tokens. The
# two devices round the bf16 matmuls after sums in another order; through
# 2 layers that moves logits (|logit| < ~0.5 here) by a few bf16 ulps.
SMALL_LAYERS, SMALL_B, SMALL_S = 2, 2, 256
SMALL_ATOL = 16 * 2.0**-10   # 8 bf16 ulps at |logit| in [0.25, 0.5)
SMALL_ARGMAX_SHARE = 0.9     # greedy tokens agreeing over all B x S positions


def drive_model(seed: int, card: str, out_dir: Path) -> int:
    """qwen2-0.5b at full width and depth: PREFILL_RUNS timed prefills of
    PREFILL_B x PREFILL_S tokens (after one warm-up, which is not counted),
    then the serve CLI's greedy decode, then a profile of both. Returns the
    flash_attention launches of the timed prefills and the decode."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model

    cfg = get_arch(MODEL)
    t0 = time.perf_counter()
    model = build_model(cfg, max_pos=PREFILL_S, device="cuda")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(seed)))
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {model.n_params()} parameters, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"random weights (seed {seed}) made in {time.perf_counter() - t0:.3f} s")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S), dtype=np.int32)).to("cuda")
    prefill_launches = timed_prefills(model, params, {"tokens": tokens}, "model", card)

    torch.cuda.reset_peak_memory_stats()
    out = serve.main(SERVE_ARGS + ["--seed", str(seed)])
    launches = fa.launches
    if not out["finite"] or out["tokens"].shape != (4, 32):
        raise AssertionError(f"serve: logits finite {out['finite']}, tokens {out['tokens'].shape}")
    decode_tps = out["tokens"].size / out["seconds"]
    log(f"model: serve {' '.join(SERVE_ARGS)}: {out['seconds']:.4f} s after a "
        f"{out['warmup_seconds']:.4f} s warm-up step, {decode_tps:.1f} tokens/s, "
        f"{1e3 * out['seconds'] / 32:.3f} ms per step, peak device memory "
        f"{out['peak_bytes']} bytes, flash_attention launches "
        f"+{launches - prefill_launches} (decode attends with the plain gqa_attention) ({card})")
    profile_model(model, params, {"tokens": tokens}, out_dir)
    del model, params, out
    torch.cuda.empty_cache()
    return launches


def timed_prefills(model, params, batch: dict, tag: str, card: str) -> int:
    """PREFILL_RUNS timed prefills of ``batch`` (``tokens``; the VLM's
    ``embeds`` and ``positions``; whisper's ``audio_embeds`` and ``tokens``)
    through ``make_prefill_step`` after one warm-up (cuBLAS handles, the
    kernel library's load), with flash_attention counted from 0: fails
    unless it launched once per attention layer a prefill
    (``attention_layers``) and the logits are finite (B, V). Prints the
    median wall, tokens/s and peak device memory; returns the launches."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train.steps import make_prefill_step

    cfg = model.cfg
    B, S = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2]
    step = make_prefill_step(model)
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    walls = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = fa.launches
    per = attention_layers(cfg)
    if launches != PREFILL_RUNS * per:
        raise AssertionError(f"{PREFILL_RUNS} prefills launched flash_attention "
                             f"{launches} times, not {PREFILL_RUNS} x {per}")
    if logits.shape != (B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not finite (B, V)")
    wall = sorted(walls)[len(walls) // 2]
    Sa = batch["audio_embeds"].shape[1] if "audio_embeds" in batch else 0
    frames = f" (and {B} x {Sa} audio frames)" if Sa else ""
    per_frame = f" and {B * Sa / wall:.1f} audio frames/s" if Sa else ""
    log(f"{tag}: prefill {B} x {S} tokens{frames}: {wall:.4f} s wall (median of "
        f"{', '.join(f'{w:.4f}' for w in walls)}), {B * S / wall:.1f} tokens/s{per_frame}, "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes, flash_attention "
        f"launches {launches} ({per} per prefill) ({card})")
    return launches


def attention_layers(cfg) -> int:
    """The attention layers of one forward, each one flash_attention launch
    in a prefill: every layer of the attention families, none of mamba2,
    one shared block per group of zamba2, each encoder layer and twice each
    decoder layer (self and cross) of whisper."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def profile_model(model, params, batch: dict, out_dir: Path, name: str = "model",
                  cache: dict | None = None) -> None:
    """One prefill of ``batch`` and 8 decode steps (from a zero cache of the
    serve phase's length, or a copy of ``cache``; fed the first token, or
    the VLM's first embedding) under ``torch.profiler``: the device's busy
    share and the costliest kernels of each; traces in ``out_dir``. For the
    MoE, SSM, hybrid, encoder-decoder and VLM families, their layers' parts
    run inside ``record_function`` ranges (``moe_ranges``, ``ssm_ranges``,
    ``attn_ranges``) and the device time is split by them; the decode's
    device operations are also counted per step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import decode_loop
    from repro_torch.train.steps import make_prefill_step

    step = make_prefill_step(model)
    if "embeds" in batch:
        first = {"embed": batch["embeds"][:, 0].contiguous()}
    else:
        first = {"token": batch["tokens"][:, 0].contiguous()}
    B = next(iter(first.values())).shape[0]
    steps = 8

    def fresh_cache() -> dict:
        if cache is None:
            return model.init_cache(B, PREFILL_S)
        return {k: v.clone() for k, v in cache.items()}

    runs = (("prefill", lambda: step(params, batch)),
            (f"decode x{steps}", lambda: decode_loop(model, params, fresh_cache(), dict(first),
                                                     steps)))
    family = model.cfg.family
    split = None if family == "dense" else _family_split(family)
    what = {"moe": "MoE", "ssm": "SSM", "hybrid": "SSM"}.get(family, "layer")
    for label, fn in runs:
        fn()  # warm-up outside the profiler
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                (split[0]() if split else contextlib.nullcontext()):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tag = f"profile {label}:" if name == "model" else f"profile {name} {label}:"
        events = device_busy(prof, out_dir / f"{name}_{label.split()[0]}_trace.json", wall, tag)
        if label.startswith("decode"):
            n_ops = sum(ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for ev in events)
            log(f"{tag} {n_ops / steps:.1f} device operations a decode step")
        if split:
            split_device_time(events, tag, what, split[1])


# ---------------------------------------------------------------- phase 5b
# olmoe-1b-7b, the MoE family, at full width and depth
MOE_MODEL = "olmoe_1b_7b"
MOE_SERVE_ARGS = ["--arch", MOE_MODEL, "--full", "--batch", "4", "--cache-len", "2048",
                  "--tokens", "32"]
# card vs CPU of the MoE family (full width, SMALL_LAYERS layers, SMALL_B x
# SMALL_S tokens): routes to tests/_torch_moe_criteria.py's criteria, logits
# within the dense check's 8 bf16 ulps, taken at the CPU logits' largest
# magnitude (the MoE heads give |logit| up to ~5, the dense check's ~0.5)
MOE_CHECK_ARCHS = ("olmoe_1b_7b", "qwen3_moe_30b_a3b")
MOE_LOGIT_ULPS = 8
# moe_layer alone, card vs CPU on the same bf16 inputs: y where the routes
# agree. cuBLAS sums the expert products in another order than the CPU, so
# g, u and the expert outputs round to another bf16 at some elements, and a
# token's 8-term bf16 sum carries that at the scale of its largest term: y
# within MOE_Y_ULPS bf16 ulps of the token's largest |y| (measured on the
# CPU, bf16 against f32-accumulated expert products at olmoe's widths:
# 0.27 % of elements differ, by at most 2.5 such ulps)
MOE_Y_ULPS = 4


def ranges(targets) -> contextlib.ExitStack:
    """While active, each ``(owner, attribute, range)`` of ``targets`` (a
    function of a module, or a method of a class) runs inside a
    ``record_function`` range of that name, which ``split_device_time``
    reads from the trace."""
    from torch.profiler import record_function

    stack = contextlib.ExitStack()
    for owner, attr, name in targets:
        orig = getattr(owner, attr)

        def call(*a, _orig=orig, _name=name, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        setattr(owner, attr, call)
        stack.callback(setattr, owner, attr, orig)
    return stack


def moe_ranges():
    """The MoE layer's parts: ``moe`` (the whole ``_moe_tokens``), and inside
    it ``moe.route`` (``_route``) and ``moe.combine`` (``_combine``)."""
    from repro_torch.models import layers

    return ranges([(layers, "_moe_tokens", "moe"), (layers, "_route", "moe.route"),
                   (layers, "_combine", "moe.combine")])


def ssm_ranges():
    """The Mamba2 mixer's parts: ``mixer`` (the whole mixer, or its decode
    step), and inside it ``mixer.conv`` (the causal conv), ``mixer.intra``
    (the SSD's intra-chunk term) and ``mixer.state`` (the chunk states:
    their own contributions, the loop over chunks, C against the state);
    the hybrid's shared block, ``shared``, and its MLP, ``shared.mlp``."""
    from repro_torch.models import lm, ssd

    return ranges([(ssd, "mamba2_mixer", "mixer"), (ssd, "mamba2_decode_step", "mixer"),
                   (ssd, "_causal_conv", "mixer.conv"), (ssd, "_intra_chunk", "mixer.intra"),
                   (ssd, "_inter_chunk", "mixer.state"), (lm.LM, "_dense_block", "shared"),
                   (lm.LM, "_decode_block", "shared"), (lm, "swiglu_mlp", "shared.mlp")])


def attn_ranges():
    """The encoder-decoder's and the VLM's parts: ``encoder`` and ``decoder``
    (whisper's layers, whole), and inside a layer ``attention`` (each
    attention: projections, RoPE, the kernel or the score chain, the output
    projection), ``mlp`` (the GELU or SwiGLU MLP) and ``norm`` (the layer or
    RMS norms)."""
    from repro_torch.models import lm

    return ranges([(lm.LM, "_enc_layer", "encoder"), (lm.LM, "_dec_layer", "decoder"),
                   (lm.LM, "_attn", "attention"), (lm.LM, "_decode_attn", "attention"),
                   (lm, "gelu_mlp", "mlp"),
                   (lm, "swiglu_mlp", "mlp"), (lm, "layer_norm", "norm"),
                   (lm, "rms_norm", "norm")])


def open_ranges(events: list) -> dict:
    """Each launch's open ``record_function`` ranges (innermost first), by
    the launch's correlation id: the ranges and launches of each thread are
    swept in time order with a stack of the ranges still open."""
    by_tid: dict = {}
    for ev in events:
        cat, tid = ev.get("cat"), ev.get("tid")
        if cat == "user_annotation":
            # ties: a range opens before a launch at its start, an outer one before an inner one
            by_tid.setdefault(tid, []).append((ev["ts"], 0, -ev.get("dur", 0.0), ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                by_tid.setdefault(tid, []).append((ev["ts"], 1, 0.0, corr))
    out: dict = {}
    for items in by_tid.values():
        items.sort(key=lambda it: it[:3])
        stack: list = []  # (end, name) of the open ranges, outermost first
        for ts, is_launch, neg_dur, what in items:
            while stack and stack[-1][0] < ts:
                stack.pop()
            if is_launch:
                out[what] = tuple(name for _, name in reversed(stack))
            else:
                stack.append((ts - neg_dur, what))
    return out


def split_device_time(events: list, tag: str, what: str, part_of) -> None:
    """The device time of a profile split by part: ``part_of(kind, ranges)``
    names the part of each kernel, copy and fill from its kind and the
    ranges that were open on the thread that launched it (innermost first;
    found by the launch's correlation id). Prints each part's seconds and
    share of the busy time."""
    launched_in = open_ranges(events)
    parts: dict[str, float] = {}
    for ev in events:
        cat = ev.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        kind = _kind(ev["name"]) if cat == "kernel" else cat
        part = part_of(kind, launched_in.get(ev.get("args", {}).get("correlation"), ()))
        parts[part] = parts.get(part, 0.0) + ev.get("dur", 0.0) * 1e-6
    total = sum(parts.values())
    if not any(launched_in.values()):
        log(f"{tag} {what} split: no kernel was launched inside a range")
    for part, sec in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"{tag} {what} split {sec:.6f} s ({100 * sec / total:.2f} % of busy): {part}")


def moe_part(kind: str, ranges: tuple) -> str:
    where = ranges[0] if ranges else None
    if kind == "flash_attention":
        return "flash_attention"
    if where == "moe.route":
        return "MoE routing (router GEMM, softmax, top-k sort, argsort, searchsorted)"
    if where == "moe.combine":
        return "MoE combine (sort by token, gather, ordered bf16 adds)"
    if where == "moe" and kind == "cuBLAS GEMM":
        return "MoE expert GEMMs"
    if where == "moe":
        return "MoE dispatch (buffer scatter, output gather, gate scale) and silu"
    return f"outside the MoE layer: {kind}"


def attn_part(kind: str, ranges: tuple) -> str:
    where = ranges[0] if ranges else None
    stack = next((r for r in ranges if r in ("encoder", "decoder")), None)
    at = f"{stack}'s " if stack else ""
    if kind == "flash_attention":
        return f"{at}flash_attention"
    if where == "attention":
        return f"{at}attention outside flash_attention: {kind}"
    if where == "mlp":
        return f"{at}MLP: {kind}"
    if where == "norm":
        return f"{at}norms: {kind}"
    return f"{at}outside attention, MLP and norms: {kind}"


def ssm_part(kind: str, ranges: tuple) -> str:
    where = ranges[0] if ranges else None
    if kind == "flash_attention":
        return "flash_attention (the shared block)"
    if where == "mixer.intra":
        return "SSD intra-chunk term (C.B scores, masked segment sums, exp, M.(dt x); f32)"
    if where == "mixer.state":
        return "SSD chunk states (each chunk's B.(dt decay x), the loop over chunks, C.state; f32)"
    if where == "mixer.conv":
        return "causal conv (4 shifted f32 products and adds)"
    if where == "mixer" and kind == "cuBLAS GEMM":
        return "Mamba2 GEMMs (projections in and out; decode: C.state)"
    if where == "mixer":
        return "Mamba2 elementwise (concat, silu, softplus, skip, gate, norm, casts; decode: " \
               "the recurrence)"
    if where == "shared.mlp":
        return f"shared block's SwiGLU MLP: {kind}"
    if where == "shared":
        return f"shared block's attention outside flash_attention: {kind}"
    return f"outside the mixers and the shared block: {kind}"


def drive_moe(seed: int, card: str, out_dir: Path) -> int:
    """olmoe-1b-7b at full width and depth: the serve CLI (greedy decode
    of ``MOE_SERVE_ARGS``), then, with its model and weights,
    PREFILL_RUNS timed prefills of PREFILL_B x PREFILL_S tokens after a
    warm-up (flash_attention counted from 0: one launch per layer), the
    share of assignments dropped at capacity in the first and last layer of
    one prefill (the port's own routes, recorded), and a profile of both.
    Returns the flash_attention launches of the prefills and the decode."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.train.steps import make_prefill_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    out = serve.main(MOE_SERVE_ARGS + ["--seed", str(seed)])
    serve_wall = time.perf_counter() - t0
    decode_launches = fa.launches
    model, params = out.pop("model"), out.pop("params")
    cfg = model.cfg
    if not out["finite"] or out["tokens"].shape != (4, 32):
        raise AssertionError(f"serve: logits finite {out['finite']}, tokens {out['tokens'].shape}")
    log(f"moe: {cfg.name} {model.n_params()} parameters, {model.n_active_params()} active per "
        f"token, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"hd {cfg.hd}, {cfg.moe_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.moe_d_ff}, "
        f"capacity factor {cfg.capacity_factor}, vocab {cfg.vocab}; random weights (seed {seed})")
    log(f"moe: serve {' '.join(MOE_SERVE_ARGS)}: {out['seconds']:.4f} s after a "
        f"{out['warmup_seconds']:.4f} s warm-up step, {out['tokens'].size / out['seconds']:.1f} "
        f"tokens/s, {1e3 * out['seconds'] / 32:.3f} ms per step, peak device memory "
        f"{out['peak_bytes']} bytes, flash_attention launches {decode_launches}; "
        f"{serve_wall:.3f} s for the whole CLI, the weights' draw on the card included ({card})")

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S), dtype=np.int32)).to("cuda")
    prefill_launches = timed_prefills(model, params, {"tokens": tokens}, "moe", card)
    with mc.RouteLog() as routes:
        make_prefill_step(model)(params, {"tokens": tokens})
    if len(routes.calls) != cfg.n_layers:
        raise AssertionError(f"one prefill routed {len(routes.calls)} layers of {cfg.n_layers}")
    T = PREFILL_B * PREFILL_S
    from repro_torch.models.layers import _capacity

    C = _capacity(T, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    for i in (0, cfg.n_layers - 1):
        r = routes.calls[i]
        n, kept = int(r["routed"].sum()), int(r["kept"].sum())
        load = r["routed"].sum(0)
        log(f"moe: prefill layer {i}: {n - kept} of {n} (token, expert) assignments dropped at "
            f"capacity C={C} ({100 * (n - kept) / n:.3f} %); tokens per expert min {load.min()} "
            f"max {load.max()} (mean {n / cfg.moe_experts:.1f}); {int((load > C).sum())} experts "
            f"over capacity")
    profile_model(model, params, {"tokens": tokens}, out_dir, name="olmoe")
    del model, params, out
    torch.cuda.empty_cache()
    return prefill_launches + decode_launches


def card_vs_cpu(seed: int, arch: str = MODEL) -> None:
    """The prefill (last-position logits, every position's greedy token)
    and one decode step (from one random cache) of ``arch`` at full width
    and SMALL_LAYERS layers, SMALL_B x SMALL_S tokens, on the card and on
    the CPU from the same weights (one draw of one seeded CPU generator).
    Logits agree within SMALL_ATOL and greedy tokens at SMALL_ARGMAX_SHARE
    of all positions. For the MoE family each layer's routes are recorded
    and held to the criteria of ``tests/_torch_moe_criteria.py``
    (ROUTE_DELTA); the logits are held, within MOE_LOGIT_ULPS bf16 ulps of
    the largest |logit|, at the sequences whose routes agreed in every
    layer. Every flip is counted and printed."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_arch(arch), n_layers=SMALL_LAYERS)
    moe = cfg.family == "moe"
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (SMALL_B, SMALL_S), dtype=np.int32))
    cache_shape = (SMALL_LAYERS, SMALL_B, SMALL_S, cfg.n_kv_heads, cfg.hd)
    cache_np = {name: rng.standard_normal(cache_shape, dtype=np.float32) for name in ("k", "v")}
    cur = SMALL_S // 2
    weights = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))
    seen = {}
    for where in ("cuda", "cpu"):
        model = build_model(cfg, device=where)
        dev = model.device
        params = model.load_params(weights)
        with mc.RouteLog() as pre:
            last = make_prefill_step(model)(params, {"tokens": tokens.to(dev)})
        positions = torch.arange(SMALL_S, device=dev)[None].expand(SMALL_B, SMALL_S)
        with torch.no_grad():
            h, _ = model._run_decoder_stack(params, params["embed"][tokens.to(dev)].bfloat16(),
                                            positions=positions)
            greedy = model._head(params, h).argmax(dim=-1)  # every position's greedy token
        cache = {name: torch.from_numpy(a).to(dev, torch.bfloat16) for name, a in cache_np.items()}
        with mc.RouteLog() as dec:
            step_logits, _ = make_serve_step(model)(params, cache, {"token": tokens[:, cur].to(dev),
                                                                    "cur_len": cur})
        seen[where] = (last.cpu(), greedy.cpu(), step_logits.cpu(), pre.calls, dec.calls)
        del model, params, h, cache
    del weights
    card, cpu = seen["cuda"], seen["cpu"]
    tag = "card vs CPU" if not moe else f"moe card vs CPU: {cfg.name} full width, {SMALL_LAYERS} layers"
    for label, i, li in (("prefill last-position logits", 0, 3), ("decode-step logits", 2, 4)):
        a, b = card[i], cpu[i]
        rows, tol, note = list(range(SMALL_B)), SMALL_ATOL, ""
        if moe:
            res = mc.compare_routes(card[li], cpu[li], cfg.moe_top_k, SMALL_B)
            for n, lay in enumerate(res["layers"]):
                log(f"{tag}: {label.split()[0]} layer {n} routes ({cpu[li][n]['probs'].shape[0]} "
                    f"tokens, delta {mc.ROUTE_DELTA}): {lay['near_ties']} tokens below delta, "
                    f"{lay['flips_below_delta']} expert sets differ there, "
                    f"{lay['flips_after_upstream_flip']} differ after a flip upstream, "
                    f"{lay['drop_changes']} drop changes, least margin {lay['min_margin']:.3e}")
            rows = res["seqs"]
            tol = MOE_LOGIT_ULPS * float(mc.bf16_ulp(float(b.abs().max())))
            note = (f"; routes agree in every layer at sequences {rows} of {SMALL_B}, where it is "
                    f"held; at every sequence, flips included and not held, "
                    f"{float((a - b).abs().max()):.3e}; largest margin shift {res['max_shift']:.3e}")
        err = float((a[rows] - b[rows]).abs().max()) if rows else float("nan")
        if not torch.isfinite(a).all() or (rows and not err <= tol):
            raise AssertionError(f"{tag} {label}: max |diff| {err} > {tol} at sequences {rows}")
        log(f"{tag}: {label} {tuple(a.shape)}: max |diff| {err:.3e} (tolerance {tol:.3e}, max "
            f"|logit| {float(b.abs().max()):.3e}), greedy tokens agree "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}{note}")
    share = float((card[1] == cpu[1]).float().mean())
    if share < SMALL_ARGMAX_SHARE:
        raise AssertionError(f"{tag}: greedy tokens agree at {share} of positions "
                             f"< {SMALL_ARGMAX_SHARE}")
    log(f"{tag if moe else f'card vs CPU: {cfg.name} full width, {SMALL_LAYERS} layers'}, "
        f"{SMALL_B} x {SMALL_S} tokens: greedy tokens agree at {share:.4f} of all positions "
        f"(required {SMALL_ARGMAX_SHARE})")


def moe_layer_card_vs_cpu(seed: int, card: str) -> None:
    """``moe_layer`` alone at olmoe-1b-7b's widths and one prefill's tokens
    (T = PREFILL_B x PREFILL_S), on identical bf16 inputs on the card and
    on the CPU: the route criteria (one layer, ROUTE_DELTA), and y within
    MOE_Y_ULPS bf16 ulps of each token's largest |y| at the tokens whose
    routes agree, with the share of elements equal bit for bit printed."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import _capacity, dense_init, moe_layer

    cfg = get_arch(MOE_MODEL)
    T, D, E, F, K = (PREFILL_B * PREFILL_S, cfg.d_model, cfg.moe_experts, cfg.moe_d_ff,
                     cfg.moe_top_k)
    g = torch.Generator().manual_seed(seed + 5)
    bf = torch.bfloat16
    x = torch.randn((1, T, D), generator=g).to(bf)
    ws = [dense_init(g, (D, E), bf), dense_init(g, (E, D, F), bf), dense_init(g, (E, D, F), bf),
          dense_init(g, (E, F, D), bf)]
    seen = {}
    for where in ("cuda", "cpu"):
        with mc.RouteLog() as log_:
            y, aux = moe_layer(x.to(where), *(w.to(where) for w in ws), top_k=K,
                               capacity_factor=cfg.capacity_factor)
        seen[where] = (y[0].float().cpu().numpy(), float(aux), log_.calls)
    (yc, auxc, rc), (yh, auxh, rh) = seen["cuda"], seen["cpu"]
    res = mc.compare_routes(rc, rh, K, 1)
    lay = res["layers"][0]
    agree = res["agree"]
    d = np.abs(yc[agree] - yh[agree])
    row_ulp = mc.bf16_ulp(np.abs(yh[agree]).max(-1, keepdims=True))
    worst = float((d / row_ulp).max()) if d.size else 0.0
    own = float((d <= mc.bf16_ulp(yh[agree])).mean()) if d.size else 1.0
    C = _capacity(T, K, E, cfg.capacity_factor)
    log(f"moe_layer card vs CPU: T={T} D={D} E={E} K={K} F={F} C={C}, bf16: {lay['near_ties']} "
        f"tokens below delta {mc.ROUTE_DELTA}, {lay['flips_below_delta']} expert sets differ "
        f"there, {lay['drop_changes']} drop changes, largest margin shift "
        f"{res['max_shift']:.3e}; y at the {int(agree.sum())} tokens whose routes agree: "
        f"{100 * float((d == 0).mean()):.4f} % of elements equal bit for bit, the rest within "
        f"{worst:.3f} bf16 ulps of the token's largest |y| (tolerance {MOE_Y_ULPS}); "
        f"{100 * own:.4f} % within 1 bf16 ulp of their own |y|; aux "
        f"{auxc!r} on the card, {auxh!r} on the CPU ({card})")
    if not np.isfinite(yc).all() or worst > MOE_Y_ULPS:
        raise AssertionError(f"moe_layer card vs CPU: y differs by {worst} ulps > {MOE_Y_ULPS}")


def moe_gather_backward_card_vs_cpu(seed: int, card: str) -> None:
    """The backward of ``_moe_tokens``'s dispatch gather ``xt[r.st]`` on
    identical inputs on the card and on the CPU, at olmoe-1b-7b's widths and
    T = PREFILL_B x PREFILL_S: an accumulating ``index_put_`` that adds each
    token's K row gradients into its row of xt's bf16 gradient. The CPU
    adds them in index order, ascending expert (the reference's
    scatter-add order); held bit for bit."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import _capacity, _route, dense_init

    cfg = get_arch(MOE_MODEL)
    T, D, E, K = PREFILL_B * PREFILL_S, cfg.d_model, cfg.moe_experts, cfg.moe_top_k
    g = torch.Generator().manual_seed(seed + 7)
    bf = torch.bfloat16
    x = torch.randn((T, D), generator=g).to(bf)
    wr = dense_init(g, (D, E), bf)
    st = _route(x.to("cuda"), wr.to("cuda"), top_k=K,
                capacity=_capacity(T, K, E, cfg.capacity_factor)).st.cpu()
    up = torch.randn((T * K, D), generator=g).to(bf)
    grads = {}
    for where in ("cuda", "cpu"):
        xt = x.to(where, copy=True).requires_grad_()
        xt[st.to(where)].backward(up.to(where))
        grads[where] = xt.grad.float().cpu().numpy()
    a, b = grads["cuda"], grads["cpu"]
    ulps = np.abs(a - b) / mc.bf16_ulp(b)
    log(f"moe gather backward card vs CPU: xt (T={T}, D={D}) gradient of xt[st], {K} rows a "
        f"token: {100 * float((a == b).mean()):.4f} % of elements equal bit for bit, at most "
        f"{float(ulps.max()):.3f} bf16 ulps apart ({card})")
    if not np.array_equal(a, b):
        raise AssertionError("moe gather backward: the card's gradient of xt differs from the "
                             "CPU's")


# ---------------------------------------------------------------- phase 5c
# mamba2-2.7b (SSM, no attention) and zamba2-7b (hybrid: one shared attention
# + MLP block after every 6 Mamba2 layers) at full width and depth
SSM_MODELS = ("mamba2_2_7b", "zamba2_7b")
# card vs CPU at full width, SMALL_B x SMALL_S tokens: mamba2 at 2 layers,
# zamba2 at 7 (one group of 6, the shared block, one trailing layer). Logits
# within CHECK_LOGIT_ULPS bf16 ulps of the CPU's largest |logit| (the MoE
# check's 8), greedy tokens at SMALL_ARGMAX_SHARE of all positions; and each
# layer's f32 SSM state after CHECK_DECODE_STEPS decode steps within
# SSM_STATE_ULPS bf16 ulps of that layer's largest |state|: the state sums
# products of bf16 activations (B, x after the conv) that the two devices
# may round one bf16 ulp apart, so it carries their bf16 error, not f32's.
# Each criterion is held where the CPU meets it against itself with every
# SSD output and decode state moved by one f32 ulp (``ssd_jitter``). From
# random weights the shared block's attention is near-argmax (scores of std
# ~100), so past it the bf16 model is ill-conditioned: there the criteria
# are printed, and held on the same model in f32 (``dtype="float32"``).
# zamba2's is run in f32 only, for the script's 1200 s: its bf16 check never
# held (the CPU missed it against its own 1-ulp jitter in every run)
SSM_CHECK_LAYERS = {"mamba2_2_7b": 2, "zamba2_7b": 7}
SSM_CHECK_F32_ONLY = ("zamba2_7b",)
CHECK_LOGIT_ULPS = 8
SSM_STATE_ULPS = 8
CHECK_DECODE_STEPS = 4


def drive_ssm(arch: str, seed: int, card: str, out_dir: Path) -> int:
    """``arch`` at full width and depth: the serve CLI (greedy decode, B=4,
    32 tokens after a warm-up step; its cache's bytes), then with its model
    and weights PREFILL_RUNS timed prefills of PREFILL_B x PREFILL_S tokens
    (flash_attention counted from 0: once per group for zamba2, never for
    mamba2), then a profile split by the mixer's parts. Returns the
    flash_attention launches of the prefills and the decode."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve

    import gc

    args = ["--arch", arch, "--full", "--batch", str(PREFILL_B), "--cache-len", str(PREFILL_S),
            "--tokens", "32", "--seed", str(seed)]
    gc.collect()  # an earlier phase's model caught in a reference cycle would count in the peak
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    out = serve.main(args)
    serve_wall = time.perf_counter() - t0
    decode_launches = fa.launches
    model, params = out.pop("model"), out.pop("params")
    cfg = model.cfg
    if not out["finite"] or out["tokens"].shape != (PREFILL_B, 32):
        raise AssertionError(f"serve: logits finite {out['finite']}, tokens {out['tokens'].shape}")
    cache = {name: math.prod(shape) * dtype.itemsize
             for name, (shape, dtype) in model.cache_template(PREFILL_B, PREFILL_S).items()}
    tag = arch.split("_")[0]
    log(f"{tag}: {cfg.name} {model.n_params()} parameters, {cfg.n_layers} Mamba2 layers, d "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of {cfg.ssm_headdim}, "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}"
        + (f"; a shared block after every {cfg.shared_attn_every} ({attention_layers(cfg)} "
           f"applications), {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}"
           if cfg.family == "hybrid" else "") + f"; random weights (seed {seed})")
    log(f"{tag}: serve {' '.join(args)}: {out['seconds']:.4f} s after a "
        f"{out['warmup_seconds']:.4f} s warm-up step, {out['tokens'].size / out['seconds']:.1f} "
        f"tokens/s, {1e3 * out['seconds'] / 32:.3f} ms per step, peak device memory "
        f"{out['peak_bytes']} bytes ({held} held before the phase), cache "
        f"{sum(cache.values())} bytes "
        f"({', '.join(f'{k} {v}' for k, v in cache.items())}), flash_attention launches "
        f"{decode_launches} (decode attends with the plain gqa_attention); {serve_wall:.3f} s "
        f"for the whole CLI, the weights' draw on the card included ({card})")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S), dtype=np.int32)).to("cuda")
    prefill_launches = timed_prefills(model, params, {"tokens": tokens}, tag, card)
    profile_model(model, params, {"tokens": tokens}, out_dir, name=tag)
    del model, params, out
    torch.cuda.empty_cache()
    return prefill_launches + decode_launches


def ulp_nudger(seed: int):
    """A function moving each element of a tensor by one ulp of its dtype,
    up or down at random (from ``seed``)."""
    g = torch.Generator().manual_seed(seed)

    def nudge(t: torch.Tensor) -> torch.Tensor:
        up = (torch.rand(t.shape, generator=g) < 0.5).to(t.device)
        return torch.nextafter(t, torch.where(up, math.inf, -math.inf).to(t.dtype))

    return nudge


@contextlib.contextmanager
def ssd_jitter(seed: int):
    """While active, every ``_ssd_chunked`` output and every state a
    ``mamba2_decode_step`` returns moves by one f32 ulp, up or down at random
    (seeded): a perturbation below any rounding the card and the CPU could
    disagree on, which shows how far the model carries one."""
    from repro_torch.models import ssd

    nudge = ulp_nudger(seed)
    chunked, step = ssd._ssd_chunked, ssd.mamba2_decode_step
    ssd._ssd_chunked = lambda *a: nudge(chunked(*a))

    def jittered_step(*a):
        y, conv, state = step(*a)
        return y, conv, nudge(state)

    ssd.mamba2_decode_step = jittered_step
    try:
        yield
    finally:
        ssd._ssd_chunked, ssd.mamba2_decode_step = chunked, step


def _ssm_run(cfg, weights, tokens: torch.Tensor, where: str) -> tuple:
    """The prefill's last-position logits (``make_prefill_step``), every
    position's greedy token, the logits of CHECK_DECODE_STEPS decode steps from
    a zero cache fed ``tokens[:, i]``, and the SSM state after them."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    model = build_model(cfg, device=where)
    params = model.load_params(weights)
    t = tokens.to(model.device)
    last = make_prefill_step(model)(params, {"tokens": t})
    with torch.no_grad():
        h, _ = model._forward(params, {"tokens": t})
        greedy = model._head(params, h).argmax(dim=-1)
    cache, steps = model.init_cache(*t.shape), []
    for i in range(CHECK_DECODE_STEPS):
        logits, cache = make_serve_step(model)(params, cache, {"token": t[:, i], "cur_len": i})
        steps.append(logits.cpu())
    return last.cpu(), greedy.cpu(), torch.stack(steps), cache["ssm"].cpu()


def ssm_card_vs_cpu(seed: int, arch: str, dtype: str = "bfloat16") -> bool:
    """``arch`` at full width and SSM_CHECK_LAYERS layers in ``dtype`` on the
    card and on the CPU from the same weights (one draw of one seeded CPU
    generator), and on the CPU once more under ``ssd_jitter``: each
    criterion above is held where the jittered CPU meets it, printed where
    it does not. Returns whether every criterion was held."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_arch(arch), n_layers=SSM_CHECK_LAYERS[arch], dtype=dtype)
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab, (SMALL_B, SMALL_S), dtype=np.int32))
    weights = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))
    card = _ssm_run(cfg, weights, tokens, "cuda")
    cpu = _ssm_run(cfg, weights, tokens, "cpu")
    with ssd_jitter(seed):
        jit = _ssm_run(cfg, weights, tokens, "cpu")
    del weights
    tag = (f"{arch.split('_')[0]} card vs CPU: {cfg.name} full width, {cfg.n_layers} layers, "
           f"{dtype}")
    return held_against_jitter(tag, card, cpu, jit, states=True)


def held_against_jitter(tag: str, card: tuple, cpu: tuple, jit: tuple,
                        states: bool = False) -> bool:
    """The card's run against the CPU's and the jittered CPU's (each
    ``_ssm_run`` or ``_embed_run``: last-position logits, every position's
    greedy token, the decode steps' logits, with ``states`` each layer's SSM
    state): logits within CHECK_LOGIT_ULPS bf16 ulps of the CPU's largest
    |logit|, states within SSM_STATE_ULPS of each layer's largest |state|,
    greedy tokens at SMALL_ARGMAX_SHARE. Each criterion is held (a miss
    fails the run) where the jittered CPU meets it, printed where it does
    not. Returns whether every criterion was held."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_moe_criteria import bf16_ulp

    held = True

    def judge(label: str, err: float, self_err: float, tol: float) -> None:
        nonlocal held
        if self_err <= tol:
            if not err <= tol:
                raise AssertionError(f"{tag}: {label}: max |diff| {err} > {tol}")
            verdict = "held"
        else:
            held, verdict = False, "NOT held: ill-conditioned, the jittered CPU misses it too"
        log(f"{tag}: {label}: max |diff| {err:.3e}, the CPU against its 1-ulp jitter "
            f"{self_err:.3e} (tolerance {tol:.3e}); {verdict}")

    for label, i in (("prefill last-position logits", 0),
                     (f"logits of {CHECK_DECODE_STEPS} decode steps", 2)):
        a, b, c = card[i], cpu[i], jit[i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag}: {label} are not finite")
        tol = CHECK_LOGIT_ULPS * float(bf16_ulp(float(b.abs().max())))
        judge(f"{label} {tuple(a.shape)} (max |logit| {float(b.abs().max()):.3e}, greedy "
              f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a[..., 0].numel()} equal)",
              float((a - b).abs().max()), float((c - b).abs().max()), tol)
    for layer, (a, b, c) in enumerate(zip(card[3], cpu[3], jit[3]) if states else ()):
        big = float(b.abs().max())
        judge(f"layer {layer} SSM state after {CHECK_DECODE_STEPS} steps (max |state| {big:.3e}, "
              f"relative L2 {float((a - b).norm() / b.norm()):.3e})",
              float((a - b).abs().max()), float((c - b).abs().max()),
              SSM_STATE_ULPS * float(bf16_ulp(big)))
    share = float((card[1] == cpu[1]).float().mean())
    self_share = float((jit[1] == cpu[1]).float().mean())
    if self_share >= SMALL_ARGMAX_SHARE and share < SMALL_ARGMAX_SHARE:
        raise AssertionError(f"{tag}: greedy tokens agree at {share} of positions "
                             f"< {SMALL_ARGMAX_SHARE}")
    held = held and self_share >= SMALL_ARGMAX_SHARE
    log(f"{tag}, {SMALL_B} x {SMALL_S} tokens: greedy tokens agree at {share:.4f} of all "
        f"positions, the CPU against its 1-ulp jitter at {self_share:.4f} (required "
        f"{SMALL_ARGMAX_SHARE}; {'held' if self_share >= SMALL_ARGMAX_SHARE else 'NOT held'})")
    return held


# ---------------------------------------------------------------- phase 5d
# whisper-base (encoder-decoder: audio frames in, cross-attention) and
# qwen2-vl-7b (VLM: patch embeddings in, M-RoPE) at full width and depth
EMBED_MODELS = ("whisper_base", "qwen2_vl_7b")
# card vs CPU at full width, SMALL_B x SMALL_S, in f32: 2 layers (2 + 2 for
# whisper). Logits within CHECK_LOGIT_ULPS bf16 ulps of the CPU's largest
# |logit| and greedy tokens at SMALL_ARGMAX_SHARE of all positions, each held
# where the CPU meets it against itself with every attention output moved
# one ulp (``attention_jitter``). Their bf16 checks were printed, never held,
# from random weights (a whole run on an H100: whisper's greedy tokens agreed
# at 0.7324, the CPU with itself jittered at 0.5762; qwen2-vl's at 0.9238 and
# 0.8613), and took ~25 s of the script's 900 s: cut (a reduced: line)
EMBED_CHECK_LAYERS = 2


def _encdec():
    """``tests/_torch_encdec.py``, shared with the tests: whisper's final
    layer norms drawn (``draw_final_norms``; the reference's init rule makes
    every 1-D leaf 0, and whisper's layer norms scale by w, not 1 + w: from
    it the encoder's output and every logit are exactly 0, and the serve
    CLI, which keeps the rule, decodes greedy token 0 throughout) and the
    decode cache's cross-attention K/V from the encoder's output
    (``cross_kv``: the reference never fills them; this makes the decode's
    cross-attention do real work)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_encdec

    return _torch_encdec


def _embed_inputs(cfg, B: int, S: int, seed: int, device: str) -> dict:
    """``make_inputs`` of a B x S prefill (whisper: S // 2 audio frames and S
    tokens; qwen2-vl: S embeddings and M-RoPE positions drawn in [0, S)),
    labels dropped."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.registry import make_inputs

    made = make_inputs(cfg, ShapeConfig("prefill", S, B, "prefill"), seed=seed, device=device)
    return {k: v for k, v in made.items() if k != "labels"}


def whisper_inputs(B: int, seed: int, device: str, *, frames: int = WHISPER_FRAMES,
                   labels: bool = False) -> dict:
    """Whisper-base's batch at its published context: B x ``frames`` audio
    frames (normal x 0.02, bf16) and B x WHISPER_TOKENS tokens (and, with
    ``labels``, labels) uniform over the vocabulary, drawn from numpy's
    ``default_rng(seed)`` as ``make_inputs`` draws its own (which ties the
    frames to half the tokens)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("whisper_base")
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32) * 0.02
    out = {"audio_embeds": torch.from_numpy(audio).to(device, torch.bfloat16)}
    for name in ("tokens", "labels") if labels else ("tokens",):
        out[name] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, WHISPER_TOKENS),
                                                  dtype=np.int32)).to(device)
    return out


def _decode_batch(batch: dict, i: int) -> dict:
    """Decode step i's input: the VLM's embedding at position i, else token i."""
    if "embeds" in batch:
        return {"embed": batch["embeds"][:, i].contiguous(), "cur_len": i}
    return {"token": batch["tokens"][:, i].contiguous(), "cur_len": i}


def drive_embed(arch: str, seed: int, card: str, out_dir: Path) -> int:
    """``arch`` (whisper-base or qwen2-vl-7b) at full width and depth: the
    serve CLI (greedy decode, B=4, 32 tokens after a warm-up step; qwen2-vl
    against a 2048 cache, fed one seeded embedding; whisper at its published
    context, cache and ``max_pos`` WHISPER_TOKENS, its cross K/V left at
    zero as the reference leaves them), then with its model and weights
    PREFILL_RUNS timed prefills of B=PREFILL_B, flash_attention counted from
    0 (qwen2-vl: ``make_inputs``' 2048 embeddings and random M-RoPE
    positions; whisper: ``whisper_inputs``, WHISPER_FRAMES audio frames and
    WHISPER_TOKENS tokens); for whisper, 32 more steps of the CLI's loop
    (``decode_loop``) with the cross K/V of the WHISPER_FRAMES frames filled
    from the encoder (``cross_kv``); then a profile split by the layers'
    parts. Returns the flash_attention launches of the prefills and the
    decodes."""
    import gc

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve

    cache_len = WHISPER_TOKENS if arch == "whisper_base" else PREFILL_S
    args = ["--arch", arch, "--full", "--batch", str(PREFILL_B), "--cache-len", str(cache_len),
            "--tokens", "32", "--seed", str(seed)]
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    out = serve.main(args)
    serve_wall = time.perf_counter() - t0
    decode_launches = fa.launches
    model, params = out.pop("model"), out.pop("params")
    cfg = model.cfg
    if not out["finite"] or out["tokens"].shape != (PREFILL_B, 32):
        raise AssertionError(f"serve: logits finite {out['finite']}, tokens {out['tokens'].shape}")
    cache = {name: math.prod(shape) * dtype.itemsize
             for name, (shape, dtype) in model.cache_template(PREFILL_B, cache_len).items()}
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    tag = arch.split("_")[0] if cfg.family == "encdec" else "qwen2-vl"
    log(f"{tag}: {cfg.name} {model.n_params()} parameters ({weights} bytes), {cfg.n_layers} "
        + (f"decoder and {cfg.encoder_layers} encoder layers, " if cfg.family == "encdec" else
           "layers, ")
        + f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, rope {cfg.rope_style}"
        + (f" sections {cfg.mrope_sections}" if cfg.mrope_sections else "")
        + f", max_pos {model.max_pos}; random weights (seed {seed})")
    log(f"{tag}: serve {' '.join(args)}: {out['seconds']:.4f} s after a "
        f"{out['warmup_seconds']:.4f} s warm-up step, {out['tokens'].size / out['seconds']:.1f} "
        f"tokens/s, {1e3 * out['seconds'] / 32:.3f} ms per step, peak device memory "
        f"{out['peak_bytes']} bytes ({held} held before the phase), cache "
        f"{sum(cache.values())} bytes ({', '.join(f'{k} {v}' for k, v in cache.items())}), "
        f"flash_attention launches {decode_launches} (decode attends with the plain "
        f"gqa_attention); {serve_wall:.3f} s for the whole CLI, the weights' draw on the card "
        f"included ({card})")
    if cfg.family == "encdec":
        zero = float(out["tokens"].max())
        _encdec().draw_final_norms(params, seed + 9)
        log(f"{tag}: from the init rule every logit is 0 (the serve CLI's greedy tokens' max "
            f"{zero:.0f}); the final layer norms drawn from the seed from here on "
            f"(draw_final_norms)")
        batch = whisper_inputs(PREFILL_B, seed, "cuda")
    else:
        batch = _embed_inputs(cfg, PREFILL_B, PREFILL_S, seed, "cuda")
    prefill_launches = timed_prefills(model, params, batch, tag, card)
    filled = None
    if cfg.family == "encdec":
        filled = model.init_cache(PREFILL_B, cache_len)
        filled["xk"], filled["xv"] = _encdec().cross_kv(model, params, batch["audio_embeds"])
        first = {"token": batch["tokens"][:, 0].contiguous()}
        serve.decode_loop(model, params, {k: v.clone() for k, v in filled.items()}, dict(first),
                          1)  # warm-up
        before = fa.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = serve.decode_loop(model, params, {k: v.clone() for k, v in filled.items()},
                                         dict(first), 32)
        wall = time.perf_counter() - t0
        if not all(torch.isfinite(x).all() for x in logits) or fa.launches != before:
            raise AssertionError(f"{tag}: decode with the cross K/V filled: not finite, or it "
                                 f"launched flash_attention")
        log(f"{tag}: decode_loop (the serve CLI's loop), 32 tokens x batch {PREFILL_B} with the "
            f"cross K/V ({WHISPER_FRAMES} frames) filled from the encoder: {wall:.4f} s, "
            f"{toks.size / wall:.1f} tokens/s, {1e3 * wall / 32:.3f} ms per step; max |xk| "
            f"{float(filled['xk'].abs().max()):.3e}; sample {toks[0][:8].tolist()} ({card})")
    profile_model(model, params, batch, out_dir, name=tag, cache=filled)
    del model, params, out, batch, filled
    gc.collect()
    torch.cuda.empty_cache()
    return prefill_launches + decode_launches


@contextlib.contextmanager
def attention_jitter(seed: int):
    """While active, every output of ``flash_attention`` and
    ``gqa_attention`` in the LM moves by one ulp of its dtype, up or down at
    random (seeded): a rounding the card and the CPU could disagree on
    (the kernel rounds P to bf16 and sums in another order), which shows
    how far the model carries one."""
    from repro_torch.models import lm

    nudge = ulp_nudger(seed)
    flash, gqa = lm.flash_attention, lm.gqa_attention
    lm.flash_attention = lambda *a, **k: nudge(flash(*a, **k))
    lm.gqa_attention = lambda *a, **k: nudge(gqa(*a, **k))
    try:
        yield
    finally:
        lm.flash_attention, lm.gqa_attention = flash, gqa


@contextlib.contextmanager
def tp_columns(n: int):
    """While active (inside ``tp_rounding(n)``), every product that tensor
    parallelism splits by its columns over "model" runs as ``n`` products,
    one for each block of columns, each on a contiguous copy of its block:
    on the shapes on which the ranks run it. These are the attention's q, k
    and v projections over their heads (the cross-attention's too; k and v
    where the KV heads divide ``n``), SwiGLU's gate and up and the GELU
    MLP's first product over d_ff, and the head over the vocab where it
    divides ``n``. In f32, cuBLAS may pick another algorithm for a block's
    shape, whose sums differ in the last bit, which ``tp_rounding`` does not
    model. With ``tp_rounding``, it makes the unsharded run compute as the
    ranks compute. The Mamba2 in-projection is not split here."""
    from repro_torch.models import layers, lm

    def cols(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) as n products over contiguous column blocks."""
        k = w.shape[-1] // n
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.cat([x2 @ w[:, i * k:(i + 1) * k].contiguous() for i in range(n)], dim=-1)
        return y.reshape(*x.shape[:-1], -1)

    def rows(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``tp_rounding``'s row-parallel product: n partial sums in f32."""
        k = y.shape[-1] // n
        parts = [(y[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]).float() for i in range(n)]
        return sum(parts[1:], parts[0]).to(y.dtype)

    def proj(x, w):
        if w.shape[1] % n:
            return real[0](x, w)
        return cols(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])

    def mlp(x, wi_gate, wi_up, wo):
        return rows(torch.nn.functional.silu(cols(x, wi_gate).float()).to(x.dtype)
                    * cols(x, wi_up), wo)

    def gelu(x, wi, bi, wo, bo):
        return rows(layers._gelu_tanh(cols(x, wi) + bi).to(x.dtype), wo) + bo

    def head(self, params, h, tp=None):
        if self.cfg.vocab % n:
            return real[3](self, params, h, tp)
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return cols(self._final_norm(params, h), w)

    real = lm._proj, lm.swiglu_mlp, lm.gelu_mlp, lm.LM._head
    lm._proj, lm.swiglu_mlp, lm.gelu_mlp, lm.LM._head = proj, mlp, gelu, head
    try:
        yield
    finally:
        lm._proj, lm.swiglu_mlp, lm.gelu_mlp, lm.LM._head = real


def _embed_run(cfg, weights, batch: dict, where: str) -> tuple:
    """The prefill's last-position logits, every position's greedy token,
    and the logits of CHECK_DECODE_STEPS teacher-forced decode steps from a
    zero cache (whisper's cross K/V filled from this device's encoder)."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    model = build_model(cfg, max_pos=SMALL_S, device=where)
    params = model.load_params(weights)
    b = {k: v.to(model.device) for k, v in batch.items()}
    last = make_prefill_step(model)(params, b)
    with torch.no_grad():
        h, _ = model._forward(params, b)
        greedy = model._head(params, h).argmax(dim=-1)
    cache = model.init_cache(SMALL_B, SMALL_S)
    if cfg.family == "encdec":
        cache["xk"], cache["xv"] = _encdec().cross_kv(model, params, b["audio_embeds"])
    steps = []
    with torch.no_grad():
        for i in range(CHECK_DECODE_STEPS):
            logits, cache = model.decode_step(params, cache, _decode_batch(b, i))
            steps.append(logits.cpu())
    return last.cpu(), greedy.cpu(), torch.stack(steps)


def embed_card_vs_cpu(seed: int, arch: str) -> bool:
    """``arch`` at full width and EMBED_CHECK_LAYERS layers (whisper: as many
    encoder layers) in f32 on the card and on the CPU from the same
    weights (one draw of one seeded CPU generator) and ``make_inputs`` of a
    SMALL_B x SMALL_S prefill, and on the CPU once more under
    ``attention_jitter``: the criteria above, each held where the jittered
    CPU meets it and printed where it does not. Returns whether every
    criterion was held."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=EMBED_CHECK_LAYERS, dtype="float32",
                              encoder_layers=min(full.encoder_layers, EMBED_CHECK_LAYERS))
    batch = _embed_inputs(cfg, SMALL_B, SMALL_S, seed + 4, "cpu")
    weights = build_model(cfg, max_pos=SMALL_S, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    if cfg.family == "encdec":
        _encdec().draw_final_norms(weights, seed + 9)
    card = _embed_run(cfg, weights, batch, "cuda")
    cpu = _embed_run(cfg, weights, batch, "cpu")
    with attention_jitter(seed):
        jit = _embed_run(cfg, weights, batch, "cpu")
    del weights
    tag = (f"{'whisper' if cfg.family == 'encdec' else 'qwen2-vl'} card vs CPU: {cfg.name} full "
           f"width, {cfg.n_layers} layers"
           + (f" + {cfg.encoder_layers} encoder layers" if cfg.family == "encdec" else "")
           + ", float32")
    return held_against_jitter(tag, card, cpu, jit)


# ---------------------------------------------------------------- phase 7
# qwen2-0.5b trained at full width, checkpointing its whole state, at
# TRAIN_DEPTH of its 24 layers (a reduced: line): at 24 the state is 4.94 GB
# and its two saves took 61.5 and 79.5 s of a script that must finish in
# 1200 s. The storage kernels still run past 2**32 positions: they are held
# on the saved state repeated to more than 2**32 bytes
TRAIN_B, TRAIN_S, TRAIN_LR = 4, 2048, 1e-3  # the reference launcher's rate
TRAIN_DEPTH = 2
# The redone step 5 starts from the restored step-4 state, equal bit for bit,
# with the same batch: its forward repeats on the same card. The tolerance
# allows only for cuBLAS choosing another algorithm (the backward's atomics,
# in the embedding gradient, come after the loss).
REDO_LOSS_ATOL = 1e-3
# card vs CPU in bf16: qwen2-0.5b at full width, 2 layers, B=2 x 256, one step at lr
TRAIN_SMALL_LAYERS, TRAIN_SMALL_B, TRAIN_SMALL_S = 2, 2, 256


def _host_memory() -> str:
    """MemTotal and MemAvailable of the host, and this process's peak RSS."""
    import resource

    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    gib = lambda key: int(info[key].split()[0]) / (1 << 20)  # noqa: E731
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    return (f"host memory {gib('MemTotal'):.1f} GiB, available {gib('MemAvailable'):.1f} GiB, "
            f"this process's peak RSS {peak:.1f} GiB")


def drive_training(seed: int, out_dir: Path, card: str, totals: dict, worst: dict) -> None:
    """qwen2-0.5b at full width and depth, B=4 x 2048, AdamW at lr 1e-3:
    steps 1-2, a save of the whole state (parameters, AdamW state, data
    state), steps 3-4, an incremental save, step 5; then the trainer and
    ``fault_budget()`` hosts crash, the step-4 state is restored (checked
    bit for bit) and step 5 is redone. The storage kernels' counts are set
    to 0 before the sequence and read after it. Then the kernels are held
    against their plain versions on the bytes that the step-4 save wrote,
    the blocks of that save are accounted for, the gradient's norm is
    printed by leaf, and one more step runs under ``torch.profiler``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.models.registry import build_model
    from repro_torch.device import host_tensor
    from repro_torch.train.checkpoint import ECCheckpointStore, serialize_tree
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step
    from repro_torch.tree import named_leaves

    import dataclasses

    cfg = dataclasses.replace(get_arch(MODEL), n_layers=TRAIN_DEPTH)
    log(f"reduced: train {MODEL} n_layers {get_arch(MODEL).n_layers} -> {TRAIN_DEPTH} (the "
        f"script's 1200 s: the 24-layer state's two saves took 61.5 and 79.5 s; the storage "
        f"kernels are held past 2**32 positions on the saved state repeated)")
    t0 = time.perf_counter()
    model = build_model(cfg, max_pos=TRAIN_S, device="cuda")
    params = model.init_params(torch.Generator().manual_seed(seed))
    opt = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                                  seed=seed))
    step_fn = make_train_step(model, None, AdamWConfig(lr=TRAIN_LR))
    store = ECCheckpointStore(n_hosts=8, parity=2, seed=seed, device="cuda",
                              coding_backend="kernel", min_block=MIN_BLOCK,
                              avg_block=AVG_BLOCK, max_block=MAX_BLOCK)
    torch.cuda.synchronize()
    log(f"train: {cfg.name} {model.n_params()} parameters ({cfg.n_layers} layers, full width), "
        f"B={TRAIN_B} x S={TRAIN_S}, AdamW lr {TRAIN_LR}, random weights (seed {seed}) made in "
        f"{time.perf_counter() - t0:.3f} s; {_host_memory()}")

    losses: list[tuple[str, float, float]] = []  # (label, loss, wall)

    def train(label: str):
        nonlocal params, opt
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.next_batch().items()}
        t = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        loss = float(loss)  # waits for the step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not np.isfinite(loss):
            raise AssertionError(f"train: {label} loss {loss} is not finite")
        losses.append((label, loss, wall))
        log(f"train: {label}: loss {loss:.6f}, {wall:.4f} s wall, "
            f"{TRAIN_B * TRAIN_S / wall:.1f} tokens/s ({card})")

    saves = {}

    def save(step: int):
        t = time.perf_counter()
        st = store.save(step, {"params": params, "opt": opt, "data": data.state()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not st.success:
            raise AssertionError(f"train: the save at step {step} failed: {st}")
        saves[step] = (st, wall)
        log(f"train: save at step {step}: {st.bytes_written} bytes in {wall:.3f} s, "
            f"{st.bytes_written / 1e9 / wall:.4f} GB/s, {st.blocks_written}/{st.blocks_total} "
            f"blocks written ({100 * st.blocks_written / st.blocks_total:.3f} %); "
            f"{_host_memory()} ({card})")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cdc.launches = 0
    gf.launches = 0
    t_seq = time.perf_counter()
    train("step 1")
    train("step 2")
    save(2)
    # the bytes each save wrote, kept on the host for the accounting below
    blob2 = serialize_tree({"step": 2, "state": {"params": params, "opt": opt,
                                                 "data": data.state()}})
    train("step 3")
    train("step 4")
    save(4)
    saved = {"params": params, "opt": opt, "data": data.state()}  # what step 4 saved
    blob4 = serialize_tree({"step": 4, "state": saved})
    train("step 5")
    first5 = losses[-1][1]
    # the trainer dies (its state is dropped) and so do fault_budget() hosts
    params = opt = None
    budget = store.fault_budget()
    store.crash_hosts([f"s{i}" for i in range(budget)])
    t = time.perf_counter()
    restored = store.restore()
    torch.cuda.synchronize()
    restore_wall = time.perf_counter() - t
    if restored is None:
        raise AssertionError("train: restore found no checkpoint")
    rstep, state = restored
    if rstep != 4:
        raise AssertionError(f"train: restored step {rstep}, not 4")
    _same_state(state, saved, "train restore")
    del saved
    params, opt = state["params"], state["opt"]
    data.restore(state["data"])
    del state
    train("step 5 redone")
    seq_wall = time.perf_counter() - t_seq
    peak = torch.cuda.max_memory_allocated()
    counts = {"cdc_gearhash": cdc.launches, "gf256_matmul": gf.launches}
    for name, c in counts.items():
        if not c:
            raise AssertionError(f"train: the checkpoints never launched {name}")
        totals[name] = totals.get(name, 0) + c
    redo_err = abs(losses[-1][1] - first5)
    if not redo_err <= REDO_LOSS_ATOL:
        raise AssertionError(f"train: redone step 5 loss {losses[-1][1]} differs from "
                             f"{first5} by {redo_err} > {REDO_LOSS_ATOL}")
    gb = saves[4][0].bytes_written / 1e9
    walls = [w for label, _, w in losses if label != "step 1"]
    median = sorted(walls)[len(walls) // 2]
    log(f"train: restore of step 4 with {budget} host(s) down: {restore_wall:.3f} s, "
        f"{gb / restore_wall:.4f} GB/s, bit for bit on the card ({card})")
    log(f"train: step 5 loss {first5:.6f}, redone {losses[-1][1]:.6f} (|diff| {redo_err:.3e}, "
        f"tolerance {REDO_LOSS_ATOL}); losses {', '.join(f'{x:.6f}' for _, x, _ in losses)}")
    log(f"train: {TRAIN_B * TRAIN_S / median:.1f} train tokens/s (median step {median:.4f} s "
        f"of {', '.join(f'{w:.4f}' for w in walls)}, steps after the first, saves excluded); "
        f"first step {losses[0][2]:.4f} s; the whole sequence {seq_wall:.3f} s; peak device "
        f"memory {peak} bytes; incremental save rewrote {saves[4][0].blocks_written}/"
        f"{saves[4][0].blocks_total} blocks; launches cdc_gearhash {counts['cdc_gearhash']} "
        f"gf256_matmul {counts['gf256_matmul']} ({card})")
    # the storage kernels on the bytes the step-4 save wrote (not counted:
    # the counts were read above), and where that save's blocks came from
    fm_stats = [r.extra for r in store.dss.history if r.kind == "fm-update"][-2:]
    del store
    chunks4 = check_storage_kernels_at(f"the training state ({len(blob4)} bytes)",
                                       host_tensor(blob4).to("cuda"), (8,), card, worst)
    account_blocks(fm_stats, blob2, blob4, chunks4)
    del blob2
    times = (1 << 32) // len(blob4) + 1  # past 2**32 positions
    check_storage_kernels_at(f"the training state {times} times over ({times * len(blob4)} "
                             f"bytes, past 2**32)", host_tensor(blob4).to("cuda").repeat(times),
                             (8,), card, worst)
    del blob4

    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.next_batch().items()}
    # the gradient's size, which the global-norm clip divides every leaf by
    _, grads = loss_and_grads(model, params, batch)
    norms = {n: float(torch.linalg.vector_norm(g.float())) for n, g in named_leaves(grads)}
    del grads
    total = sum(v * v for v in norms.values()) ** 0.5
    log(f"train: gradient norm {total:.4e} on the next batch, so the clip scales every "
        f"gradient by {1 / total:.4e}; by leaf: "
        f"{', '.join(f'{n} {v:.3e}' for n, v in sorted(norms.items(), key=lambda kv: -kv[1]))}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if not torch.isfinite(loss):
        raise AssertionError("train: the profiled step's loss is not finite")
    device_busy(prof, out_dir / "train_step_trace.json", wall, "profile train step:")
    del model, params, opt, prof
    torch.cuda.empty_cache()


def account_blocks(fm_stats: list, blob2: bytes, blob4: bytes, chunks4: int) -> None:
    """Where the incremental save's blocks come from: the file's block list
    after an update is the new content's CDC chunks plus a tombstone (an
    emptied block) for each old block the matcher did not pair with a new
    chunk; and which bytes of the state did not change from step 2 to
    step 4, leaf by leaf (the unchanged blocks lie there). ``fm_stats``
    are the two saves' fragmentation-module records."""
    from repro_torch.train.checkpoint import deserialize_tree
    from repro_torch.tree import named_leaves

    first, second = fm_stats
    tomb = second["blocks"] - second["chunks"]
    genesis = int(second["created"] > 0)  # new block ids change the file's index
    data_writes = second["written"] - genesis
    in_place = data_writes - second["created"] - tomb
    log(f"train: blocks: the step-2 save cut {first['chunks']} chunks and listed "
        f"{first['blocks']} blocks; the step-4 save cut {second['chunks']} chunks (the check "
        f"above cut {chunks4}) and listed {second['blocks']} blocks = {second['chunks']} chunks "
        f"+ {tomb} tombstones (step-2 blocks the matcher left unpaired, emptied). Of the "
        f"{second['chunks']} chunks {second['blocks'] - data_writes} were unchanged, "
        f"{in_place} rewritten in place and {second['created']} new: "
        f"{100 * (in_place + second['created']) / second['chunks']:.3f} % of the content "
        f"rewritten; {second['written']} writes with the emptied blocks and the genesis block")
    if chunks4 != second["chunks"]:
        raise AssertionError(f"train: the chunker cut {second['chunks']} blocks on the card, "
                             f"the check {chunks4}")
    old, new = (dict(named_leaves(deserialize_tree(b)["state"])) for b in (blob2, blob4))
    rows, same_bytes = [], 0
    for name, a in old.items():
        if not isinstance(a, torch.Tensor):
            continue
        b = new[name]
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        same = int(torch.sum(a.reshape(-1).view(bits) == b.reshape(-1).view(bits)))
        same_bytes += same * a.element_size()
        if same:
            rows.append(f"{name} {same}/{a.numel()}")
    log(f"train: bytes unchanged from step 2 to step 4: {same_bytes} of {len(blob4)}; by leaf "
        f"(equal elements / elements): {'; '.join(rows)}")


def _train_step_both(cfg, batch: dict, seed: int, lr: float) -> dict:
    """One train step (its two halves: loss and gradients, then AdamW) on
    the CPU and on the card from the same weights: the seeded bf16 weights
    (one CPU generator, one draw), upcast for a float32 ``cfg``. On the card
    AdamW also runs once more from the CPU's gradients; for the SSD families
    in bf16 the CPU's step runs again with every SSD output nudged one f32
    ulp up and down (``ssd_nudged``); for MoE, where a route differs, the
    CPU's step runs again on the card's routes (``RouteReplay``). Returns
    {"cpu" | "cuda" | "cuda from CPU gradients" | "cpu nudged up" | "cpu
    nudged down" | "cpu on the card's routes": (loss, grads, params, opt,
    gradient norm, the loss's ``_route`` calls)}, the trees left on their
    device."""
    import dataclasses

    import _torch_moe_criteria as mc
    import _torch_train_criteria as crit

    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.steps import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    weights = build_model(bf16, device="cpu").init_params(torch.Generator().manual_seed(seed))
    if cfg.family == "encdec":
        _encdec().draw_final_norms(weights, seed + 9)
    if cfg.dtype != "bfloat16":
        weights = tree_map(lambda p: p.float(), weights)
    runs = [("cpu", "cpu", contextlib.nullcontext), ("cuda", "cuda", contextlib.nullcontext)]
    if cfg.is_ssm and cfg.dtype == "bfloat16":
        runs[1:1] = [("cpu nudged up", "cpu", lambda: crit.ssd_nudged(math.inf)),
                     ("cpu nudged down", "cpu", lambda: crit.ssd_nudged(-math.inf))]
    if cfg.family == "moe":
        runs.append(("cpu on the card's routes", "cpu", lambda: mc.RouteReplay(seen["cuda"][5])))
    seen, cpu_grads = {}, None
    for label, where, ctx in runs:
        if label == "cpu on the card's routes" and all(
                np.array_equal(a[k], b[k]) for a, b in zip(seen["cuda"][5], seen["cpu"][5])
                for k in ("routed", "kept")):
            break  # the CPU routed as the card did
        model = build_model(cfg, device=where)
        params = tree_map(lambda p: p.to(model.device), weights)
        b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
        with mc.RouteLog() as routes, ctx():
            loss, grads = loss_and_grads(model, params, b)
        new, opt = adamw_update(params, grads, adamw_init(params), AdamWConfig(lr=lr))
        norm = float(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads))) ** 0.5
        seen[label] = (float(loss), grads, new, opt, norm, routes.calls)
        if label == "cpu":
            cpu_grads = grads
        elif label == "cuda":
            g = tree_map(lambda x: x.to(model.device), cpu_grads)
            new, opt = adamw_update(params, g, adamw_init(params), AdamWConfig(lr=lr))
            seen["cuda from CPU gradients"] = (None, None, new, opt, seen["cpu"][4], None)
        del model, params, grads, new, opt
    return seen


def _step_summary(m: dict) -> str:
    pooled = sum(x["within"] for x in m.values()) / sum(x["size"] for x in m.values())
    return (f"m {max(x['m'] for x in m.values()):.4f}, v {max(x['v'] for x in m.values()):.4f}; "
            f"within 1 bf16 ulp {pooled:.4f} of all parameters (least leaf "
            f"{min(x['share'] for x in m.values()):.4f}); largest |diff| / (ulp + 2 lr) "
            f"{max(x['ratio'] for x in m.values()):.4f}")


def train_check(cfg, width: str, B: int, S: int, lr: float, data_seed: int, seed: int,
                criteria: bool, pooled: bool = False) -> bool:
    """One train step of ``cfg`` on the card against the CPU
    (``_train_step_both``), printed, and held to the criteria of
    ``tests/_torch_train_criteria.py`` where ``criteria``, as
    ``hold_step`` decides. Always held: the loss, step, the final norm's
    gradient and AdamW on the card from the CPU's gradients. MoE: on each
    device the backward's recompute routes as the forward did, and the
    forward's routes meet ``tests/_torch_moe_criteria.py``; where a route
    differs, the distance from the CPU's own step is printed and the card
    is held against the CPU's step on the card's routes. SSD families in
    bf16: the CPU's own step with every SSD output nudged one f32 ulp up or
    down decides whether the step is well-conditioned (held), ill-conditioned
    within the cap (held to the criteria widened by the nudge) or past it
    (printed, not held). ``pooled`` takes the 1-ulp share of the updated
    parameters over all of them instead of leaf by leaf. The trees are
    compared on the card. Returns whether the step was held."""
    import _torch_moe_criteria as mc
    import _torch_train_criteria as crit

    t0 = time.perf_counter()
    batch = _train_batches(cfg, B, S, data_seed, "cpu")()
    seen = _train_step_both(cfg, batch, seed, lr)
    tag = (f"{cfg.name} {width}, {cfg.n_layers} layer{'s' if cfg.n_layers > 1 else ''}, "
           f"{cfg.dtype}, {B} x {S} tokens, lr {lr}")
    (lc, gc, pc, oc, nc, rc), (lh, gh, ph, oh, nh, rh) = seen["cuda"], seen["cpu"]
    gerr = crit.grad_errors(gc, gh)
    m = crit.step_metrics(pc, oc, ph, oh, lr)
    mx = crit.step_metrics(*seen["cuda from CPU gradients"][2:4], ph, oh, lr)
    if cfg.family == "moe":
        L = cfg.n_layers
        for where, calls in (("card", rc), ("CPU", rh)):
            again = calls[L:][::-1]  # the backward recomputes from the last layer back
            if len(calls) != 2 * L or not all(
                    np.array_equal(a[k], b[k]) for a, b in zip(calls[:L], again)
                    for k in ("probs", "routed", "kept")):
                raise AssertionError(f"train card vs CPU {tag}: the {where}'s recompute routed "
                                     f"otherwise than its forward")
        res = mc.compare_routes(rc[:L], rh[:L], cfg.moe_top_k, B)
        flips = sum(lay["flips_below_delta"] + lay["flips_after_upstream_flip"]
                    + lay["drop_changes"] for lay in res["layers"])
        log(f"train card vs CPU: {tag}: routes: the recompute routed as the forward on both "
            f"devices; {flips} tokens' expert sets or drops differ (all below delta "
            f"{mc.ROUTE_DELTA}), largest margin shift {res['max_shift']:.3e}")
        if "cpu on the card's routes" in seen:
            replay = seen["cpu on the card's routes"]
            if not all(np.array_equal(a[k], b[k]) for a, b in zip(rc, replay[5])
                       for k in ("routed", "kept")):
                raise AssertionError(f"train card vs CPU {tag}: the replay routed otherwise")
            log(f"train card vs CPU: {tag}: against the CPU's own routes (printed, not held): "
                f"gradients within {max(gerr.values()):.4f}; {_step_summary(m)}; held below "
                f"against the CPU's step on the card's routes")
            lh, gh, ph, oh, nh, _ = replay
            gerr = crit.grad_errors(gc, gh)
            m = crit.step_metrics(pc, oc, ph, oh, lr)
    nudged = []
    for label in ("cpu nudged up", "cpu nudged down"):
        if label in seen:
            mn = crit.step_metrics(*seen[label][2:4], ph, oh, lr)
            gn = crit.grad_errors(seen[label][1], gh)
            nudged.append((mn, gn))
            log(f"train card vs CPU: {tag}: the CPU against itself with the SSD {label[4:]}: "
                f"gradients within {max(gn.values()):.4f}; {_step_summary(mn)}; the criteria "
                f"{'met' if crit.meets(mn, gn) else 'missed: ill-conditioned'}")
    held, verdict, failures = crit.hold_step(m, gerr, nudged, pooled=pooled)
    if not criteria:
        held, verdict, failures = False, "not met here, not held (see train_card_vs_cpu)", []
    log(f"train card vs CPU: {tag}: loss {lc:.6f} / {lh:.6f} (|diff| {abs(lc - lh):.3e}); "
        f"gradient norm {nc:.4f} / {nh:.4f}; gradients within {max(gerr.values()):.4f} "
        f"relative L2 (final norm {gerr['final_ln']:.4f}); the step: {_step_summary(m)}; AdamW "
        f"on the card from the CPU's gradients: {_step_summary(mx)}; the criteria {verdict}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(lc) and abs(lc - lh) <= crit.LOSS_ATOL):
        raise AssertionError(f"train card vs CPU {tag}: loss {lc} against {lh}")
    if int(oc["step"]) != int(oh["step"]) or int(oc["step"]) != 1:
        raise AssertionError(f"train card vs CPU {tag}: step differs")
    if gerr["final_ln"] > crit.GRAD_RTOL:
        raise AssertionError(f"train card vs CPU {tag}: final norm gradient {gerr['final_ln']}")
    crit.assert_step_close(mx)
    if failures:
        raise AssertionError(f"train card vs CPU {tag}: {verdict}, but {failures}")
    return held


def train_card_vs_cpu(seed: int) -> None:
    """One train step on the card against the CPU, from the same weights and
    batch, held to the slice's criteria (``tests/_torch_train_criteria.py``:
    the loss, every gradient leaf, m, v, step and the updated parameters):

    - reduced qwen2-0.5b and gemma3-1b in bf16 at B=2 x 64, and at
      B=1 x 2048, where the attention runs in q_chunk chunks, each under its
      own checkpoint inside the layer's, as in the timed step;
    - qwen2-0.5b at full width, one layer, at B=1 x 2048 in f32 (the bf16
      weights upcast; the whole step in f32, ``LM.loss_fn``): one layer's
      gradients from the same inputs, through the chunked attention.

    At full width the step is ill-conditioned from the second layer on: the
    init's fan-in of wq and wk is H and KV, so the scores have a std of
    ~170 and the attention is a hard argmax, and the second layer amplifies
    what the first one's rounding changed. A one-ulp change of a bf16
    projection moves a layer's gradient by tens of percent; two compiles of
    the reference's own step are as far apart (``tests/_full_width_spread.py``).
    Even in f32 a change of the CPU's thread count moves the gradients
    about 28 times more at 2 layers than at 1 (``--f32`` there). So at
    full width in bf16 (2 layers, B=2 x 256) the criteria are not met and
    not held: that step is printed, and held only where it is
    well-conditioned: the loss, step, the final norm's gradient, and AdamW
    on the card from the CPU's gradients."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.configs import get_arch

    for arch in ("qwen2_0_5b", "gemma3_1b"):
        cfg = get_arch(arch).reduced()
        train_check(cfg, "reduced", 2, 64, 3e-4, seed, seed, criteria=True)
        train_check(cfg, "reduced", 1, TRAIN_S, 3e-4, seed, seed, criteria=True)
    full = get_arch(MODEL)
    train_check(dataclasses.replace(full, n_layers=1, dtype="float32"), "full width", 1, TRAIN_S,
                TRAIN_LR, seed + 3, seed, criteria=True)
    train_check(dataclasses.replace(full, n_layers=TRAIN_SMALL_LAYERS), "full width",
                TRAIN_SMALL_B, TRAIN_SMALL_S, TRAIN_LR, seed + 3, seed, criteria=False)


# ---------------------------------------------------------------- phase 7b
# the MoE, SSM and hybrid families trained at the architectures' published
# widths on one card, at depths cut for the script's time (full depth does
# not fit: AdamW here is functional, so the old and the new params/m/v are
# alive together during the update, ~22 bytes a parameter with the bf16
# gradients; one card's measured peak stayed under ~70 GB at the depths
# TRAIN_DEPTH_CUT names)
FAMILY_TRAIN_DEPTHS = {"olmoe_1b_7b": 2, "mamba2_2_7b": 8, "zamba2_7b": 7}
# phase 7c: whisper-base at full depth (6 + 6 layers), qwen2-vl-7b cut the
# same way (~28 bytes a parameter, ~6.5 GB for each layer of 233 M, on top
# of ~10 GB for the f32 logits and their gradient: 9 layers reached ~70 GB)
EMBED_TRAIN_DEPTHS = {"whisper_base": 6, "qwen2_vl_7b": 4}
# both cut further for the script's 1200 s: one card held olmoe at 5 layers,
# mamba2 at 56, zamba2 at 27 and qwen2-vl at 8; zamba2's 7 are one group, its
# shared block and one trailing layer
TRAIN_DEPTH_CUT = ("the script's 1200 s; one card's 80 GB holds olmoe 5, mamba2 56, zamba2 27, "
                   "qwen2-vl 8 layers")
FAMILY_TIMED_STEPS = 3
# card vs CPU at full width in f32: the fewest layers that hold each part
FAMILY_CHECK_LAYERS = {"olmoe_1b_7b": 1, "mamba2_2_7b": 1, "zamba2_7b": 3}
# zamba2's three: a group of two Mamba2 layers, the shared block and a
# trailing layer, each part as the seven layers of a group of six held it
# until the script's 1080 s with phase 14 (its CPU step took most of this check's ~70 s)
FAMILY_CHECK_OVERRIDES = {"zamba2_7b": {"shared_attn_every": 2}}
FAMILY_CHECK_S = 256
# the launcher at the reduced configs, each family: crash at step 8, one
# checkpoint host down, restore from the step-5 save, steps 6-8 redone
LAUNCHER_HOSTS, LAUNCHER_PARITY = 6, 2
LAUNCHER_BLOCKS = (1 << 16, 1 << 18, 1 << 20)  # min, avg, max: the launcher's defaults
LAUNCHER_ARGS = ["--steps", "12", "--ckpt-every", "5", "--crash-at", "8", "--kill-hosts", "1",
                 "--ckpt-hosts", str(LAUNCHER_HOSTS), "--ckpt-parity", str(LAUNCHER_PARITY),
                 "--batch", "2", "--seq", "32", "--min-block", str(LAUNCHER_BLOCKS[0]),
                 "--avg-block", str(LAUNCHER_BLOCKS[1]), "--max-block", str(LAUNCHER_BLOCKS[2])]


def train_ranges(family: str) -> contextlib.ExitStack:
    """The ranges of a train step's profile: ``forward`` (the whole
    ``loss_fn``, on the calling thread), ``layer`` (each checkpointed layer:
    the forward's and, on the backward's thread, its recompute), ``adamw``
    (the update), and the family's parts (``moe_ranges``, ``ssm_ranges``,
    ``attn_ranges``)."""
    from repro_torch.models import lm
    from repro_torch.train import steps

    stack = contextlib.ExitStack()
    stack.enter_context(ranges([(lm.LM, "loss_fn", "forward"), (steps, "adamw_update", "adamw"),
                                (lm.LM, "_dense_block", "layer"),
                                (lm.LM, "_mamba_layer", "layer"), (lm.LM, "_enc_layer", "layer"),
                                (lm.LM, "_dec_layer", "layer")]))
    stack.enter_context(_family_split(family)[0]())
    return stack


def _family_split(family: str) -> tuple:
    """(ranges, part_of) of a family's profile split."""
    if family == "moe":
        return moe_ranges, moe_part
    if family in ("ssm", "hybrid"):
        return ssm_ranges, ssm_part
    return attn_ranges, attn_part


def _train_batches(cfg, B: int, S: int, seed: int, device: str):
    """A function giving the next B x S train batch on ``device``: from
    ``SyntheticLM`` (tokens and labels), or for the families that take
    embeddings (whisper, qwen2-vl), ``make_inputs`` of a train step (audio
    frames or embeddings and M-RoPE positions, tokens, labels) from seed,
    seed + 1, ..."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.registry import make_inputs
    from repro_torch.train.data import DataConfig, SyntheticLM

    if cfg.family == "encdec" or cfg.embeddings_input:
        seeds = itertools.count(seed)
        return lambda: make_inputs(cfg, ShapeConfig("train", S, B, "train"), seed=next(seeds),
                                   device=device)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    return lambda: {k: torch.from_numpy(v).to(device) for k, v in data.next_batch().items()}


def train_part(family_part):
    """``part_of`` for a train step: forward, recompute (a checkpointed
    layer run again on the backward's thread), backward (everything else on
    that thread) and AdamW, the first two split by ``family_part``."""
    def part_of(kind: str, where: tuple) -> str:
        if "adamw" in where:
            return f"AdamW: {kind}"
        if "forward" in where:
            return f"forward: {family_part(kind, where)}"
        if "layer" in where:
            return f"recompute: {family_part(kind, where)}"
        return f"backward: {kind}"

    return part_of


def drive_family_training(arch: str, seed: int, card: str, out_dir: Path) -> dict:
    """``arch`` at its published widths and FAMILY_TRAIN_DEPTHS (or
    EMBED_TRAIN_DEPTHS) layers, weights drawn on the card from the seed,
    B=TRAIN_B x TRAIN_S from ``SyntheticLM`` (qwen2-vl: from ``make_inputs``,
    ``_train_batches``; whisper at its published decoder context: B=TRAIN_B
    x WHISPER_TOKENS and WHISPER_TRAIN_FRAMES audio frames from
    ``whisper_inputs``, ``max_pos`` WHISPER_TOKENS), AdamW at lr TRAIN_LR:
    a warm-up step, then
    FAMILY_TIMED_STEPS timed steps (finite losses, median train tokens/s,
    peak device memory), the gradient's norm on the next batch (MoE: its
    routes recorded, the recompute's checked equal to the forward's, the
    drop share of the first and last layer), then one more step under
    ``torch.profiler``, split into forward, recompute, backward and AdamW
    and by the family's parts. Returns the numbers for the summary line."""
    import dataclasses
    import gc

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import _capacity
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves

    full = get_arch(arch)
    depth = {**FAMILY_TRAIN_DEPTHS, **EMBED_TRAIN_DEPTHS}[arch]
    cfg = dataclasses.replace(full, n_layers=depth)
    tag = f"train {'qwen2-vl' if arch == 'qwen2_vl_7b' else arch.split('_')[0]}"
    if depth < full.n_layers:
        log(f"reduced: n_layers {full.n_layers} -> {depth} ({cfg.name} training: "
            f"{TRAIN_DEPTH_CUT})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encdec = cfg.family == "encdec"
    S = WHISPER_TOKENS if encdec else TRAIN_S
    t0 = time.perf_counter()
    model = build_model(cfg, max_pos=S, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    if encdec:
        _encdec().draw_final_norms(params, seed + 9)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    frames = f" and {WHISPER_TRAIN_FRAMES} audio frames" if encdec else ""
    log(f"{tag}: {cfg.name} {model.n_params()} parameters ({depth} of {full.n_layers} layers"
        + (f" and {cfg.encoder_layers} encoder layers" if encdec else "")
        + f", full width d {cfg.d_model}), B={TRAIN_B} x S={S}{frames}, AdamW lr "
        f"{TRAIN_LR}, random weights drawn on the card (seed {seed}) in "
        f"{time.perf_counter() - t0:.3f} s; {held} bytes held before the phase")
    step_fn = make_train_step(model, None, AdamWConfig(lr=TRAIN_LR))
    if encdec:
        seeds = itertools.count(seed)
        next_batch = lambda: whisper_inputs(TRAIN_B, next(seeds), "cuda",  # noqa: E731
                                            frames=WHISPER_TRAIN_FRAMES, labels=True)
    else:
        next_batch = _train_batches(cfg, TRAIN_B, TRAIN_S, seed, "cuda")
    losses, walls = [], []
    for _ in range(1 + FAMILY_TIMED_STEPS):
        batch = next_batch()
        t = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        loss = float(loss)  # waits for the step
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if not np.isfinite(loss):
            raise AssertionError(f"{tag}: loss {loss} is not finite")
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    timed = walls[1:]
    median = sorted(timed)[len(timed) // 2]
    tps = TRAIN_B * S / median
    per_frame = (f" and {TRAIN_B * WHISPER_TRAIN_FRAMES / median:.1f} audio frames/s"
                 if encdec else "")
    log(f"{tag}: {tps:.1f} train tokens/s{per_frame} (median step {median:.4f} s of "
        f"{', '.join(f'{w:.4f}' for w in timed)} after a {walls[0]:.4f} s warm-up step); losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; peak device memory {peak} bytes "
        f"({peak / 1e9:.3f} GB; {torch.cuda.max_memory_reserved()} bytes reserved) ({card})")

    batch = next_batch()
    with mc.RouteLog() as routes:
        loss, grads = loss_and_grads(model, params, batch)
    norm = float(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads))) ** 0.5
    del grads
    log(f"{tag}: gradient norm {norm:.4e} on the next batch (loss {float(loss):.6f}), so the "
        f"clip scales the step by {min(1.0, 1 / norm):.4e}")
    drops = {}
    if cfg.family == "moe":
        L, T = cfg.n_layers, TRAIN_B * TRAIN_S
        fwd, again = routes.calls[:L], routes.calls[L:][::-1]
        if len(routes.calls) != 2 * L:
            raise AssertionError(f"{tag}: {len(routes.calls)} routings for {L} layers")
        for i, (a, b) in enumerate(zip(fwd, again)):
            if not all(np.array_equal(a[k], b[k]) for k in ("probs", "routed", "kept")):
                raise AssertionError(f"{tag}: layer {i}'s recompute routed otherwise")
        C = _capacity(T, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
        for i in (0, L - 1):
            n, kept = int(fwd[i]["routed"].sum()), int(fwd[i]["kept"].sum())
            drops[i] = 100 * (n - kept) / n
            log(f"{tag}: layer {i}: {n - kept} of {n} assignments dropped at capacity C={C} "
                f"({drops[i]:.3f} %)")
        log(f"{tag}: the backward's recompute routed every layer as the forward did "
            f"(probabilities, expert sets and drops equal bit for bit)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            train_ranges(cfg.family):
        t = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if not torch.isfinite(loss):
        raise AssertionError(f"{tag}: the profiled step's loss is not finite")
    name = tag.removeprefix("train ")
    events = device_busy(prof, out_dir / f"train_{name}_trace.json", wall,
                         f"profile {tag} step:")
    split_device_time(events, f"profile {tag} step:", "train",
                      train_part(_family_split(cfg.family)[1]))
    del model, params, opt, prof, events, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "depth": depth, "tokens_per_s": tps, "peak": peak, "norm": norm,
            "drops": drops}


def drive_train_launcher(arch: str, card: str, totals: dict, worst: dict) -> None:
    """``repro_torch.launch.train`` on the card at ``arch``'s reduced
    config with LAUNCHER_ARGS: the restored state must equal the step-5
    save bit for bit (parameters, AdamW state, data state) and the redone
    steps 6-8 must repeat their losses bit for bit. The storage kernels are
    counted from 0 and added to ``totals``; after the count, they are held
    against their plain versions on the bytes of the step-5 save (the one
    restored with a host down), at the launcher's code and block sizes, into
    ``worst``."""
    from repro_torch.device import host_tensor
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import ECCheckpointStore, serialize_tree
    from repro_torch.tree import named_leaves

    saved, restored, blobs = {}, [], {}
    real_save, real_restore = ECCheckpointStore.save, ECCheckpointStore.restore

    def save(self, step, state, *a, **kw):
        saved[step] = {part: {n: v.clone() for n, v in named_leaves(state[part])}
                       for part in ("params", "opt")}
        saved[step]["data"] = dict(state["data"])
        blobs[step] = serialize_tree({"step": step, "state": state})  # the bytes the save chunks
        return real_save(self, step, state, *a, **kw)

    def restore(self, *a, **kw):
        out = real_restore(self, *a, **kw)
        restored.append(out)
        return out

    cdc.launches = 0
    gf.launches = 0
    ECCheckpointStore.save, ECCheckpointStore.restore = save, restore
    try:
        t = time.perf_counter()
        out = train.main(["--arch", arch] + LAUNCHER_ARGS)
        wall = time.perf_counter() - t
    finally:
        ECCheckpointStore.save, ECCheckpointStore.restore = real_save, real_restore
    counts = {"cdc_gearhash": cdc.launches, "gf256_matmul": gf.launches}
    losses = out["losses"]
    (step, state), = restored
    for part in ("params", "opt"):
        got = dict(named_leaves(state[part]))
        for n, value in saved[step][part].items():
            if got[n].device != value.device or not torch.equal(got[n], value):
                raise AssertionError(f"launcher {arch}: restored {part} {n} differs")
    if {k: int(v) for k, v in state["data"].items()} != saved[step]["data"]:
        raise AssertionError(f"launcher {arch}: restored data state differs")
    if step != 5 or losses[5:8] != losses[8:11] or not np.isfinite(losses).all():
        raise AssertionError(f"launcher {arch}: restored step {step}, losses {losses}")
    for n, c in counts.items():
        if not c:
            raise AssertionError(f"launcher {arch}: the checkpoints never launched {n}")
        totals[n] = totals.get(n, 0) + c
    log(f"launcher {arch} (reduced, {' '.join(LAUNCHER_ARGS)}): {wall:.3f} s; saves at steps "
        f"{[st.step for st in out['ckpts']]}; restored step {step} with one host down, bit for "
        f"bit on the card; steps 6-8 redone with equal losses "
        f"({', '.join(f'{x:.6f}' for x in losses[5:8])}); launches {counts} ({card})")
    check_storage_kernels_at(f"launcher {arch}'s step-{step} save ({len(blobs[step])} bytes)",
                             host_tensor(blobs[step]).to("cuda"), (LAUNCHER_HOSTS,), card, worst,
                             k=LAUNCHER_HOSTS - LAUNCHER_PARITY, blocks=LAUNCHER_BLOCKS)


def drive_embed_training(seed: int, card: str, out_dir: Path) -> list[dict]:
    """``drive_family_training`` of each of EMBED_TRAIN_DEPTHS, with the
    allocator growing its segments in place (``expandable_segments``) for
    the phase: without it, qwen2-vl's (B, S, 152064) f32 logits and their
    gradient, 4.98 GB each, found no room among the split segments the
    layers left (29 GB reserved but unallocated at 9 layers), and the step
    ran out of memory."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return [drive_family_training(arch, seed, card, out_dir) for arch in EMBED_TRAIN_DEPTHS]
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def embed_train_card_vs_cpu(seed: int) -> None:
    """One train step of whisper-base and qwen2-vl-7b on the card against the
    CPU (``train_check``): the reduced configs at B=2 x 64 in bf16 at
    ``AdamWConfig()``'s lr, and one full-width layer (whisper: one encoder
    and one decoder layer) in f32 at B=1 x FAMILY_CHECK_S at lr TRAIN_LR,
    each held to the criteria."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.configs import get_arch

    for arch in EMBED_MODELS:
        if not train_check(get_arch(arch).reduced(), "reduced", 2, 64, 3e-4, seed, seed,
                           criteria=True):
            raise AssertionError(f"train card vs CPU: reduced {arch} in bf16 not held")
        full = get_arch(arch)
        cfg = dataclasses.replace(full, n_layers=1, encoder_layers=min(full.encoder_layers, 1),
                                  dtype="float32")
        if not train_check(cfg, "full width", 1, FAMILY_CHECK_S, TRAIN_LR, seed + 3, seed,
                           criteria=True):
            raise AssertionError(f"train card vs CPU: {arch} at full width in f32 not held")


def family_train_card_vs_cpu(seed: int) -> None:
    """One train step of the MoE, SSM and hybrid families on the card
    against the CPU (``train_check``): the reduced configs of olmoe-1b-7b,
    qwen3-moe-30b-a3b, mamba2-2.7b and zamba2-7b at B=2 x 64 in bf16 at
    ``AdamWConfig()``'s lr; and at full width in f32 (``dtype="float32"``,
    the bf16 weights upcast) at the fewest layers that hold each part, B=1 x
    FAMILY_CHECK_S at lr TRAIN_LR: olmoe and mamba2 at one layer, zamba2 at
    three (a group of two, the shared block, a trailing layer:
    ``FAMILY_CHECK_OVERRIDES``). The f32
    steps must hold: they are the precise witnesses of the bf16 ones
    (zamba2's with its 1-ulp share taken over all parameters: see below)."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.configs import get_arch

    for arch in ("olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b", "zamba2_7b"):
        train_check(get_arch(arch).reduced(), "reduced", 2, 64, 3e-4, seed, seed, criteria=True)
    for arch, layers in FAMILY_CHECK_LAYERS.items():
        over = FAMILY_CHECK_OVERRIDES.get(arch, {})
        if over:
            log(f"reduced: train card vs CPU {arch} full-width f32 step n_layers 7 -> {layers}, "
                + ", ".join(f"{k} {getattr(get_arch(arch), k)} -> {v}" for k, v in over.items())
                + " (the script's 1080 s with phase 14: a group of two Mamba2 layers, the "
                "shared block and a trailing layer, each part as seven layers held it)")
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers, dtype="float32", **over)
        # zamba2: shared.ln2 starts at 0 and its clipped gradients (global
        # norm ~2.2e3) sit near Adam's eps, where the f32 update follows the
        # gradient; the near-argmax shared attention moves the card's norm
        # 0.15 % from the CPU's (an H100's), so ~2.3 % of that leaf's updates land
        # more than a bf16 ulp of themselves apart (all within 3e-4 of
        # ulp + 2 lr): its 1-ulp share is held over all parameters
        if not train_check(cfg, "full width", 1, FAMILY_CHECK_S, TRAIN_LR, seed + 3, seed,
                           criteria=True, pooled=arch == "zamba2_7b"):
            raise AssertionError(f"train card vs CPU: {arch} at full width in f32 not held")


# ---------------------------------------------------------------- phase 8
ELASTIC = dict(hosts=8, parity=2, new_hosts=10, new_parity=3)  # whisper's resize
MESH_STEPS, MESH_WHISPER_STEPS = 3, 3
# the chunked cross-entropy of a mesh step takes S divisible by its 128-token
# chunks (the reference asserts it): whisper's published 448 is not, 384 is
MESH_WHISPER_TOKENS = 384


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _whole(tree):
    """A tree of DTensors gathered whole (plain leaves as they are)."""
    from repro_torch.models.sharding import whole
    from repro_torch.tree import tree_map

    return tree_map(whole, tree)


def drive_mesh(seed: int, card: str, out_dir: Path, totals: dict, worst: dict) -> dict:
    """The mesh layer on the card: ``make_host_mesh("cuda")``, the (data=1,
    model=1) mesh over an NCCL group of one rank (``mesh_qwen2``,
    ``mesh_whisper``). The group is destroyed on the way out."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import MeshCtx

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        ctx = MeshCtx(make_host_mesh("cuda"))
        log(f"mesh: {ctx.shape} over a {dist.get_backend()} group of {dist.get_world_size()} "
            f"rank; batch axes {ctx.batch_axes} ({card})")
        return {"qwen2": mesh_qwen2(ctx, seed, card, out_dir, totals),
                "whisper": mesh_whisper(ctx, seed, card, out_dir, totals, worst)}
    finally:
        dist.destroy_process_group()


def mesh_hold(ctx, cfg, batch: dict, seed: int, tag: str,
              pure_dp: bool | None = None) -> tuple[bool, str, dict]:
    """Step 1 of the sharded ``make_train_step(model, ctx)`` (parameters
    stored in the ZeRO layout of ``training_state_specs``; the chunked
    cross-entropy) against the unsharded step from the same weights (drawn
    on the card from ``seed``) and batch, held as ``hold_step`` decides from
    the unsharded step's own distance under a one-ulp nudge of every RMS
    norm (``norm_nudged``). Prints the distances; raises where a held step
    misses a criterion, or the loss differs by more than LOSS_ATOL. Returns
    (held, verdict, the sharded step's ``step_metrics``). ``pure_dp``
    overrides the model's (``LM.pure_dp``)."""
    import _torch_train_criteria as crit

    from repro_torch.models.registry import build_model
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step, training_state_specs

    model = build_model(cfg, max_pos=TRAIN_S, device="cuda")
    if pure_dp is not None:
        model.pure_dp = pure_dp
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    plain = make_train_step(model, None, opt_cfg)
    p1, o1, loss1 = plain(params, adamw_init(params), batch)
    nudged = []
    for to in (math.inf, -math.inf):
        with crit.norm_nudged(to):
            pn, on, _ = plain(params, adamw_init(params), batch)
        mn = crit.step_metrics(pn, on, p1, o1, TRAIN_LR)
        nudged.append((mn, None))
        log(f"{tag}: the unsharded step against itself with every RMS norm nudged "
            f"{'up' if to > 0 else 'down'}: {_step_summary(mn)}; the criteria "
            f"{'met' if crit.meets(mn) else 'missed: ill-conditioned'}")
        del pn, on
    pstore, ospecs = training_state_specs(model, ctx)
    p, o, loss = make_train_step(model, ctx, opt_cfg)(reshard_state(params, pstore),
                                                      reshard_state(adamw_init(params), ospecs),
                                                      batch)
    m = crit.step_metrics(_whole(p), _whole(o), p1, o1, TRAIN_LR)
    held, verdict, failures = crit.hold_step(m, nudged=nudged)
    log(f"{tag}: sharded step 1 against the unsharded step: loss {float(loss):.6f} / "
        f"{float(loss1):.6f} (|diff| {abs(float(loss) - float(loss1)):.3e}); {_step_summary(m)}; "
        f"the criteria {verdict}")
    if failures or abs(float(loss) - float(loss1)) > crit.LOSS_ATOL:
        raise AssertionError(f"{tag}: sharded step 1: {verdict}, but {failures}")
    return held, verdict, m


def _plain_steps(model, params, batches: list, tokens: int) -> str:
    """The unsharded ``make_train_step`` over ``batches`` from ``params``
    (the first a warm-up): its median train tokens/s and peak device
    memory, for the sharded steps' line."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    step = make_train_step(model, None, AdamWConfig(lr=TRAIN_LR))
    state, walls = (params, adamw_init(params)), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        t = time.perf_counter()
        p, o, loss = step(*state, batch)
        float(loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        state = (p, o)
    median = sorted(walls[1:])[len(walls[1:]) // 2]
    peak = torch.cuda.max_memory_allocated()
    del state, p, o
    return (f"{tokens / median:.1f} train tokens/s (median step {median:.4f} s of "
            f"{', '.join(f'{w:.4f}' for w in walls)}, the first a warm-up), peak {peak} bytes "
            f"({peak / 1e9:.3f} GB)")


def mesh_qwen2(ctx, seed: int, card: str, out_dir: Path, totals: dict) -> dict:
    """qwen2-0.5b at full width, B=TRAIN_B x TRAIN_S: step 1 of the sharded
    train step against the unsharded one (``mesh_hold``) at full depth in
    bf16, where the random weights leave it ill-conditioned (printed, as
    ``hold_step`` decides), and at one layer in f32, which must be held;
    MESH_STEPS sharded steps at full depth (train tokens/s, peak device
    memory), one more under ``torch.profiler`` (NCCL's kernels counted: none
    fails), then the sharded prefill of 4 x 2048 tokens, flash_attention
    counted from 0 (once per layer), against the unsharded prefill bit for
    bit."""
    import dataclasses
    import gc

    sys.path.insert(0, str(ROOT / "tests"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.registry import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_prefill_step, make_train_step, training_state_specs

    cfg = get_arch(MODEL)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                                  seed=seed))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in data.next_batch().items()}
               for _ in range(MESH_STEPS + 1)]
    mesh_hold(ctx, cfg, batches[0], seed, "mesh qwen2")
    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    log(f"reduced: n_layers {cfg.n_layers} -> 1, bfloat16 -> float32 (the held comparison: "
        f"one full-width layer in f32 is well-conditioned)")
    held, verdict, _ = mesh_hold(ctx, f32, batches[0], seed, "mesh qwen2 f32 1 layer")
    if not held:
        raise AssertionError(f"mesh qwen2 f32 1 layer: {verdict}")
    gc.collect()
    torch.cuda.empty_cache()

    model = build_model(cfg, max_pos=TRAIN_S, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    pstore, ospecs = training_state_specs(model, ctx)
    step = make_train_step(model, ctx, opt_cfg)
    state = (reshard_state(params, pstore), reshard_state(adamw_init(params), ospecs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(MESH_STEPS):
        t = time.perf_counter()
        p, o, loss = step(*state, batches[i])
        loss = float(loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if not np.isfinite(loss):
            raise AssertionError(f"mesh qwen2: sharded step {i + 1} loss {loss} is not finite")
        losses.append(loss)
        state = (p, o)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(walls)[len(walls) // 2]
    plain = _plain_steps(model, params, batches[:MESH_STEPS], TRAIN_B * TRAIN_S)
    log(f"mesh qwen2: {cfg.name} {model.n_params()} parameters ({cfg.n_layers} layers, full "
        f"width), B={TRAIN_B} x S={TRAIN_S}: {TRAIN_B * TRAIN_S / median:.1f} train tokens/s "
        f"(median sharded step {median:.4f} s of {', '.join(f'{w:.4f}' for w in walls)}); "
        f"losses {', '.join(f'{x:.6f}' for x in losses)}; peak device memory {peak} bytes "
        f"({peak / 1e9:.3f} GB); unsharded in this call: {plain} ({card})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        p, o, loss = step(*state, batches[MESH_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = device_busy(prof, out_dir / "mesh_qwen2_step_trace.json", wall,
                         "profile mesh qwen2 step:")
    # NCCL's kernels: named for it, or its one-rank reduce (a communicator of
    # one rank copies where it can, and launches onerank.cu's kernel for AVG)
    nccl: dict[str, int] = {}
    for ev in events:
        name = ev["name"]
        if ev.get("cat") == "kernel" and ("nccl" in name.lower() or "onerank" in name.lower()):
            short = re.sub(r".*(oneRankReduce\w*|nccl\w*).*", r"\1", name)[:60]
            nccl[short] = nccl.get(short, 0) + 1
    c10d: dict[str, int] = {}
    for ev in events:
        if ev.get("cat") == "cpu_op" and ev["name"].startswith("c10d::"):
            c10d[ev["name"]] = c10d.get(ev["name"], 0) + 1
    copies = sum(1 for ev in events if ev.get("cat") == "gpu_memcpy")
    log(f"mesh qwen2: profiled sharded step {wall:.4f} s: {sum(nccl.values())} NCCL kernels "
        f"({', '.join(f'{n} x{c}' for n, c in nccl.items())}); collectives "
        f"{', '.join(f'{n} x{c}' for n, c in c10d.items())}; {copies} device copies in the "
        f"step ({card})")
    if not nccl:
        raise AssertionError("mesh qwen2: the sharded step's profile shows no NCCL kernel")
    del state, p, o, prof, events
    gc.collect()
    torch.cuda.empty_cache()

    tokens = {"tokens": batches[0]["tokens"]}
    plain = make_prefill_step(model)(params, tokens)
    sharded = make_prefill_step(model, ctx)
    sharded(params, tokens)  # warm-up
    torch.cuda.synchronize()
    fa.launches = 0
    t = time.perf_counter()
    logits = sharded(params, tokens)
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t
    launches = fa.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"mesh qwen2: the sharded prefill launched flash_attention "
                             f"{launches} times, not {cfg.n_layers}")
    if not torch.equal(logits, plain):
        raise AssertionError("mesh qwen2: the sharded prefill differs from the unsharded one")
    totals["flash_attention"] = totals.get("flash_attention", 0) + launches
    log(f"mesh qwen2: sharded prefill {TRAIN_B} x {TRAIN_S}: {pre_wall:.4f} s, "
        f"{TRAIN_B * TRAIN_S / pre_wall:.1f} tokens/s, flash_attention launches {launches}; "
        f"logits equal the unsharded prefill's bit for bit ({card})")
    del model, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_per_s": TRAIN_B * TRAIN_S / median, "peak": peak,
            "nccl": sum(nccl.values())}


def mesh_whisper(ctx, seed: int, card: str, out_dir: Path, totals: dict, worst: dict) -> dict:
    """whisper-base at full width and depth (B=TRAIN_B x MESH_WHISPER_TOKENS
    on WHISPER_TRAIN_FRAMES audio frames, ``max_pos`` WHISPER_TOKENS, weights
    drawn on the card, the final norms drawn): MESH_WHISPER_STEPS sharded
    steps (the first a warm-up) beside the unsharded steps on the same
    batches, one more sharded step under ``torch.profiler``, then
    ``elastic_resize`` through ``ECCheckpointStore(device="cuda")`` from 8 hosts with parity 2
    to 10 with parity 3, the storage kernels counted from 0 (save, recon,
    restore GB/s; the restored state byte for byte the saved one), the
    storage kernels against their plain versions on the saved bytes at the
    two configurations' shapes, and a step from the restored state placed
    by ``reshard_state``, bit for bit the same step from the state before
    the save."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.device import host_tensor
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import ECCheckpointStore, serialize_tree
    from repro_torch.train.elastic import elastic_resize, reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step, training_state_specs
    from repro_torch.tree import named_leaves

    cfg = get_arch("whisper_base")
    model = build_model(cfg, max_pos=WHISPER_TOKENS, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    _encdec().draw_final_norms(params, seed + 9)
    log(f"reduced: whisper's decoder tokens {WHISPER_TOKENS} -> {MESH_WHISPER_TOKENS} (the "
        f"chunked cross-entropy of a mesh step takes multiples of 128, as the reference's)")
    batches = [{k: v[:, :MESH_WHISPER_TOKENS] if k != "audio_embeds" else v
                for k, v in whisper_inputs(TRAIN_B, seed + i, "cuda", frames=WHISPER_TRAIN_FRAMES,
                                           labels=True).items()}
               for i in range(MESH_WHISPER_STEPS + 1)]
    pstore, ospecs = training_state_specs(model, ctx)
    step = make_train_step(model, ctx, AdamWConfig(lr=TRAIN_LR))
    state = (reshard_state(params, pstore), reshard_state(adamw_init(params), ospecs))
    step_walls, losses = [], []
    for i in range(MESH_WHISPER_STEPS):
        t = time.perf_counter()
        p, o, loss = step(*state, batches[i])
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t)
        state = (p, o)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"mesh whisper: losses {losses}")
    median = sorted(step_walls[1:])[len(step_walls[1:]) // 2]
    tps = TRAIN_B * MESH_WHISPER_TOKENS / median
    plain = _plain_steps(model, params, batches[:MESH_WHISPER_STEPS],
                         TRAIN_B * MESH_WHISPER_TOKENS)
    log(f"mesh whisper: {cfg.name} {model.n_params()} parameters, B={TRAIN_B} x "
        f"{MESH_WHISPER_TOKENS} tokens on {WHISPER_TRAIN_FRAMES} frames: {tps:.1f} train "
        f"tokens/s (median sharded step {median:.4f} s of "
        f"{', '.join(f'{w:.4f}' for w in step_walls)}, the first a warm-up), losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; unsharded in this call: {plain} ({card})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, _, loss = step(*state, batches[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device_busy(prof, out_dir / "mesh_whisper_step_trace.json", wall,
                "profile mesh whisper step:")
    del prof

    saved = _whole({"params": state[0], "opt": state[1]})
    store = ECCheckpointStore(n_hosts=ELASTIC["hosts"], parity=ELASTIC["parity"], seed=seed,
                              device="cuda", coding_backend="kernel", min_block=MIN_BLOCK,
                              avg_block=AVG_BLOCK, max_block=MAX_BLOCK)
    timings = {}  # each store call's (wall, result) inside elastic_resize
    for name in ("save", "reconfigure", "restore"):
        def timed(*a, _f=getattr(store, name), _n=name, **kw):
            t = time.perf_counter()
            out = _f(*a, **kw)
            torch.cuda.synchronize()
            timings[_n] = (time.perf_counter() - t, out)
            return out
        setattr(store, name, timed)
    torch.cuda.synchronize()
    cdc.launches = 0
    gf.launches = 0
    rstep, rstate, moved = elastic_resize(store, {"params": state[0], "opt": state[1]},
                                          MESH_WHISPER_STEPS, new_hosts=ELASTIC["new_hosts"],
                                          new_parity=ELASTIC["new_parity"])
    counts = {"cdc_gearhash": cdc.launches, "gf256_matmul": gf.launches}
    for name, c in counts.items():
        if not c:
            raise AssertionError(f"mesh whisper: the elastic resize never launched {name}")
        totals[name] = totals.get(name, 0) + c
    if rstep != MESH_WHISPER_STEPS or store.dss.net.stuck_ops():
        raise AssertionError(f"mesh whisper: restored step {rstep}, stuck "
                             f"{store.dss.net.stuck_ops()}")
    _same_state(rstate, saved, "mesh whisper elastic restore")
    st = timings["save"][1]
    gb = st.bytes_written / 1e9
    log(f"mesh whisper: elastic resize {ELASTIC['hosts']} hosts parity {ELASTIC['parity']} -> "
        f"{ELASTIC['new_hosts']} parity {ELASTIC['new_parity']} of the {st.bytes_written}-byte "
        f"state ({st.blocks_written} blocks): save {timings['save'][0]:.3f} s "
        f"({gb / timings['save'][0]:.4f} GB/s), recon {timings['reconfigure'][0]:.3f} s "
        f"({gb / timings['reconfigure'][0]:.4f} GB/s, {moved} blocks moved), restore "
        f"{timings['restore'][0]:.3f} s ({gb / timings['restore'][0]:.4f} GB/s); launches "
        f"cdc_gearhash {counts['cdc_gearhash']} gf256_matmul {counts['gf256_matmul']}; the "
        f"restored state equals the saved one byte for byte ({card})")
    del store
    blob = serialize_tree({"step": MESH_WHISPER_STEPS, "state": saved})
    data = host_tensor(blob).to("cuda")
    del blob
    label = f"whisper's elastic state ({data.numel()} bytes)"
    for n, k in ((ELASTIC["hosts"], ELASTIC["hosts"] - ELASTIC["parity"]),
                 (ELASTIC["new_hosts"], ELASTIC["new_hosts"] - ELASTIC["new_parity"])):
        check_storage_kernels_at(f"{label}, k={k}", data, (n,), card, worst, k=k)
    del data

    specs = {"params": pstore, "opt": ospecs}
    runs = []
    for whole in (rstate, saved):
        placed = reshard_state(whole, specs)
        p, o, loss = step(placed["params"], placed["opt"], batches[-1])
        runs.append((float(loss), _whole({"params": p, "opt": o})))
    (la, after), (lb, before) = runs
    for (na, a), (nb, b) in zip(named_leaves(after), named_leaves(before)):
        if na != nb or not torch.equal(a, b):
            raise AssertionError(f"mesh whisper: the step after the restore differs at {na}")
    if la != lb:
        raise AssertionError(f"mesh whisper: the step after the restore: loss {la} != {lb}")
    log(f"mesh whisper: the step after the restore (loss {la:.6f}) equals the same step from "
        f"the state before the save bit for bit ({card})")
    del model, params, state, saved, rstate, runs, after, before
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_per_s": tps, "save_gb_s": gb / timings["save"][0],
            "recon_gb_s": gb / timings["reconfigure"][0],
            "restore_gb_s": gb / timings["restore"][0]}


# ---------------------------------------------------------------- phase 9
# tensor and expert parallelism over "model" on the (data=1, model=2) mesh of
# the reference's own slice, as two processes that share the one card over
# gloo (make_shared_card_mesh: NCCL refuses two ranks on one GPU). Their
# times are two ranks time-sharing one card, not tensor-parallel scaling.
TP_MESH = (1, 2)
TP_ARCHS = ("qwen2_0_5b", "olmoe_1b_7b", "mamba2_2_7b", "zamba2_7b", "qwen2_vl_7b",
            "whisper_base")
# one timed train step after the warm-up in phases 9 and 10 (phase 9 timed
# two until its prefills were timed three times: the script's 900 s), and
# 4 decode steps (32 before phase 11 came, 16 before phase 12's and the
# three timed prefills, 8 before phase 14's: a reduced: line)
TP_DECODE_STEPS, TP_TRAIN_STEPS, TP_CACHE = 4, 1, 2048
# the serving warm-up's prefill: PREFILL_B x this many tokens (whisper's
# whole batch), which loads every kernel and collective the counted
# prefill runs; the whole prefill took zamba2 23.5 s over gloo
TP_WARMUP_S = 256
# the counted prefills after the warm-up in every phase of ranks, timed by
# their median: one run is not a stable number among processes sharing the
# card (phase 12's three spread from 6.63 to 12.50 s in one run)
TP_PREFILL_RUNS = 3
# serving depth on the two ranks where it is cut (a reduced: line each): PR
# 22's three archs, served there at full depth, so that the script with this
# phase's other families meets its time (the depth's cost is linear)
TP_SERVE_DEPTHS = {"qwen2_0_5b": 4, "olmoe_1b_7b": 2, "mamba2_2_7b": 4, "zamba2_7b": 7,
                   "qwen2_vl_7b": 4}
_SHALLOW_CUT = ("the script's 1200 s: these three were at full depth in the slice that ported them")
TP_SERVE_CUTS = {
    "qwen2_0_5b": _SHALLOW_CUT, "olmoe_1b_7b": _SHALLOW_CUT, "mamba2_2_7b": _SHALLOW_CUT,
    # one group of six Mamba2 layers with the shared block, and a trailing
    # layer: at 81 layers its serving took ~60 s of phase 9
    "zamba2_7b": "the script's 900 s with phases 10 and 11: at full depth (81 layers) its "
                 "sharded prefill took 30.0 s and 32 decode steps ~22 s; at 13, 3.6 and 4.5 s",
    "qwen2_vl_7b": "the script's 900 s with phases 10 and 11: at full depth (28 layers) its "
                   "sharded prefill took 14.8 s and 32 decode steps 12.8 s",
}
# training depth on the two ranks, and why it is cut (a reduced: line each).
# Memory would allow olmoe 5 layers (34.0 GB a rank, 38.6 reserved) and
# mamba2 44 (30.6 GB a rank, 36.2 reserved) on an H100, but with them the
# whole script ran 1240.8 s of its 1200 s on a slow host (phase 9 329.1 s):
# olmoe took 8.5 s a step there and mamba2 0.51 s a layer a step
TP_TRAIN_DEPTHS = {"qwen2_0_5b": 2, "olmoe_1b_7b": 1, "mamba2_2_7b": 2, "zamba2_7b": 7,
                   "qwen2_vl_7b": 1, "whisper_base": 6}
TP_TRAIN_CUTS = {
    "qwen2_0_5b": "the script's 1200 s: a 24-layer step took 9.4 s on the two ranks; 4 layers "
                  "until the script's 1080 s with phase 14",
    "olmoe_1b_7b": "the script's 1200 s: a 4-layer step took 7.4 s on the two ranks; memory "
                   "would allow 5 layers; 2 layers until the script's 1080 s with phase 14",
    "mamba2_2_7b": "the script's 1200 s: a step took 0.47 s a layer on the two ranks; memory "
                   "would allow 44 layers",
    "zamba2_7b": "the script's 1200 s: one group of 6 Mamba2 layers, the shared block and one "
                 "trailing layer",
    "qwen2_vl_7b": "the script's 1200 s: a 4-layer step took 9.3 s on the two ranks; 2 layers "
                   "until the script's 1080 s with phase 14",
}
TP_RANK_TIMEOUT = 720
# the f32 witness of the sharded serving math at full width (``tp_shallow``):
# the ranks' partial sums add the row-parallel products in another order
# (``tp_rounding``), and cuBLAS may sum a column-parallel product on a
# rank's block of columns in another order than on the whole (``tp_columns``;
# in f32, nearly every element of qwen2-vl-7b's q projection on 1792 of its
# 3584 columns: ``column_bits``); both move f32 logits by ~1e-6 of their
# largest, a wrong head, channel, expert or vocab block by far more. The
# twin, the unsharded run computed as the ranks compute it (both emulated),
# must lie within the tolerance of the sharded run at every check, and the
# sharded run within it of the plain unsharded run wherever the twin is: a
# model that carries those last bits past the tolerance (ill-conditioned)
# is held to its twin alone. The reference keeps the Mamba2 conv window in
# bf16 even in an f32 model: where an input sits at a bf16 rounding
# boundary, ~1e-7 moves it by a bf16 ulp, which the next decode steps carry
# to ~1e-4 of the logits, and the ranks' in-projections (other shapes, not
# emulated) move it as the twin does not. So those steps are printed with
# the window's flips counted, and the SSM decode is held again, every step,
# with its window in f32. zamba2 is checked at 2 layers, its Mamba2 layers'
# widths: at 7 (its shared block follows the 6th) the rounded f32 run moved
# 1.1e-4-1.1e-3 from the plain one, the prefill included (ill-conditioned)
TP_SHALLOW_LAYERS, TP_SHALLOW_STEPS, TP_WITNESS_RTOL = 2, 4, 1e-4
# what the sharded bf16 serving equals bit for bit: the unsharded run under
# ``tp_rounding`` (each row-parallel product as the ranks' rounded partial
# sums). Not mamba2 and zamba2, whose conv, SSD and norm sums also run on
# other shapes, not the MoE prefill, whose emulated exchange
# (``ep_emulated``) runs the expert products on other shapes, and not
# qwen2-vl's decode at full depth, which flipped a rounding at some step
# (its 2-layer decode is equal)
TP_EXACT = {"qwen2_0_5b": ("prefill", "decode"), "olmoe_1b_7b": ("decode",),
            "qwen2_vl_7b": ("prefill",)}
# one rank's flash shapes at model=2: qwen2-0.5b's 7 heads on its one KV head
# (GQA 7 at hd 64), olmoe-1b-7b's 8 heads on 8 KV heads at hd 128, zamba2-7b's
# shared block's 16 heads at hd 112, qwen2-vl-7b's 14 heads on 2 KV heads at
# hd 128, whisper-base's 4 heads at its published context: the encoder
# (non-causal), the decoder (causal) and the cross-attention
TP_FLASH_CASES = (
    ("qwen2 model=2 rank", PREFILL_B, 7, 1, PREFILL_S, PREFILL_S, 64, True, 0, torch.bfloat16,
     1.0),
    ("olmoe model=2 rank", PREFILL_B, 8, 8, PREFILL_S, PREFILL_S, 128, True, 0, torch.bfloat16,
     1.0),
    ("zamba2 model=2 rank", PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 112, True, 0,
     torch.bfloat16, 1.0),
    ("qwen2-vl model=2 rank", PREFILL_B, 14, 2, PREFILL_S, PREFILL_S, 128, True, 0,
     torch.bfloat16, 1.0),
    ("whisper encoder model=2 rank", PREFILL_B, 4, 4, WHISPER_FRAMES, WHISPER_FRAMES, 64, False,
     0, torch.bfloat16, 1.0),
    ("whisper decoder model=2 rank", PREFILL_B, 4, 4, WHISPER_TOKENS, WHISPER_TOKENS, 64, True, 0,
     torch.bfloat16, 1.0),
    ("whisper cross model=2 rank", PREFILL_B, 4, 4, WHISPER_TOKENS, WHISPER_FRAMES, 64, False, 0,
     torch.bfloat16, 1.0),
)
# whisper-base's own serve step (the pure data-parallel model: its prefill
# data-parallel over both axes, its decode tensor-parallel on the serve
# specs, as the reference's serve step runs it), beside the same model with
# tensor parallelism forced (``pure_dp = False``) under its own name
WHISPER_SERVE_STEP = "whisper_base serve step"

# ---------------------------------------------------------------- phase 10
# the fallback layouts of tensor parallelism over "model": qwen2-0.5b's 14
# heads (2 KV heads) do not divide model=4, so the reference shards their
# head_dim (64 = 4 x 16); its d_ff (4864) and vocab (151936) divide. Four
# processes share the card over gloo, as in phase 9. A rank attends with its
# block of 512 of the 2048 queries at its offset (flash's ``q_offset``)
# against the whole sequence's keys: rank r's causal rows reach r + 1 times
# the keys of rank 0's, timed here beside SDPA (an explicit mask: its
# ``is_causal`` cannot offset)
FB_MESH = (1, 4)
FB_ARCHS = ("qwen2_0_5b",)
FB_FLASH_CASES = tuple(
    (f"qwen2 model=4 rank {r} (q_offset {r * PREFILL_S // 4})", PREFILL_B, 14, 2, PREFILL_S // 4,
     PREFILL_S, 64, True, 0, torch.bfloat16, 1.0, r * PREFILL_S // 4) for r in range(4))
FB_TRAIN_DEPTHS = {"qwen2_0_5b": 2}
FB_TRAIN_CUTS = {"qwen2_0_5b": "phase 10's 120 s, 4 layers until the script's 1080 s with "
                               "phase 14: phase 9 trains qwen2 at 2 layers too"}
# what the sharded bf16 serving equals bit for bit: the unsharded run under
# ``tp_rounding(4)``, which models the fallback's roundings (none of its own
# in the prefill; the decode's head_dim partial scores and out-projection)
FB_EXACT = {"qwen2_0_5b": ("prefill", "decode")}
# the f32 held train step's tokens a row on model=4: every rank runs the
# unsharded step and its two nudged twins too (``mesh_hold``), and four f32
# (4, 2048, 151936) logits ran the card out of memory
FB_HOLD_TOKENS = 512


# ---------------------------------------------------------------- phase 11
# sequence sharding for serving: the reference's ``long_500k`` layout (B = 1,
# which does not fill the batch axes, so the sequence is sharded over them:
# ``token_spec``, ``cache_specs``), run by the sub-quadratic archs that its
# ``launch/dryrun.py`` runs that shape for. Two processes share the card over
# gloo on (data=2, model=1): each holds one half of the sequence, gathers the
# keys of the other for every attention layer, and relays the SSM state
# from rank 0 to rank 1 for every Mamba2 layer. A rank's prefill attends its
# 16384 queries at its offset (flash's ``q_offset``) against all 32768 keys:
# gemma3-1b's hd 256 with GQA 4:1, its local layers' 512-key window and its
# global layers' none, held and timed here at both offsets
SEQ_MESH = (2, 1)
SEQ_ARCHS = ("gemma3_1b", "mamba2_2_7b", "zamba2_7b")
SEQ_S, SEQ_CACHE, SEQ_STEPS = 32768, 524288, 4  # the prefill; long_500k's cache
SEQ_WARMUP_S = 2048  # the warm-up prefill's tokens (16 Mamba2 chunks a rank)
# serving depth where cut (a reduced: line each)
SEQ_DEPTHS = {"mamba2_2_7b": 32, "zamba2_7b": 7}
SEQ_CUTS = {"zamba2_7b": "one card's 80 GB: its 524288-long cache is 97.7 GB at 81 layers (27 "
                         "shared-block groups); 13 layers (two groups of six Mamba2 layers, "
                         "each with the shared block, and a trailing layer) until the script's "
                         "1080 s with phase 14: one group and a trailing layer, as in phase 9",
            "mamba2_2_7b": "the script's 1080 s with phase 14: its four prefills of 32768 tokens "
                           "at 64 layers took ~13 s over gloo"}
# the 2-layer checks (zamba2 at 7: one group and the shared block, and a
# trailing layer): prefill 1 x SEQ_SHALLOW_S, SEQ_SHALLOW_STEPS decode steps
# against a SEQ_SHALLOW_CACHE-long cache from two positions before the
# ranks' seam, bf16 and f32 (its K/V cache and score chain in f32 too)
SEQ_SHALLOW_LAYERS = {"gemma3_1b": 2, "mamba2_2_7b": 2, "zamba2_7b": 7}
SEQ_SHALLOW_S, SEQ_SHALLOW_CACHE, SEQ_SHALLOW_STEPS = 4096, 8192, 4
SEQ_FLASH_CASES = tuple(
    (f"gemma3 sequence rank {r} {'window 512' if w else 'global'} (q_offset {r * SEQ_S // 2})",
     1, 4, 1, SEQ_S // 2, SEQ_S, 256, True, w, torch.bfloat16, 1.0, r * SEQ_S // 2)
    for w in (512, 0) for r in range(SEQ_MESH[0]))
# sequence-sharded training (``seq_train``, phases 11 and 12): one step of B =
# 1 x SEQ_TRAIN_S tokens (a rank block of 4096: whole SSM chunks and whole
# q_chunks of the training attention), at full width and these depths (a
# reduced: line each), held on rank 0 against the one-process step from the
# same weights, and an f32 witness at SEQ_WITNESS_LAYERS layers whose every
# gradient leaf lies within TP_WITNESS_RTOL of the one-process f32 step's
SEQ_TRAIN_S, SEQ_WITNESS_LAYERS = 8192, 2
# the witness's two layers hold each kind of layer the step runs: gemma3's one
# window-512 layer and one global (every other layer global), zamba2's two
# Mamba2 layers and the shared block after them (the loss must read every
# leaf)
SEQ_WITNESS_OVERRIDES = {"gemma3_1b": {"global_every": 2}, "zamba2_7b": {"shared_attn_every": 2},
                         "whisper_base": {"encoder_layers": 2}}
SEQ_TRAIN_DEPTHS = {"gemma3_1b": 2, "mamba2_2_7b": 2, "zamba2_7b": 3}
# gemma3's two layers: one window-512 layer and one global, as its witness's;
# zamba2's three: a group of two Mamba2 layers, the shared block and a
# trailing layer
SEQ_TRAIN_OVERRIDES = {"gemma3_1b": {"global_every": 2}, "zamba2_7b": {"shared_attn_every": 2}}
SEQ_TRAIN_CUTS = {
    "gemma3_1b": "the script's 1200 s, six layers (five window-512 and one global) until "
                 "the script's 1080 s with phase 14: one of each",
    "mamba2_2_7b": "the script's 1200 s, eight layers (as phase 7b trains it) until the "
                   "script's 1080 s with phase 14",
    "zamba2_7b": "the script's 1200 s, seven layers (a group of six Mamba2 layers, the shared "
                 "block and a trailing layer, as phase 7b trains it) until the script's 1080 s "
                 "with phase 14: each part once",
}

# ---------------------------------------------------------------- phase 12
# sequence sharding composed with a fallback layout over "model": the
# reference's ``long_500k`` layout (B = 1 on the batch axes) where the heads
# do not divide "model", as gemma3-1b's 4 heads on the production meshes'
# model=16 (which takes 16 processes a sequence rank: gemma3 falls back only
# at model >= 8), run here by qwen2-0.5b, whose 14 heads do not divide
# model=4 (head_dim 64 sharded, 16 a rank; its d_ff and vocab divide:
# Megatron-SP's MLP, the vocab-parallel head). Eight processes share the card
# over gloo on (data=2, model=4): a rank holds 4096 rows of the 32768, the
# queries of its (sequence, model) block, at q_offset seq_rank * 16384 +
# model_rank * 4096 against all 32768 keys (its sequence rank's K/V gathered
# over "model" and then over the batch axes), and its head_dim block of its
# sequence block of the 524288-long cache (0.8 GB of K/V a rank)
SF_MESH = (2, 4)
SF_ARCHS = ("qwen2_0_5b",)
SF_FLASH_CASES = tuple(
    (f"qwen2 (sequence, model) rank ({r // SF_MESH[1]}, {r % SF_MESH[1]}) "
     f"(q_offset {r * SEQ_S // 8})", 1, 14, 2, SEQ_S // 8, SEQ_S, 64, True, 0, torch.bfloat16, 1.0,
     r * SEQ_S // 8) for r in range(math.prod(SF_MESH)))
SF_SHALLOW_LAYERS = {"qwen2_0_5b": 2}
# phase 12's decode steps, cut from SEQ_STEPS for the script's time with
# phases 11 and 12's training (a reduced: line)
SF_STEPS = 2
SF_TRAIN_DEPTHS = {"qwen2_0_5b": 2}
SF_TRAIN_CUTS = {"qwen2_0_5b": "the script's 1200 s, 4 layers until the script's 1080 s with "
                               "phase 14: phases 9 and 10 train qwen2 at 2 layers too"}

# ---------------------------------------------------------------- phase 14
# sequence sharding for the MoE, VLM and encoder-decoder families: one
# request of each at its published context, B = 1, on (data=2, model=1),
# two processes sharing the card, each holding its half of the sequence:
# olmoe-1b-7b's 4096 tokens (its MoE layers route the whole sequence on
# each rank, the reference's capacity and dispatch order), qwen2-vl-7b's
# 32768 embeddings with their M-RoPE positions, whisper-base's 1500 frames
# and 448 tokens (its encoder's output gathered once for every
# cross-attention; its decode on each rank's half of both caches)
FAM_MESH = (2, 1)
FAM_ARCHS = ("olmoe_1b_7b", "qwen2_vl_7b", "whisper_base")
# the prefill's tokens and the decode cache's length, and the first decode
# position: the first rank's last slot (whisper's from WHISPER_TOKENS)
FAM_SERVE = {"olmoe_1b_7b": dict(S=4096, cache_len=4096, first=2047),
             "qwen2_vl_7b": dict(S=32768, cache_len=32768, first=16383),
             "whisper_base": dict(S=WHISPER_TOKENS, first=WHISPER_TOKENS // 2 - 1)}
FAM_STEPS = 4
FAM_SERVE_DEPTHS = {"olmoe_1b_7b": 4, "qwen2_vl_7b": 4}
FAM_SERVE_CUTS = {
    "olmoe_1b_7b": "phase 14's 120 s: every rank runs the whole sequence's MoE layer",
    "qwen2_vl_7b": "phase 14's 120 s: its 32768-token prefill and cache at 28 layers",
}
# whisper-base runs as the pure data-parallel model it is (the reference's
# layout; on model = 1 its steps are the same either way)
FAM_OWN_LAYOUT = ("whisper_base",)
# one timed sequence-sharded train step each: B = 1 x these tokens (whisper
# on WHISPER_TRAIN_FRAMES frames: the training attention's q_chunk, and the
# mesh's chunked cross-entropy's 128)
FAM_TRAIN_S = {"olmoe_1b_7b": 4096, "qwen2_vl_7b": 8192, "whisper_base": MESH_WHISPER_TOKENS}
FAM_TRAIN_DEPTHS = {"olmoe_1b_7b": 2, "qwen2_vl_7b": 2, "whisper_base": 6}
# the f32 witness's tokens where fewer than the step's (a reduced: line):
# its one-process f32 steps and probes run on rank 0 alone
FAM_WITNESS_S = {"olmoe_1b_7b": 2048, "qwen2_vl_7b": 2048}
FAM_TRAIN_CUTS = {"olmoe_1b_7b": "phase 14's 120 s, as phase 7b trains it",
                  "qwen2_vl_7b": "phase 14's 120 s: a step of 8192 tokens at full width"}
# each sequence rank's flash blocks: olmoe's 16 heads at hd 128 (no GQA),
# qwen2-vl's 28 heads on 4 KV heads (GQA 7) at hd 128, whisper's encoder
# (non-causal, which reads no offset), decoder (causal) and cross-attention
# (its queries against all the frames, at no offset)
FAM_FLASH_CASES = tuple(
    (f"{name} sequence rank {r} (q_offset {r * Sq})", 1, H, Hkv, Sq, Sk, hd, causal, 0,
     torch.bfloat16, 1.0, r * Sq)
    for name, H, Hkv, Sq, Sk, hd, causal in (
        ("olmoe", 16, 16, 2048, 4096, 128, True), ("qwen2-vl", 28, 4, 16384, 32768, 128, True),
        ("whisper encoder", 8, 8, WHISPER_FRAMES // 2, WHISPER_FRAMES, 64, False),
        ("whisper decoder", 8, 8, WHISPER_TOKENS // 2, WHISPER_TOKENS, 64, True))
    for r in range(FAM_MESH[0])) + (
    ("whisper cross sequence rank block", 1, 8, 8, WHISPER_TOKENS // 2, WHISPER_FRAMES, 64,
     False, 0, torch.bfloat16, 1.0, 0),)

# each phase of ranks sharing the card: its mesh, archs, depths (where cut,
# with the reason), flash shapes, what its serving equals bit for bit, and
# its serving's shapes (``tp_serve``, ``tp_shallow``): B rows of S tokens, a
# warm-up prefill of warmup_s tokens, ``steps`` decode steps from position
# ``first`` against a cache_len-long cache (whisper's WHISPER_TOKENS), drawn
# before ``first`` where ``drawn`` (``_seq_cache``), else from zero, the
# serve step warmed up on one warm[0] long at warm[1], and under ``arch`` each
# arch's own S, cache_len and first where they differ. ``offsets`` names
# the two flash cases whose device times its summary line compares, and why;
# ``staged`` what crosses gloo through host memory; ``shallow`` None runs no
# shallow checks; ``own_layout`` the archs run only as their own pure_dp
# says; ``train_s`` each arch's sequence-sharded train tokens where not
# SEQ_TRAIN_S
# phases 10 and 12 serve qwen2-0.5b at half its depth (a reduced: line): their
# four and eight processes share the card over gloo, where a prefill of 1 x
# 32768 tokens took 9 s at 24 layers
QWEN2_HALF = {"qwen2_0_5b": 12}
QWEN2_HALF_CUT = {"qwen2_0_5b": "the script's 1080 s with phase 14: its prefills over four "
                                "and eight processes sharing the card cost linearly in the depth"}
TP_SERVE = dict(B=PREFILL_B, S=PREFILL_S, warmup_s=TP_WARMUP_S, steps=TP_DECODE_STEPS,
                cache_len=TP_CACHE, first=0, warm=(TP_CACHE, 0), drawn=False)
TP_SHALLOW = dict(TP_SERVE, steps=TP_SHALLOW_STEPS)
_TP_DECODE_CUT = ("32 -> 4 (the script's 900 s with phases 11 and 12: 8; the script's 1080 s "
                  "with phase 14: 4)")
TP_PHASES = {
    9: dict(mesh=TP_MESH, archs=TP_ARCHS, serve_depths=TP_SERVE_DEPTHS, serve_cuts=TP_SERVE_CUTS,
            train_depths=TP_TRAIN_DEPTHS, train_cuts=TP_TRAIN_CUTS,
            flash=TP_FLASH_CASES, exact=TP_EXACT, hold_tokens=TRAIN_S, serve=TP_SERVE,
            decode_cut=_TP_DECODE_CUT, shallow=TP_SHALLOW, shallow_depths={}, offsets=None,
            staged="nothing"),
    10: dict(mesh=FB_MESH, archs=FB_ARCHS, serve_depths=QWEN2_HALF, serve_cuts=QWEN2_HALF_CUT,
             train_depths=FB_TRAIN_DEPTHS, train_cuts=FB_TRAIN_CUTS,
             flash=FB_FLASH_CASES, exact=FB_EXACT, hold_tokens=FB_HOLD_TOKENS, serve=TP_SERVE,
             decode_cut=_TP_DECODE_CUT, shallow=TP_SHALLOW, shallow_depths={},
             offsets=(0, 3, "the causal load imbalance: its rows reach 4x the keys"),
             staged="nothing"),
    11: dict(mesh=SEQ_MESH, archs=SEQ_ARCHS, serve_depths=SEQ_DEPTHS, serve_cuts=SEQ_CUTS,
             train_depths=SEQ_TRAIN_DEPTHS, train_cuts=SEQ_TRAIN_CUTS, seq_train=True,
             flash=SEQ_FLASH_CASES,
             exact={a: ("prefill", "decode") for a in SEQ_ARCHS},
             serve=dict(B=1, S=SEQ_S, warmup_s=SEQ_WARMUP_S, steps=SEQ_STEPS, cache_len=SEQ_CACHE,
                        first=SEQ_CACHE - 2 * SEQ_STEPS, warm=(2 * SEQ_WARMUP_S, SEQ_WARMUP_S - 1),
                        drawn=True),
             train_overrides=SEQ_TRAIN_OVERRIDES,
             decode_cut="8 -> {} (the script's 1080 s with phase 14)".format(SEQ_STEPS),
             shallow=dict(B=1, S=SEQ_SHALLOW_S, steps=SEQ_SHALLOW_STEPS,
                          cache_len=SEQ_SHALLOW_CACHE, first=SEQ_SHALLOW_CACHE // 2 - 2,
                          drawn=True),
             shallow_depths=SEQ_SHALLOW_LAYERS,
             offsets=(2, 3, "the global layers: rank 1's rows reach 3x the causal pairs"),
             staged="the relays' states (gloo's send and receive)"),
    12: dict(mesh=SF_MESH, archs=SF_ARCHS, serve_depths=QWEN2_HALF, serve_cuts=QWEN2_HALF_CUT,
             train_depths=SF_TRAIN_DEPTHS, train_cuts=SF_TRAIN_CUTS, seq_train=True,
             flash=SF_FLASH_CASES, exact={a: ("prefill", "decode") for a in SF_ARCHS},
             serve=dict(B=1, S=SEQ_S, warmup_s=SEQ_WARMUP_S, steps=SF_STEPS, cache_len=SEQ_CACHE,
                        first=SEQ_CACHE - 2 * SEQ_STEPS, warm=(2 * SEQ_WARMUP_S, SEQ_WARMUP_S - 1),
                        drawn=True),
             decode_cut=f"8 -> {SF_STEPS} (the script's 1200 s with phases 11 and 12's "
                        f"training: its 8 steps took 28.1 s; 4 until the script's 1080 s "
                        f"with phase 14)",
             shallow=dict(B=1, S=SEQ_SHALLOW_S, steps=SEQ_SHALLOW_STEPS,
                          cache_len=SEQ_SHALLOW_CACHE, first=SEQ_SHALLOW_CACHE // 2 - 2,
                          drawn=True),
             shallow_depths=SF_SHALLOW_LAYERS,
             offsets=(0, 7, "the causal load imbalance: rank 7's rows reach ~15x rank 0's "
                            "causal pairs"),
             staged="nothing"),
    14: dict(mesh=FAM_MESH, archs=FAM_ARCHS, serve_depths=FAM_SERVE_DEPTHS,
             serve_cuts=FAM_SERVE_CUTS, train_depths=FAM_TRAIN_DEPTHS,
             train_cuts=FAM_TRAIN_CUTS, seq_train=True, train_s=FAM_TRAIN_S,
             witness_s=FAM_WITNESS_S,
             own_layout=FAM_OWN_LAYOUT, flash=FAM_FLASH_CASES,
             exact={a: ("prefill", "decode") for a in FAM_ARCHS},
             serve=dict(B=1, warmup_s=SEQ_WARMUP_S, steps=FAM_STEPS, drawn=True,
                        warm=(2 * SEQ_WARMUP_S, SEQ_WARMUP_S - 1), arch=FAM_SERVE),
             decode_cut=None, shallow=None, shallow_depths={},
             offsets=(2, 3, "the causal load imbalance of qwen2-vl's rank blocks: rank 1's "
                            "rows reach 3x the causal pairs"),
             staged="nothing"),
}


def _seq_cache(model, B: int, length: int, first: int, seed: int, cross: dict | None,
               ctx=None, f32: tuple = (), *, blocks: int) -> dict:
    """A one-row (``B`` = 1) decode cache ``length`` long: K/V drawn from
    ``seed`` at the positions before ``first`` (zeros from it), each of its
    ``blocks`` sequence blocks (the batch axes' ranks) from a generator of
    its own, layer by layer, so that the whole cache is its blocks'
    concatenation; the encoder-decoder's cross K/V likewise, as many frames
    as ``cross`` holds (every frame drawn); the conv and SSM caches
    (replicated over the batch axes) drawn, times 0.1. With ``ctx``, this
    rank's blocks as DTensors laid out as ``cache_specs`` (its block of each
    dim they put on "model": head_dim in the fallback layout); else the
    whole cache. The entries named in ``f32`` in f32 (the same values)."""
    from torch.distributed.tensor import DTensor

    assert B == 1
    out = {}
    for j, (name, (shape, dtype)) in enumerate(sorted(model.cache_template(1, length).items())):
        dtype = torch.float32 if name in f32 else dtype
        if name in ("k", "v", "xk", "xv"):
            n = cross[name].shape[2] if name in ("xk", "xv") else length
            upto = n if name in ("xk", "xv") else first
            block = n // blocks
            ranks = [ctx.seq_rank] if ctx is not None else range(blocks)
            val = torch.zeros((shape[0], 1, block * len(ranks), *shape[3:]), device="cuda",
                              dtype=dtype)
            for i, r in enumerate(ranks):
                g = torch.Generator(device="cuda").manual_seed(seed * 7919 + 16 * r + j)
                for layer in range(shape[0]):
                    val[layer, :, i * block:(i + 1) * block] = torch.randn(
                        (1, block, *shape[3:]), generator=g, device="cuda", dtype=torch.bfloat16)
                start = r * block
                if upto < start + block:
                    val[:, :, i * block + max(upto - start, 0):(i + 1) * block] = 0
        else:
            g = torch.Generator(device="cuda").manual_seed(seed * 7919 + 1000 + j)
            val = (torch.randn(shape, generator=g, device="cuda") * 0.1).to(dtype)
        out[name] = val
    if ctx is None:
        return out
    specs, n = model.cache_specs(1, length, ctx), ctx.n_model
    for name, val in out.items():
        for d, entry in enumerate(specs[name].spec):
            if entry == "model" or isinstance(entry, tuple) and "model" in entry:
                size = val.shape[d] // n
                val = val.narrow(d, ctx.model_rank * size, size).contiguous()
        out[name] = val
    return {k: DTensor.from_local(v, ctx.device_mesh(), specs[k].placements, run_check=False)
            for k, v in out.items()}


def drive_tp(seed: int, card: str, out_dir: Path, totals: dict, worst: dict,
             phase: int = 9) -> dict:
    """Phase 9, 10, 11, 12 or 14 (``TP_PHASES``): the flash kernel against its plain
    version at one rank's shapes (at its query offset where it has one,
    ``hold_flash_offset``), and timed there; then the ranks (this script with ``--tp-rank``), which
    meet through a ``file://`` rendezvous in a fresh directory. A rank that
    fails, or outlasts TP_RANK_TIMEOUT, ends the others and fails the run;
    the other ranks' output is printed where it fails. Adds each rank's
    counted flash launches to ``totals``."""
    import shutil

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    ph = TP_PHASES[phase]
    rng = np.random.default_rng(seed + phase)
    offset_ms = []
    for case in ph["flash"]:
        label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, _, *offset = case
        off = offset[0] if offset else 0
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
                   for s in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
        if offset:
            err = hold_flash_offset(label, q, k, v, causal, window, off)
        else:
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            if not err <= FLASH_TOL[dtype] or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention {label}: max |err| {err} > "
                                     f"{FLASH_TOL[dtype]}")
            log(f"kernels: flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} bf16 "
                f"{'causal' if causal else 'non-causal'}: max |err| {err:.3e} "
                f"(tolerance {FLASH_TOL[dtype]})")
            del got, want
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        del q, k, v
        timed = time_flash(case, rng, card)
        if offset:
            offset_ms.append(timed["device_ms"])
    if ph["offsets"]:
        a, b, why = ph["offsets"]
        log(f"kernels: flash_attention at the ranks' query offsets, device time alone: "
            + "; ".join(f"{case[0]} {ms:.4f} ms" for case, ms in zip(ph["flash"], offset_ms))
            + f"; {ph['flash'][b][0]}'s {offset_ms[b] / offset_ms[a]:.3f}x "
            f"{ph['flash'][a][0]}'s ({why}) ({card})")
    torch.cuda.empty_cache()

    work = (out_dir / f"tp_ranks_{phase}").resolve()  # a file:// rendezvous needs a whole path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    world = int(np.prod(ph["mesh"]))
    logs = [None] + [open(work / f"rank{r}.log", "w") for r in range(1, world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
                               "--tp-rank", str(r), "--tp-dir", str(work),
                               "--tp-phase", str(phase)],
                              stdout=logs[r], stderr=subprocess.STDOUT if logs[r] else None)
             for r in range(world)]
    deadline = time.monotonic() + TP_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs[1:]:
            f.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in range(1, world):
            log(f"tp rank {r} output (last 6000 bytes):\n"
                + (work / f"rank{r}.log").read_text()[-6000:])
        raise AssertionError(f"phase {phase}: ranks {bad} failed (rank, exit code)")
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    for arch, r0 in ranks[0].items():
        launches = [r[arch]["flash_launches"] for r in ranks]
        totals["flash_attention"] = totals.get("flash_attention", 0) + sum(launches)
        log(f"tp {arch}: flash_attention launches in the counted sharded prefills, by rank: "
            f"{launches}; peak device memory by rank, serving {[r[arch]['peak'] for r in ranks]}"
            + (f", training at {r0['train_depth']} layers {[r[arch]['train_peak'] for r in ranks]}"
               if "train_depth" in r0 else "")
            + f" bytes; rank 0's collectives by kind: the prefill {r0['counts']['prefill']}, a "
            f"decode step {r0['counts']['decode']}"
            + (f", a train step {r0['train_counts']}" if "train_counts" in r0 else "")
            + f", staged through host memory: {ph['staged']}"
            + f"; prefill {r0['prefill_tokens_per_s']:.1f}, "
            f"decode {r0['decode_tokens_per_s']:.1f}"
            + (f", train {r0['train_tokens_per_s']:.1f}" if "train_tokens_per_s" in r0 else "")
            + f" tokens/s on {world} ranks sharing the card"
            + (f"; rank 0's backward waited {r0['relay_back_s']:.6f} s on the relay in step 1, "
               f"by rank {[r[arch]['relay_back_s'] for r in ranks]}" if "relay_back_s" in r0
               else "")
            + (f"; the one-process step: {r0['plain']}" if "plain" in r0 else "") + f" ({card})")
        if "all_drops" in r0:  # each rank routed the whole sequence
            every = [r[arch]["all_drops"] for r in ranks]
            if any(d != every[0] for d in every):
                raise AssertionError(f"tp {arch}: the sequence ranks dropped {every} assignments "
                                     f"(dropped, routed) a layer, not the same")
            log(f"tp {arch}: sequence-sharded prefill: each rank routed the whole sequence, "
                f"dropping the same assignments on every rank: "
                + ", ".join(f"layer {i} {d} of {n} ({100 * d / n:.3f} %)"
                            for i, (d, n) in enumerate(every[0])))
        elif "drops" in r0:
            for layer in r0["drops"]:
                dropped = sum(r[arch]["drops"][layer][0] for r in ranks)
                routed = sum(r[arch]["drops"][layer][1] for r in ranks)
                log(f"tp {arch}: expert-parallel prefill layer {layer}: {dropped} of {routed} "
                    f"assignments dropped ({100 * dropped / routed:.3f} %; by rank "
                    f"{[r[arch]['drops'][layer][0] for r in ranks]})")
    return ranks[0]


def tp_rank_main(rank: int, work: Path, seed: int, phase: int = 9) -> int:
    """One rank of phase 9, 10, 11, 12 or 14: the gloo group,
    ``make_shared_card_mesh``, then each arch's serving (``tp_serve``; for
    whisper-base first its own serve step, the pure data-parallel model,
    then the model with tensor parallelism forced, but in a phase that runs
    it in its own layout only, ``own_layout``), training where the phase
    trains it (``tp_train``, or ``seq_train``) and the shallow checks
    (``tp_shallow``) where it has them; the results to
    ``work/rank<r>.json``. Rank 0 also runs
    the unsharded counterparts on the card (the other ranks wait in their
    next collective)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_shared_card_mesh
    from repro_torch.models.sharding import MeshCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    ph = TP_PHASES[phase]
    world = int(np.prod(ph["mesh"]))
    dist.init_process_group("gloo", init_method=f"file://{work / 'rendezvous'}", rank=rank,
                            world_size=world)
    try:
        card = card_line()
        t0 = time.perf_counter()
        ctx = MeshCtx(make_shared_card_mesh(ph["mesh"]))
        log(f"tp: {ctx.shape} over a {dist.get_backend()} group of {world} processes on one card "
            f"(CUDA tensors straight through gloo's collectives; staged through host memory: "
            f"{ph['staged']}), rank {rank} ({card})")
        out = {}
        for arch in ph["archs"]:
            own = arch in ph.get("own_layout", ())  # the model's own pure_dp only
            if arch == "whisper_base" and not own:
                out[WHISPER_SERVE_STEP] = tp_serve(ctx, arch, seed, card, rank, ph, pure_dp=True)
            t1 = time.perf_counter()
            served = tp_serve(ctx, arch, seed, card, rank, ph, pure_dp=own)
            t2 = time.perf_counter()
            train = seq_train if ph.get("seq_train") else tp_train
            out[arch] = {**served, **(train(ctx, arch, seed, card, rank, ph)
                                      if arch in ph["train_depths"] else {})}
            t3 = time.perf_counter()
            if ph["shallow"] is not None:
                tp_shallow(ctx, arch, seed, card, rank, ph)
            log(f"tp {arch}: {time.perf_counter() - t0:.3f} s into the ranks' work (serving "
                f"{t2 - t1:.3f} s, training {t3 - t2:.3f} s, the shallow checks "
                f"{time.perf_counter() - t3:.3f} s) ({card})")
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _placed(params: dict, specs: dict, ctx) -> dict:
    """``params`` as DTensors laid out as ``specs``, each rank's block its own
    copy (the global tensors can then be freed)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    mesh = ctx.device_mesh()
    return tree_map(lambda p, s: DTensor.from_local(ctx.local(p, s).clone(), mesh, s.placements,
                                                    run_check=False), params, specs)


def _local_zeros(template: dict, specs: dict, ctx) -> dict:
    """f32 zeros of each leaf's block under its spec, as DTensors (AdamW's
    moments, never whole on a rank)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    mesh = ctx.device_mesh()

    def zeros(sd, s):
        shape = list(sd[0])
        for dim, entry in enumerate(s.spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            shape[dim] //= math.prod(ctx.shape[a] for a in axes)
        return DTensor.from_local(torch.zeros(shape, dtype=torch.float32, device="cuda"), mesh,
                                  s.placements, run_check=False)

    return tree_map(zeros, template, specs)


def _logits_close(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float, float]:
    """(within CHECK_LOGIT_ULPS bf16 ulps of want's largest |logit|, the
    max |diff|, the tolerance)."""
    from _torch_moe_criteria import bf16_ulp

    tol = CHECK_LOGIT_ULPS * float(bf16_ulp(float(want.abs().max())))
    err = float((got - want).abs().max())
    return err <= tol and bool(torch.isfinite(got).all()), err, tol


def tp_judge(tag: str, err: float, self_err: float, tol: float,
             rounded: float | None = None, exact: bool = False) -> bool:
    """A sharded-against-unsharded distance ``err`` held to ``tol`` where the
    unsharded run meets ``tol`` against itself under
    ``_torch_train_criteria.tp_rounding``
    (``self_err``; a miss then fails the run), printed where it does not
    (ill-conditioned). ``rounded`` is the sharded run's own distance from
    the rounded unsharded run: with ``exact`` it must be 0 (TP_EXACT),
    else it is printed. Returns whether ``err`` was held."""
    held = self_err <= tol
    if held and not err <= tol:
        raise AssertionError(f"{tag}: {err} > {tol}")
    if exact and not rounded == 0:
        raise AssertionError(f"{tag}: the sharded run is {rounded} from the unsharded run rounded "
                             f"as the ranks round, not equal to it")
    log(f"{tag}: {err:.3e}, the unsharded run against itself rounded as the ranks round "
        f"{self_err:.3e} (tolerance {tol:.3e}"
        + (f"; the sharded run against the rounded one {rounded:.3e}"
           + (", held equal" if exact else "") if rounded is not None else "") + "); "
        + ("held" if held else "NOT held: ill-conditioned, the unsharded run misses it under "
           "the ranks' rounding too (the f32 check holds the sharded math)"))
    return held


def tp_decode_judge(tag: str, seen: list, want: list, jit: list, routes: tuple | None,
                    exact: bool = False) -> bool:
    """Decode steps' logits of the sharded run (``seen``) and of the
    unsharded run under ``tp_rounding`` (``jit``) against the unsharded
    run's (``want``),
    each step's max |diff| in tolerances (CHECK_LOGIT_ULPS bf16 ulps of its
    largest |logit|) and the share of greedy tokens that differ, each held
    by ``tp_judge`` (``exact``: every step's logits equal ``jit``'s). For the
    MoE family ``routes`` holds the three runs'
    ``RouteLog`` calls: a (step, row) pair is compared only while its
    routes have equalled the unsharded run's in every layer, at that step
    and before (a run left with no pair is as far as it can be). Returns
    whether both were held."""
    steps, B = len(want), want[0].shape[0]
    tols = [_logits_close(s, w)[2] for s, w in zip(seen, want)]

    def rows(calls) -> list:
        if routes is None:
            return [list(range(B))] * steps
        L, ok, out = len(calls) // steps, np.ones(B, bool), []
        for i in range(steps):
            for a, b in zip(calls[i * L:(i + 1) * L], routes[1][i * L:(i + 1) * L]):
                ok &= (a["routed"] == b["routed"]).all(-1)
            out.append(list(np.flatnonzero(ok)))
        return out

    def ratio(xs, kept) -> float:
        return max([float((x[r] - w[r]).abs().max()) / t
                    for x, w, t, r in zip(xs, want, tols, kept) if r], default=math.inf)

    def differ(xs, kept) -> float:
        n = sum(len(r) for r in kept)
        same = sum(int((x[r].argmax(-1) == w[r].argmax(-1)).sum())
                   for x, w, r in zip(xs, want, kept) if r)
        return 1 - same / n if n else math.inf

    kept = rows(routes[0] if routes else None)
    jkept = rows(routes[2] if routes else None)
    if routes is not None:
        tag += (f"; {B * steps - sum(map(len, kept))} of {B * steps} (step, row) pairs left "
                f"out from a route that differs, at that step or before, in any layer; under "
                f"the ranks' rounding {B * steps - sum(map(len, jkept))}")
    held = tp_judge(f"{tag}), the worst step's max |diff| in tolerances "
                    f"({CHECK_LOGIT_ULPS} bf16 ulps of its largest |logit|)",
                    ratio(seen, kept), ratio(jit, jkept), 1.0,
                    max(float((s - j).abs().max()) for s, j in zip(seen, jit)), exact)
    return tp_judge(f"{tag}), the share of greedy tokens that differ", differ(seen, kept),
                    differ(jit, jkept), 1 - SMALL_ARGMAX_SHARE) and held


def _tp_inputs(model, params: dict, seed: int, B: int, S: int) -> tuple[dict, dict | None]:
    """The B-row prefill batch of ``model``'s family: S tokens uniform over
    the vocab from ``default_rng(seed)``; the VLM's S embeddings and M-RoPE
    positions (``_embed_inputs``); whisper's WHISPER_FRAMES audio frames and
    WHISPER_TOKENS tokens (``whisper_inputs``). For whisper also its decode
    cache's cross K/V of those frames, from the encoder over the whole
    ``params`` (``cross_kv``), else None."""
    cfg = model.cfg
    if cfg.family == "encdec":
        batch = whisper_inputs(B, seed, "cuda")
        xk, xv = _encdec().cross_kv(model, params, batch["audio_embeds"])
        return batch, {"xk": xk, "xv": xv}
    if cfg.embeddings_input:
        return _embed_inputs(cfg, B, S, seed, "cuda"), None
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to("cuda")}, None


def _tp_prefix(batch: dict, n: int) -> dict:
    """``batch``'s first ``n`` positions (tokens, embeddings, M-RoPE
    positions)."""
    return {k: v[..., :n] if k != "embeds" else v[:, :n] for k, v in batch.items()}


def _tp_cache(model, B: int, cache_len: int, first: int, seed: int, cross: dict | None,
              ctx=None, f32: tuple = ()):
    """A decode cache of B rows from zero (``first`` is 0; ``seed`` unused:
    ``_seq_cache``'s signature), whisper's cross K/V ``cross`` copied in,
    the entries named in ``f32`` kept in f32 (the reference's cache is bf16
    whatever the model's dtype), laid out as ``cache_specs`` on ``ctx``'s
    mesh where given."""
    from repro_torch.train.elastic import reshard_state

    assert first == 0
    c = model.init_cache(B, cache_len)
    c.update({k: v.clone() for k, v in (cross or {}).items()})
    c.update({k: c[k].float() for k in f32 if k in c})
    return c if ctx is None else reshard_state(c, model.cache_specs(B, cache_len, ctx))


def _drops(calls: list) -> list:
    """[dropped, routed] assignments of each MoE layer's routes
    (``RouteLog.calls``)."""
    return [[int(c["routed"].sum() - c["kept"].sum()), int(c["routed"].sum())] for c in calls]


def _ep_twin(moe: bool, mesh: tuple, seq: int):
    """The unsharded counterpart of a sharded MoE prefill on ``mesh`` (n_batch,
    n_model): its expert-parallel branch emulated (``ep_emulated``) on the
    ranks' blocks of the batch, or with the sequence sharded (``seq`` > 1:
    each "model" rank routes its block of the whole sequence) on the one
    batch; with the sequence sharded on model = 1, the whole-array layer
    itself (every rank routes the whole sequence); nothing for another
    family."""
    import _torch_moe_criteria as mc

    if not moe or (seq > 1 and mesh[1] == 1):
        return contextlib.nullcontext()
    return mc.ep_emulated(1 if seq > 1 else mesh[0], mesh[1])


@contextlib.contextmanager
def f32_scores():
    """While active, ``gqa_attention`` (the decode's attention) runs its score
    chain in the query's dtype, not bf16 (the reference's, whatever the
    model's dtype): an f32 model's decode in f32 throughout. With a bf16
    chain a one-ulp difference in an f32 query flips a bf16 score now and
    then, and over the few keys of the first decode steps one flip moved
    whisper's f32 logits by 1e-2 of the largest."""
    from repro_torch.models import lm

    gqa = lm.gqa_attention
    lm.gqa_attention = lambda q, *a, **k: gqa(q, *a, **{"score_dtype": q.dtype, **k})
    try:
        yield
    finally:
        lm.gqa_attention = gqa


def tp_serve(ctx, arch: str, seed: int, card: str, rank: int, ph: dict,
             pure_dp: bool = False) -> dict:
    """``arch`` at full width, at its depth (the phase's ``serve_depths``
    (``TP_PHASES``), a ``reduced:`` line where cut; weights drawn on the
    card from ``seed``, the same on every rank, each keeping its blocks;
    whisper's final norms drawn), as a model that is not pure
    data-parallel, or with ``pure_dp`` as whisper-base is. With the phase's
    ``serve`` shapes: a warm-up and a counted sharded prefill of B rows
    (``_tp_inputs``; sequence-sharded where B does not fill the batch axes;
    flash counted from 0; collectives by kind; for the MoE family each
    rank's drops in its first and last layer), then ``steps`` sharded
    decode steps from position ``first`` against a cache (``_seq_cache``
    where ``drawn``, else ``_tp_cache``; whisper's WHISPER_TOKENS long with
    its cross K/V filled): greedy, but the VLM's, fed the prefill's
    embeddings; each rank's peak memory of that run. Rank 0 holds them
    against the unsharded prefill and decode (teacher-forced on the sharded
    inputs) on the card: the logits within CHECK_LOGIT_ULPS bf16 ulps of
    the largest |logit|, the decode's greedy tokens at SMALL_ARGMAX_SHARE
    of all positions, each held by ``tp_judge`` (and equal to the unsharded
    run computed as the ranks compute it, ``tp_rounding(model, seq=)``,
    where the phase's ``exact`` says). The MoE family's expert-parallel
    prefill routes each rank's tokens with a capacity from them, through
    the reference's exchange (ROADMAP C): its unsharded counterpart runs
    that branch emulated (``ep_emulated``); its decode routes whole. With
    ``pure_dp`` the prefill is data-parallel over both axes and the serve
    step decodes on the serve specs' blocks. Every rank then waits for rank
    0 (a barrier), so that no rank allocates the next model meanwhile."""
    import contextlib
    import dataclasses
    import gc

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc
    import _torch_train_criteria as crit

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_arch(arch)
    sv = {**ph["serve"], **ph["serve"].get("arch", {}).get(arch, {})}
    B, first, mesh = sv["B"], sv["first"], (ctx.n_batch, ctx.n_model)
    exact = ph["exact"].get(arch, ())
    seq = ctx.n_batch if ctx.seq_sharded(B) else 1
    if arch in ph["serve_depths"]:
        log(f"reduced: tp {arch} serving n_layers {cfg.n_layers} -> {ph['serve_depths'][arch]} "
            f"({ph['serve_cuts'][arch]})")
        cfg = dataclasses.replace(cfg, n_layers=ph["serve_depths"][arch])
    encdec = cfg.family == "encdec"
    cache_len = WHISPER_TOKENS if encdec else sv["cache_len"]
    new_cache = functools.partial(_seq_cache, blocks=ctx.n_batch) if sv["drawn"] else _tp_cache
    model = build_model(cfg, max_pos=cache_len, device="cuda")
    model.pure_dp = pure_dp
    tag = f"tp {WHISPER_SERVE_STEP if pure_dp else arch}"
    if ph["decode_cut"]:
        log(f"reduced: {tag} decode steps {ph['decode_cut']}")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    if encdec:
        _encdec().draw_final_norms(params, seed + 9)
    batch, cross = _tp_inputs(model, params, seed, B, sv["S"])
    # the pure data-parallel model prefills on whole weights, decodes on the serve specs
    placed = _placed(params, model.param_specs(ctx, serve=pure_dp), ctx)
    weights = params if pure_dp else placed
    if rank != 0 and not pure_dp:
        del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_tokens = B * batch["tokens" if "tokens" in batch else "embeds"].shape[1]
    prefill = make_prefill_step(model, ctx)
    prefill(weights, batch if encdec else _tp_prefix(batch, sv["warmup_s"]))  # warm-up
    torch.cuda.synchronize()
    runs, walls = TP_PREFILL_RUNS, []
    fa.launches = 0
    for _ in range(runs):  # the counted prefills; the collectives of the last
        ctx.counts.clear()
        t = time.perf_counter()
        logits = prefill(weights, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    pre_wall = sorted(walls)[runs // 2]
    out = {"flash_launches": fa.launches, "counts": {"prefill": dict(ctx.counts)},
           "prefill_tokens_per_s": n_tokens / pre_wall}
    if cfg.family == "moe":  # this rank's routes, recorded in a prefill of their own
        with mc.RouteLog() as routes:
            prefill(weights, batch)
        drops = _drops(routes.calls)
        out["drops"] = {str(i): drops[i] for i in (0, cfg.n_layers - 1)}
        if seq > 1:  # each rank routes the whole sequence: every layer's, held on rank 0
            out["all_drops"] = drops
        del routes
    if out["flash_launches"] != runs * attention_layers(cfg):
        raise AssertionError(f"{tag}: rank {rank}'s {runs} sharded prefills launched "
                             f"flash_attention {out['flash_launches']} times, not "
                             f"{runs * attention_layers(cfg)}")
    if not torch.isfinite(logits).all() or logits.shape != (B, cfg.vocab):
        raise AssertionError(f"{tag}: sharded prefill logits {tuple(logits.shape)} not finite")
    what = "sequence-sharded" if seq > 1 else "data-parallel" if pure_dp else "sharded"
    log(f"{tag}: {model.n_params()} parameters, full width, {cfg.n_layers} layers"
        + (f" and {cfg.encoder_layers} encoder layers on {WHISPER_FRAMES} frames" if encdec
           else "")
        + f"; {what} prefill {B} x {n_tokens // B} tokens, the median of {runs} "
        f"({', '.join(f'{w:.4f}' for w in walls)} s): {pre_wall:.4f} s, "
        f"{out['prefill_tokens_per_s']:.1f} tokens/s on {ctx.size(ctx.axis_names)} ranks sharing "
        f"the card, flash launches on this rank {out['flash_launches']}, collectives "
        f"{out['counts']['prefill']} ({card})")
    if rank == 0:
        moe = cfg.family == "moe"
        # the ranks round the prefill's partial sums over "model" where it is tensor-parallel
        n_tp = ctx.n_model if model.tp_ctx(ctx) is not None else 1
        with _ep_twin(moe, mesh, seq):
            t = time.perf_counter()
            plain = make_prefill_step(model)(params, batch)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            with crit.tp_rounding(n_tp, seq=seq), mc.RouteLog() as routes:
                jit = make_prefill_step(model)(params, batch)
        log(f"{tag}: the unsharded prefill of the same inputs on rank 0 (the other ranks "
            f"waiting): {t:.4f} s, {n_tokens / t:.1f} tokens/s ({card})")
        if "all_drops" in out:
            want = _drops(routes.calls)
            if out["all_drops"] != want:
                raise AssertionError(f"{tag}: the sequence-sharded prefill dropped "
                                     f"{out['all_drops']} assignments (dropped, routed) a layer, "
                                     f"the unsharded prefill {want}")
            log(f"{tag}: the sequence-sharded prefill's MoE layers each routed the whole "
                f"sequence and dropped what the unsharded prefill drops, layer by layer: "
                f"{sum(d for d, _ in want)} of {sum(n for _, n in want)} assignments "
                f"({', '.join(str(d) for d, _ in want)}), held equal ({card})")
        del routes
        _, err, tol = _logits_close(logits, plain)
        out["prefill_held"] = tp_judge(
            f"{tag}: {what} prefill against the unsharded prefill"
            + (" (its expert-parallel branch emulated)" if moe else "")
            + f" on the card (max |logit| {float(plain.abs().max()):.3e}, greedy tokens agree "
            f"{int((logits.argmax(-1) == plain.argmax(-1)).sum())}/{B}), max |diff|",
            err, _logits_close(jit, plain)[1], tol, float((logits - jit).abs().max()),
            "prefill" in exact)
        del plain, jit

    serve = make_serve_step(model, ctx)
    warm_len, warm_first = sv["warm"] if not encdec else (cache_len, 0)
    serve(placed, new_cache(model, B, warm_len, warm_first, seed, cross, ctx),
          {**_decode_batch(batch, 0), "cur_len": warm_first})  # warm-up
    cache = new_cache(model, B, cache_len, first, seed, cross, ctx)
    fed, seen = [batch["tokens"][:, 0].contiguous() if "tokens" in batch else None], []

    def feed(i: int) -> dict:
        """Step i's input: the VLM's prefill embedding i, else the greedy token fed."""
        return ({**_decode_batch(batch, i), "cur_len": first + i} if cfg.embeddings_input
                else {"token": fed[i], "cur_len": first + i})

    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(sv["steps"]):
        if i == 1:
            ctx.counts.clear()
        step_logits, cache = serve(placed, cache, feed(i))
        if i == 1:
            out["counts"]["decode"] = dict(ctx.counts)
        seen.append(step_logits)
        fed.append(step_logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    dec_wall = time.perf_counter() - t
    out["decode_tokens_per_s"] = B * sv["steps"] / dec_wall
    kv = sum(c.to_local().numel() * c.to_local().element_size() for k, c in cache.items()
             if k in ("k", "v"))
    log(f"{tag}: {what} decode, {sv['steps']} "
        + ("steps fed the prefill's embeddings" if cfg.embeddings_input else "greedy steps")
        + f" of batch {B} at positions {first}..{first + sv['steps'] - 1} against a "
        f"{cache_len}-long cache ({kv} bytes of K/V on this rank"
        + (f"; its cross K/V of {WHISPER_FRAMES} frames filled from the encoder" if encdec
           else "")
        + f"): {dec_wall:.4f} s, {out['decode_tokens_per_s']:.1f} tokens/s on "
        f"{ctx.size(ctx.axis_names)} ranks sharing the card, collectives a step "
        f"{out['counts']['decode']} ({card})")
    del cache
    moe_routes = None
    if cfg.family == "moe":  # the same steps again, rank 0 recording its routes
        cache = new_cache(model, B, cache_len, first, seed, cross, ctx)
        with mc.RouteLog() as log_routes:
            for i in range(sv["steps"]):
                _, cache = serve(placed, cache, feed(i))
        moe_routes = log_routes.calls
        del cache
    gc.collect()
    torch.cuda.empty_cache()
    out["peak"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        def unsharded() -> tuple[list, list]:
            plain_cache = new_cache(model, B, cache_len, first, seed, cross)
            step, got = make_serve_step(model), []
            with mc.RouteLog() as calls:
                for i in range(sv["steps"]):
                    want, plain_cache = step(params, plain_cache, feed(i))
                    got.append(want)
            return got, calls.calls

        want, want_routes = unsharded()
        gc.collect()
        torch.cuda.empty_cache()
        with crit.tp_rounding(ctx.n_model, seq=seq):
            jit, jit_routes = unsharded()
        routes = (moe_routes, want_routes, jit_routes) if moe_routes is not None else None
        out["decode_held"] = tp_decode_judge(
            f"{tag}: {what} decode against the unsharded decode ({sv['steps']} steps "
            f"teacher-forced on the sharded run's inputs", seen, want, jit, routes,
            "decode" in exact)
        del want, jit
    del placed, model, weights, cross, batch
    params = None
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_shallow(ctx, arch: str, seed: int, card: str, rank: int, ph: dict) -> None:
    """``arch`` at full width and the phase's ``shallow_depths`` layers
    (else TP_SHALLOW_LAYERS; whisper's encoder too), not pure
    data-parallel, in bf16 and in f32 (weights drawn on the card), with the
    phase's ``shallow`` shapes (as ``tp_serve``'s ``serve``): the sharded
    prefill of ``_tp_inputs`` and ``steps`` decode steps from ``first`` fed
    the prefill's tokens (or embeddings), against the unsharded ones on
    rank 0 (the MoE prefill's with its expert-parallel branch emulated,
    ``ep_emulated``), each also against its twin, the unsharded run under
    ``tp_rounding(model, seq=)`` (in f32 with model > 1 also
    ``tp_columns``). In bf16 held as ``tp_serve`` holds them; in f32 (the
    decode's K/V cache and score chain too, ``f32_scores``) within
    TP_WITNESS_RTOL of the largest |logit| of the twin at every check, and
    of the plain unsharded run where the twin is within it too: the
    sharded math's witness where the bf16 model is ill-conditioned. With
    model > 1, for the SSM and hybrid families (whose ranks' in-projections
    run on other shapes) the decode steps that read the bf16 conv window
    back are printed, not held, with the window's entries that differ after
    step 0 counted, and the f32 run is repeated with the window kept in f32
    and held at every step; the column-parallel products' differing bits
    are printed (``column_bits``). With the sequence sharded, the f32
    twin also runs the prefill's products on the ranks' row blocks of the
    sequence (``tp_rows``: cuBLAS may sum a product on a rank's rows in
    another order than on all of them)."""
    import contextlib
    import dataclasses
    import gc

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_moe_criteria as mc
    import _torch_train_criteria as crit

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import whole
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    mesh, sh = (ctx.n_batch, ctx.n_model), ph["shallow"]
    depth, B, first = ph["shallow_depths"].get(arch, TP_SHALLOW_LAYERS), sh["B"], sh["first"]
    seq = ctx.n_batch if ctx.seq_sharded(B) else 1
    new_cache = functools.partial(_seq_cache, blocks=ctx.n_batch) if sh["drawn"] else _tp_cache
    for dtype in ("bfloat16", "float32"):
        full = get_arch(arch)
        encdec = full.family == "encdec"
        cfg = dataclasses.replace(full, n_layers=depth, dtype=dtype,
                                  **({"encoder_layers": depth} if encdec else {}))
        log(f"reduced: tp {arch} {dtype} check n_layers {full.n_layers} -> {depth}"
            + (f" and encoder_layers {full.encoder_layers} -> {depth}" if encdec else "")
            + " (the bf16 model at full depth is ill-conditioned from random weights)")
        cache_len = WHISPER_TOKENS if encdec else sh["cache_len"]
        model = build_model(cfg, max_pos=cache_len, device="cuda")
        model.pure_dp = False
        params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
        if encdec:
            _encdec().draw_final_norms(params, seed + 9)
        placed = _placed(params, model.param_specs(ctx), ctx)
        batch, cross = _tp_inputs(model, params, seed + 1, B, sh["S"])
        moe, ssm = cfg.family == "moe", cfg.is_ssm
        split_window = ssm and ctx.n_model > 1

        def decode(serve, weights, c) -> tuple[list, list, torch.Tensor]:
            """(the decode steps' logits, their routes, the conv window after
            the first step, whole, for the SSM families)."""
            steps, window = [], None
            with mc.RouteLog() as routes:
                for i in range(sh["steps"]):
                    logits, c = serve(weights, c, {**_decode_batch(batch, i), "cur_len": first + i})
                    steps.append(logits)
                    if ssm and i == 0:
                        window = whole(c["conv"]).clone()
            return steps, routes.calls, window

        def run(sharded: bool, f32_window: bool = False) -> tuple:
            """(prefill logits, decode steps' logits, the decode's routes, its
            first conv window); in f32, the decode's K/V cache and score chain
            in f32 too."""
            step_ctx, weights = (ctx, placed) if sharded else (None, params)
            with _ep_twin(moe and not sharded, mesh, seq):
                pre = make_prefill_step(model, step_ctx)(weights, batch)
            f32 = dtype == "float32"
            cache = new_cache(model, B, cache_len, first, seed, cross, step_ctx,
                              (("k", "v") if f32 else ()) + (("conv",) if f32_window else ()))
            with f32_scores() if f32 else contextlib.nullcontext():
                return [pre], *decode(make_serve_step(model, step_ctx), weights, cache)

        got = run(True)
        got32 = run(True, True) if split_window and dtype == "float32" else None
        if rank == 0:
            f32 = dtype == "float32"

            def twin(f32_window: bool = False) -> tuple:
                """The unsharded run rounded as the ranks round and, in f32, its
                column-parallel products on the ranks' blocks (``tp_columns``)
                and, with the sequence sharded, its prefill's products on the
                ranks' row blocks of the sequence (``tp_rows``)."""
                with crit.tp_rounding(ctx.n_model, seq=seq), (
                        tp_columns(ctx.n_model) if f32 and ctx.n_model > 1
                        else contextlib.nullcontext()), (
                        crit.tp_rows(cfg, seq, ctx.n_model) if f32 and seq > 1
                        else contextlib.nullcontext()):
                    return run(False, f32_window)

            want, jit = run(False), twin()
            tag = f"tp {arch} {dtype} {depth} layers (full width)"
            if f32:
                labels = ["prefill"] + [f"decode step {first + i}" for i in range(sh["steps"])]
                windowed = ({label: "it reads the bf16 window back" for label in labels[2:]}
                            if split_window else {})
                tol = TP_WITNESS_RTOL

                def rel(a: tuple, b: tuple) -> list:
                    return [float((x - w).abs().max() / w.abs().max())
                            for x, w in zip(a[0] + a[1], b[0] + b[1])]

                def witness(what: str, got_: tuple, want_: tuple, jit_: tuple, skip: dict) -> None:
                    """Each label sharded within the tolerance of the twin, and of
                    the unsharded run where the twin is within it of that run
                    too; the labels in ``skip`` printed, not held (for the reason
                    it gives)."""
                    errs, selfs, near = rel(got_, want_), rel(jit_, want_), rel(got_, jit_)
                    bad = [label for label, e, r, d in zip(labels, errs, selfs, near)
                           if label not in skip and (d > tol or r <= tol < e)]
                    log(f"{tag}{', ' + what if what else ''}: max |diff| over the largest "
                        f"|logit|, sharded against unsharded (the twin, the unsharded run "
                        f"computed as the ranks compute it, against it; sharded against the "
                        f"twin): "
                        + ", ".join(f"{label} {e:.3e} ({r:.3e}; {d:.3e})"
                                    for label, e, r, d in zip(labels, errs, selfs, near))
                        + f"; tolerance {tol}"
                        + (f"; held against the twin only, the twin {tol} or more from the "
                           f"unsharded run: " + ", ".join(label for label, r in zip(labels, selfs)
                                                         if r > tol and label not in skip)
                           if any(r > tol for r in selfs) else "")
                        + ("; printed, not held: " + ", ".join(f"{label} ({why})"
                                                               for label, why in skip.items())
                           if skip else "") + f" ({card})")
                    if bad:
                        raise AssertionError(f"{tag}, {what}: not held: {bad} (sharded against "
                                             f"unsharded {errs}, twin {selfs}, sharded against "
                                             f"twin {near})")

                witness("the conv window in bf16 as the reference keeps it" if split_window else "",
                        got, want, jit, windowed)
                if split_window:
                    a, b = got[3].float(), want[3].float()
                    ulps = (a - b).abs() / torch.from_numpy(mc.bf16_ulp(b.cpu().numpy())).to(b)
                    log(f"{tag}: the bf16 conv window after decode step 0, sharded against "
                        f"unsharded: {int((a != b).sum())} of {b.numel()} entries differ, by at "
                        f"most {float(ulps.max()):.3f} bf16 ulps; the twin's "
                        f"{int((jit[3] != want[3]).sum())}")
                    witness("the conv window kept in f32", got32, run(False, True), twin(True),
                            {})
                if ctx.n_model > 1:
                    column_bits(params, seed, tag, card, ctx.n_model)
            else:
                exact = ph["exact"].get(arch, ())
                _, err, tol = _logits_close(got[0][0], want[0][0])
                tp_judge(f"{tag}: sharded prefill against the unsharded prefill"
                         + (" (its expert-parallel branch emulated)" if moe else "")
                         + ", max |diff|", err, _logits_close(jit[0][0], want[0][0])[1], tol,
                         float((got[0][0] - jit[0][0]).abs().max()), "prefill" in exact)
                routes = (got[2], want[2], jit[2]) if moe else None
                tp_decode_judge(f"{tag}: sharded decode against the unsharded decode "
                                f"({sh['steps']} steps from position {first}", got[1], want[1],
                                jit[1], routes, "decode" in exact)
            del want, jit
        del params, placed, got, got32, model, batch, cross
        gc.collect()
        torch.cuda.empty_cache()


def column_bits(params: dict, seed: int, tag: str, card: str, n: int) -> None:
    """What ``tp_columns`` models: for the first layer's column-parallel
    weights (the attention's and the MLP's, of the hybrid's shared block,
    of whisper's decoder), how many elements of an f32 product on
    PREFILL_B * PREFILL_S random rows differ between the whole product and
    the ranks' contiguous column blocks; printed."""
    stack = next((params[k] for k in ("layers", "shared", "dec") if "wq" in params.get(k, {})),
                 None)
    if stack is None:  # mamba2: no attention, no MLP
        return
    lead = stack["wq"].ndim - 3
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(PREFILL_B * PREFILL_S, stack["wq"].shape[-3], device="cuda", generator=g)
    seen = []
    for name in ("wq", "wk", "wv", "wg", "wu"):
        if (name not in stack or name in ("wq", "wk", "wv") and stack[name].shape[-2] % n
                or name == "wu" and "dec" in params):  # whisper's MLP reads no wu
            continue
        w = stack[name][(0,) * lead]
        w = w.reshape(w.shape[0], -1)
        k = w.shape[1] // n
        whole = x @ w
        blocks = torch.cat([x @ w[:, i * k:(i + 1) * k].contiguous() for i in range(n)], dim=-1)
        seen.append(f"{name} {tuple(w.shape)} {int((whole != blocks).sum())} of {whole.numel()}")
    log(f"{tag}: layer 0's f32 column-parallel products on {x.shape[0]} random rows, the elements "
        f"that differ between the whole product and the ranks' column blocks: {'; '.join(seen)} "
        f"({card})")


def tp_train(ctx, arch: str, seed: int, card: str, rank: int, ph: dict) -> dict:
    """``arch`` trained on the mesh at full width, the phase's ``train_depths``
    (a ``reduced:`` line where cut), not pure data-parallel: weights drawn
    on the card (whisper's final norms drawn), each rank keeping its blocks,
    AdamW's moments made as blocks, B=TRAIN_B x TRAIN_S (``_train_batches``;
    whisper: MESH_WHISPER_TOKENS tokens on WHISPER_TRAIN_FRAMES frames, as
    phase 8 trains it), lr TRAIN_LR: a warm-up and ``TP_TRAIN_STEPS`` timed
    steps (finite losses, train tokens/s, peak device memory, collectives a
    step). For qwen2-0.5b also one full-width layer in f32, sharded against
    unsharded (``mesh_hold``), held."""
    import dataclasses
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_specs
    from repro_torch.train.steps import make_train_step

    cfg = get_arch(arch)
    depth = ph["train_depths"][arch]
    if depth < cfg.n_layers:
        log(f"reduced: tp {arch} training n_layers {cfg.n_layers} -> {depth} "
            f"({ph['train_cuts'][arch]})")
        cfg = dataclasses.replace(cfg, n_layers=depth)
    encdec = cfg.family == "encdec"
    model = build_model(cfg, max_pos=WHISPER_TOKENS if encdec else TRAIN_S, device="cuda")
    model.pure_dp = False
    pspecs = model.param_specs(ctx)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    if encdec:
        _encdec().draw_final_norms(params, seed + 9)
    params = _placed(params, pspecs, ctx)
    ospecs = adamw_specs(pspecs, model.param_template(), ctx)
    opt = {"m": _local_zeros(model.param_template(), ospecs["m"], ctx),
           "v": _local_zeros(model.param_template(), ospecs["v"], ctx),
           "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    gc.collect()
    torch.cuda.empty_cache()
    if encdec:
        log(f"reduced: tp whisper training decoder tokens {WHISPER_TOKENS} -> "
            f"{MESH_WHISPER_TOKENS} on {WHISPER_TRAIN_FRAMES} frames (the chunked cross-entropy "
            f"of a mesh step takes multiples of 128; the training attention refuses 1500 frames)")
        seeds = itertools.count(seed)

        def next_batch() -> dict:
            return {k: v[:, :MESH_WHISPER_TOKENS] if k != "audio_embeds" else v
                    for k, v in whisper_inputs(TRAIN_B, next(seeds), "cuda",
                                               frames=WHISPER_TRAIN_FRAMES, labels=True).items()}
    else:
        next_batch = _train_batches(cfg, TRAIN_B, TRAIN_S, seed, "cuda")
    n_tokens = TRAIN_B * (MESH_WHISPER_TOKENS if encdec else TRAIN_S)
    step = make_train_step(model, ctx, AdamWConfig(lr=TRAIN_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, counts = [], [], {}
    for i in range(TP_TRAIN_STEPS + 1):
        batch = next_batch()
        ctx.counts.clear()
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        counts = dict(ctx.counts)
        if not np.isfinite(loss):
            raise AssertionError(f"tp {arch}: sharded train step {i} loss {loss} is not finite")
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"tp {arch}: trained at full width, {cfg.n_layers} layers, B={TRAIN_B} x "
        f"{n_tokens // TRAIN_B} tokens: {n_tokens / median:.1f} train tokens/s on "
        f"{ctx.size(ctx.axis_names)} ranks sharing the card (median step {median:.4f} s of {', '.join(f'{w:.4f}' for w in walls)}, "
        f"the first a warm-up); losses {', '.join(f'{x:.6f}' for x in losses)}; peak device "
        f"memory on rank {rank} {peak} bytes ({peak / 1e9:.3f} GB; "
        f"{torch.cuda.max_memory_reserved() / 1e9:.3f} GB reserved); collectives a step {counts} "
        f"({card})")
    del params, opt, step, model
    gc.collect()
    torch.cuda.empty_cache()
    if arch == "qwen2_0_5b":
        f32 = dataclasses.replace(get_arch(arch), n_layers=1, dtype="float32")
        log("reduced: tp qwen2 held check n_layers 24 -> 1, bfloat16 -> float32 (one full-width "
            "layer in f32 is well-conditioned)")
        hold = ph["hold_tokens"]
        if hold < TRAIN_S:
            log(f"reduced: tp qwen2 held check tokens a row {TRAIN_S} -> {hold} (every rank also "
                f"runs the unsharded f32 steps: at {TRAIN_S} the {ctx.n_model} ranks ran the card "
                f"out of memory)")
        held, verdict, _ = mesh_hold(ctx, f32, {k: v[:, :hold] for k, v in next_batch().items()},
                                     seed, f"tp qwen2 f32 1 layer on model={ctx.n_model}",
                                     pure_dp=False)
        if not held:
            raise AssertionError(f"tp qwen2 f32 1 layer: {verdict}")
    return {"train_tokens_per_s": n_tokens / median, "train_peak": peak,
            "train_depth": cfg.n_layers, "train_counts": counts}


def seq_train(ctx, arch: str, seed: int, card: str, rank: int, ph: dict) -> dict:
    """Sequence-sharded training (phases 11 and 12): first the f32 witness,
    SEQ_WITNESS_LAYERS layers of the config in f32, whose every gradient
    leaf (as the sharded step hands its optimizer, averaged over the batch
    axes, gathered whole) lies within TP_WITNESS_RTOL relative L2 of the
    one-process step's on rank 0, held. Then ``arch`` at full width and the
    phase's ``train_depths`` (a ``reduced:`` line), not pure data-parallel,
    weights drawn on the card, B = 1 x SEQ_TRAIN_S (each sequence rank's
    block; ``LM.seq_ctx(ctx, 1, train=True)``), lr TRAIN_LR, the
    parameters stored in the ZeRO layout: step 1 (also the warm-up) and
    ``TP_TRAIN_STEPS`` timed steps (train tokens/s, peak device memory on
    every rank, the collectives of step 1 by kind, the backward hops
    included, and how long each rank's receives blocked on the relay,
    ``MeshCtx.waits``: rank 0's are its backward's). On rank 0 (the others
    wait in their next collective) the one-process step from the same
    weights and batch, its train tokens/s (a warm-up, then
    ``TP_TRAIN_STEPS``), and step 1 held against it as ``hold_step``
    decides from its probes, each another correct rounding of the
    one-process step (``_seq_probes``), printed with the farthest leaves.
    The f32 witness is held by the same policy (``_witness_verdict``)."""
    import contextlib
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_train_criteria as crit

    import repro_torch.train.steps as steps
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step, training_state_specs
    from repro_torch.tree import named_leaves, tree_map

    cfg, depth = get_arch(arch), ph["train_depths"][arch]
    S, own = ph.get("train_s", {}).get(arch, SEQ_TRAIN_S), arch in ph.get("own_layout", ())
    max_pos = WHISPER_TOKENS if cfg.family == "encdec" else S
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    tag = f"seq {arch} ({ctx.n_batch} sequence ranks x model={ctx.n_model})"

    class Handed(Exception):
        """The step has handed its optimizer the gradients (the witness needs
        no more of it: not the optimizer's exchanges over gloo)."""

    def sharded_step(model, params, batch, grads: dict | None = None):
        """Step 1 of the sharded step from ``params`` stored in the ZeRO
        layout; with ``grads``, only as far as the gradients it hands its
        optimizer, recorded there (every rank stops at the same point)."""
        pstore, ospecs = training_state_specs(model, ctx)
        state = reshard_state(params, pstore), reshard_state(adamw_init(params), ospecs)
        update = steps.adamw_update_sharded
        if grads is not None:
            def recording(p, g, *rest):
                grads.update(g=g)
                raise Handed
            steps.adamw_update_sharded = recording
        try:
            return make_train_step(model, ctx, opt_cfg)(*state, batch)
        except Handed:
            return None
        finally:
            steps.adamw_update_sharded = update

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    def batches(c, first_seed: int, n: int = S):
        """The next 1 x n train batch (whisper's n tokens on
        WHISPER_TRAIN_FRAMES audio frames, as phase 8 trains it)."""
        if c.family != "encdec":
            return _train_batches(c, 1, n, first_seed, "cuda")
        seeds = itertools.count(first_seed)
        return lambda: {k: v if k == "audio_embeds" else v[:, :n] for k, v in whisper_inputs(
            1, next(seeds), "cuda", frames=WHISPER_TRAIN_FRAMES, labels=True).items()}

    if cfg.family == "encdec":
        log(f"reduced: seq {arch} training decoder tokens {WHISPER_TOKENS} -> {S} on "
            f"{WHISPER_TRAIN_FRAMES} frames (the chunked cross-entropy of a mesh step takes "
            f"multiples of 128; the training attention refuses 1500 frames)")

    # the f32 witness
    witness = {"n_layers": SEQ_WITNESS_LAYERS, "dtype": "float32",
               **SEQ_WITNESS_OVERRIDES.get(arch, {})}
    f32 = dataclasses.replace(cfg, **witness)
    ws = ph.get("witness_s", {}).get(arch, S)
    log(f"reduced: seq {arch} f32 witness "
        + ", ".join(f"{k} {getattr(cfg, k)} -> {v}" for k, v in witness.items())
        + (f", tokens {S} -> {ws}" if ws < S else "")
        + " (the witness of the sharded step's gradients"
        + ("; its one-process f32 steps run on rank 0 alone: the script's 1080 s with phase 14)"
           if ws < S else ")"))
    model = build_model(f32, max_pos=max_pos, device="cuda")
    model.pure_dp = own and model.pure_dp
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed + 1))
    if f32.family == "encdec":
        _encdec().draw_final_norms(params, seed + 10)
    batch = batches(f32, seed + 1, ws)()
    handed: dict = {}
    sharded_step(model, params, batch, handed)
    mesh, pspecs = ctx.device_mesh(), model.param_specs(ctx)
    grads = _whole(tree_map(
        lambda g, sp: DTensor.from_local(ctx.all_reduce(g.float(), ctx.batch_axes, "avg"), mesh,
                                         sp.placements, run_check=False), handed["g"], pspecs))
    if rank == 0:
        want = dict(named_leaves(loss_and_grads(model, params, batch)[1]))
        errs = {n: crit.rel_l2(g, want[n]) for n, g in named_leaves(grads)}
        # the one-process step's own distance under other correct roundings; the
        # last probe is the twin, the one-process step computed as the ranks compute it.
        # Where every leaf meets the tolerance the probes, which can only widen it, are
        # not run
        floor, twin = dict.fromkeys(errs, 0.0), {}
        probes = _seq_probes(crit, f32, ctx) if max(errs.values()) > TP_WITNESS_RTOL else {}
        for name, probe in probes.items():
            with contextlib.ExitStack() as stack:
                for cm in probe:
                    stack.enter_context(cm)
                moved = dict(named_leaves(loss_and_grads(model, params, batch)[1]))
            dist_ = {n: crit.rel_l2(moved[n], want[n]) for n in want}
            floor = {n: max(floor[n], dist_[n]) for n in floor}
            log(f"{tag}: f32 witness: the one-process gradients {name} against themselves, the "
                f"farthest {_far(dist_)}")
        if probes:
            twin = {n: crit.rel_l2(g, moved[n]) for n, g in named_leaves(grads)}
            del moved
        passed, verdict = _witness_verdict(errs, floor, twin)
        log(f"{tag}: f32 witness, {f32.n_layers} layers, B=1 x {ws}: every gradient "
            f"leaf of the sharded step against the one-process step's, the farthest "
            f"{_far(errs)}" + (f", against the twin's {_far(twin)}" if twin else
                               " (no probe run: each leaf within the tolerance)")
            + f" (tolerance {TP_WITNESS_RTOL}): {verdict} ({card})")
        if not passed:
            raise AssertionError(f"{tag}: f32 witness: {verdict}")
        del want
    del grads, handed, params, model, batch
    free()
    dist.barrier()

    # the bf16 step at the phase's depth
    over = ph.get("train_overrides", {}).get(arch, {})
    if depth < cfg.n_layers:
        log(f"reduced: seq {arch} training n_layers {cfg.n_layers} -> {depth}"
            + "".join(f", {k} {getattr(cfg, k)} -> {v}" for k, v in over.items())
            + f" ({ph['train_cuts'][arch]})")
        cfg = dataclasses.replace(cfg, n_layers=depth, **over)
    model = build_model(cfg, max_pos=max_pos, device="cuda")
    model.pure_dp = own and model.pure_dp
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    if cfg.family == "encdec":
        _encdec().draw_final_norms(params, seed + 9)
    next_batch = batches(cfg, seed)
    steps_in = [next_batch() for _ in range(TP_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx.counts.clear()
    ctx.waits.clear()
    walls, losses = [], []
    t = time.perf_counter()
    p1, o1, loss = sharded_step(model, params, steps_in[0])
    losses.append(float(loss))
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
    counts, waits = dict(ctx.counts), dict(ctx.waits)
    step, state = make_train_step(model, ctx, opt_cfg), (p1, o1)
    for batch in steps_in[1:]:
        t = time.perf_counter()
        state = step(*state, batch)
        losses.append(float(state[2]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        state = state[:2]
    del state
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: sharded train losses {losses} are not all finite")
    median = sorted(walls[1:])[len(walls[1:]) // 2]
    peaks, every_wait = [None] * dist.get_world_size(), [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    dist.all_gather_object(every_wait, waits)
    log(f"{tag}: trained at full width, {cfg.n_layers} layers, B=1 x {S} tokens "
        + (f"on {WHISPER_TRAIN_FRAMES} frames " if cfg.family == "encdec" else "")
        + f"({S // ctx.n_batch} a sequence rank): {S / median:.1f} train "
        f"tokens/s on {ctx.size(ctx.axis_names)} ranks sharing the card (median step "
        f"{median:.4f} s of {', '.join(f'{w:.4f}' for w in walls)}, the first step 1, a "
        f"warm-up); losses {', '.join(f'{x:.6f}' for x in losses)}; peak device memory by rank "
        f"{peaks} bytes; step 1's collectives by kind {counts}; the relay's receives blocked "
        f"in step 1, by rank (relay: the forward's, relay_back: the backward's): "
        f"{[{k: round(v, 6) for k, v in w.items()} for w in every_wait]} s ({card})")
    whole_p, whole_o = _whole(p1), _whole(o1)
    del p1, o1
    out = {"train_tokens_per_s": S / median, "train_peak": peak,
           "train_depth": cfg.n_layers, "train_counts": counts,
           "relay_back_s": waits.get("relay_back", 0.0)}
    if rank == 0:
        plain = make_train_step(model, None, opt_cfg)
        want_p, want_o, want_loss = plain(params, adamw_init(params), steps_in[0])
        m = crit.step_metrics(whole_p, whole_o, want_p, want_o, TRAIN_LR)
        # the probes can only widen the criteria: not run where the step meets them
        nudged = []
        for name, probe in ({} if crit.meets(m) else _seq_probes(crit, cfg, ctx)).items():
            with contextlib.ExitStack() as stack:
                for cm in probe:
                    stack.enter_context(cm)
                pn, on, _ = plain(params, adamw_init(params), steps_in[0])
            mn = crit.step_metrics(pn, on, want_p, want_o, TRAIN_LR)
            nudged.append((mn, None))
            log(f"{tag}: the one-process step {name} against itself: {_step_summary(mn)}; "
                f"farthest m {_farthest(mn)}")
            del pn, on
        held, verdict, failures = crit.hold_step(m, nudged=nudged)
        log(f"{tag}: sharded step 1 against the one-process step: loss {losses[0]:.6f} / "
            f"{float(want_loss):.6f}; {_step_summary(m)}; farthest m {_farthest(m)}; the "
            f"criteria {verdict} ({card})")
        if failures or abs(losses[0] - float(want_loss)) > crit.LOSS_ATOL:
            raise AssertionError(f"{tag}: sharded step 1: {verdict}, but {failures}")
        del want_p, want_o
        free()
        out["plain"] = _plain_steps(model, params, steps_in, S)
        log(f"{tag}: the one-process step on rank 0: {out['plain']} ({card})")
    del whole_p, whole_o, params, model, steps_in
    free()
    dist.barrier()
    return out


def _seq_probes(crit, cfg, ctx) -> dict:
    """``seq_train``'s probes of the one-process step, name -> the context
    managers to enter: another correct rounding each (the one-ulp nudges,
    the SSD's for the SSM families and the RMS norms' otherwise; last, the
    twin, the step computed as the ranks compute it, on one process: the
    cross-entropy in the mesh's chunks, ``chunked_ce``, every product over
    the sequence's rows and the embedding's lookup on the ranks' row
    blocks, ``tp_rows``, ``embed_rows``)."""
    nudge = crit.ssd_nudged if cfg.is_ssm else crit.norm_nudged
    return {"nudged up": (nudge(math.inf),), "nudged down": (nudge(-math.inf),),
            "on the ranks' row blocks": (crit.chunked_ce(),
                                         crit.tp_rows(cfg, ctx.n_batch, ctx.n_model),
                                         crit.embed_rows(ctx.n_batch))}


def _witness_verdict(errs: dict, floor: dict, twin: dict) -> tuple[bool, str]:
    """How the f32 witness is held, ``hold_step``'s policy for its
    gradients: each leaf (``errs``) within TP_WITNESS_RTOL of the
    one-process step's where every probe lies within it
    (well-conditioned); widened, leaf by leaf, by the farthest probe's
    distance (``floor``) where that is at most NUDGE_CAP tolerances; past
    that, ill-conditioned, each leaf within TP_WITNESS_RTOL of the twin's
    alone (``twin``: the one-process step computed as the ranks compute
    it), as phases 9-12 hold their serving witnesses. Returns (False where
    the witness misses, the verdict)."""
    import _torch_train_criteria as crit

    far = max(floor.values()) / TP_WITNESS_RTOL
    if far > crit.NUDGE_CAP:
        missed = [n for n, e in twin.items() if e > TP_WITNESS_RTOL]
        how = (f"ill-conditioned (another correct rounding moves the one-process gradients "
               f"{far:.2f} tolerances, past the cap of {crit.NUDGE_CAP}): held against the "
               f"twin only")
        if missed:
            return False, f"{how}, but {', '.join(f'{n} {twin[n]:.3e}' for n in missed)} missed"
        return True, how
    missed = [n for n, e in errs.items() if e > TP_WITNESS_RTOL + floor[n]]
    how = "held" if far <= 1 else (f"held, widened by the probes' distance ({far:.2f} "
                                   f"tolerances, within the cap of {crit.NUDGE_CAP})")
    if missed:
        return False, f"{how}, but {', '.join(f'{n} {errs[n]:.3e}' for n in missed)} missed"
    return True, how


def _far(errs: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {errs[k]:.3e}" for k in sorted(errs, key=errs.get, reverse=True)[:n])


def _farthest(m: dict, n: int = 3) -> str:
    """The ``n`` leaves of ``step_metrics`` farthest in m, with their m."""
    return ", ".join(f"{k} {m[k]['m']:.4f}" for k in sorted(m, key=lambda k: -m[k]["m"])[:n])


def run_tp_phase(seed: int, card: str, out_dir: Path, counts: dict, worst: dict,
                 phase: int) -> None:
    """Phase 9, 10, 11, 12 or 14 (``drive_tp``) and its summary line."""
    ph, t = TP_PHASES[phase], time.perf_counter()
    res = drive_tp(seed, card, out_dir, counts, worst, phase)
    log(f"phase {phase}: {time.perf_counter() - t:.3f} s; on (data={ph['mesh'][0]}, "
        f"model={ph['mesh'][1]}), {math.prod(ph['mesh'])} processes sharing the card over "
        f"gloo, prefill B = {ph['serve']['B']}: "
        + "; ".join(f"{a} prefill {r['prefill_tokens_per_s']:.1f}, decode "
                    f"{r['decode_tokens_per_s']:.1f}"
                    + (f", train at {r['train_depth']} layers {r['train_tokens_per_s']:.1f}"
                       if "train_depth" in r else "") + " tokens/s" for a, r in res.items())
        + f" ({card})")


# ---------------------------------------------------------------- phase 13
# the dry run (``launch.dryrun``, ``roofline.op_count``) held against the
# card: qwen2-0.5b at full width, its prefill at phase 5's shape and its
# train step at phase 7's (TRAIN_DEPTH layers), each traced on fake CUDA
# tensors, then run here; one production cell through the CLI; the four
# examples on the card
DRYRUN_STEP_RUNS = 3  # timed steps a kind, the median held against the bound
DRYRUN_PEAK_RTOL = 0.10  # the card's peak against the trace's
DRYRUN_SHARE_MAX = 1.05  # the share of the bound that no step can reach
DRYRUN_CELL = ("qwen2_0_5b", "decode_32k")  # on (16, 16), ranks 0 and 255
EXAMPLES = ("quickstart", "reconfigure_live", "serve_decode", "train_ec_checkpoint")
EXAMPLES_SAME_ON_CPU = ("quickstart", "reconfigure_live")


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    from repro_torch.roofline.op_count import tensors_of

    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors_of(tree)}
    return sum(seen.values())


def _dryrun_step(kind: str, seed: int, card: str) -> dict:
    """One qwen2-0.5b step (``kind`` "prefill": full depth, PREFILL_B x
    PREFILL_S; "train": TRAIN_DEPTH layers, TRAIN_B x TRAIN_S, AdamW)
    traced on fake CUDA tensors (``count_step``), then run on the card:
    FlopCounterMode over a real step must count the trace's FLOPs exactly,
    the card's peak (``max_memory_allocated`` after a reset, less what was
    resident besides the step's arguments) lie within DRYRUN_PEAK_RTOL of
    the trace's, the median of DRYRUN_STEP_RUNS steps take at least
    1 / DRYRUN_SHARE_MAX of ``roofline_report(hw=H100)``'s lower bound, and
    a prefill launch flash as often as the trace called it."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.registry import build_model
    from repro_torch.roofline.analysis import H100, roofline_report
    from repro_torch.roofline.op_count import count_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_prefill_step, make_train_step
    from repro_torch.tree import tree_map

    cfg = get_arch(MODEL)
    if kind == "train":
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_DEPTH)
    B, S = (PREFILL_B, PREFILL_S) if kind == "prefill" else (TRAIN_B, TRAIN_S)

    def inputs(make):
        model = build_model(cfg, max_pos=S, device="cuda")
        params = tree_map(lambda sd: make(tuple(sd[0]), sd[1]), model.param_template())
        tokens = make((B, S), torch.int32)
        if kind == "prefill":
            return make_prefill_step(model), (params, {"tokens": tokens})
        batch = {"tokens": tokens, "labels": make((B, S), torch.int32)}
        return make_train_step(model, None, AdamWConfig(lr=TRAIN_LR)), \
            (params, adamw_init(params), batch)

    with FakeTensorMode():
        step, args = inputs(lambda shp, dtype: torch.empty(shp, dtype=dtype, device="cuda"))
        _, trace = count_step(step, *args)
    gen = torch.Generator("cuda").manual_seed(seed)

    def draw(shp, dtype):
        if dtype == torch.int32:
            return torch.randint(0, cfg.vocab, shp, dtype=dtype, device="cuda", generator=gen)
        return (torch.randn(shp, device="cuda", generator=gen) * 0.02).to(dtype)

    step, args = inputs(draw)
    step(*args)  # warm-up: cuBLAS handles, the kernel library
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - _storage_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    torch.cuda.synchronize()
    flops, launches = counter.get_total_flops(), fa.launches
    peak = torch.cuda.max_memory_allocated() - resident
    finite = bool(torch.isfinite(out if kind == "prefill" else out[2]).all())
    del out
    walls = []
    for _ in range(DRYRUN_STEP_RUNS):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    tokens = B * S
    report = roofline_report(flops=trace.flops, bytes_accessed=trace.hbm_bytes,
                             collective_bytes=0.0, n_chips=1,
                             model_flops=(6 if kind == "train" else 2) *
                             build_model(cfg, device="cpu").n_active_params() * tokens,
                             hw=H100, links_per_chip=H100.links)
    bound = report["step_time_lower_bound"]
    share = bound / wall
    log(f"dryrun: {MODEL} {kind} ({cfg.n_layers} layers, {B} x {S}): trace {trace.seconds:.3f} s "
        f"on fake CUDA tensors, {trace.flops} FLOPs, {trace.hbm_bytes} HBM bytes, peak "
        f"{trace.peak_bytes} bytes ({trace.argument_bytes} at the start), flash calls "
        f"{trace.flash_calls}; the card: {flops} FLOPs (FlopCounterMode), peak {peak} bytes "
        f"(max_memory_allocated {peak + resident} less {resident} resident besides the "
        f"arguments), {launches} flash launches; median of {DRYRUN_STEP_RUNS} steps {wall:.4f} s "
        f"({', '.join(f'{w:.4f}' for w in walls)}), {tokens / wall:.1f} tokens/s; H100 bound "
        f"{bound:.6f} s ({report['dominant']}: compute {report['compute']:.6f} s, memory "
        f"{report['memory']:.6f} s), {100 * share:.2f} % of the bound ({card})")
    top = sorted(trace.bytes_by_op.items(), key=lambda kv: -kv[1])[:6]
    log(f"dryrun: {MODEL} {kind}: HBM bytes by operation " + ", ".join(
        f"{op} {n / 1e9:.3f} GB" for op, n in top) + "; live at the peak " + ", ".join(
        f"{r['dtype']}{r['shape']} {r['bytes'] / 1e9:.3f} GB ({r['op']}, {r['where']})"
        for r in trace.top[:4]))
    failures = []
    if flops != trace.flops:
        failures.append(f"FLOPs {flops} on the card, {trace.flops} in the trace")
    if not abs(peak - trace.peak_bytes) <= DRYRUN_PEAK_RTOL * trace.peak_bytes:
        failures.append(f"peak {peak} on the card, {trace.peak_bytes} in the trace "
                        f"(more than {DRYRUN_PEAK_RTOL:.0%} apart)")
    if share > DRYRUN_SHARE_MAX:
        failures.append(f"{100 * share:.2f} % of the lower bound: faster than the bound allows")
    if launches != trace.flash_calls:
        failures.append(f"{launches} flash launches, {trace.flash_calls} flash calls traced")
    if not finite:
        failures.append("a non-finite output")
    if failures:
        raise AssertionError(f"dryrun {kind}: " + "; ".join(failures))
    del step, args
    torch.cuda.empty_cache()
    return {"kind": kind, "flops": flops, "trace_flops": trace.flops, "peak": peak,
            "trace_peak": trace.peak_bytes, "wall": wall, "bound": bound, "share": share,
            "launches": launches, "trace_s": trace.seconds}


def _example(name: str, device: str) -> tuple[str, dict]:
    """``repro_torch.examples.<name>`` run here on ``device``: its standard
    output and the storage and flash kernels' launches it made."""
    import importlib
    import io

    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gf256_matmul import ops as gf

    mods = {"gf256_matmul": gf, "cdc_gearhash": cdc, "flash_attention": fa}
    before = {k: m.launches for k, m in mods.items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(f"repro_torch.examples.{name}").main(["--device", device])
    return buf.getvalue(), {k: m.launches - before[k] for k, m in mods.items()}


def drive_dryrun(seed: int, card: str, out_dir: Path, counts: dict) -> None:
    """Phase 13: the dry run's trace held against the card (``_dryrun_step``
    for qwen2-0.5b's prefill and train step); ``DRYRUN_CELL`` through
    ``python -m repro_torch.launch.dryrun`` (ranks 0 and 255 of (16, 16) on
    fake CUDA tensors over a fake process group, no JAX); the four examples
    with ``--device cuda``, quickstart's and reconfigure_live's output
    equal to their ``--device cpu`` runs' (in subprocesses meanwhile). Adds
    the kernels' launches of the prefill and the examples to ``counts``."""
    import os

    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gf256_matmul import ops as gf

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    cell_dir = out_dir / "dryrun"
    arch, shape = DRYRUN_CELL
    side = {"cell": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--out", str(cell_dir)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    side.update({name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cpu"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name in EXAMPLES_SAME_ON_CPU})
    try:
        held = [_dryrun_step(kind, seed, card) for kind in ("prefill", "train")]
        cdc.launches = gf.launches = fa.launches = 0
        launches = {}
        outputs = {}
        for name in EXAMPLES:
            outputs[name], launches[name] = _example(name, "cuda")
        for name in EXAMPLES_SAME_ON_CPU:
            cpu, err = side[name].communicate(timeout=300)
            if side[name].returncode != 0:
                raise AssertionError(f"{name} --device cpu: {err[-2000:]}")
            if cpu != outputs[name]:
                raise AssertionError(f"{name} printed otherwise on the card than on the CPU:\n"
                                     f"{outputs[name]}\n-- CPU --\n{cpu}")
        log_text = side["cell"].communicate(timeout=300)[0]
        if side["cell"].returncode != 0:
            raise AssertionError(f"dryrun {arch} {shape}: {log_text[-3000:]}")
    finally:
        for p in side.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    cell = json.loads((cell_dir / f"{arch}__{shape}__pod1.json").read_text())
    if cell["status"] != "ok" or [r["rank"] for r in cell["ranks"]] != [0, 255]:
        raise AssertionError(f"dryrun {arch} {shape}: {cell.get('error', cell['status'])}")
    r = cell["roofline"]
    log(f"dryrun: {arch} {shape} on (16, 16), ranks 0 and 255 traced in {cell['trace_s']} s on "
        f"this machine (no JAX): peak {cell['per_chip_live_bytes'] / 1e9:.3f} GB a rank, "
        f"{cell['flops_per_chip']:.4e} FLOPs, {cell['bytes_per_chip']:.4e} HBM bytes, "
        f"{cell['collective_bytes_total']:.4e} collective bytes; H100 bound "
        f"{r['step_time_lower_bound']:.6f} s ({r['dominant']}), MFU bound "
        f"{100 * r['mfu_upper_bound']:.4f} % ({card})")
    for name in EXAMPLES:
        last = outputs[name].strip().splitlines()[-1]
        log(f"dryrun: example {name} --device cuda: launches {launches[name]}"
            + (" (the same output as --device cpu)" if name in EXAMPLES_SAME_ON_CPU else "")
            + f"; its last line: {last}")
    total = {k: sum(v[k] for v in launches.values()) for k in ("gf256_matmul", "cdc_gearhash")}
    for k in ("gf256_matmul", "cdc_gearhash"):
        if total[k] == 0:
            raise AssertionError(f"the examples never launched {k}")
        counts[k] += total[k]
    counts["flash_attention"] += held[0]["launches"]
    log(f"phase 13: {time.perf_counter() - t0:.3f} s; " + "; ".join(
        f"{h['kind']} {100 * h['share']:.2f} % of the H100 bound, peak {h['peak'] / 1e9:.3f} GB "
        f"(trace {h['trace_peak'] / 1e9:.3f} GB), FLOPs equal ({h['flops']})" for h in held)
        + f"; examples' launches {total} ({card})")


def tp_phases_alone(args, card: str, t_start: float) -> int:
    """``--tp-phase``: after ``main``'s set-up and the kernels' build, only
    the phases named, each as the whole run drives it; prints no result line
    (the run is not the whole script)."""
    counts, worst = {}, {}
    for phase in args.tp_phase:
        run_tp_phase(args.seed, card, args.out, counts, worst, phase)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s after phase {phase} ({card})")
    log(f"phases {args.tp_phase} alone: flash_attention launches {counts}, worst max |err| "
        f"{worst}; no result line (not the whole script)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size-mib", type=int, default=512)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "chip_smoke")
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)  # the ranks of phases 9-12
    ap.add_argument("--tp-dir", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-phase", action="store_true",
                    help="run only phase 13 (the dry run against the card, the examples), "
                         "after building the kernels; no result line")
    ap.add_argument("--tp-phase", type=int, action="append", choices=sorted(TP_PHASES),
                    help="run only this phase of ranks sharing the card (repeatable), after "
                         "building the kernels; no result line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_dir, args.seed, args.tp_phase[0])
    # the plain versions run their f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_store import EMULAB  # fails outside a checkout
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf

    t_start = time.perf_counter()
    args.out.mkdir(parents=True, exist_ok=True)
    # phase 1
    card = card_line()
    log(card)
    # phase 2
    build(args.out)
    if args.dryrun_phase:
        counts = {"gf256_matmul": 0, "cdc_gearhash": 0, "flash_attention": 0}
        drive_dryrun(args.seed, card, args.out, counts)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s after phase 13 ({card}); launches "
            f"{counts}; no result line (not the whole script)")
        return 0
    if args.tp_phase:
        return tp_phases_alone(args, card, t_start)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind} x{count}")
    size = args.size_mib << 20
    log(f"config: EMULAB CoARESECF n={EMULAB.n_servers} k={EMULAB.n_servers - EMULAB.parity_m} "
        f"ec_opt indexed coding_backend=kernel device=cuda blocks min={MIN_BLOCK} "
        f"avg={AVG_BLOCK} max={MAX_BLOCK} file={size} bytes seed={args.seed}; "
        f"cuts: {'none' if args.size_mib >= 512 else f'file {args.size_mib} MiB of 512'}")
    log(f"config: YCSB-B {YCSB_B} through one gateway, "
        f"storm {STORM} under RetryPolicy(rpc_timeout="
        f"{storm_retry(dict(YCSB_B)).rpc_timeout:.4f}); sanitized {SANITIZED}; checkpoint of {MODEL} on "
        f"ECCheckpointStore(n_hosts=8, parity=2, device=cuda, coding_backend=kernel), the same "
        f"blocks, the model at full width and depth; training {MODEL} at B={TRAIN_B} x "
        f"S={TRAIN_S}, AdamW lr {TRAIN_LR}, checkpoints on the same store configuration; "
        f"cuts: none")
    log(f"config: serving {MODEL}, {MOE_MODEL} and {', '.join(SSM_MODELS)} at full width and "
        f"depth, prefill {PREFILL_B} x {PREFILL_S}, decode batch 4 against a 2048 cache; card vs "
        f"CPU for {MODEL}, {', '.join(MOE_CHECK_ARCHS)} at full width, {SMALL_LAYERS} layers (cut "
        f"from the depth), {SMALL_B} x {SMALL_S} tokens; for "
        f"{', '.join(f'{a} at {n} layers' for a, n in SSM_CHECK_LAYERS.items())}")
    log(f"config: serving {', '.join(EMBED_MODELS)} at full width and depth, prefill "
        f"{PREFILL_B} x {PREFILL_S} and decode batch 4 against a 2048 cache for qwen2-vl; "
        f"whisper at its published context, {WHISPER_FRAMES} audio frames and {WHISPER_TOKENS} "
        f"tokens (max_pos and cache {WHISPER_TOKENS}); card vs CPU at full width, "
        f"{EMBED_CHECK_LAYERS} layers (cut from the depth), {SMALL_B} x {SMALL_S} tokens")
    log(f"config: training {', '.join(FAMILY_TRAIN_DEPTHS)} and {', '.join(EMBED_TRAIN_DEPTHS)} "
        f"at full width, B={TRAIN_B} x S={TRAIN_S} (whisper: x {WHISPER_TOKENS} and "
        f"{WHISPER_TRAIN_FRAMES} audio frames), AdamW lr {TRAIN_LR}; cuts: "
        + ", ".join(f"{a} n_layers {get_arch(a).n_layers} -> {d}"
                    for a, d in {**FAMILY_TRAIN_DEPTHS, **EMBED_TRAIN_DEPTHS}.items()
                    if d < get_arch(a).n_layers)
        + f" ({TRAIN_DEPTH_CUT}); the launcher runs at the reduced configs of the first three")
    def elapsed(after: str) -> None:
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s after {after} ({card})")

    # phase 3
    rng = np.random.default_rng(args.seed)
    data = rng.integers(0, 256, size, dtype=np.uint8)
    chunks = cdc.split_chunks(data.tobytes(), min_size=MIN_BLOCK, avg_size=AVG_BLOCK,
                              max_size=MAX_BLOCK, device="cuda")
    k = EMULAB.n_servers - EMULAB.parity_m
    path_L = sum((len(c) + k - 1) // k for c in chunks)  # width of the file's one encode
    kernels = [check_gf256(path_L, rng, card), check_gearhash(data, rng, card),
               check_flash(rng, card)]
    torch.cuda.empty_cache()
    elapsed("phases 1-3")
    # phase 4: the storage path, counted from zero
    payload = data.tobytes()
    del data, chunks
    torch.cuda.reset_peak_memory_stats()
    cdc.launches = 0
    gf.launches = 0
    t0 = time.perf_counter()
    seen = drive_path(payload, device="cuda", seed=args.seed, card=card)
    path_s = time.perf_counter() - t0
    counts = {"gf256_matmul": gf.launches, "cdc_gearhash": cdc.launches}
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"the main path never launched {name}")
    log(f"path: {path_s:.3f} s wall for the whole sequence, launches {counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes ({card})")
    profile_path(payload, args.out, args.seed)
    del payload
    # the same sequence on a small file: card vs plain versions on the CPU
    small_rng = np.random.default_rng(args.seed + 1)
    small = small_rng.integers(0, 256, SMALL_FILE, dtype=np.uint8).tobytes()
    on_card = drive_path(small, device="cuda", seed=args.seed, quiet=True)
    on_cpu = drive_path(small, device="cpu", seed=args.seed, quiet=True)
    for key in ("write", "reads", "edit", "margins", "moved", "fingerprint"):
        if on_card[key] != on_cpu[key]:
            raise AssertionError(f"small-file {key} differs between the card and the CPU: "
                                 f"{on_card[key]!r} != {on_cpu[key]!r}")
    log(f"path: {SMALL_FILE}-byte file gives the same stats and trace on the card as on the CPU")
    torch.cuda.empty_cache()
    elapsed("phase 4")
    # phase 5: the model path, counted from zero inside drive_model
    counts["flash_attention"] = drive_model(args.seed, card, args.out)
    torch.cuda.empty_cache()
    card_vs_cpu(args.seed)
    elapsed("phase 5")
    # phase 5b: the MoE family, flash_attention counted from zero inside drive_moe
    counts["flash_attention"] += drive_moe(args.seed, card, args.out)
    torch.cuda.empty_cache()
    elapsed("phase 5b's serving")
    for arch in MOE_CHECK_ARCHS:
        card_vs_cpu(args.seed, arch)
    moe_layer_card_vs_cpu(args.seed, card)
    torch.cuda.empty_cache()
    elapsed("phase 5b")
    # phase 5c: the SSM and hybrid families, one model at a time, flash_attention counted
    # from zero inside drive_ssm
    for arch in SSM_MODELS:
        counts["flash_attention"] += drive_ssm(arch, args.seed, card, args.out)
    elapsed("phase 5c's serving")
    for arch in SSM_MODELS:
        if arch in SSM_CHECK_F32_ONLY:
            log(f"reduced: {arch} card vs CPU in float32 only (the script's 1200 s; its bfloat16 "
                f"check is ill-conditioned from random weights and was printed, never held)")
        if (arch in SSM_CHECK_F32_ONLY or not ssm_card_vs_cpu(args.seed, arch)) and \
                not ssm_card_vs_cpu(args.seed, arch, "float32"):
            raise AssertionError(f"{arch}: the f32 card-vs-CPU check did not hold every "
                                 f"criterion")
    torch.cuda.empty_cache()
    elapsed("phase 5c")
    # phase 5d: the encoder-decoder and VLM families, one model at a time, flash_attention
    # counted from zero inside drive_embed
    for arch in EMBED_MODELS:
        counts["flash_attention"] += drive_embed(arch, args.seed, card, args.out)
    elapsed("phase 5d's serving")
    for arch in EMBED_MODELS:
        log(f"reduced: {arch} card vs CPU in float32 only (the script's 900 s; its bfloat16 "
            f"check is ill-conditioned from random weights and was printed, never held)")
        if not embed_card_vs_cpu(args.seed, arch):
            raise AssertionError(f"{arch}: the f32 card-vs-CPU check did not hold every "
                                 f"criterion")
    torch.cuda.empty_cache()
    elapsed("phase 5d")
    # phase 6: the store's users, each path counted from zero inside counted_phase
    worst = {"gf256_matmul": 0, "cdc_gearhash": 0}
    check_ycsb_shapes(args.seed, card, worst)
    drive_ycsb(args.seed, args.out, card, counts)
    drive_sanitized(args.seed, args.out, card, counts)
    ycsb_card_vs_cpu(args.seed)
    drive_checkpoint(args.seed, args.out, card, counts, worst)
    elapsed("phase 6")
    # phase 7: training with checkpoints, the storage kernels counted from zero inside
    drive_training(args.seed, args.out, card, counts, worst)
    elapsed("phase 7's training")
    train_card_vs_cpu(args.seed)
    elapsed("phase 7")
    # phase 7b: the MoE, SSM and hybrid families trained at full width (depth cut to fit),
    # the storage kernels counted from zero inside each launcher run
    t7b = time.perf_counter()
    trained = [drive_family_training(arch, args.seed, card, args.out)
               for arch in FAMILY_TRAIN_DEPTHS]
    elapsed("phase 7b's training")
    moe_gather_backward_card_vs_cpu(args.seed, card)
    family_train_card_vs_cpu(args.seed)
    elapsed("phase 7b's card-vs-CPU steps")
    for arch in FAMILY_TRAIN_DEPTHS:
        drive_train_launcher(arch, card, counts, worst)
    log(f"phase 7b: {time.perf_counter() - t7b:.3f} s; "
        + "; ".join(f"{t['arch']} at {t['depth']} layers {t['tokens_per_s']:.1f} train tokens/s, "
                    f"peak {t['peak'] / 1e9:.3f} GB" for t in trained) + f" ({card})")
    elapsed("phase 7b")
    # phase 7c: the encoder-decoder and VLM families trained at full width
    t7c = time.perf_counter()
    trained = drive_embed_training(args.seed, card, args.out)
    elapsed("phase 7c's training")
    embed_train_card_vs_cpu(args.seed)
    log(f"phase 7c: {time.perf_counter() - t7c:.3f} s; "
        + "; ".join(f"{t['arch']} at {t['depth']} layers {t['tokens_per_s']:.1f} train tokens/s, "
                    f"peak {t['peak'] / 1e9:.3f} GB" for t in trained) + f" ({card})")
    elapsed("phase 7c")
    # phase 8: the mesh layer on a one-card NCCL mesh, each path counted from zero inside
    t8 = time.perf_counter()
    mesh = drive_mesh(args.seed, card, args.out, counts, worst)
    q, w = mesh["qwen2"], mesh["whisper"]
    log(f"phase 8: {time.perf_counter() - t8:.3f} s; qwen2-0.5b sharded {q['tokens_per_s']:.1f} "
        f"train tokens/s, peak {q['peak'] / 1e9:.3f} GB, {q['nccl']} NCCL kernels a step; "
        f"whisper-base sharded {w['tokens_per_s']:.1f} train tokens/s, elastic save "
        f"{w['save_gb_s']:.4f} GB/s, recon {w['recon_gb_s']:.4f} GB/s, restore "
        f"{w['restore_gb_s']:.4f} GB/s ({card})")
    elapsed("phase 8")
    # phases 9-12 (TP_PHASES): tensor and expert parallelism over "model" (9), its fallback
    # layouts (10), sequence sharding for serving (11), the two composed (12); ranks sharing
    # the card, the flash launches counted from zero on each rank inside
    for phase in (p for p in TP_PHASES if p < 13):
        run_tp_phase(args.seed, card, args.out, counts, worst, phase)
        elapsed(f"phase {phase}")
    # phase 13: the dry run against the card, the examples, each counted from zero inside
    drive_dryrun(args.seed, card, args.out, counts)
    elapsed("phase 13")
    # phase 14 (TP_PHASES): sequence sharding for the MoE, VLM and encoder-decoder families
    run_tp_phase(args.seed, card, args.out, counts, worst, 14)
    elapsed("phase 14")

    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
        entry["max_abs_err"] = max(entry["max_abs_err"], worst.get(entry["name"], 0))
    log(f"total: {time.perf_counter() - t_start:.3f} s ({card})")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: e[key] for key in order} for e in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
