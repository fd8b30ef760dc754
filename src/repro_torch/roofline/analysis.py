"""Three-term roofline of one rank's step, from the dry run's counts.

  compute    = FLOPs / peak FLOP/s               (per rank)
  memory     = HBM bytes / HBM bandwidth
  collective = collective bytes / (link bandwidth x links)

The port of the reference's ``repro.roofline.analysis``: the same
``HardwareSpec``, ``V5E`` (kept so that the two packages' reports can be
held against each other) and ``roofline_report``. The counts come from a
trace of the step (``roofline.op_count``), not from compiled HLO text, so
the reference's HLO parsers (``collective_bytes_from_hlo``,
``scan_weighted_collective_bytes``) have no input here: the port's
counterpart is ``op_count.count_step``, whose collectives take the same
per-kind wire model, and whose eager trace runs every layer (no loop body
to weight by its trip count).

``H100`` is the card the port runs on, from NVIDIA's H100 Tensor Core GPU
datasheet, SXM5 column: 989 TFLOP/s dense bf16 (1979 is with sparsity),
3.35 TB/s of HBM3, 80 GB, and NVLink 4 at 900 GB/s, 18 links at 25 GB/s
each way. Each figure is the card's largest, so that the step time it gives
stays a lower bound: the peak is the tensor cores' bf16 rate (f32 work
runs slower), and a link counts both directions (``link_bw`` 50 GB/s a
link, ``links`` 18: 900 GB/s a card). A production mesh of 256 or 512 ranks
spans many 8-card NVLink hosts, and a collective over ranks of several
hosts crosses InfiniBand (~50 GB/s a card each way), so there the
collective term is optimistic by an order of magnitude.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu_v5e"
    peak_flops: float = 197e12      # bf16 per chip
    hbm_bw: float = 819e9           # bytes/s per chip
    link_bw: float = 50e9           # bytes/s per link
    hbm_bytes: float = 16e9
    links: int = 4                  # links per chip (roofline_report's links_per_chip)


V5E = HardwareSpec()
H100 = HardwareSpec(name="h100_sxm5", peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9,
                    hbm_bytes=80e9, links=18)


def roofline_report(
    *,
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    n_chips: int,
    model_flops: float,
    hw: HardwareSpec = V5E,
    links_per_chip: int = 4,
) -> dict:
    """All terms in seconds-per-step, per chip (one rank's step)."""
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_coll = collective_bytes / (hw.link_bw * links_per_chip)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops / max(1.0, flops * n_chips)
    return {
        **terms,
        "dominant": dom,
        "step_time_lower_bound": bound,
        "mfu_upper_bound": (model_flops / n_chips / hw.peak_flops) / bound if bound else 0.0,
        "model_flops_ratio": useful,
    }
