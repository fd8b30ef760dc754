"""Debug tool: trace one cell and list the largest tensors live at its peak.

  PYTHONPATH=src python -m repro_torch.launch.buffers --arch X --shape Y \\
      [--multi-pod] [--rank N] [--top 16] [--min-gb 0.2]

The port's counterpart of the reference's ``repro.launch.hlo_buffers``,
which compiles the cell and lists its largest HLO buffers. Here the cell's
step is traced as one rank (``launch.dryrun.trace_rank``: fake tensors, a
fake process group, no card) and the storages live at the step's peak are
listed, largest first, each with the operation that made it and the
innermost function of the port that called it (``argument`` for the
step's inputs); then the operations that move the most HBM bytes.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import trace_rank


def list_buffers(top_live: list[dict], min_gb: float = 0.2) -> list[str]:
    """One line a storage of at least ``min_gb`` GB, largest first."""
    return [f"{r['bytes'] / 1e9:7.2f} GB  {r['dtype']}{r['shape']}  {r['op']}  {r['where']}"
            for r in top_live if r["bytes"] >= min_gb * 1e9]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--min-gb", type=float, default=0.2)
    args = ap.parse_args(argv)
    record, count, _ = trace_rank(args.arch, args.shape, args.multi_pod, args.rank,
                                  top=args.top)
    mem = record["memory"]
    print(f"rank {args.rank} {tuple(record['coordinate'])}: peak {count.peak_bytes / 1e9:.3f} GB "
          f"(argument {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB)")
    print("\n".join(list_buffers(count.top, args.min_gb)) or
          f"(no tensor of {args.min_gb} GB or more live at the peak)")
    print("HBM bytes by operation:")
    for op, n in sorted(count.bytes_by_op.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"{n / 1e9:10.2f} GB  {op}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
