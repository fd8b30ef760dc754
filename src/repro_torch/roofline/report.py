"""Render the dry run's and the roofline's tables from runs/dryrun_torch/*.json.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir runs/dryrun_torch]

The port of the reference's ``repro.roofline.report``: ``roofline_table``
and ``pick_hillclimb`` print what the reference's print for the same rows;
``dryrun_table``'s time column is the port's trace seconds (``trace_s``,
host seconds of the traced ranks) where the reference's is lower + compile.
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path


def load(dirname: str) -> list[dict]:
    out = []
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        d = json.load(open(f))
        d["_cell"] = Path(f).stem
        out.append(d)
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(rows: list[dict], mesh: str = "pod1") -> str:
    lines = [
        "| arch | shape | comp (s) | mem (s) | coll (s) | dominant | "
        "MODEL/HLO flops | MFU ub | live GB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in rows:
        if not d["_cell"].endswith(mesh):
            continue
        arch, shape, _ = d["_cell"].split("__")
        if d["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | — | — | *skip: full attention* | — | — | — | — |")
            continue
        if d["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR {d.get('error','')[:40]} |" + " — |" * 8)
            continue
        r = d["roofline"]
        lines.append(
            f"| {arch} | {shape} | {fmt_s(r['compute'])} | {fmt_s(r['memory'])} | "
            f"{fmt_s(r['collective'])} | **{r['dominant']}** | "
            f"{r['model_flops_ratio']:.2f} | {r['mfu_upper_bound']*100:.2f}% | "
            f"{d['per_chip_live_bytes']/1e9:.1f} | {'✓' if d['fits_hbm'] else 'OOM'} |"
        )
    return "\n".join(lines)


def dryrun_table(rows: list[dict]) -> str:
    lines = [
        "| cell | mesh | chips | trace (s) | per-chip live (GB) | fits "
        "| per-chip HLO GFLOPs | collective GB |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for d in rows:
        if d["status"] == "skipped":
            continue
        arch, shape, mesh = d["_cell"].split("__")
        if d["status"] != "ok":
            lines.append(f"| {arch}/{shape} | {mesh} | ERROR |" + " — |" * 5)
            continue
        lines.append(
            f"| {arch}/{shape} | {d['mesh']} | {d['n_chips']} | "
            f"{d['trace_s']:.0f} | "
            f"{d['per_chip_live_bytes']/1e9:.2f} | {'✓' if d['fits_hbm'] else '✗'} | "
            f"{d['flops_per_chip']/1e9:.0f} | {d['collective_bytes_total']/1e9:.2f} |"
        )
    return "\n".join(lines)


def pick_hillclimb(rows: list[dict]) -> list[str]:
    """worst roofline fraction / most collective-bound / most paper-
    representative (largest EC-checkpointable state = biggest model train)."""
    ok = [d for d in rows if d["status"] == "ok" and d["_cell"].endswith("pod1")]
    trains = [d for d in ok if "train" in d["_cell"]]
    worst = min(trains, key=lambda d: d["roofline"]["mfu_upper_bound"])
    coll = max(ok, key=lambda d: d["roofline"]["collective"] /
               max(1e-9, d["roofline"]["step_time_lower_bound"]))
    rep = max(trains, key=lambda d: d["n_active_params"])
    return [worst["_cell"], coll["_cell"], rep["_cell"]]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun_torch")
    args = ap.parse_args()
    rows = load(args.dir)
    print("## Roofline (single-pod 16x16)\n")
    print(roofline_table(rows, "pod1"))
    print("\n## Dry-run all cells\n")
    print(dryrun_table(rows))
    print("\nhillclimb candidates:", pick_hillclimb(rows))
