"""Dry run: trace every (arch x shape x mesh) cell's step as one rank of the
production mesh, on fake tensors, with no card.

The port of the reference's ``repro.launch.dryrun``, which lowers and
compiles each cell's jitted step on 512 host placeholder devices. The port
compiles nothing: it runs the step itself, as rank ``r`` of the (16, 16) or
(2, 16, 16) mesh, on fake tensors (``FakeTensorMode``: shapes and dtypes,
no data; on the card's device where this torch is built for CUDA,
``DEVICE``) over a fake process group (``launch.mesh.make_dryrun_mesh``:
its collectives move nothing), under ``roofline.op_count.count_step``, and
records for that rank:

  * memory: the bytes live at the step's start (``argument``: its
    parameters, optimizer state, cache and the global batch the port's
    steps take), the peak less that (``temp``), the outputs, and those held
    in argument storage (``alias``: the decode cache written in place);
    ``per_chip_live_bytes`` is the peak, ``fits_hbm`` against ``H100``;
  * FLOPs, HBM bytes and collective bytes by kind (``op_count``'s models),
    with the collective calls held against ``MeshCtx.counts`` kind by kind;
  * the roofline report against ``H100`` (compute/memory/collective
    seconds, the dominant term, ``mfu_upper_bound``).

The causal imbalance of a sequence-sharded cell and the fallback layouts
make ranks differ, so by default rank 0 and the last rank are traced (one
after the other in this process) and each is reported under ``ranks``; the
top-level figures are the largest over them. The inputs are the step's: a
train step's parameters and moments as DTensors in the storage layout
(``training_state_specs``: ZeRO over the batch axes, which the step gathers
back), a prefill's and a decode's parameters in the layout the step computes
in (``param_specs`` where it runs tensor-parallel, else whole), the decode
cache as ``cache_specs``, and the batch of ``input_specs`` whole (the port's
steps take the global batch on every rank), with the decode's ``cur_len`` a
host int.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
      --shape train_4k [--multi-pod] [--rank N] [--out runs/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]

``--all`` runs every catalog arch x ``shapes_for`` x both meshes, one
subprocess a cell (the process group is the process's own). No JAX and no
card are needed; the same command runs on the card's machine.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, shapes_for
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.models.registry import build_model, input_specs
from repro_torch.models.sharding import MeshCtx, NamedSharding
from repro_torch.roofline.analysis import H100, roofline_report
from repro_torch.roofline.op_count import StepCount, count_step, ctx_calls
from repro_torch.train.steps import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
    training_state_shapes,
    training_state_specs,
)
from repro_torch.tree import tree_map

# the fake tensors' device: the card's, where this torch is built for CUDA (it
# needs no card); a CPU-only torch cannot index or differentiate fake CUDA
# tensors (both take a CUDA device guard, which such a build lacks), so there
# they lie on the CPU. Nothing runs on either, the counts do not depend on it,
# and the flash call counts as the kernel on both (``flash_attention`` sends
# every fake tensor to the kernel's operator)
DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


def local_shape(shape: tuple, sharding: NamedSharding) -> tuple[int, ...]:
    """This rank's block of a tensor of global ``shape`` laid out as
    ``sharding``: each mesh dim that shards a tensor dim splits it as
    ``torch.chunk`` does (blocks of ceil(n / k), the last ones shorter or
    empty), in mesh order, outermost first."""
    out = list(shape)
    coord = sharding.mesh.get_coordinate()
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n, k = out[p.dim], sharding.mesh.size(i)
            chunk = -(-n // k)
            out[p.dim] = max(0, min(chunk, n - coord[i] * chunk))
    return tuple(out)


def empty(shape: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The dry run's tensors: ``torch.empty`` (under ``FakeTensorMode``, a
    fake tensor: no data)."""
    return torch.empty(shape, dtype=dtype, device=device)


def step_inputs(model, ctx: MeshCtx, shape: ShapeConfig, device: str = DEVICE,
                make: Callable = empty) -> tuple[Callable, tuple]:
    """The step of ``shape``'s kind on ``ctx`` and its arguments, each tensor
    made by ``make(shape, dtype, device)``: a train step's parameters and
    moments as DTensors in the storage layout (``training_state_specs``), a
    prefill's and a decode's parameters in the layout the step computes in
    (``param_specs`` where it runs tensor-parallel, else whole), the decode
    cache laid out as ``cache_specs``, each DTensor's local block this
    rank's block shape; and the global batch of ``input_specs`` (the
    decode's ``cur_len`` a host int, half the cache)."""
    def tree(template, specs):
        def leaf(sd, ns):
            block = make(local_shape(tuple(sd[0]), ns), sd[1], device)
            stride = torch.empty(tuple(sd[0]), dtype=sd[1], device="meta").stride()
            return DTensor.from_local(block, ns.mesh, ns.placements, run_check=False,
                                      shape=torch.Size(sd[0]), stride=stride)
        return tree_map(leaf, template, specs)

    batch = {k: shape.seq_len // 2 if k == "cur_len" else make(shp, dtype, device)
             for k, (shp, dtype) in input_specs(model.cfg, shape).items()}
    whole = tree_map(lambda _: ctx.replicated(), model.param_template())
    if shape.kind == "train":
        pshapes, oshapes = training_state_shapes(model)
        pspecs, ospecs = training_state_specs(model, ctx)
        return make_train_step(model, ctx), (tree(pshapes, pspecs), tree(oshapes, ospecs), batch)
    if shape.kind == "prefill":
        pspecs = model.param_specs(ctx) if model.tp_ctx(ctx) is not None else whole
        return make_prefill_step(model, ctx), (tree(model.param_template(), pspecs), batch)
    pspecs = (model.param_specs(ctx, serve=model.pure_dp)
              if model.tp_ctx(ctx, serve=True) is not None else whole)
    B, S = shape.global_batch, shape.seq_len
    cache = tree(model.cache_template(B, S), model.cache_specs(B, S, ctx))
    return make_serve_step(model, ctx), (tree(model.param_template(), pspecs), cache, batch)


def sequence_place(ctx: MeshCtx, model, global_batch: int, kind: str) -> tuple[int, int]:
    """(this rank's place, the ranks) in the sequence where the step shards
    it over the batch axes (``LM.seq_ctx``), else (0, 1)."""
    sp = model.seq_ctx(ctx, global_batch, train=kind == "train")
    return (ctx.seq_rank, ctx.n_batch) if sp is not None else (0, 1)


def check_collectives(count: StepCount, ctx: MeshCtx, model, global_batch: int,
                      kind: str) -> dict:
    """``MeshCtx.counts`` as c10d calls by kind (``ctx_calls``); raises
    unless they are the calls counted at dispatch."""
    want = ctx_calls(ctx.counts, *sequence_place(ctx, model, global_batch, kind))
    if count.collective_calls != want:
        raise AssertionError(f"collectives at dispatch {count.collective_calls} are not "
                             f"MeshCtx.counts' {dict(ctx.counts)} ({want})")
    return want


def trace_rank(arch: str, shape_name: str, multi_pod: bool, rank: int,
               top: int = 16) -> tuple[dict, StepCount, object]:
    """One rank's step traced: (its record, its ``StepCount``, the model).
    Starts the fake process group at ``rank`` and destroys it after."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = make_dryrun_mesh(multi_pod=multi_pod, rank=rank, device=DEVICE)
    try:
        ctx = MeshCtx(mesh)
        with FakeTensorMode():
            model = build_model(cfg, max_pos=shape.seq_len, device=DEVICE)
            step, args = step_inputs(model, ctx, shape)
            ctx.counts.clear()
            _, c = count_step(step, *args, top=top)
        mesh_calls = check_collectives(c, ctx, model, shape.global_batch, shape.kind)
        seq_rank, n_seq = sequence_place(ctx, model, shape.global_batch, shape.kind)
        record = {
            "rank": rank,
            "coordinate": list(mesh.get_coordinate()),
            "trace_s": round(c.seconds, 2),
            "memory": {"argument_size_in_bytes": c.argument_bytes,
                       "output_size_in_bytes": c.output_bytes,
                       "temp_size_in_bytes": c.peak_bytes - c.argument_bytes,
                       "alias_size_in_bytes": c.alias_bytes},
            "per_chip_live_bytes": c.peak_bytes,
            "flops_per_chip": float(c.flops),
            "bytes_per_chip": float(c.hbm_bytes),
            "collective_bytes": c.collective_bytes,
            "collective_bytes_total": c.collective_bytes_total,
            "collective_calls": c.collective_calls,
            "mesh_counts": dict(ctx.counts),
            "mesh_calls": mesh_calls,
            "seq_rank": seq_rank,
            "n_seq": n_seq,
            "flash_calls": c.flash_calls,
            "top_live": c.top,
        }
        return record, c, model
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               ranks: tuple[int, ...] | None = None) -> dict:
    """The cell's record: each traced rank's (``ranks``; by default rank 0
    and the last) and, at the top level, the largest of each figure over
    them, with the roofline report of those."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"status": "skipped", "reason": "pure full-attention arch (DESIGN.md §4)"}
    n_chips = 512 if multi_pod else 256
    ranks = (0, n_chips - 1) if ranks is None else tuple(ranks)
    per_rank, model = [], None
    for r in ranks:
        record, _, model = trace_rank(arch, shape_name, multi_pod, r)
        per_rank.append(record)
    top = max(per_rank, key=lambda d: d["per_chip_live_bytes"])
    flops = max(d["flops_per_chip"] for d in per_rank)
    nbytes = max(d["bytes_per_chip"] for d in per_rank)
    coll_rank = max(per_rank, key=lambda d: d["collective_bytes_total"])
    nmodel = model.n_active_params()
    # MODEL_FLOPS: 6·N·D tokens for train; 2·N·D for forward-only
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    model_flops = factor * nmodel * tokens
    report = roofline_report(
        flops=flops, bytes_accessed=nbytes,
        collective_bytes=coll_rank["collective_bytes_total"], n_chips=n_chips,
        model_flops=model_flops, hw=H100, links_per_chip=H100.links,
    )
    live = top["per_chip_live_bytes"]
    return {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "trace_s": round(sum(d["trace_s"] for d in per_rank), 2),
        "memory": top["memory"],
        "per_chip_live_bytes": int(live),
        "fits_hbm": bool(live <= H100.hbm_bytes),
        "flops_per_chip": flops,
        "bytes_per_chip": nbytes,
        "collective_bytes": coll_rank["collective_bytes"],
        "collective_bytes_total": coll_rank["collective_bytes_total"],
        "model_flops": model_flops,
        "n_active_params": nmodel,
        "hardware": H100.name,
        "roofline": report,
        "ranks": per_rank,
    }


def cells() -> list[tuple[str, str, bool]]:
    """Every catalog arch x ``shapes_for`` x both production meshes."""
    return [(a, s.name, mp) for mp in (False, True) for a, cfg in all_archs().items()
            for s in shapes_for(cfg)]


def _run_one(args) -> int:
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "pod2" if args.multi_pod else "pod1"
    path = outdir / f"{args.arch}__{args.shape}__{mesh_tag}.json"
    try:
        res = lower_cell(args.arch, args.shape, args.multi_pod,
                         None if args.rank is None else (args.rank,))
    except Exception as e:
        res = {
            "status": "error",
            "arch": args.arch,
            "shape": args.shape,
            "mesh": mesh_tag,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    path.write_text(json.dumps(res, indent=2, default=str))
    ok = res["status"]
    print(f"[{ok}] {args.arch} {args.shape} {mesh_tag}")
    if ok == "ok":
        print(json.dumps({k: res[k] for k in ("per_chip_live_bytes", "fits_hbm",
                                              "flops_per_chip", "collective_bytes_total")},
                         indent=2))
        print("memory:", json.dumps(res["memory"]))
        print("roofline:", json.dumps(res["roofline"]))
    elif ok == "error":
        print(res["error"])
        print(res["traceback"][-1500:])
    return 0 if ok != "error" else 1


def _run_all(args) -> int:
    """Each cell in a subprocess of its own, ``--jobs`` at a time."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

    def one(cell) -> tuple[tuple, int, str, float]:
        arch, shape, multi_pod = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--out", str(args.out)] + (["--multi-pod"] if multi_pod else [])
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=env, capture_output=True, text=True)
        return cell, p.returncode, (p.stdout + p.stderr).splitlines()[0] if (p.stdout or
                                                                            p.stderr) else "", \
            time.perf_counter() - t0

    todo = cells()
    failed = 0
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        for (arch, shape, mp), rc, line, wall in pool.map(one, todo):
            failed += rc != 0
            print(f"{line} ({wall:.1f} s)", flush=True)
    print(f"{len(todo) - failed} of {len(todo)} cells ok; JSON in {args.out}")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, help="trace this rank alone (default: 0 and the last)")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="every catalog arch x shapes_for x both meshes, a subprocess a cell")
    ap.add_argument("--jobs", type=int, default=max(1, min(4, (os.cpu_count() or 2) // 2)),
                    help="cells traced at once with --all")
    args = ap.parse_args(argv)
    if args.all:
        return _run_all(args)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --all")
    return _run_one(args)


if __name__ == "__main__":
    sys.exit(main())
