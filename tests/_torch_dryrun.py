"""Shared by the dry run's tests (JAX-free): the reduced configs they trace,
the flash call as the kernel's operator on real CPU tensors, and the traces
of one step on a fake or a real (data=1, model=2) mesh.

``flash_as_operator`` registers the plain version as the CPU kernel of
``torch.ops.repro_torch.flash_attention`` and, while it is entered, sends
the wrapper's CPU branch through that operator: a real CPU step then runs
the same operator sequence as the card's, which the dispatch-time counts
see as one call (its flop formula, its bytes, its output), so that the real
step counts what the fake trace counts. The port's CPU path is left as it
is outside the context.

Run as ``python _torch_dryrun.py <dir>``, this file traces
``args.pt``'s cases on a fake process group of 2 ranks (one at a time,
each rank its own group), as the dry run traces a production cell, and
saves each rank's counts to ``fake.pt``; ``_torch_mesh_ranks``' case
``dryrun_counts`` runs the same steps on 2 real gloo ranks.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

ROOT = Path(__file__).resolve().parents[1]
# one reduced config of each family
FAMILIES = {"dense": "qwen2_0_5b", "moe": "olmoe_1b_7b", "ssm": "mamba2_2_7b",
            "hybrid": "zamba2_7b", "encdec": "whisper_base", "vlm": "qwen2_vl_7b"}
B, S, MAX_POS = 4, 256, 256  # S > 128: the chunked cross-entropy runs on a mesh
MESH = ((1, 2), ("data", "model"))
KINDS = ("train", "prefill")
# what a count compares: the StepCount fields both traces hold
FIELDS = ("flops", "hbm_bytes", "collective_calls", "collective_bytes", "argument_bytes",
          "peak_bytes", "output_bytes", "alias_bytes", "flash")

_registered = False


def _register() -> None:
    global _registered
    if not _registered:
        torch.library.register_kernel(
            "repro_torch::flash_attention", "cpu",
            lambda q, k, v, causal, window, q_offset: flash_attention_ref(
                q, k, v, causal=causal, window=window, q_offset=q_offset))
        _registered = True


@contextlib.contextmanager
def flash_as_operator():
    _register()
    plain = fa.flash_attention_ref
    fa.flash_attention_ref = lambda q, k, v, *, causal, window, q_offset: \
        torch.ops.repro_torch.flash_attention(q, k, v, causal, window, q_offset)
    try:
        yield
    finally:
        fa.flash_attention_ref = plain


def model_for(arch: str, device: str = "cpu"):
    """The reduced config run as a model that is not pure data-parallel
    (its tensor parallelism runs on a mesh whose "model" is 2)."""
    from repro_torch.models.registry import build_model

    model = build_model(get_arch(arch).reduced(), max_pos=MAX_POS, device=device)
    model.pure_dp = False
    return model


def shape_of(kind: str, batch: int = B) -> ShapeConfig:
    return ShapeConfig(kind, S, batch, kind)


def real(shape: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A real tensor for a count: zeros (token ids within any vocab) or
    small normal values; what a count sees does not depend on them."""
    g = torch.Generator().manual_seed(sum(shape) + len(shape))
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 0.02).to(device, dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def counts_of(c) -> dict:
    return {**{f: getattr(c, f) for f in FIELDS}, "bytes_by_op": c.bytes_by_op}


def trace_mesh(archs, kinds=KINDS, fake: bool = True, mesh_of: tuple = MESH,
               batch: int = B) -> dict:
    """(arch, kind) -> this rank's counts of the step of ``batch`` rows on a
    (1, 2) mesh (or ``mesh_of``: (shape, names)) over the process group
    already started (fake: on fake tensors, the mesh marked as the dry
    run's; else on real CPU tensors, the flash call as the kernel's
    operator), with ``MeshCtx.counts`` as c10d calls."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import check_collectives, empty, step_inputs
    from repro_torch.models.sharding import DRYRUN, MeshCtx
    from repro_torch.roofline.op_count import count_step

    mesh = init_device_mesh("cpu", tuple(mesh_of[0]), mesh_dim_names=tuple(mesh_of[1]))
    if fake:
        setattr(mesh, DRYRUN, True)
    ctx = MeshCtx(mesh)
    out = {}
    for arch in archs:
        for kind in kinds:
            mode = FakeTensorMode() if fake else flash_as_operator()
            with mode:
                model = model_for(arch)
                step, args = step_inputs(model, ctx, shape_of(kind, batch), "cpu",
                                         empty if fake else real)
                ctx.counts.clear()
                _, c = count_step(step, *args)
            out[arch, kind] = {**counts_of(c), "mesh_counts": dict(ctx.counts),
                               "ctx_calls": check_collectives(c, ctx, model, batch, kind)}
    return out


def run_fake_ranks(args: dict, workdir: Path, world: int = 2) -> list[dict]:
    """``trace_mesh`` of ``args["archs"]`` on each rank of a fake process
    group of ``world`` (or on ``args["ranks"]`` alone), in one subprocess;
    each traced rank's result, in rank order."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(args, workdir / "args.pt")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, __file__, str(workdir), str(world)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return torch.load(workdir / "fake.pt", weights_only=False)


def main() -> int:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    workdir, world = Path(sys.argv[1]), int(sys.argv[2])
    args = torch.load(workdir / "args.pt", weights_only=False)
    torch.set_num_threads(1)
    out = []
    for rank in args.get("ranks", range(world)):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            out.append(trace_mesh(args["archs"], args.get("kinds", KINDS),
                                  mesh_of=args.get("mesh", MESH), batch=args.get("B", B)))
        finally:
            dist.destroy_process_group()
    torch.save(out, workdir / "fake.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())

