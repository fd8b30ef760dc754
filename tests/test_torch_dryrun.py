"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline.op_count``):
its fake trace counts what the step runs, it runs production cells as one
rank of the production mesh with no card, and nothing in it falls back.

- **The fake trace is faithful.** For one reduced config of each family, the
  train step and the prefill traced on fake tensors count the same FLOPs,
  HBM bytes, live bytes at the start and at the peak, and outputs as the
  same step run on real CPU tensors: on one process (no mesh), and on a
  (data=1, model=2) mesh, where each rank's trace over a fake process group
  also counts the same collectives, by kind and by bytes, as two real gloo
  ranks running the step, and as ``MeshCtx.counts`` shows. The real runs
  send the flash call through the kernel's operator
  (``_torch_dryrun.flash_as_operator``), as the card does.
- **Production cells**: ``gemma3_1b long_500k`` on (2, 16, 16),
  ``qwen2_0_5b decode_32k`` and ``olmoe_1b_7b prefill_32k`` on (16, 16),
  run by the CLI at rank 0 and the last rank: status ``ok``, the
  reference's keys, the collectives ``MeshCtx.counts`` made, the flash
  calls a prefill makes (one an attention layer).
- **No fallback**: ``resolve_device("cuda")`` raises without a card outside
  a ``FakeTensorMode``; a ``MeshCtx`` on a fake process group's mesh that
  ``make_dryrun_mesh`` did not mark raises; a real tensor given to a step on
  the dry run's mesh raises; the flash operator's fake body raises for a
  real tensor.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.roofline.op_count import count_step, ctx_calls
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.steps import make_prefill_step, make_train_step
from repro_torch.tree import tree_map

from _torch_dryrun import (  # noqa: I001  (tests/ helper)
    FAMILIES,
    FIELDS,
    KINDS,
    counts_of,
    flash_as_operator,
    model_for,
    real,
    run_fake_ranks,
    shape_of,
)
from _torch_mesh_ranks import run_ranks

ROOT = Path(__file__).resolve().parents[1]
# the reference's keys of a cell's record that the port keeps (its lower_s,
# compile_s, cost_analysis_raw and unknown_trip_whiles go; trace_s comes)
KEYS = {"status", "arch", "shape", "mesh", "n_chips", "trace_s", "memory",
        "per_chip_live_bytes", "fits_hbm", "flops_per_chip", "bytes_per_chip",
        "collective_bytes", "collective_bytes_total", "model_flops", "n_active_params",
        "roofline"}
ROOFLINE_KEYS = {"compute", "memory", "collective", "dominant", "step_time_lower_bound",
                 "mfu_upper_bound", "model_flops_ratio"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}
# (arch, shape, multi-pod, ranks, flash calls a rank)
CELLS = (("gemma3_1b", "long_500k", True, (0, 511), 0),
         ("qwen2_0_5b", "decode_32k", False, (0, 255), 0),
         ("olmoe_1b_7b", "prefill_32k", False, (0, 255), 16))


def _single(arch: str, kind: str, fake: bool) -> dict:
    """The counts of ``arch``'s one-device step of ``kind`` on fake or real
    CPU tensors."""
    with FakeTensorMode() if fake else flash_as_operator():
        model = model_for(arch)
        make = (lambda shp, dtype: torch.empty(shp, dtype=dtype)) if fake else \
            (lambda shp, dtype: real(shp, dtype, "cpu"))
        params = tree_map(lambda sd: make(tuple(sd[0]), sd[1]), model.param_template())
        from repro_torch.models.registry import input_specs
        batch = {k: make(shp, dtype) for k, (shp, dtype) in
                 input_specs(model.cfg, shape_of(kind)).items()}
        if kind == "train":
            step, args = make_train_step(model), (params, adamw_init(params), batch)
        else:
            step, args = make_prefill_step(model), (params, {k: v for k, v in batch.items()
                                                             if k != "labels"})
        _, c = count_step(step, *args)
    return counts_of(c)


@pytest.fixture
def one_thread():
    """One intra-op thread for the real CPU steps (the suite's workers share
    the host's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_fake_trace_counts_what_the_step_runs_on_one_process(one_thread, family, kind):
    fake, want = _single(FAMILIES[family], kind, True), _single(FAMILIES[family], kind, False)
    for field in FIELDS:
        assert fake[field] == want[field], (field, fake[field], want[field])
    assert fake["flops"] > 0 and fake["peak_bytes"] > fake["argument_bytes"] > 0
    assert len(fake["flash"]) == (0 if kind == "train" or family == "ssm" else
                                  {"encdec": 6}.get(family, 2))


@pytest.fixture(scope="module")
def mesh_counts(tmp_path_factory):
    archs = list(FAMILIES.values())
    d = tmp_path_factory.mktemp("dryrun_mesh")
    return (run_fake_ranks({"archs": archs}, d / "fake"),
            run_ranks("dryrun_counts", 2, d / "real", {"archs": archs}))


@pytest.mark.parametrize("family", FAMILIES)
def test_fake_trace_counts_what_two_gloo_ranks_run(mesh_counts, family):
    fake, real_ranks = mesh_counts
    arch = FAMILIES[family]
    for rank in range(2):
        for kind in KINDS:
            got, want = fake[rank][arch, kind], real_ranks[rank][arch, kind]
            for field in FIELDS:
                assert got[field] == want[field], (rank, kind, field, got[field], want[field])
            assert got["collective_calls"] == got["ctx_calls"] == want["ctx_calls"]
            assert sum(got["collective_calls"].values()) > 0
            assert got["collective_bytes"] and all(v > 0 for v in got["collective_bytes"].values())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_cells")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--out", str(out)]
                              + (["--multi-pod"] if multi_pod else []), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for arch, shape, multi_pod, _, _ in CELLS]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return {(arch, shape): json.loads((out / f"{arch}__{shape}__{'pod2' if mp else 'pod1'}.json")
                                      .read_text())
            for arch, shape, mp, _, _ in CELLS}


@pytest.mark.parametrize("arch,shape,multi_pod,ranks,flash", CELLS,
                         ids=[f"{a}-{s}" for a, s, *_ in CELLS])
def test_production_cells_trace_at_the_first_and_last_rank(cells, arch, shape, multi_pod, ranks,
                                                           flash):
    d = cells[arch, shape]
    assert d["status"] == "ok" and KEYS <= set(d), sorted(KEYS - set(d))
    assert set(d["roofline"]) == ROOFLINE_KEYS and set(d["memory"]) == MEMORY_KEYS
    assert d["mesh"] == ("2x16x16" if multi_pod else "16x16") and d["hardware"] == "h100_sxm5"
    assert [r["rank"] for r in d["ranks"]] == list(ranks)
    for r in d["ranks"]:
        assert r["collective_calls"] == r["mesh_calls"] == ctx_calls(
            r["mesh_counts"], r["seq_rank"], r["n_seq"])
        assert r["flash_calls"] == flash
        assert r["per_chip_live_bytes"] == (r["memory"]["argument_size_in_bytes"]
                                            + r["memory"]["temp_size_in_bytes"])
        assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    assert d["per_chip_live_bytes"] == max(r["per_chip_live_bytes"] for r in d["ranks"])
    assert d["flops_per_chip"] == max(r["flops_per_chip"] for r in d["ranks"])
    r = d["roofline"]
    assert r["step_time_lower_bound"] == max(r["compute"], r["memory"], r["collective"]) > 0


def test_cuda_without_a_card_only_under_fake_tensor_mode():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: resolve_device accepts CUDA anyway")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with FakeTensorMode():
        assert resolve_device("cuda") == torch.device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def test_flash_fake_body_refuses_a_real_tensor():
    q = torch.zeros((1, 1, 4, 16))
    with pytest.raises(RuntimeError, match="real tensor"):
        fa._launch_fake(q, q, q, True, 0, 0)


_NO_FALLBACK = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_dryrun_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.train.steps import make_prefill_step
    seen = []
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        MeshCtx(init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model")))
    except ValueError as e:
        seen.append("unmarked: " + str(e))
    dist.destroy_process_group()
    ctx = MeshCtx(make_dryrun_mesh(rank=3, device="cpu"))
    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    try:
        make_prefill_step(model, ctx)(params, {"tokens": torch.zeros((256, 32), dtype=torch.int32)})
    except RuntimeError as e:
        seen.append("real: " + str(e))
    print(seen)
""")


def test_the_fake_backend_only_on_the_dry_runs_mesh_and_only_with_fake_tensors():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _NO_FALLBACK], env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    seen = p.stdout
    assert "unmarked: a cpu mesh runs over gloo; the process group's backend is 'fake'" in seen
    assert "real: a real tensor reached a step on the dry run's mesh" in seen

