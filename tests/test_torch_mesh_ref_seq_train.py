"""The port's sequence-sharded train step against the reference's, at B = 1
on Auto meshes whose batch axes B does not fill: the reference shards the
sequence over them (``batch_shardings`` through its ``token_spec``) and its
``make_train_step`` is then a sequence-sharded step, partitioned by GSPMD.

Meshes and models, all run as models that are not pure data-parallel:

- (data=2, model=1): reduced qwen2-0.5b, gemma3-1b (its window-32 local
  layer and its global layer), mamba2-2.7b, and zamba2-7b at 2 layers (one
  group of two Mamba2 layers and the shared block);
- (data=2, model=2): qwen2-0.5b and mamba2-2.7b in the split layouts
  (heads and SSM heads on "model", Megatron-SP around them);
- (data=2, model=4): ``_torch_seq_fallback.MODEL4``'s qwen2-0.5b, whose
  heads, FFN and vocab do not divide "model" (the fallback layouts).

Both packages start from the reference's parameters
(``init_params(PRNGKey(0))``) and its ``make_inputs`` batch (1 x 256,
seed 1). The reference runs every mesh and model in one subprocess
(``_torch_mesh_oracle.reference_seq_train_run``); the port runs on gloo
ranks (``_torch_mesh_ranks``, case ``seq_train``), one launch a mesh. The
step is held by ``_torch_train_criteria.hold_step``: the loss within 2e-2,
each moment within 5e-2 (m) and 1e-1 (v) relative L2, each parameter
within 1 bf16 ulp + 2 lr, and within 1 ulp on at least 98 % of each leaf.
The first step's m is (1 - b1) times the clipped gradient, so m's bound is
the gradient's.

Its nudge policy (``hold_step``: each probe is another correct rounding of
the same step; where one misses the criteria, they widen by its distance,
up to NUDGE_CAP tolerances) takes three probes, all of the port's
one-device bf16 step:

- the one-ulp nudges (``ssd_nudged`` for the SSM families, ``norm_nudged``
  for the others) against it. At 1 x 256 they flip no bf16 rounding here
  and move nothing;
- on "model" > 1, the step with its row-parallel products rounded as the
  ranks round them (``tp_rounding``) against it. From random weights
  reduced qwen2-0.5b's bf16 step is ill-conditioned under them: they move
  the port's step by up to 0.197 in m (3.9 tolerances), and the
  reference's own (1, 2) layout moves its step from its one-device step by
  0.236;
- for reduced zamba2, the reference's one-device step (its (1, 1) mesh,
  in the same subprocess) against it: the two packages' one-device steps
  lie 0.052 apart in A_log's m (16 values: the packages' f32 SSD sums in
  another order), a distance that no sharding adds. The other models'
  one-device steps lie within the criteria of each other (at most 0.011,
  reduced qwen2-0.5b's bk), so this probe would widen nothing there.

The reference's sequence sharding on a (2, 1) mesh moves its step by
nothing (equal bit for bit to its one-device step at these inputs), and
the port's moves its step within the criteria.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.tree import named_leaves

from _torch_mesh_oracle import (  # noqa: I001  (tests/ helper)
    reference_inputs,
    reference_seq_train_run,
)
from _torch_mesh_ranks import run_ranks
from _torch_seq_fallback import MODEL4
from _torch_train_criteria import (
    hold_step,
    norm_nudged,
    ssd_nudged,
    step_metrics,
    tp_rounding,
)

S, LR, TIMEOUT = 256, 3e-4, 180
NAMES = ("data", "model")
# key -> (arch, overrides)
ARCHS = {"qwen2_0_5b": ("qwen2_0_5b", {}), "gemma3_1b": ("gemma3_1b", {}),
         "mamba2_2_7b": ("mamba2_2_7b", {}), "zamba2_7b": ("zamba2_7b", {"n_layers": 2}),
         "qwen2_0_5b-fallback": ("qwen2_0_5b", MODEL4["qwen2_0_5b"])}
# label -> (shape, names, the keys run there)
MESHES = {"2x1": ((2, 1), NAMES, ["qwen2_0_5b", "gemma3_1b", "mamba2_2_7b", "zamba2_7b"]),
          "2x2": ((2, 2), NAMES, ["qwen2_0_5b", "mamba2_2_7b"]),
          "2x4": ((2, 4), NAMES, ["qwen2_0_5b-fallback"])}
CASES = [(label, key) for label, (_, _, keys) in MESHES.items() for key in keys]
ONE = {"1x1": ((1, 1), NAMES, ["zamba2_7b"])}  # the reference's one-device steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results: label -> key -> step, the port's: label ->
    each rank's results, the inputs: key -> (cfg, params, batch))."""
    inputs = {}
    for key, (arch, overrides) in ARCHS.items():
        cfg, jp, (batch, _) = reference_inputs(arch, overrides, B=1, S=S)
        inputs[key] = cfg, jp, batch
    work = tmp_path_factory.mktemp("seq_train_ref")
    pool = ThreadPoolExecutor(1)  # the reference's subprocess runs while the port's ranks do
    ref = pool.submit(reference_seq_train_run, {**MESHES, **ONE}, {
        key: dict(arch=ARCHS[key][0], overrides=ARCHS[key][1], max_pos=S,
                  params=dict(named_leaves(jp)), batch=batch)
        for key, (_, jp, batch) in inputs.items()}, work / "reference", lr=LR)
    try:
        port = {label: run_ranks("seq_train", int(np.prod(shape)), work / label, dict(
            shape=shape, names=names, max_pos=S, lr=LR,
            runs={key: dict(arch=ARCHS[key][0], overrides=ARCHS[key][1],
                            params=params_from_numpy(inputs[key][1]),
                            batch={k: tensor_from_numpy(v) for k, v in inputs[key][2].items()})
                  for key in keys}), timeout=TIMEOUT)
            for label, (shape, names, keys) in MESHES.items()}
        ref = ref.result()
    finally:
        pool.shutdown()
    return ref, port, inputs


def _probes(cfg, jp, batch, n_model: int, ref_one: dict | None) -> list:
    """``hold_step``'s probes (module docstring), each the ``step_metrics``
    of another correct rounding against the port's one-device step (no
    gradients): the nudges up and down; ``tp_rounding(n_model)`` where
    ``n_model`` > 1; the reference's one-device step ``ref_one``, where
    given."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    model = build_model(cfg, max_pos=S, device="cpu")
    params = params_from_numpy(jp)
    tb = {k: tensor_from_numpy(v) for k, v in batch.items()}
    step = make_train_step(model, None, AdamWConfig(lr=LR))
    p1, o1, _ = step(params, adamw_init(params), tb)
    nudge = ssd_nudged if cfg.is_ssm else norm_nudged
    roundings = [nudge(np.inf), nudge(-np.inf)] + ([tp_rounding(n_model)] if n_model > 1 else [])
    out = []
    for rounding in roundings:
        with rounding:
            pn, on, _ = step(params, adamw_init(params), tb)
        out.append((step_metrics(pn, on, p1, o1, LR), None))
    if ref_one is not None:
        ref_opt = {"m": ref_one["m"], "v": ref_one["v"]}
        out.append((step_metrics(ref_one["params"], ref_opt, p1, o1, LR), None))
    return out


@pytest.mark.parametrize("mesh,key", CASES, ids=[f"{k}-{m}" for m, k in CASES])
def test_seq_train_step_holds_against_the_references(runs, mesh, key):
    ref, port, inputs = runs
    want = ref[mesh][key]
    ranks = port[mesh]
    got = ranks[0][key]
    assert got["misplaced"] == {}
    assert all(r[key]["loss"] == got["loss"] for r in ranks)
    assert abs(got["loss"] - want["loss"]) <= 2e-2, (got["loss"], want["loss"])
    assert int(got["opt"]["step"]) == 1
    held, verdict, failures = hold_step(
        step_metrics(got["params"], got["opt"], want["params"],
                     {"m": want["m"], "v": want["v"]}, LR),
        nudged=_probes(*inputs[key], MESHES[mesh][0][1], ref["1x1"].get(key)))
    assert held and not failures, (verdict, failures)
