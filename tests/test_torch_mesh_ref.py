"""The port's sharded train step and prefill against the reference's, on
(data=2, model=1) for qwen2-0.5b, olmoe-1b-7b and mamba2-2.7b, and on
(data=2, model=2) for whisper-base (pure data-parallel: its batch sharded
over both axes); and tensor and expert parallel over "model", on (data=1,
model=2) and (data=2, model=2) for qwen2-0.5b, olmoe-1b-7b and mamba2-2.7b
run as models that are not pure data-parallel (``pure_dp=False`` on both
sides: the reduced configs are below the threshold); reduced configs,
B = 4, S = 256 (the chunked cross-entropy runs: S > 128). The (pod=2, data=2, model=1) mesh is in
``test_torch_mesh_ref_pod.py``, and the tensor-parallel cases in
``test_torch_mesh_ref_tp.py``, so that the reference's compiles spread over
three test workers.

The reference runs in a subprocess on fake CPU devices, on a mesh with
Auto axes (``_torch_mesh_oracle``), the port on gloo ranks, from the same
parameters and batches:

- the step within the reference's own bound
  (``tests/test_dryrun_multidevice.py``): loss within 0.05, every
  parameter ``allclose(rtol=3e-2, atol=3e-2)``;
- the prefill's logits within the serving criterion of
  ``tests/test_torch_models.py`` (LOGIT_ATOL = 4 bf16 ulps at the logits'
  magnitude), against the reference's ``make_prefill_step(model, ctx)``
  with its attention swapped for its flash oracle. On a mesh the MoE layer
  routes each rank's tokens with a capacity from them, on both sides.
"""
import pytest

from _torch_mesh_oracle import (  # noqa: I001  (tests/ helper)
    LR,
    B,
    OracleCase,
    S,
    assert_prefill_meets_serving_criterion,
    assert_step_meets_reference_bound,
)

NAMES = ("data", "model")
MESH = ((2, 1), NAMES)
# id -> (arch, mesh, pure_dp override)
CASES = {"qwen2_0_5b": ("qwen2_0_5b", MESH, None), "olmoe_1b_7b": ("olmoe_1b_7b", MESH, None),
         "mamba2_2_7b": ("mamba2_2_7b", MESH, None),
         "whisper_base": ("whisper_base", ((2, 2), NAMES), None)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory) -> OracleCase:
    arch, (shape, names), pure_dp = CASES[request.param]
    return OracleCase(arch, shape, names, tmp_path_factory.mktemp(request.param),
                      B=B, S=S, lr=LR, pure_dp=pure_dp)


def test_sharded_step_meets_the_reference_bound(case):
    assert_step_meets_reference_bound(case)


def test_sharded_prefill_matches_the_reference(case):
    assert_prefill_meets_serving_criterion(case)
