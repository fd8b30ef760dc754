"""The port's sharded train step and prefill against the reference's on
(pod=2, data=2, model=1), the reference multi-device test's mesh cut to a
"model" of 1 (tensor and expert parallelism are later slices), for
qwen2-0.5b, olmoe-1b-7b and mamba2-2.7b: the criteria and the oracle of
``test_torch_mesh_ref.py``."""
import pytest

from _torch_mesh_oracle import (  # noqa: I001  (tests/ helper)
    LR,
    B,
    OracleCase,
    S,
    assert_prefill_meets_serving_criterion,
    assert_step_meets_reference_bound,
)

MESH = ((2, 2, 1), ("pod", "data", "model"))


@pytest.fixture(scope="module", params=["mamba2_2_7b", "olmoe_1b_7b", "qwen2_0_5b"])
def case(request, tmp_path_factory) -> OracleCase:
    return OracleCase(request.param, *MESH, tmp_path_factory.mktemp(request.param), B=B, S=S,
                      lr=LR)


def test_sharded_step_meets_the_reference_bound_on_pods(case):
    assert_step_meets_reference_bound(case)


def test_sharded_prefill_matches_the_reference_on_pods(case):
    assert_prefill_meets_serving_criterion(case)
