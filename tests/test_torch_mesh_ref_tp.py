"""The port's tensor- and expert-parallel train step and prefill against the
reference's, on (data=1, model=2) and (data=2, model=2) for qwen2-0.5b,
olmoe-1b-7b and mamba2-2.7b run as models that are not pure data-parallel
(``pure_dp=False`` on both sides: the reduced configs are below the
threshold): the criteria and the oracle of ``test_torch_mesh_ref.py``, whose
data-parallel cases stay there (split for the test workers' time)."""
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
# id -> (arch, mesh, pure_dp override)
CASES = {f"{arch}-tp{'x'.join(map(str, shape))}": (arch, (shape, NAMES), False)
         for arch in ("qwen2_0_5b", "olmoe_1b_7b", "mamba2_2_7b")
         for shape in ((1, 2), (2, 2))}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory) -> OracleCase:
    arch, (shape, names), pure_dp = CASES[request.param]
    return OracleCase(arch, shape, names, tmp_path_factory.mktemp(request.param),
                      B=B, S=S, lr=LR, pure_dp=pure_dp)


def test_sharded_step_meets_the_reference_bound(case):
    assert_step_meets_reference_bound(case)


def test_sharded_prefill_matches_the_reference(case):
    assert_prefill_meets_serving_criterion(case)
