"""One train step of the hybrid family (zamba2-7b) (reduced configs, on the CPU) on both
packages, against the reference's jitted step: the loss, the gradients,
the step and a second step from the carried state
(``_torch_train_pair``, which states the compiles and the tolerances).
"""
import pytest

from _torch_train_pair import (  # noqa: F401  (tests/ helper: its tests run here)
    TrainPair,
    test_grads_match_reference,
    test_loss_matches_reference,
    test_second_step_from_the_carried_state,
    test_train_step_matches_reference,
)


@pytest.fixture(scope="module", params=['zamba2_7b'])
def pair(request) -> TrainPair:
    return TrainPair(request.param)
