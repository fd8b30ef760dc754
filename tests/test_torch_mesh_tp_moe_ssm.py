"""Tensor and expert parallelism over "model" on gloo CPU ranks, against
the port's single-device steps, for olmoe-1b-7b and mamba2-2.7b on (data=1,
model=2) and (data=2, model=2): the cases, criteria and single-device
counterparts of ``tests/_torch_mesh_tp.py`` (split from
``test_torch_mesh_tp.py`` for the test workers' time; JAX-free)."""
from __future__ import annotations

import pytest

import _torch_mesh_tp as _tp  # noqa: I001  (tests/ helper)

CASES = [(a, m) for a in ("olmoe_1b_7b", "mamba2_2_7b") for m in ("1x2", "2x2")]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _tp.make_runs(tmp_path_factory)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_train_step_holds_against_the_single_device_step(runs, arch, mesh):
    _tp.tp_train_step_holds_against_the_single_device_step(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_replicated_leaves_gradients_are_summed_over_model(runs, arch, mesh):
    _tp.replicated_leaves_gradients_are_summed_over_model(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_prefill_and_decode_meet_the_serving_criterion(runs, arch, mesh):
    _tp.tp_prefill_and_decode_meet_the_serving_criterion(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_serving_equals_the_ranks_rounding_on_one_device(runs, arch, mesh):
    _tp.tp_serving_equals_the_ranks_rounding_on_one_device(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_tp_steps_make_their_collectives_over_model(runs, arch, mesh):
    _tp.tp_steps_make_their_collectives_over_model(runs, arch, mesh)
