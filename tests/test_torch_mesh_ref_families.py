"""The port's tensor-parallel train step and prefill for the hybrid, VLM and
encoder-decoder families against the reference's sharded ones, on a
(data=1, model=2) mesh: reduced zamba2-7b, qwen2-vl-7b and whisper-base run
as models that are not pure data-parallel (``pure_dp=False`` on both
sides), B = 4, S = 256 (the chunked cross-entropy runs; whisper's encoder on
S/2 frames), from the reference's parameters and ``make_inputs`` batches.
whisper-base runs also with the odd vocab 257, on which both packages put
"model" on the embedding's d_model (the tied head's logits summed over
"model", the loss on whole logits), as at its own vocab 51865.

The reference runs in a subprocess on fake CPU devices, on a mesh with Auto
axes (``_torch_mesh_oracle``), the port on gloo ranks:

- the step within the reference's own bound
  (``tests/test_dryrun_multidevice.py``): loss within 0.05, every
  parameter ``allclose(rtol=3e-2, atol=3e-2)``;
- the prefill's logits within the serving criterion (LOGIT_ATOL) of the
  reference's ``make_prefill_step(model, ctx)``, its attention swapped for
  its flash oracle.

zamba2 runs at 2 layers: one group of ``shared_attn_every`` Mamba2 layers
and the shared block. At the reduced config's 5 layers the bf16 prefill
from random weights is ill-conditioned (the reference's sharded prefill
lies far past the criterion from its own unsharded one), and the
reference cannot run the hybrid in f32 (its stack's scan carries the bf16
embedding into f32 layers and raises a TypeError: ROADMAP C).

The VLM runs on positions whose three streams equal the index, so that the
reference's training mask (by the temporal stream's values) and the
prefill's (by index) agree with the port's (ROADMAP C).
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

MESH = ((1, 2), ("data", "model"))
CASES = {
    "zamba2_7b": ("zamba2_7b", {"overrides": {"n_layers": 2}}),
    "qwen2_vl_7b": ("qwen2_vl_7b", {"index_positions": True}),
    "whisper_base": ("whisper_base", {}),
    "whisper_base_vocab257": ("whisper_base", {"overrides": {"vocab": 257}}),
}


@pytest.fixture(scope="module", params=tuple(CASES))
def case(request, tmp_path_factory) -> OracleCase:
    shape, names = MESH
    arch, kw = CASES[request.param]
    return OracleCase(arch, shape, names, tmp_path_factory.mktemp(request.param), B=B, S=S,
                      lr=LR, pure_dp=False, **kw)


def test_tp_step_meets_the_reference_bound(case):
    assert_step_meets_reference_bound(case)


def test_tp_prefill_matches_the_reference(case):
    assert_prefill_meets_serving_criterion(case)
