"""The port's fallback layouts of tensor parallelism against the reference's
sharded step and prefill, on a (data=1, model=4) mesh.

Six families' reduced configs are made not to divide model=4, as in
``tests/test_torch_mesh_fallback.py``: qwen2-0.5b and olmoe-1b-7b with 6
heads on 2 KV heads at head_dim 16 and vocab 257 with d_model 66 (qwen2's
d_ff 90, olmoe's 6 experts); gemma3-1b (qk-norm, a 32-token window on its
local layers) and qwen2-vl-7b (M-RoPE) with 6 heads at head_dim 16;
mamba2-2.7b with 6 SSM heads (d_model 48) and vocab 257; whisper-base with
6 heads and KV heads at head_dim 16, d_ff 90 and vocab 257 with d_model 66.
So the reference's ``param_specs`` shard head_dim (the attention) or
replicate the leaf (FFN, experts, SSM mixer, embedding and head). Both
sides run them as models that are not pure data-parallel, B = 4, S = 256,
from the reference's parameters and ``make_inputs`` batches (the VLM's
positions the index on all three streams, as in
``tests/test_torch_mesh_ref_families.py``). The reference runs in a
subprocess on fake CPU devices, on a mesh with Auto axes
(``_torch_mesh_oracle``), the port on gloo ranks:

- the prefill's logits within the serving criterion (LOGIT_ATOL) of the
  reference's ``make_prefill_step(model, ctx)``, its attention swapped for
  its flash oracle at each layer's window;
- the train step within the reference's own bound
  (``tests/test_dryrun_multidevice.py``): loss within 0.05, every
  parameter ``allclose(rtol=3e-2, atol=3e-2)``.

Both in bf16: the reference cannot run a ``dtype="float32"`` config (its
layer scan carries the bf16 embedding into f32 layers and raises a
TypeError, ROADMAP C; pinned here for each of its layer stacks that these
cases run), so the f32 step is held against the port's own unsharded step
instead (``tests/test_torch_mesh_fallback.py``).
"""
import pytest

from repro_torch.tree import named_leaves

from _torch_mesh_oracle import (  # noqa: I001  (tests/ helper)
    LR,
    B,
    OracleCase,
    ReferenceFailed,
    S,
    as_f32,
    assert_prefill_meets_serving_criterion,
    assert_step_meets_reference_bound,
    reference_inputs,
    reference_run,
)

MESH = ((1, 4), ("data", "model"))
ODD = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16, "vocab": 257, "d_model": 66}
# id -> (arch, ``OracleCase``'s keywords)
CASES = {
    "qwen2_0_5b": ("qwen2_0_5b", {"overrides": {**ODD, "d_ff": 90}}),
    "olmoe_1b_7b": ("olmoe_1b_7b", {"overrides": {**ODD, "moe_experts": 6}}),
    "gemma3_1b": ("gemma3_1b", {"overrides": {"n_heads": 6, "head_dim": 16}}),
    "qwen2_vl_7b": ("qwen2_vl_7b", {"overrides": {"n_heads": 6, "head_dim": 16},
                                    "index_positions": True}),
    "mamba2_2_7b": ("mamba2_2_7b", {"overrides": {"d_model": 48, "vocab": 257}}),
    "whisper_base": ("whisper_base", {"overrides": {**ODD, "n_kv_heads": 6, "d_ff": 90}}),
}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> its ``OracleCase``, run once."""
    done: dict = {}

    def get(name: str) -> OracleCase:
        if name not in done:
            shape, names = MESH
            arch, kw = CASES[name]
            done[name] = OracleCase(arch, shape, names, tmp_path_factory.mktemp(name), B=B, S=S,
                                    lr=LR, pure_dp=False, **kw)
        return done[name]

    return get


@pytest.mark.parametrize("name", tuple(CASES))
def test_fallback_prefill_matches_the_reference(cases, name):
    assert_prefill_meets_serving_criterion(cases(name))


@pytest.mark.parametrize("name", tuple(CASES))
def test_fallback_step_meets_the_reference_bound(cases, name):
    assert_step_meets_reference_bound(cases(name))


# one case for each of the reference's layer stacks (``_run_decoder_stack``,
# which the other three cases run too, ``_run_ssm_stack``, ``_run_encdec``)
F32_REFUSED = ("qwen2_0_5b", "mamba2_2_7b", "whisper_base")


@pytest.mark.parametrize("name", F32_REFUSED)
def test_the_reference_cannot_train_a_float32_config(tmp_path, name):
    """Why the f32 step is held against the port's own unsharded step: the
    reference's sharded step on the same mesh, config and batch in
    ``dtype="float32"`` raises where its layer scan carries the bf16
    embedding into f32 layers (ROADMAP C)."""
    arch, kw = CASES[name]
    overrides = {**kw["overrides"], "dtype": "float32"}
    _, params, (batch, _) = reference_inputs(arch, overrides, B=B, S=S,
                                             index_positions=kw.get("index_positions", False))
    shape, names = MESH
    with pytest.raises(ReferenceFailed, match="TypeError: scan body function carry input and "
                                              "carry output must have equal types"):
        reference_run(arch, shape, names, dict(named_leaves(params)), as_f32(batch), tmp_path,
                      max_pos=S, lr=LR, pure_dp=False, overrides=overrides)
