"""The port's sequence-sharded serving against the reference's, at B = 1 on
(data=2, model=1) and (data=2, model=2) meshes, whose batch axes B does not
fill: the reference shards the sequence over them (its ``token_spec``;
``cache_specs`` puts K/V's sequence dim there), as for its ``long_500k``
shape.

The reference runs its ``make_prefill_step`` (the attention swapped for its
flash oracle, as the port's prefill attends with the flash kernel) and
``make_serve_step`` in one subprocess for both meshes, on fake CPU devices,
meshes with Auto axes (``_torch_mesh_oracle.reference_seq_run``), jitted on the
shardings its ``launch/dryrun.py`` gives them; the port runs on gloo ranks
(``_torch_mesh_ranks``, case ``seq_families``), both as models that are not
pure data-parallel, from the reference's parameters
(``init_params(PRNGKey(0))``), its ``make_inputs`` tokens (1 x 256), and a
128-long cache drawn for the positions before 62, decoded at 62..65 (a
rank's last slot, then the next rank's first). The prefill's and every
decode step's logits lie within the serving criterion (LOGIT_ATOL) of the
reference's: reduced qwen2-0.5b, gemma3-1b (its window-32 local layer and
its global layer), mamba2-2.7b, and zamba2-7b at 2 layers (one group of
``shared_attn_every`` Mamba2 layers and the shared block), as
``tests/test_torch_mesh_ref_families.py`` holds it: at the reduced
config's 5 layers its bf16 prefill from random weights is ill-conditioned.
At 2 layers it is too at some inputs, with no sequence sharding: on 1 x
128 tokens the port's single-device prefill lies 0.0996 from the
reference's (of a largest |logit| of 2.81; 0 on 1 x 256), from bf16
roundings that the two packages' f32 sums flip in 54 of the first Mamba2
layer's 8192 outputs, which the shared block's sharp attention carries to
1.73 of its output. The sequence-sharded prefill equals the port's
single-device one bit for bit (``tests/test_torch_mesh_seq.py``), so that
distance is the single-device path's; this file runs the families
oracle's 256 tokens.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.tree import named_leaves

from _torch_mesh_oracle import (  # noqa: I001  (tests/ helper)
    LOGIT_ATOL,
    reference_inputs,
    reference_seq_run,
)
from _torch_mesh_ranks import run_ranks

S, CACHE, START, STEPS = 256, 128, 62, 4  # S: the families oracle's
MESHES = {"2x1": ((2, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
ARCHS = {"qwen2_0_5b": {}, "gemma3_1b": {}, "mamba2_2_7b": {}, "zamba2_7b": {"n_layers": 2}}


def _inputs(arch: str) -> dict:
    """Both packages' inputs, numpy: the reference's parameters and
    prefill tokens, the drawn starting cache (bf16 values) and the fed
    tokens."""
    cfg, jp, (_, prefill) = reference_inputs(arch, ARCHS[arch], B=1, S=S)
    from repro.models.lm import LM

    rng = np.random.default_rng(5)
    cache = {}
    for name, (shape, dtype) in LM(cfg, max_pos=S).cache_template(1, CACHE).items():
        draw = rng.standard_normal(shape, dtype=np.float32)
        if name in ("k", "v"):
            draw[:, :, START:] = 0
        else:
            draw *= 0.1
        bf16 = name != "ssm"
        cache[name] = torch.from_numpy(draw).to(torch.bfloat16).float().numpy() if bf16 else draw
    feeds = rng.integers(0, cfg.vocab, (STEPS, 1), dtype=np.int32)
    return dict(arch=arch, overrides=ARCHS[arch], max_pos=S, params=dict(named_leaves(jp)),
                jax_params=jp, tokens=np.asarray(prefill["tokens"]), cache=cache, feeds=feeds,
                start=START)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh -> (the reference's results, the port's ranks' results): the
    inputs made once, every mesh and arch in one reference subprocess, one
    launch of the ranks a mesh."""
    inputs = {a: _inputs(a) for a in ARCHS}
    work = tmp_path_factory.mktemp("seq")
    # the reference's subprocess runs while the port's ranks do
    pool = ThreadPoolExecutor(1)
    ref = pool.submit(reference_seq_run, MESHES,
                      {a: {k: v for k, v in m.items() if k != "jax_params"}
                       for a, m in inputs.items()}, work / "reference")
    families = {a: dict(arch=a, overrides=m["overrides"], params=params_from_numpy(m["jax_params"]),
                        prefill={"tokens": tensor_from_numpy(m["tokens"])},
                        cache={k: torch.from_numpy(v).to(torch.float32 if k == "ssm"
                                                         else torch.bfloat16)
                               for k, v in m["cache"].items()},
                        feeds=[{"token": torch.from_numpy(f)} for f in m["feeds"]], start=START)
                for a, m in inputs.items()}
    try:
        port = {label: run_ranks("seq_families", int(np.prod(shape)), work / label,
                                 dict(shape=shape, names=names, max_pos=S, families=families),
                                 timeout=600)
                for label, (shape, names) in MESHES.items()}
        ref = ref.result()
    finally:
        pool.shutdown()
    return {label: (ref[label], port[label]) for label in MESHES}


@pytest.fixture(params=tuple(MESHES))
def mesh_run(request, runs):
    """(the mesh's label, the reference's results, the port's ranks') on one
    mesh."""
    return request.param, *runs[request.param]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_seq_prefill_meets_the_references(mesh_run, arch):
    """Every rank's prefill logits within LOGIT_ATOL of the reference's
    sequence-sharded prefill."""
    _, ref, port = mesh_run
    for r in port:
        np.testing.assert_allclose(r[arch]["logits"].numpy(), ref[arch]["prefill"], rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_seq_decode_meets_the_references(mesh_run, arch):
    """Every rank's logits of each decode step (a rank's last slot, the next
    rank's first) within LOGIT_ATOL of the reference's sequence-sharded
    serve step."""
    _, ref, port = mesh_run
    for r in port:
        steps = r[arch]["decode"]
        assert len(steps) == STEPS
        for i, (a, b) in enumerate(zip(steps, ref[arch]["decode"], strict=True)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"decode step {i}")
