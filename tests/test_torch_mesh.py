"""The port's sharding specs against the reference's, leaf for leaf (no
processes, no devices).

For every arch of ``configs/`` at its published size, on the meshes (1, 1),
(2, 2), (1, 4) and (1, 8) (data, model; the fallback layouts of qwen2-0.5b
on model=4, of gemma3-1b and qwen2-vl-7b on model=8), (2, 4, 2) (pod, data,
model) and the production (16, 16): ``param_specs`` (for training and with ``serve=True``),
``adamw_specs``, ``training_state_specs``, ``batch_shardings`` at each of
the arch's shapes (``shapes_for``), ``cache_specs`` at the decode shapes
and ``_tok_spec``. The reference computes on a ``jax.sharding.
AbstractMesh`` with Auto axes, the port on its ``AbstractMesh``; a spec is
compared as the reference's ``PartitionSpec`` reads as a tuple, an entry of
one axis in a tuple read as that axis.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import AxisType
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import shapes_for as jax_shapes_for
from repro.models.lm import LM as JaxLM
from repro.models.sharding import MeshCtx as JaxMeshCtx
from repro.models.sharding import spec_with_model_on as jax_spec_with_model_on
from repro.train.optimizer import adamw_specs as jax_adamw_specs
from repro.train.steps import batch_shardings as jax_batch_shardings
from repro.train.steps import training_state_specs as jax_training_state_specs
from repro_torch.configs import all_archs, get_arch, shapes_for
from repro_torch.models.lm import LM
from repro_torch.models.sharding import AbstractMesh, MeshCtx, spec_with_model_on
from repro_torch.train.optimizer import adamw_specs
from repro_torch.train.steps import batch_shardings, training_state_specs
from repro_torch.tree import named_leaves
from torch.distributed.tensor import Replicate, Shard

ARCHS = sorted(all_archs())
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model")), ((16, 16), ("data", "model"))]


def _canon(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _jax_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxNamedSharding))[0]
    return {".".join(str(k.key) for k in path): _canon(tuple(s.spec)) for path, s in leaves}


def _specs(tree) -> dict:
    return {name: _canon(s.spec) for name, s in named_leaves(tree)}


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m[0])))
def ctxs(request):
    shape, names = request.param
    jmesh = JaxAbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    return JaxMeshCtx(jmesh), MeshCtx(AbstractMesh(shape, names))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference(ctxs, arch):
    jctx, ctx = ctxs
    jm, tm = JaxLM(jax_get_arch(arch)), LM(get_arch(arch), device="cpu")
    assert tm.pure_dp == jm.pure_dp
    assert _canon(tm._tok_spec(ctx)) == _canon(jm._tok_spec(jctx))
    for serve in (False, True):
        got, want = _specs(tm.param_specs(ctx, serve)), _jax_specs(jm.param_specs(jctx, serve))
        assert got == want, serve
    jp, tp = jm.param_specs(jctx), tm.param_specs(ctx)
    jo, to = jax_adamw_specs(jp, jm.param_shapes(), jctx), adamw_specs(tp, tm.param_template(), ctx)
    for key in ("m", "v"):
        assert _specs(to[key]) == _jax_specs(jo[key]), key
    assert _canon(to["step"].spec) == _canon(tuple(jo["step"].spec)) == ()
    (jstore, jos), (tstore, tos) = jax_training_state_specs(jm, jctx), training_state_specs(tm, ctx)
    assert _specs(tstore) == _jax_specs(jstore) and _specs(tos["v"]) == _jax_specs(jos["v"])
    jcfg = jax_get_arch(arch)
    for jshape, shape in zip(jax_shapes_for(jcfg), shapes_for(get_arch(arch))):
        assert shape.name == jshape.name
        got = _specs(batch_shardings(get_arch(arch), shape, ctx, tm))
        assert got == _jax_specs(jax_batch_shardings(jcfg, jshape, jctx)), shape.name
        if shape.kind == "decode":
            B, S = shape.global_batch, shape.seq_len
            assert _specs(tm.cache_specs(B, S, ctx)) == _jax_specs(jm.cache_specs(B, S, jctx))


def test_mesh_ctx_properties_equal_reference(ctxs):
    jctx, ctx = ctxs
    assert (ctx.has_pod, ctx.batch_axes, ctx.n_batch, ctx.n_model) == (
        jctx.has_pod, jctx.batch_axes, jctx.n_batch, jctx.n_model)
    for B in (1, 2, 3, 8, 32, 256):
        for extra in (0, 1):
            assert _canon(ctx.token_spec(B, extra)) == _canon(jctx.token_spec(B, extra))
    for dims in ((14, 64), (2, 16), (3, 5), (256,)):
        assert ctx.model_dim_choice(*dims) == jctx.model_dim_choice(*dims)
        for cand in ([0], [1, 0], [0, 1]):
            if max(cand) < len(dims):
                assert spec_with_model_on(dims, ctx, cand) == jax_spec_with_model_on(
                    dims, jctx, cand)


def test_placements_nest_the_batch_axes_in_the_reference_order():
    """Two axes on one tensor dim shard it in mesh order, outermost first:
    DTensor's (Shard(0), Shard(0), Replicate()) on (pod, data, model) hands
    rank (pod, data) the block ``data + pod * n_data``, the reference's
    flattened index (``src/repro/train/optimizer.py:180-181``); each rank's
    block is checked on gloo ranks in ``test_torch_mesh_dist.py``."""
    ctx = MeshCtx(AbstractMesh((2, 4, 2), ("pod", "data", "model")))
    s = ctx.ns(("pod", "data"), None, "model")
    assert s.spec == (("pod", "data"), None, "model")
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert ctx.replicated().placements == (Replicate(),) * 3
    for bad in ((("data", "pod"),), ("x",), ("data", "data")):
        with pytest.raises(ValueError):
            ctx.ns(*bad)


def test_pure_dp_threshold_equals_reference():
    from repro.models.lm import PURE_DP_MAX_PARAMS as JAX_MAX

    from repro_torch.models.lm import PURE_DP_MAX_PARAMS

    assert PURE_DP_MAX_PARAMS == JAX_MAX
    got = {a: LM(get_arch(a), device="cpu").pure_dp for a in ARCHS}
    assert got == {a: JaxLM(jax_get_arch(a)).pure_dp for a in ARCHS}
    assert [a for a, v in got.items() if v] == ["whisper_base"]
    assert np.isclose(LM(get_arch("qwen2_0_5b"), device="cpu").n_params(), 494032768)
