"""The port's MoE layer (``repro_torch.models.layers.moe_layer``) against the
reference's ``moe_layer`` / ``_moe_tokens``, on the CPU.

The oracle is the reference jitted with ``xla_allow_excess_precision`` off
(``exact_jit``), which keeps every bf16 rounding its code writes, as the
port does. Against it:

- ``y`` and ``ce`` are equal bit for bit (tolerance 0), with and without
  capacity drops, at the decode shape (T = B) and through exact router ties,
  on inputs drawn from a grid of dyadic values (k/8 and k/64, |k| <= 8).
  On that grid every f32 sum inside a product is exact, so what is compared
  is what the port decides: the routes and their tie order, the capacity
  and the drop bin, each bf16 rounding, and the combine's order of bf16
  adds (the scatter-add's: ascending expert per token);
- ``me`` and ``aux`` within 2 f32 ulps: the router softmax's ``exp`` is
  XLA's on one side and PyTorch's on the other, and they differ in the last
  bit on ~9 % of f32 inputs (measured), so the mean router probability
  cannot be equal bit for bit without copying XLA's ``exp``;
- on normal random inputs the f32 and bf16 products sum in another order in
  each library (oneDNN's bf16 GEMM against XLA's): ``ce`` stays equal, and
  ``y`` is equal on all but a few elements, which are 1 bf16 ulp apart
  (measured: at most 2 of 32768).

Against the default compile, whose fusions skip bf16 roundings, ``y`` is
within 2 bf16 ulps of the largest |y| (measured over seeds 0-5: at most
1.5, 0.0234 at |y| up to 2.47).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.models import layers
from repro_torch.models.convert import tensor_from_numpy

# (label, T, D, E, K, F, capacity factor, dropped assignments)
CASES = [
    ("no drops", 512, 64, 8, 4, 32, 1.25, 0),
    ("drops", 512, 64, 8, 4, 32, 0.5, 1024),
    ("decode T=B", 4, 64, 64, 8, 32, 1.25, 0),
    ("router ties", 512, 64, 8, 4, 32, 1.25, None),
]


def exact_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16(a) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.bfloat16))  # writable


def _inputs(T, D, E, F, *, seed, grid: bool, ties: bool = False):
    """x (1, T, D), wr (D, E), w_gate/w_up (E, D, F), w_down (E, F, D), bf16
    numpy. ``grid``: values k/8 (x) and k/64 (weights), |k| <= 8. ``ties``:
    every 8th token is zero (all E router probabilities equal) and experts
    1 and 5 share their router column (equal probabilities at every token)."""
    rng = np.random.default_rng(seed)
    if grid:
        draw = lambda shape, den: _bf16(rng.integers(-8, 9, shape) / den)  # noqa: E731
        x, wr = draw((T, D), 8), draw((D, E), 64)
        wg, wu, wd = draw((E, D, F), 64), draw((E, D, F), 64), draw((E, F, D), 64)
    else:
        x = _bf16(rng.standard_normal((T, D)))
        wr = _bf16(rng.standard_normal((D, E)) / np.sqrt(D))
        wg, wu = (_bf16(rng.standard_normal((E, D, F)) / np.sqrt(D)) for _ in range(2))
        wd = _bf16(rng.standard_normal((E, F, D)) / np.sqrt(F))
    if ties:
        x[::8] = 0
        wr[:, 5] = wr[:, 1]
    return x[None], wr, wg, wu, wd


def _both(args, K, cf, *, exact=True):
    """(reference, port) of ``moe_layer`` on ``args``: y (T, D) f32 and aux,
    and (me, ce) of ``_moe_tokens``."""
    x, wr, wg, wu, wd = args
    T = x.shape[1]
    E = wr.shape[1]
    C = jax_layers._capacity(T, K, E, cf)
    ja = tuple(jnp.asarray(a) for a in args)
    run = exact_jit if exact else (lambda f, *a: jax.jit(f)(*a))
    jy, jaux = run(lambda *a: jax_layers.moe_layer(*a, top_k=K, capacity_factor=cf), *ja)
    _, (jme, jce) = run(lambda *a: jax_layers._moe_tokens(a[0][0], *a[1:], top_k=K, capacity=C),
                        *ja)
    ta = tuple(tensor_from_numpy(a) for a in args)
    ty, taux = layers.moe_layer(*ta, top_k=K, capacity_factor=cf)
    _, (tme, tce) = layers._moe_tokens(ta[0][0], *ta[1:], top_k=K, capacity=C)
    ref = (np.asarray(jy, np.float32)[0], float(jaux), np.asarray(jme), np.asarray(jce))
    port = (ty.float().numpy()[0], float(taux), tme.numpy(), tce.numpy())
    return ref, port


def _f32_ulp(a) -> np.ndarray:
    return np.spacing(np.abs(np.asarray(a, np.float32)))


def _bf16_ulp(a) -> np.ndarray:
    """The bf16 spacing at |a| (8 significant bits)."""
    m = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def _dropped(args, K, cf) -> int:
    x, wr = args[0][0], args[1]
    C = layers._capacity(x.shape[0], K, wr.shape[1], cf)
    r = layers._route(tensor_from_numpy(x), tensor_from_numpy(wr), top_k=K, capacity=C)
    return int((~r.keep).sum())


@pytest.mark.parametrize("label,T,D,E,K,F,cf,dropped", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_layer_equals_exact_compile_bit_for_bit(label, T, D, E, K, F, cf, dropped, seed):
    args = _inputs(T, D, E, F, seed=seed, grid=True, ties=label == "router ties")
    if dropped is not None:
        assert _dropped(args, K, cf) == dropped
    (jy, jaux, jme, jce), (ty, taux, tme, tce) = _both(args, K, cf)
    np.testing.assert_array_equal(ty, jy)
    assert np.array_equal(ty.view(np.uint32), jy.view(np.uint32))  # signed zeros too
    np.testing.assert_array_equal(tce, jce)
    np.testing.assert_allclose(tme, jme, rtol=0, atol=2 * _f32_ulp(jme).max())
    assert abs(taux - jaux) <= 2 * _f32_ulp(jaux)


@pytest.mark.parametrize("label,T,D,E,K,F,cf,dropped", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_moe_layer_on_normal_inputs_against_exact_compile(label, T, D, E, K, F, cf, dropped):
    args = _inputs(T, D, E, F, seed=2, grid=False)
    (jy, jaux, jme, jce), (ty, taux, tme, tce) = _both(args, K, cf)
    np.testing.assert_array_equal(tce, jce)
    diff = np.abs(ty - jy)
    assert (diff <= _bf16_ulp(jy)).all()
    assert (diff > 0).sum() <= 4
    np.testing.assert_allclose(tme, jme, rtol=0, atol=2 * _f32_ulp(jme).max())
    assert abs(taux - jaux) <= 2 * _f32_ulp(jaux)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_against_default_compile_within_2_ulps(cf):
    args = _inputs(512, 64, 8, 32, seed=3, grid=False)
    (jy, _, _, jce), (ty, _, _, tce) = _both(args, 4, cf, exact=False)
    np.testing.assert_array_equal(tce, jce)
    assert np.abs(ty - jy).max() <= 2 * _bf16_ulp(np.abs(jy).max())


def test_top_k_tie_order_is_lax_top_k():
    """Equal probabilities come lower index first, as ``jax.lax.top_k``."""
    probs = np.random.default_rng(4).integers(0, 4, (256, 16)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 5)
    tv, ti = layers._top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_combine_equals_the_reference_scatter_add():
    """The combine alone, on bf16 contributions of mixed magnitudes (where
    the order of bf16 adds shows), against the reference's
    ``zeros.at[st].add(contrib)`` over the expert-sorted assignments."""
    T, E, K, D = 64, 8, 4, 16
    rng = np.random.default_rng(5)
    experts = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    contrib = _bf16(rng.standard_normal((T * K, D)) * np.exp2(rng.integers(-6, 6, (T * K, 1))))
    order = np.argsort(experts.reshape(-1), kind="stable")
    st = np.repeat(np.arange(T), K)[order]
    se = experts.reshape(-1)[order]
    c = contrib[order]
    want = np.asarray(exact_jit(lambda a, t: jnp.zeros((T, D), jnp.bfloat16).at[t].add(a),
                                jnp.asarray(c), jnp.asarray(st)), np.float32)
    got = layers._combine(tensor_from_numpy(c), torch.from_numpy(st), torch.from_numpy(se), T, E)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the data tells orders apart: adding in descending expert order rounds otherwise
    parts = tensor_from_numpy(c)[np.lexsort((-se, st))].reshape(T, K, D)
    back = torch.zeros((T, D), dtype=torch.bfloat16)
    for k in range(K):
        back = back + parts[:, k]
    assert not torch.equal(back, got)


def test_combine_does_not_depend_on_the_order_of_the_assignments():
    """Shuffling the assignments leaves y equal bit for bit: the combine
    orders them itself and sums no bf16 through atomics."""
    T, E, K, D = 128, 16, 4, 32
    rng = np.random.default_rng(6)
    experts = np.stack([rng.permutation(E)[:K] for _ in range(T)]).reshape(-1)
    tokens = np.repeat(np.arange(T), K)
    contrib = tensor_from_numpy(_bf16(rng.standard_normal((T * K, D)) *
                                      np.exp2(rng.integers(-6, 6, (T * K, 1)))))
    want = layers._combine(contrib, torch.from_numpy(tokens), torch.from_numpy(experts), T, E)
    for seed in range(3):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(T * K))
        got = layers._combine(contrib[p], torch.from_numpy(tokens)[p],
                              torch.from_numpy(experts)[p], T, E)
        assert torch.equal(got, want)


@pytest.mark.parametrize("T,K,E,cf", [(1, 2, 4, 1.25), (4, 8, 64, 1.25), (128, 2, 4, 1.25),
                                      (8192, 8, 64, 1.25), (8192, 8, 128, 1.25),
                                      (512, 4, 8, 0.5), (1000, 3, 7, 2.0)])
def test_capacity_equals_reference(T, K, E, cf):
    assert layers._capacity(T, K, E, cf) == jax_layers._capacity(T, K, E, cf)
