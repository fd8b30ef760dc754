"""The port's Mamba2 / SSD pieces (``repro_torch.models.ssd``) against the
reference's (``repro.models.ssd``), on the CPU at reduced widths
(``get_arch("mamba2_2_7b").reduced()``: d 64, N 16, P 16, Q 16, H 8).

The same seeded numpy inputs and weights go to both sides; the reference's
parameters are ``mamba2_param_shapes`` drawn with numpy (1-D leaves too, so
that ``A_log``, ``dt_bias``, ``Dskip`` and ``norm`` are not all zero).

Tolerances, and where they come from:
- ``_causal_conv``: exact. bf16 products are exact in f32 and both sides add
  the K taps in the order j = 0..K-1 before one rounding to bf16.
- ``softplus``: 3 f32 ulps (exp, log1p and the add each round once, and
  XLA's exp and log1p are not PyTorch's; measured over 2e6 points in
  [-60, 60]: at most 3, 94.6 % bit-equal).
- ``_ssd_chunked`` (f32): every output is a sum over at most Q keys of the
  chunk and N state entries, summed in another order on each side (and
  XLA's and PyTorch's f32 ``exp`` differ in the last bit on ~9 % of
  inputs), so each term may carry one ulp of the output's magnitude: SSD_ULPS
  = Q + N = 32 f32 ulps of the largest |y| (measured: 6.25 at L = Q,
  4.75 at L = 4Q).
- the mixer and the decode step (bf16 out): the f32 SSD's ulps can move a
  bf16 rounding of ``y`` before the gate and the norm, and the output
  projection sums d_inner = 128 such bf16 inputs: BF16_ULPS = 4 bf16 ulps
  of the largest |out| (measured: the mixer's outputs equal bit for bit at
  L = 16 and 64). The decode step's conv window is exact (a shift of
  the cache and the new bf16 projections, which both sides round alike), its
  f32 state within SSD_ULPS ulps of its largest entry after 4 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import ssd as jssd
from repro_torch.configs import get_arch
from repro_torch.models import ssd
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

from _torch_moe_criteria import bf16_ulp as _bf16_spacing

ARCH = "mamba2_2_7b"
SSD_ULPS = 32
BF16_ULPS = 4
B = 2


def f32_ulp(x) -> float:
    return float(np.spacing(np.float32(np.abs(x).max())))


def bf16_ulp(x) -> float:
    return float(_bf16_spacing(np.abs(x).max()))


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


class Side:
    """The reduced config on both packages and one layer's weights."""

    def __init__(self, seed: int = 0):
        self.jcfg = jax_get_arch(ARCH).reduced()
        self.cfg = get_arch(ARCH).reduced()
        rng = np.random.default_rng(seed)
        arrs = {}
        for name, (shape, dtype) in jssd.mamba2_param_shapes(self.jcfg).items():
            scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.5
            if name == "conv_w":
                scale = 0.5
            arrs[name] = np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, dtype))
        self.np = arrs
        self.jp = {k: jnp.asarray(v) for k, v in arrs.items()}
        self.tp = params_from_numpy(arrs)
        self.rng = rng


def test_param_shapes_match_reference():
    side = Side()
    want = {k: (tuple(s), jnp.dtype(d).name) for k, (s, d) in
            jssd.mamba2_param_shapes(side.jcfg).items()}
    got = {k: (tuple(s), str(d).removeprefix("torch.")) for k, (s, d) in
           ssd.mamba2_param_shapes(side.cfg).items()}
    assert got == want
    assert ssd.G == jssd.G == 1


def test_softplus_is_jax_softplus():
    """Across the range where ``F.softplus`` would switch formulas (x > 20)."""
    x = np.concatenate([np.linspace(-60, 60, 4001), [0.0, 19.99, 20.0, 20.01, 1e4, -1e4]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssd.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=3)


@pytest.mark.parametrize("L", [1, 16, 67])
def test_causal_conv_is_exact(L):
    side = Side()
    C = side.np["conv_w"].shape[1]
    u = _bf16(side.rng.standard_normal((B, L, C)))
    want = np.asarray(jssd._causal_conv(jnp.asarray(u), side.jp["conv_w"]), np.float32)
    got = ssd._causal_conv(tensor_from_numpy(u), side.tp["conv_w"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("chunks", [1, 4])
def test_ssd_chunked_matches_reference(chunks):
    """L = Q (one chunk: the intra-chunk term alone) and L = 4Q (the state
    carried across three chunk boundaries)."""
    side = Side(1)
    cfg = side.cfg
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    L = chunks * Q
    rng = side.rng
    x = _bf16(rng.standard_normal((B, L, H, P)))
    dt_ = np.asarray(jax.nn.softplus(jnp.asarray(rng.standard_normal((B, L, H)), jnp.float32)))
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm, Cm = (_bf16(rng.standard_normal((B, L, 1, N))) for _ in range(2))
    want = np.asarray(jssd._ssd_chunked(*(jnp.asarray(a) for a in (x, dt_, A, Bm, Cm)), Q))
    got = ssd._ssd_chunked(tensor_from_numpy(x), torch.from_numpy(dt_), torch.from_numpy(A),
                           tensor_from_numpy(Bm), tensor_from_numpy(Cm), Q)
    assert got.dtype == torch.float32 and got.shape == (B, L, H, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SSD_ULPS * f32_ulp(want))


@pytest.mark.parametrize("L", [16, 64])
def test_mamba2_mixer_matches_reference(L):
    side = Side(2)
    x = _bf16(side.rng.standard_normal((B, L, side.cfg.d_model)))
    want = np.asarray(jssd.mamba2_mixer(side.jp, jnp.asarray(x), side.jcfg), np.float32)
    got = ssd.mamba2_mixer(side.tp, tensor_from_numpy(x), side.cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ULPS * bf16_ulp(want))


def test_mixer_refuses_a_ragged_chunk():
    side = Side()
    x = torch.zeros((1, 24, side.cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ssd.mamba2_mixer(side.tp, x, side.cfg)


def test_mamba2_decode_step_matches_reference():
    """Four steps from a random conv window and state, each side carrying its
    own: y each step, the conv window exact, the state at the end."""
    side = Side(3)
    cfg = side.cfg
    conv_dim = cfg.d_inner + 2 * ssd.G * cfg.ssm_state
    rng = side.rng
    conv = _bf16(rng.standard_normal((B, cfg.conv_kernel - 1, conv_dim)))
    state = rng.standard_normal((B, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim))
    state = state.astype(np.float32)
    jconv, jstate = jnp.asarray(conv), jnp.asarray(state)
    tconv, tstate = tensor_from_numpy(conv), torch.from_numpy(state)
    for _ in range(4):
        x = _bf16(rng.standard_normal((B, cfg.d_model)))
        jy, jconv, jstate = jssd.mamba2_decode_step(side.jp, jnp.asarray(x), jconv, jstate,
                                                    side.jcfg)
        ty, tconv, tstate = ssd.mamba2_decode_step(side.tp, tensor_from_numpy(x), tconv, tstate,
                                                   cfg)
        want = np.asarray(jy, np.float32)
        np.testing.assert_allclose(ty.float().numpy(), want, rtol=0,
                                   atol=BF16_ULPS * bf16_ulp(want))
        np.testing.assert_array_equal(tconv.float().numpy(), np.asarray(jconv, np.float32))
    want = np.asarray(jstate)
    assert tstate.dtype == torch.float32 and tstate.shape == want.shape
    np.testing.assert_allclose(tstate.numpy(), want, rtol=0, atol=SSD_ULPS * f32_ulp(want))


def test_decode_steps_continue_the_prefill():
    """The recurrence and the chunked SSD compute one function: a mixer over
    L tokens equals L decode steps from a zero window and state, within
    the bf16 tolerance (the port against itself; the conv of the decode
    step keeps f32 where the mixer's rounds to bf16, as in the reference)."""
    side = Side(4)
    cfg = side.cfg
    L = 2 * cfg.ssm_chunk
    x = tensor_from_numpy(_bf16(side.rng.standard_normal((B, L, cfg.d_model))))
    full = ssd.mamba2_mixer(side.tp, x, cfg).float()
    conv_dim = cfg.d_inner + 2 * ssd.G * cfg.ssm_state
    conv = torch.zeros((B, cfg.conv_kernel - 1, conv_dim), dtype=torch.bfloat16)
    state = torch.zeros((B, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim))
    steps = []
    for t in range(L):
        y, conv, state = ssd.mamba2_decode_step(side.tp, x[:, t], conv, state, cfg)
        steps.append(y.float())
    got = torch.stack(steps, dim=1)
    assert float((got - full).abs().max()) <= 8 * bf16_ulp(full.numpy())
