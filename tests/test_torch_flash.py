"""The port's flash attention (its plain version, on the CPU) against the
reference's Pallas kernel in interpret mode and its oracle.

Same seeded numpy inputs to both packages. Tolerances are the reference's
own (tests/test_kernel_flash.py): 2e-5 in f32, 2e-2 in bf16 (one bf16
rounding of outputs of magnitude ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# the reference's CASES: (B, H, Sq, Sk, hd, causal, window, dtype)
CASES = [
    (1, 2, 128, 128, 32, True, 0, "float32"),
    (2, 4, 256, 256, 64, True, 0, "float32"),
    (1, 2, 256, 256, 64, False, 0, "float32"),
    (1, 2, 256, 256, 64, True, 64, "float32"),
    (2, 2, 512, 512, 128, True, 0, "bfloat16"),
    (1, 1, 128, 512, 64, True, 0, "float32"),
]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, shapes, dtype, scale=1.0):
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    return jx, tx


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window,dtype", CASES)
def test_plain_flash_matches_pallas_kernel_and_oracle(B, H, Sq, Sk, hd, causal, window, dtype):
    rng = np.random.default_rng(Sq + Sk + hd)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, Sq, hd), (B, H, Sk, hd), (B, H, Sk, hd)],
                                      dtype)
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window), tol)
    _close(got, jax_flash(jq, jk, jv, causal=causal, window=window, bq=64, bk=64,
                          interpret=True), tol)


# zamba2-7b's head dim, 112 (the card's kernel pads it to two 64-column
# chunks): (B, H, Hkv, Sq, Sk, causal, window, dtype)
HD112_CASES = [
    (1, 4, 4, 128, 128, True, 0, "bfloat16"),    # zamba2's MHA shared block, reduced
    (2, 4, 4, 256, 256, True, 0, "float32"),
    (1, 4, 2, 64, 192, True, 0, "float32"),      # top-left causal, Sq < Sk, GQA
    (1, 2, 2, 128, 128, False, 0, "bfloat16"),
    (1, 2, 1, 128, 256, True, 64, "bfloat16"),   # windowed, GQA
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window,dtype", HD112_CASES)
def test_plain_flash_hd112_matches_pallas_kernel_and_oracle(B, H, Hkv, Sq, Sk, causal, window,
                                                            dtype):
    """hd 112, which the Pallas kernel takes as it is (it asserts only on the
    lengths), against the kernel in interpret mode and its oracle, on
    ``jnp.repeat``-ed KV heads; the scale is 1/sqrt(112) on every side."""
    hd = 112
    rng = np.random.default_rng(Sq + Sk + Hkv)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)],
                                      dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    G = H // Hkv
    jk, jv = jnp.repeat(jk, G, axis=1), jnp.repeat(jv, G, axis=1)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window), tol)
    _close(got, jax_flash(jq, jk, jv, causal=causal, window=window, bq=64, bk=64,
                          interpret=True), tol)


@pytest.mark.parametrize("bq,bk", [(32, 32), (128, 64)])
def test_plain_flash_matches_pallas_block_sizes(bq, bk):
    """The reference's block-size invariance case: every block shape of the
    Pallas kernel gives what the port gives."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(1, 2, 256, 64)] * 3, "float32")
    _close(ops.flash_attention(q, k, v), jax_flash(jq, jk, jv, bq=bq, bk=bk, interpret=True),
           2e-5)


def test_plain_flash_extreme_values():
    """Logits x30 (the reference's online-softmax overflow case)."""
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((1, 1, 64, 32)) * s for s in (30, 30, 1)]
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in arrs)
    q, k, v = (torch.from_numpy(a).float() for a in arrs)
    got = ops.flash_attention(q, k, v)
    assert torch.isfinite(got).all()
    _close(got, jax_flash(jq, jk, jv, bq=32, bk=32, interpret=True), 1e-4)
    _close(got, jax_ref(jq, jk, jv), 1e-4)


@pytest.mark.parametrize("Hkv", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_gqa_matches_repeated_heads(Hkv, dtype):
    """k/v with fewer heads equal the reference on ``jnp.repeat``-ed heads."""
    B, H, S, hd = 2, 4, 128, 32
    rng = np.random.default_rng(10 + Hkv)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)],
                                      dtype)
    G = H // Hkv
    want = jax_ref(jq, jnp.repeat(jk, G, axis=1), jnp.repeat(jv, G, axis=1))
    _close(ops.flash_attention(q, k, v), want, 2e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("Sq,Sk,window", [(1, 1, 0), (63, 63, 0), (65, 65, 16), (65, 200, 0),
                                          (200, 50, 16)])
def test_plain_flash_ragged_lengths_match_oracle(Sq, Sk, window):
    """Lengths the Pallas kernel's tiles cannot take, against its oracle;
    (200, 50, 16) has rows with no key at all (uniform weights)."""
    rng = np.random.default_rng(Sq * 1000 + Sk)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(1, 2, Sq, 16), (1, 2, Sk, 16), (1, 2, Sk, 16)],
                                      "float32")
    _close(ops.flash_attention(q, k, v, window=window), jax_ref(jq, jk, jv, window=window), 2e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 64))
    bad = [
        (torch.zeros((1, 2, 8, 48)),) * 3,                                     # head dim
        (q.half(), q.half(), q.half()),                                        # dtype
        (q, q.bfloat16(), q),                                                  # mixed dtypes
        (torch.zeros((1, 8, 2, 64)).transpose(1, 2), q, q),                    # not contiguous
        (q, torch.zeros((1, 3, 8, 64)), torch.zeros((1, 3, 8, 64))),           # 2 % 3 heads
        (q, torch.zeros((1, 2, 0, 64)), torch.zeros((1, 2, 0, 64))),           # no keys
        (q[0], q[0], q[0]),                                                    # 3-D
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ops.flash_attention(*args)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=-1)


def test_plain_version_is_the_oracle_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 32)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v, window=8),
                       flash_attention_ref(q, k, v, window=8))


LOG2E = 1.4426950408889634


def _tensor_core_numerics(q, k, v, *, causal, window, bk):
    """The bf16 kernel's arithmetic in plain torch, key tile by key tile:
    bf16 Q and K, f32 scores Q K^T (masked ones -2^100, finite like the
    reference's -1e30, and exact when scaled; keys past Sk absent),
    in the log2 domain with c = log2(e) / sqrt(hd) rounded to f32 once: the
    running max m = max(m, c rowmax S), weights exp2(c S - m) (one FMA in the
    kernel), the row sum of f32 P, P rounded to bf16 before P V, an f32
    accumulator, the output in bf16."""
    H, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[2]
    k = k.repeat_interleave(H // k.shape[1], dim=1).float()
    v = v.repeat_interleave(H // v.shape[1], dim=1).float()
    qf = q.float()
    c = torch.tensor(LOG2E / hd**0.5, dtype=torch.float32)
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = qf @ kt.transpose(-1, -2)
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= k_pos <= q_pos
        if window > 0:
            ok &= (q_pos - k_pos) < window
        s = torch.where(ok, s, -2.0**100)
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vt
        m = m_new
    return (acc / l[..., None]).bfloat16()


# reduced versions of the card's bf16 shapes: (B, H, Hkv, Sq, Sk, hd, causal,
# window, input scale, key tile)
BUDGET_CASES = [
    (1, 14, 2, 256, 256, 64, True, 0, 1.0, 128),     # the prefill's heads
    (1, 14, 2, 256, 256, 64, True, 0, 1.0, 64),
    (1, 2, 2, 128, 128, 64, False, 0, 1.0, 128),     # non-causal
    (1, 4, 1, 300, 300, 256, True, 128, 1.0, 64),    # sliding window, hd 256, GQA
    (1, 2, 2, 200, 50, 64, True, 16, 1.0, 128),      # rows with no key at all
    (1, 4, 2, 80, 277, 128, True, 0, 1.0, 128),      # top-left causal, Sq < Sk
    (1, 2, 2, 1, 77, 64, True, 0, 1.0, 128),         # Sq = 1, ragged Sk
    (1, 4, 2, 100, 100, 16, False, 0, 1.0, 128),     # hd 16 under GQA
    (1, 2, 2, 256, 256, 32, True, 0, 30.0, 128),     # extreme logits: scores ~+-1e3
    (1, 2, 2, 256, 256, 32, True, 100, 30.0, 128),   # ... with masked first tiles
    (1, 4, 4, 256, 256, 112, True, 0, 1.0, 128),     # zamba2's hd 112 (two chunks, padded)
    (1, 4, 2, 80, 277, 112, True, 0, 1.0, 128),      # hd 112 under GQA, Sq < Sk
    (1, 2, 2, 256, 256, 112, True, 0, 30.0, 128),    # hd 112 with extreme logits
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal,window,scale,bk", BUDGET_CASES)
def test_tensor_core_rounding_fits_the_bf16_tolerance(B, H, Hkv, Sq, Sk, hd, causal, window,
                                                      scale, bk):
    """The bf16 kernel rounds P to bf16 before P V. Its emulation stays within
    the card checks' 2e-2 of the plain version and of the reference's oracle."""
    rng = np.random.default_rng(Sq * 31 + Sk + hd)
    arrs = [(rng.standard_normal(s) * f).astype(np.float32)
            for s, f in (((B, H, Sq, hd), scale), ((B, Hkv, Sk, hd), scale), ((B, Hkv, Sk, hd), 1))]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = _tensor_core_numerics(q, k, v, causal=causal, window=window, bk=bk)
    assert torch.isfinite(got.float()).all()
    if scale > 1:
        s = q[0, 0].float() @ k[0, 0].float().T / hd**0.5
        assert float(s.abs().max()) > 500
    _close(got, flash_attention_ref(q, k, v, causal=causal, window=window).float().numpy(), 2e-2)
    G = H // Hkv
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    want = jax_ref(jq, jnp.repeat(jk, G, axis=1), jnp.repeat(jv, G, axis=1), causal=causal,
                   window=window)
    _close(got, want, 2e-2)
