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
