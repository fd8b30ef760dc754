"""The flash kernel's query offset (``q_offset``), on the CPU: its plain
version with an offset against the whole sequence's rows.

A rank of the fallback layout (``LM._attn``) attends with its block of the
sequence's queries against all of the sequence's keys: query row i sits at
position ``q_offset + i`` for the causal mask and the window. Same seeded
numpy inputs to both packages:

- the plain version (``flash_attention_ref``) and the wrapper (which runs
  it for CPU tensors) on a block of S/4 queries at offsets 0, S/4 and
  3S/4 equal the whole sequence's plain rows of that block, causal,
  windowed (gemma3's local layers' form) and non-causal;
- the same block against the reference's ``flash_attention_ref`` on the
  whole sequence, sliced, and against its ``gqa_attention`` at the
  block's positions (f32 score chain), within the reference's f32
  tolerance 2e-5 (2e-2 in bf16, one rounding of outputs near 1).

The kernel itself is held against the plain version at these offsets on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
``check_flash``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.layers import gqa_attention as jax_gqa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# (B, H, Hkv, S, hd, causal, window, dtype)
SHAPES = {
    "causal-gqa7": (2, 14, 2, 256, 64, True, 0, "float32"),
    "window": (1, 4, 1, 256, 32, True, 48, "float32"),
    "non-causal": (1, 4, 4, 128, 16, False, 0, "float32"),
    "causal-bf16": (2, 4, 2, 256, 64, True, 0, "bfloat16"),
}
OFFSETS = (0, 1, 3)  # the block's index of the sequence's four: 0, S/4, 3S/4
CASES = [pytest.param(name, part, id=f"{name}-at{part}of4") for name in SHAPES
         for part in OFFSETS]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(name: str):
    B, H, Hkv, S, hd, causal, window, dtype = SHAPES[name]
    rng = np.random.default_rng(hd + S)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]
    return arrs, [torch.from_numpy(a).to(DTYPE[dtype]) for a in arrs]


@pytest.mark.parametrize("name,part", CASES)
def test_offset_block_equals_the_whole_sequences_rows(name, part):
    """The plain version and the wrapper on the block of S/4 queries from
    ``q_offset`` equal the whole sequence's rows of that block."""
    B, H, Hkv, S, hd, causal, window, dtype = SHAPES[name]
    (_, (q, k, v)), n = _inputs(name), S // 4
    off = part * n
    block = q[:, :, off:off + n].contiguous()
    whole = flash_attention_ref(q, k, v, causal=causal, window=window)[:, :, off:off + n]
    got = flash_attention_ref(block, k, v, causal=causal, window=window, q_offset=off)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    wrapped = ops.flash_attention(block, k, v, causal=causal, window=window, q_offset=off)
    torch.testing.assert_close(wrapped, whole, rtol=0, atol=0)


@pytest.mark.parametrize("name,part", CASES)
def test_offset_block_matches_the_reference(name, part):
    """The block against the reference's plain flash attention on the whole
    sequence, sliced, and its ``gqa_attention`` with the block's query
    positions against every key (score chain in f32)."""
    B, H, Hkv, S, hd, causal, window, dtype = SHAPES[name]
    (arrs, (q, k, v)), n = _inputs(name), S // 4
    off = part * n
    got = ops.flash_attention(q[:, :, off:off + n].contiguous(), k, v, causal=causal,
                              window=window, q_offset=off).float().numpy()
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    G = H // Hkv
    want = jax_ref(jq, jnp.repeat(jk, G, axis=1), jnp.repeat(jv, G, axis=1), causal=causal,
                   window=window)[:, :, off:off + n]
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL[dtype],
                               atol=TOL[dtype])
    pos = jnp.arange(S, dtype=jnp.int32)
    gqa = jax_gqa(jq[:, :, off:off + n].transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                  jv.transpose(0, 2, 1, 3), q_pos=pos[off:off + n], k_pos=pos, causal=causal,
                  window=window or None, score_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(gqa, np.float32).transpose(0, 2, 1, 3),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_a_negative_offset_is_refused():
    """``q_offset`` < 0 raises ``ValueError`` on any device, before a launch."""
    (_, (q, k, v)) = _inputs("window")
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)
