"""repro_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries ``@pytest.mark.cuda`` and
takes the ``cuda`` fixture, which skips it where ``torch.cuda`` finds no
device. This file imports nothing of ``repro`` (so nothing of JAX), so it
also runs on a machine with PyTorch for CUDA and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The storage kernels must be byte-identical (tolerance 0: integer
arithmetic). The flash-attention kernel must agree with its plain version
within 2e-2 in bf16 (one bf16 rounding of outputs near 1, plus f32 sums in
another order) and 1e-4 in f32 (f32 sums in another order, and exp of
scores up to ~1e3 in the extreme-logit case). A bf16 block of queries at
an offset is held row by row instead: each row within ROW_ULPS bf16 ulps
of its largest |output| (``_torch_moe_criteria.row_ulps``), since over
thousands of keys the outputs are far below 1.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import DSS, DSSParams
from repro_torch.kernels.cdc_gearhash import ops as cdc_ops
from repro_torch.kernels.cdc_gearhash.ref import gearhash_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.gf256_matmul import ops as gf_ops
from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref

from _torch_cuda import cuda  # noqa: F401  (fixture)
from _torch_encdec import cross_kv, draw_final_norms
from _torch_moe_criteria import row_ulps

GF_SHAPES = [(1, 2, 8), (4, 10, 1000), (8, 24, 4096), (2, 2, 1), (12, 20, 8192),
             (5, 6, 1_000_003), (6, 6, 4097), (9, 6, 4111), (256, 256, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,L", GF_SHAPES)
def test_gf256_kernel_matches_plain(cuda, m, k, L):
    rng = np.random.default_rng(m * 1000 + k * 10 + L)
    A = rng.integers(0, 256, (m, k), dtype=np.uint8)
    A[0, 0] = 0  # a zero coefficient takes the skipped-row branch
    B = torch.from_numpy(rng.integers(0, 256, (k, L), dtype=np.uint8)).to(cuda)
    before = gf_ops.launches
    got = gf_ops.gf256_matmul(A, B)
    assert gf_ops.launches == before + 1
    assert torch.equal(got, gf256_matmul_ref(torch.from_numpy(A), B))


GF_BLOCK_COLUMNS = 8 * 31 * 16  # a block's columns: 8 warps of 31 strips of 16


@pytest.mark.cuda
@pytest.mark.parametrize("rem", range(1, 16))
def test_gf256_kernel_every_row_offset(cuda, rem):
    """Multi-block rows with every L % 16 in 1..15 (so every row offset of
    the funnel shifts and of the realigned stores), for the path's encode
    and decode matrices and an A of 0s and 1s beside full entries."""
    from repro_torch.erasure.rs import _decoder_cached, _parity_cached

    rng = np.random.default_rng(rem)
    L = 5 * GF_BLOCK_COLUMNS + 16 * rem + rem
    mixed = rng.integers(0, 256, (7, 6), dtype=np.uint8)
    mixed[rng.integers(0, 3, (7, 6)) == 0] = 0
    mixed[rng.integers(0, 3, (7, 6)) == 0] = 1
    mixed[:, 0] = 1  # an input row of units alone
    B = torch.from_numpy(rng.integers(0, 256, (6, L), dtype=np.uint8)).to(cuda)
    for A in (_parity_cached(11, 6), _decoder_cached(11, 6, (1, 2, 3, 4, 5, 6)), mixed):
        got = gf_ops.gf256_matmul(A, B)
        assert torch.equal(got, gf256_matmul_ref(torch.from_numpy(A), B))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [GF_BLOCK_COLUMNS - 1, GF_BLOCK_COLUMNS, GF_BLOCK_COLUMNS + 1,
                               495, 497])
def test_gf256_kernel_takes_unaligned_rows(cuda, L):
    """A contiguous B whose base is not 16-byte aligned, at block and warp
    seams +-1."""
    rng = np.random.default_rng(L)
    A = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    flat = torch.from_numpy(rng.integers(0, 256, 6 * L + 3, dtype=np.uint8)).to(cuda)
    B = flat[3:].view(6, L)
    assert B.data_ptr() % 16 != 0
    assert torch.equal(gf_ops.gf256_matmul(A, B), gf256_matmul_ref(torch.from_numpy(A), B))


@pytest.mark.cuda
def test_gf256_degenerate_shapes_do_not_launch(cuda):
    before = gf_ops.launches
    for ma, ka, L in [(0, 4, 16), (2, 4, 0), (2, 0, 5)]:
        out = gf_ops.gf256_matmul(np.zeros((ma, ka), np.uint8),
                                  torch.zeros((ka, L), dtype=torch.uint8, device=cuda))
        assert tuple(out.shape) == (ma, L) and out.device.type == "cuda"
    assert gf_ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 31, 33, 2047, 2048, 2049, 1 << 20,
                               511, 512, 513, 8191, 8192, 8193, 16385])
@pytest.mark.parametrize("mask", [0, 0xFF, 0xFFFFFFFF])
def test_gearhash_kernel_matches_plain(cuda, L, mask):
    x = torch.from_numpy(np.random.default_rng(L).integers(0, 256, L, dtype=np.uint8)).to(cuda)
    before = cdc_ops.launches
    h, b = cdc_ops.gearhash(x, mask=mask)
    assert cdc_ops.launches == before + 1
    hr, br = gearhash_ref(x, mask=mask)
    assert torch.equal(h.view(torch.int32), hr.view(torch.int32))
    assert torch.equal(b, br)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 17, 8191, 8192, 8193, (1 << 20) + 5])
def test_gearhash_bitmap_only_matches_full(cuda, L):
    """The bitmap-only form (no hash written) gives the full form's bitmap,
    one launch each, at the span size (8192) +-1."""
    x = torch.from_numpy(np.random.default_rng(L + 1).integers(0, 256, L, dtype=np.uint8)).to(cuda)
    before = cdc_ops.launches
    b_only = cdc_ops.gearhash_bitmap(x, mask=0xFF)
    _h, b = cdc_ops.gearhash(x, mask=0xFF)
    assert cdc_ops.launches == before + 2
    assert torch.equal(b_only, b)
    assert torch.equal(b_only, gearhash_ref(x, mask=0xFF)[1])


@pytest.mark.cuda
def test_gearhash_kernel_takes_unaligned_stream(cuda):
    flat = torch.from_numpy(np.random.default_rng(5).integers(0, 256, 20003, dtype=np.uint8))
    x = flat.to(cuda)[3:]
    assert x.data_ptr() % 16 != 0
    h, b = cdc_ops.gearhash(x, mask=0xF)
    hr, br = gearhash_ref(x, mask=0xF)
    assert torch.equal(h.view(torch.int32), hr.view(torch.int32)) and torch.equal(b, br)
    assert torch.equal(cdc_ops.gearhash_bitmap(x, mask=0xF), br)


@pytest.mark.cuda
def test_store_on_the_card_matches_the_cpu(cuda):
    """A write, a degraded read and a repair give the same bytes and trace
    with the kernels as with the plain versions on the CPU."""
    data = np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8).tobytes()

    def run(device):
        dss = DSS(DSSParams(algorithm="coaresecf", n_servers=8, parity_m=2, seed=0,
                            min_block=4096, avg_block=16384, max_block=65536,
                            indexed=True, coding_backend="kernel", device=device))
        stats = dss.session("a").write("f", data).result()
        dss.crash_servers(["s0"])
        got = dss.session("b").read("f").result()
        dss.recover_servers(["s0"])
        rep = dss.repair()
        n = dss.net
        return got, stats, rep, (n.now, n.rpc_rounds, n.msg_count, n.bytes_sent)

    g0, c0 = gf_ops.launches, cdc_ops.launches
    on_card = run("cuda")
    assert gf_ops.launches > g0 and cdc_ops.launches > c0
    assert on_card[0] == data
    assert on_card == run("cpu")


# (B, H, Hkv, Sq, Sk, hd, causal, window, dtype): the reference's CASES
# (tests/test_kernel_flash.py), then head dims, ragged lengths, windows, GQA.
FLASH_CASES = [
    (1, 2, 2, 128, 128, 32, True, 0, torch.float32),
    (2, 4, 4, 256, 256, 64, True, 0, torch.float32),
    (1, 2, 2, 256, 256, 64, False, 0, torch.float32),
    (1, 2, 2, 256, 256, 64, True, 64, torch.float32),
    (2, 2, 2, 512, 512, 128, True, 0, torch.bfloat16),
    (1, 1, 1, 128, 512, 64, True, 0, torch.float32),
    (1, 2, 1, 100, 100, 16, True, 0, torch.bfloat16),
    (1, 2, 2, 130, 77, 128, True, 0, torch.bfloat16),
    (1, 4, 1, 300, 300, 256, True, 0, torch.bfloat16),
    (1, 4, 1, 600, 600, 256, True, 128, torch.bfloat16),
    (2, 3, 3, 1, 1, 64, True, 0, torch.float32),
    (1, 2, 2, 63, 63, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 65, 65, 64, True, 0, torch.bfloat16),
    (1, 2, 1, 2049, 2049, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 65, 2049, 32, False, 0, torch.float32),
    (1, 2, 2, 1, 63, 64, True, 0, torch.float32),
    (1, 2, 2, 200, 50, 64, True, 16, torch.float32),   # rows with no key at all
    (1, 2, 2, 300, 300, 64, False, 40, torch.float32),
    (2, 14, 2, 256, 256, 64, True, 0, torch.bfloat16),  # qwen2-0.5b heads
    # bf16 twins of the cases above that ran in f32 only: the tensor-core form
    (1, 2, 2, 128, 128, 32, True, 0, torch.bfloat16),
    (2, 4, 4, 256, 256, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 256, 256, 64, False, 0, torch.bfloat16),   # non-causal
    (1, 2, 2, 256, 256, 64, True, 64, torch.bfloat16),   # sliding window
    (1, 1, 1, 128, 512, 64, True, 0, torch.bfloat16),
    (2, 3, 3, 1, 1, 64, True, 0, torch.bfloat16),        # Sq = Sk = 1
    (1, 2, 2, 1, 63, 64, True, 0, torch.bfloat16),       # Sq = 1
    (1, 2, 2, 65, 2049, 32, False, 0, torch.bfloat16),   # ragged Sk
    (1, 2, 2, 77, 77, 64, True, 0, torch.bfloat16),      # ragged Sq and Sk
    (1, 2, 2, 200, 50, 64, True, 16, torch.bfloat16),    # rows with no key at all
    (1, 2, 2, 300, 300, 64, False, 40, torch.bfloat16),
    (2, 4, 2, 320, 1111, 128, True, 0, torch.bfloat16),  # top-left causal, Sq < Sk
    (2, 4, 2, 333, 333, 16, False, 0, torch.bfloat16),   # hd 16 under GQA
    (1, 4, 2, 100, 700, 256, True, 0, torch.bfloat16),   # hd 256 under GQA, Sq < Sk
    (1, 4, 1, 700, 700, 256, False, 300, torch.bfloat16),
    (4, 16, 16, 2048, 2048, 128, True, 0, torch.bfloat16),  # olmoe-1b-7b's prefill
    # hd 112 (zamba2-7b), padded to two 64-column chunks in the bf16 form
    (4, 32, 32, 2048, 2048, 112, True, 0, torch.bfloat16),  # zamba2-7b's prefill
    (2, 4, 2, 320, 1111, 112, True, 0, torch.bfloat16),     # top-left causal, Sq < Sk, GQA
    (1, 2, 2, 77, 77, 112, False, 0, torch.bfloat16),       # ragged, non-causal
    (1, 4, 1, 600, 600, 112, True, 128, torch.bfloat16),    # windowed
    (2, 4, 2, 320, 1111, 112, True, 0, torch.float32),
    (1, 2, 2, 200, 50, 112, True, 16, torch.float32),       # rows with no key at all
    # whisper-base's prefill at its published context (1500 audio frames, 448
    # tokens): the encoder, non-causal; the decoder's self-attention, causal;
    # its cross-attention, non-causal with Sq < Sk
    (4, 8, 8, 1500, 1500, 64, False, 0, torch.bfloat16),
    (4, 8, 8, 448, 448, 64, True, 0, torch.bfloat16),
    (4, 8, 8, 448, 1500, 64, False, 0, torch.bfloat16),
    # the reference's make_inputs convention (S tokens, S // 2 frames):
    # non-causal over 1024 keys, and non-causal with Sq > Sk; qwen2-vl-7b's
    # prefill: GQA of 7 query heads a KV head at hd 128, causal
    (4, 8, 8, 1024, 1024, 64, False, 0, torch.bfloat16),
    (4, 8, 8, 2048, 1024, 64, False, 0, torch.bfloat16),
    (4, 28, 4, 2048, 2048, 128, True, 0, torch.bfloat16),
    (1, 8, 8, 333, 77, 64, False, 0, torch.bfloat16),       # ragged, Sq > Sk, non-causal
    (1, 14, 2, 200, 200, 128, True, 0, torch.float32),      # GQA 7 at hd 128 in f32
    # one rank's prefill on a (data=1, model=2) mesh, the heads split over
    # "model": qwen2-0.5b's 7 query heads on its one KV head at hd 64 (GQA 7
    # at hd 64), olmoe-1b-7b's 8 heads on 8 KV heads at hd 128
    (4, 7, 1, 2048, 2048, 64, True, 0, torch.bfloat16),
    (4, 8, 8, 2048, 2048, 128, True, 0, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, Sq, Sk, hd, causal, window, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    rng = np.random.default_rng(Sq * 7 + Sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
               for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the query offset (``q_offset``) of a rank's block of the sequence, S/4 rows
# at 0, S/4 and 3S/4 of S: qwen2-0.5b's GQA 7 at hd 64 and model=4, gemma3's
# window at hd 256, the f32 form, and a narrow window on a ragged length
FLASH_OFFSET_CASES = [
    pytest.param(4, 14, 2, 2048, 64, True, 0, torch.bfloat16, id="qwen2-model4"),
    pytest.param(2, 4, 1, 2048, 256, True, 512, torch.bfloat16, id="gemma3-window512"),
    pytest.param(2, 4, 2, 1024, 128, True, 0, torch.float32, id="f32-hd128"),
    pytest.param(1, 2, 2, 640, 64, True, 48, torch.bfloat16, id="window48-ragged"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("part", [0, 1, 3], ids=["at0", "atS/4", "at3S/4"])
@pytest.mark.parametrize("B,H,Hkv,S,hd,causal,window,dtype", FLASH_OFFSET_CASES)
def test_flash_kernel_with_a_query_offset_matches_plain(cuda, part, B, H, Hkv, S, hd, causal,
                                                        window, dtype):
    """A block of S/4 queries at ``q_offset`` = part * S/4 against all S
    keys: the kernel against its plain version, and both against the whole
    sequence's rows of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S + hd + part)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
               for shape in ((B, H, S // 4, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    off = part * S // 4
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=off)
    whole_q = torch.zeros((B, H, S, hd), dtype=dtype, device=cuda)
    whole_q[:, :, off:off + S // 4] = q
    whole = flash_attention_ref(whole_q, k, v, causal=causal, window=window)
    if dtype == torch.bfloat16:
        assert row_ulps(got, want) <= ROW_ULPS
        assert row_ulps(got, whole[:, :, off:off + S // 4]) <= ROW_ULPS
        return
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), whole[:, :, off:off + S // 4].float(), rtol=1e-4,
                               atol=1e-4)


# a bf16 row's limit in ulps of its largest |output|: the kernel and its plain
# version each round the f32 output to bf16 once (1 ulp apart at most); the
# kernel's bf16 P moves the sum by far less
ROW_ULPS = 4


# a sequence rank's block (sequence sharding over two batch ranks, B = 1):
# half of S queries at offset 0 or S/2 against all S keys, gemma3-1b's hd 256
# with 4 query heads on one KV head, its local layers' window 512 and its
# global layers' none
SEQ_FLASH_CASES = [pytest.param(w, id=f"window{w}") for w in (512, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1], ids=["seq-rank0", "seq-rank1"])
@pytest.mark.parametrize("window", SEQ_FLASH_CASES)
def test_flash_kernel_at_a_sequence_ranks_offset_matches_plain(cuda, rank, window):
    """gemma3-1b's (1, 4, S/2, 256) block of a rank at ``q_offset`` rank *
    S/2 against the S = 8192 keys: the kernel against its plain version and
    the whole sequence's rows of it, each row within ROW_ULPS; the kernel
    run one key tile (64 keys at hd 256) off misses that limit: at an
    offset one tile off, and (rank 1's global layer) with the first tile's
    keys dropped."""
    S, half = 8192, 4096
    rng = np.random.default_rng(41 + rank + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda,
                                                                                torch.bfloat16)
               for shape in ((1, 4, half, 256), (1, 1, S, 256), (1, 1, S, 256)))
    off = rank * half
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=True, window=window, q_offset=off)
    assert row_ulps(got, want) <= ROW_ULPS
    whole_q = torch.zeros((1, 4, S, 256), dtype=torch.bfloat16, device=cuda)
    whole_q[:, :, off:off + half] = q
    whole = flash_attention_ref(whole_q, k, v, causal=True, window=window)[:, :, off:off + half]
    assert row_ulps(got, whole) <= ROW_ULPS
    tile = 64
    shifted = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     q_offset=off - tile if off else tile)
    assert row_ulps(shifted, want) > ROW_ULPS
    if off and not window:
        dropped = fa_ops.flash_attention(q, k[:, :, tile:].contiguous(),
                                         v[:, :, tile:].contiguous(), causal=True,
                                         q_offset=off - tile)
        assert row_ulps(dropped, want) > ROW_ULPS


@pytest.mark.cuda
def test_seq_prefill_on_a_shared_card_mesh(cuda, tmp_path):
    """Two processes sharing the card on ``make_shared_card_mesh((2, 1))``, B
    = 1: gemma3-1b and mamba2-2.7b at full width and 2 layers, their
    sequence-sharded prefill of 2048 tokens (1024 a rank: the keys gathered
    and the flash kernel at each rank's offset; the conv's halo and the
    SSM state's relay through host memory) equal bit for bit to the
    unsharded prefill on the card."""
    import dataclasses

    from _torch_mesh_ranks import run_ranks

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    archs, seed = ("gemma3_1b", "mamba2_2_7b"), 3
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 32000, (1, 2048),
                                                                dtype=np.int32))
    ranks = run_ranks("seq_shared_card", 2, tmp_path, dict(
        shape=(2, 1), archs=archs, layers=2, seed=seed, tokens=tokens))
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        model = build_model(cfg, max_pos=2048)
        model.pure_dp = False
        params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
        want = make_prefill_step(model)(params, {"tokens": tokens.to(cuda)}).cpu()
        for r in ranks:
            got = r[arch]
            assert torch.equal(got["logits"], want), float((got["logits"] - want).abs().max())
            assert got["launches"] == (2 if arch == "gemma3_1b" else 0)
            layers = 2 if arch == "mamba2_2_7b" else 0
            assert got["counts"].get("halo", 0) == layers == got["counts"].get("relay", 0)
        del model, params


@pytest.mark.cuda
def test_flash_kernel_extreme_logits(cuda):
    """Online rescaling must not overflow with large logits (the reference's
    test_online_softmax_extreme_values, at x30)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 1, 64, 32)) * 30).float().to(cuda)
    k = torch.from_numpy(rng.standard_normal((1, 1, 64, 32)) * 30).float().to(cuda)
    v = torch.from_numpy(rng.standard_normal((1, 1, 64, 32))).float().to(cuda)
    got = fa_ops.flash_attention(q, k, v)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flash_attention_ref(q, k, v), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_extreme_logits_bf16(cuda):
    """The bf16 (tensor-core) form with q and k x30, so that the f32 scores
    reach ~+-1e3, and rows whose first key tiles are all masked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    shape = (1, 2, 256, 32)
    q, k = (torch.from_numpy(rng.standard_normal(shape) * 30).to(cuda, torch.bfloat16)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal(shape)).to(cuda, torch.bfloat16)
    for window in (0, 100):
        got = fa_ops.flash_attention(q, k, v, window=window)
        want = flash_attention_ref(q, k, v, window=window)
        assert float((q[0, 0].float() @ k[0, 0].float().T).abs().max()) / 32**0.5 > 500
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_takes_unaligned_bf16(cuda):
    """A contiguous bf16 view whose base is not 16-byte aligned (the TMA
    needs one) still gives the plain version's result."""
    rng = np.random.default_rng(3)
    n = 2 * 2 * 96 * 64
    flat = torch.from_numpy(rng.standard_normal(3 * n + 1, dtype=np.float32))
    flat = flat.to(cuda, torch.bfloat16)
    q, k, v = (flat[1 + i * n: 1 + (i + 1) * n].view(2, 2, 96, 64) for i in range(3))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    got = fa_ops.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    hd48 = torch.zeros((1, 2, 8, 48), device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    kv3 = torch.zeros((1, 3, 8, 64), device=cuda, dtype=torch.bfloat16)
    before = fa_ops.launches
    for args in ((hd48, hd48, hd48), (q.half(), q.half(), q.half()), (q.float(), q, q),
                 (strided, q, q), (q.cpu(), q, q), (q, kv3, kv3)):
        with pytest.raises(ValueError):
            fa_ops.flash_attention(*args)
    assert fa_ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_1b", "mamba2_2_7b", "zamba2_7b"])
def test_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """The prefill with the kernel on the card against the plain versions
    on the CPU, same weights (one seeded generator) and tokens, on a reduced
    config: logits within 4 bf16 ulps at |logit| < 4 (matmuls round in
    another order on the two devices), one launch per attention layer (none
    in mamba2, one per group of zamba2)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    cfg = get_arch(arch).reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 96)))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = model.load_params(model.init_params(torch.Generator().manual_seed(0)))
        before = fa_ops.launches
        logits[dev] = make_prefill_step(model)(params, {"tokens": tokens.to(dev)}).cpu()
        attn = {"ssm": 0, "hybrid": cfg.n_layers // max(1, cfg.shared_attn_every)}
        assert fa_ops.launches - before == (attn.get(cfg.family, cfg.n_layers)
                                            if dev == "cuda" else 0)
    assert torch.isfinite(logits["cuda"]).all()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0, atol=4 * 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper_base", "qwen2_vl_7b"])
def test_encdec_vlm_on_the_card_match_the_cpu(cuda, arch):
    """whisper-base (2 encoder + 2 decoder layers) and qwen2-vl-7b (2 layers)
    reduced, from the same weights (one seeded generator; whisper's final
    layer norms drawn, which the init rule leaves at 0) and the same
    ``make_inputs`` of a 2 x 96 prefill, on the card and on the CPU: the
    prefill's logits within 4 bf16 ulps at |logit| < 4 and the kernel
    launched once per encoder layer and twice per decoder layer (whisper:
    6) or once per layer (qwen2-vl: 2); then 4 decode steps (qwen2-vl fed
    its embeddings; whisper teacher-forced, its ``xk``/``xv`` filled from
    each device's encoder output: ``enc_out @ xwk``, ``@ xwv``), each
    step's logits within the same tolerance."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models.registry import build_model, make_inputs
    from repro_torch.train.steps import make_prefill_step

    cfg = get_arch(arch).reduced()
    inputs = make_inputs(cfg, ShapeConfig("prefill", 96, 2, "prefill"), seed=0, device="cpu")
    weights = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    if cfg.family == "encdec":
        # the init rule's zero final layer norms make every logit 0: draw them
        draw_final_norms(weights, 1)
    seen = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = model.load_params(weights)
        batch = {k: v.to(dev) for k, v in inputs.items() if k != "labels"}
        before = fa_ops.launches
        last = make_prefill_step(model)(params, batch).cpu()
        want = 2 * cfg.n_layers + cfg.encoder_layers if cfg.family == "encdec" else cfg.n_layers
        assert fa_ops.launches - before == (want if dev == "cuda" else 0)
        cache = model.init_cache(2, 96)
        if cfg.family == "encdec":
            cache["xk"], cache["xv"] = cross_kv(model, params, batch["audio_embeds"])
        steps = []
        for i in range(4):
            step = ({"embed": batch["embeds"][:, i]} if cfg.embeddings_input
                    else {"token": batch["tokens"][:, i]})
            logits, cache = model.decode_step(params, cache, {**step, "cur_len": i})
            steps.append(logits.cpu())
        seen[dev] = (last, torch.stack(steps))
    for got, want in zip(seen["cuda"], seen["cpu"]):
        assert torch.isfinite(got).all() and 0 < want.abs().max() < 4
        torch.testing.assert_close(got, want, rtol=0, atol=4 * 2.0**-6)


def _workload_report(device: str) -> tuple[dict, tuple]:
    """A small YCSB-B run through a gateway on the Emulab deployment (the
    spec of ``chip_smoke.py``'s phase (a), at 32 sessions over 8 files of
    256 KiB), with a tolerable crash storm and retries."""
    from repro_torch.configs.paper_store import EMULAB, make_dss
    from repro_torch.core import CrashStorm, RetryPolicy, WorkloadGen, WorkloadSpec

    dss = make_dss(EMULAB, seed=4, indexed=True, coding_backend="kernel", device=device,
                   min_block=16 << 10, avg_block=16 << 10, max_block=64 << 10,
                   retry=RetryPolicy())
    spec = WorkloadSpec(sessions=32, files=8, file_size=256 << 10, read_fraction=0.95,
                        zipf_s=0.99, ops_per_session=2,
                        storms=(CrashStorm(at=0.05, frac=0.25, duration=0.05),))
    gw = dss.gateway()
    report = WorkloadGen(spec, seed=4).run(dss, via=gw)
    gw.stop()
    dss.net.run()
    assert dss.net.stuck_ops() == []
    n = dss.net
    return report, (n.now, n.events_processed, n.rpc_rounds, n.msg_count, n.bytes_sent,
                    n.client_counters)


@pytest.mark.cuda
def test_workload_report_on_the_card_matches_the_cpu(cuda):
    before = (cdc_ops.launches, gf_ops.launches)
    card = _workload_report("cuda")
    assert cdc_ops.launches > before[0] and gf_ops.launches > before[1]
    assert card == _workload_report("cpu")
    assert card[0]["ops_stuck"] == 0 and card[0]["availability_after_recovery"] >= 0.99


@pytest.mark.cuda
def test_checkpoint_of_a_reduced_model_round_trips_on_the_card(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import ECCheckpointStore

    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cuda")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(0)))
    store = ECCheckpointStore(device="cuda", coding_backend="kernel", min_block=4096,
                              avg_block=16384, max_block=65536)
    before = (cdc_ops.launches, gf_ops.launches)
    assert store.save(1, params).success
    store.crash_hosts([f"s{i}" for i in range(store.fault_budget())])
    step, got = store.restore()
    assert cdc_ops.launches > before[0] and gf_ops.launches > before[1]

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            yield from leaves(v, prefix + k + ".") if isinstance(v, dict) else [(prefix + k, v)]

    want, back = dict(leaves(params)), dict(leaves(got))
    assert step == 1 and want.keys() == back.keys()
    for name, value in want.items():
        assert back[name].device.type == "cuda" and back[name].dtype == value.dtype
        assert torch.equal(back[name], value), name
    assert store.dss.net.stuck_ops() == []


def _train_step(model, params, batch: dict) -> tuple:
    """``loss_and_grads`` then one ``make_train_step`` from the same state
    (``AdamWConfig()``), as (loss, grads, params, opt, the step's loss) on
    the host, with each ``_route`` call of both (``RouteLog``)."""
    import _torch_train_criteria as crit
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import loss_and_grads, make_train_step

    from _torch_moe_criteria import RouteLog

    with RouteLog() as routes:
        loss, grads = loss_and_grads(model, params, batch)
        new, opt, loss2 = make_train_step(model)(params, adamw_init(params), batch)
    assert new["embed"].device.type == model.device.type and opt["step"].dtype == torch.int32
    return (float(loss), crit.to_np(grads), crit.to_np(new), crit.to_np(opt), float(loss2),
            routes.calls)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 64), (1, 2048)])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_1b", "olmoe_1b_7b", "qwen3_moe_30b_a3b",
                                  "mamba2_2_7b", "zamba2_7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, B, S):
    """One train step (reduced config, ``AdamWConfig()``) on the card and on
    the CPU, same weights (one seeded generator) and batch, held to the
    criteria of ``tests/_torch_train_criteria.py``: the loss, every gradient
    leaf, m, v, step and the updated parameters. At S=2048 the attention
    runs in q_chunk chunks, each under its own checkpoint.

    MoE: on each device the recompute in the backward routes exactly as the
    forward did (probabilities, expert sets and drops equal); between the
    devices the forward's routes meet ``tests/_torch_moe_criteria.py``.
    Where a route differs, the card is held against the CPU's step run
    again on the card's routes (``RouteReplay``). SSM and hybrid: the CPU's
    own step with every SSD output nudged one f32 ulp up and down
    (``ssd_nudged``) decides whether and how the step is held
    (``hold_step``); where it is not, only the losses and step are."""
    import _torch_train_criteria as crit
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig

    from _torch_moe_criteria import RouteReplay, compare_routes

    cfg = get_arch(arch).reduced()
    lr = AdamWConfig().lr
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)).next_batch()
    seen, nudged = {}, []
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        seen[dev] = _train_step(model, params, b)
        if dev == "cpu":
            cpu = (model, params, b)
            for to in (math.inf, -math.inf) if cfg.is_ssm else ():
                with crit.ssd_nudged(to):
                    _, g, p, o, _, _ = _train_step(model, params, b)
                nudged.append((crit.step_metrics(p, o, *seen["cpu"][2:4], lr),
                               crit.grad_errors(g, seen["cpu"][1])))
    (lc, gc, pc, oc, lc2, rc), (lh, gh, ph, oh, lh2, rh) = seen["cuda"], seen["cpu"]
    assert np.isfinite(lc) and abs(lc - lh) <= crit.LOSS_ATOL and abs(lc2 - lh2) <= crit.LOSS_ATOL
    assert int(oc["step"]) == int(oh["step"]) == 1
    if cfg.family == "moe":
        L = cfg.n_layers
        for calls in (rc, rh):  # loss_and_grads, then the train step: forward, recompute each
            assert len(calls) == 4 * L
            # the backward recomputes the layers from the last one back
            for fwd, again in zip(2 * (calls[:L] + calls[:L][::-1]), calls):
                assert all(np.array_equal(fwd[k], again[k]) for k in ("probs", "routed", "kept"))
        if not compare_routes(rc[:L], rh[:L], cfg.moe_top_k, B)["agree"].all():
            with RouteReplay(rc):
                _, gh, ph, oh, _, replayed = _train_step(*cpu)
            assert all(np.array_equal(a[k], r[k]) for a, r in zip(rc, replayed)
                       for k in ("routed", "kept"))
    _, verdict, failures = crit.hold_step(crit.step_metrics(pc, oc, ph, oh, lr),
                                          crit.grad_errors(gc, gh), nudged)
    assert not failures, (verdict, failures)


@pytest.mark.cuda
def test_training_state_round_trips_through_the_store_on_the_card(cuda):
    """Two train steps of reduced qwen2-0.5b on the card, a save of the whole
    state (parameters, AdamW state, data state) through the store on the
    card, the fault budget's hosts down, a restore (bit for bit, on the
    card), and the next step from the restored state: its loss equals the
    uninterrupted run's within 1e-3 (the forward from an equal state
    repeats; only the backward's atomics, after the loss, may differ)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import ECCheckpointStore
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import named_leaves

    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cuda")
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=64, global_batch=2))
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model)

    def batch():
        return {k: torch.from_numpy(v).to(cuda) for k, v in data.next_batch().items()}

    for _ in range(2):
        params, opt, _ = step(params, opt, batch())
    store = ECCheckpointStore(device="cuda", coding_backend="kernel", min_block=4096,
                              avg_block=16384, max_block=65536)
    before = (cdc_ops.launches, gf_ops.launches)
    saved = {"params": params, "opt": opt, "data": data.state()}
    assert store.save(2, saved).success
    _, _, want = step(params, opt, batch())
    store.crash_hosts([f"s{i}" for i in range(store.fault_budget())])
    got_step, state = store.restore()
    assert cdc_ops.launches > before[0] and gf_ops.launches > before[1]
    assert got_step == 2

    back = dict(named_leaves(state))
    for name, value in named_leaves(saved):
        if isinstance(value, torch.Tensor):
            assert back[name].device.type == "cuda" and back[name].dtype == value.dtype
            assert torch.equal(back[name], value), name
        else:
            assert int(back[name]) == value, name
    data.restore(state["data"])
    _, _, again = step(state["params"], state["opt"], batch())
    assert abs(float(again) - float(want)) <= 1e-3
    assert store.dss.net.stuck_ops() == []


@pytest.mark.cuda
def test_explorer_selftest_on_the_card(cuda, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.explore", "--selftest", "--device",
         "cuda", "--budget", "500", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("[selftest] ok:") == 4


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """``moe_layer`` on identical bf16 inputs (T=2048, D=256, 32 experts,
    top-8, capacity factor 1.0: 341 assignments drop) on the card and the
    CPU: routes to ``_torch_moe_criteria``; y, where they agree, within 4
    bf16 ulps of each token's largest |y| (cuBLAS sums the expert products
    in another order), with most elements equal bit for bit."""
    import math

    from repro_torch.models.layers import moe_layer

    from _torch_moe_criteria import RouteLog, bf16_ulp, compare_routes

    T, D, E, K, F = 2048, 256, 32, 8, 128
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((1, T, D), generator=g).to(bf)
    ws = [(torch.randn(shape, generator=g) / math.sqrt(shape[-2])).to(bf)
          for shape in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    seen = {}
    for dev in ("cuda", "cpu"):
        with RouteLog() as routes:
            y, aux = moe_layer(x.to(dev), *(w.to(dev) for w in ws), top_k=K, capacity_factor=1.0)
        seen[dev] = (y[0].float().cpu().numpy(), float(aux), routes.calls)
    res = compare_routes(seen["cuda"][2], seen["cpu"][2], K, 1)
    assert int((~seen["cpu"][2][0]["kept"] & seen["cpu"][2][0]["routed"]).sum()) > 0
    agree = res["agree"]
    yc, yh = seen["cuda"][0][agree], seen["cpu"][0][agree]
    d = np.abs(yc - yh)
    assert (d <= 4 * bf16_ulp(np.abs(yh).max(-1, keepdims=True))).all()
    assert (d == 0).mean() > 0.9
    assert abs(seen["cuda"][1] - seen["cpu"][1]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen3_moe_30b_a3b"])
def test_moe_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """The MoE prefill on the card against the CPU, reduced config, same
    weights and tokens: routes to ``_torch_moe_criteria``, logits within 4
    bf16 ulps at |logit| < 4 at the sequences whose routes agree in every
    layer, one flash launch per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    from _torch_moe_criteria import RouteLog, compare_routes

    cfg = get_arch(arch).reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 96)))
    weights = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    seen = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = model.load_params(weights)
        before = fa_ops.launches
        with RouteLog() as routes:
            logits = make_prefill_step(model)(params, {"tokens": tokens.to(dev)}).cpu()
        assert fa_ops.launches - before == (cfg.n_layers if dev == "cuda" else 0)
        seen[dev] = (logits, routes.calls)
    assert torch.isfinite(seen["cuda"][0]).all()
    rows = compare_routes(seen["cuda"][1], seen["cpu"][1], cfg.moe_top_k, 2)["seqs"]
    assert rows
    torch.testing.assert_close(seen["cuda"][0][rows], seen["cpu"][0][rows], rtol=0,
                               atol=4 * 2.0**-6)


# The SSD pieces at reduced width (mamba2-2.7b's reduced config), on the card
# against the CPU. f32 inputs to the SSD alone: within 32 f32 ulps of the
# largest |y| (its Q + N terms summed in another order, as against the
# reference in tests/test_torch_ssd.py). Through the bf16 projections, the
# two devices may round an activation one bf16 ulp apart, and the SSD and
# the norm carry that: outputs and states within SSM_BF16_ULPS = 8 bf16 ulps
# of their largest entries (the model's card-vs-CPU criterion, PERF.md §2).
SSM_BF16_ULPS = 8


def _bf16_ulp(t: torch.Tensor) -> float:
    from _torch_moe_criteria import bf16_ulp

    return float(bf16_ulp(float(t.abs().max())))


def _ssd_layer(seed: int):
    from repro_torch.configs import get_arch
    from repro_torch.models import ssd

    cfg = get_arch("mamba2_2_7b").reduced()
    g = torch.Generator().manual_seed(seed)
    p = {}
    for name, (shape, dtype) in ssd.mamba2_param_shapes(cfg).items():
        scale = 0.5 if len(shape) == 1 or name == "conv_w" else shape[0] ** -0.5
        p[name] = (torch.randn(shape, generator=g) * scale).to(dtype)
    return cfg, p, g


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 4])
def test_ssd_chunked_on_the_card_matches_the_cpu(cuda, chunks):
    from repro_torch.models import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, g = _ssd_layer(0)
    B, H, P, N, Q = 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    L = chunks * Q
    x = torch.randn((B, L, H, P), generator=g)
    dt_ = ssd.softplus(torch.randn((B, L, H), generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.5)
    Bm, Cm = torch.randn((B, L, 1, N), generator=g), torch.randn((B, L, 1, N), generator=g)
    want = ssd._ssd_chunked(x, dt_, A, Bm, Cm, Q)
    got = ssd._ssd_chunked(*(t.to(cuda) for t in (x, dt_, A, Bm, Cm)), Q).cpu()
    atol = 32 * float(np.spacing(np.float32(want.abs().max())))
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_mamba2_mixer_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, g = _ssd_layer(1)
    x = torch.randn((2, 4 * cfg.ssm_chunk, cfg.d_model), generator=g).bfloat16()
    want = ssd.mamba2_mixer(p, x, cfg).float()
    got = ssd.mamba2_mixer({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), cfg).float().cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=SSM_BF16_ULPS * _bf16_ulp(want))


@pytest.mark.cuda
def test_mamba2_decode_step_on_the_card_matches_the_cpu(cuda):
    """Four steps from the same random conv window and state on each device,
    each carrying its own: y each step and the state at the end."""
    from repro_torch.models import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, g = _ssd_layer(2)
    B = 2
    conv_dim = cfg.d_inner + 2 * ssd.G * cfg.ssm_state
    conv = torch.randn((B, cfg.conv_kernel - 1, conv_dim), generator=g).bfloat16()
    state = torch.randn((B, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), generator=g)
    pc = {k: v.to(cuda) for k, v in p.items()}
    side = {"cpu": (conv, state), "cuda": (conv.to(cuda), state.to(cuda))}
    for _ in range(4):
        x = torch.randn((B, cfg.d_model), generator=g).bfloat16()
        y_cpu, *side["cpu"] = ssd.mamba2_decode_step(p, x, *side["cpu"], cfg)
        y_card, *side["cuda"] = ssd.mamba2_decode_step(pc, x.to(cuda), *side["cuda"], cfg)
        torch.testing.assert_close(y_card.float().cpu(), y_cpu.float(), rtol=0,
                                   atol=SSM_BF16_ULPS * _bf16_ulp(y_cpu))
    want = side["cpu"][1]
    torch.testing.assert_close(side["cuda"][1].cpu(), want, rtol=0,
                               atol=SSM_BF16_ULPS * _bf16_ulp(want))


@pytest.mark.cuda
def test_sharded_prefill_on_a_one_rank_nccl_mesh(cuda):
    """qwen2-0.5b at full width, 2 layers: ``make_prefill_step(model, ctx)``
    on ``make_host_mesh("cuda")`` (an NCCL group of one rank) equals the
    unsharded prefill bit for bit, with one flash launch per layer, and a
    sharded train step's loss equals the unsharded step's within 2e-2 (the
    chunked cross-entropy sums in another order)."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_prefill_step, make_train_step

    cfg = dataclasses.replace(get_arch("qwen2_0_5b"), n_layers=2)
    model = build_model(cfg, max_pos=256, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256), dtype=np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        ctx = MeshCtx(make_host_mesh("cuda"))
        assert ctx.shape == {"data": 1, "model": 1}
        before = fa_ops.launches
        got = make_prefill_step(model, ctx)(params, {"tokens": batch["tokens"]})
        assert fa_ops.launches - before == cfg.n_layers
        assert torch.equal(got, make_prefill_step(model)(params, {"tokens": batch["tokens"]}))
        _, _, loss = make_train_step(model, ctx)(params, adamw_init(params), batch)
        _, _, want = make_train_step(model)(params, adamw_init(params), batch)
        assert abs(float(loss) - float(want)) <= 2e-2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_shared_card_mesh_runs_tensor_parallel_on_one_card(cuda, tmp_path):
    """Two processes sharing the card on ``make_shared_card_mesh((1, 2))``,
    over gloo (NCCL refuses two ranks on one GPU); a CUDA mesh over gloo
    built any other way is refused. Reduced qwen2-0.5b, not pure
    data-parallel: the sharded prefill (the flash kernel on each rank's 2
    heads) and three decode steps within the serving criterion (4 bf16 ulps
    at the logits' magnitude) of the unsharded ones on the card."""
    from _torch_mesh_ranks import run_ranks

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models.registry import build_model, make_inputs
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_arch("qwen2_0_5b").reduced()
    model = build_model(cfg, max_pos=256, device="cpu")
    model.pure_dp = False
    params = model.init_params(torch.Generator().manual_seed(0))
    prefill = {"tokens": make_inputs(cfg, ShapeConfig("t", 256, 4, "prefill"), seed=2,
                                     device="cpu")["tokens"]}
    ranks = run_ranks("shared_card", 2, tmp_path, dict(
        arch="qwen2_0_5b", shape=(1, 2), names=("data", "model"), max_pos=256, params=params,
        prefill=prefill, tokens=prefill["tokens"], cache_len=16, steps=3))
    card = build_model(cfg, max_pos=256, device="cuda")
    cparams = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    want = make_prefill_step(card)(cparams, {"tokens": prefill["tokens"].to(cuda)}).cpu()
    cache, serve, steps = card.init_cache(4, 16), make_serve_step(card), []
    for i in range(3):
        logits, cache = serve(cparams, cache, {"token": prefill["tokens"][:, i].to(cuda),
                                               "cur_len": i})
        steps.append(logits.cpu())
    for r in ranks:
        assert r["refused"] and "nccl" in r["refused"]
        assert r["counts"].get("all_gather", 0) > 0
        torch.testing.assert_close(r["logits"], want, rtol=0, atol=4 * 2.0**-6)
        for got, ref in zip(r["decode"], steps, strict=True):
            torch.testing.assert_close(got, ref, rtol=0, atol=4 * 2.0**-6)
