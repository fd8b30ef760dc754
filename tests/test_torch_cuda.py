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
scores up to ~1e3 in the extreme-logit case).
"""
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


@pytest.mark.cuda
def test_gf256_degenerate_shapes_do_not_launch(cuda):
    before = gf_ops.launches
    for ma, ka, L in [(0, 4, 16), (2, 4, 0), (2, 0, 5)]:
        out = gf_ops.gf256_matmul(np.zeros((ma, ka), np.uint8),
                                  torch.zeros((ka, L), dtype=torch.uint8, device=cuda))
        assert tuple(out.shape) == (ma, L) and out.device.type == "cuda"
    assert gf_ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 31, 33, 2047, 2048, 2049, 1 << 20])
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
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_1b"])
def test_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """The prefill with the kernel on the card against the plain versions
    on the CPU, same weights (one seeded generator) and tokens, on a reduced
    config: logits within 4 bf16 ulps at |logit| < 4 (matmuls round in
    another order on the two devices), one launch per layer."""
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
        assert fa_ops.launches - before == (cfg.n_layers if dev == "cuda" else 0)
    assert torch.isfinite(logits["cuda"]).all()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0, atol=4 * 2.0**-6)
