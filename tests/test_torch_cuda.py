"""repro_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries ``@pytest.mark.cuda`` and
takes the ``cuda`` fixture, which skips it where ``torch.cuda`` finds no
device. This file imports nothing of ``repro`` (so nothing of JAX), so it
also runs on a machine with PyTorch for CUDA and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Results must be byte-identical (tolerance 0: integer arithmetic).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DSS, DSSParams
from repro_torch.kernels.cdc_gearhash import ops as cdc_ops
from repro_torch.kernels.cdc_gearhash.ref import gearhash_ref
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
