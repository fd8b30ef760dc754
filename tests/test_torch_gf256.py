"""repro_torch's GF(256) matmul against repro's Pallas kernel and oracles.

On the CPU the port's wrapper runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode (as ``test_kernel_gf256.py`` does),
its pure-jnp oracle and the numpy LUT. Every comparison is byte-exact:
this is integer arithmetic, so the tolerance is 0. The CUDA kernel itself
is held against the plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.erasure.gf import gf_matmul_np
from repro.kernels.gf256_matmul.ops import gf256_matmul as ref_gf256_matmul
from repro.kernels.gf256_matmul.ref import gf256_matmul_ref as jnp_ref

from repro_torch.erasure.rs import RSCode as PortRSCode
from repro_torch.kernels.gf256_matmul import ops as port_ops
from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref as torch_ref

SHAPES = [
    (1, 2, 8),
    (2, 4, 128),
    (4, 10, 1000),
    (3, 16, 2048),
    (8, 24, 4096),
    (16, 32, 2048),
    (2, 2, 1),
    (12, 20, 8192),
]


def _operands(m, k, L):
    rng = np.random.default_rng(m * 1000 + k * 10 + L)
    return (rng.integers(0, 256, (m, k), dtype=np.uint8),
            rng.integers(0, 256, (k, L), dtype=np.uint8))


@pytest.mark.parametrize("m,k,L", SHAPES)
def test_port_matches_pallas_interpret(m, k, L):
    A, B = _operands(m, k, L)
    got = port_ops.gf256_matmul(A, torch.from_numpy(B)).numpy()
    want = np.asarray(ref_gf256_matmul(A, B, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,L", SHAPES)
def test_port_matches_oracles(m, k, L):
    A, B = _operands(m, k, L)
    got = port_ops.gf256_matmul(A, B).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp_ref(A, B)))
    np.testing.assert_array_equal(got, gf_matmul_np(A, B))
    np.testing.assert_array_equal(port_ops.gf256_coding_matmul(A, B, device="cpu"), got)


def test_edge_values():
    """Identity, zero and all-255 matrices; zero and 255 bytes in B."""
    k, L = 6, 256
    B = np.arange(k * L, dtype=np.uint8).reshape(k, L)
    np.testing.assert_array_equal(port_ops.gf256_matmul(np.eye(k, dtype=np.uint8), B).numpy(), B)
    Z = np.zeros((3, k), dtype=np.uint8)
    np.testing.assert_array_equal(port_ops.gf256_matmul(Z, B).numpy(), np.zeros((3, L), np.uint8))
    F = np.full((2, k), 255, dtype=np.uint8)
    np.testing.assert_array_equal(port_ops.gf256_matmul(F, B).numpy(),
                                  np.asarray(ref_gf256_matmul(F, B, interpret=True)))
    every = np.arange(256, dtype=np.uint8)
    A = every.reshape(16, 16)
    B = np.stack([every[16 * r:16 * r + 16].repeat(16) for r in range(16)])
    np.testing.assert_array_equal(port_ops.gf256_matmul(A, B).numpy(), gf_matmul_np(A, B))


def test_degenerate_shapes():
    for ma, ka, L in [(0, 4, 16), (2, 4, 0), (0, 0, 0), (2, 0, 5)]:
        A = np.zeros((ma, ka), dtype=np.uint8)
        B = np.zeros((ka, L), dtype=np.uint8)
        out = port_ops.gf256_matmul(A, B)
        assert tuple(out.shape) == (ma, L) and out.dtype == torch.uint8
        out2 = port_ops.gf256_coding_matmul(A, B, device="cpu")
        assert out2.shape == (ma, L) and out2.dtype == np.uint8
        ref = np.asarray(ref_gf256_matmul(A, B, interpret=True))
        np.testing.assert_array_equal(out.numpy(), ref)


def test_shape_validation_raises_valueerror():
    A = np.zeros((2, 4), dtype=np.uint8)
    with pytest.raises(ValueError):
        port_ops.gf256_matmul(A, np.zeros((5, 16), dtype=np.uint8))
    with pytest.raises(ValueError):
        port_ops.gf256_matmul(A, np.zeros(16, dtype=np.uint8))
    with pytest.raises(ValueError):
        port_ops.gf256_coding_matmul(A, np.zeros((5, 16), dtype=np.uint8), device="cpu")
    with pytest.raises(ValueError):
        port_ops.gf256_coding_matmul(np.zeros(4, dtype=np.uint8),
                                     np.zeros((4, 16), dtype=np.uint8), device="cpu")


def test_cpu_calls_do_not_count_launches():
    before = port_ops.launches
    A, B = _operands(4, 10, 1000)
    port_ops.gf256_matmul(A, B)
    port_ops.gf256_coding_matmul(A, B, device="cpu")
    port_ops.rs_encode_parity(A, B)
    assert port_ops.launches == before


def test_torch_ref_matches_numpy_lut_wide():
    rng = np.random.default_rng(5)
    A = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    B = rng.integers(0, 256, (6, 100_003), dtype=np.uint8)
    np.testing.assert_array_equal(torch_ref(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
                                  gf_matmul_np(A, B))


def test_rs_encode_parity_wrapper():
    rng = np.random.default_rng(9)
    code = PortRSCode(n=12, k=8, device="cpu")
    data = rng.integers(0, 256, (8, 1024), dtype=np.uint8)
    par = port_ops.rs_encode_parity(code.parity_matrix, data).numpy()
    np.testing.assert_array_equal(par, code.encode(data)[8:])


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, B = _operands(2, 4, 128)
    with pytest.raises(RuntimeError):
        port_ops.gf256_coding_matmul(A, B, device="cuda")
