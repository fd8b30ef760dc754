"""Erasure-coding substrate: GF(2^8) arithmetic and [n,k] Reed-Solomon codes.

The compute hot path (GF(256) matrix multiply) is served by the CUDA
kernel in ``repro_torch.kernels.gf256_matmul``; this package
provides the field/matrix algebra and the systematic-code plumbing around it.
"""
from repro_torch.erasure.gf import (
    EXP_TABLE,
    LOG_TABLE,
    gf_add,
    gf_const_to_bitmatrix,
    gf_inv,
    gf_matmul_np,
    gf_matrix_to_bitmatrix,
    gf_mul,
    gf_mul_np,
)
from repro_torch.erasure.matrix import cauchy_parity_matrix, gf_invert_matrix, vandermonde_matrix
from repro_torch.erasure.rs import RSCode, bytes_to_rows, rows_to_bytes

__all__ = [
    "EXP_TABLE",
    "LOG_TABLE",
    "gf_add",
    "gf_mul",
    "gf_inv",
    "gf_mul_np",
    "gf_matmul_np",
    "gf_const_to_bitmatrix",
    "gf_matrix_to_bitmatrix",
    "cauchy_parity_matrix",
    "vandermonde_matrix",
    "gf_invert_matrix",
    "RSCode",
    "bytes_to_rows",
    "rows_to_bytes",
]
