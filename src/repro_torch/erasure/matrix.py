"""Generator matrices and Gaussian elimination over GF(256).

Systematic [n, k] codes: codeword = [data (k rows) ; parity (m = n-k rows)],
parity = P @ data with P an MDS parity matrix. We default to **Cauchy**
parity matrices (every square submatrix of a Cauchy matrix is invertible, so
the stacked generator [I; P] is MDS — jerasure's construction). A classical
Vandermonde construction is provided for cross-checking.
"""
from __future__ import annotations

import numpy as np

from repro_torch.erasure.gf import gf_inv, gf_matmul_np, gf_mul, gf_mul_np


def cauchy_parity_matrix(n: int, k: int) -> np.ndarray:
    """(n-k, k) Cauchy matrix C[i, j] = 1 / (x_i ^ y_j), x_i = i, y_j = m + j.

    x's and y's are distinct elements of GF(256), so all entries are defined
    and every square submatrix of [I; C] built from <= k rows is invertible.
    Requires n <= 256.
    """
    m = n - k
    if n > 256:
        raise ValueError("GF(256) Cauchy construction requires n <= 256")
    C = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            C[i, j] = gf_inv(i ^ (m + j))
    return C


def vandermonde_matrix(n: int, k: int) -> np.ndarray:
    """Systematic (n-k, k) parity rows derived from a Vandermonde matrix.

    Build V (n, k) with V[i, j] = alpha_i^j (alpha_i = i), then right-multiply
    by inv(V[:k]) so the top square becomes identity; the bottom m rows are
    the parity matrix. MDS because column ops preserve submatrix rank.
    """
    if n > 256:
        raise ValueError("n <= 256 required")
    V = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        acc = 1
        for j in range(k):
            V[i, j] = acc
            acc = gf_mul(acc, i)
    top_inv = gf_invert_matrix(V[:k])
    Vs = gf_matmul_np(V, top_inv)
    if not np.array_equal(Vs[:k], np.eye(k, dtype=np.uint8)):
        raise RuntimeError("Vandermonde systematization failed")
    return Vs[k:]


def gf_invert_matrix(A: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan elimination (uint8)."""
    A = np.asarray(A, dtype=np.uint8).copy()
    k = A.shape[0]
    if A.shape != (k, k):
        raise ValueError(f"square matrix required, got shape {A.shape}")
    aug = np.concatenate([A, np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        # pivot
        piv = None
        for r in range(col, k):
            if aug[r, col] != 0:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular matrix over GF(256)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        # normalize pivot row
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul_np(aug[col], np.uint8(inv_p))
        # eliminate
        for r in range(k):
            if r != col and aug[r, col] != 0:
                factor = aug[r, col]
                aug[r] = aug[r] ^ gf_mul_np(np.uint8(factor), aug[col])
    return aug[:, k:].copy()


def gf_solve_decode_matrix(generator_rows: np.ndarray) -> np.ndarray:
    """Given the k generator rows of the surviving fragments (each row is the
    GF(256) linear combination producing that fragment from the k data rows),
    return the (k, k) matrix mapping surviving fragments back to data."""
    return gf_invert_matrix(generator_rows)
