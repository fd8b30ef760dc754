"""GF(2^8) arithmetic.

Field: GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1)  (0x11D, the AES-adjacent
polynomial used by most RS implementations, e.g. ISA-L, jerasure).

Two execution models are provided:

* **byte/LUT model** (`gf_mul_np`, `gf_matmul_np`): classical log/antilog
  tables — the reference semantics, used host-side for small matrices
  (generator construction, k x k inversions).
* **bitsliced GF(2) model** (`gf_const_to_bitmatrix`, `gf_matrix_to_bitmatrix`):
  every multiply-by-constant is an 8x8 bit matrix, so a GF(256) matmul becomes
  a 0/1 matmul mod 2 — the TPU-native formulation consumed by the Pallas
  kernel (see DESIGN.md §3, Adaptation 1).
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    # exp[510], exp[511] unused (log sums max at 254+254=508)
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_add(a: int, b: int) -> int:
    """Addition == subtraction == XOR in characteristic 2."""
    return a ^ b


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[int(LOG_TABLE[a]) + int(LOG_TABLE[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(256)")
    return int(EXP_TABLE[255 - int(LOG_TABLE[a])])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) - int(LOG_TABLE[b])) % 255])


def gf_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) product of uint8 arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    nz = (a != 0) & (b != 0)
    la = LOG_TABLE[a]
    lb = LOG_TABLE[b]
    prod = EXP_TABLE[la + lb]
    return np.where(nz, prod, np.uint8(0)).astype(np.uint8)


def gf_matmul_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(256) matrix product: C[i,j] = XOR_k A[i,k]*B[k,j] (uint8).

    Host-side reference (numpy). The hot-path equivalent lives in
    ``repro_torch.kernels.gf256_matmul``.
    """
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(
            f"gf_matmul_np needs (m,k)@(k,n) matrices, got {A.shape}@{B.shape}"
        )
    # (m, k, j) products, XOR-folded over k.
    terms = gf_mul_np(A[:, :, None], B[None, :, :])
    return np.bitwise_xor.reduce(terms, axis=1)


def gf_poly_eval(coeffs: list[int], x: int) -> int:
    """Horner evaluation of a polynomial over GF(256)."""
    acc = 0
    for c in coeffs:
        acc = gf_mul(acc, x) ^ c
    return acc


# ---------------------------------------------------------------------------
# Bitsliced (GF(2)) representation
# ---------------------------------------------------------------------------

def gf_const_to_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M s.t. bits(c*d) = M @ bits(d) (mod 2) for all d.

    Column j is the bit decomposition of c * x^j (multiplication by a field
    constant is linear over GF(2)).
    """
    M = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        p = gf_mul(c, 1 << j)
        for i in range(8):
            M[i, j] = (p >> i) & 1
    return M


def gf_matrix_to_bitmatrix(A: np.ndarray) -> np.ndarray:
    """Expand a (m, k) GF(256) matrix to its (8m, 8k) GF(2) bit matrix.

    Block (r, c) of the result is ``gf_const_to_bitmatrix(A[r, c])``; with
    data bytes unpacked little-endian along the k axis this turns the GF(256)
    matmul into an ordinary 0/1 matmul mod 2 (MXU-friendly).
    """
    A = np.asarray(A, dtype=np.uint8)
    m, k = A.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for r in range(m):
        for c in range(k):
            out[8 * r : 8 * r + 8, 8 * c : 8 * c + 8] = gf_const_to_bitmatrix(int(A[r, c]))
    return out


def bytes_to_bits_np(D: np.ndarray) -> np.ndarray:
    """(k, L) uint8 -> (8k, L) 0/1, row 8r+j = bit j of row r (little-endian)."""
    D = np.asarray(D, dtype=np.uint8)
    k, L = D.shape
    shifts = np.arange(8, dtype=np.uint8)
    bits = (D[:, None, :] >> shifts[None, :, None]) & 1  # (k, 8, L)
    return bits.reshape(8 * k, L)


def bits_to_bytes_np(Pbits: np.ndarray) -> np.ndarray:
    """(8m, L) 0/1 -> (m, L) uint8 (little-endian pack)."""
    Pbits = np.asarray(Pbits, dtype=np.uint8)
    m8, L = Pbits.shape
    if m8 % 8 != 0:
        raise ValueError(f"bit-plane row count {m8} is not a multiple of 8")
    b = Pbits.reshape(m8 // 8, 8, L)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    return (b.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)
