"""The storage kernels' arithmetic, emulated step by step on the CPU.

``csrc/gf256_matmul.cu`` and ``csrc/cdc_gearhash.cu`` run only on the card,
so this file replays what their lanes do, in numpy, over whole warps at
once: the same words, shuffles, selects and shifts, the same branches on
the coefficients and the same carries. Each emulation must be byte-identical
(tolerance 0: integer arithmetic) to the JAX package's oracles,
``repro.erasure.gf.gf_matmul_np`` and
``repro.kernels.cdc_gearhash.ref.gearhash_ref``.

The GF(256) emulation reads its input from a byte buffer that holds B at
some address and garbage around it, as the kernel's aligned 16-byte words
do, and writes into a buffer of garbage: every byte of C must be written
once per launch (one launch per tile of 8 x 8 coefficients) and nothing
else touched. The kernels' tiling constants are read from the sources, so
the emulation follows them.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.erasure.gf import gf_matmul_np, gf_mul_np
from repro.erasure.rs import _decoder_cached, _parity_cached
from repro.kernels.cdc_gearhash.ref import gearhash_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
M32 = 0xFFFFFFFF
LANES = 32
UNIT = 0x01010101


def _const(name: str, source: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


GF_TILE = _const("kTile", "gf256_matmul.cu")
GF_STRIP = _const("kStrip", "gf256_matmul.cu")
GF_STRIPS_PER_WARP = LANES - 1
GEAR_PER_LANE = _const("kPerLane", "cdc_gearhash.cu")
GEAR_STEPS = _const("kSteps", "cdc_gearhash.cu")
GEAR_STEP = LANES * GEAR_PER_LANE
GEAR_SPAN = GEAR_STEP * GEAR_STEPS
GEAR_ROW_WORDS = GEAR_PER_LANE + 4


def test_emulated_constants_are_the_kernels():
    gf = (CSRC / "gf256_matmul.cu").read_text()
    assert "kStripsPerWarp = kLanes - 1;" in gf and GF_STRIP == 16
    gear = (CSRC / "cdc_gearhash.cu").read_text()
    assert "kStep = kLanes * kPerLane;" in gear and "kRowWords = kPerLane + 4;" in gear
    assert (GF_TILE, GEAR_PER_LANE, GEAR_SPAN) == (8, 16, 8192)


# ------------------------------------------------------------ shared steps
def _shfl_down(v: np.ndarray) -> np.ndarray:
    """__shfl_down_sync(.., 1) over (warps, 32, ...): lane 31 keeps its own."""
    out = v.copy()
    out[:, :-1] = v[:, 1:]
    return out


def _shfl_up(v: np.ndarray, lane0: np.ndarray) -> np.ndarray:
    """__shfl_up_sync(.., 1) over (warps, 32), with lane 0 replaced."""
    out = np.empty_like(v)
    out[:, 1:] = v[:, :-1]
    out[:, 0] = lane0
    return out


def _window16(lo: np.ndarray, hi: np.ndarray, s: int) -> np.ndarray:
    """``window16``: bytes [s, s + 16) of lo ++ hi (4 words each, last axis),
    by the kernel's two word selects and four funnel shifts."""
    w = [lo[..., i].astype(np.uint64) for i in range(4)] + [hi[..., i].astype(np.uint64)
                                                           for i in range(4)]
    if s & 4:
        w[0:7] = w[1:8]
    if s & 8:
        w[0:5] = w[2:7]
    sh = np.uint64(8 * (s & 3))
    return np.stack([(((w[i + 1] << np.uint64(32)) | w[i]) >> sh) & np.uint64(M32)
                     for i in range(4)], axis=-1).astype(np.uint32)


def _words(b: np.ndarray) -> np.ndarray:
    """(..., 16) bytes -> (..., 4) little-endian uint32 words."""
    return np.ascontiguousarray(b, dtype=np.uint8).view("<u4")


def _bytes(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w, dtype="<u4").view(np.uint8)


def test_window16_is_a_byte_slice():
    rng = np.random.default_rng(0)
    lo, hi = (rng.integers(0, 1 << 32, (5, 4), dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    both = np.concatenate([_bytes(lo), _bytes(hi)], axis=-1)
    for s in range(16):
        np.testing.assert_array_equal(_bytes(_window16(lo, hi, s)), both[:, s:s + 16])


# ------------------------------------------------------------ gf256_matmul
def _sign_bytes(y: np.ndarray) -> np.ndarray:
    """prmt.b32 with selector 0xBA98: each byte becomes 0xFF if its bit 7 is set."""
    b = _bytes(y)
    return _words(np.where(b & 0x80, 0xFF, 0).astype(np.uint8))


def _plane(x: np.ndarray, b: int) -> np.ndarray:
    return _sign_bytes(((x.astype(np.uint64) << np.uint64(7 - b)) & np.uint64(M32))
                       .astype(np.uint32))


def _splats(a: int) -> list[int]:
    """splat(a * 2^b) for b = 0..7, by the kernel's xtime recurrence."""
    out = []
    for _ in range(8):
        out.append(a * UNIT)
        a = ((a << 1) ^ (0x1D if a & 0x80 else 0)) & 0xFF
    return out


def test_planes_rebuild_every_product():
    """XOR_b plane_b(x) & splat(a * 2^b) == a * x for all 256 x 256 pairs."""
    x = np.arange(256, dtype=np.uint8).reshape(64, 4)
    xw = _words(x)
    planes = [_plane(xw, b) for b in range(8)]
    for a in range(256):
        acc = np.zeros_like(xw)
        for b, c in enumerate(_splats(a)):
            acc ^= planes[b] & np.uint32(c)
        np.testing.assert_array_equal(_bytes(acc).reshape(-1),
                                      gf_mul_np(np.uint8(a), np.arange(256, dtype=np.uint8)))


class _Mem:
    """A byte buffer whose index is the address: a matrix at ``base``,
    random garbage around it (so a stray read shows in the result), and a
    count of the bytes written."""

    def __init__(self, rng, size: int):
        self.buf = rng.integers(0, 256, size + 64, dtype=np.uint8)
        self.writes = np.zeros(size + 64, dtype=np.int64)

    def load_word(self, row: int, L: int, at: np.ndarray) -> np.ndarray:
        """``load_word``: the aligned 16 bytes at ``at`` where they hold a
        byte of row[0, L), zero words elsewhere."""
        assert np.all(at % 16 == 0)
        valid = (at < row + L) & (at + 16 > row)
        safe = np.where(valid, at, 0)
        got = _words(self.buf[safe[..., None] + np.arange(16)])
        return np.where(valid[..., None], got, 0).astype(np.uint32)

    def store(self, addr: np.ndarray, vals: np.ndarray) -> None:
        np.add.at(self.writes, addr, 1)
        self.buf[addr] = vals


def _emulate_gf256(A: np.ndarray, B: np.ndarray, b_off: int = 0, c_off: int = 0,
                   seed: int = 0) -> np.ndarray:
    """``gf256_matmul_kernel`` over its whole grid: B at address 32 + b_off,
    C at 32 + c_off, one launch per tile of 8 x 8 coefficients; returns C as
    the launches leave it."""
    rng = np.random.default_rng(seed)
    m, k = A.shape
    L = B.shape[1]
    mem_b = _Mem(rng, 32 + b_off + k * L + 32)
    b_base = 32 + b_off
    mem_b.buf[b_base:b_base + k * L] = B.reshape(-1)
    mem_c = _Mem(rng, 32 + c_off + m * L + 32)
    c_base = 32 + c_off
    garbage = mem_c.buf.copy()

    strips = -(-L // GF_STRIP)
    warps = -(-strips // GF_STRIPS_PER_WARP)
    lane = np.arange(LANES)[None, :]
    c0 = (np.arange(warps)[:, None] * GF_STRIPS_PER_WARP + lane) * GF_STRIP   # (warps, 32)

    def stage_row(r: int) -> tuple[np.ndarray, int]:
        """``stage_row``: a warp's 33 shared-memory words of input row r (lane
        t's word under its strip; the 33rd, lane 31's word after, only where
        the row is not 16-byte aligned)."""
        row = b_base + r * L
        off = row % 16
        at = row + c0 - off
        words = np.zeros((warps, LANES + 1, 4), np.uint32)
        words[:, :LANES] = mem_b.load_word(row, L, at)
        if off:
            words[:, LANES] = mem_b.load_word(row, L, at[:, -1] + 16)
        return words, off

    def realign(staged: tuple[np.ndarray, int]) -> np.ndarray:
        words, off = staged
        return _window16(words[:, :LANES], words[:, 1:], off) if off else words[:, :LANES]

    for i0 in range(0, m, GF_TILE):          # one launch per tile of A
        for r0 in range(0, k, GF_TILE):
            rows, inputs = min(GF_TILE, m - i0), min(GF_TILE, k - r0)
            coef = [[_splats(int(A[i0 + i, r0 + r])) for r in range(inputs)] for i in range(rows)]
            planes_needed = [any(A[i0 + i, r0 + r] > 1 for i in range(rows))
                             for r in range(inputs)]
            staged = [stage_row(r0 + r) for r in range(inputs)]   # all in flight at once
            acc = [np.zeros((warps, LANES, 4), np.uint32) for _ in range(rows)]
            for r in range(inputs):
                x = realign(staged[r])
                if not planes_needed[r]:
                    for i in range(rows):
                        if coef[i][r][0] == UNIT:
                            acc[i] ^= x
                    continue
                planes = [_plane(x, b) for b in range(8)]
                for i in range(rows):
                    c = coef[i][r]
                    if c[0] == 0:
                        continue
                    if c[0] == UNIT:
                        acc[i] ^= x
                        continue
                    for b in range(8):
                        acc[i] ^= planes[b] & np.uint32(c[b])
            for i in range(rows):  # store_row, XOR into C for a later tile of inputs
                row = c_base + (i0 + i) * L
                h = (16 - row % 16) % 16
                v = acc[i]
                d = _window16(v, _shfl_down(v), h) if h else v
                s = c0[:, :-1] + h                                  # lane 31 stores nothing
                col = s[..., None] + np.arange(16)                  # (warps, 31, 16)
                ok = col < L
                whole = s + 16 <= L                                 # a 16-byte store each
                assert np.all((row + s[whole]) % 16 == 0)
                head = np.arange(min(h, L))                         # strip 0 owns the head
                for addr, vals in ((row + col[ok], _bytes(d[:, :-1])[ok]),
                                   (row + head, _bytes(v[0, 0])[head])):
                    mem_c.store(addr, mem_c.buf[addr] ^ vals if r0 else vals)

    c_region = slice(c_base, c_base + m * L)
    outside = np.ones(mem_c.buf.size, bool)
    outside[c_region] = False
    np.testing.assert_array_equal(mem_c.writes[c_region], -(-k // GF_TILE))  # once a tile
    np.testing.assert_array_equal(mem_c.writes[outside], 0)
    np.testing.assert_array_equal(mem_c.buf[outside], garbage[outside])
    return mem_c.buf[c_region].reshape(m, L)


ENC = _parity_cached(11, 6)                     # (5, 6): every encode of the path
DEC = _decoder_cached(11, 6, (1, 2, 3, 4, 5, 6))  # (6, 6): a decode with s0 down


def test_path_matrices_have_the_coefficients_the_kernel_branches_on():
    """The encode is all full coefficients but one 1; the decode is mostly
    0s and 1s (its unit rows copy the surviving data fragments)."""
    assert ENC.shape == (5, 6) and (ENC == 0).sum() == 0 and (ENC == 1).sum() == 1
    assert DEC.shape == (6, 6) and (DEC == 0).sum() >= 20 and (DEC == 1).sum() >= 4


@pytest.mark.parametrize("name", ["encode", "decode"])
@pytest.mark.parametrize("rem", range(16))
def test_gf256_emulation_every_row_offset(name, rem):
    """L = 2000 + rem: every L % 16 (and so every L % 4), so every row offset
    (r * L) mod 16 the funnel shifts and the output realignment take; 5 warps."""
    A = ENC if name == "encode" else DEC
    L = 2000 + rem
    B = np.random.default_rng(rem).integers(0, 256, (6, L), dtype=np.uint8)
    np.testing.assert_array_equal(_emulate_gf256(A, B, seed=rem), gf_matmul_np(A, B))


@pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 495, 496, 497, 991, 992, 993, 3967, 3968, 3969])
@pytest.mark.parametrize("b_off,c_off", [(0, 0), (5, 11)])
def test_gf256_emulation_seams_and_base_offsets(L, b_off, c_off):
    """Warp seams (31 strips = 496 columns) and block seams (8 warps = 3968)
    +-1, tiny rows, and matrices whose base is not 16-byte aligned."""
    rng = np.random.default_rng(L + b_off)
    B = rng.integers(0, 256, (6, L), dtype=np.uint8)
    for A in (ENC, DEC):
        got = _emulate_gf256(A, B, b_off=b_off, c_off=c_off, seed=L)
        np.testing.assert_array_equal(got, gf_matmul_np(A, B))


@pytest.mark.parametrize("m,k,L", [(6, 6, 1000), (10, 70, 333), (3, 130, 100)])
def test_gf256_emulation_mixed_coefficients(m, k, L):
    """0s and 1s beside full entries, more than one tile of 8 output rows
    and of 8 input rows (later tiles XOR into C), and input rows of units
    alone."""
    rng = np.random.default_rng(m * k)
    A = rng.integers(0, 256, (m, k), dtype=np.uint8)
    kind = rng.integers(0, 3, (m, k))
    A[kind == 0] = 0
    A[kind == 1] = 1
    A[:, 0] = 1      # a unit-only input row
    A[:, 1] = 0      # an input row that no output uses
    B = rng.integers(0, 256, (k, L), dtype=np.uint8)
    np.testing.assert_array_equal(_emulate_gf256(A, B, b_off=3, seed=m), gf_matmul_np(A, B))


# ------------------------------------------------------------ cdc_gearhash
def _gear_mix(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.uint64)
    v = ((v + 0x9E3779B9) * 0x85EBCA6B) & M32
    v ^= v >> np.uint64(15)
    v = (v * 0xC2B2AE35) & M32
    v ^= v >> np.uint64(13)
    return v


def _emulate_gearhash(data: np.ndarray, mask: int) -> tuple[np.ndarray, np.ndarray]:
    """``gearhash_kernel`` over its whole grid: one warp per span, 16
    positions per lane per step, the warm-up reduction and the two-shuffle
    carry."""
    L = data.size
    spans = -(-L // GEAR_SPAN)
    lane = np.arange(LANES, dtype=np.int64)[None, :]
    start = np.arange(spans, dtype=np.int64)[:, None] * GEAR_SPAN          # (spans, 1)
    hash_out = np.full(L, 0xDEADBEEF, dtype=np.uint64)
    flag_out = np.full(L, 7, dtype=np.uint8)

    # warm-up: lane t adds gear(x[start - 1 - t]) << t, one warp reduction
    before = start - 1 - lane
    xb = np.where(before >= 0, data[np.maximum(before, 0)], 0)
    carry = (((_gear_mix(xb) << lane.astype(np.uint64)) & M32).sum(axis=1) & M32)

    j = np.arange(GEAR_PER_LANE)
    for step in range(GEAR_STEPS):
        base = start + step * GEAR_STEP
        active = (base < L)[:, 0]                     # the loop's bound, per warp
        p = base + GEAR_PER_LANE * lane                 # (spans, 32)
        pos = p[..., None] + j                          # (spans, 32, 16)
        x = np.where(pos < L, data[np.minimum(pos, L - 1)], 0)   # load16
        g = _gear_mix(x)
        h = np.empty_like(g)
        run = np.zeros(g.shape[:2], np.uint64)
        for q in range(GEAR_PER_LANE):
            run = ((run << np.uint64(1)) + g[..., q]) & M32
            h[..., q] = run
        up = _shfl_up(h[..., -1], carry)
        last = (h[..., -1] + (up << np.uint64(16))) & M32
        prev = _shfl_up(last, carry)
        carry = np.where(active, last[:, -1], carry)
        h = (h + (prev[..., None] << (j + 1).astype(np.uint64))) & M32
        flags = ((h & np.uint64(mask)) == 0).astype(np.uint8)
        keep = active[:, None, None] & (pos < L)
        flag_out[pos[keep]] = flags[keep]
        # the hashes go through shared memory (a lane's row padded to 20
        # words): lane t then stores step positions 128 q + 4 t .. + 3
        staged = np.zeros((spans, LANES * GEAR_ROW_WORDS), np.uint64)
        for t in range(LANES):
            staged[:, t * GEAR_ROW_WORDS:t * GEAR_ROW_WORDS + GEAR_PER_LANE] = h[:, t]
        for q in range(4):
            i = 128 * q + 4 * lane                                   # (1, 32)
            src = (i >> 4) * GEAR_ROW_WORDS + (i & 15)
            vals = staged[:, src[0, :, None] + np.arange(4)]        # (spans, 32, 4)
            at = base[:, :, None] + i[..., None] + np.arange(4)
            ok = active[:, None, None] & (at < L)
            hash_out[at[ok]] = vals[ok]
    return hash_out.astype(np.uint32), flag_out


def _gear_case(L: int, seed: int, zeros_at: int | None = None) -> np.ndarray:
    data = np.random.default_rng(seed).integers(0, 256, L, dtype=np.uint8)
    if zeros_at is not None:
        data[max(0, zeros_at - 40):zeros_at + 40] = 0
    return data


def _check_gear(data: np.ndarray, mask: int) -> None:
    h, b = _emulate_gearhash(data, mask)
    hr, br = gearhash_ref(jnp.asarray(data), mask=mask)
    np.testing.assert_array_equal(h, np.asarray(hr))
    np.testing.assert_array_equal(b, np.asarray(br))


@pytest.mark.parametrize("rem", range(16))
def test_gearhash_emulation_every_length_mod_16(rem):
    """Two spans and a ragged third: every L % 16, so every partial last lane."""
    _check_gear(_gear_case(2 * GEAR_SPAN + 48 + rem, rem), 0xFF)


@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, GEAR_STEP - 1, GEAR_STEP, GEAR_STEP + 1,
                               GEAR_SPAN - 1, GEAR_SPAN, GEAR_SPAN + 1,
                               2 * GEAR_SPAN - 1, 2 * GEAR_SPAN, 2 * GEAR_SPAN + 1])
def test_gearhash_emulation_warp_and_span_seams(L):
    """Lengths at the step (512) and span (8192) seams +-1: the carry from
    lane 31 to lane 0 and the warm-up of a span that starts past 0."""
    _check_gear(_gear_case(L, L), 0xF)


@pytest.mark.parametrize("mask", [0, 0xFFFFFFFF, 0xFFFF])
def test_gearhash_emulation_masks_and_zero_runs(mask):
    """Masks 0 (every position a boundary) and 0xFFFFFFFF (hash == 0 only),
    with runs of zero bytes across position 0 and the first span seam, where
    the warm-up mixes gear(0) != 0."""
    data = _gear_case(3 * GEAR_SPAN + 5, 1, zeros_at=GEAR_SPAN)
    data[:20] = 0
    _check_gear(data, mask)


def test_gearhash_emulation_a_few_hundred_kib():
    _check_gear(_gear_case(300_000, 2), 0xFFF)


def test_gearhash_warm_up_is_the_hash_before_the_span():
    """The warp reduction of gear(x[s - 1 - t]) << t is the reference's hash
    at s - 1, for a span at 0 (zero bytes before it) and past 0."""
    data = _gear_case(3 * GEAR_SPAN, 3)
    hr = np.asarray(gearhash_ref(jnp.asarray(data), mask=0)[0]).astype(np.uint64)
    lane = np.arange(LANES)
    for s in (GEAR_SPAN, 2 * GEAR_SPAN):
        xb = data[s - 1 - lane]
        assert int((_gear_mix(xb) << lane.astype(np.uint64)).sum() & M32) == hr[s - 1]
    zero = _gear_mix(np.zeros(LANES, np.uint8)) << lane.astype(np.uint64)
    hz = np.asarray(gearhash_ref(jnp.zeros(64, jnp.uint8), mask=0)[0])
    assert int(zero.sum() & M32) == int(hz[-1])  # x[< 0] = 0 bytes: gear(0) != 0
