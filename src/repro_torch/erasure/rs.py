"""Systematic [n, k] Reed-Solomon (Cauchy) codes over GF(256).

``RSCode`` is the object-level API used by the EC DAPs (``repro_torch.core.dap.ec*``)
and the repair subsystem (``repro_torch.core.repair``):

* ``encode(data)``      — (k, L) uint8 -> (n, L) coded fragments (systematic:
                          fragments [0, k) are the data rows themselves).
* ``decode(frs, idxs)`` — any k fragments (+ their indices) -> (k, L) data.

Coding backends
---------------
``backend`` selects where the GF(256) matmul runs, and ``device`` where the
kernel path puts its tensors:

* ``"numpy"``  — the byte-LUT reference (``erasure.gf.gf_matmul_np``).
* ``"kernel"`` — the data-plane path (``repro_torch.kernels.gf256_matmul.ops.
  gf256_coding_matmul``): the hand-written CUDA kernel on ``device="cuda"``,
  its plain PyTorch version on ``device="cpu"``.
* ``"auto"``   — size-based dispatch: operands at or above
  ``AUTO_KERNEL_MIN_BYTES`` take the kernel path; tiny single-block
  products stay on the LUT path, whose fixed overhead is lower.

All backends, on either device, are bit-identical.

Batched byte paths
------------------
``encode_bytes_batch`` / ``decode_bytes_batch`` fuse many ragged byte values
into as few matmuls as possible: values are laid side by side column-wise
(GF(256) matmul acts per column, so no per-value padding is needed), decode
groups sharing a surviving-fragment index set share one cached inverted
generator (``_decoder_cached``), and each group is one launch (the
block-diagonal fusion of several groups is off in the port; see
``_decode_flats``). Fragments carry an optional CRC-32
computed/verified in the same traversal that materialises the bytes
(``with_crc=True`` / a per-item crc dict), so integrity checking never costs
a second pass over the data.
"""
from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.erasure.gf import gf_matmul_np
from repro_torch.erasure.matrix import cauchy_parity_matrix, gf_invert_matrix

BACKENDS = ("numpy", "kernel", "auto")

# "auto" crossover: operand (B) bytes at which the kernel backend takes over
# from the numpy LUT path. Known divergence: this is the reference's value,
# measured for its jit'd XLA path on a CPU; the crossover of the CUDA kernel
# (host-to-device copy and launch against the LUT) is not yet measured on
# the card. The choice never changes the bytes.
AUTO_KERNEL_MIN_BYTES = 1 << 16

# Block-diagonal group fusion bound: G groups of a k-row code fuse into one
# (G*k, G*k) launch only while that matrix stays small.
_FUSE_MAX_ROWS = 128


def element_crc_ok(elem) -> bool:
    """Integrity check for a stored/shipped coded element.

    Elements are ``(fragment_bytes, orig_len)`` or, since ISSUE 6,
    ``(fragment_bytes, orig_len, crc32)``. Returns False only when a carried
    checksum does not match the fragment bytes — legacy 2-tuples (and the
    server's ``("", 0)`` sentinel) always pass.
    """
    if not isinstance(elem, tuple) or len(elem) < 3 or elem[2] is None:
        return True
    return zlib.crc32(elem[0]) == elem[2]


def bytes_to_rows(data: bytes, k: int) -> tuple[np.ndarray, int]:
    """Pad ``data`` to a multiple of k and reshape to (k, L). Returns the
    original length so ``rows_to_bytes`` can strip the padding."""
    orig = len(data)
    L = (orig + k - 1) // k if orig else 1
    buf = np.zeros(k * L, dtype=np.uint8)
    buf[:orig] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(k, L), orig


def rows_to_bytes(rows: np.ndarray, orig_len: int) -> bytes:
    return rows.reshape(-1).tobytes()[:orig_len]


@functools.lru_cache(maxsize=128)
def _parity_cached(n: int, k: int) -> np.ndarray:
    P = cauchy_parity_matrix(n, k)
    P.setflags(write=False)
    return P


@functools.lru_cache(maxsize=4096)
def _decoder_cached(n: int, k: int, idxs: tuple[int, ...]) -> np.ndarray:
    """Inverted generator for fragment index-set ``idxs`` of the [n, k] code.

    Cached per index-set the way ``ops._abits_cached`` caches bit-matrices:
    batched reads keep hitting the same few surviving-quorum subsets, so the
    k x k Gauss-Jordan runs once per subset, not once per decode."""
    P = _parity_cached(n, k)
    gen = np.zeros((k, k), dtype=np.uint8)
    for r, idx in enumerate(idxs):
        if idx < k:
            gen[r, idx] = 1
        else:
            gen[r] = P[idx - k]
    D = gf_invert_matrix(gen)
    D.setflags(write=False)
    return D


@dataclass
class RSCode:
    """Systematic Cauchy-RS erasure code over GF(256)."""

    n: int
    k: int
    backend: str = "numpy"  # "numpy" | "kernel" | "auto"
    # Block-diagonal fusion of multi-group decode_bytes_batch calls into one
    # kernel launch: None = only where ``kernel_is_native()`` says so, which
    # in the port is never (a launch per group; the bytes are the same).
    # Tests force True/False.
    fuse_groups: bool | None = None
    # where the kernel backend runs: "cuda" (the CUDA kernel) or "cpu" (its
    # plain PyTorch version). Operands and results stay host numpy.
    device: str = "cuda"
    _parity: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if not (0 < self.k <= self.n <= 256):
            raise ValueError(f"need 0 < k <= n <= 256, got n={self.n} k={self.k}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown coding backend {self.backend!r}; expected one of {BACKENDS}"
            )
        self._parity = _parity_cached(self.n, self.k)
        resolve_device(self.device)

    # -- properties ---------------------------------------------------------
    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def parity_matrix(self) -> np.ndarray:
        return self._parity

    def generator_row(self, idx: int) -> np.ndarray:
        """Row of the full systematic generator [I; P] for fragment ``idx``."""
        if idx < self.k:
            row = np.zeros(self.k, dtype=np.uint8)
            row[idx] = 1
            return row
        return self._parity[idx - self.k].copy()

    # -- core ops ------------------------------------------------------------
    def _use_kernel(self, A: np.ndarray, B: np.ndarray) -> bool:
        if self.backend == "numpy" or A.size == 0 or B.size == 0:
            return False
        if self.backend == "kernel":
            return B.shape[1] >= 8
        return B.size >= AUTO_KERNEL_MIN_BYTES  # "auto"

    def _matmul(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        if self._use_kernel(np.asarray(A), np.asarray(B)):
            from repro_torch.kernels.gf256_matmul import ops as gf_ops

            return gf_ops.gf256_coding_matmul(A, B, device=self.device)
        return gf_matmul_np(A, B)

    @staticmethod
    def _systematic_rows(indices, nrows: int, k: int) -> list[int] | None:
        """Row positions holding fragments 0..k-1 (in that order), or None
        when the supplied indices don't cover the full systematic set."""
        pos: dict[int, int] = {}
        for p, idx in enumerate(list(indices)[:nrows]):
            pos.setdefault(int(idx), p)
        if all(i in pos for i in range(k)):
            return [pos[i] for i in range(k)]
        return None

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, L) uint8 -> (n, L) uint8 coded fragments (systematic)."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {data.shape}")
        if self.m == 0:
            return data.copy()
        parity = self._matmul(self._parity, data)
        return np.concatenate([data, parity], axis=0)

    def decode(self, fragments: np.ndarray, indices: list[int]) -> np.ndarray:
        """Reconstruct (k, L) data from any k fragments.

        ``fragments``: (k, L) uint8 rows; ``indices``: their fragment ids in
        [0, n). Raises if fewer than k distinct fragments are supplied. When
        the supplied rows cover all k systematic fragments — in any order,
        at any position — they are returned directly (no inversion, no
        matmul); otherwise the first k rows decode through the cached
        inverted generator.
        """
        fragments = np.asarray(fragments, dtype=np.uint8)
        if len(indices) != len(set(indices)):
            raise ValueError("duplicate fragment indices")
        if fragments.shape[0] < self.k or len(indices) < self.k:
            raise ValueError(
                f"need {self.k} fragments to decode, got {fragments.shape[0]}"
            )
        rows = self._systematic_rows(indices, fragments.shape[0], self.k)
        if rows is not None:
            return np.ascontiguousarray(fragments[rows])
        idxs = [int(i) for i in list(indices)[: self.k]]
        frs = fragments[: self.k]
        dec = _decoder_cached(self.n, self.k, tuple(idxs))
        return np.asarray(self._matmul(dec, frs))

    def reconstruct_fragment(
        self, target_idx: int, fragments: np.ndarray, indices: list[int]
    ) -> np.ndarray:
        """Rebuild a single lost fragment (server repair path)."""
        data = self.decode(fragments, indices)
        if target_idx < self.k:
            return data[target_idx]
        return self._matmul(self._parity[target_idx - self.k : target_idx - self.k + 1], data)[0]

    def reconstruct_fragments(
        self, target_idxs: list[int], fragments: np.ndarray, indices: list[int]
    ) -> np.ndarray:
        """Rebuild several lost fragments with one decode + one fused matmul.

        Returns (len(target_idxs), L) rows in target order. Used by the
        repair controller, which typically replaces every fragment a set of
        recovered servers lost at once."""
        data = self.decode(fragments, indices)
        if not target_idxs:
            return np.zeros((0, data.shape[1]), dtype=np.uint8)
        gen = np.stack([self.generator_row(i) for i in target_idxs], axis=0)
        return np.asarray(self._matmul(gen, data))

    # -- batched coding (single fused GF(256) matmul over many blocks) -------
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, L) uint8 -> (B, n, L) coded blocks via ONE matmul.

        GF(256) matmul acts column-wise, so the B blocks are laid side by
        side as one (k, B*L) operand; the product splits back into per-block
        parity bit-identically to B separate ``encode`` calls. On the kernel
        backend this is one launch instead of B."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (B, {self.k}, L) blocks, got {data.shape}")
        B, _, L = data.shape
        if B == 0:
            return np.zeros((0, self.n, L), dtype=np.uint8)
        if self.m == 0:
            return data.copy()
        flat = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(self.k, B * L)
        parity = np.asarray(self._matmul(self._parity, flat))
        parity = parity.reshape(self.m, B, L).transpose(1, 0, 2)
        return np.concatenate([data, parity], axis=1)

    def decode_batch(self, fragments: np.ndarray, indices: list[int]) -> np.ndarray:
        """(B, k, L) fragment blocks sharing ONE index set -> (B, k, L) data.

        The common case for batched reads: every block lost the same servers,
        so one inverted generator serves the whole batch in a single matmul."""
        fragments = np.asarray(fragments, dtype=np.uint8)
        if fragments.ndim != 3:
            raise ValueError(f"expected (B, k, L) fragment blocks, got {fragments.shape}")
        if len(indices) != len(set(indices)):
            raise ValueError("duplicate fragment indices")
        if fragments.shape[1] < self.k or len(indices) < self.k:
            raise ValueError(
                f"need {self.k} fragments per block to decode, got {fragments.shape[1]}"
            )
        B, R, L = fragments.shape
        if B == 0:
            return fragments[:, : self.k, :].copy()
        rows = self._systematic_rows(indices, R, self.k)
        if rows is not None:
            return np.ascontiguousarray(fragments[:, rows, :])
        idxs = [int(i) for i in list(indices)[: self.k]]
        frs = fragments[:, : self.k, :]
        dec = _decoder_cached(self.n, self.k, tuple(idxs))
        flat = np.ascontiguousarray(frs.transpose(1, 0, 2)).reshape(self.k, B * L)
        out = np.asarray(self._matmul(dec, flat))
        return np.ascontiguousarray(out.reshape(self.k, B, L).transpose(1, 0, 2))

    # -- bytes-level convenience (object values in the DAPs) -----------------
    def encode_bytes(self, value: bytes, *, with_crc: bool = False):
        """``([fragment bytes] * n, orig_len)``; with ``with_crc`` also a
        parallel list of per-fragment CRC-32s (one-element batch)."""
        return self.encode_bytes_batch([value], with_crc=with_crc)[0]

    def encode_bytes_batch(self, values: list[bytes], *, with_crc: bool = False):
        """Batch ``encode_bytes`` over many byte strings with ONE fused matmul.

        The values' (k, L_b) row blocks are laid side by side column-wise —
        the GF matmul acts per column, so ragged lengths fuse with NO
        padding and the result is bit-identical to per-value encoding.
        Returns ``[(fragments, orig_len)]`` aligned with ``values``, or
        ``[(fragments, orig_len, crcs)]`` with ``with_crc=True`` — the CRC-32
        of each fragment, computed in the same pass that materialises its
        bytes (the integrity tags the EC DAP ships inside coded elements)."""
        if not values:
            return []
        rows: list[np.ndarray] = []
        origs: list[int] = []
        for v in values:
            r, o = bytes_to_rows(v, self.k)
            rows.append(r)
            origs.append(o)
        if self.m:
            flat = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=1)
            parity = np.asarray(self._matmul(self._parity, flat))
        out = []
        off = 0
        for b, r in enumerate(rows):
            lb = r.shape[1]
            frags = [r[i].tobytes() for i in range(self.k)]
            if self.m:
                frags += [parity[j, off : off + lb].tobytes() for j in range(self.m)]
                off += lb
            if with_crc:
                out.append((frags, origs[b], [zlib.crc32(f) for f in frags]))
            else:
                out.append((frags, origs[b]))
        return out

    def _choose_idxs(self, fragments: dict) -> tuple[int, ...]:
        """The k-subset of fragment indices to decode from: the all-systematic
        subset whenever every data fragment is present (the no-matmul fast
        path), the lowest k indices otherwise."""
        if len(fragments) < self.k:
            raise ValueError(f"need {self.k} fragments, have {len(fragments)}")
        if all(i in fragments for i in range(self.k)):
            return tuple(range(self.k))
        return tuple(int(i) for i in sorted(fragments)[: self.k])

    def _decode_flats(
        self, jobs: list[tuple[np.ndarray, np.ndarray]]
    ) -> list[np.ndarray]:
        """Run each (decoder, (k, W) operand) job. Known divergence from the
        reference: ``kernel_is_native()`` is False in the port, so unless a
        caller forces ``fuse_groups`` each job is one kernel launch instead
        of one block-diagonal launch for all of them (a grouped launch over
        decode groups is still to be written). The bytes are identical."""
        fuse = self.fuse_groups
        if fuse is None and self.backend != "numpy" and len(jobs) > 1:
            from repro_torch.kernels.gf256_matmul import ops as gf_ops

            fuse = gf_ops.kernel_is_native()
        if (
            not fuse
            or len(jobs) <= 1
            or self.backend == "numpy"
            or len(jobs) * self.k > _FUSE_MAX_ROWS
        ):
            return [np.asarray(self._matmul(dec, flat)) for dec, flat in jobs]
        k, G = self.k, len(jobs)
        wmax = max(flat.shape[1] for _, flat in jobs)
        A = np.zeros((G * k, G * k), dtype=np.uint8)
        B = np.zeros((G * k, wmax), dtype=np.uint8)
        for g, (dec, flat) in enumerate(jobs):
            A[g * k : (g + 1) * k, g * k : (g + 1) * k] = dec
            B[g * k : (g + 1) * k, : flat.shape[1]] = flat
        out = np.asarray(self._matmul(A, B))
        return [
            np.ascontiguousarray(out[g * k : (g + 1) * k, : flat.shape[1]])
            for g, (_, flat) in enumerate(jobs)
        ]

    def decode_bytes_batch(self, items: list[tuple]) -> list[bytes]:
        """Decode many byte values with as few GF(256) matmuls as possible.

        Each item is ``(fragments, orig_len)`` or ``(fragments, orig_len,
        crcs)`` — ``fragments`` maps fragment index -> fragment bytes (any
        number >= k; the decode subset is chosen here, preferring the
        all-systematic one), ``crcs`` optionally maps index -> CRC-32 to
        verify while the rows are gathered. Items whose chosen index subset
        coincides (the common case for a batched read: every block heard
        from the same quorum) share one cached inverted generator and fuse
        column-wise into ONE matmul regardless of ragged lengths; distinct
        subsets additionally fuse block-diagonally into a single launch on
        the native kernel. Raises ``ValueError`` when an item's chosen
        fragments disagree in length (a short/truncated fragment would
        otherwise silently decode to garbage) or fail their checksum.
        Returns the decoded bytes aligned with ``items``."""
        out: list[bytes | None] = [None] * len(items)
        sys_idxs = tuple(range(self.k))
        groups: dict[tuple[int, ...], list[tuple[int, dict, int, int]]] = {}
        for pos, item in enumerate(items):
            fragments, orig = item[0], item[1]
            crcs = item[2] if len(item) > 2 else None
            idxs = self._choose_idxs(fragments)
            L = len(fragments[idxs[0]])
            for i in idxs:
                if len(fragments[i]) != L:
                    raise ValueError(
                        f"fragment length mismatch in item {pos}: index {i} "
                        f"has {len(fragments[i])} bytes, index {idxs[0]} has {L}"
                    )
                if (
                    crcs is not None
                    and crcs.get(i) is not None
                    and zlib.crc32(fragments[i]) != crcs[i]
                ):
                    raise ValueError(
                        f"fragment {i} of item {pos} failed its checksum"
                    )
            if self.k * L < orig:
                raise ValueError(
                    f"item {pos}: {self.k} fragments of {L} bytes cannot hold "
                    f"a {orig}-byte value"
                )
            if idxs == sys_idxs:
                # systematic fast path: the data rows ARE the fragments
                out[pos] = b"".join(bytes(fragments[i]) for i in idxs)[:orig]
            else:
                groups.setdefault(idxs, []).append((pos, fragments, L, orig))
        jobs: list[tuple[np.ndarray, np.ndarray]] = []
        metas: list[list[tuple[int, int, int, int]]] = []
        for idxs, members in groups.items():
            W = sum(L for _, _, L, _ in members)
            flat = np.zeros((self.k, W), dtype=np.uint8)
            meta: list[tuple[int, int, int, int]] = []
            off = 0
            for pos, fragments, L, orig in members:
                for r, i in enumerate(idxs):
                    flat[r, off : off + L] = np.frombuffer(
                        fragments[i], dtype=np.uint8
                    )
                meta.append((pos, off, L, orig))
                off += L
            jobs.append((_decoder_cached(self.n, self.k, idxs), flat))
            metas.append(meta)
        for data, meta in zip(self._decode_flats(jobs), metas):
            for pos, off, L, orig in meta:
                rows = np.ascontiguousarray(data[:, off : off + L])
                out[pos] = rows_to_bytes(rows, orig)
        return out  # type: ignore[return-value]

    def decode_bytes(
        self, fragments: dict[int, bytes], orig_len: int, crcs: dict | None = None
    ) -> bytes:
        item = (fragments, orig_len) if crcs is None else (fragments, orig_len, crcs)
        return self.decode_bytes_batch([item])[0]
