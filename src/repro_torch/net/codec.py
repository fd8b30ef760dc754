"""Wire codec: length-prefixed binary framing for server messages (ISSUE 3).

The simulator used to charge message latency by a per-Python-object heuristic
(``nbytes``: 16 bytes per tuple, 8 per int, ...), which over-charges small
control messages and ignores real framing costs — the ROADMAP's "wire-level
framing" open item. This module defines an actual wire format for the
protocol's message vocabulary and the ``Network`` now charges
``len(encode_frame(msg))`` for every message it can frame (anything else
falls back to the heuristic).

Format
------
A frame is ``uvarint(len(body)) || body``. A body is a one-byte type tag
followed by the payload:

    N                       None
    T / F                   True / False
    i  zigzag-uvarint       int (arbitrary precision, small ints 1 byte)
    d  8 bytes big-endian   float (IEEE-754 double)
    s  uvarint n, n bytes   str (UTF-8)
    b  uvarint n, n bytes   bytes / bytearray / memoryview
    t  uvarint n, n bodies  tuple
    l  uvarint n, n bodies  list
    m  uvarint n, n k/v     dict (insertion order preserved)
    C  5 bodies             Config (cfg_id, servers, dap, k, delta)
    a  dtype,shape,raw      numpy ndarray (C-contiguous copy)

Everything the storage servers send or receive — tags ``(ts, wid)``, coded
elements ``(bytes, orig_len)`` and their checksummed ``(bytes, orig_len,
crc32)`` form (ISSUE 6; the CRC is a plain uvarint int, so integrity tags
cost <= 6 wire bytes per fragment), ``Config`` objects inside ``read-next``
replies, the ``*_batch`` envelopes — round-trips exactly (``decode_frame(encode_frame
(m)) == m``; property-tested in ``tests/test_codec.py``). ``wire_size``
computes the framed size *without* materialising the frame, so per-message
accounting stays O(structure) with no big-payload copies.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np


class CodecError(ValueError):
    """Object is outside the wire vocabulary (caller should fall back)."""


# --------------------------------------------------------- message registry
# The protocol's message vocabulary, declared next to the wire format it
# rides on. ``repro.analysis``'s registry-drift lint parses these literals
# and cross-checks them against ``core/server.py``'s ``_DISPATCH`` table and
# handler reply tags (and the gateway's gossip vocabulary) in BOTH
# directions, so adding a handler without auditing its framing — or
# retiring one and leaving a stale registry entry — fails ``make analyze``.
# The runtime sanitizer uses the same sets to flag unknown tags on live
# traffic, and ``tests/test_codec.py`` round-trips one exemplar per entry.

#: request tags the storage servers dispatch (``StorageServer._DISPATCH``)
MESSAGE_TYPES: frozenset = frozenset({
    "ec-query-batch", "ec-put-batch", "abd-get-batch", "abd-put-batch",
    "read-next-batch", "write-next-batch", "cons-p1-batch", "cons-p2-batch",
    "margin-batch",
    "abd-get", "abd-get-tag", "abd-put",
    "ec-query", "ec-put", "ec-repair-pull", "ec-repair-push",
    "read-next", "write-next", "cons-p1", "cons-p2",
})

#: reply tags the storage-server handlers return
REPLY_TYPES: frozenset = frozenset({
    "ec-list-batch", "abd-val-batch", "next-c-batch", "p1-batch", "p2-batch",
    "margin-batch",
    "abd-val", "abd-tag", "ec-list", "ec-repair-list",
    "next-c", "ack", "repair-ack",
    "p1-ok", "p1-nack", "p2-ok", "p2-nack",
})

#: gateway anti-entropy vocabulary (``GossipListener.handle``)
GOSSIP_TYPES: frozenset = frozenset({"gossip-configs"})
GOSSIP_REPLY_TYPES: frozenset = frozenset({"gossip-ack"})


_CONFIG_CLS = None


def _config_cls():
    """``repro_torch.core.tags.Config``, imported lazily: ``repro_torch.net.sim`` imports
    this module, and importing ``repro_torch.core.tags`` at module load would run
    ``repro_torch.core.__init__`` → ``coares`` → ``repro_torch.net.sim`` mid-init. The
    codec is only exercised at runtime, when everything is loaded."""
    global _CONFIG_CLS
    if _CONFIG_CLS is None:
        from repro_torch.core.tags import Config

        _CONFIG_CLS = Config
    return _CONFIG_CLS


# ----------------------------------------------------------------- varints
def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _uvarint_size(n: int) -> int:
    size = 1
    while n > 0x7F:
        n >>= 7
        size += 1
    return size


def _read_uvarint(buf, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _zigzag(n: int) -> int:
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def _unzigzag(z: int) -> int:
    return z >> 1 if not z & 1 else -((z + 1) >> 1)


# ------------------------------------------------------------------ encode
def _encode_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int) and not isinstance(obj, bool):
        out += b"i"
        out += _uvarint(_zigzag(obj))
    elif isinstance(obj, float):
        out += b"d"
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"s"
        out += _uvarint(len(raw))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += b"b"
        out += _uvarint(len(raw))
        out += raw
    elif isinstance(obj, tuple):
        out += b"t"
        out += _uvarint(len(obj))
        for x in obj:
            _encode_into(x, out)
    elif isinstance(obj, list):
        out += b"l"
        out += _uvarint(len(obj))
        for x in obj:
            _encode_into(x, out)
    elif isinstance(obj, dict):
        out += b"m"
        out += _uvarint(len(obj))
        for k, v in obj.items():
            _encode_into(k, out)
            _encode_into(v, out)
    elif isinstance(obj, _config_cls()):
        out += b"C"
        _encode_into(obj.cfg_id, out)
        _encode_into(obj.servers, out)
        _encode_into(obj.dap, out)
        _encode_into(obj.k, out)
        _encode_into(obj.delta, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            # pointer bytes would frame (and size) but never round-trip
            raise CodecError("object-dtype ndarray is not wire-encodable")
        arr = np.ascontiguousarray(obj)
        out += b"a"
        _encode_into(arr.dtype.str, out)
        _encode_into(tuple(int(d) for d in arr.shape), out)
        raw = arr.tobytes()
        out += _uvarint(len(raw))
        out += raw
    elif isinstance(obj, np.integer):
        _encode_into(int(obj), out)
    elif isinstance(obj, np.floating):
        _encode_into(float(obj), out)
    else:
        raise CodecError(f"not wire-encodable: {type(obj).__name__}")


def encode(obj: Any) -> bytes:
    """Encode one body (no length prefix)."""
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


def encode_frame(obj: Any) -> bytes:
    """Length-prefixed frame: ``uvarint(len(body)) || body``."""
    body = encode(obj)
    return _uvarint(len(body)) + body


# ------------------------------------------------------------------ decode
def _decode_at(buf, pos: int) -> tuple[Any, int]:
    tag = buf[pos : pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        z, pos = _read_uvarint(buf, pos)
        return _unzigzag(z), pos
    if tag == b"d":
        return struct.unpack(">d", buf[pos : pos + 8])[0], pos + 8
    if tag == b"s":
        n, pos = _read_uvarint(buf, pos)
        return bytes(buf[pos : pos + n]).decode("utf-8"), pos + n
    if tag == b"b":
        n, pos = _read_uvarint(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if tag in (b"t", b"l"):
        n, pos = _read_uvarint(buf, pos)
        items = []
        for _ in range(n):
            x, pos = _decode_at(buf, pos)
            items.append(x)
        return (tuple(items) if tag == b"t" else items), pos
    if tag == b"m":
        n, pos = _read_uvarint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _decode_at(buf, pos)
            v, pos = _decode_at(buf, pos)
            d[k] = v
        return d, pos
    if tag == b"C":
        cfg_id, pos = _decode_at(buf, pos)
        servers, pos = _decode_at(buf, pos)
        dap, pos = _decode_at(buf, pos)
        k, pos = _decode_at(buf, pos)
        delta, pos = _decode_at(buf, pos)
        return _config_cls()(cfg_id, servers, dap=dap, k=k, delta=delta), pos
    if tag == b"a":
        dtype, pos = _decode_at(buf, pos)
        shape, pos = _decode_at(buf, pos)
        n, pos = _read_uvarint(buf, pos)
        arr = np.frombuffer(bytes(buf[pos : pos + n]), dtype=np.dtype(dtype))
        return arr.reshape(shape), pos + n
    raise CodecError(f"bad wire tag {tag!r} at {pos - 1}")


def decode(body: bytes) -> Any:
    obj, pos = _decode_at(body, 0)
    if pos != len(body):
        raise CodecError(f"{len(body) - pos} trailing bytes after body")
    return obj


def decode_frame(frame: bytes) -> Any:
    n, pos = _read_uvarint(frame, 0)
    if len(frame) - pos != n:
        raise CodecError(f"frame length {n} != {len(frame) - pos} body bytes")
    return decode(frame[pos:])


# --------------------------------------------------------------- wire size
def _body_size(obj: Any) -> int:
    if obj is None or obj is True or obj is False:
        return 1
    if isinstance(obj, int) and not isinstance(obj, bool):
        return 1 + _uvarint_size(_zigzag(obj))
    if isinstance(obj, float):
        return 9
    if isinstance(obj, str):
        n = len(obj) if obj.isascii() else len(obj.encode("utf-8"))
        return 1 + _uvarint_size(n) + n
    if isinstance(obj, (bytes, bytearray, memoryview)):
        # memoryview len() counts ELEMENTS; nbytes is the encoded length
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        return 1 + _uvarint_size(n) + n
    if isinstance(obj, (tuple, list)):
        return 1 + _uvarint_size(len(obj)) + sum(_body_size(x) for x in obj)
    if isinstance(obj, dict):
        return (
            1
            + _uvarint_size(len(obj))
            + sum(_body_size(k) + _body_size(v) for k, v in obj.items())
        )
    if isinstance(obj, _config_cls()):
        return (
            1
            + _body_size(obj.cfg_id)
            + _body_size(obj.servers)
            + _body_size(obj.dap)
            + _body_size(obj.k)
            + _body_size(obj.delta)
        )
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise CodecError("object-dtype ndarray is not wire-encodable")
        n = int(obj.nbytes)
        return (
            1
            + _body_size(obj.dtype.str)
            + _body_size(tuple(int(d) for d in obj.shape))
            + _uvarint_size(n)
            + n
        )
    if isinstance(obj, np.integer):
        return _body_size(int(obj))
    if isinstance(obj, np.floating):
        return 9
    raise CodecError(f"not wire-encodable: {type(obj).__name__}")


def wire_size(obj: Any) -> int:
    """``len(encode_frame(obj))`` without building the frame."""
    body = _body_size(obj)
    return _uvarint_size(body) + body


def try_wire_size(obj: Any) -> int | None:
    """Framed size, or None when the object is outside the vocabulary."""
    try:
        return wire_size(obj)
    except CodecError:
        return None


# ----------------------------------------------------- identity size memo
class SizingMemo:
    """Wire-size computation with an identity-keyed memo (ISSUE 7).

    ``wire_size`` walks a message's whole structure; on the simulator's hot
    path the SAME objects recur constantly — a broadcast payload framed once
    per fan-out but re-framed on every retry round, stored tags / coded
    elements / ``Config`` objects embedded in every ``ec-list`` and
    ``read-next`` reply, a gateway's multicast entries. This memo caches the
    body size of every *transitively immutable* node it walks (tuples of
    immutables, ``Config``, and the leaf scalars they contain), keyed on
    ``id(obj)`` with the object pinned in the memo so the id cannot be
    recycled while the entry lives. Mutable containers (list / dict /
    bytearray / memoryview / ndarray) are never cached — their size is
    re-walked on every call — so in-place mutation can never yield a stale
    size. The memo is bounded: it is cleared wholesale past ``max_entries``
    entries or ``max_pinned_bytes`` of cumulative wire size (an identity
    cache has no useful eviction order, and pinning keeps payload bytes
    alive — the byte budget stops a long run from retaining every payload
    it ever framed).

    On top of the identity memo sits a *content* cache for whole messages:
    protocol requests are built fresh every round, so they never identity-hit,
    yet under a zipfian workload the same message **values** recur across
    thousands of sessions. ``wire_size`` therefore also keys finished frames
    by the message object itself (dict hash, C speed) — guarded by a
    ``repr`` fingerprint, because Python equality is coarser than the wire
    format: ``0 == False == 0.0`` yet the three frame differently. Two
    objects that are ``==`` *and* share a ``repr`` have pairwise-equal leaves
    of identical types, hence identical frames, so a fingerprint-verified hit
    is exact; a mismatch just falls back to the walk. Only hashable,
    transitively-immutable values with frames ≤ ``content_max_frame`` are
    cached (big payload frames would make the repr check itself expensive).

    Sizes are exactly ``wire_size``'s — the memo changes cost, never the
    charged bytes (property-tested in ``tests/test_scalepath.py``).
    """

    __slots__ = (
        "_memo", "_frame", "_pinned",
        "max_entries", "max_pinned_bytes", "content_max_frame",
    )

    def __init__(self, max_entries: int = 1 << 18, max_pinned_bytes: int = 64 << 20,
                 content_max_frame: int = 4096):
        self._memo: dict[int, tuple[Any, int]] = {}
        self._frame: dict[Any, tuple[str, int, int]] = {}
        self._pinned = 0
        self.max_entries = max_entries
        self.max_pinned_bytes = max_pinned_bytes
        self.content_max_frame = content_max_frame

    def wire_size(self, obj: Any) -> int:
        """``len(encode_frame(obj))`` without building the frame (memoized).
        Raises :class:`CodecError` outside the vocabulary, like
        :func:`wire_size`."""
        hit = self._memo.get(id(obj))
        if hit is not None and hit[0] is obj:
            body = hit[1]
            return _uvarint_size(body) + body
        try:
            ent = self._frame.get(obj)
        except TypeError:  # unhashable content (list/dict/bytearray inside)
            hashable = False
        else:
            hashable = True
            if ent is not None and ent[0] == repr(obj):
                # promote: repeated calls with this very object id-hit above
                # instead of paying the repr fingerprint every time
                self._remember(obj, ent[2])
                return ent[1]
        body, pure = self._size(obj)
        total = _uvarint_size(body) + body
        if hashable and pure and total <= self.content_max_frame:
            frame = self._frame
            if len(frame) >= self.max_entries:
                frame.clear()
            frame[obj] = (repr(obj), total, body)
        return total

    def _remember(self, obj: Any, size: int) -> None:
        memo = self._memo
        if len(memo) >= self.max_entries or self._pinned > self.max_pinned_bytes:
            memo.clear()
            self._pinned = 0
        memo[id(obj)] = (obj, size)
        self._pinned += size

    def _size(self, obj: Any) -> tuple[int, bool]:
        """(body size, transitively-immutable?) — only pure nodes are cached."""
        if obj is None or obj is True or obj is False:
            return 1, True
        cls = type(obj)
        if cls is int:
            return 1 + _uvarint_size(_zigzag(obj)), True
        if cls is float:
            return 9, True
        if cls is str:
            n = len(obj) if obj.isascii() else len(obj.encode("utf-8"))
            return 1 + _uvarint_size(n) + n, True
        if cls is bytes:
            n = len(obj)
            return 1 + _uvarint_size(n) + n, True
        if cls is tuple:
            hit = self._memo.get(id(obj))
            if hit is not None and hit[0] is obj:
                return hit[1], True
            size = 1 + _uvarint_size(len(obj))
            pure = True
            for x in obj:
                s, p = self._size(x)
                size += s
                pure = pure and p
            if pure:
                self._remember(obj, size)
            return size, pure
        if cls is list:
            size = 1 + _uvarint_size(len(obj))
            for x in obj:
                size += self._size(x)[0]
            return size, False
        if cls is dict:
            size = 1 + _uvarint_size(len(obj))
            for k, v in obj.items():
                size += self._size(k)[0] + self._size(v)[0]
            return size, False
        if isinstance(obj, _config_cls()):
            # frozen dataclass over immutable fields: always cacheable
            hit = self._memo.get(id(obj))
            if hit is not None and hit[0] is obj:
                return hit[1], True
            size = (
                1
                + self._size(obj.cfg_id)[0]
                + self._size(obj.servers)[0]
                + self._size(obj.dap)[0]
                + self._size(obj.k)[0]
                + self._size(obj.delta)[0]
            )
            self._remember(obj, size)
            return size, True
        # uncommon/mutable leaves: defer to the plain walk, never cache
        if isinstance(obj, (bytearray, memoryview, np.ndarray)):
            return _body_size(obj), False
        if isinstance(obj, (int, bool)):  # bool/int subclasses
            return _body_size(obj), True
        if isinstance(obj, (float, str, bytes, np.integer, np.floating)):
            return _body_size(obj), True
        if isinstance(obj, (tuple, list)):  # subclasses: size, don't cache
            return _body_size(obj), False
        if isinstance(obj, dict):
            return _body_size(obj), False
        raise CodecError(f"not wire-encodable: {type(obj).__name__}")
