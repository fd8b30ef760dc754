"""The work of one flash-attention call: the (query, key) pairs its masks
leave and the K/V rows they reach.

One definition for every count of it: the kernel's flop formula (``ops``),
the HBM bytes the dry run charges it (``roofline.op_count``) and the bound
``chip_smoke.py`` holds its times against. Positions follow the kernel's:
keys from 0, queries from ``q_offset``; a query at q attends key k where
k <= q (causal) and q - k < window (window > 0).
"""
from __future__ import annotations


def _first_key(q: int, window: int) -> int:
    return max(0, q - window + 1) if window else 0


def causal_pairs(Sq: int, Sk: int, window: int = 0, causal: bool = True,
                 q_offset: int = 0) -> int:
    """Unmasked (q, k) pairs of one head, the queries at positions
    ``q_offset`` .. ``q_offset + Sq - 1``: what the kernel computes.
    Non-causal with no window: every pair. Closed form, by the runs of
    queries over which each end of a query's key range is constant or
    grows by one."""
    if Sq <= 0 or Sk <= 0:
        return 0
    if not causal and not window:
        return Sq * Sk
    lo, hi = q_offset, q_offset + Sq - 1
    # the last key: min(q, Sk - 1) if causal, else Sk - 1
    if causal:
        cut = min(max(lo, Sk - 1), hi + 1)  # queries below ``cut`` end at q
        last_sum = _span_sum(lo, cut - 1) + (hi - cut + 1) * (Sk - 1)
    else:
        last_sum = Sq * (Sk - 1)
    # the first key: q - window + 1 once that is above 0
    if window:
        start = min(max(lo, window - 1), hi + 1)  # queries below ``start`` begin at 0
        first_sum = _span_sum(start, hi) - (hi - start + 1) * (window - 1)
    else:
        first_sum = 0
    total = last_sum - first_sum + Sq
    # a query whose first key is past its last adds 0, where the sums above
    # add last - first + 1 < 0: windowed queries at Sk + window and beyond
    past = max(lo, Sk + window) if window else hi + 1
    return total + _span_sum(past - window - Sk + 1, hi - window - Sk + 1)


def _span_sum(a: int, b: int) -> int:
    """a + (a + 1) + ... + b (0 for an empty span)."""
    return (a + b) * (b - a + 1) // 2 if b >= a else 0


def keys_reached(Sq: int, Sk: int, window: int = 0, causal: bool = True,
                 q_offset: int = 0) -> int:
    """Keys that some query at ``q_offset`` .. ``q_offset + Sq - 1`` attends
    under the masks of ``causal_pairs``: the K and V rows the kernel must
    read. A query's keys run from ``q - window + 1`` (0 with no window) to
    ``q`` (the last key if not causal), so the block's run from its first
    query's first key to its last query's last."""
    first = _first_key(q_offset, window)
    last = min(q_offset + Sq - 1, Sk - 1) if causal else Sk - 1
    return max(0, last - first + 1)


def flops(B: int, H: int, Sq: int, Sk: int, hd: int, window: int = 0, causal: bool = True,
          q_offset: int = 0) -> int:
    """4 * B * H * hd * ``causal_pairs``: the two products a pair costs (QK^T
    and PV), each a multiply and an add per head-dim element."""
    return 4 * B * H * hd * causal_pairs(Sq, Sk, window, causal, q_offset)


def hbm_bytes(B: int, H: int, Hkv: int, Sq: int, Sk: int, hd: int, itemsize: int,
              window: int = 0, causal: bool = True, q_offset: int = 0) -> int:
    """The bytes one call must move: q read and the output written, and the K
    and V rows the masks reach, each read once."""
    return (2 * B * H * Sq * hd + 2 * B * Hkv * keys_reached(Sq, Sk, window, causal, q_offset)
            * hd) * itemsize
