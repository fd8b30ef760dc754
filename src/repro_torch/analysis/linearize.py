"""Post-hoc linearizability over recorded histories, Wing–Gong style.

A Wing–Gong linearizability search is exponential in general; for a tagged
read/write register it collapses to three linear-time conditions, because
tags ``(ts, wid)`` totally order the writes and every operation reports the
tag it observed (the reduction ARES's atomicity proof builds on, and the
same one ``tests/checkers.py`` uses — this module is the library form the
runtime sanitizer raises through, with exceptions instead of ``assert``):

1. **Write-tag uniqueness** — two version-changing writes never share a
   tag (so tag order IS a total order over writes).
2. **Real-time tag monotonicity** — an operation never returns a tag
   smaller than one returned by any operation that completed before it
   started. With (1) this yields a legal linearization: order all ops by
   (tag, kind) with each read after its write.
3. **Reads-from** — every read's tag was produced by some write (or is
   the initial ``TAG0``), i.e. reads never invent values.

Violations raise :class:`LinearizabilityError` (a ``SanitizerError``)
carrying the object and the offending operation pair.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Iterable

from repro_torch.analysis.sanitizer import SanitizerError
from repro_torch.core.tags import TAG0


class LinearizabilityError(SanitizerError):
    """A recorded history admits no legal linearization under tag order."""


def check_tag_linearizable(
    history: Iterable[Any], *, strict_reads: bool = True
) -> dict[str, int]:
    """Check every read/write ``OpRecord`` in ``history``; returns
    ``{"objects": ..., "ops": ...}`` counters on success and raises
    :class:`LinearizabilityError` on the first violated condition.

    Records with other kinds (``recon``, ``fm-*``) or without a tag are
    outside the register model and are skipped. ``strict_reads=False``
    relaxes condition (3) only: histories taken under crash storms may
    contain reads that observed a write which never completed (failed or
    stuck ops record nothing), so their tags legitimately have no recorded
    producer. Conditions (1) and (2) — the atomicity core — always apply.
    """
    by_obj: dict[str, list] = defaultdict(list)
    n_ops = 0
    for r in history:
        if r.kind in ("read", "write") and r.tag is not None:
            by_obj[r.obj].append(r)
            n_ops += 1
    for obj, ops in by_obj.items():
        # (1) uniqueness over version-changing writes
        wtags = [r.tag for r in ops if r.kind == "write" and r.flag == "chg"]
        if len(wtags) != len(set(wtags)):
            dup = sorted(t for t in set(wtags) if wtags.count(t) > 1)
            raise LinearizabilityError(
                f"{obj}: duplicate chg-write tags {dup} — tag order is not "
                "a total order over writes"
            )
        # (2) real-time monotonicity: sweep start/end events in virtual-time
        # order (ends before starts at equal times: a read starting exactly
        # when a write ends must already see it)
        events = sorted(
            [(r.start, 1, i) for i, r in enumerate(ops)]
            + [(r.end, 0, i) for i, r in enumerate(ops)],
            key=lambda e: (e[0], e[1]),
        )
        floor_of = [TAG0] * len(ops)
        max_done = TAG0
        for _t, is_start, i in events:
            if is_start:
                floor_of[i] = max_done
            else:
                r = ops[i]
                if r.tag < floor_of[i]:
                    raise LinearizabilityError(
                        f"{obj}: {r.kind} by {r.client} returned tag "
                        f"{r.tag} < {floor_of[i]}, the tag of an operation "
                        "that completed before it started (real-time order "
                        "violated)"
                    )
                if r.tag > max_done:
                    max_done = r.tag
        # (3) reads-from: read tags must come from some write (chg or the
        # degraded unchg form, which reports the tag it adopted) or TAG0
        if strict_reads:
            produced = {r.tag for r in ops if r.kind == "write"} | {TAG0}
            for r in ops:
                if r.kind == "read" and r.tag not in produced:
                    raise LinearizabilityError(
                        f"{obj}: read by {r.client} returned tag {r.tag} "
                        "that no recorded write produced"
                    )
    return {"objects": len(by_obj), "ops": n_ops}
