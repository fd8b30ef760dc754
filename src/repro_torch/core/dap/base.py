"""Data Access Primitives (§III): get-tag / get-data / put-data.

A DAP instance is bound to (network, client id, configuration). All
primitives are generators driven by the sim runner. Implementations must
satisfy Property 1 (C1/C2) — empirically validated by the history checkers in
``tests/checkers.py`` and the hypothesis suites.

Multi-object extension (ISSUE 2): ``get_data_batch`` / ``put_data_batch``
carry N objects in ONE quorum fan-out. The List protocol is agnostic to how
many objects ride in a round (Konwar et al.'s storage-optimized EC-DAP), so
each object's result is exactly what its single-object call would return —
batching changes framing and round count, never per-object semantics. The
single-object primitives are thin wrappers over the batch forms.
"""
from __future__ import annotations

from typing import Any, Generator, Iterable, Sequence

from repro_torch.core.tags import Config, Tag


class DapClient:
    kind = "?"

    def __init__(self, net, client_id: str, config: Config, cfg_idx: int, client_state):
        self.net = net
        self.client_id = client_id
        self.config = config
        self.cfg_idx = cfg_idx
        # shared mutable per-(client) state — EC-DAPopt keeps (c.tag, c.val)
        # per (object, configuration) here (paper Alg 4 state variables).
        self.client_state = client_state

    # generators:
    def get_tag(self, obj: str) -> Generator:  # pragma: no cover
        raise NotImplementedError

    def get_data(self, obj: str) -> Generator:
        """Single-object form — one round of the batch engine."""
        res = yield from self.get_data_batch((obj,))
        return res[obj]

    def put_data(self, obj: str, tag: Tag, value: Any) -> Generator:
        yield from self.put_data_batch(((obj, tag, value),))
        return None

    # batch generators (the primitives subclasses actually implement):
    def get_data_batch(self, objs: Iterable[str]) -> Generator:
        """Fetch ``{obj: (tag, value)}`` for every object in one fan-out."""
        raise NotImplementedError

    def put_data_batch(self, items: Sequence[tuple[str, Tag, Any]]) -> Generator:
        """Store every ``(obj, tag, value)`` in one fan-out."""
        raise NotImplementedError


def make_dap(net, client_id: str, config: Config, cfg_idx: int, client_state) -> DapClient:
    from repro_torch.core.dap.abd import AbdDap
    from repro_torch.core.dap.ec import EcDap

    if config.dap == "abd":
        return AbdDap(net, client_id, config, cfg_idx, client_state)
    if config.dap in ("ec", "ec_opt"):
        return EcDap(
            net, client_id, config, cfg_idx, client_state,
            optimized=(config.dap == "ec_opt"),
        )
    raise ValueError(f"unknown DAP {config.dap!r}")
