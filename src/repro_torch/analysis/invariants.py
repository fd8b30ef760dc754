"""The repo-specific protocol-invariant rule pack (``python -m repro_torch.analysis``).

Five rules, each guarding an invariant one of the protocol tiers rests on:

``registry-drift``
    ``core/server.py``'s ``_DISPATCH`` table, ``net/codec.py``'s
    ``MESSAGE_TYPES``/``REPLY_TYPES`` registries, and the gateway's gossip
    vocabulary must agree bidirectionally. A handler without a registry
    entry (or vice versa) means a message type the wire codec was never
    audited against — exactly how byte accounting and the runtime
    sanitizer's vocabulary check silently rot.

``assert-ban``
    No ``assert`` in ``core/``, ``net/`` or ``erasure/``: asserts vanish
    under ``python -O``, so a load-bearing protocol check becomes a no-op
    in optimized deployments. Raise ``ValueError``/``RuntimeError``.

``determinism``
    No wall-clock (``time`` module) or unseeded randomness (stdlib
    ``random``, legacy ``np.random.*`` globals) in ``core/``/``net/``.
    Virtual time and the fast/legacy trace-identity contract (ROADMAP:
    "determinism is the contract") both die the moment protocol code reads
    the host clock or an unseeded stream. Seeded ``np.random.default_rng``
    / ``Generator`` / ``SeedSequence`` remain allowed.

``set-iteration``
    No iterating a ``set``/``frozenset`` (or materialising one via
    ``tuple()``/``list()``, or passing one as RPC ``dests=``) in
    ``core/``/``net/``: set iteration order is salted per process, so a
    fan-out built from a set replays a different trace per run. Membership
    tests and ``sorted(...)`` are fine — that's the sanctioned idiom.

``statemap-bypass``
    No rebinding a server's tracked state maps (``.abd``/``.ec``/
    ``.next_c``) or its reply-cache internals (``._rcache``/``._rkeys``)
    outside ``StorageServer.__init__``: replacing a ``_StateMap`` with a
    plain dict silently disconnects the PR-6 read-reply cache's
    invalidation (and the runtime sanitizer's external-mutation hook) —
    the exact cache-coherence race the tracked maps exist to prevent.

The engine additionally self-checks the waiver mechanism (``stale-waiver``,
ISSUE 9): every ``protocol-lint: allow-<rule>`` comment that no longer
suppresses a finding of ``<rule>`` on its line is itself reported — a stale
waiver silently re-opens the line to the exact regression the rule guards
against. See ``repro_torch.analysis.astlint.run_rules``.

Run as ``python -m repro_torch.analysis``. The whole
path is stdlib-only: nothing here imports numpy or the protocol modules.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from repro_torch.analysis.astlint import (
    Finding,
    ModuleRule,
    RepoRule,
    const_str,
    dict_str_keys,
    frozenset_str_items,
    is_set_expr,
    main_with,
    parse_module,
    run_rules,
)

PROTOCOL_SCOPE = ("core", "net")
ASSERT_SCOPE = ("core", "net", "erasure")

# legacy np.random globals draw from the process-wide unseeded state; the
# Generator API (seeded construction) is the only sanctioned randomness.
_NP_RANDOM_ALLOWED = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "Philox",
})


class AssertBanRule(ModuleRule):
    name = "assert-ban"
    scope = ASSERT_SCOPE

    def check(
        self, relpath: str, tree: ast.Module, lines: list[str]
    ) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Assert):
                yield Finding(
                    self.name, relpath, node.lineno,
                    "assert vanishes under python -O; raise "
                    "ValueError/RuntimeError instead",
                )


class DeterminismRule(ModuleRule):
    name = "determinism"
    scope = PROTOCOL_SCOPE

    def check(
        self, relpath: str, tree: ast.Module, lines: list[str]
    ) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    top = alias.name.split(".")[0]
                    if top in ("time", "random"):
                        yield Finding(
                            self.name, relpath, node.lineno,
                            f"import of {top!r}: wall-clock/unseeded "
                            "randomness breaks virtual-time determinism",
                        )
            elif isinstance(node, ast.ImportFrom):
                top = (node.module or "").split(".")[0]
                if top in ("time", "random"):
                    yield Finding(
                        self.name, relpath, node.lineno,
                        f"import from {top!r}: wall-clock/unseeded "
                        "randomness breaks virtual-time determinism",
                    )
            elif isinstance(node, ast.Attribute):
                # np.random.<legacy-global> (e.g. np.random.random): draws
                # from the unseeded process-wide state
                v = node.value
                if (
                    isinstance(v, ast.Attribute)
                    and v.attr == "random"
                    and isinstance(v.value, ast.Name)
                    and v.value.id in ("np", "numpy")
                    and node.attr not in _NP_RANDOM_ALLOWED
                ):
                    yield Finding(
                        self.name, relpath, node.lineno,
                        f"np.random.{node.attr}: legacy global RNG is "
                        "unseeded; use np.random.default_rng(seed)",
                    )


class SetIterationRule(ModuleRule):
    name = "set-iteration"
    scope = PROTOCOL_SCOPE

    @staticmethod
    def _set_names(tree: ast.Module) -> set[str]:
        """Names that are ONLY ever assigned set-valued expressions."""
        yes: set[str] = set()
        no: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                value, targets = node.value, [node.target]
            else:
                continue
            if value is None:
                continue
            bucket = yes if is_set_expr(value) else no
            for t in targets:
                if isinstance(t, ast.Name):
                    bucket.add(t.id)
        return yes - no

    def check(
        self, relpath: str, tree: ast.Module, lines: list[str]
    ) -> Iterator[Finding]:
        tracked = self._set_names(tree)

        def bad(node: ast.AST) -> bool:
            return is_set_expr(node) or (
                isinstance(node, ast.Name) and node.id in tracked
            )

        for node in ast.walk(tree):
            if isinstance(node, (ast.For, ast.AsyncFor)) and bad(node.iter):
                yield Finding(
                    self.name, relpath, node.lineno,
                    "iterating a set: order is salted per process; "
                    "iterate sorted(...) instead",
                )
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if bad(gen.iter):
                        yield Finding(
                            self.name, relpath, node.lineno,
                            "comprehension over a set: order is salted per "
                            "process; iterate sorted(...) instead",
                        )
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("tuple", "list")
                    and node.args
                    and bad(node.args[0])
                ):
                    yield Finding(
                        self.name, relpath, node.lineno,
                        f"{node.func.id}() over a set bakes salted order "
                        "into a sequence; use sorted(...)",
                    )
                for kw in node.keywords:
                    if kw.arg == "dests" and bad(kw.value):
                        yield Finding(
                            self.name, relpath, node.lineno,
                            "RPC dests= built from a set: fan-out order "
                            "(and the trace) becomes nondeterministic",
                        )


class StateMapBypassRule(ModuleRule):
    name = "statemap-bypass"
    scope = PROTOCOL_SCOPE

    _TRACKED = frozenset({"abd", "ec", "next_c", "_rcache", "_rkeys"})

    def check(
        self, relpath: str, tree: ast.Module, lines: list[str]
    ) -> Iterator[Finding]:
        yield from self._visit(relpath, tree, in_init=False)

    def _visit(
        self, relpath: str, node: ast.AST, in_init: bool
    ) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._visit(
                    relpath, child,
                    in_init=(
                        child.name == "__init__"
                        and relpath == "core/server.py"
                    ),
                )
                continue
            if isinstance(child, (ast.Assign, ast.AugAssign)) and not in_init:
                targets = (
                    child.targets
                    if isinstance(child, ast.Assign)
                    else [child.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr in self._TRACKED
                    ):
                        yield Finding(
                            self.name, relpath, child.lineno,
                            f"rebinding .{t.attr} replaces the tracked "
                            "_StateMap and disconnects reply-cache "
                            "invalidation (mutate it in place instead)",
                        )
            yield from self._visit(relpath, child, in_init)


class RegistryDriftRule(RepoRule):
    """server ``_DISPATCH``/reply tags ↔ codec registries ↔ gateway gossip."""

    name = "registry-drift"

    # ------------------------------------------------------------- extract
    @staticmethod
    def _class(tree: ast.Module, name: str) -> ast.ClassDef | None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == name:
                return node
        return None

    @staticmethod
    def _return_tags(fn: ast.AST) -> set[str]:
        """First-element string constants of literal tuple returns."""
        tags: set[str] = set()
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Return)
                and isinstance(node.value, ast.Tuple)
                and node.value.elts
            ):
                s = const_str(node.value.elts[0])
                if s is not None:
                    tags.add(s)
        return tags

    def _server_vocab(
        self, tree: ast.Module
    ) -> tuple[dict[str, int], dict[str, int], set[str]]:
        """(dispatch {op: line}, read_only {op: line}, reply tags)."""
        dispatch: dict[str, int] = {}
        read_only: dict[str, int] = {}
        replies: set[str] = set()
        cls = self._class(tree, "StorageServer")
        if cls is None:
            return dispatch, read_only, replies
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t = stmt.targets[0]
                if isinstance(t, ast.Name) and t.id in (
                    "_DISPATCH", "_READ_ONLY"
                ):
                    keys = dict_str_keys(stmt.value) or []
                    dest = dispatch if t.id == "_DISPATCH" else read_only
                    for k, line in keys:
                        dest[k] = line
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name.startswith("_h_"):
                    replies |= self._return_tags(stmt)
        return dispatch, read_only, replies

    def _gossip_vocab(self, tree: ast.Module) -> tuple[set[str], set[str]]:
        """(handled ops, reply tags) of ``GossipListener.handle``."""
        ops: set[str] = set()
        replies: set[str] = set()
        cls = self._class(tree, "GossipListener")
        if cls is None:
            return ops, replies
        for stmt in cls.body:
            if (
                isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name == "handle"
            ):
                for node in ast.walk(stmt):
                    if (
                        isinstance(node, ast.Compare)
                        and isinstance(node.left, ast.Name)
                        and node.left.id == "op"
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], ast.Eq)
                    ):
                        s = const_str(node.comparators[0])
                        if s is not None:
                            ops.add(s)
                replies |= self._return_tags(stmt)
        return ops, replies

    @staticmethod
    def _registries(tree: ast.Module) -> dict[str, tuple[set[str], int]]:
        out: dict[str, tuple[set[str], int]] = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            else:
                continue
            if isinstance(target, ast.Name) and target.id.endswith("_TYPES"):
                items = frozenset_str_items(value)
                if items is not None:
                    out[target.id] = (items, stmt.lineno)
        return out

    # --------------------------------------------------------------- check
    def check_repo(self, root: Path) -> Iterator[Finding]:
        server_p = root / "core" / "server.py"
        codec_p = root / "net" / "codec.py"
        gateway_p = root / "core" / "gateway.py"
        for p in (server_p, codec_p, gateway_p):
            if not p.exists():
                yield Finding(
                    self.name, p.name, 1, f"expected module missing: {p}"
                )
                return
        dispatch, read_only, replies = self._server_vocab(
            parse_module(server_p)[0]
        )
        regs = self._registries(parse_module(codec_p)[0])
        gossip_ops, gossip_replies = self._gossip_vocab(
            parse_module(gateway_p)[0]
        )

        def reg(regname: str) -> tuple[set[str], int]:
            ent = regs.get(regname)
            if ent is None:
                return set(), 1
            return ent

        msg_types, msg_line = reg("MESSAGE_TYPES")
        reply_types, reply_line = reg("REPLY_TYPES")
        g_types, g_line = reg("GOSSIP_TYPES")
        g_reply_types, gr_line = reg("GOSSIP_REPLY_TYPES")
        for regname in (
            "MESSAGE_TYPES", "REPLY_TYPES", "GOSSIP_TYPES",
            "GOSSIP_REPLY_TYPES",
        ):
            if regname not in regs:
                yield Finding(
                    self.name, "net/codec.py", 1,
                    f"registry {regname} missing (expected a frozenset "
                    "literal of message tags)",
                )
        # server handlers <-> codec MESSAGE_TYPES, both directions
        for op in sorted(set(dispatch) - msg_types):
            yield Finding(
                self.name, "core/server.py", dispatch[op],
                f"server handles {op!r} but net/codec.py MESSAGE_TYPES has "
                "no entry (registry drift)",
            )
        for op in sorted(msg_types - set(dispatch)):
            yield Finding(
                self.name, "net/codec.py", msg_line,
                f"MESSAGE_TYPES lists {op!r} but core/server.py _DISPATCH "
                "has no handler (registry drift)",
            )
        # server reply tags <-> codec REPLY_TYPES, both directions
        for tag in sorted(replies - reply_types):
            yield Finding(
                self.name, "net/codec.py", reply_line,
                f"server replies with {tag!r} but REPLY_TYPES has no entry "
                "(registry drift)",
            )
        for tag in sorted(reply_types - replies):
            yield Finding(
                self.name, "net/codec.py", reply_line,
                f"REPLY_TYPES lists {tag!r} but no server handler returns "
                "it (registry drift)",
            )
        # cacheable ops must be dispatchable
        for op in sorted(set(read_only) - set(dispatch)):
            yield Finding(
                self.name, "core/server.py", read_only[op],
                f"_READ_ONLY caches {op!r} but _DISPATCH has no handler",
            )
        # gateway gossip vocabulary <-> codec, both directions
        for op in sorted(gossip_ops.symmetric_difference(g_types)):
            yield Finding(
                self.name, "net/codec.py", g_line,
                f"gossip op {op!r} differs between GossipListener.handle "
                "and GOSSIP_TYPES (registry drift)",
            )
        for tag in sorted(gossip_replies.symmetric_difference(g_reply_types)):
            yield Finding(
                self.name, "net/codec.py", gr_line,
                f"gossip reply {tag!r} differs between GossipListener."
                "handle and GOSSIP_REPLY_TYPES (registry drift)",
            )


MODULE_RULES = (
    AssertBanRule(),
    DeterminismRule(),
    SetIterationRule(),
    StateMapBypassRule(),
)
REPO_RULES = (RegistryDriftRule(),)


def package_root() -> Path:
    """``src/repro_torch`` — the package this pack lints."""
    return Path(__file__).resolve().parents[1]


def collect_findings(root: Path | None = None) -> list[Finding]:
    """All findings over ``root`` (default: this repo's ``src/repro_torch``)."""
    return run_rules(root or package_root(), MODULE_RULES, REPO_RULES)


def main(argv: list[str] | None = None) -> int:
    return main_with(package_root(), MODULE_RULES, REPO_RULES, argv)
