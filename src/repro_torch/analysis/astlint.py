"""Tiny AST lint engine for the protocol-invariant rule pack (ISSUE 8).

``ruff`` keeps the general Python hygiene; this engine exists for the rules
ruff cannot express — repo-specific protocol invariants like "every server
message type has a codec registry entry" or "no unordered set iteration in
fan-out construction". It is deliberately stdlib-only (``ast`` + ``pathlib``)
so the CI lint job needs zero third-party installs, and it never *imports*
the code under analysis — everything is read from source, so a module with a
side-effectful import (or a missing optional dep) still lints.

Two rule shapes:

* :class:`ModuleRule` — gets each in-scope module's AST and source lines;
  yields :class:`Finding`s. Scope is a tuple of path prefixes relative to
  the package root (e.g. ``("core", "net")``).
* :class:`RepoRule` — gets the package root once; for cross-file invariants
  (the registry-drift detector reads ``core/server.py`` against
  ``net/codec.py``).

Waivers: a finding is suppressed when its source line (or, for multi-line
statements, the statement's first line) carries the comment marker
``protocol-lint: allow-<rule-name>`` — always with a reason, e.g.::

    from time import perf_counter  # protocol-lint: allow-wallclock (profiling)

Waivers are per-line and per-rule, so a blanket opt-out is impossible.

Stale waivers (ISSUE 9): a waiver that stops suppressing anything — the
code it excused was fixed or moved, but the comment stayed — is itself a
finding (rule ``stale-waiver``). ``run_rules`` collects every waiver
comment (via ``tokenize``, so a docstring *mentioning* a marker, like the
example above, doesn't count) and reports each one no module-rule finding
consumed. A stale waiver is latent rot: it silently re-opens the line to
the exact regression the rule guards against. Stale-waiver findings are
not themselves waivable — delete the comment instead.
"""
from __future__ import annotations

import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # path relative to the package root
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class ModuleRule:
    """Per-module rule: override ``check`` (and ``scope`` / ``name``)."""

    name = "module-rule"
    #: path prefixes (relative to the package root, "/"-separated) this rule
    #: applies to; () = every module.
    scope: tuple[str, ...] = ()

    def applies(self, relpath: str) -> bool:
        return not self.scope or any(
            relpath == s or relpath.startswith(s + "/") for s in self.scope
        )

    def check(
        self, relpath: str, tree: ast.Module, lines: list[str]
    ) -> Iterator[Finding]:  # pragma: no cover - interface
        raise NotImplementedError


class RepoRule:
    """Whole-repo rule: override ``check_repo``."""

    name = "repo-rule"

    def check_repo(self, root: Path) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


def parse_module(path: Path) -> tuple[ast.Module, list[str]]:
    source = path.read_text(encoding="utf-8")
    return ast.parse(source, filename=str(path)), source.splitlines()


def iter_py_files(root: Path) -> Iterator[Path]:
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" not in p.parts:
            yield p


def waived(lines: list[str], lineno: int, rule: str) -> bool:
    """True when the finding's line carries ``protocol-lint: allow-<rule>``."""
    if 1 <= lineno <= len(lines):
        return f"protocol-lint: allow-{rule}" in lines[lineno - 1]
    return False


STALE_WAIVER_RULE = "stale-waiver"

_WAIVER_RE = re.compile(r"protocol-lint:\s*allow-([A-Za-z0-9_-]+)")


def iter_waivers(lines: list[str]) -> Iterator[tuple[int, str]]:
    """``(lineno, rule)`` for every waiver marker in a COMMENT token.
    Tokenizing (rather than substring-scanning every line) keeps docstrings
    and string literals that merely *mention* a marker from counting as
    waivers of anything."""
    src = "\n".join(lines) + "\n"
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                for m in _WAIVER_RE.finditer(tok.string):
                    yield tok.start[0], m.group(1)
    except tokenize.TokenError:  # pragma: no cover - file already parsed
        return


def run_rules(
    root: Path,
    module_rules: Iterable[ModuleRule],
    repo_rules: Iterable[RepoRule] = (),
    check_waivers: bool = True,
) -> list[Finding]:
    """Run every rule over the package rooted at ``root``; returns findings
    (waived ones already removed), sorted by path/line. With
    ``check_waivers`` (the default), every waiver comment that suppressed
    no finding is reported under the ``stale-waiver`` rule — including
    waivers naming unknown rules and waivers in files outside every rule's
    scope, where nothing could ever fire."""
    findings: list[Finding] = []
    module_rules = list(module_rules)
    used: set[tuple[str, int, str]] = set()
    waivers: list[tuple[str, int, str]] = []
    for path in iter_py_files(root):
        relpath = path.relative_to(root).as_posix()
        active = [r for r in module_rules if r.applies(relpath)]
        if not active and not check_waivers:
            continue
        tree, lines = parse_module(path)
        if check_waivers:
            for lineno, rname in iter_waivers(lines):
                waivers.append((relpath, lineno, rname))
        for rule in active:
            for f in rule.check(relpath, tree, lines):
                if waived(lines, f.line, f.rule):
                    used.add((f.path, f.line, f.rule))
                else:
                    findings.append(f)
    for rule in repo_rules:
        findings.extend(rule.check_repo(root))
    for relpath, lineno, rname in waivers:
        if (relpath, lineno, rname) not in used:
            findings.append(Finding(
                STALE_WAIVER_RULE, relpath, lineno,
                f"waiver 'allow-{rname}' suppresses nothing here: rule "
                f"{rname!r} does not fire on this line — remove the "
                "comment (a stale waiver silently re-opens the line to "
                "the regression the rule guards against)",
            ))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main_with(
    root: Path,
    module_rules: Iterable[ModuleRule],
    repo_rules: Iterable[RepoRule],
    argv: list[str] | None = None,
) -> int:
    """CLI driver: print findings, return 1 when any survive (CI gate)."""
    del argv  # no options yet; the rule pack IS the configuration
    findings = run_rules(root, module_rules, repo_rules)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in iter_py_files(root))
    if findings:
        print(
            f"analyze: {len(findings)} finding(s) across {n_files} files",
            file=sys.stderr,
        )
        return 1
    print(f"analyze: {n_files} files clean")
    return 0


# --------------------------------------------------------------- AST helpers
def const_str(node: ast.AST) -> str | None:
    """The literal string value of a Constant-str node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def dict_str_keys(node: ast.AST) -> list[tuple[str, int]] | None:
    """(key, lineno) pairs of a dict display whose keys are all str
    constants; None when ``node`` is not such a dict."""
    if not isinstance(node, ast.Dict):
        return None
    out = []
    for k in node.keys:
        s = const_str(k) if k is not None else None
        if s is None:
            return None
        out.append((s, k.lineno))
    return out


def frozenset_str_items(node: ast.AST) -> set[str] | None:
    """Items of a ``frozenset({...})`` / ``frozenset((...))`` literal of str
    constants; None when the node has a different shape."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "frozenset"
        and len(node.args) == 1
    ):
        arg = node.args[0]
        if isinstance(arg, (ast.Set, ast.Tuple, ast.List)):
            items = set()
            for e in arg.elts:
                s = const_str(e)
                if s is None:
                    return None
                items.add(s)
            return items
    return None


def is_set_expr(node: ast.AST) -> bool:
    """Syntactically set-valued: a set display/comprehension or a direct
    ``set(...)`` / ``frozenset(...)`` call."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False
