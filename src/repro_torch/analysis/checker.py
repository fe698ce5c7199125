"""avecheck static-analyzer core: file model, annotations, runner.

The analyzer is AST-based and repo-specific: it encodes the ownership and
locking conventions of the AVEC data plane (see
``repro_torch.core.memory``'s lease rules and the ``guarded-by`` discipline) as
mechanical checks.  Annotation syntax, all in ordinary comments:

* ``# guarded-by: _lock`` — on a ``self.attr = ...`` (or dataclass field)
  line: the attribute may only be mutated inside ``with self._lock:``.
* ``# avecheck: handoff`` — on a statement that transfers ownership of a
  lease to another component (the coalescer enqueue, a finalizer
  registration): satisfies the lease-balance rule for that lease.
* ``# avecheck: ignore[rule1,rule2] -- reason`` — suppress findings of the
  named rule(s) on that line; on a ``def`` line it covers the whole
  function.  The justification is mandatory: a reasonless suppression is
  itself a finding.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Optional

RULES = ("lease", "lock", "block", "wire")

_IGNORE_RE = re.compile(
    r"avecheck:\s*ignore\[([a-z,\s_-]+)\]\s*(?:--\s*(\S.*))?")
_HANDOFF_RE = re.compile(r"avecheck:\s*handoff\b")
_GUARD_RE = re.compile(r"guarded-by:\s*(\w+)")


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False

    def __str__(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.message}"


@dataclass
class Suppression:
    rules: set
    reason: Optional[str]
    used: bool = False


class SourceFile:
    """One parsed module plus its avecheck comment annotations."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.comments: dict[int, str] = {}
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                self.comments[tok.start[0]] = tok.string
        self.suppressions: dict[int, Suppression] = {}
        self.handoff_lines: set[int] = set()
        self.guard_lines: dict[int, str] = {}
        for line, text in self.comments.items():
            m = _IGNORE_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressions[line] = Suppression(rules, m.group(2))
            if _HANDOFF_RE.search(text):
                self.handoff_lines.add(line)
            g = _GUARD_RE.search(text)
            if g:
                self.guard_lines[line] = g.group(1)
        # parent links for context queries
        self._parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parent[child] = node

    # -- structure queries ------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parent.get(node)

    def enclosing_function(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parent(cur)
        return None

    def exception_context(self, node: ast.AST, within: ast.AST) -> str:
        """'finally' | 'except' | 'normal' for ``node``, looking no further
        up than ``within`` (usually the enclosing function)."""
        cur, prev = self.parent(node), node
        while cur is not None and prev is not within:
            if isinstance(cur, ast.Try):
                if any(prev is h or _contains(h, prev) for h in cur.handlers):
                    return "except"
                if prev in cur.finalbody or any(
                        _contains(s, prev) for s in cur.finalbody):
                    return "finally"
            prev, cur = cur, self.parent(cur)
        return "normal"

    def held_locks(self, node: ast.AST) -> list[str]:
        """Source text of every ``with`` context expression lexically
        enclosing ``node`` (innermost last), e.g. ``["self._cv"]``."""
        held: list[str] = []
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    try:
                        held.append(ast.unparse(item.context_expr))
                    except Exception:
                        pass
            cur = self.parent(cur)
        return held

    # -- annotation queries -----------------------------------------------
    def is_handoff(self, lineno: int) -> bool:
        return lineno in self.handoff_lines

    def suppressed(self, rule: str, node: ast.AST) -> bool:
        """True if ``rule`` is suppressed at ``node``'s line, at the first
        line of its enclosing simple statement, or function-wide on the
        enclosing ``def`` line."""
        lines = {getattr(node, "lineno", 0)}
        stmt = node
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = self.parent(stmt)
        if stmt is not None:
            lines.add(stmt.lineno)
        fn = self.enclosing_function(node)
        if fn is not None:
            lines.add(fn.lineno)
        for line in lines:
            sup = self.suppressions.get(line)
            if sup and rule in sup.rules:
                sup.used = True
                return True
        return False


def _contains(root: ast.AST, node: ast.AST) -> bool:
    return any(n is node for n in ast.walk(root))


def local_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk ``fn``'s body excluding nested function/class bodies (each is
    analyzed on its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class Project:
    """All files under analysis — cross-file rules (wire-error
    completeness) see the whole set."""

    def __init__(self, files: list[SourceFile]) -> None:
        self.files = files

    @classmethod
    def load(cls, paths: Iterable[str]) -> "Project":
        seen: dict[str, SourceFile] = {}
        for p in paths:
            root = Path(p)
            candidates = [root] if root.is_file() else sorted(
                f for f in root.rglob("*.py") if "__pycache__" not in f.parts)
            for f in candidates:
                key = str(f)
                if key not in seen:
                    seen[key] = SourceFile(key, f.read_text())
        return cls(list(seen.values()))


def run_paths(paths: Iterable[str]) -> list[Finding]:
    """Run every rule over ``paths``; returns all findings (suppressed ones
    included, flagged).  Reasonless suppressions and unused suppressions of
    real rule names surface as ``meta`` findings so the baseline can't rot."""
    from repro_torch.analysis import rules as _rules

    project = Project.load(paths)
    findings: list[Finding] = []
    for rule_fn in (_rules.lease_rule, _rules.lock_rule, _rules.block_rule):
        for sf in project.files:
            findings.extend(rule_fn(sf, project))
    findings.extend(_rules.wire_rule(project))
    for sf in project.files:
        for line, sup in sorted(sf.suppressions.items()):
            unknown = sup.rules - set(RULES)
            if unknown:
                findings.append(Finding(
                    sf.path, line, "meta",
                    f"suppression names unknown rule(s) {sorted(unknown)}; "
                    f"known rules: {', '.join(RULES)}"))
            if not sup.reason:
                findings.append(Finding(
                    sf.path, line, "meta",
                    "suppression without justification: write "
                    "`# avecheck: ignore[rule] -- reason`"))
            elif (sup.rules & set(RULES)) and not sup.used:
                findings.append(Finding(
                    sf.path, line, "meta",
                    f"unused suppression for {sorted(sup.rules)}: no finding "
                    f"here any more — delete it"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
