"""``python -m nos_tpu_torch.analysis --fix``: autofixes for mechanical findings.

Only *mechanical* findings are auto-fixed — ones whose fix is the single
obvious edit the rule message already dictates:

- **N006 unused imports** — the named alias is removed from its import
  statement (the whole statement when no alias remains).  Multi-line
  ``from x import (a, b)`` statements are rewritten canonically via
  ``ast.unparse``; the fix never touches an import whose finding is
  pragma-suppressed, and a *partial* rewrite is skipped when the
  statement carries any comment (unparse would destroy it — and a
  destroyed ``# noslint`` pragma for another rule would silently drop
  an audited suppression).  The skipped finding stays in the lint
  output for a human.
- **N000 naked pragmas** — a ``# noslint: NXXX`` with no reason is
  *removed*, not padded with a placeholder: the pragma still suppressed
  its rule while being itself a violation, so deleting it re-surfaces
  the underlying finding for a human to either fix or justify.  An
  autofix that invented a reason would launder the suppression.

Everything else (N001–N005, N007–N010) needs judgment and stays manual.
The fixer is idempotent: running it twice changes nothing the second
time (tests/test_analysis.py pins this).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from .core import ModuleSource, _PRAGMA_RE, load_module
from .rules import NameHygiene

_UNUSED_RE = re.compile(r"unused import '([^']+)'")


def _binds(node: ast.stmt, name: str) -> bool:
    for alias in node.names:            # type: ignore[attr-defined]
        bound = alias.asname or (
            alias.name.split(".")[0] if isinstance(node, ast.Import)
            else alias.name)
        if bound == name:
            return True
    return False


def _drop_aliases(node: ast.stmt, names: set[str]) -> ast.stmt | None:
    """A copy of the import node without ``names``; None if empty."""
    kept = []
    for alias in node.names:            # type: ignore[attr-defined]
        bound = alias.asname or (
            alias.name.split(".")[0] if isinstance(node, ast.Import)
            else alias.name)
        if bound not in names:
            kept.append(alias)
    if not kept:
        return None
    if isinstance(node, ast.Import):
        return ast.Import(names=kept)
    return ast.ImportFrom(module=node.module, names=kept, level=node.level)


def _comment_lines(source: str) -> set[int]:
    """1-based line numbers carrying a comment token."""
    out: set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.add(tok.start[0])
    except (tokenize.TokenError, IndentationError):
        pass                            # fix_file parse-gates anyway
    return out


def _fix_unused_imports(mod: ModuleSource) -> tuple[str, list[str]]:
    """(new source, fix descriptions) — removes unsuppressed N006
    unused-import findings from the module's source text."""
    rule = NameHygiene()
    if not rule.applies_to(mod):
        return mod.source, []
    unused: list[tuple[int, str]] = []
    for v in rule.check(mod):
        m = _UNUSED_RE.search(v.message)
        if m and v.rule not in mod.suppressed_at(v.line):
            unused.append((v.line, m.group(1)))
    if not unused:
        return mod.source, []

    lines = mod.source.splitlines(keepends=True)
    commented = _comment_lines(mod.source)
    fixes: list[str] = []
    # collect edits per import node, then apply bottom-up
    edits: list[tuple[int, int, list[str]]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        end = node.end_lineno or node.lineno
        drop = {nm for (ln, nm) in unused
                if node.lineno <= ln <= end and _binds(node, nm)}
        if not drop:
            continue
        replacement = _drop_aliases(node, drop)
        if replacement is not None and any(
                ln in commented for ln in range(node.lineno, end + 1)):
            # a partial unparse-rewrite would erase the comment (or an
            # audited pragma for another rule); leave the finding to a
            # human — removing the WHOLE statement keeps its comments'
            # fate tied to the import they annotate, so that still runs
            continue
        indent = lines[node.lineno - 1][: len(lines[node.lineno - 1])
                                        - len(lines[node.lineno - 1]
                                              .lstrip())]
        if replacement is None:
            new_lines: list[str] = []
        else:
            new_lines = [indent + ast.unparse(replacement) + "\n"]
        edits.append((node.lineno, end, new_lines))
        fixes.extend(f"{mod.relpath}:{node.lineno}: removed unused "
                     f"import {nm!r}" for nm in sorted(drop))
    for start, end, new_lines in sorted(edits, reverse=True):
        lines[start - 1:end] = new_lines
    return "".join(lines), fixes


def _fix_naked_pragmas(mod: ModuleSource) -> tuple[str, list[str]]:
    """(new source, fix descriptions) — deletes reason-less pragmas so
    the suppressed finding re-surfaces (see module docstring)."""
    naked = [p for p in mod.pragmas if not p.reason]
    if not naked:
        return mod.source, []
    lines = mod.source.splitlines(keepends=True)
    fixes: list[str] = []
    for pragma in sorted(naked, key=lambda p: p.line, reverse=True):
        i = pragma.line - 1
        line = lines[i]
        newline = "\n" if line.endswith("\n") else ""
        stripped = _PRAGMA_RE.sub("", line).rstrip()
        if stripped.endswith("#"):
            stripped = stripped.rstrip("#").rstrip()
        if not stripped.strip():
            del lines[i]               # the pragma was the whole line
        else:
            lines[i] = stripped + newline
        fixes.append(f"{mod.relpath}:{pragma.line}: removed naked "
                     f"pragma ({', '.join(sorted(pragma.rules))}) — the "
                     "suppressed finding re-surfaces; fix it or justify "
                     "the pragma")
    return "".join(lines), fixes


def fix_file(path: str, root: str) -> list[str]:
    """Apply every mechanical fix to one file in place; returns the fix
    descriptions (empty = nothing to do).  Runs each fixer to its own
    fixpoint via re-parse, so line numbers never go stale."""
    fixes: list[str] = []
    # pragma deletion FIRST: a naked pragma suppressing an auto-fixable
    # N006 re-surfaces it for the import fixer in this same run — the
    # opposite order needs a second run to converge (idempotency pin)
    for fixer in (_fix_naked_pragmas, _fix_unused_imports):
        mod = load_module(path, root)
        new_source, done = fixer(mod)
        if done and new_source != mod.source:
            # refuse to write anything that no longer parses — an
            # autofix must never trade a finding for a syntax error
            ast.parse(new_source)
            with open(path, "w", encoding="utf-8") as f:
                f.write(new_source)
            fixes.extend(done)
    return fixes
