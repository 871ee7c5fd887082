"""noslint core: file model, pragma suppression, rule runner.

The framework half of the project-native checker (docs/static-analysis.md).
Rules live in nos_tpu_torch/analysis/rules.py; this module owns everything rule
authors share:

- ``ModuleSource``: one parsed file (path, source, AST, line table);
- ``Violation``: a finding, anchored to a file:line;
- pragma handling: ``# noslint: N001 — reason`` suppresses the named
  rule(s) on its own line or, as a standalone comment, on the next code
  line.  A pragma **must carry a reason** (the text after the dash/colon);
  a bare ``# noslint: N001`` is itself reported (rule N000) so
  suppressions stay auditable;
- ``run(...)``: parse files once, run every rule's per-file ``check``,
  then the cross-file ``finalize`` phase (label-consistency style rules),
  and apply suppressions to the merged result.

Design notes.  Rules are AST-based and single-pass — `bugs as deviant
behavior` checking, not a type system: each rule encodes one invariant
this codebase has already paid for breaking, with the false-positive
knobs (scope prefixes, excludes) kept in the rule, not the framework.
Generated protobuf modules (``*_pb2.py``) are never linted.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Iterator

#: Rule id reserved for the framework itself (invalid pragmas).
FRAMEWORK_RULE = "N000"

_PRAGMA_RE = re.compile(
    r"#\s*noslint:\s*"
    r"(?P<rules>[A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)"
    r"\s*(?:[-—–:]\s*(?P<reason>\S.*))?")

#: Files never linted: generated code.
GENERATED_SUFFIXES = ("_pb2.py",)


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Pragma:
    rules: frozenset[str]
    reason: str
    line: int          # the line the pragma comment sits on


class ModuleSource:
    """One file: source text, AST, and the pragma table.

    ``suppressed_at(line)`` returns the rule ids silenced on that line —
    a pragma covers its own line plus, when the pragma is the whole line
    (a standalone comment), the next line, so block statements can carry
    the pragma just above them.
    """

    def __init__(self, path: str, relpath: str, source: str) -> None:
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.pragmas: list[Pragma] = []
        self._by_line: dict[int, set[str]] = {}
        self._collect_pragmas()

    def _collect_pragmas(self) -> None:
        # Real COMMENT tokens only — a pragma *example* quoted in a
        # docstring must not silence anything.
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            i = tok.start[0]
            rules = frozenset(
                r.strip() for r in m.group("rules").split(","))
            pragma = Pragma(rules=rules, reason=(m.group("reason") or ""),
                            line=i)
            self.pragmas.append(pragma)
            covered = {i}
            if self.lines[i - 1][:tok.start[1]].strip() == "":
                covered.add(i + 1)      # standalone comment: next line too
            for line in covered:
                self._by_line.setdefault(line, set()).update(rules)

    def suppressed_at(self, line: int) -> set[str]:
        return self._by_line.get(line, set())


class Rule:
    """Base class for noslint rules.

    ``check(mod)`` yields per-file violations.  Rules needing the whole
    tree (cross-file registries) accumulate state in ``check`` and yield
    from ``finalize``; ``finalize`` violations are still suppressible at
    the line they anchor to.  ``scope``/``exclude`` are repo-relative
    path prefixes (empty scope = everywhere).
    """

    id: str = ""
    title: str = ""
    scope: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()
    #: True for rules whose verdicts need the WHOLE tree (finalize-phase
    #: registries): the result cache (analysis/cache.py) must re-run them
    #: every time, because another file's change can move their verdicts.
    cross_file: bool = False

    def applies_to(self, mod: ModuleSource) -> bool:
        rel = mod.relpath
        if any(rel.startswith(p) for p in self.exclude):
            return False
        return not self.scope or any(rel.startswith(p) for p in self.scope)

    def check(self, mod: ModuleSource) -> Iterable[Violation]:
        return ()

    def finalize(self) -> Iterable[Violation]:
        return ()


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into lintable .py paths (sorted, stable)."""
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py") and not _generated(path):
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d for d in dirs
                if d not in ("__pycache__", ".git", "build"))
            for name in sorted(files):
                if name.endswith(".py") and not _generated(name):
                    yield os.path.join(root, name)


def _generated(name: str) -> bool:
    return any(name.endswith(s) for s in GENERATED_SUFFIXES)


def load_module(path: str, root: str) -> ModuleSource:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return ModuleSource(path, os.path.relpath(path, root), source)


@dataclass
class Report:
    violations: list[Violation] = field(default_factory=list)
    suppressed: list[Violation] = field(default_factory=list)
    files: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations


def run(rules: Iterable[Rule], paths: Iterable[str],
        root: str | None = None, cache=None) -> Report:
    """Lint ``paths`` with ``rules``; returns the merged, pragma-filtered
    report.  ``root`` anchors repo-relative paths (defaults to cwd).

    ``cache`` (analysis/cache.py ResultCache) skips the per-file rules on
    files whose content hash matches a stored entry.  Cross-file rules
    (``cross_file = True``) always run — their verdicts can move when
    ANY file changes, so only their per-file accumulation is repeated,
    never cached.  A rule that accumulates ``finalize`` state across
    files MUST set ``cross_file`` or the cache will starve it."""
    root = root or os.getcwd()
    rules = list(rules)
    per_file_rules = [r for r in rules if not r.cross_file]
    cross_rules = [r for r in rules if r.cross_file]
    mods: list[ModuleSource] = []
    report = Report()
    for path in iter_python_files(paths):
        try:
            mods.append(load_module(path, root))
        except SyntaxError as e:
            report.violations.append(Violation(
                FRAMEWORK_RULE, os.path.relpath(path, root),
                e.lineno or 1, f"syntax error: {e.msg}"))
    report.files = len(mods)
    by_path = {m.relpath: m for m in mods}

    raw: list[Violation] = []
    for mod in mods:
        file_hash = cache.content_hash(mod.source) if cache else ""
        per = cache.get(mod.relpath, file_hash) if cache else None
        if per is None:
            per = list(_pragma_violations(mod))
            for rule in per_file_rules:
                if rule.applies_to(mod):
                    per.extend(rule.check(mod))
            if cache is not None:
                cache.put(mod.relpath, file_hash, per)
        raw.extend(per)
        for rule in cross_rules:
            if rule.applies_to(mod):
                raw.extend(rule.check(mod))
    for rule in rules:
        raw.extend(rule.finalize())

    seen: set[tuple[str, str, int, str]] = set()
    for v in raw:
        # dataflow paths can judge one source line more than once (the
        # finally-inlining copies); identical findings collapse to one
        key = (v.rule, v.path, v.line, v.message)
        if key in seen:
            continue
        seen.add(key)
        mod = by_path.get(v.path)
        if mod is not None and v.rule in mod.suppressed_at(v.line):
            report.suppressed.append(v)
        else:
            report.violations.append(v)
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return report


def _pragma_violations(mod: ModuleSource) -> Iterator[Violation]:
    for pragma in mod.pragmas:
        if not pragma.reason:
            yield Violation(
                FRAMEWORK_RULE, mod.relpath, pragma.line,
                "noslint pragma without a reason — write "
                "'# noslint: <rule> — <why this is intentional>'")


def lint_source(source: str, rules: Iterable[Rule],
                relpath: str = "nos_tpu_torch/fixture.py") -> list[Violation]:
    """Lint one in-memory snippet (the analyzer's own test surface).

    ``relpath`` places the snippet for scope matching — rules only fire
    where they would fire in the tree.  Cross-file rules get a fresh
    instance per call in tests, so ``finalize`` state does not leak.
    """
    mod = ModuleSource(relpath, relpath, source)
    out: list[Violation] = list(_pragma_violations(mod))
    rules = list(rules)
    for rule in rules:
        if rule.applies_to(mod):
            out.extend(rule.check(mod))
    for rule in rules:
        out.extend(rule.finalize())
    seen: set[tuple[str, str, int, str]] = set()
    kept: list[Violation] = []
    for v in out:
        # same identical-finding collapse as run() — the dataflow
        # finally-inlining copies can judge one line more than once
        key = (v.rule, v.path, v.line, v.message)
        if key in seen or v.rule in mod.suppressed_at(v.line):
            continue
        seen.add(key)
        kept.append(v)
    return kept
