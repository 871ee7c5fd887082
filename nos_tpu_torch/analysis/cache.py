"""Per-file result cache for noslint — content-hashed, rule-versioned.

The dataflow rules (CFG + fixpoint per function) make the sweep
meaningfully heavier than the single-pass tokenize/AST rules, and the
CLI runs it on every invocation.  This cache keeps the *per-file* rule
results keyed by

- the file's content hash (sha256 of the bytes), and
- the **rules signature** — a hash over the analysis package's own
  sources plus the rule id list, so editing any rule/engine file
  invalidates every entry (a cache that survives a rule change would
  certify with stale rules).

Cross-file rules (``Rule.cross_file = True``: N003's metric registry,
N009's symbol index) are NEVER cached — another file's change can move
their verdicts, so ``core.run`` re-runs them over every parsed module on
every sweep.  What the cache skips is exactly the expensive part: the
per-file dataflow passes on unchanged files.

Layout: ``.noslint_torch_cache/<slug>.json`` at the repo root (its own
directory, never shared with the JAX package's analyzer), one entry per
source file, overwritten in place (no growth beyond the tree's file
count).  The directory is disposable; ``--no-cache`` bypasses it and a
corrupt/alien entry is treated as a miss, never an error.
"""

from __future__ import annotations

import hashlib
import json
import os

from .core import Violation

CACHE_DIR_NAME = ".noslint_torch_cache"

#: bump manually on format changes (entry shape, Violation fields)
_FORMAT = 2


def _analysis_sources() -> list[str]:
    pkg = os.path.dirname(os.path.abspath(__file__))
    return sorted(
        os.path.join(pkg, f) for f in os.listdir(pkg)
        if f.endswith(".py"))


def rules_signature(rule_ids: list[str]) -> str:
    """Hash of the analyzer itself + the active rule set: any edit to
    the engine or a rule invalidates every cached entry."""
    h = hashlib.sha256()
    h.update(f"format={_FORMAT};rules={','.join(sorted(rule_ids))}"
             .encode())
    for path in _analysis_sources():
        with open(path, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return h.hexdigest()


class ResultCache:
    """get/put of per-file violation lists (see module docstring)."""

    def __init__(self, root: str, signature: str) -> None:
        self.dir = os.path.join(root, CACHE_DIR_NAME)
        self.signature = signature
        self.hits = 0
        self.misses = 0

    @staticmethod
    def content_hash(source: str) -> str:
        return hashlib.sha256(source.encode("utf-8")).hexdigest()

    def _entry_path(self, relpath: str) -> str:
        slug = relpath.replace("/", "__").replace("\\", "__")
        return os.path.join(self.dir, slug + ".json")

    def get(self, relpath: str, content_hash: str) -> list[Violation] | None:
        """The cached per-file violations, or None on any miss
        (absent, stale hash, stale signature, or unreadable)."""
        try:
            with open(self._entry_path(relpath), encoding="utf-8") as f:
                entry = json.load(f)
        except (OSError, ValueError):
            self.misses += 1
            return None
        if entry.get("sig") != self.signature \
                or entry.get("hash") != content_hash:
            self.misses += 1
            return None
        try:
            out = [Violation(v["rule"], v["path"], v["line"], v["message"])
                   for v in entry["violations"]]
        except (KeyError, TypeError):
            self.misses += 1
            return None
        self.hits += 1
        return out

    def put(self, relpath: str, content_hash: str,
            violations: list[Violation]) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError:
            return   # read-only checkout: cacheless, never failure
        entry = {
            "sig": self.signature,
            "hash": content_hash,
            "violations": [vars(v) for v in violations],
        }
        path = self._entry_path(relpath)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(entry, f)
            os.replace(tmp, path)      # atomic on POSIX: no torn entries
        except OSError:
            # a read-only checkout degrades to cacheless, never to failure
            try:
                os.unlink(tmp)
            except OSError:
                pass
