"""CLI driver: ``python -m nos_tpu_torch.analysis [paths ...]``.

Exit status 0 = clean (the CI/tier-1 contract), 1 = violations.
``--format json`` emits machine-readable findings for tooling;
``--list-rules`` prints the catalog; ``--show-suppressed`` audits what
the pragmas are hiding; ``--fix`` applies the mechanical autofixes
(fix.py) before linting; ``--no-cache`` bypasses the per-file result
cache (``.noslint_torch_cache/``, see cache.py); ``--changed-only`` lints
just the files changed against the git merge-base (the pre-commit
mode — composes with the cache, cross-file rules still see the full
tree they need via their registries); ``--determinism`` runs the
dual-run journal diff harness (determinism.py) instead of linting.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .cache import ResultCache, rules_signature
from .core import iter_python_files, run
from .rules import default_rules


def _changed_python_files(repo_root: str, scope: list[str]) -> list[str]:
    """Python files changed against the git merge-base (committed on
    this branch, staged, unstaged, and untracked), restricted to
    ``scope``.  On the default branch itself the base degenerates to
    HEAD, which is exactly the pre-commit contract: lint what this
    commit is about to change."""
    import subprocess

    def git(*args: str) -> "subprocess.CompletedProcess[str]":
        return subprocess.run(["git", "-C", repo_root, *args],
                              capture_output=True, text=True)

    base = None
    for ref in ("origin/main", "origin/master", "main", "master"):
        r = git("merge-base", "HEAD", ref)
        if r.returncode == 0:
            base = r.stdout.strip()
            break
    head = git("rev-parse", "HEAD").stdout.strip()
    if not base or base == head:
        base = "HEAD"
    names: set[str] = set()
    names.update(
        git("diff", "--name-only", "--diff-filter=ACMR",
            base).stdout.split())
    names.update(
        git("ls-files", "--others", "--exclude-standard").stdout.split())
    scope_abs = [os.path.abspath(s) for s in scope]
    out = []
    for name in sorted(names):
        if not name.endswith(".py"):
            continue
        path = os.path.abspath(os.path.join(repo_root, name))
        if not os.path.isfile(path):
            continue
        if any(path == s or path.startswith(s + os.sep)
               for s in scope_abs):
            out.append(path)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nos_tpu_torch.analysis",
        description="noslint: project-native invariant checks (N001-N012)")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the nos_tpu_torch "
                        "package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print pragma-suppressed findings")
    parser.add_argument("--fix", action="store_true",
                        help="apply mechanical autofixes (N006 unused "
                        "imports, N000 naked pragmas) in place, then lint")
    parser.add_argument("--no-cache", action="store_true",
                        help="bypass the .noslint_torch_cache/ result cache")
    parser.add_argument("--changed-only", action="store_true",
                        help="lint only files changed vs the git "
                        "merge-base (pre-commit mode; composes with "
                        "the cache)")
    parser.add_argument("--determinism", action="store_true",
                        help="run the dual-run journal diff harness "
                        "(PYTHONHASHSEED x plan_workers matrix) "
                        "instead of linting")
    parser.add_argument("--determinism-child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--plan-workers", type=int, default=1,
                        help=argparse.SUPPRESS)
    parser.add_argument("--incremental", choices=("on", "off"),
                        default="on", help=argparse.SUPPRESS)
    parser.add_argument("--cycles", type=int, default=2,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.determinism_child:
        from .determinism import child_main

        return child_main(args.plan_workers, args.cycles,
                          incremental=(args.incremental == "on"))
    if args.determinism:
        from .determinism import main_determinism

        return main_determinism(fmt=args.format, cycles=args.cycles)

    rules = default_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.id}  {rule.title}")
        return 0

    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(os.path.dirname(pkg_dir))
    paths = args.paths or [os.path.dirname(pkg_dir)]

    if args.changed_only:
        paths = _changed_python_files(repo_root, paths)
        if not paths:
            print("noslint: --changed-only: no changed python files "
                  "in scope")
            return 0

    if args.fix:
        from .fix import fix_file

        for path in iter_python_files(paths):
            try:
                fixed = fix_file(path, repo_root)
            except SyntaxError as e:
                # the lint pass below reports it as N000; keep fixing
                # the REST of the tree instead of dying mid-sweep
                print(f"skip (syntax error): {path}:{e.lineno}",
                      file=sys.stderr)
                continue
            for line in fixed:
                # stderr: --format json promises ONE document on stdout
                print(f"fixed: {line}", file=sys.stderr)

    cache = None
    if not args.no_cache:
        cache = ResultCache(repo_root,
                            rules_signature([r.id for r in rules]))
    report = run(rules, paths, root=repo_root, cache=cache)

    if args.format == "json":
        print(json.dumps({
            "files": report.files,
            "violations": [vars(v) for v in report.violations],
            "suppressed": [vars(v) for v in report.suppressed],
        }, indent=2))
    else:
        for v in report.violations:
            print(v.render())
        if args.show_suppressed:
            for v in report.suppressed:
                print(f"[suppressed] {v.render()}")
        cache_note = ""
        if cache is not None and (cache.hits or cache.misses):
            cache_note = (f", cache {cache.hits} hit(s) / "
                          f"{cache.misses} miss(es)")
        print(f"noslint: {report.files} file(s), "
              f"{len(report.violations)} violation(s), "
              f"{len(report.suppressed)} suppressed{cache_note}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
