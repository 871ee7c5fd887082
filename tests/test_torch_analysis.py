"""noslint for the port (``nos_tpu_torch/analysis/``) against the JAX
package's analyzer (``nos_tpu/analysis/``).

- **the gate**: rules N001–N012 over the whole ``nos_tpu_torch/`` tree;
  any unsuppressed violation fails tier-1, and ``python -m
  nos_tpu_torch.analysis`` exits 0;
- **tree parity**: ``nos_tpu/`` copied as ``nos_tpu_torch/`` with only
  its package names rewritten gives the port's analyzer JAX's report
  over ``nos_tpu/``: the same files, no violation, the same suppressed
  (rule, file, line) set;
- **per-rule fixtures** (``tests/test_analysis.py``'s cases): each case
  runs under both analyzers (the ``an`` fixture).  Under the port's,
  ``Analyzer.lint`` also lints the snippet with JAX's analyzer and
  asserts the same (rule, line, path, message) list once the package
  name is mapped, so a case pins JAX's expectations on both and their
  agreement;
- the CLI (``--list-rules``, ``--format json``, ``--fix``,
  ``--changed-only``), the result cache and its key.

The lock checker's unit tests live in ``tests/test_torch_cmd.py``
(``LOCK_STORIES``, verdicts held against JAX's); the two of
``tests/test_analysis.py``'s that it lacks are here.
``tests/test_torch_dataflow.py`` and ``tests/test_torch_rules_det.py``
import ``Analyzer`` and the ``an`` fixture's parameters from here.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest

pytestmark = pytest.mark.analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "nos_tpu"
PORT = "nos_tpu_torch"
PKGS = (JAX, PORT)

_PKG_RE = re.compile(r"\bnos_tpu(?=[./])")


def in_pkg(text: str, pkg: str) -> str:
    """``text`` with the JAX package's dotted and path names moved to
    ``pkg`` (``nos_tpu.x`` / ``nos_tpu/x``; metric names, ``nos_tpu_``,
    stay)."""
    return _PKG_RE.sub(pkg, text)


def rules_of(v):
    return [x.rule for x in v]


class Analyzer:
    """One package's analyzer, addressed by its package name."""

    def __init__(self, pkg: str) -> None:
        self.pkg = pkg

        def mod(name: str):
            return importlib.import_module(f"{pkg}.analysis{name}")

        self.api = mod("")
        self.core = mod(".core")
        self.rules = mod(".rules")
        self.flow = mod(".rules_flow")
        self.det = mod(".rules_det")
        self.dataflow = mod(".dataflow")
        self.cache = mod(".cache")
        self.fix = mod(".fix")
        self.cli = mod(".__main__")

    def __repr__(self) -> str:
        return self.pkg

    def rel(self, text: str) -> str:
        return in_pkg(text, self.pkg)

    def module(self, name: str):
        """This package's module ``name`` (``utils.guards``, ...)."""
        return importlib.import_module(f"{self.pkg}.{name}")

    def rule(self, name: str):
        for module in (self.rules, self.flow, self.det):
            if hasattr(module, name):
                return getattr(module, name)
        raise AttributeError(name)

    def _lint(self, src: str, rules, relpath: str):
        return self.core.lint_source(
            self.rel(src), [self.rule(r)() for r in rules],
            relpath=self.rel(relpath))

    def lint(self, src: str, *rules: str,
             relpath: str = "nos_tpu/fixture.py"):
        """``lint_source`` of ``src`` (JAX's form: ``nos_tpu`` names are
        mapped to this package) with fresh instances of the named rules;
        under the port, also held to JAX's findings on the same
        snippet."""
        got = self._lint(src, rules, relpath)
        if self.pkg != JAX:
            want = ANALYZERS[JAX]._lint(src, rules, relpath)
            assert [(v.rule, v.line, v.path, v.message) for v in got] == [
                (v.rule, v.line, self.rel(v.path), self.rel(v.message))
                for v in want]
        return got


ANALYZERS = {pkg: Analyzer(pkg) for pkg in PKGS}


def anchor_cli(an: Analyzer, root, monkeypatch) -> None:
    """Make ``an``'s CLI take ``root`` for the repo holding it: the CLI
    anchors relative paths (hence rule scopes) and its cache there."""
    monkeypatch.setattr(an.cli, "__file__",
                        str(root / an.pkg / "analysis" / "__main__.py"))


@pytest.fixture(params=PKGS)
def an(request) -> Analyzer:
    return ANALYZERS[request.param]


# ---------------------------------------------------------------------------
# The gate: the port's tree is clean (and the CLI says so).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    from nos_tpu_torch.analysis import default_rules, run

    return run(default_rules(), [os.path.join(REPO_ROOT, PORT)],
               root=REPO_ROOT)


class TestTreeIsClean:
    def test_noslint_zero_violations_on_nos_tpu_torch(self, port_report):
        assert port_report.files > 150     # the sweep saw the tree
        rendered = "\n".join(v.render() for v in port_report.violations)
        assert port_report.ok, f"noslint violations:\n{rendered}"

    def test_every_suppression_carries_a_reason(self, port_report):
        assert not [v for v in port_report.violations if v.rule == "N000"]
        # and each honoured pragma is one the port's records list: the
        # two lease writes JAX suppresses alike, and the constants
        # module's re-export of the share prefix
        assert sorted((v.rule, v.path) for v in port_report.suppressed) == [
            ("N001", "nos_tpu_torch/kube/leaderelection.py"),
            ("N001", "nos_tpu_torch/kube/leaderelection.py"),
            ("N006", "nos_tpu_torch/api/constants.py"),
        ]

    def test_cli_exits_zero_over_the_port(self):
        """The gate as a user runs it: ``python -m nos_tpu_torch.analysis``
        with no path lints ``nos_tpu_torch/`` and exits 0."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-m", "nos_tpu_torch.analysis", "--no-cache"],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        summary = proc.stdout.strip().splitlines()[-1]
        assert re.match(r"noslint: \d+ file\(s\), 0 violation\(s\), "
                        r"3 suppressed$", summary), summary

    def test_cli_lists_rules(self, an, capsys):
        assert an.cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        ids = [line.split()[0] for line in out.splitlines()]
        assert ids == [f"N{i:03d}" for i in range(1, 13)]


class TestTreeParity:
    def test_renamed_jax_tree_gives_jaxs_report(self, tmp_path):
        """The port's analyzer over ``nos_tpu/`` renamed to
        ``nos_tpu_torch/`` (package names only, so every line keeps its
        number) reports what JAX's does over ``nos_tpu/``."""
        from nos_tpu.analysis import default_rules as jax_rules
        from nos_tpu.analysis import run as jax_run
        from nos_tpu_torch.analysis import default_rules, run

        copy = tmp_path / PORT
        shutil.copytree(
            os.path.join(REPO_ROOT, JAX), copy,
            ignore=lambda d, names: [n for n in names if n == "__pycache__"
                                     or (os.path.isfile(os.path.join(d, n))
                                         and not n.endswith(".py"))])
        for path in copy.rglob("*.py"):
            path.write_text(in_pkg(path.read_text(), PORT))
        want = jax_run(jax_rules(), [os.path.join(REPO_ROOT, JAX)],
                       root=REPO_ROOT)
        got = run(default_rules(), [str(copy)], root=str(tmp_path))
        assert got.files == want.files > 150
        assert want.violations == [] and got.violations == []
        assert len(want.suppressed) == 6
        assert sorted((v.rule, v.path, v.line) for v in got.suppressed) \
            == sorted((v.rule, in_pkg(v.path, PORT), v.line)
                      for v in want.suppressed)


# ---------------------------------------------------------------------------
# N001: retry-wrapped writes
# ---------------------------------------------------------------------------

class TestN001:
    def test_flags_raw_patch_and_update(self, an):
        src = (
            "def f(api, cm):\n"
            "    api.patch('Node', 'n', mutate=lambda o: None)\n"
            "    api.update(KIND_CONFIGMAP, cm)\n"
        )
        assert rules_of(an.lint(src, "RetryWrappedWrites")) == \
            ["N001", "N001"]

    def test_wrapped_and_dict_update_are_clean(self, an):
        src = (
            "from nos_tpu.utils.retry import retry_on_conflict\n"
            "def f(api, d):\n"
            "    retry_on_conflict(api, 'Node', 'n', lambda o: None)\n"
            "    d.update({'a': 1})\n"
            "    obj.metadata.annotations.update(extra)\n"
        )
        assert an.lint(src, "RetryWrappedWrites") == []

    def test_substrate_and_super_calls_exempt(self, an):
        src = (
            "class Chaos:\n"
            "    def patch(self, kind, name, ns='', *, mutate=None):\n"
            "        return super().patch(kind, name, ns, mutate=mutate)\n"
        )
        assert an.lint(src, "RetryWrappedWrites") == []
        raw = "api.patch('Node', 'n', mutate=m)\n"
        assert an.lint(raw, "RetryWrappedWrites",
                       relpath="nos_tpu/kube/rest.py") == []

    def test_pragma_suppresses_with_reason(self, an):
        src = (
            "def f(api, cm):\n"
            "    # noslint: N001 — CAS loss is semantically a lost election\n"
            "    api.update(KIND_CONFIGMAP, cm)\n"
        )
        assert an.lint(src, "RetryWrappedWrites") == []

    def test_pragma_without_reason_is_flagged(self, an):
        src = (
            "def f(api, cm):\n"
            "    api.update(KIND_CONFIGMAP, cm)  # noslint: N001\n"
        )
        # N001 suppressed, but the naked pragma itself is an N000
        assert rules_of(an.lint(src, "RetryWrappedWrites")) == ["N000"]


# ---------------------------------------------------------------------------
# N002: injectable clock
# ---------------------------------------------------------------------------

class TestN002:
    REL = "nos_tpu/controllers/foo.py"

    def test_flags_raw_time_calls(self, an):
        src = (
            "import time\n"
            "from time import sleep\n"
            "def tick():\n"
            "    t = time.time()\n"
            "    sleep(1)\n"
            "    time.monotonic()\n"
        )
        v = an.lint(src, "InjectableClock", relpath=self.REL)
        assert rules_of(v) == ["N002", "N002", "N002"]

    def test_injectable_default_reference_is_clean(self, an):
        src = (
            "import time\n"
            "from typing import Callable\n"
            "class C:\n"
            "    def __init__(self, clock: Callable[[], float]"
            " = time.monotonic):\n"
            "        self._clock = clock\n"
            "    def now(self):\n"
            "        return self._clock()\n"
        )
        assert an.lint(src, "InjectableClock", relpath=self.REL) == []

    def test_out_of_scope_paths_unflagged(self, an):
        src = "import time\nt = time.time()\n"
        assert an.lint(src, "InjectableClock",
                       relpath="nos_tpu/exporter/__init__.py") == []

    def test_pragma_suppressed(self, an):
        src = (
            "import time\n"
            "# noslint: N002 — wall-clock timestamp for a log payload only\n"
            "t = time.time()\n"
        )
        assert an.lint(src, "InjectableClock", relpath=self.REL) == []


# ---------------------------------------------------------------------------
# N003: metric discipline
# ---------------------------------------------------------------------------

class TestN003:
    def test_unregistered_and_bad_name_flagged(self, an):
        src = (
            "REGISTRY.inc('nos_tpu_good_total')\n"
            "REGISTRY.inc('bad_prefix_total')\n"
        )
        msgs = [x.message for x in an.lint(src, "MetricDiscipline")]
        assert any("never registered" in m for m in msgs)
        # the port keeps JAX's metric names, so JAX's prefix
        assert any("nos_tpu_[a-z0-9_]+" in m for m in msgs)

    def test_double_describe_flagged(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_total', 'a')\n"
            "REGISTRY.describe('nos_tpu_x_total', 'b')\n"
        )
        v = an.lint(src, "MetricDiscipline")
        assert any("more than once" in x.message for x in v)

    def test_inconsistent_label_keys_flagged(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_total', 'help')\n"
            "REGISTRY.inc('nos_tpu_x_total', labels={'kind': 'a'})\n"
            "REGISTRY.inc('nos_tpu_x_total', labels={'node': 'b'})\n"
        )
        v = an.lint(src, "MetricDiscipline")
        assert any("label keys" in x.message for x in v)

    def test_consistent_usage_clean(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_total', 'help')\n"
            "REGISTRY.inc('nos_tpu_x_total', labels={'kind': 'a'})\n"
            "REGISTRY.inc('nos_tpu_x_total', 2.0, labels={'kind': 'b'})\n"
        )
        assert an.lint(src, "MetricDiscipline") == []

    def test_non_literal_name_flagged(self, an):
        v = an.lint("REGISTRY.inc(name_var)\n", "MetricDiscipline")
        assert any("string literal" in x.message for x in v)

    def test_literal_buckets_clean(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_seconds', 'h',\n"
            "                  buckets=(0.1, 1.0, 10.0))\n"
            "REGISTRY.observe('nos_tpu_x_seconds', 0.2,\n"
            "                 labels={'class': 'a'})\n"
        )
        assert an.lint(src, "MetricDiscipline") == []

    def test_non_literal_buckets_flagged(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_seconds', 'h')\n"
            "REGISTRY.observe('nos_tpu_x_seconds', 0.2, buckets=BOUNDS)\n"
        )
        v = an.lint(src, "MetricDiscipline")
        assert any("literal tuple/list" in x.message for x in v)

    def test_non_increasing_buckets_flagged(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_seconds', 'h',\n"
            "                  buckets=(1.0, 1.0, 2.0))\n"
        )
        v = an.lint(src, "MetricDiscipline")
        assert any("strictly increasing" in x.message for x in v)

    def test_conflicting_bucket_layouts_flagged(self, an):
        src = (
            "REGISTRY.describe('nos_tpu_x_seconds', 'h',\n"
            "                  buckets=(0.1, 1.0))\n"
            "REGISTRY.observe('nos_tpu_x_seconds', 0.2,\n"
            "                 buckets=(0.5, 5.0))\n"
        )
        v = an.lint(src, "MetricDiscipline")
        assert any("bucket layout" in x.message for x in v)

    def test_quantile_requires_literal_name(self, an):
        v = an.lint("REGISTRY.quantile(metric_var, 0.99)\n",
                    "MetricDiscipline")
        assert any("string literal" in x.message for x in v)

    def test_exclude_list_does_not_exempt_obs_modules(self, an):
        """The exclusions name the Registry implementation and the
        analyzer ONLY; obs/ (timeseries, slo: heavy emitters) stays in
        scope."""
        rule = an.rule("MetricDiscipline")
        for entry in rule.exclude:
            assert not entry.startswith(an.rel("nos_tpu/obs")), entry
        assert rule.exclude == (an.rel("nos_tpu/exporter/metrics.py"),
                                an.rel("nos_tpu/analysis/"))
        v = an.lint("REGISTRY.inc('nos_tpu_obs_only_total')\n",
                    "MetricDiscipline", relpath="nos_tpu/obs/fixture.py")
        assert any("never registered" in x.message for x in v)


# ---------------------------------------------------------------------------
# N004: no blocking under lock
# ---------------------------------------------------------------------------

class TestN004:
    def test_sleep_network_result_log_flagged(self, an):
        src = (
            "def f(self):\n"
            "    with self._lock:\n"
            "        time.sleep(0.1)\n"
            "        fut.result()\n"
            "        logger.warning('x')\n"
            "        subprocess.run(['ls'])\n"
        )
        assert rules_of(an.lint(src, "NoBlockingUnderLock")) == ["N004"] * 4

    def test_debug_log_and_nested_def_clean(self, an):
        src = (
            "def f(self):\n"
            "    with self._lock:\n"
            "        logger.debug('cheap when disabled')\n"
            "        x = compute()\n"
            "        def later():\n"
            "            time.sleep(1)\n"
            "    time.sleep(1)\n"
        )
        assert an.lint(src, "NoBlockingUnderLock") == []

    def test_api_locked_call_is_a_lock(self, an):
        src = (
            "def f(self):\n"
            "    with self._api.locked(), self._lock:\n"
            "        retry_on_conflict(self._api, 'Pod', 'p', m)\n"
        )
        assert rules_of(an.lint(src, "NoBlockingUnderLock")) == ["N004"]

    def test_pragma_suppressed(self, an):
        src = (
            "def f(self):\n"
            "    with _BUILD_LOCK:\n"
            "        # noslint: N004 — the lock exists to serialize this\n"
            "        subprocess.run(['make'])\n"
        )
        assert an.lint(src, "NoBlockingUnderLock") == []


# ---------------------------------------------------------------------------
# N005: swallowed exceptions
# ---------------------------------------------------------------------------

class TestN005:
    def test_bare_and_swallowed_flagged(self, an):
        src = (
            "def f():\n"
            "    try:\n"
            "        g()\n"
            "    except:\n"
            "        pass\n"
            "    try:\n"
            "        g()\n"
            "    except Exception:\n"
            "        return False\n"
        )
        assert rules_of(an.lint(src, "NoSwallowedExceptions")) == \
            ["N005", "N005"]

    def test_logged_recorded_narrow_clean(self, an):
        src = (
            "def f():\n"
            "    first = None\n"
            "    try:\n"
            "        g()\n"
            "    except Exception:\n"
            "        logger.exception('tick failed')\n"
            "    try:\n"
            "        g()\n"
            "    except BaseException as e:\n"
            "        if first is None:\n"
            "            first = e\n"
            "    try:\n"
            "        g()\n"
            "    except (ValueError, KeyError):\n"
            "        pass\n"
        )
        assert an.lint(src, "NoSwallowedExceptions") == []

    def test_pragma_suppressed(self, an):
        src = (
            "def f():\n"
            "    try:\n"
            "        g()\n"
            "    # noslint: N005 — best-effort import hook, see module doc\n"
            "    except Exception:\n"
            "        pass\n"
        )
        assert an.lint(src, "NoSwallowedExceptions") == []


# ---------------------------------------------------------------------------
# N006: name hygiene
# ---------------------------------------------------------------------------

class TestN006:
    def test_undefined_name_flagged(self, an):
        src = (
            "def main(cfg):\n"
            "    api = build_api(cfg)\n"
            "    return api\n"
        )
        v = an.lint(src, "NameHygiene")
        assert rules_of(v) == ["N006"]
        assert "build_api" in v[0].message

    def test_unused_import_flagged(self, an):
        v = an.lint("import os\nimport sys\nprint(sys.argv)\n", "NameHygiene")
        assert rules_of(v) == ["N006"]
        assert "'os'" in v[0].message

    def test_quoted_annotation_and_all_are_uses(self, an):
        src = (
            "from typing import TYPE_CHECKING\n"
            "if TYPE_CHECKING:\n"
            "    from nos_tpu.partitioning.state import PartitioningState\n"
            "from nos_tpu.kube.objects import Pod\n"
            "__all__ = ['Pod']\n"
            "def plan(p) -> 'PartitioningState': ...\n"
        )
        assert an.lint(src, "NameHygiene") == []

    def test_init_py_reexports_exempt(self, an):
        assert an.lint("from .core import Thing\n", "NameHygiene",
                       relpath="nos_tpu/foo/__init__.py") == []

    def test_pragma_suppressed(self, an):
        src = (
            "from .state import NodePartitioning"
            "  # noslint: N006 — re-export for readers\n"
        )
        assert an.lint(src, "NameHygiene") == []


# ---------------------------------------------------------------------------
# --fix: mechanical autofixes (fix.py)
# ---------------------------------------------------------------------------

class TestAutofix:
    FIXTURE = (
        "import os\n"
        "import sys, json\n"
        "from typing import (\n"
        "    Any,\n"
        "    Callable,\n"
        ")\n"
        "\n"
        "def f(api, cm):\n"
        "    # noslint: N001\n"
        "    api.update('ConfigMap', cm)\n"
        "    print(sys.argv, json.dumps({}))\n"
        "    x: Any = 1\n"
        "    return x\n"
    )

    @staticmethod
    def _module(an, tmp_path, text):
        pkg = tmp_path / an.pkg
        pkg.mkdir(exist_ok=True)
        target = pkg / "mod.py"
        target.write_text(text)
        return target

    def test_fixes_unused_imports_and_naked_pragmas(self, an, tmp_path):
        target = self._module(an, tmp_path, self.FIXTURE)
        fixes = an.fix.fix_file(str(target), str(tmp_path))
        text = target.read_text()
        assert "import os" not in text
        assert "Callable" not in text
        assert "import sys, json" in text
        assert "from typing import Any" in text
        assert "noslint" not in text
        assert len(fixes) == 3
        # still parses, and the N001 the pragma hid re-surfaces
        ast.parse(text)
        assert rules_of(an.lint(text, "RetryWrappedWrites")) == ["N001"]

    def test_idempotent(self, an, tmp_path):
        target = self._module(an, tmp_path, self.FIXTURE)
        an.fix.fix_file(str(target), str(tmp_path))
        once = target.read_text()
        assert an.fix.fix_file(str(target), str(tmp_path)) == []
        assert target.read_text() == once

    def test_cli_fix_is_idempotent_on_a_tree(self, an, tmp_path, capsys,
                                             monkeypatch):
        """``--fix`` over a fixture tree: the first run fixes, the second
        changes no file and reports no fix."""
        anchor_cli(an, tmp_path, monkeypatch)
        pkg = tmp_path / an.pkg
        (pkg / "sub").mkdir(parents=True)
        (pkg / "a.py").write_text(self.FIXTURE)
        (pkg / "sub" / "b.py").write_text("import os  # noslint: N006\n"
                                          "x = 1\n")
        (pkg / "sub" / "c.py").write_text("y = 2\n")
        an.cli.main(["--fix", "--no-cache", str(pkg)])
        first = capsys.readouterr().err.count("fixed: ")
        after = {p: p.read_text() for p in pkg.rglob("*.py")}
        an.cli.main(["--fix", "--no-cache", str(pkg)])
        assert capsys.readouterr().err.count("fixed: ") == 0
        assert {p: p.read_text() for p in pkg.rglob("*.py")} == after
        assert first == 5
        assert after[pkg / "sub" / "b.py"] == "x = 1\n"

    def test_suppressed_unused_import_not_fixed(self, an, tmp_path):
        target = self._module(
            an, tmp_path, "from .state import Thing"
            "  # noslint: N006 — re-export for readers\n")
        assert an.fix.fix_file(str(target), str(tmp_path)) == []
        assert "Thing" in target.read_text()

    def test_naked_pragma_over_unused_import_converges_in_one_run(
            self, an, tmp_path):
        target = self._module(an, tmp_path,
                              "import os  # noslint: N006\nx = 1\n")
        fixes = an.fix.fix_file(str(target), str(tmp_path))
        assert len(fixes) == 2            # pragma gone AND import gone
        assert "import os" not in target.read_text()
        assert an.fix.fix_file(str(target), str(tmp_path)) == []

    def test_partial_rewrite_never_destroys_comments(self, an, tmp_path):
        target = self._module(an, tmp_path, (
            "from typing import (\n"
            "    Any,  # load-bearing comment about Any\n"
            "    Callable,\n"
            ")\n"
            "import os  # goes with the whole statement\n"
            "\n"
            "x: Any = 1\n"))
        fixes = an.fix.fix_file(str(target), str(tmp_path))
        text = target.read_text()
        assert "load-bearing comment" in text
        assert "Callable" in text
        assert "import os" not in text
        assert len(fixes) == 1
        assert an.fix.fix_file(str(target), str(tmp_path)) == []
        assert target.read_text() == text

    def test_cli_fix_skips_unparsable_file_and_keeps_sweeping(
            self, an, tmp_path, capsys):
        broken = self._module(an, tmp_path, "def oops(:\n")
        with pytest.raises(SyntaxError):
            an.fix.fix_file(str(broken), str(tmp_path))
        rc = an.cli.main(["--fix", "--no-cache", str(broken)])
        captured = capsys.readouterr()
        assert rc == 1
        assert "syntax error" in captured.out
        assert "skip (syntax error)" in captured.err
        assert "Traceback" not in captured.err


# ---------------------------------------------------------------------------
# The CLI's other modes
# ---------------------------------------------------------------------------

class TestCli:
    def test_json_format_parses(self, an, tmp_path, capsys, monkeypatch):
        anchor_cli(an, tmp_path, monkeypatch)
        pkg = tmp_path / an.pkg
        pkg.mkdir()
        (pkg / "a.py").write_text("import os\n")
        (pkg / "b.py").write_text(
            "import sys  # noslint: N006 — kept for the fixture\n")
        assert an.cli.main([str(pkg), "--format", "json", "--no-cache"]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert doc["files"] == 2
        assert [(v["rule"], os.path.basename(v["path"]), v["line"])
                for v in doc["violations"]] == [("N006", "a.py", 1)]
        assert [(v["rule"], os.path.basename(v["path"]))
                for v in doc["suppressed"]] == [("N006", "b.py")]

    def test_cache_dir_is_the_packages_own(self, an):
        assert an.cache.CACHE_DIR_NAME == {
            JAX: ".noslint_cache", PORT: ".noslint_torch_cache"}[an.pkg]

    @staticmethod
    def _git(repo, *args):
        return subprocess.run(
            ["git", "-C", str(repo), "-c", "user.name=t",
             "-c", "user.email=t@example.invalid", *args],
            capture_output=True, text=True, check=True).stdout

    def test_changed_only_lints_only_changed_files(self, an, tmp_path,
                                                   monkeypatch, capsys):
        """In a temporary git repo: a committed file left alone is out; a
        modified one and an untracked one are in, as is nothing outside
        the scope or not Python.  The CLI then lints just those."""
        repo = tmp_path / "repo"
        pkg = repo / an.pkg
        pkg.mkdir(parents=True)
        self._git(repo, "init", "-q", "-b", "main")
        (pkg / "same.py").write_text("import os\n")
        (pkg / "changed.py").write_text("x = 1\n")
        (repo / "outside.py").write_text("import os\n")
        self._git(repo, "add", "-A")
        self._git(repo, "commit", "-q", "-m", "base")
        (pkg / "changed.py").write_text("import json\nx = 1\n")
        (pkg / "new.py").write_text("import sys\n")
        (pkg / "notes.txt").write_text("not python\n")
        (repo / "outside.py").write_text("import os\nimport re\n")
        changed = an.cli._changed_python_files(str(repo), [str(pkg)])
        assert [os.path.basename(p) for p in changed] == \
            ["changed.py", "new.py"]

        anchor_cli(an, repo, monkeypatch)
        monkeypatch.setattr(an.cli, "_changed_python_files",
                            lambda root, scope: changed)
        assert an.cli.main(["--changed-only", "--no-cache", str(pkg)]) == 1
        out = capsys.readouterr().out.splitlines()
        assert out[-1].startswith("noslint: 2 file(s), 2 violation(s)")
        assert sorted(line.split(":")[0].rsplit("/", 1)[-1]
                      for line in out[:-1]) == ["changed.py", "new.py"]
        monkeypatch.setattr(an.cli, "_changed_python_files",
                            lambda root, scope: [])
        assert an.cli.main(["--changed-only", str(pkg)]) == 0
        assert "no changed python files" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The per-file result cache (cache.py)
# ---------------------------------------------------------------------------

class TestResultCache:
    def _cache(self, an, tmp_path):
        return an.cache.ResultCache(
            str(tmp_path),
            an.cache.rules_signature([r.id for r in an.rules.default_rules()]))

    def _tree(self, an, tmp_path):
        pkg = tmp_path / an.pkg
        pkg.mkdir(exist_ok=True)
        a = pkg / "a.py"
        b = pkg / "b.py"
        a.write_text("import os\n")
        b.write_text("x = 1\n")
        return pkg, a, b

    def _run(self, an, pkg, tmp_path, cache):
        return an.core.run(an.rules.default_rules(), [str(pkg)],
                           root=str(tmp_path), cache=cache)

    def test_hit_serves_identical_results(self, an, tmp_path):
        pkg, _, _ = self._tree(an, tmp_path)
        cache = self._cache(an, tmp_path)
        cold = self._run(an, pkg, tmp_path, cache)
        assert cache.misses == 2 and cache.hits == 0
        cache2 = self._cache(an, tmp_path)
        warm = self._run(an, pkg, tmp_path, cache2)
        assert cache2.hits == 2 and cache2.misses == 0
        assert [v.render() for v in warm.violations] == \
            [v.render() for v in cold.violations]
        assert rules_of(cold.violations) == ["N006"]
        assert os.path.isdir(tmp_path / an.cache.CACHE_DIR_NAME)

    def test_content_change_invalidates_that_file_only(self, an, tmp_path):
        pkg, a, _ = self._tree(an, tmp_path)
        self._run(an, pkg, tmp_path, self._cache(an, tmp_path))
        a.write_text("import os\nprint(os.sep)\n")
        cache = self._cache(an, tmp_path)
        assert self._run(an, pkg, tmp_path, cache).ok
        assert cache.hits == 1 and cache.misses == 1

    def test_readonly_checkout_degrades_to_cacheless(self, an, tmp_path,
                                                     monkeypatch):
        pkg, _, _ = self._tree(an, tmp_path)

        def deny(*a, **k):
            raise PermissionError("read-only filesystem")

        monkeypatch.setattr(os, "makedirs", deny)
        cache = self._cache(an, tmp_path)
        rep = self._run(an, pkg, tmp_path, cache)
        assert rules_of(rep.violations) == ["N006"]
        assert cache.hits == 0

    def test_rules_signature_change_invalidates_everything(self, an,
                                                           tmp_path):
        pkg, _, _ = self._tree(an, tmp_path)
        self._run(an, pkg, tmp_path, self._cache(an, tmp_path))
        stale = an.cache.ResultCache(str(tmp_path), "different-signature")
        self._run(an, pkg, tmp_path, stale)
        assert stale.misses == 2 and stale.hits == 0

    def test_key_changes_when_a_rule_source_changes(self, an, tmp_path,
                                                    monkeypatch):
        """The signature hashes the analyzer's own sources: an edit to a
        rule's file gives a new key, under which every entry misses."""
        src = tmp_path / "analysis_copy"
        shutil.copytree(os.path.dirname(an.cache.__file__), src,
                        ignore=shutil.ignore_patterns("__pycache__"))
        monkeypatch.setattr(
            an.cache, "_analysis_sources",
            lambda: sorted(str(p) for p in src.glob("*.py")))
        ids = [r.id for r in an.rules.default_rules()]
        before = an.cache.rules_signature(ids)
        assert an.cache.rules_signature(ids) == before     # stable
        pkg, _, _ = self._tree(an, tmp_path)
        self._run(an, pkg, tmp_path,
                  an.cache.ResultCache(str(tmp_path), before))
        with open(src / "rules.py", "a") as f:
            f.write("\n# an edited rule\n")
        after = an.cache.rules_signature(ids)
        assert after != before
        cache = an.cache.ResultCache(str(tmp_path), after)
        self._run(an, pkg, tmp_path, cache)
        assert cache.misses == 2 and cache.hits == 0
        # and the rule set is part of the key too
        assert an.cache.rules_signature(ids[:-1]) != after

    def test_cross_file_rules_bypass_the_cache(self, an, tmp_path):
        """N003's verdict about b.py moves when a.py changes — a cached
        b.py entry must not pin the stale verdict."""
        pkg = tmp_path / an.pkg
        pkg.mkdir()
        a = pkg / "a.py"
        b = pkg / "b.py"
        a.write_text("REGISTRY = object()\n"
                     "REGISTRY.describe('nos_tpu_x_total', 'help')\n")
        b.write_text("from .a import REGISTRY\n"
                     "REGISTRY.inc('nos_tpu_x_total')\n")
        assert self._run(an, pkg, tmp_path, self._cache(an, tmp_path)).ok
        a.write_text("y = 1\n")
        rep = self._run(an, pkg, tmp_path, self._cache(an, tmp_path))
        assert rules_of(rep.violations) == ["N003"]
        assert rep.violations[0].path.endswith("b.py")


# ---------------------------------------------------------------------------
# The lock checker and the registry: the cases tests/test_torch_cmd.py
# does not hold
# ---------------------------------------------------------------------------

class TestLockcheck:
    def test_registry_describe_guard(self, an):
        """Re-describing with the same help is idempotent; a conflicting
        help raises."""
        reg = an.module("exporter.metrics").Registry()
        reg.describe("nos_tpu_x_total", "help")
        reg.describe("nos_tpu_x_total", "help")
        with pytest.raises(ValueError, match="already registered"):
            reg.describe("nos_tpu_x_total", "different")

    def test_guard_state_property_setter_judged_by_inner_write(self, an):
        lc = an.module("testing.lockcheck")

        class Shared:
            def __init__(self):
                self._lock = threading.RLock()
                self._x = ""

            @property
            def x(self):
                with self._lock:
                    return self._x

            @x.setter
            def x(self, v):
                with self._lock:
                    self._x = v

        g = lc.LockGraph(name="prop")
        s = Shared()
        try:
            lc.guard_state(s, g)
            s.x = "plan-1"               # the setter takes the lock itself
            g.assert_clean()
        finally:
            g.close()
            lc.unguard_all()
