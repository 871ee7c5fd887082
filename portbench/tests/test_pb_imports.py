"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``nos_tpu_torch`` is the program; ``nos_tpu`` is
not), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.tests.conftest import ROOT

PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "nos_tpu"}


def _modules(where: Path) -> list[str]:
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in where.rglob("*.py")
                  if "tests" not in p.relative_to(PB).parts[:1])


def test_no_jax_in_the_harness_process():
    mods = [m.removesuffix(".__init__") for m in _modules(PB)]
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in list(sys.modules)})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "nos_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"nos_tpu_torch"}, (path, name)
            assert not name.startswith("portbench.entries"), (path, name)


def test_the_runner_refuses_a_run_that_loaded_jax(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "nos_tpu.models", object())
    assert run.forbidden_modules() == ["nos_tpu"]
    monkeypatch.delitem(sys.modules, "nos_tpu.models")
    monkeypatch.setitem(sys.modules, "nos_tpu_torchx", object())
    assert run.forbidden_modules() == []
