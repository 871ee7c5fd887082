"""The port's boundary: nos_tpu_torch and chip_smoke.py import nothing of
JAX or of nos_tpu, its entry points refuse to run quietly on the CPU, and
its kernel build is keyed on the sources."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import nos_tpu_torch
from nos_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nos_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nos_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serve.py"]


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import nos_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    nos_tpu_torch.__path__, "nos_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names,
                  "new": sorted(set(sys.modules) - before)}))
"""


def test_importing_every_module_loads_no_jax_or_nos_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert "nos_tpu_torch.models.generate" in result["imported"]
    assert "nos_tpu_torch.ops.attention" in result["imported"]
    bad = [m for m in result["new"] if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_nos_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


class TestNoQuietCPU:
    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_raises(self):
        from nos_tpu_torch.entry import entry

        with pytest.raises(RuntimeError, match="CUDA"):
            entry()

    def test_model_constructor_raises(self):
        from nos_tpu_torch.models.llama import TINY, Llama, init_params

        with pytest.raises(RuntimeError, match="CUDA"):
            Llama(TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(TINY, torch.Generator())

    def test_resolve_device(self):
        assert nos_tpu_torch.resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(RuntimeError):
            nos_tpu_torch.resolve_device(None)
        with pytest.raises(RuntimeError):
            nos_tpu_torch.resolve_device("cuda:0")


def test_entry_on_cpu_when_asked():
    from nos_tpu_torch.entry import entry

    fn, (model, tokens) = entry(device="cpu")
    assert model.cfg.num_layers == 4 and model.cfg.attn_impl == "flash"
    assert model.embed.dtype == torch.bfloat16
    assert tokens.shape == (1, 512) and tokens.device.type == "cpu"
    assert callable(fn)


class TestBuild:
    def test_sources_are_the_repo_kernels(self):
        assert _build.sources() == ["flash_fwd"]

    def test_library_name_tracks_the_source(self, tmp_path, monkeypatch):
        path = _build.library_path("flash_fwd")
        assert path.parent == _build.KERNEL_DIR
        assert path.name.startswith("libflash_fwd-")
        src = tmp_path / "csrc"
        src.mkdir()
        text = (_build.CSRC / "flash_fwd.cu").read_text()
        (src / "flash_fwd.cu").write_text(text)
        monkeypatch.setattr(_build, "CSRC", src)
        assert _build.library_path("flash_fwd").name == path.name
        (src / "flash_fwd.cu").write_text(text + "\n// edited\n")
        assert _build.library_path("flash_fwd").name != path.name

    def test_kernel_dir_is_ignored_by_git(self):
        ignored = (ROOT / ".gitignore").read_text().splitlines()
        rel = _build.KERNEL_DIR.relative_to(ROOT).as_posix() + "/"
        assert rel in ignored

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path / "k")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()
