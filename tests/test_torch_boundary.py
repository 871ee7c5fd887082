"""The port's boundary: nos_tpu_torch and chip_smoke.py import nothing of
JAX or of nos_tpu, its entry points refuse to run quietly on the CPU, and
its kernel build is keyed on the sources."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
import nos_tpu_torch
from nos_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nos_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nos_tpu")


def _with_includes(path: Path, seen=None) -> str:
    """A CUDA source and, in its place, every header it includes by a
    quoted name from beside it, once each."""
    seen = set() if seen is None else seen
    seen.add(path.name)
    parts = []
    for line in path.read_text().splitlines():
        m = re.match(r'\s*#include\s+"([^"]+)"', line)
        if m and m.group(1) not in seen and (path.parent / m.group(1)).is_file():
            parts.append(_with_includes(path.parent / m.group(1), seen))
        else:
            parts.append(line)
    return "\n".join(parts)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serve.py",
        ROOT / "scripts" / "profile_torch_train.py",
        ROOT / "scripts" / "profile_torch_moe.py",
        ROOT / "scripts" / "ab_flash_kernel.py",
        ROOT / "scripts" / "sweep_flash_torch.py",
        ROOT / "scripts" / "time_waste_waterfall.py",
        ROOT / "scripts" / "time_native_fleet.py",
        ROOT / "scripts" / "mfu_explore_torch.py",
        ROOT / "demos" / "gpu-sharing-comparison" / "run.py"]


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
    for module in ("models.generate", "models.train", "models.data",
                   "models.checkpoint", "models.moe", "ops.attention",
                   "ops.autotune", "ops.roofline", "parallel.mesh", "parallel.ring",
                   "parallel.pipeline", "api.config", "exporter.metrics",
                   "cmd.train", "testing.ranks", "entry", "topology.known",
                   "topology.packing", "topology.profile", "device.fake",
                   "device.nvml", "device.discovery", "device.workload_env",
                   "testing.nvml", "api.constants", "kube.client",
                   "kube.objects", "kube.resources", "utils.guards",
                   "utils.retry", "obs.trace", "obs.journal",
                   "scheduler.framework", "topology.annotations",
                   "topology.timeshare_unit", "topology.hybrid",
                   "partitioning.state", "partitioning.core.snapshot",
                   "partitioning.core.planner", "partitioning.core.actuator",
                   "partitioning.timeshare.partitioner",
                   "partitioning.timeshare.snapshot_taker",
                   "testing.factory", "testing.fleet", "utils.batcher",
                   "utils.pod_util", "partitioning.core.quarantine",
                   "controllers.pod_controller",
                   "controllers.node_controller",
                   "controllers.partitioner_controller",
                   "partitioning.timeshare.factory", "controllers.kubelet",
                   "device.timeshare_plugin",
                   "controllers.chipagent.reporter",
                   "controllers.chipagent.agent", "testing.chaos",
                   "topology.slice_unit",
                   "partitioning.slicepart.calculators",
                   "partitioning.slicepart.node",
                   "partitioning.slicepart.snapshot_taker",
                   "partitioning.slicepart.partitioner",
                   "partitioning.slicepart.factory",
                   "controllers.sliceagent.shared",
                   "controllers.sliceagent.plan",
                   "controllers.sliceagent.actuator",
                   "controllers.sliceagent.reporter",
                   "controllers.sliceagent.agent", "device.plugin",
                   "api.elasticquota", "api.pdb", "quota.calculator",
                   "quota.info", "controllers.elasticquota.controller",
                   "scheduler.cache", "scheduler.gang",
                   "scheduler.capacityscheduling", "scheduler.scheduler",
                   "cmd.assembly", "api.podgroup", "topology.shape",
                   "partitioning.core.pools", "partitioning.core.parallel",
                   "partitioning.core.failure", "cmd.partitioner",
                   "cmd.scheduler", "cmd.operator", "cmd.chipagent",
                   "cmd.sliceagent", "cmd.metricsexporter",
                   "kube.leaderelection", "kube.webhook", "exporter",
                   "testing.lockcheck", "obs.ledger", "obs.timeseries",
                   "obs.slo", "obs.explain", "obs.__main__",
                   "scheduler.elastic", "topology.windows",
                   "partitioning.core.defrag", "sim", "sim.engine",
                   "sim.trace", "requests", "requests.costs",
                   "requests.replica", "requests.router", "serving",
                   "serving.autoscaler", "serving.trace",
                   "cmd.autoscaler", "capacity", "capacity.cloudapi",
                   "capacity.provisioner", "cmd.provisioner",
                   "sim.injectors", "sim.report", "sim.scenario",
                   "sim.worstweek", "sim.__main__", "device.deviceplugin",
                   "device.deviceplugin.deviceplugin_pb2",
                   "device.podresources",
                   "device.podresources.podresources_pb2",
                   "device.native", "scheduler.native_filter",
                   "testing.interleave", "testing.helm"):
        assert f"nos_tpu_torch.{module}" in result["imported"]
    assert "nos_tpu_torch.testing.bind" not in result["imported"]
    bad = [m for m in result["new"] if _forbidden(m)]
    assert not bad, bad


# The control plane's processes (the mains, the CLIs, the simulator, the
# analyzer and its determinism children) use no tensor, and start without
# torch, whose import takes seconds a process on the card's machine.
_TORCH_FREE = ("cmd.scheduler", "cmd.partitioner", "cmd.operator",
               "cmd.chipagent", "cmd.sliceagent", "cmd.metricsexporter",
               "cmd.autoscaler", "cmd.provisioner", "obs.__main__",
               "sim.__main__", "analysis.__main__", "analysis.determinism")


@pytest.mark.parametrize("module", _TORCH_FREE)
def test_control_plane_process_starts_without_torch(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    code = (f"import importlib, sys; importlib.import_module("
            f"'nos_tpu_torch.{module}'); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "False"


def test_discovery_without_torch_reads_no_cuda_and_imports_none():
    """A process that has not imported torch has no CUDA context: the
    CUDA rung is passed over and torch stays unloaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    code = ("import sys; from nos_tpu_torch.device import discovery; "
            "found = discovery.discover(allow_cuda=True); "
            "print(found.source != 'device', 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.split() == ["True", "False"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.proto")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_proto_imports_nothing(path):
    # the kubelet's wire packages, self-contained: no proto of the JAX
    # package (or any other) is imported
    text = path.read_text()
    assert not re.search(r"^\s*import\b", text, re.M), path
    assert re.search(r"^package (v1beta1|v1);$", text, re.M), path


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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_top_level_function_or_class_is_defined_twice(path):
    # a second def of one name replaces the first at import, and every
    # caller of the first then runs the second without a word
    seen: dict[str, int] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            assert node.name not in seen, (
                f"{path.name}: {node.name} defined at lines "
                f"{seen[node.name]} and {node.lineno}")
            seen[node.name] = node.lineno


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

    def test_training_entry_points_raise(self):
        from nos_tpu_torch.cmd.train import TrainConfig, build
        from nos_tpu_torch.entry import dryrun_multigpu
        from nos_tpu_torch.models.llama import TINY
        from nos_tpu_torch.models.train import ShardedTrainer

        with pytest.raises(RuntimeError, match="CUDA"):
            build(TrainConfig(model="tiny"))
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedTrainer(TINY, mesh=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multigpu(2)

    def test_moe_entry_points_raise(self):
        from nos_tpu_torch.entry import bench_moe_trainer
        from nos_tpu_torch.models.moe import (TINY_MOE, MoELlama,
                                              init_moe_params,
                                              make_ep_trainer)

        with pytest.raises(RuntimeError, match="CUDA"):
            MoELlama(TINY_MOE)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_moe_params(TINY_MOE, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            make_ep_trainer(TINY_MOE, mesh=None, example_tokens=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_moe_trainer()

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
        assert _build.sources() == ["flash_bwd", "flash_bwd_split",
                                    "flash_fwd"]

    def test_library_name_tracks_the_source(self, tmp_path, monkeypatch):
        path = _build.library_path("flash_fwd")
        assert path.parent == _build.KERNEL_DIR
        assert path.name.startswith("libflash_fwd-")
        src = tmp_path / "csrc"
        src.mkdir()
        for header in _build.CSRC.glob("*.cuh"):
            (src / header.name).write_text(header.read_text())
        text = (_build.CSRC / "flash_fwd.cu").read_text()
        (src / "flash_fwd.cu").write_text(text)
        monkeypatch.setattr(_build, "CSRC", src)
        assert _build.library_path("flash_fwd").name == path.name
        (src / "flash_fwd.cu").write_text(text + "\n// edited\n")
        assert _build.library_path("flash_fwd").name != path.name

    def test_library_name_tracks_the_shared_headers(self, tmp_path,
                                                     monkeypatch):
        # the Hopper machinery, and the backward body K2 and K4 share
        names = ("flash_bwd", "flash_bwd_split")
        paths = {n: _build.library_path(n).name for n in names}
        src = tmp_path / "csrc"
        src.mkdir()
        for f in _build.CSRC.iterdir():
            (src / f.name).write_text(f.read_text())
        monkeypatch.setattr(_build, "CSRC", src)
        assert {n: _build.library_path(n).name for n in names} == paths
        for name in ("hopper_common.cuh", "flash_bwd_body.cuh"):
            header = src / name
            header.write_text(header.read_text() + "\n// edited\n")
            edited = {n: _build.library_path(n).name for n in names}
            assert all(edited[n] != paths[n] for n in names), name
            paths = edited

    @pytest.mark.parametrize("name", sorted(chip_smoke.KERNELS))
    def test_smoke_kernel_is_defined_in_its_source(self, name):
        # chip_smoke.py reads each kernel's ptxas line by this function
        # name: a rename would turn its registers and spills into None.
        source, function, _design = chip_smoke.KERNELS[name]
        assert source in _build.sources()
        text = _with_includes(_build.CSRC / f"{source}.cu")
        assert re.search(r"__global__\s+void\s+(__launch_bounds__\([^()]*\)"
                         rf"\s+)?{function}\s*\(", text), (source, function)

    def test_no_mma_sync_kernel_is_left(self):
        # every flash kernel is a wgmma design on hopper_common.cuh: no
        # source issues the mma.sync instruction
        assert {d for _, _, d in chip_smoke.KERNELS.values()} == {"wgmma+tma"}
        for source in _build.sources():
            text = _with_includes(_build.CSRC / f"{source}.cu")
            assert "wgmma.mma_async" in text, source
            assert "mma.sync.aligned" not in text, source

    def test_the_host_shim_is_built_apart_from_the_kernels(self):
        # native/gpu_shim.cc is host C++: g++ builds it, nvcc never sees
        # it, and it includes no CUDA or PyTorch header
        assert _build.NATIVE == PORT / "native"
        assert sorted(p.name for p in _build.NATIVE.iterdir()) == \
            ["gpu_shim.cc"]
        text = (_build.NATIVE / "gpu_shim.cc").read_text()
        includes = re.findall(r"^#include\s+<([^>]+)>", text, re.M)
        assert includes and not any(
            "cuda" in h or "torch" in h or "/" in h for h in includes)
        assert "__global__" not in text
        assert _build.host_library_path("gpu_shim").parent == \
            _build.KERNEL_DIR

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

    def test_build_file_without_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path / "k")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_file(_build.CSRC / "flash_fwd.cu")

    def test_build_file_is_keyed_on_the_file_and_its_headers(
            self, tmp_path, monkeypatch):
        # nvcc's stand-in writes the library and prints one ptxas line
        monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path / "k")
        started = []

        def start(src, out):
            started.append(out)
            tmp = out.with_name(out.name + ".tmp")
            tmp.write_bytes(b"")
            return tmp, subprocess.Popen(
                [sys.executable, "-c",
                 "print('ptxas info    : Used 7 registers')"],
                stdout=subprocess.PIPE, text=True)

        monkeypatch.setattr(_build, "_start", start)
        src = tmp_path / "variant" / "flash_fwd.cu"
        src.parent.mkdir()
        src.write_text((_build.CSRC / "flash_fwd.cu").read_text())
        lib, ptxas = _build.build_file(src)
        assert lib.parent == tmp_path / "k" and lib.is_file()
        assert lib.name.startswith("libflash_fwd-file-")
        assert ptxas == ["ptxas info    : Used 7 registers"]
        assert _build.build_file(src) == (lib, []) and len(started) == 1
        src.write_text(src.read_text() + "\n// edited\n")
        edited, _ = _build.build_file(src)
        # a header beside the variant takes the place of the package's
        (src.parent / "hopper_common.cuh").write_text("// changed\n")
        header, _ = _build.build_file(src)
        assert len({lib, edited, header}) == 3 and len(started) == 3

    def test_ptxas_resources(self):
        # the lines build() keeps from nvcc -Xptxas=-v, two kernels
        lines = [
            "ptxas info    : Compiling entry function '_Z9kernel_av' for "
            "'sm_90a'",
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas info    : Used 168 registers, used 16 barriers",
            "ptxas info    : Compiling entry function '_Z9kernel_bv' for "
            "'sm_90a'",
            "32 bytes stack frame, 28 bytes spill stores, 32 bytes spill "
            "loads",
            "ptxas info    : Used 255 registers, used 1 barriers, 32 bytes "
            "cumulative stack size",
        ]
        assert _build.ptxas_resources(lines) == {
            "_Z9kernel_av": {"registers": 168, "spill_stores": 0,
                             "spill_loads": 0},
            "_Z9kernel_bv": {"registers": 255, "spill_stores": 28,
                             "spill_loads": 32},
        }
        assert _build.ptxas_resources([]) == {}
