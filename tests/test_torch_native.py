"""The native scheduling shim (``nos_tpu_torch/native/gpu_shim.cc``,
``device/native.py``, ``scheduler/native_filter.py``) and its hooks in
the scheduler, the planner and the capacity plugin, on the CPU.

- **Port C against JAX C**: with the memory guard held at zero the
  port's ``nos_fit_batch`` gives the JAX shim's verdicts and miss masks
  bit for bit (JAX's chips are the port's compute slices); the score
  argmin picks JAX's index, window terms included; the victim screen
  with an open memory cap gives JAX's mask.
- **The port's screen against the port's Python**: ``screen_nodes``
  gives ``NodeResourcesFit.filter``'s messages byte for byte on MIG
  fleets in flux (both guards firing), MPS and mixed fleets;
  ``screen_compiled``'s fails are the pipeline's; ``_native_choose`` is
  ``min(_score_key)``; the native ``_victim_screen`` is ``_fits_empty``.
- **The build**: the GIL handshake, two processes building at once, a
  compiler that fails.
- **Decisions do not change**: the fleets of ``testing/fleet.py`` run
  with every native path and with none (Python only, the shim's
  functions made to raise) to the same summaries, waterfalls and
  journals, at the digests JAX's runs pinned.

Random inputs come from numpy generators seeded per case.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.device import native
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.ops import _build
from nos_tpu_torch.partitioning.core import (
    GeometryPlanner, ParallelGeometryPlanner)
from nos_tpu_torch.partitioning.slicepart import (
    SlicePartitionCalculator, SliceProfileCalculator, SliceSnapshotTaker)
from nos_tpu_torch.partitioning.timeshare import (
    TimesharePartitionCalculator, TimeshareProfileCalculator,
    TimeshareSnapshotTaker)
from nos_tpu_torch.scheduler import capacityscheduling as cs
from nos_tpu_torch.scheduler.framework import (
    CycleState, Framework, MigrationDrainGuard, NodeInfo, NodeResourcesFit,
    SharedLister, SpareGuard,
)
from nos_tpu_torch.scheduler.native_filter import FitPrescreen
from nos_tpu_torch.scheduler.scheduler import Scheduler
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology.known import H100_80GB
from nos_tpu_torch.topology.profile import slice_resource_name

from test_torch_planner import build_jax_shim

ROOT = Path(__file__).resolve().parent.parent
MIG_PROFILES = [p.name for p in H100_80GB.mig_profiles]
SHARES = (10, 20, 40, 80)


# ---------------------------------------------------------------------------
# the port's C against the JAX package's C
# ---------------------------------------------------------------------------

class TestAgainstJaxShim:
    @pytest.fixture(autouse=True)
    def jax_shim(self, monkeypatch):
        assert build_jax_shim(monkeypatch), \
            "the JAX package's native shim did not build"
        from nos_tpu.device import native as jax_native
        return jax_native

    @pytest.mark.parametrize("seed", range(8))
    def test_fit_batch_with_the_memory_guard_zeroed(self, seed, jax_shim):
        rng = np.random.default_rng(seed)
        # the widest mask both shims take on the last seed
        n_res = 62 if seed == 7 else int(rng.integers(1, 8))
        n_nodes, n_classes = 24, 6
        free = rng.choice([0.0, 1.0, 2.0, 3.0, 8.0], (n_nodes, n_res))
        req = rng.choice([0.0, 0.0, 1.0, 2.0, 4.0], (n_classes, n_res))
        if seed == 7:
            free[:, 8:] = 9.0       # keep some fits among 62 resources
        cap = rng.choice([7.0, 14.0], n_nodes)
        used = rng.choice([0.0, 3.0, 7.0, 14.0], n_nodes)
        g = rng.choice([0.0, 1.0, 3.0, 7.0], n_classes)
        # one cell where every resource fits and the guard fires
        free[0], req[0], used[0], g[0] = 9.0, 1.0, cap[0], 1.0
        zeros = [0.0] * n_nodes
        got = native.fit_batch(
            free.ravel().tolist(), req.ravel().tolist(), cap.tolist(),
            used.tolist(), zeros, zeros, g.tolist(), [0.0] * n_classes,
            n_nodes, n_classes, n_res)
        want = jax_shim.fit_batch(
            free.ravel().tolist(), req.ravel().tolist(), cap.tolist(),
            used.tolist(), g.tolist(), n_nodes, n_classes, n_res)
        assert got == want
        verdicts, miss = got
        assert 0 < sum(verdicts) < n_nodes * n_classes
        assert not any(m & native.FIT_MISS_MEMORY_GUARD for m in miss)
        assert miss[0] == native.FIT_MISS_COMPUTE_GUARD

    @pytest.mark.parametrize("seed", range(8))
    def test_score_batch_with_windows(self, seed, jax_shim):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(2, 40))
        ll = ctypes.c_longlong
        avoided = (ctypes.c_uint8 * n)(*rng.choice([0, 0, 0, 1], n))
        headroom = (ctypes.c_double * n)(*rng.choice([0.0, 1.0, 2.5], n))
        gids = rng.choice([-1, 0, 1, 2], n)
        widx = rng.integers(0, 16, n)
        sizes = []
        woff = [0]
        for g in gids:
            if g >= 0:
                sizes.extend([[2], [2, 4], [4, 8], []][rng.integers(4)])
            woff.append(len(sizes))
        keys = sorted({(int(rng.integers(3)), int(rng.integers(16)))
                       for _ in range(int(rng.integers(0, 48)))})
        m = len(keys) if seed % 4 else 0     # an empty table too
        vals = rng.choice([0, 0, 1], max(1, m))
        args = [avoided, headroom, (ll * n)(*gids), (ll * n)(*widx),
                (ll * n)(*rng.integers(0, 6, n)),
                (ll * n)(*rng.permutation(n)),
                (ll * max(1, len(sizes)))(*sizes), (ll * (n + 1))(*woff),
                (ll * max(1, m))(*[k[0] for k in keys[:m]]),
                (ll * max(1, m))(*[k[1] for k in keys[:m]]),
                (ctypes.c_uint8 * max(1, m))(*vals[:m]), n, m]
        assert native.score_batch(*args) == jax_shim.score_batch(*args)

    @pytest.mark.parametrize("seed", range(6))
    def test_window_busy_sort_matches_python_sort(self, seed, jax_shim):
        """nos_window_busy against the JAX shim's and against sorted():
        unique (group, host index) keys, as the busy dict has them."""
        rng = np.random.default_rng(300 + seed)
        keys = list({(int(rng.integers(6)), int(rng.integers(16)))
                     for _ in range(int(rng.integers(0, 40)))})
        rng.shuffle(keys)
        triples = [(g, i, int(rng.integers(2))) for g, i in keys]
        n = len(triples)
        out = []
        for sort in (native.window_busy_sort, jax_shim.window_busy_sort):
            gid = (ctypes.c_longlong * max(1, n))(*[t[0] for t in triples])
            idx = (ctypes.c_longlong * max(1, n))(*[t[1] for t in triples])
            val = (ctypes.c_uint8 * max(1, n))(*[t[2] for t in triples])
            sort(gid, idx, val, n)
            out.append([(gid[i], idx[i], val[i]) for i in range(n)])
        assert out[0] == out[1] == sorted(triples)

    def test_window_busy_sort_refuses_a_short_array(self):
        arr = (ctypes.c_longlong * 1)()
        with pytest.raises(ValueError, match="nos_window_busy"):
            native.window_busy_sort(arr, arr, (ctypes.c_uint8 * 1)(), 3)

    def test_multihost_shard(self, jax_shim):
        """A block shard takes its GPU whole, as JAX's runtime makes a
        4x4 shard take its host: one device, and no instance beside it
        (the fake runtime here; tests/test_torch_nvml_runtime.py holds
        the NVML runtime's shards to it)."""
        from nos_tpu.topology import V5E, Shape
        from nos_tpu.topology.errors import (
            PlacementInfeasibleError as JaxInfeasible,
        )
        from nos_tpu_torch.device.fake import FakeGpuRuntime
        from nos_tpu_torch.topology.errors import PlacementInfeasibleError

        jrt = jax_shim.NativeTpuRuntime(V5E)
        assert len(jrt.create_slices(0, [Shape.parse("4x4")])) == 1
        with pytest.raises(JaxInfeasible):
            jrt.create_slices(0, [Shape.parse("1x1")])
        rt = FakeGpuRuntime(num_gpus=2)
        assert len(rt.create_slices(0, ["2x8"])) == 1
        (dev,) = rt.list_devices()
        assert (dev.resource_name, dev.unit_index) == \
            ("nos.nebuly.com/nvlink-block-2x8", 0)
        assert rt.placements() == {}
        with pytest.raises(PlacementInfeasibleError):
            rt.create_slices(0, ["1g.10gb"])
        with pytest.raises(PlacementInfeasibleError):
            rt.create_slices(1, ["2x8", "1g.10gb"])

    @pytest.mark.parametrize("seed", range(4))
    def test_victim_prescreen_with_an_open_memory_cap(self, seed, jax_shim):
        rng = np.random.default_rng(200 + seed)
        n_res = int(rng.integers(1, 5))
        req = np.round(rng.uniform(0.5, 4.0, n_res), 3).tolist()
        rows = np.round(rng.uniform(0.0, 5.0, (30, n_res)), 3).tolist()
        rows += [list(req), [v - 1e-9 for v in req]]    # the edges
        caps = rng.integers(0, 9, len(rows)).tolist()
        open_cap = [1 << 40] * len(rows)
        for pod in (0, int(rng.integers(1, 9))):
            got = native.victim_prescreen(rows, req, caps, open_cap, pod, 8)
            assert got == jax_shim.victim_prescreen(rows, req, caps, pod)


# ---------------------------------------------------------------------------
# the port's screen against the port's Python
# ---------------------------------------------------------------------------

def _mig_node(rng, name: str, model: str = H100_80GB.name) -> NodeInfo:
    """A MIG node in flux: each GPU carved at random, and bound pods
    holding profiles a re-carve may have taken away."""
    geometry = {}
    for g in range(int(rng.integers(1, 4))):
        carve = {}
        for _ in range(int(rng.integers(1, 4))):
            p = MIG_PROFILES[int(rng.integers(len(MIG_PROFILES)))]
            carve[p] = carve.get(p, 0) + int(rng.integers(1, 3))
        geometry[g] = {"free": carve}
    if rng.integers(3) == 0:
        # a card re-carved to 1g.10gb x 7 under three bound 1g.20gb pods:
        # 6 of its 7 memory slots held, 3 of its 7 compute slices
        node = factory.make_gpu_node(
            name, gpus=1, partitioning=C.MIG_KIND,
            status_geometry={0: {"free": {"1g.10gb": 7}}},
            extra_labels={C.LABEL_ACCELERATOR: model})
        ni = NodeInfo(node=node)
        ni.requested = {slice_resource_name("1g.20gb"): 3.0}
        return ni
    node = factory.make_gpu_node(name, gpus=len(geometry),
                                 partitioning=C.MIG_KIND,
                                 status_geometry=geometry,
                                 extra_labels={C.LABEL_ACCELERATOR: model})
    ni = NodeInfo(node=node)
    held = {}
    for _ in range(int(rng.integers(0, 4))):
        res = slice_resource_name(
            MIG_PROFILES[int(rng.integers(len(MIG_PROFILES)))])
        held[res] = held.get(res, 0.0) + float(rng.integers(1, 3))
    ni.requested = held
    return ni


def _mps_node(rng, name: str) -> NodeInfo:
    geometry = {g: {"free": {f"{int(rng.choice(SHARES))}gb":
                             int(rng.integers(1, 4))}}
                for g in range(int(rng.integers(1, 3)))}
    ni = NodeInfo(node=factory.make_gpu_node(name, gpus=len(geometry),
                                             status_geometry=geometry))
    ni.requested = {f"{C.RESOURCE_TIMESHARE_PREFIX}{int(rng.choice(SHARES))}gb":
                    float(rng.integers(0, 3)), C.CPU: float(rng.integers(0, 60))}
    return ni


def _pods(rng, kinds: tuple[str, ...]):
    out = []
    if "mig" in kinds:
        # two slots more than such a card has left
        out.append(factory.make_mig_pod("1g.10gb", 2, name="two-small"))
    for i in range(12):
        kind = kinds[i % len(kinds)]
        if kind == "mig":
            p = MIG_PROFILES[int(rng.integers(len(MIG_PROFILES)))]
            pod = factory.make_mig_pod(p, int(rng.integers(1, 4)),
                                       name=f"p{i}")
        else:
            pod = factory.make_timeshare_pod(int(rng.choice(SHARES)),
                                             int(rng.integers(1, 3)),
                                             name=f"p{i}")
        if rng.integers(3) == 0:
            pod.spec.containers[0].resources[C.CPU] = float(rng.integers(1, 9))
        out.append(pod)
    return out


def _fleet(rng, kind: str) -> list[NodeInfo]:
    nodes = []
    for i in range(40):
        if kind == "mig" or (kind == "mixed" and i % 2):
            # a few nodes of no known model: the compute guard only
            model = "unknown-gpu" if i % 7 == 3 else H100_80GB.name
            nodes.append(_mig_node(rng, f"n{i}", model))
        else:
            nodes.append(_mps_node(rng, f"n{i}"))
    return nodes


FLEETS = {"mig": ("mig",), "mps": ("mps",), "mixed": ("mig", "mps")}


class TestScreenAgainstPython:
    @pytest.mark.parametrize("kind", sorted(FLEETS))
    @pytest.mark.parametrize("seed", range(6))
    def test_screen_nodes_messages_are_the_filter_s(self, kind, seed):
        rng = np.random.default_rng(300 + seed)
        nodes = _fleet(rng, kind)
        screen = FitPrescreen(Framework())
        fit = NodeResourcesFit()
        cache: dict = {}
        seen = set()
        for pod in _pods(rng, FLEETS[kind]):
            msgs = screen.screen_nodes(nodes, pod_request(pod),
                                       guard_cache=cache)
            for ni, msg in zip(nodes, msgs):
                st = fit.filter(CycleState(), pod, ni)
                want = None if st.is_success \
                    else f"NodeResourcesFit: {st.message}"
                assert msg == want, (ni.name, pod.key)
                seen.add("pass" if msg is None else msg.split(" (")[0])
        assert "pass" in seen and len(seen) > 2, seen
        if kind != "mps":
            # both guards fired, over the nodes of a known model
            assert {"NodeResourcesFit: insufficient MIG compute slices",
                    "NodeResourcesFit: insufficient MIG memory slots"} \
                <= seen, seen

    @pytest.mark.parametrize("kind", sorted(FLEETS))
    @pytest.mark.parametrize("seed", range(4))
    def test_screen_compiled_fails_are_the_pipeline_s(self, kind, seed):
        rng = np.random.default_rng(400 + seed)
        nodes = _fleet(rng, kind)
        for ni in nodes[::5]:      # holds the guards behind the fit reject
            ni.node.metadata.labels[C.LABEL_SPARE] = C.SPARE_WARM
        pods = _pods(rng, FLEETS[kind])
        for fw in (Framework(), Framework([NodeResourcesFit(), SpareGuard(),
                                           MigrationDrainGuard()])):
            screen = FitPrescreen(fw)
            compiled = screen.compile_classes([pod_request(p) for p in pods])
            fails = 0
            for ni in nodes:
                verdicts = screen.screen_compiled(ni, compiled)
                for pod, ok in zip(pods, verdicts):
                    passes = fw.run_filter_plugins(CycleState(), pod,
                                                   ni).is_success
                    if not ok:
                        assert not passes, (ni.name, pod.key)
                        fails += 1
                    elif len(fw.filter_chain) == 1:
                        # NodeResourcesFit alone: the screen is exact
                        assert passes, (ni.name, pod.key)
            assert fails > 0

    def test_an_unsound_chain_is_not_screened(self):
        class OwnFit(NodeResourcesFit):
            pass

        assert not FitPrescreen(Framework([OwnFit()])).verdict_sound
        screen = FitPrescreen(Framework([SpareGuard(), NodeResourcesFit()]))
        assert screen.verdict_sound and not screen.message_exact
        assert screen.screen_nodes([], {"x": 1.0}) is None

    @pytest.mark.parametrize("seed", range(6))
    def test_native_choose_is_the_score_key_argmin(self, seed):
        rng = np.random.default_rng(500 + seed)
        api = APIServer()
        for i in range(24):
            geometry = {g: {"free": {f"{int(rng.choice(SHARES))}gb": 1}}
                        for g in range(2)}
            node = factory.make_gpu_node(f"gpu-node-{i}",
                                         status_geometry=geometry)
            index = ["missing", "banana", str(int(rng.integers(0, 4)))][
                int(rng.integers(3))]
            if index != "missing":
                node.metadata.labels[C.LABEL_HOST_INDEX] = index
            if rng.integers(4) == 0:
                node.metadata.annotations[C.ANNOT_DEFRAG_DRAIN] = "p-1"
            api.create(KIND_NODE, node)
        sched = build_scheduler(api)
        nis = sched._cycle_lister().list()
        for gb in SHARES:
            pod = factory.make_timeshare_pod(gb, 1, name=f"t{gb}")
            feasible = [ni for ni in nis
                        if f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb"
                        in ni.allocatable]
            if len(feasible) < 2:
                continue
            got = sched._native_choose(pod, feasible)
            assert got is min(feasible, key=sched._score_key(pod))
        # a negative index is the Python argmin's
        nis[0].node.metadata.labels[C.LABEL_HOST_INDEX] = "-1"
        pod = factory.make_timeshare_pod(10, 1, name="neg")
        assert sched._native_choose(pod, nis) is None
        assert sched._choose_node(pod, {ni.name: ni for ni in nis}) is \
            min(nis, key=sched._score_key(pod))

    @pytest.mark.parametrize("kind", sorted(FLEETS))
    @pytest.mark.parametrize("seed", range(3))
    def test_victim_screen_is_fits_empty(self, kind, seed):
        rng = np.random.default_rng(600 + seed)
        nodes = _fleet(rng, kind)
        plugin = cs.CapacityScheduling()
        lister = SharedLister(nodes)
        for i, pod in enumerate(_pods(rng, FLEETS[kind])):
            state = CycleState({cs.VIEW_EPOCH_CONTEXT_KEY: i})
            req = pod_request(pod)
            assert plugin._victim_screen(state, pod, lister) == frozenset(
                ni.name for ni in nodes if cs._fits_empty(req, ni))


# ---------------------------------------------------------------------------
# the build and the binding
# ---------------------------------------------------------------------------

_BUILD_ONE = """
import json, sys
from pathlib import Path
from nos_tpu_torch.ops import _build
_build.KERNEL_DIR = Path(sys.argv[1])
r = _build.build_host("gpu_shim")
print(json.dumps({"cached": r["cached"], "path": str(r["path"])}))
"""


class TestShimBuild:
    def test_the_gil_handshake_sees_both_threads(self):
        # ctypes.CDLL drops the GIL for each call; PyDLL would not
        assert type(native.load()) is ctypes.CDLL
        assert native.gil_handshake(30.0) == [1, 1]

    def test_the_library_is_keyed_on_the_source(self, tmp_path,
                                                  monkeypatch):
        path = _build.host_library_path("gpu_shim")
        assert path.parent == _build.KERNEL_DIR
        src = tmp_path / "native"
        src.mkdir()
        text = (_build.NATIVE / "gpu_shim.cc").read_text()
        (src / "gpu_shim.cc").write_text(text)
        monkeypatch.setattr(_build, "NATIVE", src)
        assert _build.host_library_path("gpu_shim") == path
        (src / "gpu_shim.cc").write_text(text + "\n// edited\n")
        assert _build.host_library_path("gpu_shim") != path

    def test_two_processes_building_at_once_make_one_library(self,
                                                             tmp_path):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop("CXX", None)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, text=True) for _ in range(2)]
        outs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
        assert all(p.returncode == 0 for p in procs)
        assert outs[0]["path"] == outs[1]["path"]
        assert sorted(o["cached"] for o in outs) == [False, True]
        assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
            ["build.lock", Path(outs[0]["path"]).name])

    @pytest.mark.parametrize("compiler", ["/bin/false", "no-such-compiler"])
    def test_a_failed_build_raises(self, compiler, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setenv("CXX", compiler)
        with pytest.raises(native.NativeBuildError, match=compiler):
            native.load()
        assert not list(tmp_path.glob("*.so*"))

    def test_short_arrays_raise_before_the_call(self):
        with pytest.raises(ValueError, match="where 6 are read"):
            native.fit_batch([1.0] * 5, [1.0] * 3, [0.0] * 2, [0.0] * 2,
                             [0.0] * 2, [0.0] * 2, [0.0], [0.0], 2, 1, 3)
        with pytest.raises(ValueError, match="wrong length"):
            native.victim_prescreen([[1.0, 2.0], [1.0]], [1.0, 1.0],
                                    [0, 0], [0, 0], 0, 0)
        ll = ctypes.c_longlong
        gid = (ll * 2)(0, -1)
        with pytest.raises(ValueError, match="where 2 are read"):
            # the first candidate's window sizes run past the array
            native.score_batch((ctypes.c_uint8 * 2)(),
                               (ctypes.c_double * 2)(), gid, (ll * 2)(),
                               (ll * 2)(), (ll * 2)(0, 1), (ll * 1)(2),
                               (ll * 3)(0, 2, 2), (ll * 1)(), (ll * 1)(),
                               (ctypes.c_uint8 * 1)(), 2, 0)

    def test_refused_arguments_raise(self):
        with pytest.raises(ValueError, match="nos_fit_batch"):
            native.fit_batch([1.0] * 63, [1.0] * 63, [0.0], [0.0], [0.0],
                             [0.0], [0.0], [0.0], 1, 1, 63)
        none = (ctypes.c_longlong * 1)()
        with pytest.raises(ValueError, match="nos_score_batch"):
            native.score_batch((ctypes.c_uint8 * 1)(),
                               (ctypes.c_double * 1)(), none, none, none,
                               none, none, none, none, none,
                               (ctypes.c_uint8 * 1)(), 0, 0)


# ---------------------------------------------------------------------------
# the fleets decide the same with the native paths and without them
# ---------------------------------------------------------------------------

def _python_victim_screen(self, state, pod, nodes):
    """The capacity plugin's victim screen in Python: ``_fits_empty``."""
    if state.get(cs.VIEW_EPOCH_CONTEXT_KEY) is None:
        return None
    req = pod_request(pod)
    return frozenset(ni.name for ni in nodes.list()
                     if cs._fits_empty(req, ni))


@pytest.fixture
def python_only(monkeypatch):
    """Every native path off: the scheduler's screen dropped and its
    choose bound to the Python argmin (as a caller turns them off), the
    planner built with ``native_prescreen=False``, the victim screen in
    Python, and the shim's functions made to raise."""
    init = Scheduler.__init__

    def scheduler_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._prescreen = None
        self._native_choose = lambda pod, nis: None

    planner_init = GeometryPlanner.__init__

    def python_planner(self, *args, **kwargs):
        planner_init(self, *args, **{**kwargs, "native_prescreen": False})

    def refuse(*args, **kwargs):
        raise AssertionError("the shim was called on the Python path")

    monkeypatch.setattr(Scheduler, "__init__", scheduler_init)
    monkeypatch.setattr(GeometryPlanner, "__init__", python_planner)
    monkeypatch.setattr(cs.CapacityScheduling, "_victim_screen",
                        _python_victim_screen)
    for name in ("fit_batch", "fit_batch_raw", "score_batch",
                 "victim_prescreen"):
        monkeypatch.setattr(native, name, refuse)


@pytest.fixture
def journals(monkeypatch):
    """Every DecisionJournal a run makes, to read its records after."""
    made = []

    class Kept(J.DecisionJournal):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(J, "DecisionJournal", Kept)
    return made


@pytest.fixture
def native_calls(monkeypatch):
    """The calls into the shim's functions, by name."""
    calls: dict[str, int] = {}
    for name in ("fit_batch", "fit_batch_raw", "score_batch",
                 "victim_prescreen"):
        fn = getattr(native, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(native, name, counted)
    return calls


def _masked(value):
    """``value`` with every plan id masked: a plan's id is drawn fresh
    each run."""
    if isinstance(value, dict):
        return {k: "<plan>" if k == "plan_id" else _masked(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_masked(v) for v in value]
    return value


def _records(journals) -> list:
    return [[(r.category, r.subject, _masked(r.attrs)) for r in j.events()]
            for j in journals]


def _run_both(request, run):
    """``run()`` with the native paths, then with none; each run's
    result, its journals' records and the shim's calls."""
    calls = request.getfixturevalue("native_calls")
    made = request.getfixturevalue("journals")
    on = run()
    on_records, on_calls = _records(made), dict(calls)
    made.clear()
    request.getfixturevalue("python_only")
    off = run()
    return on, off, on_records, _records(made), on_calls


class TestDecisionsDoNotChange:
    @pytest.mark.parametrize("name,spec,digest", [
        ("quota", fleet.quota_fleet_spec, "QUOTA_FLEET_DIGEST"),
        ("gang", fleet.gang_fleet_spec, "GANG_FLEET_DIGEST"),
    ])
    def test_the_quota_and_gang_fleets(self, request, name, spec, digest):
        on, off, jon, joff, calls = _run_both(
            request, lambda: fleet.run_quota_fleet(spec(0)))
        assert on["summary"] == off["summary"]
        assert fleet.plan_digest(on["summary"]) == \
            getattr(chip_smoke, digest)
        assert _masked(on["waste"]) == _masked(off["waste"])
        assert jon == joff and any(jon)
        assert calls.get("fit_batch", 0) > 0
        assert calls.get("score_batch", 0) > 0
        if name == "quota":
            assert calls.get("victim_prescreen", 0) > 0

    def test_the_recovery_fleet(self, request):
        # the recovery run alone: its baseline holds no decision of
        # another kind
        on, off, jon, joff, calls = _run_both(
            request, lambda: fleet._recovery_run(
                fleet.recovery_fleet_spec(0), True))
        assert on["summary"] == off["summary"]
        assert fleet.plan_digest(on["summary"]) == \
            chip_smoke.RECOVERY_FLEET_DIGEST
        assert _masked(on["waste"]) == _masked(off["waste"])
        assert jon == joff and any(jon)
        assert calls.get("fit_batch_raw", 0) > 0
        assert calls.get("fit_batch", 0) > 0

    @pytest.mark.parametrize("scenario", fleet.CAPACITY_SCENARIOS)
    def test_the_capacity_fleets(self, request, scenario):
        on, off, _, _, calls = _run_both(
            request, lambda: fleet.run_capacity_fleet(scenario))
        # the summary holds the run's decision trace
        assert on["summary"] == off["summary"]
        assert fleet.plan_digest(on["summary"]) == \
            chip_smoke.CAPACITY_FLEET_DIGESTS[scenario]
        assert calls.get("fit_batch", 0) > 0

    @pytest.mark.parametrize("kind", ["mps", "mig"])
    def test_the_partition_plan(self, request, kind):
        if kind == "mps":
            spec = fleet.fleet_spec(0)
            parts = (TimeshareSnapshotTaker, TimeshareProfileCalculator,
                     TimesharePartitionCalculator, fleet.FLEET_DIGEST)
        else:
            spec = fleet.mig_fleet_spec(0)
            parts = (SliceSnapshotTaker, SliceProfileCalculator,
                     SlicePartitionCalculator, fleet.MIG_FLEET_DIGEST)
        taker, calc, part, digest = parts

        def run():
            journal = J.DecisionJournal(maxlen=1 << 16)
            prev = J.set_journal(journal)
            try:
                snap = taker().take_snapshot(fleet.build_cluster(spec))
                pending = fleet.build_pending(spec)
                GeometryPlanner(Framework(), calc(), part()).plan(
                    snap, pending)
            finally:
                J.set_journal(prev)
            bound = {b["name"] for n in spec["nodes"] for b in n["bound"]}
            return fleet.plan_summary(snap, pending, bound, calc())

        on, off, jon, joff, calls = _run_both(request, run)
        assert on == off and fleet.plan_digest(on) == digest
        assert jon == joff and any(jon)
        assert calls.get("fit_batch_raw", 0) > 0

    def test_the_parallel_plan(self, request):
        spec = fleet.domain_fleet_spec(0)

        def run():
            planner = ParallelGeometryPlanner(
                lambda: GeometryPlanner(Framework(),
                                        TimeshareProfileCalculator(),
                                        TimesharePartitionCalculator()),
                TimeshareProfileCalculator(), kind=C.MPS_KIND,
                max_workers=4, min_shard_hosts=0)
            journal = J.DecisionJournal(maxlen=1 << 16)
            prev = J.set_journal(journal)
            try:
                desired = planner.plan(
                    TimeshareSnapshotTaker().take_snapshot(
                        fleet.build_cluster(spec)),
                    fleet.build_pending(spec))
            finally:
                J.set_journal(prev)
                planner.close()
            return fleet.parallel_plan_summary(desired, [
                (r.category, r.subject, r.attrs) for r in journal.events()
                if r.category in (J.PLAN_NODE_COMMITTED,
                                  J.PLAN_NODE_REVERTED,
                                  J.PLAN_SHARD_MERGED)])

        on, off, _, _, calls = _run_both(request, run)
        assert on == off
        assert fleet.plan_digest(on) == chip_smoke.PARALLEL_FLEET_DIGEST
        assert calls.get("fit_batch_raw", 0) > 0


class TestSmokeFleet:
    """``chip_smoke.py``'s phase 19 at a cut size: two NVLink domains of
    64 nodes to plan, 64 nodes to schedule."""

    def test_the_plans_agree_with_the_screen_and_without(self):
        out = chip_smoke._scale_fleet_plans(domains=2, hosts=64, timed=1)
        assert out["nodes"] == 128 and out["pending"] == 80
        for workers in chip_smoke.FLEET_PLAN_WORKERS:
            assert out[f"on_workers_{workers}"]["prescreen_fails"] > 0
            assert out[f"off_workers_{workers}"]["prescreen_fails"] == 0
        assert out["nodes_carved"] > 0

    def test_the_cycles_agree_with_the_screen_and_without(self):
        out = chip_smoke._fleet_cycles(nodes=64, bound=512, steady=5)
        assert out["residents"] == 24 and out["journal_records"] > 0
        assert out["on"]["prescreen_fails"] > 0
        assert out["off"]["prescreen_fails"] == 0
        assert out["on"]["backstop_ms"] > 0

    def test_a_plan_that_differs_fails_the_phase(self, monkeypatch):
        # a plan whose decisions are not the first plan's fails the phase
        original = fleet.parallel_plan_summary
        seen = []

        def summary(desired, records):
            seen.append(1)
            out = original(desired, records)
            if len(seen) > 2:
                out["geometries"] = {}
            return out

        monkeypatch.setattr(fleet, "parallel_plan_summary", summary)
        with pytest.raises(SystemExit, match="differs from the first"):
            chip_smoke._scale_fleet_plans(domains=2, hosts=64, timed=1)

    def test_the_scale_specs_are_bench_fleet_s(self):
        spec = fleet.scale_plan_spec()
        assert len(spec["nodes"]) == 1024 and len(spec["pending"]) == 640
        assert sum(1 for n in spec["nodes"] if n["bound"]) == 512
        counts: dict = {}
        for p in spec["pending"][:22]:
            counts[p["profile"]] = counts.get(p["profile"], 0) + 1
        assert counts == dict(fleet.SCALE_MIX)
        assert [p["priority"] for p in spec["pending"][:4]] == [0, 1, 2, 0]
        with pytest.raises(ValueError):
            fleet.scale_cycle_api(nodes=1, bound=57)


def _ab_script():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "time_native_fleet.py"
    spec = importlib.util.spec_from_file_location("time_native_fleet", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("pairs, faster, slower, delta, spread, verdict", [
    (10, 0, 9, 1.0, 0.5, "on slower"),      # nine tenths, beyond spread
    (10, 9, 1, -1.0, 0.5, "on faster"),
    (10, 8, 2, -1.0, 0.5, "unresolved"),    # too few pairs won
    (10, 10, 0, -0.4, 0.5, "unresolved"),   # within the off side's spread
    (20, 1, 18, 2.0, 1.0, "on slower"),
    (20, 2, 17, 2.0, 1.0, "unresolved"),
    (10, 5, 5, 0.0, 0.0, "unresolved"),
])
def test_the_ab_verdict_is_the_ten_pair_rule(pairs, faster, slower, delta,
                                             spread, verdict):
    assert _ab_script()._verdict(pairs, faster, slower, delta,
                                 spread) == verdict
