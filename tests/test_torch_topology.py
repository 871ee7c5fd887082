"""The port's GPU domain model (nos_tpu_torch/topology) against the JAX
package's nos_tpu/topology where the two share a function (geometry
helpers, DeviceList, make_device_id: exact equality on the same
inputs), and the H100 MIG profile table and packer against the
published table.  The JAX package models TPU slices, so it has no MIG
counterpart: the table and the packer are held against the NVIDIA MIG
User Guide's H100 80GB table and a brute force over the 8 memory slots."""

import itertools
import json
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import nos_tpu.topology.device as jax_device
import nos_tpu.topology.geometry as jax_geometry
from nos_tpu_torch.topology import (
    DEFAULT_REGISTRY, H100_80GB, Device, DeviceList, FREE, GpuModelRegistry,
    Placement, USED, enumerate_geometries, extend, feasible,
    fewest_slices_geometry, geometry_equal, make_device_id, num_slices, pack,
)
from nos_tpu_torch.topology import errors, profile

PROFILES = ("1g.10gb", "1g.10gb+me", "1g.20gb", "2g.20gb", "3g.40gb",
            "4g.40gb", "7g.80gb")


def _random_geometries(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    names = list(PROFILES) + ["8gb", "24gb"]
    out = []
    for _ in range(n):
        keys = rng.choice(names, size=rng.integers(0, 5), replace=False)
        out.append({str(k): int(rng.integers(-1, 4)) for k in keys})
    return out


class TestParityWithJax:
    @pytest.mark.parametrize("seed", range(4))
    def test_geometry_helpers(self, seed):
        geoms = _random_geometries(seed, 12)
        for a, b in itertools.product(geoms, repeat=2):
            assert geometry_equal(a, b) == jax_geometry.geometry_equal(a, b)
        for g in geoms:
            assert num_slices(g) == jax_geometry.num_slices(g)
        assert fewest_slices_geometry(geoms) == \
            jax_geometry.fewest_slices_geometry(geoms)
        assert fewest_slices_geometry([]) is None \
            and jax_geometry.fewest_slices_geometry([]) is None

    def test_zero_counts_do_not_count(self):
        a, b = {"1g.10gb": 2, "3g.40gb": 0}, {"1g.10gb": 2}
        assert geometry_equal(a, b) and jax_geometry.geometry_equal(a, b)

    def test_device_list_grouping(self):
        rng = np.random.default_rng(7)
        rows = [(profile.slice_resource_name(str(rng.choice(PROFILES))),
                 f"dev-{i}", str(rng.choice([USED, FREE])),
                 int(rng.integers(0, 3))) for i in range(20)]
        ours = DeviceList(Device(*r) for r in rows)
        theirs = jax_device.DeviceList(jax_device.Device(*r) for r in rows)

        def flat(groups):
            return {k: [dataclass_tuple(d) for d in v]
                    for k, v in groups.items()}

        assert flat(ours.group_by_unit()) == flat(theirs.group_by_unit())
        assert flat(ours.group_by_resource()) == \
            flat(theirs.group_by_resource())
        for status in (USED, FREE):
            assert [dataclass_tuple(d) for d in ours.with_status(status)] == \
                [dataclass_tuple(d) for d in theirs.with_status(status)]
        assert ours.ids() == theirs.ids()
        assert (USED, FREE) == (jax_device.USED, jax_device.FREE)

    @pytest.mark.parametrize("unit,suffix,ordinal",
                             [(0, "1g.10gb", 1), (3, "gpu-24gb", 12),
                              (7, "3g.40gb", 0)])
    def test_make_device_id(self, unit, suffix, ordinal):
        assert make_device_id(unit, suffix, ordinal) == \
            jax_device.make_device_id(unit, suffix, ordinal)


def dataclass_tuple(d):
    return (d.resource_name, d.device_id, d.status, d.unit_index)


class TestMigTable:
    def test_h100_table_is_the_published_one(self):
        # NVIDIA MIG User Guide, H100 80GB: profile, g, memory slices
        # (the placement's size), GB, max count, allowed starts
        want = {
            "1g.10gb": (1, 1, 10, 7, (0, 1, 2, 3, 4, 5, 6)),
            "1g.10gb+me": (1, 1, 10, 1, (0, 1, 2, 3, 4, 5, 6)),
            "1g.20gb": (1, 2, 20, 4, (0, 2, 4, 6)),
            "2g.20gb": (2, 2, 20, 3, (0, 2, 4)),
            "3g.40gb": (3, 4, 40, 2, (0, 4)),
            "4g.40gb": (4, 4, 40, 1, (0,)),
            "7g.80gb": (7, 8, 80, 1, (0,)),
        }
        got = {p.name: (p.compute_slices, p.memory_slices, p.memory_gb,
                        p.max_count, p.starts) for p in H100_80GB.mig_profiles}
        assert got == want
        assert (H100_80GB.name, H100_80GB.memory_gb, H100_80GB.sm_count,
                H100_80GB.compute_slices, H100_80GB.memory_slices) == \
            ("nvidia-h100-80gb-hbm3", 80, 132, 7, 8)
        # NVML_GPU_INSTANCE_PROFILE_{1_SLICE, 1_SLICE_REV1, 1_SLICE_REV2,
        # 2_SLICE, 3_SLICE, 4_SLICE, 7_SLICE}
        assert [p.nvml_id for p in H100_80GB.mig_profiles] == \
            [0, 7, 9, 1, 2, 3, 4]
        assert [p.name for p in H100_80GB.mig_profiles
                if profile.is_media_profile(p.name)] == ["1g.10gb+me"]

    def test_models_compare_by_identity(self):
        from dataclasses import replace

        twin = replace(H100_80GB)
        assert twin != H100_80GB and twin.name == H100_80GB.name
        assert len({H100_80GB, twin}) == 2

    @pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3",
                                      "NVIDIA H100 80GB HBM3 MIG 1g.10gb"])
    def test_product_names_match(self, name):
        assert DEFAULT_REGISTRY.match(name) is H100_80GB

    @pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                      "NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                                      "Tesla T4"])
    def test_other_cards_are_not_in_the_table(self, name):
        assert DEFAULT_REGISTRY.match(name) is None


VALID = [
    {"3g.40gb": 1, "4g.40gb": 1},
    {"3g.40gb": 2},
    {"1g.10gb": 7},
    {"4g.40gb": 1, "1g.10gb": 3},
    {"2g.20gb": 3, "1g.10gb": 1},
    {"1g.20gb": 4},
]
INVALID = [
    {"4g.40gb": 2},
    {"7g.80gb": 1, "1g.10gb": 1},
    {"1g.10gb": 8},
    {"3g.40gb": 3},
]


def _check_placements(counts, placements, fixed=()):
    seen = {}
    occupied = 0
    g = 0
    for pl in list(fixed) + list(placements):
        prof = H100_80GB.profile(pl.profile)
        assert pl.start in prof.starts and pl.size == prof.memory_slices
        assert not occupied & pl.mask
        assert pl.start + pl.size <= H100_80GB.memory_slices
        occupied |= pl.mask
        g += prof.compute_slices
    for pl in placements:
        seen[pl.profile] = seen.get(pl.profile, 0) + 1
    assert seen == {k: v for k, v in counts.items() if v}
    assert g <= H100_80GB.compute_slices


def _brute_force(counts, fixed=()) -> bool:
    """Every assignment of allowed starts to every instance, each profile
    within its most instances."""
    if any(c > H100_80GB.profile(name).max_count
           for name, c in counts.items()):
        return False
    rows = [H100_80GB.profile(name) for name, c in counts.items()
            for _ in range(c)]
    occupied = 0
    g = 0
    for pl in fixed:
        occupied |= pl.mask
        g += H100_80GB.profile(pl.profile).compute_slices
    if g + sum(p.compute_slices for p in rows) > H100_80GB.compute_slices:
        return False
    for starts in itertools.product(*[p.starts for p in rows]):
        occ = occupied
        ok = True
        for p, s in zip(rows, starts):
            mask = ((1 << p.memory_slices) - 1) << s
            if occ & mask or s + p.memory_slices > H100_80GB.memory_slices:
                ok = False
                break
            occ |= mask
        if ok:
            return True
    return False


class TestPacking:
    @pytest.mark.parametrize("counts", VALID, ids=str)
    def test_valid(self, counts):
        placements = pack(H100_80GB, counts)
        assert placements is not None and feasible(H100_80GB, counts)
        _check_placements(counts, placements)

    @pytest.mark.parametrize("counts", INVALID, ids=str)
    def test_invalid(self, counts):
        assert pack(H100_80GB, counts) is None
        assert not feasible(H100_80GB, counts)
        assert not _brute_force(counts)

    def test_unknown_profile_is_infeasible(self):
        assert pack(H100_80GB, {"1g.12gb": 1}) is None

    @settings(max_examples=150, deadline=None)
    @given(st.dictionaries(st.sampled_from(PROFILES),
                           st.integers(min_value=0, max_value=4),
                           max_size=4))
    def test_pack_agrees_with_brute_force(self, counts):
        counts = {k: v for k, v in counts.items() if v}
        placements = pack(H100_80GB, counts)
        if placements is None:
            assert not feasible(H100_80GB, counts)
        else:
            _check_placements(counts, placements)
        assert (placements is not None) == _brute_force(counts)

    def test_extend_keeps_the_fixed_placements(self):
        fixed = [Placement("3g.40gb", 4, 4)]
        new = extend(H100_80GB, fixed, {"2g.20gb": 2})
        _check_placements({"2g.20gb": 2}, new, fixed)
        assert {pl.start for pl in new} == {0, 2}
        # the 4g needs slot 0..3 free and the compute slices to spare
        assert extend(H100_80GB, fixed, {"4g.40gb": 1}) is not None
        assert extend(H100_80GB, [Placement("1g.10gb", 0, 1)],
                      {"4g.40gb": 1}) is None
        assert extend(H100_80GB, fixed, {"3g.40gb": 1, "1g.10gb": 1}) is None
        assert pack(H100_80GB, {"1g.10gb": 1}, fixed) == \
            extend(H100_80GB, fixed, {"1g.10gb": 1})

    @settings(max_examples=60, deadline=None)
    @given(st.sampled_from(VALID), st.dictionaries(
        st.sampled_from(PROFILES), st.integers(0, 3), max_size=3))
    def test_extend_agrees_with_brute_force(self, base, counts):
        fixed = pack(H100_80GB, base)
        counts = {k: v for k, v in counts.items() if v}
        new = extend(H100_80GB, fixed, counts)
        if new is not None:
            _check_placements(counts, new, fixed)
        assert (new is not None) == _brute_force(counts, fixed)

    def test_overlapping_fixed_placements_place_nothing(self):
        fixed = [Placement("3g.40gb", 0, 4), Placement("2g.20gb", 2, 2)]
        assert extend(H100_80GB, fixed, {}) is None

    def test_enumerate_geometries(self):
        geoms = enumerate_geometries(H100_80GB)
        assert enumerate_geometries(H100_80GB) is geoms      # cached
        as_dicts = [dict(g) for g in geoms]
        for g in as_dicts:
            assert feasible(H100_80GB, g)
            for name in PROFILES:          # maximal
                assert not feasible(H100_80GB, {**g, name: g.get(name, 0) + 1})
        for counts in VALID:
            if counts in as_dicts:
                continue
            # every valid set lies under some maximal geometry
            assert any(all(g.get(k, 0) >= v for k, v in counts.items())
                       for g in as_dicts), counts
        for want in ({"7g.80gb": 1}, {"1g.10gb": 7}, {"3g.40gb": 2},
                     {"3g.40gb": 1, "4g.40gb": 1}, {"1g.20gb": 4},
                     {"2g.20gb": 3, "1g.10gb": 1}):
            assert want in as_dicts
        assert len(as_dicts) == len({tuple(sorted(g.items()))
                                     for g in as_dicts})


class TestRegistry:
    def test_get(self):
        reg = GpuModelRegistry()
        assert reg.get("nvidia-h100-80gb-hbm3") is H100_80GB
        with pytest.raises(KeyError, match="unknown accelerator"):
            reg.get("nvidia-b200")

    def test_override_restricts_the_table(self, tmp_path):
        path = tmp_path / "models.json"
        path.write_text(json.dumps({"nvidia-h100-80gb-hbm3": {
            "mig_profiles": ["3g.40gb", "7g.80gb"]}}))
        reg = GpuModelRegistry()
        reg.load_overrides(str(path))
        model = reg.get("nvidia-h100-80gb-hbm3")
        assert model is not H100_80GB
        assert model.profile_names() == ["3g.40gb", "7g.80gb"]
        assert [dict(g) for g in enumerate_geometries(model)] == \
            [{"3g.40gb": 2}, {"7g.80gb": 1}]
        assert not feasible(model, {"1g.10gb": 1})
        assert feasible(H100_80GB, {"1g.10gb": 1})
        path.write_text(json.dumps({"nvidia-h100-80gb-hbm3": {
            "mig_profiles": ["9g.90gb"]}}))
        with pytest.raises(ValueError, match="9g.90gb"):
            reg.load_overrides(str(path))

    def test_override_adds_a_card(self, tmp_path):
        a100 = {"product_patterns": [r"A100.*80GB"], "memory_gb": 80,
                "sm_count": 108, "mig_profiles": [
                    {"name": "1g.10gb", "compute_slices": 1,
                     "memory_slices": 1, "memory_gb": 10, "max_count": 7,
                     "starts": list(range(7)), "nvml_id": 0},
                    {"name": "7g.80gb", "compute_slices": 7,
                     "memory_slices": 8, "memory_gb": 80, "max_count": 1,
                     "starts": [0], "nvml_id": 4}]}
        path = tmp_path / "models.json"
        path.write_text(json.dumps({"nvidia-a100-80gb": a100}))
        reg = GpuModelRegistry()
        reg.load_overrides(str(path))
        model = reg.match("NVIDIA A100-SXM4-80GB")
        assert model is reg.get("nvidia-a100-80gb")
        assert (model.memory_gb, model.sm_count, model.compute_slices) == \
            (80, 108, 7)
        assert [dict(g) for g in enumerate_geometries(model)] == \
            [{"1g.10gb": 7}, {"7g.80gb": 1}]
        assert DEFAULT_REGISTRY.match("NVIDIA A100-SXM4-80GB") is None


class TestProfiles:
    def test_slice_resources(self):
        assert profile.slice_resource_name("3g.40gb") == "nvidia.com/mig-3g.40gb"
        assert profile.profile_from_resource("nvidia.com/mig-1g.10gb") == \
            "1g.10gb"
        for bad in ("nvidia.com/mig-1g", "nvidia.com/gpu-24gb",
                    "nos.tpu/slice-2x2", "nvidia.com/mig-1g.10gb+me"):
            assert profile.profile_from_resource(bad) is None
            assert not profile.is_slice_resource(bad)
        # "2x2" names an NVLink block (2 nodes of 2 GPUs); a one-node
        # "block" names nothing
        assert profile.slice_resource_name("2x2") == \
            "nos.nebuly.com/nvlink-block-2x2"
        with pytest.raises(ValueError):
            profile.slice_resource_name("1x2")
        for name in PROFILES:
            assert profile.profile_from_resource(
                profile.slice_resource_name(name)) == name

    def test_timeshare_resources(self):
        assert profile.timeshare_resource_name(24) == "nvidia.com/gpu-24gb"
        assert profile.gb_from_resource("nvidia.com/gpu-24gb") == 24
        assert profile.is_timeshare_resource("nvidia.com/gpu-8gb")
        for bad in ("nvidia.com/gpu", "nvidia.com/gpu-24", "nos.tpu/tpu-8gb",
                    "nvidia.com/mig-1g.10gb"):
            assert profile.gb_from_resource(bad) is None
            assert not profile.is_timeshare_resource(bad)

    def test_extract_requests(self):
        req = {"nvidia.com/mig-1g.10gb": 2, "nvidia.com/mig-3g.40gb": 1,
               "nvidia.com/mig-2g.20gb": 0, "nvidia.com/gpu-24gb": 3,
               "nvidia.com/gpu-8gb": -1, "cpu": 4,
               "memory": 8 * 1024 ** 3, "nvidia.com/gpu": 1}
        assert profile.extract_slice_requests(req) == {"1g.10gb": 2,
                                                       "3g.40gb": 1}
        assert profile.extract_timeshare_requests(req) == {24: 3}

    def test_profile_sort_key(self):
        names = ["7g.80gb", "24gb", "1g.20gb", "8gb", "2g.20gb", "1g.10gb",
                 "weird"]
        assert sorted(names, key=profile.profile_sort_key) == [
            "8gb", "1g.10gb", "1g.20gb", "2g.20gb", "24gb", "7g.80gb",
            "weird"]


# A Kubernetes extended-resource name (a qualified name) and an
# annotation key: DNS-subdomain prefix, then a name of alphanumerics,
# "-", "_" and "." (k8s.io/apimachinery validation.IsQualifiedName)
QUALIFIED_NAME = re.compile(
    r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?/[A-Za-z0-9]([-A-Za-z0-9_.]*"
    r"[A-Za-z0-9])?$")


class TestMediaProfiles:
    """24d: ``1g.10gb+me``, the H100's media-extension profile, parses,
    is spelled without "+" wherever Kubernetes names it, and is planned
    only for a pod that asks for it."""

    def test_the_profile_parses(self):
        m = profile.PROFILE_RE.match("1g.10gb+me")
        assert (m.group("g"), m.group("gb"), m.group("me")) == \
            ("1", "10", "+me")
        assert profile.is_media_profile("1g.10gb+me")
        assert not profile.is_media_profile("1g.10gb")
        for bad in ("1g.10gb+", "1g.10gb+gfx", "1g.10gb.me", "1g.10gbme"):
            assert profile.PROFILE_RE.match(bad) is None
        assert profile.profile_sort_key("1g.10gb+me") == (10, "1g.10gb+me")

    @pytest.mark.parametrize("name", [p.name for p in H100_80GB.mig_profiles])
    def test_profile_to_resource_name_is_legal(self, name):
        res = profile.slice_resource_name(name)
        assert QUALIFIED_NAME.match(res), res
        assert "+" not in res
        assert profile.profile_from_resource(res) == name

    def test_resource_name_to_profile(self):
        assert profile.profile_from_resource("nvidia.com/mig-1g.10gb.me") == \
            "1g.10gb+me"
        assert profile.slice_resource_name("1g.10gb+me") == \
            "nvidia.com/mig-1g.10gb.me"
        assert profile.extract_slice_requests(
            {"nvidia.com/mig-1g.10gb.me": 1, "nvidia.com/mig-1g.10gb": 2}) \
            == {"1g.10gb+me": 1, "1g.10gb": 2}
        for key in ("1g.10gb", "3g.40gb", "24gb"):
            assert profile.profile_key(key) == key
            assert profile.profile_from_key(key) == key
        assert profile.profile_key("1g.10gb+me") == "1g.10gb.me"
        assert profile.profile_from_key("1g.10gb.me") == "1g.10gb+me"

    def test_annotation_keys_are_legal_and_round_trip(self):
        from nos_tpu_torch.topology import annotations as A

        spec = A.spec_from_geometries({0: {"1g.10gb+me": 1, "1g.10gb": 6}})
        status = A.status_from_units([type("U", (), {
            "index": 0, "used_names": lambda self: {"1g.10gb+me": 1},
            "free_names": lambda self: {"1g.10gb": 6}})()])
        for key in {**spec, **status}:
            assert QUALIFIED_NAME.match(key), key
        assert [(a.index, a.profile, a.quantity)
                for a in A.parse_spec_annotations(spec)] == \
            [(0, "1g.10gb", 6), (0, "1g.10gb+me", 1)]
        assert [(a.profile, a.status) for a in
                A.parse_status_annotations(status)] == \
            [("1g.10gb", "free"), ("1g.10gb+me", "used")]
        annots = {**spec, **status}
        assert A.spec_matches_status(annots, family="mig")
        A.strip_spec_annotations(annots, family="mps")
        assert len(annots) == 4
        A.strip_spec_annotations(annots, family="mig")
        A.strip_status_annotations(annots, family="mig")
        assert annots == {}

    def test_planned_only_for_a_pod_that_asks(self):
        from nos_tpu_torch.topology.slice_unit import SliceUnit

        unit = SliceUnit(model=H100_80GB)
        unit.init_geometry()
        assert unit.geometry_names() == {"7g.80gb": 1}
        assert unit.update_geometry_for({"1g.10gb": 3})
        assert "1g.10gb+me" not in unit.geometry_names()
        asked = SliceUnit(model=H100_80GB)
        asked.init_geometry()
        assert asked.update_geometry_for({"1g.10gb+me": 1})
        assert asked.free_names().get("1g.10gb+me") == 1
        # a used media instance stays where the re-carve serves others
        asked.allocate("1g.10gb+me")
        assert asked.update_geometry_for({"3g.40gb": 1})
        assert asked.used_names() == {"1g.10gb+me": 1}
        assert asked.free_names().get("3g.40gb") == 1

    def test_a_media_pod_is_planned_and_bound_on_a_mig_node(self):
        from nos_tpu_torch.testing import devcluster
        from nos_tpu_torch.testing.factory import make_pod

        nodes = devcluster.kind_nodes()
        pod = make_pod("video", resources={"nvidia.com/mig-1g.10gb.me": 1})
        got = devcluster.plan_and_bind(nodes, [pod])
        mig = nodes[0].metadata.name
        assert got["bound"] == {"video": mig}
        assert got["geometry"][mig].get("nvidia.com/mig-1g.10gb.me") == 1.0


def test_errors():
    assert errors.is_not_found(errors.DeviceNotFoundError("x"))
    assert not errors.is_not_found(errors.InvalidProfileError("x"))
    assert not errors.ErrorList([])
    el = errors.ErrorList([ValueError("a"), KeyError("b")])
    assert el and "a" in str(el)
    assert issubclass(errors.PlacementInfeasibleError, errors.TopologyError)
