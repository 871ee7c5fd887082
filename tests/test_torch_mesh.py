"""The port's mesh (nos_tpu_torch.parallel.mesh) against the JAX
package's: MeshSpec and factorize_pow2 case by case, the DeviceMesh over
gloo ranks, each rank's block of the batch against the shard JAX's
batch_sharding puts on the same device, and the rank launcher's results,
errors and timeout."""

import time

import jax
import numpy as np
import pytest

from nos_tpu.parallel import mesh as jmesh
from nos_tpu_torch.parallel import mesh as tmesh
from nos_tpu_torch.testing import ranks

PARSE = ["dp=2,fsdp=4", "fsdp=2,tp=2,sp=2", " tp=4 ", "dp=1,ep=2",
         "2x2x4", "8", "4x2", "2x2x2x2", "3x2x2x2x2", "1x1"]


class TestMeshSpec:
    @pytest.mark.parametrize("text", PARSE)
    def test_parse_matches_jax(self, text):
        got = tmesh.MeshSpec.parse(text)
        want = jmesh.MeshSpec.parse(text)
        assert got.shape() == want.shape() and got.size == want.size

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64])
    @pytest.mark.parametrize("want_sp,want_tp", [(True, True), (False, True),
                                                 (True, False)])
    def test_for_device_count_matches_jax(self, n, want_sp, want_tp):
        got = tmesh.MeshSpec.for_device_count(n, want_sp=want_sp,
                                              want_tp=want_tp)
        want = jmesh.MeshSpec.for_device_count(n, want_sp=want_sp,
                                               want_tp=want_tp)
        assert got.shape() == want.shape()

    def test_axes_match_jax(self):
        assert tmesh.AXES == jmesh.AXES

    def test_rules_cover_every_jax_axis(self):
        # the port's table names each mesh axis JAX's rules shard over
        text = " ".join(rule for _, rule in tmesh.DEFAULT_RULES)
        for _, axes in jmesh.DEFAULT_RULES:
            for ax in (axes if isinstance(axes, tuple) else (axes,)):
                if ax is not None and ax != "ep":
                    assert ax in text, ax


class TestFactorizePow2:
    @pytest.mark.parametrize("n,parts", [(1, 1), (1, 3), (2, 2), (8, 3),
                                         (16, 2), (64, 3), (256, 4)])
    def test_matches_jax(self, n, parts):
        assert tmesh.factorize_pow2(n, parts) == jmesh.factorize_pow2(n, parts)

    @pytest.mark.parametrize("n", [3, 6, 12])
    def test_not_a_power_of_two(self, n):
        with pytest.raises(ValueError, match="power of two") as got:
            tmesh.factorize_pow2(n, 2)
        with pytest.raises(ValueError) as want:
            jmesh.factorize_pow2(n, 2)
        assert str(got.value) == str(want.value)


# (spec, global batch rows x seq): the batch splits over dp x fsdp and sp
MESHES = [("fsdp=2", (4, 8)), ("dp=2,sp=2", (4, 8)),
          ("dp=2,fsdp=2,tp=2", (8, 6))]


@pytest.fixture(scope="module", params=MESHES, ids=[m for m, _ in MESHES])
def mesh_run(request):
    text, shape = request.param
    spec = tmesh.MeshSpec.parse(text)
    batch = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    return spec, batch, tmesh.run_ranks(ranks.mesh_cases, spec.size, text,
                                        batch, timeout=120)


class TestMakeMesh:
    def test_dims_and_coordinates(self, mesh_run):
        spec, _, out = mesh_run
        sizes = [spec.dp, spec.fsdp, spec.tp, spec.sp, spec.ep]
        for rank, got in enumerate(out):
            assert got["names"] == tmesh.AXES
            assert got["shape"] == tuple(sizes)
            assert got["spec"] == spec
            # rank order is row-major over (dp, fsdp, tp, sp, ep), the
            # order JAX's make_mesh reshapes jax.devices() in
            coords = np.unravel_index(rank, sizes)
            assert tuple(got["coords"][ax] for ax in tmesh.AXES) == \
                tuple(int(c) for c in coords)

    def test_size_mismatch_raises_the_jax_message(self, mesh_run):
        spec, _, out = mesh_run
        wrong = jmesh.MeshSpec(fsdp=2 * spec.size)
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(wrong, devices=jax.devices()[:spec.size])
        assert all(got["error"] == str(want.value) for got in out)

    def test_local_block_is_the_jax_shard(self, mesh_run):
        spec, batch, out = mesh_run
        mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec.shape()),
                               devices=jax.devices()[:spec.size])
        arr = jax.device_put(batch, jmesh.batch_sharding(mesh))
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for rank, got in enumerate(out):
            np.testing.assert_array_equal(got["block"],
                                          by_device[jax.devices()[rank]])


class TestRunRanks:
    def test_results_in_rank_order(self):
        assert tmesh.run_ranks(ranks.rank_and_world, 3, timeout=60) == [
            (0, 3), (1, 3), (2, 3)]

    def test_a_rank_error_raises_with_its_traceback(self):
        with pytest.raises(RuntimeError, match="rank 1 raised on purpose"):
            tmesh.run_ranks(ranks.raise_on, 2, 1, timeout=60)

    def test_a_hang_is_killed_at_the_timeout(self):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] not done"):
            tmesh.run_ranks(ranks.hang_on, 2, 1, timeout=8)
        assert time.monotonic() - t0 < 30
