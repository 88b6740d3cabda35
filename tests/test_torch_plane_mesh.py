"""The port's plane meshes on the CPU: the mesh grammar, the sharded ops,
the sharded row store and the clustering scenario, each case a counterpart
of one in ``tests/test_sharded_plane.py`` or
``tests/test_model_axis_plane.py`` (whose in-process cases need several
JAX devices and skip in a one-device run).

A mesh here repeats the one ``cpu`` device: 8 row shards, or 4 row shards
x 2 model shards. Every shard's launch, padding and join runs for real.
Sharded ops are held bit for bit to the port's single-device ops, with
two exceptions the reference's docstrings also make: segment sums (added
over shards in shard order) to 1 ulp, and dim-sharded L1 distances, which
are the per-chunk sums added over the model shards in order (checked
exactly against that sum, and to rtol 1e-6 against the single-device
distance). Against the reference's single-device ops: identical argmins,
blends bit for bit, distances and scores within the port's usual rtol
1e-5 (its plain sums are not jnp's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import DynamicClustering as JaxClustering
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.clustering import DynamicClustering
from repro_torch.core.plane import ParameterPlane
from repro_torch.kernels import ops
from repro_torch.kernels.plane_sharded import MeshRows
from repro_torch.launch.mesh import make_plane_mesh, mesh_from_spec, parse_spec, resolve_mesh
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CPU = torch.device("cpu")
MESHES = {"1x8": (8, 1), "4x2": (4, 2)}


def cpu_mesh(rows: int, dims: int = 1):
    return make_plane_mesh(rows, dim_shards=dims, devices=[CPU] * (rows * dims))


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    return cpu_mesh(*MESHES[request.param])


def _rand(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk_sum_l1(xs: np.ndarray, cs: np.ndarray, m: int) -> torch.Tensor:
    """The dim-sharded distances: each chunk's single-device L1, then the
    chunks added in order (plane_sharded's join)."""
    parts = [ops.l1_distance_pairwise(_t(x), _t(c)) for x, c in zip(np.split(xs, m, -1), np.split(cs, m, -1))]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


# ------------------------------------------------------------------ grammar
def test_mesh_spec_grammar():
    for off in ("", "0", "off", "none", " OFF "):
        assert parse_spec(off) is None and mesh_from_spec(off, [CPU] * 8) is None
    m = mesh_from_spec("1", [CPU] * 8)
    assert m is not None and m.shape == {"plane": 1}  # "1" is one shard, not auto
    m = mesh_from_spec("8", [CPU] * 8)
    assert m.axis_names == ("plane",) and m.shape == {"plane": 8}
    m = mesh_from_spec("4x2", [CPU] * 8)
    assert m.axis_names == ("plane", "model") and m.shape == {"plane": 4, "model": 2}
    assert m.row_shards == 4 and m.first_device == CPU
    assert mesh_from_spec("auto", [CPU] * 8).shape == {"plane": 8}
    assert mesh_from_spec("auto", [CPU]) is None  # one device: no mesh
    # the entry points' form: on the CPU a spec repeats the cpu device; auto is one CPU
    assert resolve_mesh("4x2", "cpu").shape == {"plane": 4, "model": 2}
    assert resolve_mesh("auto", "cpu") is None and resolve_mesh(None, "cpu") is None
    assert resolve_mesh(m, "cpu") is m


def test_make_plane_mesh_rejects_what_it_cannot_lay_out():
    with pytest.raises(ValueError, match="must divide"):
        make_plane_mesh(2, dim_shards=3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_plane_mesh(8, dim_shards=2, devices=[CPU] * 8)
    if torch.cuda.device_count() < 2:  # no cards here: a mesh of cards cannot be built
        with pytest.raises(ValueError):
            make_plane_mesh(2)
    with pytest.raises(ValueError, match="starts on"):
        resolve_mesh(make_plane_mesh(2, devices=["meta", "meta"]), "cpu")


def test_the_port_reads_no_mesh_variable(monkeypatch):
    """A mesh comes only by argument: the reference's knobs change nothing."""
    for name, value in (("REPRO_PLANE_MESH", "8"), ("REPRO_FLEET_MESH", "8"),
                        ("REPRO_PLANE_MESH_MIN_ROWS", "0"), ("REPRO_PLANE_MODEL_COMPUTE", "off")):
        monkeypatch.setenv(name, value)
    cl = DynamicClustering(2, backend="plane")
    assert cl.mesh is None and cl.mesh_min_rows == 128
    cl.assign("c0", {"w": torch.zeros(8)})
    assert cl.plane.mesh is None and not cl.plane.sharded


def test_dim_shards_dispatch_rules():
    m = cpu_mesh(4, 2)
    assert ops._dim_shards(m, "model", 300) == 2
    assert ops._dim_shards(m, "model", 301) == 1  # indivisible: rows only
    assert ops._dim_shards(m, None, 300) == 1
    assert ops._dim_shards(None, "model", 300) == 1
    assert ops._dim_shards(cpu_mesh(8), "model", 300) == 1  # no model axis


# -------------------------------------------------------------- sharded ops
class TestShardedOps:
    def test_l1_pairwise_against_single_device(self, mesh):
        xs, cs = _rand(0, 11, 300), _rand(1, 5, 300)
        got = ops.l1_distance_pairwise(_t(xs), _t(cs), mesh=mesh)
        want = ops.l1_distance_pairwise(_t(xs), _t(cs))
        if mesh.shape.get("model", 1) == 1:
            torch.testing.assert_close(got, want, rtol=0, atol=0)  # per-row sums: bitwise
        else:
            torch.testing.assert_close(got, _chunk_sum_l1(xs, cs, 2), rtol=0, atol=0)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
            np.testing.assert_array_equal(got.argmin(1).numpy(), want.argmin(1).numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(jref.l1_distance_pairwise_ref(xs, cs)), rtol=1e-5)

    def test_l1_pairwise_fewer_rows_than_shards(self, mesh):
        xs, cs = _rand(2, 1, 200), _rand(3, 3, 200)
        got = ops.l1_distance_pairwise(_t(xs), _t(cs), mesh=mesh)
        assert got.shape == (1, 3)
        want = ops.l1_distance_pairwise(_t(xs), _t(cs)) if "model" not in mesh.shape else _chunk_sum_l1(xs, cs, 2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_l1_pairwise_indivisible_dim_falls_back_bitwise(self):
        xs, cs = _rand(4, 9, 301), _rand(5, 4, 301)
        got = ops.l1_distance_pairwise(_t(xs), _t(cs), mesh=cpu_mesh(4, 2))
        torch.testing.assert_close(got, ops.l1_distance_pairwise(_t(xs), _t(cs)), rtol=0, atol=0)

    def test_l1_pairwise_model_compute_off_restores_row_compute(self):
        """``dim_axis=None`` (the reference's REPRO_PLANE_MODEL_COMPUTE=off):
        rows over the plane axis only, bitwise the single device."""
        xs, cs = _rand(6, 11, 300), _rand(7, 5, 300)
        got = ops.l1_distance_pairwise(_t(xs), _t(cs), mesh=cpu_mesh(4, 2), dim_axis=None)
        torch.testing.assert_close(got, ops.l1_distance_pairwise(_t(xs), _t(cs)), rtol=0, atol=0)

    @pytest.mark.parametrize("c", [1, 3, 8, 11])
    def test_assign_and_lerp_against_single_device_and_reference(self, mesh, c):
        u, cs = _rand(c, 300), _rand(c + 100, c, 300)
        d, i, b = ops.assign_and_lerp(_t(u), _t(cs), 0.25, mesh=mesh)
        ds, is_, bs = ops.assign_and_lerp(_t(u), _t(cs), 0.25)
        assert d.shape == (c,) and i.dtype == torch.int32 and int(i) == int(is_)
        torch.testing.assert_close(b, bs, rtol=0, atol=0)  # the blend is elementwise: bitwise
        if "model" in mesh.shape:
            torch.testing.assert_close(d, _chunk_sum_l1(u[None], cs, 2)[0], rtol=0, atol=0)
            np.testing.assert_allclose(d.numpy(), ds.numpy(), rtol=1e-6)
        else:
            torch.testing.assert_close(d, ds, rtol=0, atol=0)
        dj, ij, bj = jops.assign_and_lerp(jnp.asarray(u), jnp.asarray(cs), 0.25)
        assert int(ij) == int(i)
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5)

    def test_assign_and_lerp_padded_rows_never_win(self, mesh):
        # a zero padding row would be L1-closest to a near-zero upload were it
        # not masked: the argmin stays inside the real rows
        u = torch.full((256,), 1e-3)
        cs = torch.stack([torch.full((256,), 50.0), torch.full((256,), -40.0), torch.full((256,), 30.0)])
        d, i, b = ops.assign_and_lerp(u, cs, 0.5, mesh=mesh)
        assert int(i) == 2 and bool(torch.isfinite(d).all())

    def test_assign_fetches_a_negative_zero_as_positive_zero(self):
        """The winner's row comes back as the owner's row plus the other
        shards' zeros, as the reference's one-hot psum: -0 becomes +0."""
        cs = torch.tensor([[5.0, 5.0], [-0.0, 1.0]])
        u = torch.tensor([-0.0, 1.0])
        _, i, b = ops.assign_and_lerp(u, cs, 0.5, mesh=cpu_mesh(8))
        assert int(i) == 1 and torch.equal(torch.signbit(b), torch.tensor([False, False]))
        _, _, bs = ops.assign_and_lerp(u, cs, 0.5)
        assert bool(torch.signbit(bs)[0])  # the single device keeps the sign

    def test_chi2_segmented_g_bitwise_sums_within_one_ulp(self, mesh):
        sizes = [2, 1, 9, 4]
        m, s = sum(sizes), len(sizes)
        fp, ft = _rand(7, m, 6, scale=100.0), np.abs(_rand(8, m, 6, scale=100.0)) + 1.0
        ss = torch.softmax(_t(_rand(9, m, 6)), -1)
        seg = torch.from_numpy(np.repeat(np.arange(s), sizes).astype(np.int32))
        g, seg_sum = ops.chi2_feedback_segmented(_t(fp), _t(ft), ss, seg, s, mesh=mesh)
        g1, seg1 = ops.chi2_feedback_segmented(_t(fp), _t(ft), ss, seg, s)
        torch.testing.assert_close(g, g1, rtol=0, atol=0)  # per member: bitwise
        np.testing.assert_array_max_ulp(seg_sum.numpy(), seg1.numpy(), maxulp=1)
        onehot = jnp.asarray(np.eye(s, dtype=np.float32)[seg.numpy()])
        gj, sj = jref.chi2_feedback_segmented_ref(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss.numpy()), onehot)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(seg_sum.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("m", [3, 11, 16])
    def test_chi2_rows_bitwise_against_single_device(self, mesh, m):
        """The dissolve and reassignment probes: rows over both axes, at row
        counts that do not divide the shards."""
        fp, ft = _rand(m, m, 6, scale=100.0), np.abs(_rand(m + 1, m, 6, scale=100.0)) + 1.0
        ss = torch.softmax(_t(_rand(m + 2, m, 6)), -1)
        got = ops.chi2_feedback(_t(fp), _t(ft), ss, mesh=mesh)
        assert got.shape == (m,)
        torch.testing.assert_close(got, ops.chi2_feedback(_t(fp), _t(ft), ss), rtol=0, atol=0)
        want = jref.chi2_feedback_ref(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def test_sharded_calls_launch_once_a_shard(self, mesh):
        """Each sharded call runs the single-device op once a shard (counted
        here by the calls of the shard function it is handed)."""
        seen = []

        def local(x, c):
            seen.append(x.shape[0])
            return ops.l1_distance_pairwise(x, c)

        xs = ops._to_mesh_rows(mesh, _t(_rand(10, 5, 300)), dim_axis="model" if "model" in mesh.shape else None)
        from repro_torch.kernels import plane_sharded

        plane_sharded.l1_pairwise_sharded(xs, _t(_rand(11, 3, 300)), mesh, local)
        shards = mesh.shape["plane"] * mesh.shape.get("model", 1)
        assert len(seen) == shards and set(seen) == {-(-5 // mesh.shape["plane"])}


# ---------------------------------------------------------- sharded storage
def _template(dim: int = 187) -> dict:
    return {"w": torch.zeros(dim)}  # 187: no model axis of 2 or more divides it


def _layout_ok(plane: ParameterPlane) -> bool:
    """Every block on its shard's device, row shards equal."""
    rl = plane._rows_local
    return all(b.shape[0] == rl and b.device == plane._grid[r][m]
               for r, blocks in enumerate(plane._blocks) for m, b in enumerate(blocks))


class TestShardedPlane:
    def test_capacity_rounds_to_shard_multiple(self, mesh):
        plane = ParameterPlane(_template(), capacity=mesh.shape["plane"] + 1, mesh=mesh)
        assert plane.capacity % mesh.shape["plane"] == 0 and plane.sharded and _layout_ok(plane)

    def test_writes_keep_layout_and_rows(self, mesh):
        plane = ParameterPlane(_template(300), capacity=16, mesh=mesh)
        r0, r1, r2 = plane.alloc(), plane.alloc(), plane.alloc()
        plane.write(r0, torch.full((300,), 2.0))
        plane.write_rows([r2, r1], torch.stack([torch.full((300,), 4.0), torch.full((300,), 3.0)]))
        assert _layout_ok(plane)
        np.testing.assert_array_equal(plane.take([r0, r1, r2]).numpy()[:, 0], [2.0, 3.0, 4.0])
        r, local = divmod(r2, plane._rows_local)  # row i lives in block i // rows_local
        assert float(plane._blocks[r][0][local, 0]) == 4.0
        assert plane.dim_sharded == ("model" in mesh.shape)

    def test_grow_keeps_layout_rows_and_order(self, mesh):
        shards = mesh.shape["plane"]
        plane = ParameterPlane(_template(300), capacity=shards, mesh=mesh)
        single = ParameterPlane(_template(300), capacity=shards)
        rows = []
        for k in range(3 * shards + 1):  # grows twice
            v = _t(_rand(k, 300))
            a, b = plane.alloc(v), single.alloc(v)
            assert a == b
            rows.append(a)
        assert plane.capacity == 4 * shards and _layout_ok(plane)
        torch.testing.assert_close(plane.take(rows), single.take(rows), rtol=0, atol=0)

    def test_recycled_row_zeroed(self, mesh):
        plane = ParameterPlane(_template(), capacity=8, mesh=mesh)
        row = plane.alloc(torch.full((187,), 9.0))
        plane.free(row)
        again = plane.alloc()
        assert again == row
        assert float(plane.row(again).abs().sum()) == 0.0 and float(plane.take([again]).abs().sum()) == 0.0
        again2 = plane.alloc_many(3)
        assert float(plane.take(again2).abs().sum()) == 0.0

    def test_rows_and_take_placements(self, mesh):
        plane = ParameterPlane(_template(300), capacity=16, mesh=mesh)
        single = ParameterPlane(_template(300), capacity=16)
        rows = [plane.alloc(_t(_rand(i, 300))) for i in range(11)]
        for i in range(11):
            single.alloc(_t(_rand(i, 300)))
        want = single.take(rows[::-1])
        for on_mesh in (False, True):
            got = plane.rows(rows[::-1], on_mesh=on_mesh)
            assert isinstance(got, torch.Tensor) and got.device == mesh.first_device
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        shard = plane.take(rows[::-1], on_mesh="shard")
        assert isinstance(shard, MeshRows) and shard.shape == (11, 300)
        R = mesh.shape["plane"]
        b = -(-11 // R)
        assert len(shard.parts) == R and all(p.shape[0] == b for ps in shard.parts for p in ps)
        assert len(shard.parts[0]) == (2 if plane.dim_sharded else 1)
        torch.testing.assert_close(shard.gather(CPU), want, rtol=0, atol=0)
        assert float(shard.parts[-1][0][-1].abs().sum()) == 0.0  # zero padding

    def test_sharded_rows_feed_pairwise_kernel_without_gathering(self, mesh):
        plane = ParameterPlane(_template(300), capacity=16, mesh=mesh)
        rows = [plane.alloc(_t(_rand(i, 300))) for i in range(8)]
        centers = _t(_rand(99, 3, 300))
        shard = plane.take(rows, on_mesh="shard")
        da = "model" if plane.dim_sharded else None
        assert ops._to_mesh_rows(mesh, shard, dim_axis=da) is shard  # passes straight through
        got = ops.l1_distance_pairwise(shard, centers, mesh=mesh)
        want = ops.l1_distance_pairwise(plane.take(rows), centers, mesh=mesh)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        single = ops.l1_distance_pairwise(plane.take(rows), centers)
        if not plane.dim_sharded:
            torch.testing.assert_close(got, single, rtol=0, atol=0)
        else:  # model compute off: each row shard joins its dim chunks on its own device, then one launch
            rejoined = ops._to_mesh_rows(mesh, shard)
            assert len(rejoined.parts) == len(shard.parts) and all(len(p) == 1 for p in rejoined.parts)
            off = ops.l1_distance_pairwise(shard, centers, mesh=mesh, dim_axis=None)
            torch.testing.assert_close(off, single, rtol=0, atol=0)

    def test_dim_axis_falls_back_when_not_divisible(self):
        plane = ParameterPlane(_template(187), capacity=8, mesh=cpu_mesh(4, 2))
        assert plane.sharded and not plane.dim_sharded  # rows over plane, the dim whole
        row = plane.alloc(torch.full((187,), 1.5))
        assert plane.row_view(row).shape == (187,)
        np.testing.assert_array_equal(plane.rows([row])[0].numpy(), 1.5)

    def test_whole_row_access_only_where_a_row_is_whole(self):
        plane = ParameterPlane(_template(300), capacity=8, mesh=cpu_mesh(4, 2))
        row = plane.alloc(torch.ones(300))
        with pytest.raises(ValueError):
            plane.row_view(row)
        with pytest.raises(ValueError):
            _ = plane.storage
        with pytest.raises(ValueError):
            plane.index([row])

    def test_row_arithmetic_across_shards_is_bitwise(self, mesh):
        plane = ParameterPlane(_template(300), capacity=16, mesh=mesh)
        single = ParameterPlane(_template(300), capacity=16)
        for p in (plane, single):
            rows = [p.alloc(_t(_rand(i, 300))) for i in range(12)]
            p.lerp_row(rows[1], _t(_rand(50, 300)), 0.3)
            p.copy_row(rows[1], rows[11])  # across row shards
            p.copy_row(rows[10], rows[0])
        torch.testing.assert_close(plane.take(rows), single.take(rows), rtol=0, atol=0)


# ------------------------------------------------------ clustering scenario
def _scenario(make, full, mesh=None):
    """``tests/test_sharded_plane.py``'s clustering scenario: 40 uploads of
    9 clients around three anchors."""
    cl = make(mesh)
    rng = np.random.default_rng(11)
    anchors = {0: 0.0, 1: 30.0, 2: 90.0}
    events = []
    for _ in range(40):
        client = int(rng.integers(0, 9))
        anchor = anchors[client % 3] + float(rng.normal() * 2.0)
        update = {"w": full(anchor)}
        cid, created = cl.assign(f"c{client}", update)
        cl.aggregate(cid, update)
        events.append((f"c{client}", cid, created))
    return cl, events


def _port(mesh):
    return DynamicClustering(3, mix_rate=0.25, backend="plane", mesh=mesh, mesh_min_rows=0)


@pytest.mark.parametrize("width", [31, 32])  # 32: the model axis splits the rows
def test_sharded_clustering_matches_single_device_and_reference(mesh, width):
    sharded, ev_sharded = _scenario(_port, lambda a: torch.full((width,), a), mesh)
    single, ev_single = _scenario(_port, lambda a: torch.full((width,), a))
    ref, ev_ref = _scenario(lambda _: JaxClustering(3, mix_rate=0.25, backend="plane", mesh=False),
                            lambda a: jnp.full((width,), a))
    assert sharded.plane.mesh is mesh and single.plane.mesh is None
    assert sharded.plane.dim_sharded == ("model" in mesh.shape and width % 2 == 0)
    assert ev_sharded == ev_single == ev_ref
    assert sharded.assignment == single.assignment == ref.assignment
    assert sharded.nearest_pair() == single.nearest_pair() == ref.nearest_pair()
    for cid in single.clusters:
        got = sharded.plane.row(sharded.clusters[cid]._row)
        torch.testing.assert_close(got, single.plane.row(single.clusters[cid]._row), rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.plane.row(ref.clusters[cid]._row)),
                                   rtol=1e-6, atol=1e-6)
