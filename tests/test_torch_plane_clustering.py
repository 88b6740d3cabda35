"""The port's ParameterPlane and DynamicClustering against the reference.

The same call sequence runs on both planes (the reference with its plane
backend, single device) from one numpy stream. Rows must be identical —
lerp rows within 1 ulp, because the reference's ``plane.lerp_vec`` comes
out as an FMA on this jax while the port pins the two-op blend — and
clustering decisions (assignments, merge candidates, merges, expansions)
identical, with centers within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import DynamicClustering as JaxClustering
from repro.core.plane import ParameterPlane as JaxPlane
from repro_torch.common.pytrees import FlattenSpec, tree_leaves
from repro_torch.core.clustering import DynamicClustering
from repro_torch.core.plane import ParameterPlane
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

SHAPES = [(16, 8), (8,), (8, 3), (3,)]  # w0, b0, w1, b1 of a tiny MLP


def _mlp_np(rng, scale=1.0):
    return [
        {"w": (scale * rng.standard_normal(SHAPES[0])).astype(np.float32),
         "b": (scale * rng.standard_normal(SHAPES[1])).astype(np.float32)},
        {"w": (scale * rng.standard_normal(SHAPES[2])).astype(np.float32),
         "b": (scale * rng.standard_normal(SHAPES[3])).astype(np.float32)},
    ]


def _to_jax(tree):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]


def _to_torch(tree):
    return [{k: torch.tensor(v) for k, v in layer.items()} for layer in tree]


def _ulp_close(a, b, scale=None, ulps=1):
    """|a - b| <= ulps units in the last place of ``scale`` (default the
    larger of |a|, |b|). For a blend the scale is its larger product: an FMA
    skips one product's rounding, which shows at that scale."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if scale is None:
        scale = np.maximum(np.abs(a), np.abs(b))
    return bool(np.all(np.abs(a - b) <= ulps * np.spacing(np.asarray(scale, np.float32))))


def _blend_scale(a, b, t):
    """Elementwise max(|(1-t) a|, |t b|, ...) over a lerp's operands."""
    return np.maximum(np.abs(np.float32(1.0 - t) * a), np.abs(np.float32(t) * b))


def test_flatten_order_matches_the_reference():
    tree = _mlp_np(np.random.default_rng(0))
    from repro.common.pytrees import tree_flat_vector

    want = np.asarray(tree_flat_vector(_to_jax(tree)))
    got = FlattenSpec(_to_torch(tree)).flatten(_to_torch(tree)).numpy()
    np.testing.assert_array_equal(got, want)  # [b0, w0, b1, w1], w kept (din, dout)
    spec = FlattenSpec(_to_torch(tree))
    back = spec.unflatten(torch.tensor(want))
    for x, y in zip(tree_leaves(back), tree_leaves(_to_torch(tree))):
        assert torch.equal(x, y)


def test_plane_call_sequence_matches_the_reference():
    rng = np.random.default_rng(1)
    template = _mlp_np(rng)
    jp, tp = JaxPlane(_to_jax(template), capacity=2), ParameterPlane(_to_torch(template), capacity=2)
    rows_j, rows_t = [], []
    for step in range(12):
        op = step % 4
        val = _mlp_np(rng)
        if op == 0 or not rows_j:  # alloc seeded (grows past capacity)
            rows_j.append(jp.alloc(_to_jax(val)))
            rows_t.append(tp.alloc(_to_torch(val)))
        elif op == 1:  # overwrite
            jp.write(rows_j[0], _to_jax(val))
            tp.write(rows_t[0], _to_torch(val))
        elif op == 2:  # the async mixing step, on the row op 1 just wrote
            old = tp.row(rows_t[0]).numpy()
            jp.lerp_row(rows_j[0], _to_jax(val), 0.25)
            tp.lerp_row(rows_t[0], _to_torch(val), 0.25)
            lerp_scale = _blend_scale(old, tp.spec.flatten(_to_torch(val)).numpy(), 0.25)
        else:  # free the lerped row, then a zero-seeded realloc of it
            jp.free(rows_j.pop(0))
            tp.free(rows_t.pop(0))
            rows_j.append(jp.alloc())
            rows_t.append(tp.alloc())
        assert rows_j == rows_t
        assert jp.num_allocated == tp.num_allocated
        got = tp.rows(rows_t).numpy()
        want = np.asarray(jp.rows(rows_j))
        np.testing.assert_array_equal(got[1:], want[1:])
        if op == 2:
            assert _ulp_close(got[0], want[0], np.maximum(lerp_scale, np.abs(want[0]))), step
        else:
            np.testing.assert_array_equal(got[0], want[0])
    tp.copy_row(rows_t[0], rows_t[1])
    jp.copy_row(rows_j[0], rows_j[1])
    np.testing.assert_array_equal(tp.row(rows_t[1]).numpy(), tp.row(rows_t[0]).numpy())
    assert jp.capacity == tp.capacity


def test_plane_reads_are_snapshots():
    tp = ParameterPlane(_to_torch(_mlp_np(np.random.default_rng(2))), capacity=4)
    r = tp.alloc(torch.ones(tp.dim))
    before = tp.row(r)
    tp.write(r, torch.zeros(tp.dim))
    assert float(before.sum()) == tp.dim and float(tp.row(r).sum()) == 0.0


def _stream(seed, n_clients=6, n_uploads=40):
    """Client-specific drifting uploads: two latent groups."""
    rng = np.random.default_rng(seed)
    bases = [_mlp_np(rng), _mlp_np(rng)]
    for k in range(n_uploads):
        c = int(rng.integers(n_clients))
        base = bases[c % 2]
        noise = _mlp_np(rng, 0.3)
        yield c, [{n: base[i][n] + noise[i][n] for n in ("w", "b")} for i in range(2)]


def _train_fn_jax(tree):
    return [{k: v * 0.9 + 0.01 for k, v in layer.items()} for layer in tree]


def _train_fn_torch(tree):
    return [{k: v * 0.9 + 0.01 for k, v in layer.items()} for layer in tree]


def test_clustering_decisions_match_the_reference():
    jc = JaxClustering(2, mix_rate=0.25, hm=1.0, backend="plane", mesh=False)
    tc = DynamicClustering(2, mix_rate=0.25, hm=1.0)
    for k, (client, up) in enumerate(_stream(3)):
        ju, tu = _to_jax(up), _to_torch(up)
        cj, newj = jc.assign(client, ju)
        ct, newt = tc.assign(client, tu)
        assert (cj, newj) == (ct, newt), k
        jc.aggregate(cj, ju)
        tc.aggregate(ct, tu)
        if k in (15, 30):  # peel a member into a new cluster, as a refine would
            fb = {m: float(m) for m in jc.clusters[cj].members}
            rows_j = {m: jc.plane.alloc(_to_jax(up)) for m in fb}
            rows_t = {m: tc.plane.alloc(tu) for m in fb}
            assert jc.expand(cj, fb, uploads=rows_j, refine_round=k) == \
                tc.expand(ct, fb, uploads=rows_t, refine_round=k)
    assert jc.assignment == tc.assignment
    assert sorted(jc.clusters) == sorted(tc.clusters)
    for cid in jc.clusters:
        np.testing.assert_allclose(
            tc.clusters[cid].center_vec.numpy(), np.asarray(jc.clusters[cid].center_vec),
            rtol=1e-5, atol=1e-6,
        )
    pair_j, pair_t = jc.nearest_pair(close_frac=None), tc.nearest_pair(close_frac=None)
    assert pair_j == pair_t and pair_t is not None
    assert jc.merge_pair(*pair_j, _train_fn_jax) == tc.merge_pair(*pair_t, _train_fn_torch)
    assert jc.assignment == tc.assignment and jc.merges == tc.merges == 1
    assert jc.should_merge() == tc.should_merge()
    for cid in jc.clusters:
        np.testing.assert_allclose(
            tc.clusters[cid].center_vec.numpy(), np.asarray(jc.clusters[cid].center_vec),
            rtol=1e-5, atol=1e-6,
        )
    assert jc.plane.num_allocated == tc.plane.num_allocated


def test_fused_blend_is_reused_only_for_the_argmin_cluster():
    tc = DynamicClustering(2, mix_rate=0.5)
    spec_tree = _to_torch(_mlp_np(np.random.default_rng(4)))
    a = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in spec_tree]
    b = [{k: torch.full_like(v, 10.0) for k, v in layer.items()} for layer in spec_tree]
    tc.assign("a", a)
    tc.aggregate(0, a)
    tc.assign("b", b)
    tc.aggregate(1, b)
    up = [{k: torch.full_like(v, 1.0) for k, v in layer.items()} for layer in spec_tree]
    cid, _ = tc.assign("a", up)
    assert cid == 0 and tc._pending[1] == 0
    tc.aggregate(0, up)
    np.testing.assert_array_equal(tc.clusters[0].center_vec.numpy(), 0.5)
    # an upload the hysteresis keeps in its old cluster takes the live lerp
    up2 = [{k: torch.full_like(v, 5.4) for k, v in layer.items()} for layer in spec_tree]
    cid, _ = tc.assign("a", up2)
    assert cid == 0 and tc._pending[1] == 1
    tc.aggregate(cid, up2)
    np.testing.assert_array_equal(tc.clusters[0].center_vec.numpy(), np.float32(0.5) * np.float32(0.5) + np.float32(0.5) * np.float32(5.4))


@pytest.mark.parametrize("t", [0.25, 0.3, 1.0 / 3.0])
def test_lerp_within_one_ulp_of_reference(t):
    from repro.core.plane import lerp_vec as jax_lerp

    from repro_torch.core.plane import lerp_vec

    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(4099).astype(np.float32), rng.standard_normal(4099).astype(np.float32)
    got = lerp_vec(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
    want = np.asarray(jax_lerp(jnp.asarray(a), jnp.asarray(b), t))
    assert _ulp_close(got, want, np.maximum(_blend_scale(a, b, t), np.abs(want)))
