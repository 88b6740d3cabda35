"""The port's six baselines against ``repro.baselines`` through the same
calls on the same seeded numpy inputs, plus ``tree_weighted_mean`` and
``ClientFleet.train_cohort``.

Tolerances:

* eager tree arithmetic (``tree_weighted_mean``, ``tree_lerp``: Oort's,
  ClusterFL's and FedSEA's aggregation) is the reference's op for op, one
  rounding an op: bit for bit, signed zeros included;
* FedAvg's ``ws @ us`` is one product in each framework, and neither
  fixes its summation order (XLA's ``tensordot`` against PyTorch's
  ``matmul``). Each result is within ``(B-1)·2^-24·Σ|w_i·u_i|`` of the
  exact sum whatever the order, so the two are held to twice that. (On
  this CPU they came out bitwise up to B = 6 and differ from B = 8, where
  a 2e-7 absolute difference on a cancelling sum fails ``rtol=1e-6,
  atol=1e-7``.)
* FedAsyn's blend: the reference's ``_lerp_dyn`` and ``_lerp_chain``
  compile to an FMA on jax 0.9.0 (one of the two products is not rounded;
  ROADMAP queue 3), the port keeps the two-op form. So each blend is
  within 1 ulp per element of the reference, the ulp of the blend's
  largest operand, ``max(|(1-t)·v|, |t·u|, |result|)`` (where the two
  products cancel, the result's own ulp is finer than the rounding the
  FMA skips), and a window of blends within the sum of its steps' ulps.
  The port's coalesced ingest is its per-event ingest bit for bit;
* ``train_cohort`` is ``train_client`` bit for bit on the same models
  (the same padded batch arithmetic, row by row).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import baselines as RB
from repro.common.pytrees import tree_flat_vector as jax_flat
from repro.common.pytrees import tree_lerp as jax_tree_lerp
from repro.common.pytrees import tree_weighted_mean as jax_weighted_mean
from repro_torch import baselines as TB
from repro_torch.common.pytrees import tree_flat_vector, tree_lerp, tree_weighted_mean
from repro_torch.core.client import SimClient
from repro_torch.data.synthetic import make_task
from repro_torch.fl.fleet import ClientFleet
from repro_torch.interop import tree_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

DIMS = (40, 24, 6)


def _mlp(rng, dims=DIMS):
    return [{"w": rng.standard_normal((a, b)).astype(np.float32), "b": rng.standard_normal(b).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _jax(tree):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _vec(tree) -> np.ndarray:
    """A reference (jax/numpy) or port (torch) tree as one numpy row."""
    leaf = tree[0]["w"]
    if isinstance(leaf, torch.Tensor):
        return tree_flat_vector(tree).cpu().numpy()
    return np.asarray(jax_flat(tree))


def _blend_ulp(v, u, t, *results) -> np.ndarray:
    """One ulp of a blend's largest operand, elementwise."""
    terms = [np.abs(np.float32(1.0 - t) * v), np.abs(t * u)] + [np.abs(r) for r in results]
    return np.spacing(np.maximum.reduce(terms))


def _weight(base_version: int, version: int) -> np.float32:
    """FedAsyn's staleness-decayed weight at the default alpha and power."""
    return np.float32(0.6 * (1.0 + max(0, version - base_version)) ** -0.5)


def _uploads(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ups = {i: _mlp(rng) for i in range(n)}
    sizes = {i: int(rng.integers(20, 200)) for i in range(n)}
    return ups, sizes


def _same_downlinks(want, got):
    assert [(d.client_id, d.version, d.cluster_id, d.reason) for d in want] == \
        [(d.client_id, d.version, d.cluster_id, d.reason) for d in got]


# ------------------------------------------------------------ tree arithmetic
@pytest.mark.parametrize("n", [1, 3, 7])
def test_tree_weighted_mean_is_the_reference_bit_for_bit(n):
    ups, sizes = _uploads(n, n)
    trees = list(ups.values())
    if n == 3:  # -0 leaves everywhere in one element: the integer 0 start makes it +0
        for t in trees:
            t[0]["b"][0] = -0.0
    w = [sizes[i] for i in ups]
    want = jax_weighted_mean([_jax(t) for t in trees], w)
    got = tree_weighted_mean([tree_from_numpy(t) for t in trees], w)
    np.testing.assert_array_equal(_bits(_vec(got)), _bits(_vec(want)))
    if n == 3:
        assert _bits(_vec(got))[0] == 0  # +0: b0's first element, the first of the row (keys sorted)


def test_tree_lerp_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(5)
    a, b = _mlp(rng), _mlp(rng)
    for t in (0.25, 0.375, 0.5, 0.75):
        np.testing.assert_array_equal(_bits(_vec(tree_lerp(tree_from_numpy(a), tree_from_numpy(b), t))),
                                      _bits(_vec(jax_tree_lerp(_jax(a), _jax(b), t))))


# ---------------------------------------------------------- synchronous rounds
@pytest.mark.parametrize("n", [1, 4, 6, 8, 16])
def test_fedavg_finish_round_within_the_summation_bound(n):
    rng = np.random.default_rng(100 + n)
    init = _mlp(rng)
    ref, port = RB.FedAvg(_jax(init), {}), TB.FedAvg(tree_from_numpy(init), {})
    for rnd in range(2):
        ups, sizes = _uploads(10 * n + rnd, n)
        ref.client_sizes = port.client_sizes = sizes
        dl_r = ref.finish_round("global", {k: _jax(v) for k, v in ups.items()}, 0.0)
        dl_p = port.finish_round("global", {k: tree_from_numpy(v) for k, v in ups.items()}, 0.0)
        _same_downlinks(dl_r, dl_p)
        assert all(d.params is dl_p[0].params for d in dl_p)  # one object for the fan-out
        assert port.stats() == ref.stats() == {"version": rnd + 1}
        w = np.asarray([sizes[i] for i in ups], np.float64)
        ws = (w / w.sum()).astype(np.float32)
        terms = np.abs(ws[:, None] * np.stack([_vec(u) for u in ups.values()])).sum(0)
        a, b = port._vec.numpy(), np.asarray(ref._vec)
        assert (np.abs(a - b) <= 2 * max(n - 1, 0) * 2.0 ** -24 * terms).all()
        if n == 1:
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_vec(port.global_model), a)
        # the next round starts from the same vector in both packages
        port._vec = torch.from_numpy(b.copy())
        port._view = (-1, None)


def test_oort_select_and_finish_round_match_the_reference():
    n = 12
    rng = np.random.default_rng(3)
    init = _mlp(rng)
    sizes = {i: int(rng.integers(20, 200)) for i in range(n)}
    hints = {i: float(rng.uniform(20, 300)) for i in range(n)}
    ref = RB.Oort(_jax(init), sizes, hints, seed=4)
    port = TB.Oort(tree_from_numpy(init), sizes, hints, seed=4)
    members = list(range(n))
    for rnd in range(4):
        sel_r, sel_p = ref.select("global", members, rnd), port.select("global", members, rnd)
        assert [int(c) for c in sel_r] == [int(c) for c in sel_p]
        ups = {c: _mlp(np.random.default_rng(50 + 7 * rnd + int(c))) for c in sel_r}
        dl_r = ref.finish_round("global", {c: _jax(ups[c]) for c in sel_r}, 0.0)
        dl_p = port.finish_round("global", {c: tree_from_numpy(ups[c]) for c in sel_p}, 0.0)
        _same_downlinks(dl_r, dl_p)
        np.testing.assert_array_equal(_bits(_vec(port.global_model)), _bits(_vec(ref.global_model)))
        assert port.util == ref.util and port.stats() == ref.stats()


def test_clusterfl_warmup_clusters_and_per_cluster_rounds_match_the_reference():
    n = 10
    rng = np.random.default_rng(8)
    init = _mlp(rng)
    # four latent groups of uploads, so k-means has a structure to find
    bases = [_mlp(rng) for _ in range(4)]
    ups = {i: [{k: (b[k] + 0.05 * rng.standard_normal(b[k].shape)).astype(np.float32) for k in b}
               for b in bases[i % 4]] for i in range(n)}
    sizes = {i: int(rng.integers(20, 200)) for i in range(n)}
    ref = RB.ClusterFL(_jax(init), sizes, num_clusters=4, seed=2)
    port = TB.ClusterFL(tree_from_numpy(init), sizes, num_clusters=4, seed=2)
    assert port.groups(list(range(n))) == ref.groups(list(range(n))) == {"warmup": list(range(n))}
    dl_r = ref.finish_round("warmup", {k: _jax(v) for k, v in ups.items()}, 0.0)
    dl_p = port.finish_round("warmup", {k: tree_from_numpy(v) for k, v in ups.items()}, 0.0)
    _same_downlinks(dl_r, dl_p)
    assert port.assignment == ref.assignment and len(set(port.assignment.values())) == 4
    groups = port.groups(list(range(n)))
    assert groups == ref.groups(list(range(n)))
    np.testing.assert_array_equal(port.membership_matrix(list(range(n))), ref.membership_matrix(list(range(n))))
    for cl in groups:
        np.testing.assert_array_equal(_bits(_vec(port.centers[cl])), _bits(_vec(ref.centers[cl])))
    for cl, members in groups.items():
        up2 = {m: _mlp(np.random.default_rng(200 + m)) for m in members}
        _same_downlinks(ref.finish_round(cl, {m: _jax(up2[m]) for m in members}, 1.0),
                        port.finish_round(cl, {m: tree_from_numpy(up2[m]) for m in members}, 1.0))
        np.testing.assert_array_equal(_bits(_vec(port.model_for(members[0]))), _bits(_vec(ref.model_for(members[0]))))
    assert port.versions == ref.versions and port.stats() == ref.stats()


def test_standalone_keeps_each_client_model():
    rng = np.random.default_rng(9)
    init, up = _mlp(rng), _mlp(rng)
    ref, port = RB.Standalone(_jax(init)), TB.Standalone(tree_from_numpy(init))
    assert port.groups([0, 1, 2]) == ref.groups([0, 1, 2])
    up_t = tree_from_numpy(up)
    dl_r, dl_p = ref.finish_round(1, {1: _jax(up)}, 0.0), port.finish_round(1, {1: up_t}, 0.0)
    _same_downlinks(dl_r, dl_p)
    assert dl_p[0].reason == "local" and dl_p[0].params is up_t
    assert port.model_for(1) is up_t and port.model_for(0) is port.init_params
    assert port.stats() == ref.stats() == {}


# -------------------------------------------------------- asynchronous ingest
def _arrivals(seed: int, n: int):
    """(cid, params, base_version, n_samples, t) arrivals; base versions lag
    the server by 0-5."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 6)), _mlp(rng), -int(rng.integers(0, 6)), 50, float(j)) for j in range(n)]


def _with_versions(batch, version):
    return [(c, p, max(0, version + j + bv), n, t) for j, (c, p, bv, n, t) in enumerate(batch)]


def test_fedasyn_per_event_within_one_ulp_of_the_reference():
    rng = np.random.default_rng(11)
    init = _mlp(rng)
    ref, port = RB.FedAsyn(_jax(init)), TB.FedAsyn(tree_from_numpy(init))
    for cid, p, bv, n, t in _with_versions(_arrivals(12, 9), 0):
        v, w = np.asarray(ref._vec), _weight(bv, ref.version)
        dl_r = ref.handle_upload(cid, _jax(p), bv, n, t)
        dl_p = port.handle_upload(cid, tree_from_numpy(p), bv, n, t)
        _same_downlinks(dl_r, dl_p)
        got, want = port._vec.numpy(), np.asarray(ref._vec)
        assert (np.abs(got - want) <= _blend_ulp(v, _vec(p), w, want)).all()
        # the next blend starts from the same vector in both packages
        port._vec = torch.from_numpy(np.asarray(ref._vec).copy())
        port._view = (-1, None)
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("window", [1, 2, 5])
def test_fedasyn_handle_uploads_is_per_event_bitwise_and_within_one_ulp_of_the_reference(window):
    rng = np.random.default_rng(20 + window)
    init = _mlp(rng)
    batch = _with_versions(_arrivals(30 + window, window), 3)
    seq = TB.FedAsyn(tree_from_numpy(init))
    seq.version = 3
    want = [seq.handle_upload(c, tree_from_numpy(p), bv, n, t) for c, p, bv, n, t in batch]
    port = TB.FedAsyn(tree_from_numpy(init))
    ref = RB.FedAsyn(_jax(init))
    port.version = ref.version = 3
    got = port.handle_uploads([(c, tree_from_numpy(p), bv, n, t) for c, p, bv, n, t in batch])
    ref_out = ref.handle_uploads([(c, _jax(p), bv, n, t) for c, p, bv, n, t in batch])
    v, bound = _vec(init), 0.0
    for (_, p, bv, _, _), j, w, g, r in zip(batch, range(window), want, got, ref_out):
        _same_downlinks(w, g)
        _same_downlinks(r, g)
        np.testing.assert_array_equal(_bits(_vec(g[0].params)), _bits(_vec(w[0].params)))
        a, b = _vec(g[0].params), _vec(r[0].params)
        bound = bound + _blend_ulp(v, _vec(p), _weight(bv, 3 + j), a, b)
        assert (np.abs(a - b) <= bound).all()
        v = b
    np.testing.assert_array_equal(_bits(port._vec.numpy()), _bits(seq._vec.numpy()))
    assert port.stats() == seq.stats() == ref.stats()
    assert port.global_model is got[-1][0].params


def test_fedsea_buffers_drops_stragglers_and_blends_on_tick_like_the_reference():
    rng = np.random.default_rng(13)
    init = _mlp(rng)
    ref = RB.FedSEA(_jax(init), sync_interval=60.0)
    port = TB.FedSEA(tree_from_numpy(init), sync_interval=60.0)
    assert port.tick_interval == ref.tick_interval == 60.0
    assert port.on_tick(0.0) == ref.on_tick(0.0) == []  # nothing buffered: no version bump
    for tick in range(5):
        arr = _arrivals(40 + tick, 2 + tick)
        for cid, p, bv, n, t in arr:
            base = max(0, port.version + bv)  # lags 0-5 versions: some past the window of 2
            n = 20 + 10 * cid
            _same_downlinks(ref.handle_upload(cid, _jax(p), base, n, t),
                            port.handle_upload(cid, tree_from_numpy(p), base, n, t))
        assert list(port.buffer) == list(ref.buffer)
        _same_downlinks(ref.on_tick(60.0 * tick), port.on_tick(60.0 * tick))
        np.testing.assert_array_equal(_bits(_vec(port.global_model)), _bits(_vec(ref.global_model)))
        assert port.stats() == ref.stats()
    assert port.stats()["dropped"] > 0 and port.stats()["version"] == 5


# ---------------------------------------------------------------- the fleet
def test_train_cohort_is_train_client_bit_for_bit():
    task = make_task("har", 5, np.random.default_rng(7), samples_per_client=24)
    rng = np.random.default_rng(10)
    models = {i: [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                   "b": np.zeros(b, np.float32)} for a, b in zip((64, 10, 8), (10, 8, 6))] for i in range(5)}

    def fleet():
        clients = [SimClient(client_id=i, data=d, num_classes=task.num_classes, device_class="D1",
                             round_time_fn=lambda: 1.0, local_epochs=3 + i % 3, partial_finetune=i == 1)
                   for i, d in enumerate(task.clients)]
        f = ClientFleet(clients, tree_from_numpy(models[0]), device="cpu")
        for cid in range(5):
            f.set_model(cid, tree_from_numpy(models[cid]))
        return f

    one, cohort = fleet(), fleet()
    shared = tree_from_numpy(models[4])
    cids = [3, 0, 1]  # a cohort of 3 pads to 4; client 1 trains its head only
    handed = [shared, None, shared]  # None: the client's own row
    rows_before = cohort.plane.take([cohort._model_row[i] for i in range(5)]).clone()
    got, losses, vecs = cohort.train_cohort(cids, handed)
    assert torch.equal(cohort.plane.take([cohort._model_row[i] for i in range(5)]), rows_before)  # no row written
    assert len(got) == 3 and losses.shape == (3,) and vecs.shape == (3, cohort.spec.dim)
    for g, v in zip(got, vecs):  # the trees are the matrix's rows
        np.testing.assert_array_equal(_bits(_vec(g)), _bits(v.numpy()))
    for cid, p, g in zip(cids, handed, got):
        if p is not None:
            one.set_model(cid, p)
        want, _ = one.train_client(cid)
        np.testing.assert_array_equal(_bits(_vec(g)), _bits(_vec(want)))
