"""The port's per-event EchoPFL server against the reference's.

One numpy upload stream, one deterministic feedback function and the
reference's pretrained broadcast-RNN weights go into both servers. With
``hm=1.0`` and ``refine_every=5`` the stream runs through many refines
(expansion, reassignment, merge and dissolve all happen). Decisions must be identical:
assignments, events, the staleness snapshot, the downlink (client, version,
cluster, reason) sequence and ``stats()`` apart from float fields; centers
within rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.server import EchoPFLServer as JaxServer
from repro_torch.common.pytrees import tree_leaves
from repro_torch.core.server import EchoPFLServer
from repro_torch.interop import tree_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

DIMS = (12, 10, 6)
J = 6


def _tree(rng, scale=1.0):
    return [
        {"w": (scale * rng.standard_normal((a, b))).astype(np.float32),
         "b": (scale * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(DIMS[:-1], DIMS[1:])
    ]


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in tree_leaves(tree)])


class _Feedback:
    """(client, center) -> (F_pred, F_true, S_soft): a client fits a center
    whose strongest random projection names the client's latent group."""

    def __init__(self, dim, n_clients):
        rng = np.random.default_rng(42)
        self.proj = rng.standard_normal((3, dim))
        self.f_true = rng.uniform(5, 30, (n_clients, J))
        self.s_soft = rng.dirichlet(np.full(J, 0.5), n_clients)

    def __call__(self, client, center):
        sig = int(np.argmax(self.proj @ _flat(center)))
        ft = self.f_true[client]
        fp = ft if sig == client % 3 else np.roll(ft, 1 + client % 2) * (1 + client / 10)
        return fp.astype(np.float32), ft.astype(np.float32), self.s_soft[client].astype(np.float32)


def _train_fn(tree):
    return [{k: v * 0.9 + 0.01 for k, v in layer.items()} for layer in tree]


@pytest.fixture(scope="module")
def rnn_np():
    return {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(0)).items()}


def test_per_event_server_matches_reference(rnn_np):
    n_clients, n_uploads = 9, 60
    rng = np.random.default_rng(0)
    bases = [_tree(rng) for _ in range(3)]
    init = _tree(rng, 0.1)
    dim = _flat(init).size
    kw = dict(num_initial_clusters=3, hm=1.0, refine_every=5, local_train_fn=_train_fn,
              feedback_fn=_Feedback(dim, n_clients))
    js = JaxServer([{k: jax.numpy.asarray(v) for k, v in layer.items()} for layer in init],
                   pretrain_key=jax.random.PRNGKey(0), plane_mesh=False, plane_backend="plane", **kw)
    ts = EchoPFLServer([{k: torch.tensor(v) for k, v in layer.items()} for layer in init],
                       rnn_params=tree_from_numpy(rnn_np), device="cpu", **kw)
    for leaf_j, leaf_t in zip(jax.tree_util.tree_leaves(js._rnn_init), tree_leaves(ts._rnn_init)):
        np.testing.assert_array_equal(np.asarray(leaf_j), leaf_t.numpy())
    for k in range(n_uploads):
        c = int(rng.integers(n_clients))
        noise = _tree(rng, 0.2)
        up = [{n: bases[c % 3][i][n] + noise[i][n] for n in ("w", "b")} for i in range(len(noise))]
        dl_j = js.handle_upload(c, [{n: jax.numpy.asarray(v) for n, v in l.items()} for l in up], 0, 10, float(k))
        dl_t = ts.handle_upload(c, [{n: torch.tensor(v) for n, v in l.items()} for l in up], 0, 10, float(k))
        key = lambda d: (d.client_id, d.version, d.cluster_id, d.reason)  # noqa: E731
        assert sorted(map(key, dl_j)) == sorted(map(key, dl_t)), k
        assert js.clustering.assignment == ts.clustering.assignment, k
        for d_j, d_t in zip(sorted(dl_j, key=key), sorted(dl_t, key=key)):
            np.testing.assert_allclose(_flat(d_t.params), _flat(d_j.params), rtol=1e-5, atol=1e-6)
    assert js._refine_round == ts._refine_round >= 3
    assert js.events == ts.events
    kinds = {e["kind"] for e in ts.events}
    assert {"expand", "reassign", "merge", "dissolve", "broadcast"} <= kinds, kinds
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    sj, st = js.stats(), ts.stats()
    fb_j, fb_t = sj.pop("cluster_feedback_mean"), st.pop("cluster_feedback_mean")
    assert sj == st
    assert fb_j.keys() == fb_t.keys()
    np.testing.assert_allclose([fb_t[c] for c in fb_t], [fb_j[c] for c in fb_j], rtol=1e-5)
    for cid in js.clustering.clusters:
        np.testing.assert_allclose(
            ts.clustering.clusters[cid].center_vec.numpy(),
            np.asarray(js.clustering.clusters[cid].center_vec), rtol=1e-5, atol=1e-6,
        )
    assert js.client_versions == ts.client_versions


def test_server_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EchoPFLServer([{"w": torch.zeros(2, 2), "b": torch.zeros(2)}])
