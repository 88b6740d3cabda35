"""The port's coalesced ingest on the CPU: ``EchoPFLServer.handle_uploads``
and the simulator's coalescing window.

- ``handle_uploads`` equals sequential ``handle_upload`` calls bit for bit:
  centers, assignments, predictor records, counters and RNN weights,
  events, staleness, client versions and downlink payloads. Batches of 6
  put a refine boundary mid-batch; also a duplicate client that splits a
  segment, partial-finetune pins, frequent refines that invalidate the
  speculative launch, broadcast and clustering disabled, minimal windows,
  and an expansion seeded in mid-segment (the counterpart of the
  reference's ``TestHandleUploadsSequentialEquivalence``).
- The coalesced loop at a window of 1e-9 s equals the per-event loop: the
  whole report.
- At a 45 s window the port equals the reference's coalesced run on
  ``har`` (6 and 16 clients) and on ``tiny_lm``, with the reference's
  initial weights and broadcast RNN handed over: identical uploads, bytes,
  series, events, assignments, staleness and decisions; accuracy curves
  within 0.01.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.lm_task import default_lm_task as jax_default_lm_task
from repro.fl.lm_task import run_lm_experiment as jax_run_lm_experiment
from repro.fl.network import NetworkModel as JaxNetwork
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.common.pytrees import tree_leaves
from repro_torch.core import server as server_mod
from repro_torch.fl.experiment import build_clients, build_strategy, run_experiment
from repro_torch.fl.lm_task import run_lm_experiment
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)


@pytest.fixture(scope="module")
def rnn_np():
    return {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(0)).items()}


@pytest.fixture
def segments(monkeypatch):
    """The sizes of the segments ``handle_uploads`` sent through one chain."""
    sizes = []
    fn = server_mod.K.ingest_chain

    def rec(U, *a, **kw):
        sizes.append(U.shape[0])
        return fn(U, *a, **kw)

    monkeypatch.setattr(server_mod.K, "ingest_chain", rec)
    return sizes


# ------------------------------------------------------------ handle_uploads
def _server(rnn_np, **kw):
    _, clients, init = build_clients("har", 6, seed=3, samples_per_client=48, device="cpu")
    return clients, init, build_strategy("echopfl", init, clients, seed=3, rnn_params=rnn_np, device="cpu", **kw)


def _noisy_stream(clients, init, rounds=12, seed=0):
    rng = np.random.default_rng(seed)
    stream = []
    for r in range(rounds):
        for c in clients:
            upload = [
                {k: v + torch.from_numpy(np.float32(0.05 + 0.01 * r)
                                         * rng.standard_normal(tuple(v.shape)).astype(np.float32))
                 for k, v in layer.items()}
                for layer in init
            ]
            stream.append((c.client_id, upload, 0, 48, float(r)))
    return stream


def _payload_bits(params):
    return torch.cat([x.reshape(-1) for x in tree_leaves(params)]).view(torch.int32)


def _assert_servers_equal(sA, sB, outA, outB):
    assert sA._uploads == sB._uploads
    assert sA.clustering.assignment == sB.clustering.assignment
    assert sorted(sA.clustering.clusters) == sorted(sB.clustering.clusters)
    for cid, ca in sA.clustering.clusters.items():
        cb = sB.clustering.clusters[cid]
        assert ca.version == cb.version and ca.members == cb.members
        assert ca.partial_finetune == cb.partial_finetune
        assert torch.equal(ca.center_vec.view(torch.int32), cb.center_vec.view(torch.int32)), f"center {cid}"
        assert torch.equal(ca.broadcast_vec.view(torch.int32), cb.broadcast_vec.view(torch.int32)), f"anchor {cid}"
    assert set(sA.predictors) == set(sB.predictors)
    for cid, pa in sA.predictors.items():
        pb = sB.predictors[cid]
        assert (pa.records, pa.decisions, pa.broadcasts, pa.active, pa.scale, pa.k) == (
            pb.records, pb.decisions, pb.broadcasts, pb.active, pb.scale, pb.k)
        assert (pa.params is None) == (pb.params is None)
        for name in pa.params or ():
            assert torch.equal(pa.params[name].view(torch.int32), pb.params[name].view(torch.int32)), (cid, name)
    assert sA.events == sB.events
    assert sA.staleness.snapshot() == sB.staleness.snapshot()
    assert sA.client_versions == sB.client_versions
    assert sA.stats() == sB.stats()
    assert len(outA) == len(outB)
    for a, b in zip(outA, outB):
        assert [(d.client_id, d.version, d.cluster_id, d.reason) for d in a] == [
            (d.client_id, d.version, d.cluster_id, d.reason) for d in b]
        for da, db in zip(a, b):
            assert torch.equal(_payload_bits(da.params), _payload_bits(db.params))


def _batched(server, stream, size):
    out = []
    for i in range(0, len(stream), size):
        out.extend(server.handle_uploads(stream[i:i + size]))
    return out


@pytest.mark.parametrize("size", [3, 6, 13])
def test_batched_ingest_is_sequential_bit_for_bit(rnn_np, segments, size):
    """Batches of 6 put the refine boundary (every 20 uploads) mid-batch."""
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, size)
    assert sA._uploads == len(stream)
    _assert_servers_equal(sA, sB, outA, outB)
    assert segments and max(segments) > 1


def test_duplicate_client_in_batch_splits_segment(rnn_np, segments):
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init, rounds=3)
    dup = stream[:6] + [stream[6]] + stream[7:12] + [stream[13], stream[12], stream[13]]
    outA = [sA.handle_upload(*u) for u in dup]
    outB = sB.handle_uploads(dup)
    _assert_servers_equal(sA, sB, outA, outB)
    assert max(segments) > 1


def test_partial_finetune_members_stay_pinned(rnn_np):
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init, rounds=5)
    for u in stream[:12]:
        sA.handle_upload(*u)
    sB.handle_uploads(stream[:12])
    for s in (sA, sB):  # pin two members of cluster 0
        cl = s.clustering.clusters[0]
        cl.partial_finetune.update(sorted(cl.members)[:2])
        cl.pf_round = s._refine_round + 10  # not lifted during the test
    outA = [sA.handle_upload(*u) for u in stream[12:]]
    outB = sB.handle_uploads(stream[12:])
    _assert_servers_equal(sA, sB, outA, outB)


def test_frequent_refines_relaunch_the_segment(rnn_np, segments):
    """Refines every 5 uploads with merges at hm = 1: expansions, merges and
    dissolves change the cluster set mid-segment and the replay relaunches
    from live state."""
    clients, init, sA = _server(rnn_np, refine_every=5, hm=1.0)
    _, _, sB = _server(rnn_np, refine_every=5, hm=1.0)
    stream = _noisy_stream(clients, init, rounds=10, seed=4)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 12)
    _assert_servers_equal(sA, sB, outA, outB)
    assert {e["kind"] for e in sA.events} & {"expand", "merge", "dissolve"}
    assert len(segments) > 2 * (len(stream) // 12)  # two segments a batch, and relaunches


def test_broadcast_disabled(rnn_np):
    clients, init, sA = _server(rnn_np, enable_broadcast=False)
    _, _, sB = _server(rnn_np, enable_broadcast=False)
    stream = _noisy_stream(clients, init, rounds=6)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 9)
    _assert_servers_equal(sA, sB, outA, outB)
    assert sA._rnn_init is None and all(p.params is None for p in sA.predictors.values())
    assert not any(e["kind"] == "broadcast" for e in sA.events)


def test_clustering_disabled_takes_the_per_upload_path(rnn_np, segments):
    clients, init, sA = _server(rnn_np, enable_clustering=False)
    _, _, sB = _server(rnn_np, enable_clustering=False)
    stream = _noisy_stream(clients, init, rounds=5)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 6)
    _assert_servers_equal(sA, sB, outA, outB)
    assert list(sA.clustering.clusters) == [0] and sA._refine_round == 0
    assert not segments


def test_minimal_window_pairs_bitwise(rnn_np, segments):
    """Batches of two distinct clients: the smallest segments and chains."""
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init, rounds=8)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 2)
    _assert_servers_equal(sA, sB, outA, outB)
    assert set(segments) == {2}


@pytest.mark.parametrize("seed", [0, 5])
def test_predictor_batched_or_serial_is_sequential(rnn_np, seed):
    """The predictor's work, one chain per cluster and refinement
    sub-window, replays the serial learn/decide calls of sequential ingest
    bit for bit, final RNN weights included."""
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init, seed=seed)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 6)
    _assert_servers_equal(sA, sB, outA, outB)


# ------------------------------------------- a refine that expands mid-segment
def _expansion_stream(seed=7, n_clients=6, rounds=2, dim=(16, 8)):
    """Two rounds of distinct clients: a window of the second round is one
    segment whose refine (every 8 uploads) comes before client 4's upload."""
    rng = np.random.default_rng(seed)
    init = [{"w": rng.standard_normal(dim).astype(np.float32), "b": np.zeros(dim[1], np.float32)}]
    stream = []
    for r in range(rounds):
        for c in range(n_clients):
            up = [{k: v + np.float32(0.1) * rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in init[0].items()}]
            stream.append((c, up, 0, 48, float(r)))
    return init, stream


def _feedback(client_id, center):
    """Every client fits its center but client 4, the refine's one poor fit."""
    f_true = np.full(4, 0.25, np.float32)
    f_pred = np.asarray([0.7, 0.1, 0.1, 0.1], np.float32) if client_id == 4 else f_true
    return f_pred, f_true, np.asarray([0.1, 0.4, 0.2, 0.3], np.float32)


def _record_seeds(server):
    """The flat rows that expansions seed new clusters from."""
    seeds = []
    cl = server.clustering
    expand, new_cluster = cl.expand, cl._new_cluster

    def rec_new(center):
        seeds.append(np.asarray(center.cpu() if isinstance(center, torch.Tensor) else center))
        return new_cluster(center)

    def rec_expand(*a, **kw):
        cl._new_cluster = rec_new
        try:
            return expand(*a, **kw)
        finally:
            cl._new_cluster = new_cluster

    cl.expand = rec_expand
    return seeds


def _flat(upload):
    return np.concatenate([upload[0]["b"], upload[0]["w"].reshape(-1)])


def test_mid_segment_expansion_seeds_from_sequential_rows(rnn_np, segments):
    """A refine inside a segment expands client 4 out of its cluster. Its
    new center is seeded from client 4's last upload row. Sequential ingest
    has written the first round's upload there; the port's segment writes
    each refinement sub-window's rows at its start and equals sequential
    ingest bit for bit. The reference's segment writes every row before its
    replay, so its seed is the second round's upload, which arrives after
    the refine."""
    from repro.core.server import EchoPFLServer as JaxServer

    init, stream = _expansion_stream()
    flat0, flat1 = _flat(stream[4][1]), _flat(stream[10][1])
    kw = dict(num_initial_clusters=1, refine_every=8, feedback_fn=_feedback)

    def port():
        to_t = lambda tree: [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in tree]  # noqa: E731
        srv = server_mod.EchoPFLServer(to_t(init), rnn_params=rnn_np, device="cpu", **kw)
        return srv, _record_seeds(srv), [(c, to_t(u), *rest) for c, u, *rest in stream]

    sA, seedsA, st = port()
    sB, seedsB, _ = port()
    outA = [sA.handle_upload(*u) for u in st]
    outB = sB.handle_uploads(st[:6]) + sB.handle_uploads(st[6:])
    _assert_servers_equal(sA, sB, outA, outB)
    assert [e["kind"] for e in sA.events if e["kind"] != "broadcast"] == ["expand"]
    assert 6 in segments  # the second round went in as one segment, then relaunched
    assert len(seedsA) == len(seedsB) == 1
    np.testing.assert_array_equal(seedsB[0].view(np.int32), seedsA[0].view(np.int32))
    np.testing.assert_array_equal(seedsA[0], flat0)

    def ref():
        to_j = lambda tree: [{k: jax.numpy.asarray(v) for k, v in layer.items()} for layer in tree]  # noqa: E731
        srv = JaxServer(to_j(init), enable_broadcast=False, **kw)
        return srv, _record_seeds(srv), [(c, to_j(u), *rest) for c, u, *rest in stream]

    jA, jseedsA, jst = ref()
    jB, jseedsB, _ = ref()
    for u in jst:
        jA.handle_upload(*u)
    jB.handle_uploads(jst[:6])
    jB.handle_uploads(jst[6:])
    assert [e["kind"] for e in jB.events] == [e["kind"] for e in jA.events] == ["expand"]
    np.testing.assert_array_equal(jseedsA[0], flat0)  # sequential: the first round's upload
    np.testing.assert_array_equal(jseedsB[0], flat1)  # the reference's segment: the second round's
    assert not np.array_equal(flat0, flat1)


# ---------------------------------------------------------------- simulator
def _har_weights(n):
    _, _, init = jax_build_clients("har", n, seed=0)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in init]


def _assert_reports_identical(a, b):
    assert a.curve == b.curve and a.per_client_acc == b.per_client_acc
    for name in ("up_bytes", "down_bytes", "up_events", "down_events", "duration", "up_series", "down_series"):
        assert getattr(a, name) == getattr(b, name), name
    ea, eb = dict(a.extra), dict(b.extra)
    ea.pop("coalesce_window", None)
    eb.pop("coalesce_window", None)
    assert ea == eb


@pytest.mark.parametrize("max_uploads", [None, 40])
def test_degenerate_window_is_the_per_event_loop(rnn_np, max_uploads):
    kw = dict(num_clients=6, seed=3, samples_per_client=48, device="cpu", rnn_params=rnn_np,
              max_time=1e9 if max_uploads else 420.0, max_uploads=max_uploads)
    r0 = run_experiment("har", "echopfl", **kw)[3]
    r1 = run_experiment("har", "echopfl", coalesce_window=1e-9, **kw)[3]
    _assert_reports_identical(r0, r1)
    if max_uploads:
        assert r0.extra["uploads"] == max_uploads
        r2 = run_experiment("har", "echopfl", coalesce_window=45.0, **kw)[3]
        assert r2.extra["uploads"] == max_uploads and r2.duration == r0.duration


def _assert_runs_identical(js, jr, ts, tr):
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series"):
        assert getattr(jr, name) == getattr(tr, name), name
    assert js.events == ts.events
    assert js.clustering.assignment == ts.clustering.assignment
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    for key in ("uploads", "clusters", "merges", "expansions", "broadcasts", "rnn_broadcasts", "decisions"):
        assert jr.extra[key] == tr.extra[key], key
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)


@pytest.mark.parametrize("n,max_time", [(6, 600.0), (16, 900.0)])
def test_window_matches_the_reference(rnn_np, n, max_time):
    init_np = _har_weights(n)
    _, clients, init = jax_build_clients("har", n, seed=0)
    js = jax_build_strategy("echopfl", init, clients, seed=0)
    sim = JaxSimulator(clients, js, network=JaxNetwork(), seed=0, coalesce_window=45.0)
    jr = sim.run_async(max_time=max_time)
    _, _, ts, tr = run_experiment("har", "echopfl", num_clients=n, max_time=max_time, seed=0, device="cpu",
                                  init_params=init_np, rnn_params=rnn_np, coalesce_window=45.0)
    _assert_runs_identical(js, jr, ts, tr)
    assert tr.extra["coalesce_window"] == 45.0 and max(sim.coalesced_groups["upload_done"]) > 1


@pytest.fixture(scope="module")
def lm_runs():
    args = dict(num_clients=8, max_time=900, eval_interval=120, seed=0)
    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np = to_np(jtask.base.params)
    delta_np = to_np(jtask.init_params(jax.random.PRNGKey(0)))
    rnn = to_np(jax_pretrain_rnn(jax.random.PRNGKey(0)))
    old = os.environ.get("REPRO_ASYNC_COALESCE")
    os.environ["REPRO_ASYNC_COALESCE"] = "45"  # the reference's LM run reads its window from here
    try:
        ref = jax_run_lm_experiment("echopfl", **args)
    finally:
        if old is None:
            os.environ.pop("REPRO_ASYNC_COALESCE")
        else:
            os.environ["REPRO_ASYNC_COALESCE"] = old
    port = run_lm_experiment("echopfl", device="cpu", base_params=base_np, init_params=delta_np, rnn_params=rnn,
                             coalesce_window=45.0, **args)
    return ref, port


def test_lm_window_matches_the_reference(lm_runs):
    (_, _, js, jr), (_, _, ts, tr) = lm_runs
    assert jr.extra["coalesce_window"] == tr.extra["coalesce_window"] == 45.0
    _assert_runs_identical(js, jr, ts, tr)
    assert {e["kind"] for e in ts.events} >= {"broadcast"}
