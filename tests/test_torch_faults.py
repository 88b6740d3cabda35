"""The port's fault layer and churn (``repro_torch.fl.faults``, the
simulator's hooks, ``EchoPFLServer.evict_clients``,
``UplinkCodec.release_client``) against the reference's, on the CPU.

Units: ``FaultInjector`` draws equal the reference's for every kind, seed,
client and counter, and so do the ledgers; ``apply_poison`` gives the
reference's bits for ``nan``, ``scale`` and ``sign`` on a multi-leaf MLP
tree and leaves its input untouched; ``evict_clients`` frees the upload
rows and reclaims emptied clusters; ``release_client`` frees codec rows.

End to end on ``har`` (8 clients, 900 s, seed 0; the reference's initial
MLP and pretrained broadcast RNN handed over), per event and at a 45 s
window: ``bench_faults.py``'s fault plan at rate 0.3 (loss 0.3, crash 0.15,
duplicates and reorders 0.075, fault seed 1) under the retry and the drop
policy; a static ``churn=`` dict; crashes with deaths. Identical: the fault
ledger, the byte ledger (``up_retry_bytes`` and the per-minute series
included), ``duration``, uploads, ``churn_delays``, the server's events and
assignments, the staleness snapshot. Accuracy curves within 0.01 (they
come out equal). The reference is given explicit ``faults`` and
``guard="off"`` and its ``REPRO_*`` variables are unset, so no ambient knob
leaks in.

The coalesced churn run reaches a known fault of the reference (ROADMAP
queue 3): its segment writes every upload row before the replay, so an
expansion in mid-segment seeds from a later upload. The port writes each
sub-window's rows at its start, as sequential ingest does. That run is held
to the reference with the reference's early write emulated in the port
(:func:`early_row_writes`), and shown to depart from it without.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl import faults as jf
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.network import NetworkModel as JaxNetwork
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.common.pytrees import tree_leaves
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl import faults as tf
from repro_torch.fl.experiment import build_clients, build_strategy, run_experiment
from repro_torch.fl.simulator import Simulator
from repro_torch.fl.uplink import UplinkCodec, resolve_uplink
from repro_torch.interop import tree_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

N_CLIENTS, MAX_TIME, SEED = 8, 900.0, 0
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "up_retry_bytes", "duration",
          "up_series", "down_series")


@pytest.fixture(autouse=True)
def _no_repro_env(monkeypatch):
    import os

    for name in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(name)


def bench_plan(mod, rate: float, policy: str):
    """``benchmarks/bench_faults.py``'s plan at one rate, in either package."""
    return mod.FaultPlan(config=mod.FaultConfig(seed=SEED + 1, loss_rate=rate, crash_rate=rate / 2,
                                                dup_rate=rate / 4, reorder_rate=rate / 4, policy=policy))


def death_plan(mod):
    return mod.FaultPlan(config=mod.FaultConfig(seed=3, crash_rate=0.25, death_rate=0.8, loss_rate=0.0,
                                                dup_rate=0.0, reorder_rate=0.0))


CHURN = {1: [(60.0, 300.0)], 3: [(100.0, 420.0), (600.0, 700.0)], 6: [(0.0, 200.0)]}
CASES = {f"{policy} w{int(w)}": (w, "plan", policy) for policy in ("retry", "drop") for w in (0.0, 45.0)}
CASES.update({f"churn w{int(w)}": (w, "churn", None) for w in (0.0, 45.0)})
CASES.update({f"death w{int(w)}": (w, "death", None) for w in (0.0, 45.0)})


@pytest.fixture(scope="module")
def weights():
    _, _, init = jax_build_clients("har", N_CLIENTS, seed=SEED)
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(SEED)).items()}
    return init_np, rnn_np


def _args(mod, kind, policy):
    if kind == "plan":
        return dict(faults=bench_plan(mod, 0.3, policy))
    if kind == "death":
        return dict(faults=death_plan(mod))
    return dict(churn=CHURN, faults=None if mod is tf else "off")


def reference_run(window, **kw):
    _, clients, init = jax_build_clients("har", N_CLIENTS, seed=SEED)
    strat = jax_build_strategy("echopfl", init, clients, seed=SEED)
    sim = JaxSimulator(clients, strat, network=JaxNetwork(), seed=SEED, client_backend="fleet",
                       coalesce_window=window, guard="off", **kw)
    return strat, sim.run_async(max_time=MAX_TIME), sim


@contextlib.contextmanager
def early_row_writes():
    """The reference's segment order in the port: every upload row of a
    segment written before its replay (``repro/core/server.py:353-360``)."""
    from repro_torch.core import server as server_mod

    orig = server_mod.EchoPFLServer._handle_upload_segment

    def early(self, seg):
        plane = self.clustering.plane
        for client, *_ in seg:
            if client not in self.clustering.uploads:
                self.clustering.uploads[client] = plane.alloc()
        plane.write_rows([self.clustering.uploads[c] for c, *_ in seg],
                         torch.stack([plane.from_pytree(item[1]) for item in seg]))
        return orig(self, seg)

    server_mod.EchoPFLServer._handle_upload_segment = early
    try:
        yield
    finally:
        server_mod.EchoPFLServer._handle_upload_segment = orig


def port_run(weights, window, **kw):
    init_np, rnn_np = weights
    _, clients, init = build_clients("har", N_CLIENTS, seed=SEED, device="cpu", init_params=init_np)
    strat = build_strategy("echopfl", init, clients, seed=SEED, rnn_params=rnn_np, device="cpu")
    sim = Simulator(clients, strat, seed=SEED, coalesce_window=window, **kw)
    return strat, sim.run_async(max_time=MAX_TIME), sim


@pytest.fixture(scope="module")
def runs(weights):
    out = {}
    for name, (window, kind, policy) in CASES.items():
        ref = reference_run(window, **_args(jf, kind, policy))
        if name == "churn w45":
            out["churn w45 own order"] = (ref, port_run(weights, window, **_args(tf, kind, policy)))
            with early_row_writes():
                out[name] = (ref, port_run(weights, window, **_args(tf, kind, policy)))
        else:
            out[name] = (ref, port_run(weights, window, **_args(tf, kind, policy)))
    return out


# ------------------------------------------------------------------ units
def test_injector_draws_equal_the_reference_for_every_kind():
    """Mixed queries in one order on both injectors: every answer, the
    counters and the ledger equal; a second pair with the queries in
    another order gives the same answers per (kind, client) (the schedule
    is order-independent)."""
    cfg = dict(seed=11, crash_rate=0.4, death_rate=0.3, loss_rate=0.5, max_retries=3, dup_rate=0.4,
               reorder_rate=0.4, poison_nan_rate=0.2, poison_scale_rate=0.2, poison_sign_rate=0.2, policy="drop")
    a, b = jf.FaultInjector(jf.FaultPlan(jf.FaultConfig(**cfg))), tf.FaultInjector(tf.FaultPlan(tf.FaultConfig(**cfg)))
    queries = [(kind, cid) for _ in range(12) for cid in (0, 3, "c7", 11)
               for kind in ("crash", "upload_plan", "duplicate", "reorder", "poison")]
    got_a = [getattr(a, k)(c) for k, c in queries]
    got_b = [getattr(b, k)(c) for k, c in queries]
    assert got_a == got_b
    assert a._counters == b._counters and a.ledger_snapshot() == b.ledger_snapshot()
    assert [a.backoff(i) for i in range(8)] == [b.backoff(i) for i in range(8)]
    kinds = {type(x).__name__ for x in got_b}
    assert {"NoneType", "float", "tuple"} <= kinds
    assert b.ledger["deaths"] > 0 and b.ledger["dropped_uploads"] > 0 and b.ledger["poison_sign"] > 0
    c = tf.FaultInjector(tf.FaultPlan(tf.FaultConfig(**cfg)))
    rev = {q: [] for q in set(queries)}
    for k, cid in reversed(queries):
        rev[k, cid].append(getattr(c, k)(cid))
    fwd = {q: [] for q in set(queries)}
    for (k, cid), x in zip(queries, got_b):
        fwd[k, cid].append(x)
    assert fwd == rev


def test_zero_rates_never_draw():
    cfg = tf.FaultConfig(seed=2, crash_rate=0.0, loss_rate=0.0, dup_rate=0.0, reorder_rate=0.0)
    inj = tf.FaultInjector(tf.FaultPlan(cfg))
    assert (inj.crash(0), inj.upload_plan(0), inj.duplicate(0), inj.reorder(0), inj.poison(0)) == (
        None, (0, True), None, 0.0, None)
    assert inj._counters == {}


def _mlp_tree():
    _, _, init = jax_build_clients("har", 2, seed=SEED)
    return init


@pytest.mark.parametrize("kind", ["nan", "scale", "sign"])
@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_apply_poison_is_the_references_bits(kind, u):
    init = _mlp_tree()
    cfg = dict(seed=0, poison_nan_rate=0.5, poison_nan_frac=0.03, poison_scale_factor=123.456)
    want = jf.apply_poison(init, kind, u, jf.FaultConfig(**cfg))
    port_in = tree_from_numpy([{k: np.asarray(v) for k, v in layer.items()} for layer in init])
    before = [x.clone() for x in tree_leaves(port_in)]
    got = tf.apply_poison(port_in, kind, u, tf.FaultConfig(**cfg))
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = tree_leaves(got)
    assert len(w_leaves) == len(g_leaves) == 4  # two layers: b0, w0, b1, w1
    for w, g in zip(w_leaves, g_leaves):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32
        assert np.asarray(w, np.float32).tobytes() == g.numpy().tobytes()
    for x, y in zip(before, tree_leaves(port_in)):  # the input was not written
        assert torch.equal(x, y)
    if kind == "nan":
        assert all(int(torch.isnan(g).sum()) == max(1, round(0.03 * g.numel())) for g in g_leaves)


def _server(weights, **kw):
    init_np, rnn_np = weights
    return EchoPFLServer(tree_from_numpy(init_np), num_initial_clusters=2, refine_every=1000, rnn_params=rnn_np,
                         device="cpu", **kw)


def _uploads(init, n):
    # two well-separated groups of uploads
    return [[{k: v + (i % 2) * 0.5 + i * 0.01 for k, v in layer.items()} for layer in init] for i in range(n)]


def test_evict_frees_rows_and_reclaims_empty_clusters(weights):
    srv = _server(weights)
    for i, up in enumerate(_uploads(srv.init_params, 4)):
        srv.handle_upload(i, up, 0, 48, float(i))
    plane = srv.clustering.plane
    before = plane.num_allocated
    victim = next(c for c in sorted(srv.clustering.clusters) if srv.clustering.clusters[c].members)
    members = sorted(srv.clustering.clusters[victim].members)
    res = srv.evict_clients(members)
    assert res == {"evicted": members, "reclaimed": [victim]}
    assert victim not in srv.clustering.clusters and victim not in srv.predictors
    assert f"cluster/{victim}" not in srv.repo.names()
    assert plane.num_allocated == before - 2 - len(members)
    assert all(m not in srv.clustering.uploads and m not in srv.clustering.assignment for m in members)
    assert srv.events[-1] == {"kind": "reclaim", "cluster": victim}
    assert srv.evict_clients(members) == {"evicted": [], "reclaimed": []}  # idempotent
    assert srv.evict_clients(["nobody"]) == {"evicted": [], "reclaimed": []}


def test_evict_keeps_cluster_zero_with_clustering_off(weights):
    srv = _server(weights, enable_clustering=False)
    for i, up in enumerate(_uploads(srv.init_params, 3)):
        srv.handle_upload(i, up, 0, 48, float(i))
    res = srv.evict_clients([0, 1, 2])
    assert res == {"evicted": [0, 1, 2], "reclaimed": []} and 0 in srv.clustering.clusters


@pytest.mark.parametrize("mode,per_client", [("topk", 2), ("int8", 1)])
def test_release_client_frees_codec_rows(mode, per_client):
    template = {"w": torch.zeros(32)}
    codec = UplinkCodec(template, [0, 1, 2], resolve_uplink(mode), device="cpu")
    codec.seed({i: template for i in range(3)})
    before = codec.plane.num_allocated
    codec.release_client(1)
    assert codec.plane.num_allocated == before - per_client
    codec.release_client(1)  # idempotent
    assert codec.plane.num_allocated == before - per_client
    codec.install(1, {"w": torch.ones(32)})  # a released client is not installed again
    codec.seed({1: template})
    assert not codec._seeded[1] and codec.plane.num_allocated == before - per_client
    with pytest.raises(ValueError):
        codec.encode(1, {"w": torch.ones(32)})
    codec.encode(0, {"w": torch.ones(32)})


def test_resolve_faults_takes_arguments_only(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "1")  # the port reads no knob
    assert tf.resolve_faults(None) is None and tf.resolve_faults("off") is None
    cfg = tf.FaultConfig(seed=4)
    assert tf.resolve_faults(cfg).config is cfg
    plan = tf.FaultPlan(cfg)
    assert tf.resolve_faults(plan) is plan
    for bad in ("on", 3):
        with pytest.raises(ValueError):
            tf.resolve_faults(bad)
    with pytest.raises(ValueError):
        tf.FaultConfig(policy="maybe")
    with pytest.raises(ValueError):
        tf.FaultConfig(poison_nan_rate=0.6, poison_sign_rate=0.6)


def test_faults_off_builds_nothing(weights):
    init_np, rnn_np = weights
    _, clients, init = build_clients("har", 2, seed=SEED, device="cpu", init_params=init_np)
    strat = build_strategy("echopfl", init, clients, seed=SEED, rnn_params=rnn_np, device="cpu")
    sim = Simulator(clients, strat, seed=SEED)
    assert sim._faults is None and sim._guard is None and sim.churn == {}


# ------------------------------------------------------------- end to end
@pytest.mark.parametrize("name", list(CASES))
def test_chaos_ledgers_equal_the_reference(runs, name):
    (js, jr, jsim), (ts, tr, tsim) = runs[name]
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    for key in ("faults", "uploads", "churn_delays", "staleness", "broadcasts", "decisions", "clusters"):
        assert jr.extra.get(key) == tr.extra.get(key), key
    assert "guard" not in tr.extra
    assert js.events == ts.events
    assert js.clustering.assignment == ts.clustering.assignment
    assert jsim._dead == tsim._dead and jsim.churn_delays == tsim.churn_delays
    assert jr.summary() == tr.summary()


@pytest.mark.parametrize("name", list(CASES))
def test_chaos_accuracy_tracks_the_reference(runs, name):
    (_, jr, _), (_, tr, _) = runs[name]
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert set(tr.per_client_acc) == set(range(N_CLIENTS))


def test_the_cases_reach_every_fault(runs):
    """The parity cases are not vacuous: retries, drops, duplicates,
    reorders, crashes, deaths and churn delays all happen."""
    led = {name: runs[name][1][1].extra for name in CASES}
    assert led["retry w0"]["faults"]["upload_failures"] > 0 and led["retry w45"]["faults"]["dups_absorbed"] > 0
    assert led["retry w0"]["faults"]["stale_downlinks_absorbed"] + led["retry w45"]["faults"][
        "stale_downlinks_absorbed"] > 0
    assert led["drop w0"]["faults"]["dropped_clients"] > 0 and led["drop w45"]["faults"]["dropped_clients"] > 0
    assert led["retry w0"]["faults"]["crashes"] > 0
    assert all(led[f"death w{w}"]["faults"]["deaths"] > 0 for w in (0, 45))
    assert all(led[f"churn w{w}"]["churn_delays"] > 0 for w in (0, 45))
    assert runs["retry w0"][1][1].up_retry_bytes > 0


def test_coalesced_churn_reaches_the_references_early_row_writes(runs):
    """Without the emulation the coalesced churn run departs from the
    reference at a refine (the expansion's seed row), with the same
    uploads and churn delays."""
    (js, jr, _), (ts, tr, _) = runs["churn w45 own order"]
    assert js.events != ts.events
    assert (jr.extra["uploads"], jr.extra["churn_delays"], jr.up_bytes) == (
        tr.extra["uploads"], tr.extra["churn_delays"], tr.up_bytes)
    assert [e["kind"] for e in ts.events].count("expand") > 0


@pytest.mark.parametrize("window", [0, 45])
def test_deaths_free_their_rows(runs, window):
    """Every dead client was evicted: no upload row or assignment left, the
    plane holds exactly the live clusters' rows and the live uploads', and
    dead clients still score (with their last model)."""
    (_, rep, sim) = runs[f"death w{window}"][1]
    f = rep.extra["faults"]
    assert f["evicted_clients"] == f["deaths"] == len(sim._dead) > 0
    srv = sim.strategy
    assert srv.clustering.plane.num_allocated == 2 * len(srv.clustering.clusters) + len(srv.clustering.uploads)
    assert not (sim._dead & set(srv.clustering.uploads)) and not (sim._dead & set(srv.clustering.assignment))
    assert set(rep.per_client_acc) == set(sim.clients)


@pytest.mark.parametrize("window", [0.0, 45.0])
def test_churned_client_never_uploads_offline(weights, window):
    """No upload of a churned client arrives inside its offline window,
    and it uploads again after it."""
    init_np, rnn_np = weights
    _, clients, init = build_clients("har", 6, seed=3, device="cpu", init_params=init_np)
    strat = build_strategy("echopfl", init, clients, seed=3, rnn_params=rnn_np, device="cpu")
    seen = []
    orig = strat.handle_upload

    def spy(cid, params, bv, n, t):
        seen.append((cid, t))
        return orig(cid, params, bv, n, t)

    strat.handle_upload = spy
    if window:
        orig_many = strat.handle_uploads
        strat.handle_uploads = lambda batch: (seen.extend((b[0], b[4]) for b in batch), orig_many(batch))[1]
    rep = Simulator(clients, strat, seed=3, churn={1: [(60.0, 300.0)]}, coalesce_window=window).run_async(
        max_time=900.0)
    assert rep.extra["churn_delays"] >= 1
    assert not [t for cid, t in seen if cid == 1 and 60.0 <= t < 300.0]
    assert [t for cid, t in seen if cid == 1 and t >= 300.0]


def test_run_experiment_passes_chaos_through(weights):
    init_np, rnn_np = weights
    rep = run_experiment("har", "echopfl", num_clients=4, max_time=300, seed=SEED, device="cpu",
                         init_params=init_np, rnn_params=rnn_np, faults=bench_plan(tf, 0.3, "retry"),
                         churn={0: [(10.0, 100.0)]}, coalesce_window=45.0)[3]
    assert rep.extra["faults"]["seed"] == SEED + 1 and "churn_delays" in rep.extra and "guard" not in rep.extra
