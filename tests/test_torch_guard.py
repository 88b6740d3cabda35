"""The port's ingest guard (``repro_torch.fl.guard``), the snapshot ring
and center rollback, against the reference's, on the CPU.

Units: ``IngestGuard`` gives the reference's decisions, ledgers and
histories on the same statistic streams (with NaN, Inf, blow-ups,
quarantine and eviction), and ``upload_stats`` the reference's float64
numbers bit for bit on the same payload; the snapshot ring restores the
newest finite snapshot and its rows go back with the cluster (the
reference's ``TestSnapshotRing`` cases).

End to end on ``har`` (8 clients, 900 s, seed 0; the reference's initial
MLP and broadcast RNN handed over), per event and at a 45 s window:

- a guard on a clean run is the guard-off run bit for bit;
- ``bench_defense.py``'s poison at rate 0.2 (NaN 0.1, blow-up and sign flip
  0.05 each, fault seed 1, the default crash/loss/duplicate/reorder rates),
  guard on and off: the guard, fault and byte ledgers, uploads, events and
  assignments equal the reference's, and so does the guard-off run's
  count of non-finite centers; the guard-on runs end with finite centers;
- a guard whose center check fails on a fixed schedule of its calls (the
  same subclass in both packages) forces rollbacks in mid-segment, after
  planned steps: the port plans the steps before the failure, rolls back
  at it and relaunches the rest, and its ledgers equal the reference's,
  which runs that sub-window serially.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl import faults as jf
from repro.fl import guard as jg
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.network import NetworkModel as JaxNetwork
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl import faults as tf
from repro_torch.fl import guard as tg
from repro_torch.fl.experiment import build_clients, build_strategy
from repro_torch.fl.simulator import Simulator
from repro_torch.interop import tree_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

N_CLIENTS, MAX_TIME, SEED = 8, 900.0, 0
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "up_retry_bytes", "duration", "up_series",
          "down_series")


@pytest.fixture(autouse=True)
def _no_repro_env(monkeypatch):
    import os

    for name in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(name)


def poison_plan(mod, rate: float):
    """``benchmarks/bench_defense.py``'s plan at one rate, in either package."""
    return mod.FaultPlan(config=mod.FaultConfig(seed=SEED + 1, poison_nan_rate=rate / 2,
                                                poison_scale_rate=rate / 4, poison_sign_rate=rate / 4))


def _failing(base):
    class FailingGuard(base):
        """A guard whose center check fails at calls 4, 13, 22, ... (the
        calls come in the per-event order in both loops and packages)."""

        calls = 0

        def center_ok(self, cluster_key, cnorm):
            self.calls += 1
            if self.calls % 9 == 4:
                return False
            return super().center_ok(cluster_key, cnorm)

    return FailingGuard


@pytest.fixture(scope="module")
def weights():
    _, _, init = jax_build_clients("har", N_CLIENTS, seed=SEED)
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(SEED)).items()}
    return init_np, rnn_np


def reference_run(window, faults, guard, failing=False):
    _, clients, init = jax_build_clients("har", N_CLIENTS, seed=SEED)
    strat = jax_build_strategy("echopfl", init, clients, seed=SEED)
    sim = JaxSimulator(clients, strat, network=JaxNetwork(), seed=SEED, client_backend="fleet",
                       coalesce_window=window, faults=faults, guard=guard)
    if failing:
        sim._guard = _failing(jg.IngestGuard)(sim._guard.cfg)
    return strat, sim.run_async(max_time=MAX_TIME), sim


def port_run(weights, window, faults, guard, failing=False):
    init_np, rnn_np = weights
    _, clients, init = build_clients("har", N_CLIENTS, seed=SEED, device="cpu", init_params=init_np)
    strat = build_strategy("echopfl", init, clients, seed=SEED, rnn_params=rnn_np, device="cpu")
    sim = Simulator(clients, strat, seed=SEED, coalesce_window=window, faults=faults, guard=guard)
    if failing:
        sim._guard = _failing(tg.IngestGuard)(sim._guard.cfg)
    return strat, sim.run_async(max_time=MAX_TIME), sim


def nonfinite_centers(strat) -> int:
    return sum(not np.isfinite(np.asarray(c.center_vec)).all() for c in strat.clustering.clusters.values())


POISON_CASES = [(g, w) for g in ("on", "off") for w in (0.0, 45.0)]


@pytest.fixture(scope="module")
def poison_runs(weights):
    return {(g, w): (reference_run(w, poison_plan(jf, 0.2), g), port_run(weights, w, poison_plan(tf, 0.2), g))
            for g, w in POISON_CASES}


@pytest.fixture(scope="module")
def failing_runs(weights):
    from repro_torch.core import server as server_mod

    out = {}
    orig = server_mod.EchoPFLServer._handle_upload_segment
    for w in (0.0, 45.0):
        cut: list = []

        def seg(self, s):
            res = orig(self, s)
            cut.append((len(s), res[1]))
            return res

        server_mod.EchoPFLServer._handle_upload_segment = seg
        try:
            out[w] = (reference_run(w, "off", "on", failing=True), port_run(weights, w, None, "on", failing=True),
                      cut)
        finally:
            server_mod.EchoPFLServer._handle_upload_segment = orig
    return out


# ------------------------------------------------------------------ units
def _stream(seed, n=400):
    """Statistic tuples (client, cluster, finite, l2, dist) and center norms:
    mostly tight values, some blow-ups, NaN and Inf, and a few persistent
    offenders."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cid = int(rng.integers(0, 12))
        key = int(rng.integers(-1, 3))
        l2, dist = float(rng.normal(10, 0.5)), float(rng.normal(50, 2))
        finite = True
        r = rng.uniform()
        if cid in (3, 7) and r < 0.5 or r < 0.05:
            l2 *= 1e3
        elif r < 0.08:
            dist *= 40
        elif r < 0.1:
            finite, l2, dist = False, math.inf, math.inf
        cn = float(rng.normal(300, 5)) if rng.uniform() > 0.05 else (1e6 if rng.uniform() < 0.5 else math.nan)
        out.append((cid, key, finite, l2, dist, cn))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [{}, dict(grace=2, window=8, k=2.0, quarantine_strikes=2, evict_strikes=3)])
def test_guard_decisions_equal_the_reference_on_one_stream(seed, cfg):
    a, b = jg.IngestGuard(jg.GuardConfig(**cfg)), tg.IngestGuard(tg.GuardConfig(**cfg))
    for cid, key, finite, l2, dist, cn in _stream(seed):
        assert a.check_upload(cid, key, finite, l2, dist) == b.check_upload(cid, key, finite, l2, dist)
        assert a.should_evict(cid) == b.should_evict(cid)
        assert a.center_ok(key, cn) == b.center_ok(key, cn)
    assert a.ledger_snapshot() == b.ledger_snapshot()
    for name in ("_norm_hist", "_dist_hist", "_center_hist"):
        ha, hb = getattr(a, name), getattr(b, name)
        assert {k: list(v) for k, v in ha.items()} == {k: list(v) for k, v in hb.items()}, name
    assert a._last_home == b._last_home and a._strikes == b._strikes
    assert a.quarantined == b.quarantined and a.evicted == b.evicted
    led = b.ledger_snapshot()
    assert led["rejected_norm"] > 0 and led["rejected_nonfinite"] > 0


@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "scale"])
def test_upload_stats_are_the_references_bits(kind):
    rng = np.random.default_rng(5)
    tree = [{"w": rng.standard_normal((6, 5)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)},
            {"w": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}]
    center = [{k: (v + 0.1).astype(np.float32) for k, v in layer.items()} for layer in tree]
    if kind == "nan":
        tree[1]["w"][2, 1] = np.nan
    elif kind == "inf":
        tree[0]["b"][0] = np.inf
    elif kind == "scale":
        tree = [{k: v * np.float32(1e30) for k, v in layer.items()} for layer in tree]
    to_j = lambda t: [{k: jnp.asarray(v) for k, v in layer.items()} for layer in t]  # noqa: E731
    for c in (center, None):
        want = jg.IngestGuard().upload_stats(to_j(tree), None if c is None else to_j(c))
        got = tg.IngestGuard().upload_stats(tree_from_numpy(tree), None if c is None else tree_from_numpy(c))
        assert want[0] == got[0] and np.float64(want[1]).tobytes() == np.float64(got[1]).tobytes()
        assert np.float64(want[2]).tobytes() == np.float64(got[2]).tobytes()


def test_resolve_guard_takes_arguments_only(monkeypatch):
    monkeypatch.setenv("REPRO_GUARD", "on")  # the port reads no knob
    assert tg.resolve_guard(None) is None and tg.resolve_guard("off") is None
    assert tg.resolve_guard("on") == tg.GuardConfig()
    cfg = tg.GuardConfig(k=3.0)
    assert tg.resolve_guard(cfg) is cfg
    with pytest.raises(ValueError):
        tg.resolve_guard("maybe")
    with pytest.raises(ValueError):
        tg.GuardConfig(quarantine_strikes=5, evict_strikes=2)


def _server(weights, ring):
    init_np, rnn_np = weights
    srv = EchoPFLServer(tree_from_numpy(init_np), num_initial_clusters=2, refine_every=1000, rnn_params=rnn_np,
                        device="cpu")
    srv.attach_guard(tg.IngestGuard(tg.GuardConfig(snapshot_ring=ring)))
    return srv


def test_rollback_restores_the_last_finite_snapshot(weights):
    srv = _server(weights, 2)
    for i in range(4):
        up = [{k: v + i * 0.01 for k, v in layer.items()} for layer in srv.init_params]
        srv.handle_upload(i, up, 0, 48, float(i))
    cl = next(iter(srv.clustering.clusters.values()))
    if cl._snap_count == 0:  # broadcasts are on demand: force one
        cl.snapshot_broadcast()
    assert cl._snap_count > 0
    good = cl.center_vec.clone()
    cl.snapshot_broadcast()  # the ring's newest entry: the current center
    srv.clustering.plane.write(cl._row, torch.full_like(good, float("nan")))
    cl._center_cache = None
    assert not torch.isfinite(cl.center_vec).all()
    assert cl.rollback() and torch.equal(cl.center_vec, good)
    # a corrupt newest snapshot is passed over for an older one, then the anchor
    srv.clustering.plane.write(cl._snap_rows[(cl._snap_cursor - 1) % 2], torch.full_like(good, float("nan")))
    srv.clustering.plane.write(cl._row, torch.full_like(good, float("nan")))
    assert cl.rollback() and torch.isfinite(cl.center_vec).all()
    for r in (*cl._snap_rows, cl._bcast_row):
        srv.clustering.plane.write(r, torch.full_like(good, float("nan")))
    assert not cl.rollback()


def test_ring_rows_freed_with_the_cluster(weights):
    srv = _server(weights, 3)
    for i in range(4):
        up = [{k: v + (i % 2) * 0.5 for k, v in layer.items()} for layer in srv.init_params]
        srv.handle_upload(i, up, 0, 48, float(i))
    plane = srv.clustering.plane
    before = plane.num_allocated
    victim = next(c for c in sorted(srv.clustering.clusters) if srv.clustering.clusters[c].members)
    members = sorted(srv.clustering.clusters[victim].members)
    assert len(srv.clustering.clusters[victim]._snap_rows) == 3
    srv.evict_clients(members)
    assert plane.num_allocated == before - 2 - 3 - len(members)


def test_attach_gives_every_cluster_a_ring(weights):
    init_np, rnn_np = weights
    srv = EchoPFLServer(tree_from_numpy(init_np), num_initial_clusters=2, rnn_params=rnn_np, device="cpu")
    for i in range(2):
        srv.handle_upload(i, [{k: v + i for k, v in layer.items()} for layer in srv.init_params], 0, 48, 0.0)
    assert all(c._snap_rows is None for c in srv.clustering.clusters.values())
    srv.attach_guard(tg.IngestGuard(tg.GuardConfig(snapshot_ring=2)))
    assert srv.clustering.snapshot_ring == 2
    assert all(len(c._snap_rows) == 2 for c in srv.clustering.clusters.values())
    c0 = srv.clustering._new_cluster(srv.init_params)
    assert len(c0._snap_rows) == 2


# ------------------------------------------------------------- end to end
def _bitwise(a, b):
    assert a.curve == b.curve and a.per_client_acc == b.per_client_acc
    for field in LEDGER:
        assert getattr(a, field) == getattr(b, field), field
    for key in ("staleness", "uploads", "broadcasts", "decisions", "clusters", "merges", "expansions"):
        assert a.extra.get(key) == b.extra.get(key), key


@pytest.mark.parametrize("window", [0.0, 45.0])
def test_guard_on_a_clean_run_changes_no_bit(weights, window):
    s_off, r_off, _ = port_run(weights, window, None, None)
    s_on, r_on, _ = port_run(weights, window, None, "on")
    _bitwise(r_off, r_on)
    assert s_off.events == s_on.events and s_off.clustering.assignment == s_on.clustering.assignment
    for cid, c in s_off.clustering.clusters.items():
        assert torch.equal(c.center_vec, s_on.clustering.clusters[cid].center_vec)
    g = r_on.extra["guard"]
    assert g["accepted"] == r_on.extra["uploads"] > 0
    assert g["rejected_nonfinite"] == g["rejected_norm"] == g["rejected_dist"] == g["rollbacks"] == 0
    assert "guard" not in r_off.extra and s_off.guard is None and s_off.clustering.snapshot_ring == 0


@pytest.mark.parametrize("guard,window", POISON_CASES)
def test_poison_ledgers_equal_the_reference(poison_runs, guard, window):
    (js, jr, _), (ts, tr, _) = poison_runs[guard, window]
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    for key in ("faults", "guard", "uploads", "staleness", "broadcasts", "decisions", "clusters"):
        assert jr.extra.get(key) == tr.extra.get(key), key
    assert js.events == ts.events
    assert js.clustering.assignment == ts.clustering.assignment
    assert nonfinite_centers(js) == nonfinite_centers(ts)
    ja, ta = np.asarray([a for _, a in jr.curve]), np.asarray([a for _, a in tr.curve])
    np.testing.assert_array_equal(np.isnan(ja), np.isnan(ta))
    np.testing.assert_allclose(ta, ja, atol=0.01, rtol=0)


def test_poison_runs_are_what_the_bench_shows(poison_runs):
    """Guard off, NaN reaches the centers and accuracy collapses; guard on,
    NaN uploads are rejected, every center ends finite and the curve has
    no NaN; both arms drew the same poison."""
    for w in (0.0, 45.0):
        (_, (ts_off, tr_off, _)), (_, (ts_on, tr_on, _)) = poison_runs["off", w], poison_runs["on", w]
        assert tr_off.extra["faults"]["poison_nan"] > 0
        assert nonfinite_centers(ts_off) > 0 and nonfinite_centers(ts_on) == 0
        assert tr_on.extra["guard"]["rejected_nonfinite"] > 0
        assert all(math.isfinite(a) for _, a in tr_on.curve)
        assert tr_on.final_acc > tr_off.final_acc


@pytest.mark.parametrize("window", [0.0, 45.0])
def test_forced_center_failures_roll_back_as_the_reference(failing_runs, window):
    (js, jr, _), (ts, tr, _), cut = failing_runs[window]
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    for key in ("guard", "uploads", "staleness", "broadcasts", "decisions", "clusters", "rnn_broadcasts"):
        assert jr.extra.get(key) == tr.extra.get(key), key
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment
    assert tr.extra["guard"]["rollbacks"] > 3
    assert sum(e["kind"] == "rollback" for e in ts.events) == tr.extra["guard"]["rollbacks"]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    if window:
        # a failure in mid-segment after planned steps: the segment was cut
        # after its second step or later and relaunched
        assert any(1 < consumed < n for n, consumed in cut), cut
