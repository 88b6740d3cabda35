"""The port's checkpoint and restart layer against the reference's, on the CPU.

Server state (``EchoPFLServer.state_dict``, ``state_template``,
``load_state``): ``state_dict -> load_state -> state_dict`` is bit-exact,
directly and through the checkpointer, and the restored server answers the
next upload as the original does; last uploads come back and a second
restore leaks no row; on one upload stream (the one
``tests/test_torch_server.py`` uses: expansion, reassignment, merge and
dissolve all happen) the port's meta equals the reference's after a JSON
round trip (floats within rtol 1e-5, that test's tolerance) and its tree has
the reference's paths; a checkpoint written by either package mid-stream
restores into the other's server, and both go on with identical decisions.

The uplink codec's state (the reference's ``tests/test_uplink.py`` cases):
a roundtrip that continues bitwise, clients unknown to the restoring codec,
a mode mismatch, ``seed_template``, the server's pending codec section
replayed at attach, and a released client staying released
(``tests/test_guard.py``); a restored server given a guard gets empty
snapshot rings, claimed after its centers and upload rows.

The kill-restore run of ``tests/test_faults.py::TestServerKillRestore``:
``har``, 8 clients with 48 samples, seed 0, ``uplink="topk"``, faults
(seed 5: crashes 0.05, losses 0.2, duplicates and reorders 0.1), 900 s,
the server killed at 30 uploads; per event and at a 30 s window, with the
reference's initial MLP and broadcast RNN handed over. In each mode the
port's killed run equals its uninterrupted run field for field, and equals
the reference's killed run in every ledger and decision (accuracy curves
within 0.01, the tolerance of ``tests/test_torch_faults.py``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.server as jax_server_mod
from repro.checkpoint import checkpointer as jck
from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.server import EchoPFLServer as JaxServer
from repro.fl import faults as jf
from repro.fl import uplink as ju
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl import faults as tf
from repro_torch.fl import guard as tg
from repro_torch.fl.experiment import build_clients, build_strategy
from repro_torch.fl.simulator import Simulator
from repro_torch.fl.uplink import UplinkCodec, UplinkConfig, seed_template
from repro_torch.interop import tree_from_numpy
from test_torch_checkpoint import tree_to_numpy_any
from test_torch_server import _Feedback, _flat, _train_fn, _tree
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

N_CLIENTS, SAMPLES, MAX_TIME, SEED, AT = 8, 48, 900.0, 0, 30
CHAOS = dict(seed=5, crash_rate=0.05, loss_rate=0.2, dup_rate=0.1, reorder_rate=0.1)
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "up_retry_bytes", "duration",
          "up_series", "down_series")


@pytest.fixture(autouse=True)
def _no_repro_env(monkeypatch):
    import os

    for name in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(name)


@pytest.fixture(scope="module")
def rnn_np():
    return {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(SEED)).items()}


def _bits(t):
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree_to_numpy_any(t))]


def _json(meta):
    return json.loads(json.dumps(meta))


def _assert_close_meta(a, b, path="meta"):
    """Equal JSON, floats within rtol 1e-5 (ints, strings, bools and structure exact)."""
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _assert_close_meta(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close_meta(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert np.isclose(a, b, rtol=1e-5, atol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------- one server stream
N_STREAM, SPLIT = 9, 30


def _stream(n):
    rng = np.random.default_rng(0)
    bases = [_tree(rng) for _ in range(3)]
    init = _tree(rng, 0.1)
    ups = []
    for _ in range(n):
        c = int(rng.integers(N_STREAM))
        noise = _tree(rng, 0.2)
        ups.append((c, [{k: bases[c % 3][i][k] + noise[i][k] for k in ("w", "b")} for i in range(len(noise))]))
    return init, ups


def _server_kw(init):
    return dict(num_initial_clusters=3, hm=1.0, refine_every=5, local_train_fn=_train_fn,
                feedback_fn=_Feedback(_flat(init).size, N_STREAM))


def _port_server(init, rnn_np):
    return EchoPFLServer(tree_from_numpy(init), rnn_params=rnn_np, device="cpu", **_server_kw(init))


def _jax_server(init):
    return JaxServer([{k: jnp.asarray(v) for k, v in layer.items()} for layer in init],
                     pretrain_key=jax.random.PRNGKey(SEED), plane_mesh=False, plane_backend="plane",
                     **_server_kw(init))


def _feed(srv, ups, k0, torch_side):
    conv = (lambda up: [{k: torch.tensor(v) for k, v in l.items()} for l in up]) if torch_side else (
        lambda up: [{k: jnp.asarray(v) for k, v in l.items()} for l in up])
    out = []
    for k, (c, up) in enumerate(ups):
        dls = srv.handle_upload(c, conv(up), 0, 10, float(k0 + k))
        out.append(sorted((d.client_id, d.version, d.cluster_id, d.reason) for d in dls))
    return out


@pytest.fixture(scope="module")
def cached_pretrain():
    """The reference's RNN pretraining memoized by key (deterministic), so
    the strategies its runs build pretrain once."""
    cache = {}
    orig = jax_server_mod.pretrain_rnn

    def cached(key, *a, **kw):
        tag = np.asarray(key).tobytes()
        if tag not in cache:
            cache[tag] = orig(key, *a, **kw)
        return cache[tag]

    jax_server_mod.pretrain_rnn = cached
    yield
    jax_server_mod.pretrain_rnn = orig


@pytest.mark.parametrize("through_disk", [False, True], ids=["direct", "checkpointer"])
def test_state_dict_round_trips_bit_exact(rnn_np, tmp_path, through_disk):
    init, ups = _stream(40)
    srv = _port_server(init, rnn_np)
    _feed(srv, ups[:SPLIT], 0, True)
    tree1, meta1 = srv.state_dict()
    assert {e["kind"] for e in srv.events} >= {"expand", "merge", "broadcast"}
    restored = _port_server(init, rnn_np)
    if through_disk:
        save_pytree(str(tmp_path / "srv"), tree1, extra=meta1)
        raw = restore_pytree(str(tmp_path / "srv"))[1]
        tree_r, meta_r = restore_pytree(str(tmp_path / "srv"), like=restored.state_template(raw))
        assert all(isinstance(x, np.ndarray) for x in jax.tree_util.tree_leaves(tree_r))
        restored.load_state(tree_r, meta_r)
    else:
        restored.load_state(tree1, meta1)
    tree2, meta2 = restored.state_dict()
    assert _json(meta1) == meta1 == meta2  # the meta is JSON as it stands
    assert tck._paths_and_leaves(tree1)[0] == tck._paths_and_leaves(tree2)[0]
    assert _bits(tree1) == _bits(tree2)
    # the restored server answers the rest of the stream as the original does
    assert _feed(srv, ups[SPLIT:], SPLIT, True) == _feed(restored, ups[SPLIT:], SPLIT, True)
    assert srv.events == restored.events and srv.clustering.assignment == restored.clustering.assignment
    assert _bits(srv.state_dict()[0]) == _bits(restored.state_dict()[0])


def test_broadcast_ablation_merges_and_restores(tmp_path):
    """With ``enable_broadcast=False`` the predictors hold no weights. The
    stream (merges included) makes the reference's decisions, and the
    state goes through the checkpointer and back bit-exact; the
    reference's own restart of such a server fails on its template."""
    init, ups = _stream(60)
    js = JaxServer([{k: jnp.asarray(v) for k, v in layer.items()} for layer in init], plane_mesh=False,
                   plane_backend="plane", enable_broadcast=False, **_server_kw(init))
    ts = EchoPFLServer(tree_from_numpy(init), device="cpu", enable_broadcast=False, **_server_kw(init))
    assert _feed(js, ups, 0, False) == _feed(ts, ups, 0, True)
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment
    assert {"merge", "expand"} <= {e["kind"] for e in ts.events} and ts.predictors
    tree, meta = ts.state_dict()
    save_pytree(str(tmp_path / "srv"), tree, extra=meta)
    restored = EchoPFLServer(tree_from_numpy(init), device="cpu", enable_broadcast=False, **_server_kw(init))
    raw = restore_pytree(str(tmp_path / "srv"))[1]
    restored.load_state(*restore_pytree(str(tmp_path / "srv"), like=restored.state_template(raw)))
    assert all(p.params is None for p in restored.predictors.values())
    assert restored.state_dict()[1] == meta and _bits(restored.state_dict()[0]) == _bits(tree)


def test_load_state_restores_last_uploads_and_leaks_no_row(rnn_np):
    init, ups = _stream(12)
    srv = _port_server(init, rnn_np)
    srv.refine_every = 10**9
    _feed(srv, ups, 0, True)
    tree, meta = srv.state_dict()
    assert meta["upload_clients"] == sorted(str(c) for c in srv.clustering.uploads)
    restored = _port_server(init, rnn_np)
    restored.load_state(tree, meta)
    plane = restored.clustering.plane
    assert set(restored.clustering.uploads) == set(srv.clustering.uploads)
    for cid, row in srv.clustering.uploads.items():
        assert torch.equal(srv.clustering.plane.row(row), plane.row(restored.clustering.uploads[cid]))
    before = plane.num_allocated
    restored.load_state(tree, meta)  # the pre-restore rows are freed first
    assert plane.num_allocated == before == 2 * len(meta["clusters"]) + len(meta["upload_clients"])


def test_meta_and_paths_equal_the_references(rnn_np):
    init, ups = _stream(SPLIT)
    js, ts = _jax_server(init), _port_server(init, rnn_np)
    assert _feed(js, ups, 0, False) == _feed(ts, ups, 0, True)
    (jt, jm), (tt, tm) = js.state_dict(), ts.state_dict()
    _assert_close_meta(_json(jm), _json(tm))
    assert set(tm) == set(jm) and {"last_expand_round", "events", "cluster_feedback_mean"} <= set(tm)
    jp, jl = jck._paths_and_leaves(jt)
    tp, tl = tck._paths_and_leaves(tt)
    assert jp == tp
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_mid_stream_resumes_in_the_other_package(rnn_np, tmp_path, writer):
    """A server of one package after 30 uploads, saved by its checkpointer
    and restored into a fresh server of the other package: both go on over
    the rest of the stream with the same downlinks, events, assignments,
    staleness and stats (floats within rtol 1e-5)."""
    init, ups = _stream(60)
    js, ts = _jax_server(init), _port_server(init, rnn_np)
    d = str(tmp_path / "ckpt")
    if writer == "reference":
        src, dst = js, ts
        _feed(js, ups[:SPLIT], 0, False)
        tree, meta = js.state_dict()
        jck.save_pytree(d, tree, extra=meta)
        raw = restore_pytree(d)[1]
        dst.load_state(*restore_pytree(d, like=dst.state_template(raw)))
    else:
        src, dst = ts, js
        _feed(ts, ups[:SPLIT], 0, True)
        tree, meta = ts.state_dict()
        save_pytree(d, tree, extra=meta)
        raw = jck.restore_pytree(d)[1]
        dst.load_state(*jck.restore_pytree(d, like=dst.state_template(raw)))
    _assert_close_meta(_json(src.state_dict()[1]), _json(dst.state_dict()[1]))
    assert _bits(src.state_dict()[0]) == _bits(dst.state_dict()[0])  # the restore itself is exact
    rest = ups[SPLIT:]
    assert _feed(js, rest, SPLIT, False) == _feed(ts, rest, SPLIT, True)
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment
    assert js.staleness.snapshot() == ts.staleness.snapshot() and js.client_versions == ts.client_versions
    sj, st = js.stats(), ts.stats()
    fb_j, fb_t = sj.pop("cluster_feedback_mean"), st.pop("cluster_feedback_mean")
    assert sj == st and fb_j.keys() == fb_t.keys()
    np.testing.assert_allclose([fb_t[c] for c in fb_t], [fb_j[c] for c in fb_j], rtol=1e-5)
    assert {e["kind"] for e in ts.events[len(meta["events"]):]} >= {"broadcast"}


# --------------------------------------------------------------- codec state
def _template(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.tensor(rng.normal(size=(8, 4)).astype(np.float32)),
            "b": torch.tensor(rng.normal(size=(4,)).astype(np.float32))}


def _models(cids, seed=1):
    rng = np.random.default_rng(seed)
    return {c: {"w": torch.tensor(rng.normal(size=(8, 4)).astype(np.float32)),
                "b": torch.tensor(rng.normal(size=(4,)).astype(np.float32))} for c in cids}


def _codec(mode="topk", cids=(0, 1, 2, 3)):
    codec = UplinkCodec(_template(), list(cids), UplinkConfig(mode=mode), device="cpu")
    codec.seed({c: _template() for c in cids})
    return codec


def _mat(codec, models, cids):
    return torch.stack([codec.spec.flatten(models[c]) for c in cids])


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_state_roundtrip_continues_bitwise(mode):
    c1 = _codec(mode)
    c1.encode_rows([0, 1, 2, 3], _mat(c1, _models([0, 1, 2, 3]), [0, 1, 2, 3]))
    tree, meta = c1.state_dict()
    assert meta == {"mode": mode, "k": c1.k, "chunk": c1.chunk, "clients": ["0", "1", "2", "3"]}
    assert set(tree) == ({"anchors", "residuals"} if mode == "topk" else {"anchors"})
    c2 = UplinkCodec(_template(), [0, 1, 2, 3], UplinkConfig(mode=mode), device="cpu")
    c2.load_state(tree, meta)
    assert _bits(c2.state_dict()[0]) == _bits(tree) and c2.state_dict()[1] == meta
    mat2 = _mat(c1, _models([0, 1, 2, 3], seed=11), [0, 1, 2, 3])
    r1, _ = c1.encode_rows([0, 1, 2, 3], mat2)
    r2, _ = c2.encode_rows([0, 1, 2, 3], mat2)
    assert _bits(r1) == _bits(r2)


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_state_equals_the_references(mode):
    """The same seeds and encodes in both packages' codecs give the same
    meta and bitwise-equal rows (the encodes are the reference's bits)."""
    j = ju.UplinkCodec({k: jnp.asarray(v.numpy()) for k, v in _template().items()}, [0, 1, 2, 3],
                       ju.UplinkConfig(mode=mode))
    j.seed({c: {k: jnp.asarray(v.numpy()) for k, v in _template().items()} for c in (0, 1, 2)})
    t = UplinkCodec(_template(), [0, 1, 2, 3], UplinkConfig(mode=mode), device="cpu")
    t.seed({c: _template() for c in (0, 1, 2)})
    models = _models([0, 2])
    j.encode_rows([0, 2], jnp.stack([j.spec.flatten({k: jnp.asarray(v.numpy()) for k, v in models[c].items()})
                                     for c in (0, 2)]))
    t.encode_rows([0, 2], _mat(t, models, [0, 2]))
    (jt, jm), (tt, tm) = j.state_dict(), t.state_dict()
    assert jm == tm and jm["clients"] == ["0", "1", "2"]
    assert jck._paths_and_leaves(jt)[0] == tck._paths_and_leaves(tt)[0]
    assert _bits(jt) == _bits(tt)


def test_codec_restore_skips_clients_it_does_not_simulate():
    c1 = _codec("topk", cids=[0, 1])
    c1.encode(0, _models([0])[0])
    tree, meta = c1.state_dict()
    c2 = UplinkCodec(_template(), [1, 7], UplinkConfig(mode="topk"), device="cpu")
    c2.load_state(tree, meta)  # client 0 is not simulated here, 7 was never seeded
    with pytest.raises(ValueError):
        c2.encode(7, _models([7])[7])
    c2.encode(1, _models([1])[1])


def test_codec_mode_mismatch_raises():
    tree, meta = _codec("int8").state_dict()
    c2 = UplinkCodec(_template(), [0], UplinkConfig(mode="topk"), device="cpu")
    with pytest.raises(ValueError, match="mode mismatch"):
        c2.load_state(tree, meta)


def test_seed_template_structure():
    tree, meta = _codec("topk").state_dict()
    tpl = seed_template(meta, _template())
    assert set(tpl) == {"anchors", "residuals"} and set(tpl["anchors"]) == {"0", "1", "2", "3"}
    assert tck._paths_and_leaves(tpl)[0] == tck._paths_and_leaves(tree)[0]
    assert set(seed_template(_codec("int8").state_dict()[1], _template())) == {"anchors"}


def test_released_client_stays_released_through_a_restore():
    codec = UplinkCodec(_template(), [0, 1, 2], UplinkConfig(mode="topk"), device="cpu")
    codec.seed({i: _template() for i in range(3)})
    codec.release_client(1)
    tree, meta = codec.state_dict()
    assert meta["clients"] == ["0", "2"]
    codec2 = UplinkCodec(_template(), [0, 1, 2], UplinkConfig(mode="topk"), device="cpu")
    codec2.release_client(1)
    before = codec2.plane.num_allocated
    codec2.load_state(tree, meta)
    assert not codec2._seeded[codec2.index[1]] and codec2.plane.num_allocated == before


def test_server_checkpoint_carries_the_codec_and_replays_it_at_attach(tmp_path, rnn_np):
    init = _template()
    srv = EchoPFLServer(init, num_initial_clusters=2, rnn_params=rnn_np, device="cpu")
    codec = _codec("topk")
    srv.attach_uplink_codec(codec)
    models = _models([0, 1, 2, 3])
    for c in (0, 1, 2):
        rec, _ = codec.encode(c, models[c])
        srv.handle_upload(c, rec, 0, 16, float(c))
    tree, meta = srv.state_dict()
    assert "uplink" in tree and meta["uplink"]["mode"] == "topk"
    save_pytree(str(tmp_path / "srv"), tree, extra=meta)
    srv2 = EchoPFLServer(init, num_initial_clusters=2, rnn_params=rnn_np, device="cpu")
    raw = restore_pytree(str(tmp_path / "srv"))[1]
    template = srv2.state_template(raw)
    assert "uplink" in template
    srv2.load_state(*restore_pytree(str(tmp_path / "srv"), like=template))  # no codec yet: kept pending
    assert srv2._pending_uplink_state is not None
    codec2 = UplinkCodec(_template(), [0, 1, 2, 3], UplinkConfig(mode="topk"), device="cpu")
    codec2.seed({c: _template(seed=9) for c in (0, 1, 2, 3)})
    srv2.attach_uplink_codec(codec2)  # the replay overwrites the fresh seed
    assert srv2._pending_uplink_state is None
    (t1, m1), (t2, m2) = codec.state_dict(), codec2.state_dict()
    assert m1 == m2 and _bits(t1) == _bits(t2)
    assert _bits(srv.state_dict()[0]) == _bits(srv2.state_dict()[0])


def test_attach_guard_gives_a_restored_server_empty_rings(rnn_np):
    init, ups = _stream(12)
    srv = _port_server(init, rnn_np)
    srv.attach_guard(tg.IngestGuard(tg.GuardConfig(snapshot_ring=2)))
    _feed(srv, ups, 0, True)
    tree, meta = srv.state_dict()
    assert not any(k.startswith("snap") for k in tree) and "snapshot" not in json.dumps(meta)
    restored = _port_server(init, rnn_np)
    restored.load_state(tree, meta)
    assert all(c._snap_rows is None for c in restored.clustering.clusters.values())
    plane = restored.clustering.plane
    n_state = plane.num_allocated
    restored.attach_guard(tg.IngestGuard(tg.GuardConfig(snapshot_ring=2)))
    rings = [r for c in restored.clustering.clusters.values() for r in c._snap_rows]
    assert len(rings) == 2 * len(restored.clustering.clusters) and all(
        c._snap_count == 0 for c in restored.clustering.clusters.values())
    assert plane.num_allocated == n_state + len(rings)
    # an empty ring rolls back to the broadcast anchor, as the reference's does
    c = next(iter(restored.clustering.clusters.values()))
    anchor = c.broadcast_vec
    plane.write(c._row, torch.full_like(anchor, float("nan")))
    assert c.rollback() and torch.equal(c.center_vec, anchor)


# ------------------------------------------------------------ kill and restore
@pytest.fixture(scope="module")
def weights(rnn_np):
    _, _, init = jax_build_clients("har", N_CLIENTS, seed=SEED, samples_per_client=SAMPLES)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in init], rnn_np


def port_run(weights, window, restart_dir=None, uplink="topk"):
    init_np, rnn = weights
    _, clients, init = build_clients("har", N_CLIENTS, seed=SEED, samples_per_client=SAMPLES, device="cpu",
                                     init_params=init_np)

    def factory():
        return build_strategy("echopfl", init, clients, seed=SEED, rnn_params=rnn, device="cpu")

    plan = None if restart_dir is None else tf.ServerRestartPlan(at_uploads=AT, directory=restart_dir,
                                                                  strategy_factory=factory)
    sim = Simulator(clients, factory(), seed=SEED, coalesce_window=window, uplink=uplink,
                    faults=tf.FaultPlan(config=tf.FaultConfig(**CHAOS), restart=plan))
    return sim.run_async(max_time=MAX_TIME), sim


def reference_killed_run(window, restart_dir):
    _, clients, init = jax_build_clients("har", N_CLIENTS, seed=SEED, samples_per_client=SAMPLES)

    def factory():
        return jax_build_strategy("echopfl", init, clients, seed=SEED)

    plan = jf.ServerRestartPlan(at_uploads=AT, directory=restart_dir, strategy_factory=factory)
    sim = JaxSimulator(clients, factory(), seed=SEED, client_backend="fleet", coalesce_window=window,
                       uplink="topk", guard="off", faults=jf.FaultPlan(config=jf.FaultConfig(**CHAOS), restart=plan))
    return sim.run_async(max_time=MAX_TIME), sim


@pytest.fixture(scope="module")
def kill_runs(weights, cached_pretrain, tmp_path_factory):
    out = {}
    for window in (0.0, 30.0):
        d = tmp_path_factory.mktemp(f"ck{int(window)}")
        base = port_run(weights, window)
        killed = port_run(weights, window, str(d / "port"))
        ref = reference_killed_run(window, str(d / "reference"))
        out[window] = base, killed, ref
    return out


def _no_restart(faults):
    return {k: v for k, v in faults.items() if k != "server_restarts"}


@pytest.mark.parametrize("window", [0.0, 30.0], ids=["per_event", "w30"])
def test_killed_run_equals_the_uninterrupted_run(kill_runs, window):
    (base, sb), (killed, sk), _ = kill_runs[window]
    assert killed.extra["faults"]["server_restarts"] == 1 and base.extra["faults"]["server_restarts"] == 0
    assert sk.strategy is not sb.strategy and sk.strategy.uplink_codec is sk._codec  # the codec re-attached
    assert getattr(sk.strategy.feedback_batch_fn, "_fleet", None) is sk._fleet  # the fleet's probe reinstalled
    assert _no_restart(killed.extra["faults"]) == _no_restart(base.extra["faults"])
    assert killed.curve == base.curve and killed.per_client_acc == base.per_client_acc
    for field in LEDGER:
        assert getattr(killed, field) == getattr(base, field), field
    for key in ("staleness", "uploads", "broadcasts", "decisions", "rnn_broadcasts", "clusters", "merges",
                "expansions", "plane_rows", "cluster_feedback_mean", "uplink"):
        assert killed.extra.get(key) == base.extra.get(key), key
    assert killed.extra["uploads"] > AT
    assert sk.strategy.events == sb.strategy.events
    assert sk.strategy.clustering.assignment == sb.strategy.clustering.assignment
    assert _bits(sk.strategy.state_dict()[0]) == _bits(sb.strategy.state_dict()[0])


@pytest.mark.parametrize("window", [0.0, 30.0], ids=["per_event", "w30"])
def test_killed_run_equals_the_references_killed_run(kill_runs, window):
    _, (killed, sk), (ref, sr) = kill_runs[window]
    assert killed.extra["faults"] == ref.extra["faults"]
    for field in LEDGER:
        assert getattr(killed, field) == getattr(ref, field), field
    for key in ("staleness", "uploads", "broadcasts", "decisions", "rnn_broadcasts", "clusters", "merges",
                "expansions", "uplink"):
        assert killed.extra.get(key) == ref.extra.get(key), key
    assert sk.strategy.events == sr.strategy.events
    assert sk.strategy.clustering.assignment == sr.strategy.clustering.assignment
    assert [t for t, _ in killed.curve] == [t for t, _ in ref.curve]
    np.testing.assert_allclose([a for _, a in killed.curve], [a for _, a in ref.curve], atol=0.01)
    _assert_close_meta(_json(sr.strategy.state_dict()[1]), _json(sk.strategy.state_dict()[1]))


def test_restart_due_and_mark_restarted_follow_the_reference():
    for mod in (jf, tf):
        plan = mod.FaultPlan(restart=mod.ServerRestartPlan(at_uploads=3, directory="unused",
                                                           strategy_factory=lambda: None))
        inj = mod.FaultInjector(plan)
        assert [inj.restart_due(u) for u in (0, 2, 3, 9)] == [False, False, True, True]
        inj.mark_restarted()
        assert not inj.restart_due(9) and inj.ledger["server_restarts"] == 1
    assert not tf.FaultInjector(tf.FaultPlan()).restart_due(10**6)


def test_a_strategy_without_state_fails_at_the_restart(weights, tmp_path):
    """FedAsyn keeps no checkpointable state: the restart raises, as the
    reference's does, instead of going on without it."""
    init_np, rnn = weights
    _, clients, init = build_clients("har", 4, seed=SEED, samples_per_client=SAMPLES, device="cpu",
                                     init_params=init_np)
    plan = tf.ServerRestartPlan(at_uploads=3, directory=str(tmp_path),
                                strategy_factory=lambda: build_strategy("fedasyn", init, clients, device="cpu"))
    sim = Simulator(clients, build_strategy("fedasyn", init, clients, device="cpu"), seed=SEED,
                    faults=tf.FaultPlan(restart=plan))
    with pytest.raises(AttributeError, match="state_dict"):
        sim.run_async(max_time=MAX_TIME)
