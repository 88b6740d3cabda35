"""The EchoPFL server on a sharded plane (1 x 8 and 4 x 2 meshes of the
``cpu`` device, ``mesh_min_rows=0``) against its single-device run, and
that run against the reference's.

* The reference's server scenario (``tests/test_sharded_plane.py`` and
  ``tests/test_model_axis_plane.py``: 6 clients, 40 uploads, one initial
  cluster, a refine every 8) and ``tests/test_torch_server.py``'s stream
  (9 clients, merges, reassignments and dissolves): events, assignments,
  downlinks and ``stats()`` identical to the single-device run (the
  feedback means, from segment sums added over shards, within 1 ulp),
  every center bit for bit; the single-device run's decisions those of the
  reference's single-device run, centers within rtol 1e-6.
* The reference's own sharded run on a forced 8-device host (a child
  interpreter) makes the port's 1 x 8 decisions. Its 4 x 2 run is no bar:
  ``tests/test_model_axis_plane.py``'s subprocess test fails.
* The coalesced ``har`` run with both planes meshed (``scripts/ci.sh``'s
  leg for the reference) and a per-event run that merges, each against the
  unmeshed run.
* A sharded server's ``state_dict`` restores into an unsharded server, and
  the run goes on as the sharded one does.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.server import EchoPFLServer as JaxServer
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl.experiment import run_experiment
from repro_torch.interop import tree_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_plane_mesh
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MESHES = {"1x8": (8, 1), "4x2": (4, 2)}
STAT_KEYS = ("clusters", "merges", "expansions", "staleness", "broadcasts", "rnn_broadcasts", "decisions",
             "plane_rows")


def cpu_mesh(rows: int, dims: int = 1):
    return make_plane_mesh(rows, dim_shards=dims, devices=[CPU] * (rows * dims))


@pytest.fixture(scope="module")
def rnn_np():
    return {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(0)).items()}


def _centers(srv) -> dict:
    return {cid: c.center_vec for cid, c in srv.clustering.clusters.items()}


def _assert_same_run(a, b):
    """Two port servers made the same decisions and hold the same bits; the
    reported feedback means (segment sums over shards) within 1 ulp."""
    assert a.events == b.events
    assert a.clustering.assignment == b.clustering.assignment
    assert a.client_versions == b.client_versions
    sa, sb = a.stats(), b.stats()
    fa, fb = sa.pop("cluster_feedback_mean"), sb.pop("cluster_feedback_mean")
    assert sa == sb and fa.keys() == fb.keys()
    for cid in fa:
        assert abs(fa[cid] - fb[cid]) <= abs(fb[cid]) * 2.0 ** -23, (cid, fa[cid], fb[cid])
    ca, cb = _centers(a), _centers(b)
    assert sorted(ca) == sorted(cb)
    for cid in ca:
        torch.testing.assert_close(ca[cid], cb[cid], rtol=0, atol=0)


# ------------------------------------------------------ the reference's scenario
def _feedback_fn(client_id, center):
    err = 80.0 if client_id in ("c4", "c5") else 1.0
    return (np.asarray([50.0 + err, 50.0 - err, 1.0], np.float32), np.asarray([50.0, 50.0, 1.0], np.float32),
            np.asarray([0.9, 0.08, 0.02], np.float32))


def _scenario_port(rnn_np, mesh=None, uploads=range(40), srv=None):
    def vec(x):
        return {"w": torch.full((24,), float(x))}  # 24: the model axis splits the rows

    if srv is None:
        srv = EchoPFLServer(vec(0.0), num_initial_clusters=1, refine_every=8, feedback_fn=_feedback_fn,
                            local_train_fn=lambda p: p, rnn_params=tree_from_numpy(rnn_np), plane_mesh=mesh,
                            mesh_min_rows=0, seed=0, device="cpu")
    for i in uploads:
        srv.handle_upload(f"c{i % 6}", vec(40.0 * (i % 2) + 0.01 * i), 0, 8, t=float(i))
    return srv


def _scenario_reference():
    def vec(x):
        return {"w": jnp.full((24,), float(x))}

    srv = JaxServer(vec(0.0), num_initial_clusters=1, refine_every=8, feedback_fn=_feedback_fn,
                    local_train_fn=lambda p: p, plane_backend="plane", plane_mesh=False, seed=0,
                    pretrain_key=jax.random.PRNGKey(0))
    for i in range(40):
        srv.handle_upload(f"c{i % 6}", vec(40.0 * (i % 2) + 0.01 * i), 0, 8, t=float(i))
    return srv


@pytest.fixture(scope="module")
def scenario_runs(rnn_np):
    return {"single": _scenario_port(rnn_np), "reference": _scenario_reference(),
            **{name: _scenario_port(rnn_np, cpu_mesh(*shape)) for name, shape in MESHES.items()}}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_reference_scenario_sharded_matches_single_device(scenario_runs, name):
    sharded, single = scenario_runs[name], scenario_runs["single"]
    assert sharded.clustering.plane.sharded and single.clustering.plane.mesh is None
    assert sharded.clustering.plane.dim_sharded == (name == "4x2")
    assert sharded.stats()["expansions"] > 0  # the scenario reaches refinement
    _assert_same_run(sharded, single)


def test_reference_scenario_single_device_matches_reference(scenario_runs):
    port, ref = scenario_runs["single"], scenario_runs["reference"]
    assert port.events == ref.events
    assert port.clustering.assignment == ref.clustering.assignment
    sp, sr = port.stats(), ref.stats()
    assert {k: sp[k] for k in STAT_KEYS} == {k: sr[k] for k in STAT_KEYS}
    for cid, c in ref.clustering.clusters.items():
        np.testing.assert_allclose(port.clustering.clusters[cid].center_vec.numpy(), np.asarray(c.center_vec),
                                   rtol=1e-6, atol=1e-6)


_FORCED_8 = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    for name in ("REPRO_PLANE_MESH", "REPRO_PLANE_MODEL_COMPUTE"):
        os.environ.pop(name, None)
    os.environ["REPRO_PLANE_MESH_MIN_ROWS"] = "0"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core.broadcast import pretrain_rnn
    from repro.core.server import EchoPFLServer
    from repro.kernels import plane_sharded

    sys.path.insert(0, "tests")
    from test_torch_sharded_server import STAT_KEYS, _feedback_fn, _scenario_port, cpu_mesh

    assert len(jax.devices()) == 8
    # two shims for jax 0.9, which the reference predates: its make_plane_mesh(8) with the axis
    # untyped (make_mesh's default explicit axes make the plane's flush scatter raise
    # ShardingTypeError), and shard_map's check_rep under its new name
    mesh = jax.make_mesh((8,), ("plane",), axis_types=(jax.sharding.AxisType.Auto,))
    _shard_map = plane_sharded.shard_map

    def shard_map(f, check_rep=True, **kw):
        return _shard_map(f, check_vma=check_rep, **kw)

    plane_sharded.shard_map = shard_map

    def vec(x):
        return {"w": jnp.full((24,), float(x))}

    ref = EchoPFLServer(vec(0.0), num_initial_clusters=1, refine_every=8, feedback_fn=_feedback_fn,
                        local_train_fn=lambda p: p, plane_backend="plane", plane_mesh=mesh, seed=0)
    for i in range(40):
        ref.handle_upload(f"c{i % 6}", vec(40.0 * (i % 2) + 0.01 * i), 0, 8, t=float(i))
    assert ref.clustering.plane._buf.sharding.spec[0] == "plane" and ref.clustering.mesh_min_rows == 0
    rnn = {k: np.asarray(v) for k, v in pretrain_rnn(jax.random.PRNGKey(0)).items()}
    port = _scenario_port(rnn, cpu_mesh(8))
    out = {}
    for name, srv in (("reference", ref), ("port", port)):
        st = srv.stats()
        out[name] = {
            "events": srv.events, "assignment": srv.clustering.assignment,
            "stats": {k: st[k] for k in STAT_KEYS},
            "centers": {str(c): np.asarray(v.center_vec).tolist() for c, v in srv.clustering.clusters.items()},
        }
    print("DECISIONS " + json.dumps(out))
    """
)


def test_reference_forced_8_device_run_makes_the_port_decisions():
    """Both runs in one child interpreter, on one string hash seed: the
    scenario's expansion ranks two clients of equal feedback in the order a
    set of client ids iterates, which the hash seed decides."""
    env = dict(os.environ, PYTHONHASHSEED="0",
               PYTHONPATH=os.pathsep.join(p for p in ("src", os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.run([sys.executable, "-c", _FORCED_8], capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    line = next(x for x in proc.stdout.splitlines() if x.startswith("DECISIONS "))
    runs = json.loads(line[len("DECISIONS "):])
    ref, port = runs["reference"], runs["port"]
    assert port["events"] == ref["events"]
    assert port["assignment"] == ref["assignment"]
    assert port["stats"] == ref["stats"] and ref["stats"]["expansions"] > 0
    assert port["centers"].keys() == ref["centers"].keys()
    for cid, v in ref["centers"].items():
        np.testing.assert_allclose(port["centers"][cid], v, rtol=1e-6, atol=1e-6)


def test_sharded_state_restores_into_an_unsharded_server(rnn_np):
    """Stop the 4 x 2 run at 24 uploads, restore its state_dict into a
    server without a mesh and run the last 16 there: the run of a sharded
    server throughout, bit for bit (a checkpoint holds whole rows)."""
    full = _scenario_port(rnn_np, cpu_mesh(4, 2))
    half = _scenario_port(rnn_np, cpu_mesh(4, 2), uploads=range(24))
    tree, meta = half.state_dict()
    meta = json.loads(json.dumps(meta))
    fresh = EchoPFLServer({"w": torch.zeros(24)}, num_initial_clusters=1, refine_every=8,
                          feedback_fn=_feedback_fn, local_train_fn=lambda p: p,
                          rnn_params=tree_from_numpy(rnn_np), seed=0, device="cpu")
    fresh.load_state(tree, meta, client_id_type=str)
    assert fresh.clustering.plane.mesh is None
    _scenario_port(rnn_np, uploads=range(24, 40), srv=fresh)
    assert fresh.events == full.events and fresh.clustering.assignment == full.clustering.assignment
    for cid, v in _centers(full).items():
        torch.testing.assert_close(fresh.clustering.clusters[cid].center_vec, v, rtol=0, atol=0)


# ------------------------------------------- the per-event stream with merges
def test_merging_stream_sharded_matches_single_device(rnn_np):
    """``tests/test_torch_server.py``'s stream on both meshes: every refine
    branch (expansion, reassignment, merge, dissolve) on sharded launches,
    the merge in place (1 x 8) and on gathered rows (4 x 2)."""
    from test_torch_server import DIMS, _Feedback, _flat, _train_fn, _tree

    def run(mesh):
        rng = np.random.default_rng(0)
        bases = [_tree(rng) for _ in range(3)]
        init = _tree(rng, 0.1)
        kw = dict(num_initial_clusters=3, hm=1.0, refine_every=5, local_train_fn=_train_fn,
                  feedback_fn=_Feedback(_flat(init).size, 9))
        srv = EchoPFLServer([{k: torch.tensor(v) for k, v in layer.items()} for layer in init],
                            rnn_params=tree_from_numpy(rnn_np), device="cpu", plane_mesh=mesh, mesh_min_rows=0,
                            **kw)
        downs = []
        for k in range(60):
            c = int(rng.integers(9))
            noise = _tree(rng, 0.2)
            up = [{n: bases[c % 3][i][n] + noise[i][n] for n in ("w", "b")} for i in range(len(noise))]
            msgs = srv.handle_upload(c, [{n: torch.tensor(v) for n, v in layer.items()} for layer in up], 0, 10,
                                     float(k))
            downs.extend((m.client_id, m.version, m.cluster_id, m.reason) for m in msgs)
        return srv, downs

    assert DIMS == (12, 10, 6)  # 192 + 66 = 258 floats: the model axis of 2 divides the rows
    single, d_single = run(None)
    kinds = {e["kind"] for e in single.events}
    assert {"merge", "expand", "dissolve"} <= kinds, kinds
    for shape in MESHES.values():
        ops.reset_launch_counts()
        sharded, d_sharded = run(cpu_mesh(*shape))
        assert d_sharded == d_single
        _assert_same_run(sharded, single)
        calls = ops.sharded_calls()
        assert all(calls[name] > 0 for name in calls), calls


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def har_weights(rnn_np):
    from repro.fl.experiment import build_clients as jax_build_clients

    _, _, init = jax_build_clients("har", 8, seed=0)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in init], rnn_np


def _har(weights, **kw):
    init, rnn = weights
    return run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0, device="cpu", init_params=init,
                          rnn_params=rnn, **kw)


def _assert_same_report(a, b):
    (_, _, sa, ra), (_, _, sb, rb) = a, b
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "curve", "final_acc"):
        assert getattr(ra, name) == getattr(rb, name), name
    assert ra.extra["uploads"] == rb.extra["uploads"]
    _assert_same_run(sa, sb)


@pytest.mark.parametrize("window", [45.0, 0.0], ids=["coalesced", "per-event"])
def test_meshed_har_runs_match_the_unmeshed_run(har_weights, window):
    """Both planes meshed, as the reference's CI leg runs it: the coalesced
    run at a 45 s window on 8 plane shards and 8 fleet shards (its chain on
    the first device), and a per-event run with ``hm=1.0`` on 4 x 2 plane
    shards and 4 fleet shards."""
    kw = dict(coalesce_window=window)
    if window:
        meshes = dict(plane_mesh="8", fleet_mesh="8")
    else:
        kw["hm"] = 1.0
        meshes = dict(plane_mesh="4x2", fleet_mesh="4")
    single = _har(har_weights, **kw)
    ops.reset_launch_counts()
    meshed = _har(har_weights, mesh_min_rows=0, **meshes, **kw)
    assert meshed[2].clustering.plane.sharded
    _assert_same_report(meshed, single)
    assert ops.sharded_calls()["chi2_feedback_segmented"] > 0
    if not window:
        assert meshed[2].clustering.merges > 0
