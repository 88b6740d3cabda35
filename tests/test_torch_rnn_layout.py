"""The broadcast RNN kernel's work split and sums (``csrc/rnn.cu``), and its
one launch an upload on the per-event path, on the CPU.

(a) The work split read from ``csrc/rnn.cu``'s constants: the threads'
    blocks cover each weight of wh0, wx1 and wh1 exactly once; the two
    reduce-scatters of shuffles, played out on 32 lanes in numpy, leave each
    lane the column (forward) or row (backward) the kernel says, and the
    warps' partials cover every (tile, entry) slot once.
(b) The kernel's sum orders (``tests/torch_rnn_model.py::kernel_grads``:
    the reduce-scatter backward, the tile sums, the logits' butterfly) in
    float32 give autograd's and ``jax.grad``'s gradients within the model's
    stated bounds.
(c) A ``har`` EchoPFL run on the CPU makes one ``rnn_step`` call (one
    ``rnn_chain`` launch on the card) an upload that learns or decides by
    the RNN, none through ``rnn_sgd`` or ``rnn_want``, and its events,
    ledgers and decisions equal the reference's.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rnn_model as model
from repro.core import broadcast as ref
from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import run_experiment as jax_run_experiment
from repro_torch.core import broadcast as bc
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl.experiment import run_experiment
from repro_torch.kernels import rnn
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "rnn.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, ROWS_T = _const("kThreadsRnn"), _const("kRowsT")
ROW_GROUPS, COL_GROUPS = _const("kRowGroups"), _const("kColGroups")
TILE, TILES = ROWS_T * ROW_GROUPS, model.HIDDEN // (ROWS_T * ROW_GROUPS)
H = model.HIDDEN
CLUSTERS = (1, 2)  # the kernel's variants: one block to 104 records, a cluster of two past that


def _cols_t(cluster: int) -> int:
    return 4 // cluster  # Split<kCl>::kColsT


def _places(cluster: int):
    """Each thread's (rank, lane, row tile, column tile, row group, column
    group, i0, j0) over the cluster's blocks, as ``Place`` in csrc/rnn.cu
    computes them."""
    tid = np.arange(THREADS * cluster)
    rank, lane, warp = tid // THREADS, tid % 32, (tid % THREADS) // 32
    wr, wc, rg, cg = warp // TILES, warp % TILES, lane % ROW_GROUPS, lane // ROW_GROUPS
    cols_t = _cols_t(cluster)
    j0 = rank * (H // cluster) + cols_t * COL_GROUPS * wc + cols_t * cg
    return rank, lane, wr, wc, rg, cg, TILE * wr + ROWS_T * rg, j0


# ---------------------------------------------------------------------- (a)
def test_constants_are_the_model_s():
    assert (THREADS, ROWS_T, ROW_GROUPS, COL_GROUPS) == (512, model.ROWS_T, model.ROW_GROUPS, model.COL_GROUPS)
    assert TILE == model.TILE and TILES == model.TILES and _cols_t(1) == model.COLS_T
    for line in ("constexpr int kTile = kRowsT * kRowGroups;", "constexpr int kTiles = kH / kTile;",
                 "static constexpr int kColsT = 4 / kCl;", "static constexpr int kTileC = kColsT * kColGroups;",
                 "static constexpr int kCols = kH / kCl;", "static constexpr int kTilesB = kTiles * kCl;",
                 "int wr() const { return warp / kTiles; }", "int wc() const { return warp % kTiles; }",
                 "int rg() const { return lane % kRowGroups; }", "int cg() const { return lane / kRowGroups; }",
                 "int i0() const { return kTile * wr() + kRowsT * rg(); }",
                 "int j0() const { return rank * L::kCols + L::kTileC * wc() + L::kColsT * cg(); }",
                 "int n() const { return kTile * wr() + lane; }",
                 "int c() const { return rank * L::kCols + L::kTileC * wc() + lane % L::kTileC; }"):
        assert line in SOURCE, line
    assert "int variant(int64_t T) { return T <= Split<1>::kSharedT ? 1 : 2; }" in SOURCE  # the window decides


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("matrix", ["wh0", "wx1", "wh1"])
def test_each_weight_is_held_by_one_thread(matrix, cluster):
    """The threads' 8 x 4 (one block) or 8 x 2 (a cluster of two) blocks cover the 128 x 128 matrix, each
    weight once (the three matrices share the split)."""
    *_, i0, j0 = _places(cluster)
    count = np.zeros((H, H), np.int64)
    for a in range(ROWS_T):
        for b in range(_cols_t(cluster)):
            np.add.at(count, (i0 + a, j0 + b), 1)
    assert (count == 1).all(), matrix
    assert cluster * THREADS * ROWS_T * _cols_t(cluster) == H * H


def _pair(v_lo, v_hi, hi, mask, lanes):
    """``pair`` in csrc/rnn.cu on 32 lanes: keep + the partner's send."""
    send = np.where(hi, v_lo, v_hi)
    keep = np.where(hi, v_hi, v_lo)
    return keep + send[lanes ^ mask]


def test_reduce_scatters_leave_each_lane_its_column_and_row():
    """Tag each thread's partial with a distinct power of two for its (column or row, source lane): after
    the forward's reduce-scatter lane l holds exactly column j0 + rg's four row groups (with two columns a
    thread, column j0 + rg / 2's, in lanes rg and rg ^ 1), after the backward's row i0 + cg's eight column
    groups."""
    lanes = np.arange(32)
    rg, cg = lanes % ROW_GROUPS, lanes // ROW_GROUPS
    tag = lambda b, l: 1 << (32 * b + l)  # noqa: E731
    b1, b0 = (lanes & 2) != 0, (lanes & 1) != 0
    v = [np.array([tag(b, l) for l in lanes], dtype=object) for b in range(4)]
    w0, w1 = _pair(v[0], v[2], b1, 2, lanes), _pair(v[1], v[3], b1, 2, lanes)
    four = _pair(w0, w1, b0, 1, lanes)
    w = _pair(v[0], v[1], b1, 2, lanes)
    two = w + w[lanes ^ 1]
    for l in lanes:
        group = [src for src in lanes if cg[src] == cg[l]]
        assert four[l] == sum(tag(rg[l], src) for src in group), l
        assert two[l] == sum(tag(rg[l] >> 1, src) for src in group), l
    v8 = [np.array([tag(a, l) for l in lanes], dtype=object) for a in range(ROWS_T)]
    b4, b3, b2 = (lanes & 16) != 0, (lanes & 8) != 0, (lanes & 4) != 0
    w = [_pair(v8[m], v8[m + 4], b4, 16, lanes) for m in range(4)]
    y = [_pair(w[m], w[m + 2], b3, 8, lanes) for m in range(2)]
    got = _pair(y[0], y[1], b2, 4, lanes)
    for l in lanes:
        assert got[l] == sum(tag(cg[l], src) for src in lanes if rg[src] == rg[l]), l


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_partials_cover_every_slot_once(cluster):
    """Forward: the storing lanes of warp (wr, wc) write entry j0 + rg (j0 + rg / 2) of row tile wr's
    partials, in every block; backward: entry i0 + cg of column tile (rank, wc)'s, in the block that owns
    the entry. Each (tile, entry) slot of a product once, and the backward's entries each block reads are
    its own columns."""
    rank, lane, wr, wc, rg, cg, i0, j0 = _places(cluster)
    cols_t = _cols_t(cluster)
    stores = (lane & 1) == 0 if cols_t == 2 else np.ones_like(lane, bool)
    col = j0 + (rg if cols_t == 4 else rg >> 1)
    fwd = np.zeros((TILES, H), np.int64)
    np.add.at(fwd, (wr[stores], col[stores]), 1)
    assert (fwd == 1).all()
    bwd = np.zeros((TILES * cluster, H), np.int64)
    np.add.at(bwd, (rank * TILES + wc, i0 + cg), 1)
    assert (bwd == 1).all()
    owner = (i0 + cg) // (H // cluster)
    c = rank * (H // cluster) + cols_t * COL_GROUPS * wc + lane % (cols_t * COL_GROUPS)  # Place::c
    assert set(zip(rank, c)) == {(r, e) for r in range(cluster) for e in range(r * H // cluster, (r + 1) * H // cluster)}
    assert set(owner) == set(range(cluster))


# ---------------------------------------------------------------------- (b)
def _ref_weights(seed: int) -> dict:
    return {k: np.asarray(v) for k, v in ref.init_rnn(jax.random.PRNGKey(seed)).items()}


@pytest.mark.parametrize("T", [1, 2, 10, 33, 128])
def test_kernel_order_gradients_are_autograd_and_jax_grad(T):
    w = _ref_weights(200 + T)
    x = np.random.default_rng(T).uniform(0.05, 1.0, (T, 1)).astype(np.float32)
    label = (T + 1) % 2
    got, loss = model.kernel_grads(w, x, label)
    leaves = {k: torch.from_numpy(np.array(v, np.float32)).requires_grad_(True) for k, v in w.items()}
    lt = -torch.log_softmax(rnn.rnn_logits(leaves, torch.from_numpy(x)), dim=-1)[label]
    autograd = {k: g.numpy() for k, g in zip(leaves, torch.autograd.grad(lt, list(leaves.values())))}
    jg = jax.grad(lambda p: -jax.nn.log_softmax(ref.rnn_logits(p, jnp.asarray(x)))[label])(
        {k: jnp.asarray(v) for k, v in w.items()})
    for name, want in (("autograd", autograd), ("jax.grad", {k: np.asarray(v) for k, v in jg.items()})):
        for k in model.LEAVES:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=model.GRAD_RTOL,
                                       atol=model.GRAD_ATOL_OF_MAX * np.abs(want[k]).max(), err_msg=f"{name} {k}")
    np.testing.assert_allclose(loss, float(lt.detach()), rtol=1e-6)


def test_kernel_order_sums_are_the_products():
    """The forward and backward orders sum the same products: within float32 rounding of numpy's matmul."""
    rng = np.random.default_rng(3)
    W = rng.standard_normal((H, H)).astype(np.float32)
    v = rng.standard_normal(H).astype(np.float32)
    np.testing.assert_allclose(model.kernel_hw(v, W), v.astype(np.float64) @ W, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.kernel_wd(W, v), W.astype(np.float64) @ v, rtol=1e-5, atol=1e-5)
    assert model.butterfly(np.arange(32, dtype=np.float32)) == np.float32(496)


# ---------------------------------------------------------------------- (c)
ARGS = dict(num_clients=8, max_time=900, seed=0)


@pytest.fixture(scope="module")
def har_runs():
    """The reference's ``har`` run and the port's on the CPU with the reference's weights, the port's
    per-upload RNN calls recorded."""
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])).items()}
    ref_run = jax_run_experiment("har", "echopfl", **ARGS)
    calls = {"step": [], "sgd": 0, "want": 0}
    uploads = []
    step, sgd, want, handle = bc._rnn_step, bc._rnn_sgd, bc._rnn_want, EchoPFLServer.handle_upload

    def rec_step(params, pre, post, label, lr):
        calls["step"].append((label is not None, post is not None))
        return step(params, pre, post, label, lr)

    def rec_sgd(*a, **kw):
        calls["sgd"] += 1
        return sgd(*a, **kw)

    def rec_want(*a, **kw):
        calls["want"] += 1
        return want(*a, **kw)

    def rec_handle(self, client_id, *a, **kw):
        n0 = len(calls["step"])
        out = handle(self, client_id, *a, **kw)
        uploads.append(len(calls["step"]) - n0)
        return out

    bc._rnn_step, bc._rnn_sgd, bc._rnn_want, EchoPFLServer.handle_upload = rec_step, rec_sgd, rec_want, rec_handle
    try:
        port = run_experiment("har", "echopfl", device="cpu", init_params=init_np, rnn_params=rnn_np, **ARGS)
    finally:
        bc._rnn_step, bc._rnn_sgd, bc._rnn_want, EchoPFLServer.handle_upload = step, sgd, want, handle
    return ref_run, port, calls, uploads


def test_per_event_upload_is_one_rnn_step(har_runs):
    """Every per-event upload makes at most one ``rnn_step`` call, each call learns or decides (or both),
    and nothing goes through ``rnn_sgd`` or ``rnn_want``; the RNN decisions are the server's decisions
    less its fallback and inactive ones, the learns its uploads into a cluster with records."""
    (_, _, js, jr), (_, _, ts, tr), calls, uploads = har_runs
    assert calls["sgd"] == 0 and calls["want"] == 0
    assert len(uploads) == tr.extra["uploads"] and set(uploads) <= {0, 1}
    assert all(learn or decide for learn, decide in calls["step"])
    learns = sum(learn for learn, _ in calls["step"])
    decides = sum(decide for _, decide in calls["step"])
    both = sum(learn and decide for learn, decide in calls["step"])
    assert learns > 0 and decides > 0 and both > 0
    assert decides <= ts._decisions and learns <= tr.extra["uploads"]
    print(f"{tr.extra['uploads']} uploads, {len(calls['step'])} rnn_step calls: {learns} learn, {decides} decide, "
          f"{both} both; {ts._decisions} decisions")


def test_per_event_run_equals_the_reference(har_runs):
    (_, _, js, jr), (_, _, ts, tr), _, _ = har_runs
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        assert getattr(jr, name) == getattr(tr, name), name
    assert jr.up_series == tr.up_series and jr.down_series == tr.down_series
    assert js.events == ts.events
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    assert js.clustering.assignment == ts.clustering.assignment
    assert js._decisions == ts._decisions and js._rnn_broadcasts == ts._rnn_broadcasts
    assert {c: (p.decisions, p.broadcasts, p.active) for c, p in js.predictors.items()} == \
        {c: (p.decisions, p.broadcasts, p.active) for c, p in ts.predictors.items()}
