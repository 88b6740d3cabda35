"""The port's coalesced ingest chain (``kernels/ingest_chain.py``) on the CPU.

``ingest_chain`` on CPU tensors takes :func:`ingest_chain_plain`. It is
held to three things on the same numpy-seeded inputs:

- the reference's ``ops.ingest_chain`` (its CPU route), called as the
  reference's server calls it, with S and C padded to powers of two, and
  with exact shapes: identical cids, each step's blend within 1 ulp of the
  port's blend of the same inputs (the reference's chain contracts its
  blend into an FMA on this jax; the port pins the two-op form), whole
  rows within rtol 1e-5, the statistics within rtol 2e-6;
- S sequential per-event port steps (``assign_and_lerp``, the host's veto,
  ``lerp_vec`` or the fused blend, ``l1_vec``): bit for bit;
- the numpy model of the card kernel's order (``kernel_chain``): identical
  cids, blended rows bit for bit, distances and statistics within rtol 1e-5.

``with_stats=True`` (the ingest guard's post-blend center norm) changes no
other output by a bit and adds ``cnorm = torch.sum(torch.abs(c_new))`` as
a fourth statistic in the same buffer: within rtol 2e-6 of the
reference's ``ops.ingest_chain(..., with_stats=True)`` with identical
cids, within rtol 1e-5 of the order model's; a NaN upload gives a NaN norm.

Cases: N = 256, 4,099 and 8,193 (three chunks of the card kernel, the
last one ragged), C = 1, 3, 4, 5 and 9 (a partial tile of four rows), S = 1,
8, 13, with first uploads (prev -1), vetoed switches, forced (pinned) ids,
repeated winners, and an upload holding a NaN. ``ingest_chain`` never
writes ``centers``: the carried matrix comes back in a buffer of its own.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.core.plane import l1_vec, lerp_vec
from repro_torch.kernels import ops
from repro_torch.kernels.assign_lerp import blend_plain
from repro_torch.kernels.ingest_chain import ingest_chain_plain
from test_torch_l1_order import kernel_chain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

BETA, MARGIN = 0.25, 0.1
CASES = [(n, c, s) for n in (256, 4099, 8193) for c in (1, 3, 4, 5, 9) for s in (1, 8, 13)]


def _inputs(n, c, s, seed=0, nan_step=None):
    """Centers, anchors and S uploads with prev and forced ids drawn per
    step: a third of the uploads near a random center (switches and
    repeated winners), a third midway between the client's previous center
    and another (vetoes), a third noise."""
    rng = np.random.default_rng(seed * 7919 + n * 31 + c * 7 + s)
    centers = rng.standard_normal((c, n)).astype(np.float32)
    bcast = (centers + 0.3 * rng.standard_normal((c, n))).astype(np.float32)
    U = rng.standard_normal((s, n)).astype(np.float32)
    prev = [int(p) if rng.uniform() < 0.7 else -1 for p in rng.integers(0, c, s)]
    forced = [int(p) if rng.uniform() < 0.2 else -1 for p in rng.integers(0, c, s)]
    if s > 2:
        prev[0], forced[0] = -1, -1  # a client's first upload
    kind, pick = rng.integers(0, 3, s), rng.integers(0, c, s)
    for j in range(s):
        if kind[j] == 0:
            U[j] = centers[pick[j]] + 0.2 * U[j]
        elif kind[j] == 1 and prev[j] >= 0:
            U[j] = 0.5 * (centers[prev[j]] + centers[pick[j]]) + 0.05 * U[j]
    if nan_step is not None:
        U[nan_step, n // 3] = np.nan
    return U, centers, bcast, prev, forced


def _port(U, centers, bcast, prev, forced):
    out = ops.ingest_chain(torch.from_numpy(U), torch.from_numpy(centers), torch.from_numpy(bcast), prev, forced,
                           beta=BETA, switch_margin=MARGIN)
    return out.cids.numpy(), out.blended.numpy(), out.stats.numpy(), out


def _reference(U, centers, bcast, prev, forced, padded: bool):
    S, C = len(U), len(centers)
    valid = [True] * S
    num_centers = None
    if padded:  # as the reference's server calls it
        P, Cp = 1 << (S - 1).bit_length(), 1 << (C - 1).bit_length()
        U = np.concatenate([U, np.broadcast_to(U[:1], (P - S, U.shape[1]))])
        prev, forced, valid = prev + [-1] * (P - S), forced + [-1] * (P - S), valid + [False] * (P - S)
        zpad = np.zeros((Cp - C, centers.shape[1]), np.float32)
        centers, bcast = np.concatenate([centers, zpad]), np.concatenate([bcast, zpad])
        num_centers = C
    cids, blended, change, gb, ga = jax_ops.ingest_chain(
        jnp.asarray(U), jnp.asarray(centers), jnp.asarray(bcast), prev, forced, valid,
        beta=BETA, switch_margin=MARGIN, num_centers=num_centers,
    )
    stats = np.stack([np.asarray(change), np.asarray(gb), np.asarray(ga)], axis=1)[:S]
    return np.asarray(cids)[:S], np.asarray(blended)[:S], stats


def _blends_within_one_ulp(U, centers, cids, r_blended):
    """Each reference step's blend against the port's two-op blend of the
    same inputs (the reference's own carried row): within one ulp of the
    larger input, elementwise, NaN at the same places. The trajectories
    themselves drift apart by such ulps where a center wins repeatedly."""
    cmat = centers.copy()
    for j, cid in enumerate(cids):
        old = cmat[cid]
        mine = blend_plain(torch.from_numpy(old), torch.from_numpy(U[j]), BETA).numpy()
        want = r_blended[j]
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(mine), nan)
        scale = np.maximum(np.abs(old), np.abs(U[j]))[~nan]
        assert (np.abs(mine[~nan] - want[~nan]) <= np.spacing(scale)).all(), j
        cmat[cid] = want


@pytest.mark.parametrize("n,c,s", CASES)
def test_plain_matches_the_reference_padded_and_exact(n, c, s):
    U, centers, bcast, prev, forced = _inputs(n, c, s)
    cids, blended, stats, _ = _port(U, centers, bcast, prev, forced)
    for padded in (True, False):
        r_cids, r_blended, r_stats = _reference(U, centers, bcast, prev, forced, padded)
        np.testing.assert_array_equal(cids, r_cids)
        _blends_within_one_ulp(U, centers, r_cids, r_blended)
        np.testing.assert_allclose(blended, r_blended, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats, r_stats, rtol=2e-6, atol=0)


@pytest.mark.parametrize("n,c,s", CASES)
def test_plain_is_sequential_port_steps_bitwise(n, c, s):
    """Each step as ``DynamicClustering.assign`` and ``aggregate`` take it:
    the fused assign's blend when its argmin stands, else ``lerp_vec`` of
    the vetoed or pinned row; the statistics as ``handle_upload`` reads
    them."""
    U, centers, bcast, prev, forced = _inputs(n, c, s, seed=1)
    cids, blended, stats, out = _port(U, centers, bcast, prev, forced)
    cmat, B = torch.from_numpy(centers.copy()), torch.from_numpy(bcast)
    for j in range(s):
        u = torch.from_numpy(U[j])
        d_t, _, fused = ops.assign_and_lerp(u, cmat, BETA)
        d = d_t.numpy()
        amin = int(np.argmin(d))
        cid = amin
        if forced[j] >= 0:
            cid = forced[j]
        elif prev[j] >= 0 and prev[j] != amin and d[amin] > (1.0 - MARGIN) * d[prev[j]]:
            cid = prev[j]
        assert cids[j] == cid, j
        old = cmat[cid].clone()
        new = fused if cid == amin and forced[j] < 0 else lerp_vec(old, u, BETA)
        assert np.array_equal(blended[j].view(np.int32), new.numpy().view(np.int32)), j
        want = [l1_vec(new, old), l1_vec(old, B[cid]), l1_vec(new, B[cid])]
        assert stats[j].tobytes() == np.asarray([float(w) for w in want], np.float32).tobytes(), j
        assert out.dists[j].numpy().tobytes() == d.tobytes()
        cmat[cid] = new
    assert torch.equal(out.carried, cmat)


@pytest.mark.parametrize("n,c,s", CASES)
def test_plain_matches_the_kernel_order_model(n, c, s):
    U, centers, bcast, prev, forced = _inputs(n, c, s, seed=2)
    cids, blended, stats, out = _port(U, centers, bcast, prev, forced)
    m_cids, m_blended, m_dists, m_stats, m_carried = kernel_chain(U, centers, bcast, prev, forced, BETA, MARGIN)
    np.testing.assert_array_equal(cids, m_cids)
    assert blended.tobytes() == m_blended.tobytes()
    assert out.carried.numpy().tobytes() == m_carried.tobytes()
    np.testing.assert_allclose(out.dists.numpy(), m_dists, rtol=1e-5, atol=0)
    np.testing.assert_allclose(stats, m_stats, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [256, 4099])
def test_nan_upload_goes_to_the_first_center(n):
    """A NaN in an upload makes every distance NaN: the first index wins
    (no veto can hold, the comparison is false), and the NaN spreads into
    that center and every later step's distances to it."""
    U, centers, bcast, prev, forced = _inputs(n, 4, 8, seed=3, nan_step=2)
    forced[2] = -1
    cids, blended, stats, out = _port(U, centers, bcast, prev, forced)
    assert cids[2] == 0 and np.isnan(out.dists[2].numpy()).all()
    assert np.isnan(stats[2, [0, 2]]).all() and np.isfinite(stats[2, 1])  # gap_before reads the old row
    r_cids, r_blended, r_stats = _reference(U, centers, bcast, prev, forced, padded=True)
    np.testing.assert_array_equal(cids, r_cids)
    _blends_within_one_ulp(U, centers, r_cids, r_blended)
    np.testing.assert_array_equal(np.isnan(stats), np.isnan(r_stats))
    m_cids, m_blended, _, m_stats, _ = kernel_chain(U, centers, bcast, prev, forced, BETA, MARGIN)
    np.testing.assert_array_equal(cids, m_cids)
    np.testing.assert_array_equal(np.isnan(blended), np.isnan(m_blended))
    ok = ~np.isnan(m_blended)
    assert blended[ok].tobytes() == m_blended[ok].tobytes()
    np.testing.assert_array_equal(np.isnan(stats), np.isnan(m_stats))


def test_the_cases_hold_vetoes_switches_and_pins():
    """Across the parametrized inputs, steps of every kind occur."""
    vetoes = switches = pinned = 0
    for n, c, s in CASES:
        U, centers, bcast, prev, forced = _inputs(n, c, s)
        cids, _, _, out = _port(U, centers, bcast, prev, forced)
        amin = out.dists.numpy().argmin(axis=1)
        for j in range(s):
            pinned += forced[j] >= 0
            vetoes += forced[j] < 0 and cids[j] != amin[j]
            switches += forced[j] < 0 and prev[j] >= 0 and cids[j] != prev[j]
    assert vetoes >= 5 and switches >= 10 and pinned >= 10, (vetoes, switches, pinned)


def test_veto_switch_forced_and_repeated_winner():
    """Rows that differ from one base by a constant: L1 is N times the gap.
    Centers at +1.0, +0.05, +3.0. Step 0 (no previous cluster) goes to 1;
    step 1 (+0.52, was in 1) is nearest 0 but not 10% closer: vetoed, stays
    in 1; step 2 (+0.9, was in 1) is decisively closer to 0: switches;
    step 3 is pinned to 2; steps 4-5 win 1 again, each against the row the
    step before blended."""
    n = 300
    base = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    centers = np.stack([base + 1.0, base + 0.05, base + 3.0]).astype(np.float32)
    U = np.stack([base + a for a in (0.0, 0.52, 0.9, 0.0, 0.1, 0.1)]).astype(np.float32)
    prev, forced = [-1, 1, 1, -1, -1, 1], [-1, -1, -1, 2, -1, -1]
    want = [1, 1, 0, 2, 1, 1]
    cids, _, _, out = _port(U, centers, centers.copy(), prev, forced)
    assert list(cids) == want
    assert int(np.argmin(out.dists[1].numpy())) == 0  # step 1 was a veto
    assert list(_reference(U, centers, centers.copy(), prev, forced, padded=True)[0]) == want
    assert list(kernel_chain(U, centers, centers, prev, forced, BETA, MARGIN)[0]) == want


def test_chain_leaves_its_inputs_and_counts_no_launch_on_the_cpu():
    U, centers, bcast, prev, forced = _inputs(64, 3, 5, seed=4)
    c_t = torch.from_numpy(centers.copy())
    ops.reset_launch_counts()
    ops.ingest_chain(torch.from_numpy(U), c_t, torch.from_numpy(bcast), prev, forced, beta=BETA)
    assert np.array_equal(c_t.numpy(), centers)
    assert ops.launch_counts()["ingest_chain"] == 0


@pytest.mark.parametrize("n,c,s", [(64, 3, 5), (8193, 5, 12)])
def test_chain_returns_the_carried_matrix_in_a_buffer_of_its_own(n, c, s):
    """``centers`` is only read: its values stay, and no output shares its
    storage (the card kernel writes the carried matrix into a buffer of its
    own, never into the gathered centers)."""
    U, centers, bcast, prev, forced = _inputs(n, c, s, seed=6)
    c_t = torch.from_numpy(centers.copy())
    out = ops.ingest_chain(torch.from_numpy(U), c_t, torch.from_numpy(bcast), prev, forced, beta=BETA)
    assert np.array_equal(c_t.numpy(), centers)
    storage = c_t.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() != storage for t in (out.carried, out.buf))
    assert out.carried.shape == (c, n) and not np.array_equal(out.carried.numpy(), centers)


def _block(text: str, head: str) -> str:
    """The braced block that follows ``head`` in C++ source."""
    start = text.index("{", text.index(head))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise ValueError(f"unbalanced braces after {head!r}")


def test_the_kernel_has_one_grid_barrier_a_step():
    """``ingest_chain_kernel`` syncs the grid once inside its step loop
    (after the distance partials) and once after it (before the
    statistics): S + 1 barriers a launch."""
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/ingest_chain.cu").read_text()
    kernel = _block(src, "ingest_chain_kernel(")
    loop = _block(kernel, "for (int64_t j = 0; j < steps; ++j)")
    assert loop.count("grid.sync()") == 1
    assert kernel.count("grid.sync()") == 2


def test_chain_rejects_what_it_does_not_take():
    U, centers, bcast, prev, forced = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                       for a in _inputs(16, 2, 3, seed=5))
    with pytest.raises(ValueError, match="index"):
        ops.ingest_chain(U, centers, bcast, [2, -1, -1], forced, beta=BETA)
    with pytest.raises(ValueError, match="one entry per upload"):
        ops.ingest_chain(U, centers, bcast, prev[:2], forced, beta=BETA)
    with pytest.raises(TypeError):
        ops.ingest_chain(U.double(), centers, bcast, prev, forced, beta=BETA)
    with pytest.raises(ValueError, match="index"):
        ops.ingest_chain(U, centers, bcast, prev, [-1, 2, -1], beta=BETA, with_stats=True)
    host = ingest_chain_plain(U, centers, bcast, prev, forced, BETA).host()
    assert host[0].dtype == np.int32 and host[1].shape == (3, 16) and host[2].shape == (3, 3)
    host = ingest_chain_plain(U, centers, bcast, prev, forced, BETA, with_stats=True).host()
    assert host[0].dtype == np.int32 and host[1].shape == (3, 16) and host[2].shape == (3, 4)


STATS_CASES = [(n, c, s) for n in (256, 4099) for c in (1, 4, 9) for s in (1, 8, 13)]


@pytest.mark.parametrize("n,c,s", STATS_CASES)
def test_with_stats_changes_no_other_output(n, c, s):
    U, centers, bcast, prev, forced = _inputs(n, c, s, seed=7)
    _, _, _, off = _port(U, centers, bcast, prev, forced)
    on = ops.ingest_chain(torch.from_numpy(U), torch.from_numpy(centers), torch.from_numpy(bcast), prev, forced,
                          beta=BETA, switch_margin=MARGIN, with_stats=True)
    assert off.cnorm is None and on.stats.shape == (s, 4) and on.cnorm.shape == (s,)
    for a, b in ((off.cids, on.cids), (off.blended, on.blended), (off.dists, on.dists), (off.carried, on.carried),
                 (off.stats, on.stats[:, :3])):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    want = np.asarray([float(torch.sum(torch.abs(on.blended[j]))) for j in range(s)], np.float32)
    assert on.cnorm.numpy().tobytes() == want.tobytes()
    cids, blended, stats = on.host()
    assert stats.shape == (s, 4) and stats.tobytes() == on.stats.numpy().tobytes()
    assert np.array_equal(cids, on.cids.numpy()) and blended.tobytes() == on.blended.numpy().tobytes()


def _reference_with_stats(U, centers, bcast, prev, forced):
    """The reference's chain with its norm, called as its server calls it
    (S and C padded to powers of two)."""
    S, C = len(U), len(centers)
    P, Cp = 1 << (S - 1).bit_length(), 1 << (C - 1).bit_length()
    Up = np.concatenate([U, np.broadcast_to(U[:1], (P - S, U.shape[1]))])
    zpad = np.zeros((Cp - C, centers.shape[1]), np.float32)
    outs = jax_ops.ingest_chain(
        jnp.asarray(Up), jnp.asarray(np.concatenate([centers, zpad])), jnp.asarray(np.concatenate([bcast, zpad])),
        prev + [-1] * (P - S), forced + [-1] * (P - S), [True] * S + [False] * (P - S),
        beta=BETA, switch_margin=MARGIN, num_centers=C, with_stats=True,
    )
    assert len(outs) == 6
    return np.asarray(outs[0])[:S], np.asarray(outs[5])[:S]


@pytest.mark.parametrize("n,c,s", STATS_CASES)
def test_norm_matches_the_reference_and_the_order_model(n, c, s):
    U, centers, bcast, prev, forced = _inputs(n, c, s, seed=8)
    on = ops.ingest_chain(torch.from_numpy(U), torch.from_numpy(centers), torch.from_numpy(bcast), prev, forced,
                          beta=BETA, switch_margin=MARGIN, with_stats=True)
    r_cids, r_cnorm = _reference_with_stats(U, centers, bcast, prev, forced)
    np.testing.assert_array_equal(on.cids.numpy(), r_cids)
    np.testing.assert_allclose(on.cnorm.numpy(), r_cnorm, rtol=2e-6, atol=0)
    m_cids, _, _, m_stats, _ = kernel_chain(U, centers, bcast, prev, forced, BETA, MARGIN, with_stats=True)
    np.testing.assert_array_equal(on.cids.numpy(), m_cids)
    np.testing.assert_allclose(on.stats.numpy(), m_stats, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [256, 4099])
def test_nan_upload_gives_a_nan_norm(n):
    """A NaN upload blends NaN into the first center: its step's norm is
    NaN, as is every later norm of that center, in the port, the
    reference and the order model alike."""
    U, centers, bcast, prev, forced = _inputs(n, 4, 8, seed=3, nan_step=2)
    forced[2] = -1
    on = ops.ingest_chain(torch.from_numpy(U), torch.from_numpy(centers), torch.from_numpy(bcast), prev, forced,
                          beta=BETA, switch_margin=MARGIN, with_stats=True)
    cn = on.cnorm.numpy()
    assert np.isnan(cn[2])
    nan_rows = np.isnan(on.blended.numpy()).any(axis=1)
    np.testing.assert_array_equal(np.isnan(cn), nan_rows)
    _, r_cnorm = _reference_with_stats(U, centers, bcast, prev, forced)
    np.testing.assert_array_equal(np.isnan(cn), np.isnan(r_cnorm))
    m_stats = kernel_chain(U, centers, bcast, prev, forced, BETA, MARGIN, with_stats=True)[3]
    np.testing.assert_array_equal(np.isnan(cn), np.isnan(m_stats[:, 3]))
