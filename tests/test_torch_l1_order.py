"""The summation order of the CUDA L1 kernels, modelled in numpy.

``csrc/l1_rows.cuh`` fixes one order for every L1 sum of the port's kernels
(``l1_distance``, ``l1_distance_pairwise``, ``pairwise_l1`` and the fused
``assign_and_lerp``): N is cut into 4096-element chunks; in a chunk, thread
t of 256 sums |x - c| over the groups of four elements at 4 t + 1024 j
(j < 4) in one fp32 register; the 32 lanes of a warp meet in an xor
butterfly, the 8 warps in a pairwise tree; the chunk partials meet in one
warp, lane l taking chunks l, l + 32, ... in order, then a butterfly.
:func:`kernel_l1` reproduces it in fp32 numpy, bit for bit, so these tests
show on the CPU what the kernels guarantee on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check the kernels
themselves):

- equal rows at any place and alignment in their matrix get equal sums
  (the kernels' first order, :func:`old_kernel_l1`, did not: a row that
  was not 16-byte aligned summed in another order);
- the order stays within rtol 1e-5 of the reference at the LM delta's
  width, N = 783,360;
- the chunking is a function of N alone, and the model's constants are
  the kernel source's.

``tests/test_torch_cuda.py`` holds the kernels' distances on the card to
:func:`kernel_l1` bit for bit, and the coalesced ingest chain
(``csrc/ingest_chain.cu``) to :func:`kernel_chain`, which strings those
sums into the chain's steps.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import l1
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
THREADS, STEPS, WARPS = 256, 4, 8
CHUNK = 4 * THREADS * STEPS


def butterfly(v: np.ndarray) -> np.ndarray:
    """Sum over the last axis (a power of two) by halving: the xor butterfly
    of ``warp_sum`` at lane 0, and ``warp_tree`` over 8 warp sums."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def kernel_l1(x: np.ndarray, c: np.ndarray) -> np.float32:
    """L1(x, c) in the order of ``csrc/l1_rows.cuh``, in fp32. Padding past
    N adds |0 - 0| = 0, which leaves a non-negative or NaN sum unchanged, as
    the kernel's zero loads do."""
    n = x.shape[0]
    chunks = l1.l1_chunks(n)
    d = np.zeros(chunks * CHUNK, np.float32)
    d[:n] = np.abs(x.astype(np.float32) - c.astype(np.float32))
    d = d.reshape(chunks, STEPS, THREADS, 4)
    acc = np.zeros((chunks, THREADS), np.float32)
    for j in range(STEPS):  # one register per thread: j-major, then the four elements
        for e in range(4):
            acc = acc + d[:, j, :, e]
    partial = butterfly(butterfly(acc.reshape(chunks, WARPS, 32)))  # lanes, then warps
    lanes = np.zeros(-(-chunks // 32) * 32, np.float32)
    lanes[:chunks] = partial
    per_lane = np.zeros(32, np.float32)
    for row in lanes.reshape(-1, 32):  # lane l: chunks l, l + 32, ... in order
        per_lane = per_lane + row
    return butterfly(per_lane)


def kernel_chain(U, centers, bcast, prev_idx, forced_idx, beta: float, margin: float = 0.1,
                 with_stats: bool = False):
    """The ingest chain in numpy, with every sum in :func:`kernel_l1`'s
    order: per step the distances to the carried rows, the first-index
    argmin (a NaN wins), the veto ``d[amin] > fl(fl(1 - margin) d[prev])``,
    the forced index, the two-op blend and the three statistics. Returns
    ``(cids, blended, dists, stats, carried)``; ``stats[j]`` is (change,
    gap_before, gap_after), and with ``with_stats`` also the post-blend
    center norm ``cnorm = L1(new, 0)`` in the same order, as the kernel's
    fourth statistic sums it."""
    U, cmat, bcast = (np.asarray(a, np.float32) for a in (U, centers, bcast))
    cmat = cmat.copy()
    S, C = U.shape[0], cmat.shape[0]
    omb, b, omm = np.float32(1.0 - beta), np.float32(beta), np.float32(1.0 - margin)
    cids = np.zeros(S, np.int32)
    blended = np.zeros_like(U)
    dists = np.zeros((S, C), np.float32)
    stats = np.zeros((S, 4 if with_stats else 3), np.float32)
    zero = np.zeros(U.shape[1], np.float32)
    for j in range(S):
        d = np.asarray([kernel_l1(U[j], r) for r in cmat], np.float32)
        amin = int(np.argmin(d))
        cid = amin
        if forced_idx[j] >= 0:
            cid = forced_idx[j]
        elif prev_idx[j] >= 0 and prev_idx[j] != amin and d[amin] > omm * d[prev_idx[j]]:
            cid = prev_idx[j]
        old = cmat[cid].copy()
        new = omb * old + b * U[j]
        cids[j], blended[j], dists[j] = cid, new, d
        stats[j, :3] = (kernel_l1(new, old), kernel_l1(old, bcast[cid]), kernel_l1(new, bcast[cid]))
        if with_stats:
            stats[j, 3] = kernel_l1(new, zero)
        cmat[cid] = new
    return cids, blended, dists, stats, cmat


def old_kernel_l1(buf: np.ndarray, offset: int, n: int) -> np.float32:
    """The first kernel's order for the row ``buf[offset:offset + n]`` of a
    gathered matrix against zeros: 16-byte aligned rows (offset % 4 == 0)
    summed float4 groups t, t + 256, ... per thread, any other row single
    elements t, t + 256, ...; then a block sum (butterfly per warp, then one
    warp over the 8 warp sums padded to 32)."""
    row = np.abs(buf[offset:offset + n]).astype(np.float32)
    acc = np.zeros(THREADS, np.float32)
    tail = 0
    if offset % 4 == 0:
        n4 = n // 4
        groups = np.zeros(-(-n4 // THREADS) * THREADS * 4, np.float32)
        groups[:n4 * 4] = row[:n4 * 4]
        for step in groups.reshape(-1, THREADS, 4):
            for e in range(4):
                acc = acc + step[:, e]
        tail = n4 * 4
    rest = np.zeros(-(-(n - tail) // THREADS) * THREADS, np.float32)
    rest[:n - tail] = row[tail:]
    for step in rest.reshape(-1, THREADS):
        acc = acc + step
    warps = np.zeros(32, np.float32)
    warps[:WARPS] = butterfly(acc.reshape(WARPS, 32))
    return butterfly(warps)


def test_kernel_constants_are_the_sources():
    common = (CSRC / "common.cuh").read_text()
    rows = (CSRC / "l1_rows.cuh").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", common).group(1) == str(THREADS)
    assert re.search(r"constexpr int kSteps = (\d+);", rows).group(1) == str(STEPS)
    assert "constexpr int64_t kChunk = 4 * kThreads * kSteps;" in rows
    assert l1.CHUNK == CHUNK


@pytest.mark.parametrize("n", [1, 3, 4, 4095, 4096, 4097, 25418, 783360, 5_000_000])
def test_chunk_count_is_a_function_of_n_alone(n):
    assert l1.l1_chunks(n) == -(-n // CHUNK)
    assert (l1.l1_chunks(n) - 1) * CHUNK < n <= l1.l1_chunks(n) * CHUNK


@pytest.mark.parametrize("n", [25418, 4550, 4099, 4097, 1, 6])
def test_equal_rows_at_any_offset_get_equal_sums(n):
    """A C = 5 gather with rows 1 and 2 equal: where N % 4 != 0 the two rows
    lie in different alignment classes. Their sums agree bit for bit in the
    kernels' order, whatever matrix, place or partner (the pair's sum is
    symmetric: fl(a - b) = -fl(b - a))."""
    rng = np.random.default_rng(n)
    u = rng.standard_normal(n).astype(np.float32)
    cs = rng.standard_normal((5, n)).astype(np.float32) + 5.0
    cs[1] = u + 0.5  # rows 1 and 2: equal and nearest
    cs[2] = cs[1]
    flat = cs.reshape(-1)  # the plane's gather: rows contiguous with stride N
    rows = [flat[r * n:(r + 1) * n] for r in range(5)]
    d = [kernel_l1(u, r) for r in rows]
    assert d[1].tobytes() == d[2].tobytes()
    assert kernel_l1(rows[2], u).tobytes() == d[1].tobytes()
    assert int(np.argmin(np.asarray(d))) == 1  # the tie goes to the first index


def test_the_first_order_depended_on_alignment():
    """The fault the fixed order repairs: at N % 4 = 2 every second row of a
    gather is 8-byte aligned and took the scalar path, so equal rows in the
    two classes could get different bits (and a tie could go to the later
    index). Several seeds, so one coincidence cannot hide it."""
    n = 25418
    differs = 0
    for seed in range(6):
        row = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        buf = np.concatenate([row, row, row])  # rows at offsets 0, n (8-byte aligned), 2n
        a, b = old_kernel_l1(buf, 0, n), old_kernel_l1(buf, n, n)
        differs += a.tobytes() != b.tobytes()
        z = np.zeros(n, np.float32)
        assert kernel_l1(buf[:n], z).tobytes() == kernel_l1(buf[n:2 * n], z).tobytes()
    assert differs > 0


@pytest.mark.parametrize("c,n", [(4, 783360), (5, 25418), (3, 4099), (2, 4097), (8, 1)])
def test_order_within_rtol_of_the_reference(c, n):
    """The kernels' order against the reference's ``l1_distance_ref`` (XLA's
    sum) and an fp64 sum: rtol 1e-5, as the kernels are held on the card.
    (JAX is imported here: ``tests/test_torch_cuda.py`` takes :func:`kernel_l1`
    from this module on a machine without it.)"""
    import jax.numpy as jnp

    from repro.kernels import ref

    rng = np.random.default_rng(c * 1000 + n)
    u = rng.standard_normal(n).astype(np.float32)
    cs = rng.standard_normal((c, n)).astype(np.float32)
    got = np.asarray([kernel_l1(u, r) for r in cs], np.float32)
    want = np.asarray(ref.l1_distance_ref(jnp.asarray(u), jnp.asarray(cs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    exact = np.abs(cs.astype(np.float64) - u.astype(np.float64)).sum(axis=1)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=0)


def test_nan_propagates_to_the_sum():
    u = np.ones(5000, np.float32)
    c = np.zeros(5000, np.float32)
    c[4500] = np.nan  # in the second chunk
    assert np.isnan(kernel_l1(u, c))
    assert kernel_l1(u, np.zeros(5000, np.float32)) == np.float32(5000)


@pytest.mark.parametrize("n,c,s", [(4099, 3, 6), (8193, 5, 4), (300, 1, 3)])
def test_kernel_chain_norm_is_the_fourth_statistic(n, c, s):
    """``with_stats`` adds ``cnorm = L1(new, 0)`` in the kernel's order as a
    fourth column and changes nothing else; the norm is that of each
    step's blended row, within rtol 1e-5 of a float64 sum."""
    rng = np.random.default_rng(n + c + s)
    U = rng.standard_normal((s, n)).astype(np.float32)
    centers = rng.standard_normal((c, n)).astype(np.float32)
    bcast = centers + np.float32(0.1)
    prev, forced = [-1] * s, [-1] * s
    plain = kernel_chain(U, centers, bcast, prev, forced, 0.25)
    with_norm = kernel_chain(U, centers, bcast, prev, forced, 0.25, with_stats=True)
    assert with_norm[3].shape == (s, 4)
    for a, b in zip(plain[:3] + plain[4:], with_norm[:3] + with_norm[4:]):
        assert a.tobytes() == b.tobytes()
    assert with_norm[3][:, :3].tobytes() == plain[3].tobytes()
    zero = np.zeros(n, np.float32)
    for j in range(s):
        assert with_norm[3][j, 3].tobytes() == kernel_l1(with_norm[1][j], zero).tobytes()
    exact = np.abs(with_norm[1].astype(np.float64)).sum(axis=1)
    np.testing.assert_allclose(with_norm[3][:, 3], exact, rtol=1e-5, atol=0)
