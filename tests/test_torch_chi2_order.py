"""The summation order of the CUDA chi-squared kernel, modelled in numpy.

``csrc/chi2.cu`` computes both entry points (``chi2_feedback`` is the
segmented form with no segments) in one launch, in one fixed order:

- J <= 32: one thread per row sums, for j = 0 .. J-1 in order, chi2 +=
  (fp - ft)^2 / max(ft, 1e-6) and sum += s; mean = sum / J; then var +=
  (s - mean)^2; g = chi2 * (var / J). Every step is one fp32 operation
  rounded to nearest: nothing is contracted into an FMA.
- J > 32: lane l of a warp sums elements l, l + 32, ... in that order, and
  the 32 lanes meet in an xor butterfly (offsets 16, 8, 4, 2, 1).
- Segment sums: rows come in tiles of 256 rows (J <= 32) or 8 (J > 32);
  the grid is min(8, tiles) blocks (one cluster) and block b takes tiles
  b, b + blocks, ...; in each tile, lane l of the warp that takes segment
  s sums the g of the tile's rows l, l + 32, ... with id s in row order
  from 0, the lanes meet in the butterfly, the block adds its tiles' sums
  in tile order, and block rank 0 adds the blocks' partials in rank order.
  Rows whose id is not in [0, S) join no segment.

:func:`kernel_chi2` reproduces this in fp32 numpy, bit for bit. Here it is
held against the plain version and the reference's Pallas kernels (in
interpret mode); ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernel's bits on the card to it. JAX is imported only inside the tests that
use it: the card tests import this module on a machine without JAX.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import chi2
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
THREADS, CLUSTER, MAX_THREAD_J = 256, 8, 32
WARPS = THREADS // 32
EPS = np.float32(1e-6)


def butterfly(v: np.ndarray) -> np.ndarray:
    """Sum over the last axis (32 lanes) by halving: the xor butterfly's
    result, which every lane holds (addition commutes)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lane_sums(v: np.ndarray) -> np.ndarray:
    """(M, J) -> (M,): lane l sums columns l, l + 32, ... in order, then the
    butterfly. Lanes past J add zeros, which leave a sum that starts at +0
    unchanged, as the kernel's loop that stops at J does."""
    m, j = v.shape
    padded = np.zeros((m, -(-j // 32) * 32), np.float32)
    padded[:, :j] = v
    acc = np.zeros((m, 32), np.float32)
    for c in range(padded.shape[1] // 32):
        acc = acc + padded[:, 32 * c:32 * (c + 1)]
    return butterfly(acc)


def kernel_g(fp: np.ndarray, ft: np.ndarray, ss: np.ndarray) -> np.ndarray:
    """(M, J) x3 -> (M,) g in the kernel's order, in fp32. ``np.fmax`` is
    CUDA's ``fmaxf`` (a NaN loses to 1e-6)."""
    fp, ft, ss = (np.asarray(a, np.float32) for a in (fp, ft, ss))
    m, j = fp.shape
    jf = np.float32(j)
    with np.errstate(all="ignore"):
        d = fp - ft
        term = (d * d) / np.fmax(ft, EPS)
        if j <= MAX_THREAD_J:
            chi, total = np.zeros(m, np.float32), np.zeros(m, np.float32)
            for k in range(j):
                chi = chi + term[:, k]
                total = total + ss[:, k]
            mean = total / jf
            var = np.zeros(m, np.float32)
            for k in range(j):
                e = ss[:, k] - mean
                var = var + e * e
        else:
            chi = _lane_sums(term)
            mean = _lane_sums(ss) / jf
            e = ss - mean[:, None]
            var = _lane_sums(e * e)
        return chi * (var / jf)


def kernel_segment_sums(g: np.ndarray, seg: np.ndarray, s: int, j: int) -> np.ndarray:
    """(S,) sums of g per segment id in the kernel's order: within a tile
    lane-strided rows, then the butterfly; tiles in order within a block;
    blocks in rank order. Unmatched rows add +0, which leaves a lane's sum
    (never -0) unchanged, as the kernel's skipped add does."""
    m = g.shape[0]
    t = THREADS if j <= MAX_THREAD_J else WARPS
    tiles = -(-m // t)
    blocks = max(1, min(CLUSTER, tiles))
    part = np.zeros((blocks, s), np.float32)
    ids = np.arange(s)
    for tile in range(tiles):
        rows = slice(tile * t, min(m, (tile + 1) * t))
        n = rows.stop - rows.start
        gt = np.zeros(-(-n // 32) * 32, np.float32)
        st = np.full(gt.shape, -1)
        gt[:n], st[:n] = g[rows], seg[rows]
        lanes = np.zeros((s, 32), np.float32)
        for gc, sc in zip(gt.reshape(-1, 32), st.reshape(-1, 32)):  # lane l: rows l, l + 32, ...
            lanes = lanes + np.where(sc[None, :] == ids[:, None], gc[None, :], np.float32(0))
        part[tile % blocks] += butterfly(lanes)
    total = part[0].copy()
    for b in range(1, blocks):
        total += part[b]
    return total


def kernel_chi2(fp, ft, ss, seg=None, s: int = 0):
    """(g (M,), seg_sum (S,)) as the kernel writes them."""
    g = kernel_g(fp, ft, ss)
    seg = np.zeros(g.shape[0], np.int32) if seg is None else np.asarray(seg)
    return g, kernel_segment_sums(g, seg, s, np.shape(fp)[1])


def feedback(rng, m, j):
    """The server's kind of inputs: predicted and true class counts, a softmax."""
    f_pred = (rng.uniform(size=(m, j)) * 100).astype(np.float32)
    f_true = (rng.uniform(size=(m, j)) * 100 + 1.0).astype(np.float32)
    z = rng.standard_normal((m, j))
    s_soft = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return f_pred, f_true, s_soft


def test_kernel_constants_are_the_sources():
    src = (CSRC / "chi2.cu").read_text()
    common = (CSRC / "common.cuh").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", common).group(1) == str(THREADS)
    assert "constexpr int kRows = repro::kThreads;" in src
    assert "constexpr int kWarps = repro::kThreads / 32;" in src
    assert re.search(r"constexpr int kMaxThreadJ = (\d+);", src).group(1) == str(MAX_THREAD_J)
    assert re.search(r"constexpr int kCluster = (\d+);", src).group(1) == str(CLUSTER)
    assert int(re.search(r"constexpr int kMaxSmem = (\d+);", src).group(1)) == chi2.MAX_SMEM
    assert (chi2.ROWS, chi2.WARPS, chi2.MAX_THREAD_J) == (THREADS, WARPS, MAX_THREAD_J)
    # the wrapper's shared-memory sum is the kernel's
    assert "const int64_t staged = j <= kMaxThreadJ ? 3 * cap * (j | 1) : 0;" in src
    assert "return 4 * (staged + 2 * cap + s);" in src
    # no contraction: every operation of the sums is an explicit round-to-nearest one
    body = src[src.index("chi2_term"):src.index("int launch(")]
    assert not re.search(r"[^_]\b(chi|sum|var|acc|total)\s*\+=", body)


@pytest.mark.parametrize("m,j,s,want", [
    (4, 10, 0, 4 * (3 * 4 * 11 + 8)), (20, 10, 4, 4 * (3 * 20 * 11 + 40 + 4)),
    (2049, 16, 300, 4 * (3 * 256 * 17 + 512 + 300)), (5, 200, 3, 4 * (10 + 3)), (2049, 200, 9, 4 * (16 + 9)), (0, 10, 7, 28),
])
def test_shared_memory_sum(m, j, s, want):
    assert chi2.smem_bytes(m, j, s) == want


def test_segments_beyond_shared_memory_are_refused_on_the_card_only():
    """The widest J a thread takes at the full tile leaves room for some
    32,000 segments; the check is the kernel's, so the CPU's plain version
    still takes any S."""
    s_max = (chi2.MAX_SMEM - chi2.smem_bytes(300, 32, 0)) // 4
    assert s_max > 30_000
    assert chi2.smem_bytes(300, 32, s_max) <= chi2.MAX_SMEM < chi2.smem_bytes(300, 32, s_max + 1)
    fp, ft, ss = (torch.from_numpy(a) for a in feedback(np.random.default_rng(0), 3, 4))
    g, seg_sum = chi2.chi2_feedback_segmented(fp, ft, ss, torch.zeros(3, dtype=torch.int32), s_max + 1)
    assert seg_sum.shape == (s_max + 1,) and float(seg_sum[0]) == pytest.approx(float(g.sum()), rel=1e-6)


@pytest.mark.parametrize("m,j", [(1, 10), (7, 6), (300, 9), (64, 2), (5, 200)])
def test_model_matches_plain_and_pallas(m, j):
    """The order stays within rtol 1e-5 / atol 1e-6 of the plain version and
    of the reference's Pallas kernel (interpret mode) at the shapes the
    kernel tests use, on both the thread-row (J <= 32) and warp paths."""
    import jax.numpy as jnp

    from repro.kernels.chi2_feedback import chi2_feedback as pallas_chi2

    fp, ft, ss = feedback(np.random.default_rng(m * 31 + j), m, j)
    got = kernel_g(fp, ft, ss)
    plain = chi2.chi2_feedback_plain(*(torch.from_numpy(a) for a in (fp, ft, ss))).numpy()
    want = np.asarray(pallas_chi2(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss), interpret=True))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "sizes", [[1], [3, 1, 7], [5, 5], [2, 1, 1, 9, 4], [200, 250, 150]],
    ids=["single-member", "ragged", "even", "very-ragged", "crosses-blocks"],
)
def test_segmented_model_matches_plain_and_pallas(sizes):
    import jax.numpy as jnp

    from repro.kernels.chi2_feedback import chi2_feedback_segmented as pallas_chi2_seg

    m, s = sum(sizes), len(sizes)
    fp, ft, ss = feedback(np.random.default_rng(m), m, 6)
    seg = np.repeat(np.arange(s), sizes).astype(np.int32)
    g, seg_sum = kernel_chi2(fp, ft, ss, seg, s)
    gp, sp = chi2.chi2_feedback_segmented_plain(*(torch.from_numpy(a) for a in (fp, ft, ss, seg)), s)
    onehot = (seg[:, None] == np.arange(s)[None, :]).astype(np.float32)
    gk, sk = pallas_chi2_seg(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss), jnp.asarray(onehot),
                             interpret=True)
    for want_g, want_s in ((gp.numpy(), sp.numpy()), (np.asarray(gk), np.asarray(sk))):
        np.testing.assert_allclose(g, want_g, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(seg_sum, want_s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,j,s", [(2049, 10, 300), (2049, 2, 1), (300, 16, 4), (20, 200, 4), (1, 1, 1)])
def test_segment_sums_across_tiles_and_blocks(m, j, s):
    """Past one tile (M = 2049 is nine 256-row tiles over an 8-block
    cluster, so block 0 takes tiles 0 and 8) the sums stay within fp32
    rounding of exact ones; ids -1 and S join nothing; g does not depend on
    the segments."""
    rng = np.random.default_rng(m + j + s)
    fp, ft, ss = feedback(rng, m, j)
    seg = rng.integers(-1, s + 1, m).astype(np.int32)  # s itself: out of range, joins nothing
    g, seg_sum = kernel_chi2(fp, ft, ss, seg, s)
    assert g.tobytes() == kernel_g(fp, ft, ss).tobytes()
    exact = np.asarray([g[seg == k].astype(np.float64).sum() for k in range(s)])
    np.testing.assert_allclose(seg_sum, exact, rtol=1e-5, atol=1e-5)


def test_empty_inputs():
    z = np.zeros((0, 10), np.float32)
    g, seg_sum = kernel_chi2(z, z, z, np.zeros(0, np.int32), 5)
    assert g.shape == (0,) and seg_sum.tolist() == [0.0] * 5
    g, seg_sum = kernel_chi2(*feedback(np.random.default_rng(1), 3, 4))
    assert g.shape == (3,) and seg_sum.shape == (0,)


def test_equal_rows_get_equal_bits_at_any_place():
    """A row's g depends on its values and J alone: not on M, its place or
    its tile."""
    fp, ft, ss = feedback(np.random.default_rng(5), 600, 10)
    for a in (fp, ft, ss):
        a[517] = a[3]
    g = kernel_g(fp, ft, ss)
    assert g[517].tobytes() == g[3].tobytes()
    assert kernel_g(fp[3:4], ft[3:4], ss[3:4]).tobytes() == g[3].tobytes()


def test_the_two_paths_are_two_orders():
    """At J = 33 the warp path's lane-strided order and the thread path's
    sequential one (as if a thread took the row) differ in bits for some
    rows, so the J limit is part of the order and the model must follow it."""
    fp, ft, ss = feedback(np.random.default_rng(33), 256, 33)
    warp = kernel_g(fp, ft, ss)
    jf, d = np.float32(33), fp - ft
    term = (d * d) / np.fmax(ft, EPS)
    chi, total, var = (np.zeros(256, np.float32) for _ in range(3))
    for k in range(33):
        chi, total = chi + term[:, k], total + ss[:, k]
    mean = total / jf
    for k in range(33):
        var = var + (ss[:, k] - mean) * (ss[:, k] - mean)
    seq = chi * (var / jf)
    assert (warp.view(np.int32) != seq.view(np.int32)).any()
    np.testing.assert_allclose(warp, seq, rtol=1e-5)


def test_an_fma_would_change_the_bits():
    """What the kernel's round-to-nearest intrinsics rule out: contracting
    var += d * d into one fused multiply-add (one rounding, modelled in
    fp64) gives other bits for some rows at the server's J = 10."""
    fp, ft, ss = feedback(np.random.default_rng(10), 512, 10)
    g = kernel_g(fp, ft, ss)
    jf = np.float32(10)
    total = np.zeros(512, np.float32)
    for k in range(10):
        total = total + ss[:, k]
    mean = total / jf
    chi = np.zeros(512, np.float32)
    d = fp - ft
    term = (d * d) / np.fmax(ft, EPS)
    for k in range(10):
        chi = chi + term[:, k]
    var = np.zeros(512, np.float32)
    for k in range(10):
        e = (ss[:, k] - mean).astype(np.float64)
        var = (e * e + var.astype(np.float64)).astype(np.float32)
    fused = chi * (var / jf)
    assert (g.view(np.int32) != fused.view(np.int32)).any()


class _FakeLibrary:
    """Stands in for the kernel library: records each call, writes nothing."""

    def __init__(self):
        self.calls = []

    def repro_chi2(self, *args):
        self.calls.append(args)
        return 0


def test_each_entry_point_is_one_library_call(monkeypatch):
    """Past the device dispatch, each wrapper makes one library call on one
    (M + S,) buffer and returns views of it; ``chi2_feedback`` passes no
    segment ids and S = 0. (The card tests count the kernels themselves.)"""
    from repro_torch.kernels import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(chi2, "use_plain", lambda *a: False)
    fp, ft, ss = (torch.from_numpy(a) for a in feedback(np.random.default_rng(4), 20, 10))
    seg = torch.arange(20, dtype=torch.int32) % 4
    before = chi2.chi2_feedback.launches, chi2.chi2_feedback_segmented.launches
    g = chi2.chi2_feedback(fp, ft, ss)
    assert len(lib.calls) == 1 and g.shape == (20,)
    assert lib.calls[0][3] is None and lib.calls[0][5:8] == (20, 10, 0)
    g, seg_sum = chi2.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    assert len(lib.calls) == 2 and lib.calls[1][3] == seg.data_ptr() and lib.calls[1][5:8] == (20, 10, 4)
    assert g.untyped_storage().data_ptr() == seg_sum.untyped_storage().data_ptr() == lib.calls[1][4]
    assert seg_sum.data_ptr() == g.data_ptr() + 4 * 20 and seg_sum.shape == (4,)
    assert (chi2.chi2_feedback.launches, chi2.chi2_feedback_segmented.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="shared memory"):
        chi2.chi2_feedback_segmented(fp, ft, ss, seg, chi2.MAX_SMEM // 4)
    assert len(lib.calls) == 2


def test_segmented_numpy_reads_both_outputs():
    fp, ft, ss = (torch.from_numpy(a) for a in feedback(np.random.default_rng(6), 9, 6))
    seg = torch.tensor([0, 1, 2, 0, -1, 1, 2, 2, 0], dtype=torch.int32)
    g, seg_sum = chi2.chi2_feedback_segmented(fp, ft, ss, seg, 3)
    host_g, host_s = chi2.segmented_numpy(g, seg_sum)
    assert host_g.tobytes() == g.numpy().tobytes() and host_s.tobytes() == seg_sum.numpy().tobytes()
