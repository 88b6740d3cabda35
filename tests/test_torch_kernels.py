"""The port's kernel modules against the reference's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version; those are held
against the JAX package's Pallas kernels run in interpret mode (and the
blend against ``repro.kernels.ref.assign_and_lerp_ref``, bit for bit) over
the sweeps of ``test_kernels.py`` and ``test_batched_kernels.py``. Inputs
come from numpy seeds. ``test_torch_cuda.py`` holds the CUDA kernels
against these plain versions on the card.

Tolerances: L1 and chi2 rtol 1e-5 (fp32 sums in another order); the argmin
index equal; the blend bitwise (both sides round each product, then the
sum); merge rtol 1e-6 / atol 1e-6 (the max is exact; the tolerance covers
the reference blend, which XLA may contract into an FMA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.kernels.assign_lerp import assign_and_lerp as pallas_assign_and_lerp
from repro.kernels.chi2_feedback import chi2_feedback as pallas_chi2
from repro.kernels.chi2_feedback import chi2_feedback_segmented as pallas_chi2_seg
from repro.kernels.l1_distance import l1_distance as pallas_l1
from repro.kernels.l1_pairwise import l1_distance_pairwise as pallas_pairwise
from repro.kernels.merge_attention import merge_attention as pallas_merge
from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- family A: L1
@pytest.mark.parametrize("n", [1, 100, 1000, 4097, 4099, 65536, 70000])
@pytest.mark.parametrize("c", [1, 2, 5])
def test_l1_distance_matches_pallas(n, c):
    rng = np.random.default_rng(n * 7 + c)
    u, cs = _f32(rng, n), _f32(rng, c, n)
    got = l1.l1_distance(_t(u), _t(cs)).numpy()
    want = np.asarray(pallas_l1(jnp.asarray(u), jnp.asarray(cs), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("m,c,n", [(1, 1, 1), (3, 5, 100), (9, 2, 700), (17, 9, 300), (8, 8, 8192), (3, 5, 4097),
                                   (2, 3, 4099)])
def test_l1_pairwise_matches_pallas(m, c, n):
    rng = np.random.default_rng(m * 13 + n)
    xs, cs = _f32(rng, m, n), _f32(rng, c, n)
    got = l1.l1_distance_pairwise(_t(xs), _t(cs)).numpy()
    want = np.asarray(pallas_pairwise(jnp.asarray(xs), jnp.asarray(cs), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_l1_pairwise_self_diagonal_and_rows():
    vs = _t(_f32(np.random.default_rng(2), 6, 256))
    d = l1.l1_distance_pairwise(vs, vs).numpy()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-5)
    for i in range(6):
        np.testing.assert_allclose(d[i], l1.l1_distance(vs[i], vs).numpy(), rtol=1e-5)


# ---------------------------------------------------- family B: assign+lerp
# (4, 783360): the full-width LM delta against four centers
@pytest.mark.parametrize("c,n", [(1, 100), (5, 300), (8, 4096), (3, 70000), (5, 4097), (2, 4099), (4, 783360)])
def test_assign_and_lerp_matches_pallas_and_ref(c, n):
    rng = np.random.default_rng(n + c)
    u, cs = _f32(rng, n), _f32(rng, c, n)
    dp, ip, _ = pallas_assign_and_lerp(jnp.asarray(u), jnp.asarray(cs), 0.25, interpret=True)
    for beta in (0.0, 0.25, 1.0, 0.3):  # 0.3: (1 - beta) is inexact in fp32
        d, i, b = assign_lerp.assign_and_lerp(_t(u), _t(cs), beta)
        np.testing.assert_allclose(d.numpy(), np.asarray(dp), rtol=1e-5)
        assert i.dtype == torch.int32 and int(i) == int(ip)
        _, ir, br = ref.assign_and_lerp_ref(jnp.asarray(u), jnp.asarray(cs), beta)
        assert int(ir) == int(i)
        np.testing.assert_array_equal(b.numpy(), np.asarray(br))  # bitwise


def test_assign_and_lerp_ties_break_to_first_index():
    u = np.full(64, 1.0, np.float32)
    cs = np.stack([np.full(64, 3.0), np.full(64, 2.0), np.full(64, 0.0)]).astype(np.float32)
    d, i, b = assign_lerp.assign_and_lerp(_t(u), _t(cs), 0.5)
    assert d[1] == d[2] and int(i) == 1 == int(np.argmin(d.numpy()))
    np.testing.assert_array_equal(b.numpy(), np.full(64, 1.5, np.float32))


def test_assign_and_lerp_blends_only_the_argmin_center():
    u = _t(np.full(256, 2.0, np.float32))
    cs = _t(np.stack([np.zeros(256), np.full(256, 1.9), np.full(256, 100.0)]).astype(np.float32))
    d, i, b = assign_lerp.assign_and_lerp(u, cs, 0.5)
    assert int(i) == 1
    np.testing.assert_allclose(b.numpy(), 0.5 * 1.9 + 0.5 * 2.0, rtol=1e-6)
    assert float(d[0]) == pytest.approx(2.0 * 256, rel=1e-6)


# ----------------------------------------------------------- family C: chi2
def _feedback(rng, m, j):
    f_pred = (rng.uniform(size=(m, j)) * 100).astype(np.float32)
    f_true = (rng.uniform(size=(m, j)) * 100 + 1.0).astype(np.float32)
    z = rng.standard_normal((m, j))
    s_soft = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return f_pred, f_true, s_soft


@pytest.mark.parametrize("m,j", [(1, 10), (7, 6), (300, 9), (64, 2), (5, 200)])
def test_chi2_feedback_matches_pallas(m, j):
    fp, ft, ss = _feedback(np.random.default_rng(m * 31 + j), m, j)
    got = chi2.chi2_feedback(_t(fp), _t(ft), _t(ss)).numpy()
    want = np.asarray(pallas_chi2(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_chi2_uses_population_variance():
    s = np.asarray([[0.2, 0.3, 0.5]], np.float32)
    f = np.asarray([[10.0, 20.0, 30.0]], np.float32)
    t = np.asarray([[20.0, 20.0, 20.0]], np.float32)
    g = float(chi2.chi2_feedback(_t(f), _t(t), _t(s))[0])
    assert g == pytest.approx(10.0 * np.var(s), rel=1e-6)  # np.var divides by J


@pytest.mark.parametrize(
    "sizes", [[1], [3, 1, 7], [5, 5], [2, 1, 1, 9, 4], [200, 250, 150]],
    ids=["single-member", "ragged", "even", "very-ragged", "crosses-blocks"],
)
def test_chi2_segmented_matches_pallas(sizes):
    m, s = sum(sizes), len(sizes)
    fp, ft, ss = _feedback(np.random.default_rng(m), m, 6)
    seg = np.repeat(np.arange(s), sizes).astype(np.int32)
    g, seg_sum = ops.chi2_feedback_segmented(_t(fp), _t(ft), _t(ss), _t(seg), num_segments=s)
    onehot = (seg[:, None] == np.arange(s)[None, :]).astype(np.float32)
    gp, sp = pallas_chi2_seg(jnp.asarray(fp), jnp.asarray(ft), jnp.asarray(ss),
                             jnp.asarray(onehot), interpret=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(gp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(seg_sum.numpy(), np.asarray(sp), rtol=1e-5, atol=1e-5)


def test_chi2_segmented_skips_rows_without_segment():
    fp, ft, ss = _feedback(np.random.default_rng(3), 5, 4)
    seg = np.asarray([0, -1, 1, 0, -1], np.int32)
    g, seg_sum = chi2.chi2_feedback_segmented(_t(fp), _t(ft), _t(ss), _t(seg), 2)
    gn = g.numpy()
    np.testing.assert_allclose(seg_sum.numpy(), [gn[0] + gn[3], gn[2]], rtol=1e-6)


# ---------------------------------------------------------- family D: merge
@pytest.mark.parametrize("n", [100, 4096, 70000])
def test_merge_attention_matches_pallas(n):
    rng = np.random.default_rng(n)
    vm, va, vt = _f32(rng, n), _f32(rng, n), _f32(rng, n)
    got = merge.merge_attention(_t(vm), _t(va), _t(vt)).numpy()
    args = (jnp.asarray(vm), jnp.asarray(va), jnp.asarray(vt))
    np.testing.assert_allclose(got, np.asarray(pallas_merge(*args, interpret=True)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_ops.merge_attention(*args)), rtol=1e-6, atol=1e-6)
    _, alpha = merge.merge_attention_plain(_t(vm), _t(va), _t(vt))
    assert (alpha >= 0).all() and (alpha <= 1 + 1e-6).all()


# ------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    u, cs = _t(_f32(rng, 50)), _t(_f32(rng, 3, 50))
    ops.l1_distance(u, cs)
    ops.l1_distance_pairwise(cs, cs)
    ops.assign_and_lerp(u, cs, 0.25)
    fp, ft, ss = (_t(a) for a in _feedback(rng, 4, 6))
    ops.chi2_feedback(fp, ft, ss)
    ops.chi2_feedback_segmented(fp, ft, ss, _t(np.zeros(4, np.int32)), 1)
    ops.merge_attention(u, u + 1, u - 1)
    assert ops.launch_counts() == {name: 0 for name in ops.WRAPPERS}


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros(8)
    with pytest.raises(TypeError):
        ops.l1_distance(u.double(), torch.zeros(2, 8).double())
    with pytest.raises(ValueError):
        ops.l1_distance(u, torch.zeros(2, 9))
    with pytest.raises(ValueError):
        ops.merge_attention(u, u, torch.zeros(7))
    with pytest.raises(ValueError):
        ops.chi2_feedback_segmented(torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2, 3),
                              torch.zeros(2, dtype=torch.int64), 1)


def test_wrappers_reject_mixed_or_meta_devices():
    # all on meta is the dry-run's trace: the plain version, shapes only
    out = ops.l1_distance(torch.zeros(8, device="meta"), torch.zeros(2, 8, device="meta"))
    assert out.device.type == "meta" and out.shape == (2,) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        ops.l1_distance(torch.zeros(8), torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError):
        ops.merge_attention(torch.zeros(8, device="meta"), torch.zeros(8), torch.zeros(8))
