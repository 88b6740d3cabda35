"""bf16 inputs to the port's kernels whose reference casts them to fp32.

On the CPU each wrapper takes its plain version, which casts bf16 operands
to fp32 as the reference's kernel bodies do; those are held to the
reference's Pallas kernels in interpret mode on the same bf16 inputs
(numpy seeds, rounded to bf16 once and handed to both packages).

Tolerances. Flash forward at the reference's own shapes and bf16
tolerance (``tests/test_kernels.py:14``, atol = rtol = 2e-2; the output is
bf16); the backward at the same tolerance. ``l1_distance`` and
``l1_distance_pairwise`` at the reference's shapes and rtol 3e-3
(``tests/test_kernels.py:69``, ``tests/test_batched_kernels.py:24``),
``pairwise_l1`` at the same. Stated here for the rest: the assign's
distances rtol 3e-3 (the L1 sums), its index equal and its blended row
bit for bit against the reference's fenced blend (both sides blend the
same fp32 values with the two-op form);
chi2 rtol 1e-5 (fp32 arithmetic on the same fp32 values, sums in another
order); merge within one bf16 ulp (rtol 2**-8: the fp32 merge agrees within
1e-6 and is rounded to bf16 once, which may land on either side of a
rounding boundary). Also: the fp32 results do not change, bf16 output
dtypes follow the reference, and float16 or mixed dtypes raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.assign_lerp import assign_and_lerp as pallas_assign_and_lerp
from repro.kernels.chi2_feedback import chi2_feedback as pallas_chi2
from repro.kernels.chi2_feedback import chi2_feedback_segmented as pallas_chi2_seg
from repro.kernels.flash_attention import flash_attention_with_lse as pallas_flash
from repro.kernels.flash_attention_bwd import flash_attention_bwd as pallas_flash_bwd
from repro.kernels.l1_distance import l1_distance as pallas_l1
from repro.kernels.l1_distance import pairwise_l1 as pallas_pairwise_l1
from repro.kernels.l1_pairwise import l1_distance_pairwise as pallas_pairwise
from repro.kernels.merge_attention import merge_attention as pallas_merge
from repro_torch.kernels import assign_lerp, chi2, l1, merge
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import flash_attention_bwd as FB
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

BF16 = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    """(torch bf16, jax bf16) of the same values."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------------- flash
FLASH_CASES = [  # the reference's tests/test_kernels.py sweep
    (1, 4, 2, 128, 128, 64, True, None, None),
    (2, 4, 4, 64, 64, 32, True, None, 50.0),
    (1, 2, 1, 100, 100, 80, True, 32, None),
    (1, 2, 2, 64, 192, 128, False, None, None),
    (2, 8, 2, 1, 256, 64, True, None, None),
    (1, 4, 4, 256, 256, 16, True, None, None),
    (1, 16, 2, 32, 32, 64, True, 8, 30.0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_forward_bf16_matches_the_reference(case):
    B, H, KV, Sq, Sk, hd, causal, window, softcap = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    (q, jq), (k, jk), (v, jv) = _bf16(rng, B, H, Sq, hd), _bf16(rng, B, KV, Sk, hd), _bf16(rng, B, KV, Sk, hd)
    q_pos0 = Sk - Sq if causal and Sk > Sq else 0
    kw = dict(causal=causal, window=window, softcap=softcap, q_pos0=q_pos0)
    o, lse = F.flash_attention_with_lse(q, k, v, **kw)
    jo, jlse = pallas_flash(jq, jk, jv, interpret=True, **kw)
    assert o.dtype == BF16 and lse.dtype == torch.float32 and jo.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(o), _np(jo), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), _np(jlse), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[6]],
                         ids=[str(c) for c in (FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[6])])
def test_flash_backward_bf16_matches_the_reference(case):
    B, H, KV, Sq, Sk, hd, causal, window, softcap = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31 + 1)
    (q, jq), (k, jk), (v, jv) = _bf16(rng, B, H, Sq, hd), _bf16(rng, B, KV, Sk, hd), _bf16(rng, B, KV, Sk, hd)
    do, jdo = _bf16(rng, B, H, Sq, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jo, jlse = pallas_flash(jq, jk, jv, interpret=True, **kw)
    want = pallas_flash_bwd(jq, jk, jv, jo, jlse, jdo, interpret=True, **kw)
    o = torch.from_numpy(_np(jo)).to(BF16)
    got = FB.flash_attention_bwd(q, k, v, o, torch.tensor(_np(jlse)), do, **kw)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.dtype == BF16 and g.shape == like.shape and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------- L1
@pytest.mark.parametrize("n", [1, 100, 1000, 65536, 70000])
@pytest.mark.parametrize("c", [1, 2, 5])
def test_l1_distance_bf16_matches_the_reference(n, c):
    rng = np.random.default_rng(n * 7 + c)
    (u, ju), (cs, jcs) = _bf16(rng, n), _bf16(rng, c, n)
    got = l1.l1_distance(u, cs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(pallas_l1(ju, jcs, interpret=True)), rtol=3e-3)


@pytest.mark.parametrize("m,c,n", [(1, 1, 1), (3, 5, 100), (9, 2, 700), (17, 9, 300), (8, 8, 8192)])
def test_l1_pairwise_bf16_matches_the_reference(m, c, n):
    rng = np.random.default_rng(m * 13 + n)
    (xs, jxs), (cs, jcs) = _bf16(rng, m, n), _bf16(rng, c, n)
    got = l1.l1_distance_pairwise(xs, cs)
    np.testing.assert_allclose(got.numpy(), _np(pallas_pairwise(jxs, jcs, interpret=True)), rtol=3e-3)


@pytest.mark.parametrize("m,n", [(3, 100), (6, 4099)])
def test_pairwise_l1_bf16_matches_the_reference(m, n):
    vs, jvs = _bf16(np.random.default_rng(m + n), m, n)
    np.testing.assert_allclose(l1.pairwise_l1(vs).numpy(), _np(pallas_pairwise_l1(jvs, interpret=True)),
                               rtol=3e-3, atol=1e-6)


# ------------------------------------------------------------ assign + lerp
@pytest.mark.parametrize("c,n", [(1, 100), (5, 300), (8, 4096), (3, 70000), (2, 4099)])
def test_assign_and_lerp_bf16_matches_the_reference(c, n):
    rng = np.random.default_rng(n + c)
    (u, ju), (cs, jcs) = _bf16(rng, n), _bf16(rng, c, n)
    dp, ip, bp = pallas_assign_and_lerp(ju, jcs, 0.3, interpret=True)
    d, i, b = assign_lerp.assign_and_lerp(u, cs, 0.3)
    assert d.dtype == b.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), _np(dp), rtol=3e-3)
    assert int(i) == int(ip)
    _, ir, br = ref.assign_and_lerp_ref(ju, jcs, 0.3)
    assert int(ir) == int(i)
    np.testing.assert_array_equal(b.numpy().view(np.int32), np.asarray(br, np.float32).view(np.int32))
    # not held to bp: the interpret-mode kernel's blend contracts into an FMA on jax 0.9.0
    # (ROADMAP queue 3), as in the fp32 test (tests/test_torch_kernels.py)
    assert bp.dtype == jnp.float32


# ------------------------------------------------------------------- chi2
def _hist(rng, m, j):
    h = rng.random((m, j)).astype(np.float32) + 0.05
    return h / h.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("m,j", [(1, 6), (7, 12), (33, 40), (300, 6)])
def test_chi2_bf16_matches_the_reference(m, j):
    rng = np.random.default_rng(m * 31 + j)
    rows = [torch.from_numpy(_hist(rng, m, j)).to(BF16) for _ in range(3)]
    jrows = [jnp.asarray(r.float().numpy()).astype(jnp.bfloat16) for r in rows]
    got = chi2.chi2_feedback(*rows)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(pallas_chi2(*jrows, interpret=True)), rtol=1e-5, atol=1e-9)
    seg = rng.integers(-1, 3, size=m).astype(np.int32)
    onehot = (seg[:, None] == np.arange(3)[None, :]).astype(np.float32)
    g, s = chi2.chi2_feedback_segmented(*rows, torch.from_numpy(seg), 3)
    jg, js = pallas_chi2_seg(*jrows, jnp.asarray(onehot), interpret=True)
    np.testing.assert_allclose(g.numpy(), _np(jg), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ merge
@pytest.mark.parametrize("n", [5, 4096, 70001])
def test_merge_attention_bf16_matches_the_reference(n):
    rng = np.random.default_rng(n)
    (vm, jvm), (va, jva), (vt, jvt) = _bf16(rng, n), _bf16(rng, n), _bf16(rng, n)
    got = merge.merge_attention(vm, va, vt)
    want = pallas_merge(jvm, jva, jvt, interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -8, atol=1e-6)
    inplace = vm.clone()
    assert merge.merge_attention(inplace, va, vt, out=inplace) is inplace
    assert torch.equal(inplace.view(torch.int16), got.view(torch.int16))


# ------------------------------------------------- fp32 unchanged, dtypes
def test_bf16_plain_versions_are_the_fp32_ones_on_the_cast_rows():
    rng = np.random.default_rng(5)
    u, cs, xs = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
                 for s in ((300,), (4, 300), (3, 300)))
    f = lambda t: t.float()  # noqa: E731
    assert torch.equal(l1.l1_distance(u, cs), l1.l1_distance(f(u), f(cs)))
    assert torch.equal(l1.l1_distance_pairwise(xs, cs), l1.l1_distance_pairwise(f(xs), f(cs)))
    for a, b in zip(assign_lerp.assign_and_lerp(u, cs, 0.25), assign_lerp.assign_and_lerp(f(u), f(cs), 0.25)):
        assert torch.equal(a, b)
    fp, ft, ss = (torch.from_numpy(_hist(rng, 9, 5)).to(BF16) for _ in range(3))
    assert torch.equal(chi2.chi2_feedback(fp, ft, ss), chi2.chi2_feedback(f(fp), f(ft), f(ss)))
    want = merge.merge_attention(f(cs[0]), f(cs[1]), f(cs[2])).to(BF16)
    assert torch.equal(merge.merge_attention(cs[0], cs[1], cs[2]), want)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32)).to(BF16)
    o, lse = F.flash_attention_with_lse(q, q, q)
    o32, lse32 = F.flash_attention_with_lse(f(q), f(q), f(q))
    assert torch.equal(o, o32.to(BF16)) and torch.equal(lse, lse32)


def test_float16_and_mixed_dtypes_raise():
    h = torch.zeros(2, 8, dtype=torch.float16)
    b = torch.zeros(2, 8, dtype=BF16)
    x = torch.zeros(2, 8)
    for call in (lambda: l1.l1_distance(h[0], h), lambda: l1.l1_distance_pairwise(h, h), lambda: l1.pairwise_l1(h),
                 lambda: assign_lerp.assign_and_lerp(h[0], h, 0.5), lambda: chi2.chi2_feedback(h, h, h),
                 lambda: merge.merge_attention(h[0], h[0], h[0]),
                 lambda: F.flash_attention_with_lse(h[None, None], h[None, None], h[None, None])):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call()
    for call in (lambda: l1.l1_distance(b[0], x), lambda: merge.merge_attention(b[0], x[0], x[0]),
                 lambda: chi2.chi2_feedback(b, x, x),
                 lambda: F.flash_attention_with_lse(b[None, None], x[None, None], x[None, None])):
        with pytest.raises(TypeError, match="one dtype"):
            call()
