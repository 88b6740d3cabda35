"""The port's flash-attention plain versions against the reference's Pallas
kernels (interpret mode), its autograd Function against autograd through
the materialized forward, and ``pairwise_l1``.

Inputs come from numpy seeds and go to both packages. Tolerances as in
``tests/test_attention_grads.py``: forward 1e-5, backward 3e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_with_lse as jax_fwd
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_bwd
from repro.kernels.l1_distance import pairwise_l1 as jax_pairwise_l1
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.kernels import l1, ops
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

# B, H, KV, S, hd, dv, causal, window, softcap (tests/test_attention_grads.py), plus q_pos0
CASES = [
    (1, 4, 2, 64, 32, 32, True, None, None, 0),
    (2, 4, 1, 48, 16, 16, True, None, None, 0),
    (1, 2, 2, 64, 32, 32, False, None, None, 0),
    (1, 4, 2, 64, 32, 32, True, 16, None, 0),
    (1, 4, 4, 64, 32, 32, True, None, 30.0, 0),
    (1, 4, 4, 64, 48, 24, True, None, None, 0),
    (1, 8, 2, 100, 64, 64, True, None, None, 0),
    (1, 4, 2, 24, 32, 32, True, None, None, 40),  # continuation: Sq 24 of Sk 64, q_pos0 40
]


def _inputs(case, seed=0):
    B, H, KV, S, hd, dv, causal, window, softcap, q_pos0 = case
    rng = np.random.default_rng(seed)
    sk = S + q_pos0 if q_pos0 else S
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, sk, dv)).astype(np.float32)
    do = rng.standard_normal((B, H, S, dv)).astype(np.float32)
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap, q_pos0=q_pos0)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_forward_matches_reference_kernel(case):
    (q, k, v, _), kw = _inputs(case)
    want_o, want_lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    o, lse = F.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_backward_matches_reference_kernels(case):
    (q, k, v, do), kw = _inputs(case, seed=1)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jax_fwd(jq, jk, jv, interpret=True, **kw)
    want = jax_bwd(jq, jk, jv, jo, jlse, jdo, interpret=True, **kw)
    got = FB.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, np.array(jo), np.array(jlse), do)), **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4, atol=3e-4, err_msg=name)


@pytest.mark.parametrize("case", CASES[:2] + CASES[3:5] + CASES[-1:], ids=str)
def test_autograd_function_matches_autograd_through_materialized_forward(case):
    (q, k, v, do), kw = _inputs(case, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    ref_leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o_ref, _ = F.flash_attention_with_lse_plain(*ref_leaves, **kw)
    want = torch.autograd.grad(o_ref, ref_leaves, torch.from_numpy(do))
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)


def test_attention_options_are_constants_without_gradients():
    (q, k, v, _), kw = _inputs(CASES[0])
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ops.attention(*t, **kw).sum().backward()
    assert all(x.grad is not None and x.grad.shape == x.shape for x in t)


@pytest.mark.parametrize("m,n", [(1, 7), (5, 300), (12, 4099)])
def test_pairwise_l1_matches_reference(m, n):
    x = np.random.default_rng(m * n).standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jax_pairwise_l1(jnp.asarray(x), interpret=True))
    got = l1.pairwise_l1(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert got.shape == (m, m) and torch.equal(got, l1.pairwise_l1_plain(torch.from_numpy(x)))


def test_wrappers_raise_on_bad_arguments():
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="GQA"):
        F.flash_attention_with_lse(q, kv, kv)
    with pytest.raises(TypeError, match="float32"):
        F.flash_attention_with_lse(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="window"):
        F.flash_attention_with_lse(q[:, :2], kv, kv, window=0)
