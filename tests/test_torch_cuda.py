"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no CPU
mode); they import no JAX, so they run on a machine with only the port's
dependencies: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances as in ``chip_smoke.py``: L1 and chi2 rtol 1e-5, the blend
bitwise, the index equal, merge rtol 1e-6 / atol 1e-7, the flash forward
1e-5 and backward 3e-4 (the backward also bitwise across repeats).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _feedback(rng, m, j):
    f_pred = (rng.uniform(size=(m, j)) * 100).astype(np.float32)
    f_true = (rng.uniform(size=(m, j)) * 100 + 1.0).astype(np.float32)
    z = rng.standard_normal((m, j))
    s_soft = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return f_pred, f_true, s_soft


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4550, 25418, 4099])
def test_cuda_kernels_match_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    dev = cuda_device
    cs = torch.from_numpy(_f32(rng, 5, n)).to(dev)
    u = torch.from_numpy(_f32(rng, n)).to(dev)
    d, i, b = ops.assign_and_lerp(u, cs, 0.25)
    dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, 0.25)
    torch.testing.assert_close(d, dp, rtol=1e-5, atol=0)
    assert int(i) == int(ip)
    assert torch.equal(b, bp)
    xs = torch.from_numpy(_f32(rng, 8, n)).to(dev)
    torch.testing.assert_close(ops.l1_distance_pairwise(xs, cs),
                               l1.l1_distance_pairwise_plain(xs, cs), rtol=1e-5, atol=0)
    torch.testing.assert_close(ops.merge_attention(u, cs[0], cs[1]),
                               merge.merge_attention_plain(u, cs[0], cs[1])[0], rtol=1e-6, atol=1e-7)
    fp, ft, ss = (torch.from_numpy(a).to(dev) for a in _feedback(rng, 64, 10))
    seg = torch.from_numpy(np.arange(64, dtype=np.int32) % 4).to(dev)
    g, s = ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    gp, sp = chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, 4)
    torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda_device):
    ops.reset_launch_counts()
    x = torch.ones(3, 40, device=cuda_device)
    ops.l1_distance_pairwise(x, x)
    ops.assign_and_lerp(x[0], x, 0.5)
    counts = ops.launch_counts()
    assert counts["l1_distance_pairwise"] == 1 and counts["assign_and_lerp"] == 1
    assert counts["l1_distance"] == 1  # the assign chain's distance launch


FLASH_CASES = [
    # B, H, KV, Sq, Sk, hd, dv, options
    (8, 4, 2, 32, 32, 16, 16, {}),  # tiny_lm training shape
    (1, 8, 4, 100, 100, 64, 48, dict(window=32, softcap=30.0)),  # ragged, GQA, dv != hd
    (1, 8, 2, 300, 300, 128, 128, {}),  # head width 128 (llama3-405b, command-r)
    (1, 4, 2, 65, 65, 64, 64, {}),  # one row past a 64-row tile
    (2, 4, 2, 70, 70, 12, 12, {}),  # head width not a multiple of 4: 4-byte copies
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_cuda_flash_kernels_match_plain(cuda_device, case):
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB

    B, H, KV, Sq, Sk, hd, dv, kw = case
    rng = np.random.default_rng(Sq)
    q, k, v, do = (torch.from_numpy(_f32(rng, *s)).to(cuda_device)
                   for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, dv), (B, H, Sq, dv)))
    o, lse = F.flash_attention_with_lse(q, k, v, **kw)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    got = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    again = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_flash_wrappers_count_launches(cuda_device):
    ops.reset_launch_counts()
    q = torch.ones(2, 4, 16, 16, device=cuda_device, requires_grad=True)
    kv = torch.ones(2, 2, 16, 16, device=cuda_device, requires_grad=True)
    ops.attention(q, kv, kv).sum().backward()
    ops.pairwise_l1(torch.ones(3, 40, device=cuda_device))
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == 1
    assert counts["pairwise_l1"] == 1
