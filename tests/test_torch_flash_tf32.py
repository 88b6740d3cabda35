"""The numerics the CUDA flash-attention kernels rely on, emulated on the CPU.

``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` compute every product on the
tensor cores in split TF32: each fp32 operand is split as ``x = hi + lo``
with ``hi = cvt.rna.tf32(x)`` and ``lo = cvt.rna.tf32(x - hi)``, and a product
is ``hi_a·lo_b + lo_a·hi_b + hi_a·hi_b`` with fp32 accumulation
(``csrc/mma_tf32.cuh``). These tests emulate that in plain PyTorch (TF32
products are exact in fp32, so fp32 matrix products of the split parts
reproduce them), run the forward and backward formulas with it, and hold the
results to ``chip_smoke.py``'s tolerances against an fp64 computation:
forward 1e-5, backward 3e-4. Single TF32 (``hi_a·hi_b`` alone) misses them,
which is why the kernels pay for three products.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import flash_attention_bwd as FB
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32's 10 mantissa bits, to nearest, ties away from
    zero (``cvt.rna.tf32.f32``): add half an ulp of TF32 to the magnitude
    bits, then clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_split3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in split TF32: the cross terms first, then ``hi·hi``."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in single TF32."""
    return tf32_rna(a) @ tf32_rna(b)


def attention_fwd_bwd(q, k, v, do, mm, *, scale, window, softcap):
    """Causal attention forward and backward with every product through
    ``mm``, the way the kernels form them: ``(o, lse, dq, dk, dv)``."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kh, vh = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = mm(q, kh.transpose(-1, -2)) * scale
    chain = torch.ones_like(s)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, chain = softcap * t, 1 - t * t
    mask = F.attention_mask(S, S, causal=True, window=window, q_pos0=0, device="cpu")
    s = torch.where(mask, s, torch.full((), F.NEG_INF, dtype=s.dtype))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), dtype=s.dtype))
    o = mm(p, vh)
    dsum = (do * o).sum(-1, keepdim=True)
    ds = p * (mm(do, vh.transpose(-1, -2)) - dsum) * chain
    dq = mm(ds, kh) * scale
    dk = (mm(ds.transpose(-1, -2), q) * scale).reshape(B, -1, G, S, hd).sum(2)
    dv = mm(p.transpose(-1, -2), do).reshape(B, -1, G, S, v.shape[-1]).sum(2)
    return o, lse, dq, dk, dv


# name, B, H, KV, S, hd, options: llama3.2-1b's heads cut to one sequence of
# 256 over 2 KV heads, and gemma2's head width 256 with its window and
# softcap cut to S = 128
SHAPES = [
    ("llama3.2-1b-like", 1, 8, 2, 256, 64, dict(scale=64 ** -0.5, window=None, softcap=None)),
    ("gemma2 S=128", 1, 8, 4, 128, 256, dict(scale=256 ** -0.5, window=128, softcap=50.0)),
]
TOL = (1e-5, 1e-5, 3e-4, 3e-4, 3e-4)  # o, lse, dq, dk, dv: chip_smoke.py's forward and backward tolerances


def _run(shape, mm):
    _, B, H, KV, S, hd, kw = shape
    rng = np.random.default_rng(S + hd)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))]
    got = attention_fwd_bwd(*map(torch.from_numpy, arrays), mm, **kw)
    want = attention_fwd_bwd(*(torch.from_numpy(a).double() for a in arrays), torch.matmul, **kw)
    return got, want


def _within(got, want, tol) -> bool:
    return torch.allclose(got.double(), want, rtol=tol, atol=tol)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


def test_split_keeps_fp32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21  # lo keeps 11 of the 13 bits hi drops


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_tf32_within_tolerances(shape):
    got, want = _run(shape, mm_split3)
    for g, w, tol, name in zip(got, want, TOL, ("o", "lse", "dq", "dk", "dv")):
        torch.testing.assert_close(g.double(), w, rtol=tol, atol=tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_single_tf32_misses_tolerances(shape):
    got, want = _run(shape, mm_tf32)
    assert not _within(got[0], want[0], TOL[0]), "single TF32 met the forward's o tolerance"
    assert not all(_within(g, w, t) for g, w, t in zip(got[2:], want[2:], TOL[2:])), \
        "single TF32 met the backward's tolerance"


def test_kernel_formulas_match_plain_versions():
    """The emulation's formulas are the plain versions' (exact products, fp64)."""
    shape = SHAPES[1]
    _, B, H, KV, S, hd, kw = shape
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).double() for s in
                   ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
    o, lse, dq, dk, dv = attention_fwd_bwd(q, k, v, do, torch.matmul, **kw)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
    grads = FB.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    for got, want in zip((o, lse, dq, dk, dv), (o_p, lse_p, *grads)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
