"""The arithmetic of the bf16 flash-attention kernels, emulated on the CPU.

``csrc/flash_fwd_bf16.cu`` and ``csrc/flash_bwd_bf16.cu`` compute on Hopper's
bf16 tensor cores (``csrc/wgmma_bf16.cuh``):

* ``s = q·kᵀ`` and ``dp = do·vᵀ`` multiply bf16 by bf16, which is exact in
  fp32, and accumulate in fp32;
* a product with an fp32 operand ``x`` (``p`` in ``o = p·v`` and
  ``dv = pᵀ·do``, ``ds`` in ``dq = ds·k`` and ``dk = dsᵀ·q``) runs as two bf16
  products into one fp32 accumulator, ``x = hi + lo`` with
  ``hi = bf16_rn(x)`` and ``lo = bf16_rn(x - hi)``;
* o, dq, dk and dv round to bf16 on the store; lse stays fp32, and
  ``D = rowsum(do·o)`` is the wrappers' fp32 pre-pass on the bf16 ``o``.

These tests run the forward and backward formulas with that arithmetic in
plain PyTorch (fp32 matrix products of bf16-valued operands reproduce the
exact products and fp32 sums) on ``FLASH_CASES`` of
``tests/test_torch_bf16_kernels.py``, and hold the results

* to the JAX reference (the Pallas kernels in interpret mode, on the same
  bf16 inputs) at the reference's bf16 tolerance, atol = rtol = 2e-2;
* to the plain versions (``kernels/flash_attention*.py``, fp32 on the bf16
  inputs) at the bounds the card check uses (``tests/torch_bf16_bounds.py``,
  read by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``): o, dq, dk
  and dv within one bf16 ulp of the plain version's value, or 1e-5
  absolute where that is larger; lse within atol = rtol = 1e-5. Reasons:
  both sides round an fp32 value to bf16 once, and the fp32 values differ
  by the sums' order and the split's dropped term (about 2^-17 of each
  product), a few 1e-6 at most, so a rounding boundary between them moves
  the result by one ulp and no more; where the terms cancel to a value
  whose ulp is below that, the few 1e-6 show whole (up to 2.0e-6 for o in
  ``test_phase5_shape_bounds``'s draw: 1e-5 leaves a margin of 5); lse is
  fp32 on both sides, only the sums' order differs.

At phase 5's shape (2, 32, 512, 64), KV 8, the emulation shows two bounds
first stated for the card too tight (``test_phase5_shape_bounds``): 1e-6
absolute for o near zero (15 elements of 2,097,152 land 1.1e-6 to 2.0e-6
off), and atol = rtol = 4e-3 for the gradients (one dv element of 2,097,152
a step of 2^-6 off at |dv| just above 2, where 4e-3 + 4e-3·|dv| allows
0.012): one rounding step of bf16 is 2^-7 of |x| just above a power of
two, more than 4e-3 relative.

They also show why the kernels split only ``p`` and ``ds``: a bf16 value is
exact in TF32, so split TF32 of it has ``lo == 0`` (the TF32 kernels'
third product on it multiplies a zero), while ``p`` and ``ds`` carry bits
past bf16's 8, and one bf16 product of them misses the ulp bound on o.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_with_lse as pallas_flash
from repro.kernels.flash_attention_bwd import flash_attention_bwd as pallas_flash_bwd
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import flash_attention_bwd as FB
from test_torch_bf16_kernels import FLASH_CASES
from test_torch_flash_tf32 import split as split_tf32
from torch_bf16_bounds import within_one_ulp
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

BF16 = torch.bfloat16
IDS = [str(c) for c in FLASH_CASES]


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16, to nearest even (``__float2bfloat16_rn``), kept as fp32."""
    return x.to(BF16).float()


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = bf16_rn(x)
    return hi, bf16_rn(x - hi)


def mm_split(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ b`` for fp32 ``x`` and bf16-valued ``b``: two bf16 products into
    one fp32 sum, the small part first."""
    hi, lo = split_bf16(x)
    return lo @ b + hi @ b


def mm_hi(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ b`` with ``x`` rounded to bf16 once (one bf16 product)."""
    return bf16_rn(x) @ b


def _scores(q, k, *, scale, causal, window, softcap, q_pos0):
    """Scores of bf16-valued q (B, H, Sq, hd) and k (B, KV, Sk, hd), exact
    products with fp32 sums: (masked s, chain, mask), heads expanded."""
    Sq, Sk = q.shape[2], k.shape[2]
    kh = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = (q @ kh.transpose(-1, -2)) * scale
    chain = torch.ones_like(s)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, chain = softcap * t, 1 - t * t
    mask = F.attention_mask(Sq, Sk, causal=causal, window=window, q_pos0=q_pos0, device="cpu")
    return torch.where(mask, s, torch.full((), F.NEG_INF)), chain, mask


def emulate_fwd(q, k, v, *, mm=mm_split, scale, causal, window, softcap, q_pos0):
    """The bf16 forward kernel's arithmetic: ``(o bf16, lse fp32)``."""
    s, _, mask = _scores(q, k, scale=scale, causal=causal, window=window, softcap=softcap, q_pos0=q_pos0)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    vh = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return mm(p, vh).to(BF16), lse


def emulate_bwd(q, k, v, o, lse, do, *, scale, causal, window, softcap, q_pos0):
    """The bf16 backward kernels' arithmetic: ``(dq, dk, dv)`` in bf16, with
    ``D = rowsum(do·o)`` in fp32 on the bf16 ``o``."""
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    s, chain, mask = _scores(q, k, scale=scale, causal=causal, window=window, softcap=softcap, q_pos0=q_pos0)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    kh, vh = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    dsum = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ vh.transpose(-1, -2) - dsum) * chain
    dq = mm_split(ds, kh) * scale
    dk = (mm_split(ds.transpose(-1, -2), q) * scale).reshape(B, KV, G, -1, hd).sum(2)
    dv = mm_split(p.transpose(-1, -2), do).reshape(B, KV, G, -1, do.shape[-1]).sum(2)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _case(case, seed_extra=0):
    """bf16 inputs of one case (numpy seeds), as torch bf16 and the
    emulation's fp32 copies, and the options."""
    B, H, KV, Sq, Sk, hd, causal, window, softcap = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31 + seed_extra)
    shapes = ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd), (B, H, Sq, hd))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16) for s in shapes)
    kw = dict(causal=causal, window=window, softcap=softcap, q_pos0=Sk - Sq if causal and Sk > Sq else 0)
    return (q, k, v, do), kw


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_forward_emulation_matches_the_reference(case):
    (q, k, v, _), kw = _case(case)
    o, lse = emulate_fwd(q.float(), k.float(), v.float(), scale=case[5] ** -0.5, **kw)
    jo, jlse = pallas_flash(_jax(q), _jax(k), _jax(v), interpret=True, **kw)
    np.testing.assert_allclose(_np(o), _np(jo), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), _np(jlse), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_backward_emulation_matches_the_reference(case):
    (q, k, v, do), kw = _case(case, 1)
    jq, jk, jv, jdo = map(_jax, (q, k, v, do))
    jo, jlse = pallas_flash(jq, jk, jv, interpret=True, **kw)
    want = pallas_flash_bwd(jq, jk, jv, jo, jlse, jdo, interpret=True, **kw)
    o, lse = torch.from_numpy(_np(jo).copy()), torch.from_numpy(_np(jlse).copy())
    got = emulate_bwd(q.float(), k.float(), v.float(), o, lse, do.float(), scale=case[5] ** -0.5, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_forward_emulation_within_the_card_bounds(case):
    (q, k, v, _), kw = _case(case)
    o, lse = emulate_fwd(q.float(), k.float(), v.float(), scale=case[5] ** -0.5, **kw)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
    assert within_one_ulp(o, o_p)
    torch.testing.assert_close(o.float(), o_p.float(), atol=4e-3, rtol=4e-3)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_backward_emulation_within_the_card_bounds(case):
    (q, k, v, do), kw = _case(case, 1)
    o, lse = F.flash_attention_with_lse_plain(q, k, v, **kw)
    got = emulate_bwd(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale=case[5] ** -0.5, **kw)
    want = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype == BF16
        assert within_one_ulp(g, w), name
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)


def test_phase5_shape_bounds():
    """Phase 5's shape, causal, one draw: o and the gradients within one ulp
    or 1e-5 everywhere and lse within 1e-5; a floor of 1e-6 misses o, and
    atol = rtol = 4e-3 misses dv."""
    rng = np.random.default_rng(0)
    B, H, KV, S, hd = 2, 32, 8, 512, 64
    shapes = ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16) for s in shapes)
    kw = dict(causal=True, window=None, softcap=None, q_pos0=0)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
    o, lse = emulate_fwd(q.float(), k.float(), v.float(), scale=hd ** -0.5, **kw)
    assert within_one_ulp(o, o_p) and not within_one_ulp(o, o_p, floor=1e-6)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-5)
    got = emulate_bwd(q.float(), k.float(), v.float(), o_p.float(), lse_p, do.float(), scale=hd ** -0.5, **kw)
    want = FB.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    assert all(within_one_ulp(g, w) for g, w in zip(got, want))
    assert not torch.allclose(got[2].float(), want[2].float(), atol=4e-3, rtol=4e-3)


@pytest.mark.parametrize("case", FLASH_CASES[:3], ids=IDS[:3])
def test_one_bf16_product_of_p_misses_the_ulp_bound(case):
    """p rounded to bf16 once (no lo part): o misses one ulp of the plain
    version somewhere, which is why the kernels pay for the second product."""
    (q, k, v, _), kw = _case(case)
    o, _ = emulate_fwd(q.float(), k.float(), v.float(), mm=mm_hi, scale=case[5] ** -0.5, **kw)
    o_p, _ = F.flash_attention_with_lse_plain(q, k, v, **kw)
    assert not within_one_ulp(o, o_p)


def test_bf16_values_split_in_tf32_with_a_zero_lo():
    """A bf16 value has 8 significant bits, TF32 11: split TF32 (the fp32
    kernels' ``hi + lo``) of it is ``hi == x``, ``lo == 0``; ``p`` and ``ds``,
    fp32 results, split with ``lo != 0``."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)).to(BF16).float()
    hi, lo = split_tf32(x)
    assert torch.equal(hi, x) and torch.equal(lo, torch.zeros_like(x))
    p = torch.softmax(torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)), -1)
    assert bool((split_tf32(p)[1] != 0).any())
    hi, lo = split_bf16(p)
    assert bool((lo != 0).any())
    rel = ((hi.double() + lo.double() - p.double()).abs() / p.double()).max().item()
    assert rel <= 2.0 ** -16  # lo keeps 8 of the 16 bits hi drops
