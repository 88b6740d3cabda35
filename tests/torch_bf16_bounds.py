"""The bounds that hold the bf16 flash kernels to their plain versions.

o, dq, dk and dv: within one bf16 ulp of the plain version's value, or
``FLOOR`` absolute where that is larger. Both round an fp32 value to bf16
once, and the two fp32 values differ by the sums' order and by the kernels'
split of p and ds into two bf16 parts (about 2^-17 of each product), a few
1e-6 at most: a rounding boundary between them moves the result by one ulp
and no more, and where the terms cancel to a value whose ulp is smaller
those few 1e-6 show whole (``tests/test_torch_flash_bf16_mma.py`` emulates
the kernels' arithmetic and measures both). lse: fp32 on both sides, only
the sums' order differs, atol = rtol = ``LSE_TOL``. Imports no JAX:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` use it on the card.
"""
import torch

FLOOR = 1e-5
LSE_TOL = 1e-5
REFERENCE_TOL = 2e-2  # the reference's bf16 tolerance (tests/test_kernels.py:14), which every case also meets


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each entry of ``x``: 2^(e - 8) for
    ``x = m·2^e``, ``0.5 <= |m| < 1``."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def within_one_ulp(got: torch.Tensor, want: torch.Tensor, floor: float = FLOOR) -> bool:
    """Every entry of ``got`` within one bf16 ulp of ``want``'s, or within
    ``floor`` absolute."""
    d = (got.float() - want.float()).abs()
    return bool(((d <= bf16_ulp(want)) | (d <= floor)).all())


def max_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest distance in ``want``'s bf16 ulps, over the entries
    farther than ``FLOOR`` (0 when there are none)."""
    d = (got.float() - want.float()).abs()
    far = d > FLOOR
    return (d[far] / bf16_ulp(want)[far]).max().item() if bool(far.any()) else 0.0
