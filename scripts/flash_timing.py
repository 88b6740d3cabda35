#!/usr/bin/env python3
"""Device time per call of the port's flash-attention kernels on one GPU.

    python3 scripts/flash_timing.py [ROOT ...]

Times the flash forward, the backward (``D`` pre-pass, dq and dkv) and each
backward kernel alone, beside fp32 ``scaled_dot_product_attention`` and its
backward as a yardstick, at the LM paths' shapes (``tiny_lm``, full-width
``llama3.2-1b``) and at S = 2048; then the same at bf16 (the bf16 kernels,
the ``D`` pre-pass alone, bf16 SDPA) at ``chip_smoke.py`` phase 5's step
shape (2, 32, 512, 64) and the reference's train_4k attention shape (2, 32,
4,096, 64), 8 KV heads. Device time per call from
``chip_smoke.device_ms``. Roots, turns and output as in
``scripts/timing_turns.py``.

    python3 scripts/flash_timing.py --bits [ROOT ...]

Times nothing: runs the forward and backward on seeded inputs at
``BITS_SHAPES`` (``tiny_lm``'s, full-width ``llama3.2-1b``'s, a ragged GQA
shape with a window, a softcap and ``dv != hd``, head width 12 on the
narrow copies, head width 256) and prints, per shape, one SHA-256 of the
fp32 kernels' outputs' bytes (o, lse, dq, dk, dv) and one of the bf16
kernels' on the same inputs rounded to bf16. Equal digests across roots:
the same bits.
"""
from __future__ import annotations

import sys

from timing_turns import device_ms, main

SHAPES = {  # label: B, H, S, hd, KV (causal, dv = hd)
    "tiny_lm": (8, 4, 32, 16, 2),
    "llama3.2-1b": (4, 32, 256, 64, 8),
    "llama3.2-1b S=2048": (1, 32, 2048, 64, 8),
}
BITS_SHAPES = {  # label: B, H, KV, S, hd, dv, options
    "tiny_lm": (8, 4, 2, 32, 16, 16, {}),
    "llama3.2-1b": (4, 32, 8, 256, 64, 64, {}),
    "ragged window softcap": (1, 8, 4, 100, 64, 48, dict(window=32, softcap=30.0)),
    "hd 12": (2, 4, 2, 70, 12, 12, {}),
    "hd 256": (1, 4, 2, 160, 256, 256, {}),
}
BF16_SHAPES = {  # label: B, H, S, hd, KV (causal, dv = hd), bf16
    "bf16 phase 5 step": (2, 32, 512, 64, 8),
    "bf16 train_4k": (2, 32, 4096, 64, 8),
}


def measure() -> dict:
    import torch

    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for label, (B, H, S, hd, KV) in {**SHAPES, **BF16_SHAPES}.items():
        dtype = torch.bfloat16 if label in BF16_SHAPES else torch.float32
        q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
        o, lse = ops.flash_attention_with_lse(q, k, v)
        dsum = FB._dsum(do, o)
        qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        o_lib = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
        it = 20 if S >= 4096 else 100  # calls a profiler session
        out[label] = {
            "fwd": device_ms(lambda: ops.flash_attention_with_lse(q, k, v), it),
            "bwd": device_ms(lambda: FB.flash_attention_bwd(q, k, v, o, lse, do), it),
            "dq": device_ms(lambda: FB.flash_attention_dq(q, k, v, do, lse, dsum), it),
            "dkv": device_ms(lambda: FB.flash_attention_dkv(q, k, v, do, lse, dsum), it),
            "sdpa_fwd": device_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), it),
            "sdpa_bwd": device_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do, retain_graph=True), it),
            "dsum": device_ms(lambda: FB._dsum(do, o), it),
        }
    return out


def bits() -> dict:
    import hashlib

    import torch

    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB

    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for label, (B, H, KV, S, hd, dv, kw) in BITS_SHAPES.items():
        fp32 = [torch.randn(s, generator=g, device="cuda")
                for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, dv), (B, H, S, dv))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (x.to(dtype) for x in fp32)
            o, lse = F.flash_attention_with_lse(q, k, v, **kw)
            digest = hashlib.sha256()
            for t in (o, lse, *FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)):
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            out[f"{label} {str(dtype).removeprefix('torch.')}"] = digest.hexdigest()[:16]
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, measure, {"--bits": bits}))
