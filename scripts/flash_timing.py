#!/usr/bin/env python3
"""Device time per call of the port's flash-attention kernels on one GPU.

    python3 scripts/flash_timing.py [ROOT ...]

Times the flash forward, the backward (``D`` pre-pass, dq and dkv) and each
backward kernel alone, beside fp32 ``scaled_dot_product_attention`` and its
backward as a yardstick, at the LM paths' shapes (``tiny_lm``, full-width
``llama3.2-1b``) and at S = 2048. Device time per call from
``chip_smoke.device_ms``. Roots, turns and output as in
``scripts/timing_turns.py``.
"""
from __future__ import annotations

import sys

from timing_turns import device_ms, main

SHAPES = {  # label: B, H, S, hd, KV (causal, dv = hd)
    "tiny_lm": (8, 4, 32, 16, 2),
    "llama3.2-1b": (4, 32, 256, 64, 8),
    "llama3.2-1b S=2048": (1, 32, 2048, 64, 8),
}


def measure() -> dict:
    import torch

    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for label, (B, H, S, hd, KV) in SHAPES.items():
        q, k, v, do = (torch.randn(s, generator=g, device="cuda")
                       for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
        o, lse = ops.flash_attention_with_lse(q, k, v)
        dsum = torch.sum(do * o, dim=-1)
        qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        o_lib = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
        out[label] = {
            "fwd": device_ms(lambda: ops.flash_attention_with_lse(q, k, v)),
            "bwd": device_ms(lambda: FB.flash_attention_bwd(q, k, v, o, lse, do)),
            "dq": device_ms(lambda: FB.flash_attention_dq(q, k, v, do, lse, dsum)),
            "dkv": device_ms(lambda: FB.flash_attention_dkv(q, k, v, do, lse, dsum)),
            "sdpa_fwd": device_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
            "sdpa_bwd": device_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do, retain_graph=True)),
        }
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, measure))
