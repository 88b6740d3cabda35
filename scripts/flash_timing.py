#!/usr/bin/env python3
"""Device time per call of the port's flash-attention kernels on one GPU.

    python3 scripts/flash_timing.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in its own
process, builds that tree's kernels and times the flash forward, the
backward (``D`` pre-pass, dq and dkv) and each backward kernel alone, beside
fp32 ``scaled_dot_product_attention`` and its backward as a yardstick, at
the LM paths' shapes (``tiny_lm``, full-width ``llama3.2-1b``) and at
S = 2048. Device time is the summed kernel durations of a ``torch.profiler``
trace over 100 calls (``chip_smoke.device_ms``). Give two roots in turns (``old new new old``) to
compare trees on one card. Prints the card's name and power limit and one
JSON line per root. Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import device_ms  # noqa: E402  (profiler sessions held to a full count)

SHAPES = {  # label: B, H, S, hd, KV (causal, dv = hd)
    "tiny_lm": (8, 4, 32, 16, 2),
    "llama3.2-1b": (4, 32, 256, 64, 8),
    "llama3.2-1b S=2048": (1, 32, 2048, 64, 8),
}


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops

    resolve_device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {"root": root}
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


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for root in roots:
        res = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
