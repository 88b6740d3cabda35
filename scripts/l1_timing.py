#!/usr/bin/env python3
"""Device time per call of the port's L1 and assign kernels on one GPU.

    python3 scripts/l1_timing.py [ROOT ...]

Times ``l1_distance``, ``l1_distance_pairwise``, ``pairwise_l1`` and
``assign_and_lerp`` at the shapes of PERF.md's kernel table (the MLP main
path's, and the LM delta's width N = 783,360), beside ``torch.cdist(p=1)``
where it computes the same function. ``ms``: device time per call
(``chip_smoke.device_ms``); ``call_ms``: per call, host overhead included.
Roots, turns and output as in ``scripts/timing_turns.py``.
"""
from __future__ import annotations

import sys

from timing_turns import call_ms, device_ms, main

CASES = (  # entry point, shape: (M, C, N) for the L1 rows, (C, N) for the assign
    ("l1_distance", (1, 4, 25418)),
    ("l1_distance", (1, 4, 783360)),
    ("l1_distance_pairwise", (3, 3, 25418)),
    ("pairwise_l1", (4, 4, 783360)),
    ("pairwise_l1", (8, 8, 2304)),
    ("assign_and_lerp", (4, 25418)),
    ("assign_and_lerp", (4, 783360)),
)


def measure() -> dict:
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for name, shape in CASES:
        lib = None
        if name == "assign_and_lerp":
            c, n = shape
            u, cs = (torch.randn(s, generator=g, device="cuda") for s in ((n,), (c, n)))
            fn = lambda: ops.assign_and_lerp(u, cs, 0.25)  # noqa: E731
        else:
            m, c, n = shape
            xs, cs = (torch.randn(s, generator=g, device="cuda") for s in ((m, n), (c, n)))
            u = xs[0].contiguous()
            fn = {"l1_distance": lambda: ops.l1_distance(u, cs),
                  "l1_distance_pairwise": lambda: ops.l1_distance_pairwise(xs, cs),
                  "pairwise_l1": lambda: ops.pairwise_l1(xs)}[name]
            lib = {"l1_distance": lambda: torch.cdist(u[None], cs, p=1),
                   "l1_distance_pairwise": lambda: torch.cdist(xs, cs, p=1),
                   "pairwise_l1": lambda: torch.cdist(xs, xs, p=1)}[name]
        key = f"{name} {tuple(shape)}"
        out[key] = {"ms": device_ms(fn), "call_ms": call_ms(fn)}
        if lib is not None:
            out[key].update(cdist_ms=device_ms(lib), cdist_call_ms=call_ms(lib))
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, measure))
