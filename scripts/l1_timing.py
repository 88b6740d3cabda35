#!/usr/bin/env python3
"""Device time per call of the port's L1 and assign kernels on one GPU.

    python3 scripts/l1_timing.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in its own
process, builds that tree's kernels and times ``l1_distance``,
``l1_distance_pairwise``, ``pairwise_l1`` and ``assign_and_lerp`` at the
shapes of PERF.md's kernel table (the MLP main path's, and the LM delta's
width N = 783,360), beside ``torch.cdist(p=1)`` where it computes the same
function. ``ms``: summed kernel durations of a ``torch.profiler`` trace over
100 calls, per call (``chip_smoke.device_ms``); ``call_ms``: back-to-back calls between two CUDA
events, host overhead included. Give two roots in turns (``old new new
old``) to compare trees on one card. Prints the card's name and power limit
and one JSON line per root. Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import device_ms  # noqa: E402  (profiler sessions held to a full count)

CASES = (  # entry point, shape: (M, C, N) for the L1 rows, (C, N) for the assign
    ("l1_distance", (1, 4, 25418)),
    ("l1_distance", (1, 4, 783360)),
    ("l1_distance_pairwise", (3, 3, 25418)),
    ("pairwise_l1", (4, 4, 783360)),
    ("pairwise_l1", (8, 8, 2304)),
    ("assign_and_lerp", (4, 25418)),
    ("assign_and_lerp", (4, 783360)),
)


def call_ms(fn, iters: int = 200) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import ops

    resolve_device("cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    out = {"root": root}
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
