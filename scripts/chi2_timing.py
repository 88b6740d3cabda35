#!/usr/bin/env python3
"""Device time per call of the port's chi-squared feedback kernels on one GPU.

    python3 scripts/chi2_timing.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in its own
process, builds that tree's kernels and times ``chi2_feedback`` and
``chi2_feedback_segmented`` at the shapes of PERF.md's kernel table: the MLP
main path's (4, 10) probes and (20, 10), S = 4 refine, the 128-client
fleet's refine, (128, 10) with S = 16, and (1, 1) with S = 1, the launch
floor. ``ms``: summed kernel durations of a ``torch.profiler`` trace over
100 calls, per call (``chip_smoke.device_ms``); ``call_ms``: back-to-back
calls between two CUDA events, host overhead included. Give roots in turns
(``old new new old``) to compare trees on one card; a root that fails to
build or run is reported and skipped. Prints the card's name and power
limit and one JSON line per root. Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import device_ms  # noqa: E402  (profiler sessions held to a full count)

CASES = (  # entry point, (M, J) or (M, J, S)
    ("chi2_feedback", (4, 10)),
    ("chi2_feedback_segmented", (20, 10, 4)),
    ("chi2_feedback_segmented", (128, 10, 16)),
    ("chi2_feedback_segmented", (1, 1, 1)),
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
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {"root": root}
    for name, shape in CASES:
        m, j = shape[:2]
        fp = torch.rand((m, j), generator=g, device="cuda") * 30
        ft = torch.rand((m, j), generator=g, device="cuda") * 30 + 1.0
        ss = torch.softmax(torch.randn((m, j), generator=g, device="cuda"), dim=-1)
        if name == "chi2_feedback":
            fn = lambda: ops.chi2_feedback(fp, ft, ss)  # noqa: E731
        else:
            seg = torch.arange(m, device="cuda", dtype=torch.int32) % shape[2]
            fn = lambda: ops.chi2_feedback_segmented(fp, ft, ss, seg, shape[2])  # noqa: E731
        out[f"{name} {tuple(shape)}"] = {"ms": device_ms(fn), "call_ms": call_ms(fn)}
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for root in roots:
        res = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{root}: failed\n{res.stderr[-3000:]}", file=sys.stderr, flush=True)
            failed += 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
