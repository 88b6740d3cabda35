#!/usr/bin/env python3
"""Device time per call of the port's chi-squared feedback kernels on one GPU.

    python3 scripts/chi2_timing.py [ROOT ...]

Times ``chi2_feedback`` and ``chi2_feedback_segmented`` at the shapes of
PERF.md's kernel table: the MLP main path's (4, 10) probes and (20, 10),
S = 4 refine, the 128-client fleet's refine, (128, 10) with S = 16, and
(1, 1) with S = 1, the launch floor. ``ms``: device time per call
(``chip_smoke.device_ms``); ``call_ms``: per call, host overhead included.
Roots, turns and output as in ``scripts/timing_turns.py``.
"""
from __future__ import annotations

import sys

from timing_turns import call_ms, device_ms, main

CASES = (  # entry point, (M, J) or (M, J, S)
    ("chi2_feedback", (4, 10)),
    ("chi2_feedback_segmented", (20, 10, 4)),
    ("chi2_feedback_segmented", (128, 10, 16)),
    ("chi2_feedback_segmented", (1, 1, 1)),
)


def measure() -> dict:
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
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


if __name__ == "__main__":
    sys.exit(main(__file__, measure))
