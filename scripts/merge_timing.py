#!/usr/bin/env python3
"""Device time per call of the port's merge kernel on one GPU.

    python3 scripts/merge_timing.py [ROOT ...]

Times ``merge_attention`` at the paths' rows: (25418,) ``image_recognition``
(the MLP main path), (4550,) ``har``, (2304,) ``tiny_lm``, (783360,) the
full-width LM delta, and (1,), the launch floor. ``ms``: device time per call
(``chip_smoke.device_ms``); ``call_ms``: per call with a fresh output;
``inplace_call_ms``: per call in place (``out=v_main``, as the server calls
it), where the tree's wrapper takes ``out``. Roots, turns and output as in
``scripts/timing_turns.py``.
"""
from __future__ import annotations

import inspect
import sys

from timing_turns import call_ms, device_ms, main

SHAPES = {"image_recognition": 25418, "har": 4550, "tiny_lm": 2304, "llama3.2-1b": 783360, "launch_floor": 1}


def measure() -> dict:
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(23)
    in_place = "out" in inspect.signature(ops.merge_attention).parameters
    out = {}
    for label, n in SHAPES.items():
        vm, va, vt = (torch.randn(n, generator=g, device="cuda") for _ in range(3))
        fn = lambda: ops.merge_attention(vm, va, vt)  # noqa: E731
        row = {"ms": device_ms(fn), "call_ms": call_ms(fn)}
        if in_place:
            row["inplace_call_ms"] = call_ms(lambda: ops.merge_attention(vm, va, vt, out=vm))
        out[f"{label} ({n},)"] = row
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, measure))
