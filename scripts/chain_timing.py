#!/usr/bin/env python3
"""Device time per call of the port's coalesced ingest chain on one GPU.

    python3 scripts/chain_timing.py [ROOT ...]

Times ``ingest_chain`` at phase 3d's most frequent segment (25, 4, 25418),
at (32, 4, 25418), at ``tiny_lm``'s row (16, 2, 2304) and at the LM delta's
width (4, 2, 783360), and over S = 1, 8, 32, 64 at C = 4, N = 25418, whose
least-squares slope is the cost of one step (``step_us``) and whose
intercept the launch's fixed cost (``fixed_us``). ``ms``: device time per
call (``chip_smoke.device_ms``); ``call_ms``: per call, host overhead
included. Inputs are ``chip_smoke.chain_inputs`` (vetoes, forced ids,
repeated winners). Roots, turns and output as in ``scripts/timing_turns.py``.

Before the turns it builds ``scripts/grid_sync_probe.cu`` with ``nvcc`` and
prints, on one JSON line, the cost of one step of a cooperative grid at 1,
7, 28 and 132 blocks of 256 threads: cooperative groups' grid barrier alone
(``barrier_us``), and with the chain's step skeleton around it, one partial
stored a block and every block's partial read back through L2
(``barrier_l2_us``), and a barrier of one release atomic a block and an
acquire spin on a generation word (``generation_barrier_us``): the slope
over 1 and 257 steps, from CUDA events.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from timing_turns import REPO, call_ms, device_ms, main

SHAPES = {"phase 3d's most frequent": (25, 4, 25418), "(32, 4, 25418)": (32, 4, 25418),
          "tiny_lm": (16, 2, 2304), "llama3.2-1b": (4, 2, 783360)}
SLOPE_STEPS, SLOPE_C, SLOPE_N = (1, 8, 32, 64), 4, 25418
PROBE_BLOCKS = (1, 7, 28, 132)  # 7: the chain's grid at C = 4, N = 25418


def _chain_fn(S: int, C: int, N: int):
    import torch

    from chip_smoke import chain_inputs
    from repro_torch.kernels import ops

    U, centers, bcast, prev, forced = chain_inputs(S, C, N, S * 31 + C)
    Ud, Cd, Bd = (torch.from_numpy(a).to("cuda") for a in (U, centers, bcast))
    return lambda: ops.ingest_chain(Ud, Cd, Bd, prev, forced, beta=0.25)


def measure() -> dict:
    out = {}
    for label, shape in SHAPES.items():
        fn = _chain_fn(*shape)
        out[f"{label} {shape}"] = {"ms": device_ms(fn), "call_ms": call_ms(fn, 50, 3)}
    slope = {S: device_ms(_chain_fn(S, SLOPE_C, SLOPE_N)) for S in SLOPE_STEPS}
    xs, ys = list(slope), [slope[S] * 1e3 for S in slope]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    step_us = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum((x - mx) ** 2 for x in xs)
    out[f"slope (S, {SLOPE_C}, {SLOPE_N})"] = {"ms": {str(S): ms for S, ms in slope.items()},
                                               "step_us": step_us, "fixed_us": my - step_us * mx}
    return out


def probe() -> dict:
    """Per-step cost of a bare grid barrier, and of the chain's step skeleton
    around it, at PROBE_BLOCKS blocks (CUDA events around 20 launches)."""
    import torch

    from repro_torch.kernels import _build

    lib_path = REPO / "build" / "grid_sync_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(REPO / "scripts" / "grid_sync_probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.grid_sync_probe.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.grid_sync_probe.restype = ctypes.c_int
    slab = torch.zeros(2 * max(PROBE_BLOCKS), device="cuda")
    res = torch.zeros(max(PROBE_BLOCKS), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def per_launch_us(blocks: int, steps: int, mode: int, launches: int = 20) -> float:
        def run():
            rc = lib.grid_sync_probe(blocks, steps, mode, slab.data_ptr(), res.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"grid_sync_probe failed to launch: cudaError {rc}")

        for _ in range(3):
            run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / launches

    out = {}
    for blocks in PROBE_BLOCKS:
        row = {}
        for mode, key in ((0, "barrier_us"), (1, "barrier_l2_us"), (2, "generation_barrier_us")):
            row[key] = (per_launch_us(blocks, 257, mode) - per_launch_us(blocks, 1, mode)) / 256
        out[str(blocks)] = row
    return out


if __name__ == "__main__":
    if sys.argv[1:2] != ["--one"]:
        sys.path.insert(0, str(REPO / "src"))
        import torch

        from repro_torch.common.device import resolve_device

        resolve_device("cuda")
        print(json.dumps({"grid_sync_probe": probe(), "card": torch.cuda.get_device_name(0)}), flush=True)
    sys.exit(main(__file__, measure))
