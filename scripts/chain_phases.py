#!/usr/bin/env python3
"""Where a step of the ingest chain kernel spends its time, on one GPU.

    python3 scripts/chain_phases.py [NAME=path/to/ingest_chain.cu ...]

Copies the kernel source (default: this tree's
``src/repro_torch/csrc/ingest_chain.cu``), adds ``clock64()`` stamps that
thread 0 of block 0 takes at the phase boundaries, builds the copy with
``nvcc`` under ``build/chain_phases/`` and runs it at (S, C, N) = (32, 4,
25418), (25, 4, 25418) and (16, 2, 2304) on ``chip_smoke.chain_inputs``.
Prints one JSON line per source and shape, in microseconds (the clock rate
from ``%globaltimer`` over the launch), each step phase the median over
steps 1 .. S - 1 of 5 launches after 3 warm-ups:

- ``wait``: from the end of the previous step to the upload's chunk in
  shared memory; ``dist``: the distance partials, to the grid sync
  (``dist_loads`` up to the warp butterflies, ``dist_tree`` the rest);
- ``barrier``: the grid sync; ``argmin``: the distances from L2, the argmin,
  veto and forced index (``argmin_l2`` up to the warps' candidates);
- ``blend``: the chosen row's blend and its statistics' partials; ``step``;
- once a launch: ``setup`` (staging the rows), ``first_wait``, ``tail``
  (the rows' write-out), ``final_barrier``, ``stats``, ``total``.

``bitwise_as_port``: the copy's outputs equal ``ops.ingest_chain``'s of this
tree bit for bit. The stamps cost a few registers and instructions, so the
phases add up to slightly more than ``scripts/chain_timing.py``'s step.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"
SHAPES = ((32, 4, 25418), (25, 4, 25418), (16, 2, 2304))
MAX_STEPS = 128  # steps stamped; a launch's later steps share the last row
TAIL = 2 + 8 * MAX_STEPS  # stamp slots after the steps'

PREAMBLE = f"""
__device__ long long g_stamps[{TAIL + 3}];
__device__ unsigned long long g_gt[2];
__device__ __forceinline__ unsigned long long gtimer() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(i) do {{ if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[(i)] = clock64(); }} while (0)
"""

READ = f"""
REPRO_API int phases_clear() {{
  static long long zeros[{TAIL + 3}];
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros)));
}}
REPRO_API int phases_read(long long* stamps, unsigned long long* gt) {{
  cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(long long) * {TAIL + 3});
  return static_cast<int>(cudaMemcpyFromSymbol(gt, g_gt, sizeof(unsigned long long) * 2));
}}
"""


def instrument(text: str) -> str:
    """The kernel source with the stamps; each anchor must match once."""
    s = text.replace('#include "l1_rows.cuh"', '#include "l1_rows.cuh"\n' + PREAMBLE, 1)

    def sub(pattern: str, repl: str, required: bool = True) -> None:
        nonlocal s
        s, k = re.subn(pattern, repl, s, count=1, flags=re.S)
        if required and k != 1:
            raise ValueError(f"chain_phases: no anchor {pattern!r} in the kernel source")

    sub(r"(cg::grid_group grid = cg::this_grid\(\);)",
        r"\1\n  if (blockIdx.x == 0 && threadIdx.x == 0) g_gt[0] = gtimer();\n  STAMP(0);")
    sub(r"  cp_async_commit\(\);\n\n  for \(int64_t j = 0; j < steps; \+\+j\) \{",
        "  cp_async_commit();\n  STAMP(1);\n\n  for (int64_t j = 0; j < steps; ++j) {\n"
        f"    const int64_t sj = 2 + 8 * (j < {MAX_STEPS - 1} ? j : {MAX_STEPS - 1});")
    sub(r"(    if \(on_chip\) cp_async_wait_all\(\);[^\n]*\n)", r"\1    STAMP(sj + 0);\n")
    sub(r"\n    grid\.sync\(\);\n", "\n    STAMP(sj + 1);\n    grid.sync();\n    STAMP(sj + 2);\n")
    sub(r"(    if \(blockIdx\.x == 0 && threadIdx\.x == 0\) cids\[j\] = cid;\n)", r"\1    STAMP(sj + 3);\n")
    sub(r"(      repro::store_partials<1, 3>\(spart[^\n]*\n)", r"\1      STAMP(sj + 4);\n")
    sub(r"(      warp_sum_n\(acc\);\n)", r"      STAMP(sj + 6);\n\1", required=False)
    sub(r"(    if \(lane == 0\) \{\n      best_v\[wid\] = bv;)", r"    STAMP(sj + 7);\n\1", required=False)
    sub(r"  grid\.sync\(\);\n  // the statistics",
        f"  STAMP({TAIL});\n  grid.sync();\n  STAMP({TAIL + 1});\n  // the statistics")
    sub(r"(    if \(lane == 0\) stats\[o\] = s;\n  \}\n)\}",
        f"\\1  STAMP({TAIL + 2});\n  if (blockIdx.x == 0 && threadIdx.x == 0) g_gt[1] = gtimer();\n}}")
    s = s.replace("repro_ingest_chain_plan", "phases_chain_plan").replace("repro_ingest_chain", "phases_chain")
    return s + READ


def build(name: str, path: Path, nvcc: str) -> ctypes.CDLL:
    out = REPO / "build" / "chain_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(instrument(path.read_text()))
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.phases_chain.argtypes = [P] * 4 + [I64] * 4 + [ctypes.c_double] * 2 + [P] * 7 + [ctypes.c_int, P]
    lib.phases_read.argtypes = [P, P]
    return lib


def run(lib: ctypes.CDLL, S: int, C: int, N: int) -> dict:
    import numpy as np
    import torch

    from chip_smoke import chain_inputs
    from repro_torch.kernels import ops
    from repro_torch.kernels.l1 import l1_chunks

    U, centers, bcast, prev, forced = chain_inputs(S, C, N, S * 31 + C)
    Ud, Cd, Bd = (torch.from_numpy(a).cuda() for a in (U, centers, bcast))
    chunks = l1_chunks(N)
    idx = torch.tensor(prev + forced, dtype=torch.int32, device="cuda")
    scratch = torch.empty(2 * chunks * C + S * chunks * 3, device="cuda")
    dists, cids = torch.empty(S, C, device="cuda"), torch.empty(S, dtype=torch.int32, device="cuda")
    stats, blended, carried = (torch.empty(S, 3, device="cuda"), torch.empty(S, N, device="cuda"),
                               torch.empty(C, N, device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for rep in range(8):
        torch.cuda.synchronize()
        lib.phases_clear()
        rc = lib.phases_chain(Ud.data_ptr(), Cd.data_ptr(), Bd.data_ptr(), idx.data_ptr(), S, C, N, chunks, 0.25,
                              0.1, scratch.data_ptr(), scratch.data_ptr() + 4 * 2 * chunks * C, dists.data_ptr(),
                              cids.data_ptr(), stats.data_ptr(), blended.data_ptr(), carried.data_ptr(), 0, stream)
        if rc != 0:
            raise RuntimeError(f"chain_phases: launch failed, cudaError {rc}")
        torch.cuda.synchronize()
        stamps, gt = np.zeros(TAIL + 3, np.int64), np.zeros(2, np.uint64)
        lib.phases_read(stamps.ctypes.data, gt.ctypes.data)
        if rep < 3:
            continue
        per_ns = (stamps[TAIL + 2] - stamps[0]) / float(gt[1] - gt[0])
        us = lambda c: float(c) / per_ns / 1e3  # noqa: E731
        P = stamps[2:2 + 8 * S].reshape(S, 8)
        prev_end = np.concatenate([[stamps[1]], P[:-1, 4]])
        phase = {"wait": P[:, 0] - prev_end, "dist": P[:, 1] - P[:, 0], "barrier": P[:, 2] - P[:, 1],
                 "argmin": P[:, 3] - P[:, 2], "blend": P[:, 4] - P[:, 3]}
        if P[1, 6]:
            phase.update(dist_loads=P[:, 6] - P[:, 0], dist_tree=P[:, 1] - P[:, 6])
        if P[1, 7]:
            phase["argmin_l2"] = P[:, 7] - P[:, 2]
        row = {k: us(np.median(v[1:])) for k, v in phase.items()}
        row.update(step=us(np.median(np.diff(P[:, 4]))), setup=us(stamps[1] - stamps[0]),
                   first_wait=us(P[0, 0] - stamps[1]), tail=us(stamps[TAIL] - P[-1, 4]),
                   final_barrier=us(stamps[TAIL + 1] - stamps[TAIL]), stats=us(stamps[TAIL + 2] - stamps[TAIL + 1]),
                   total=us(stamps[TAIL + 2] - stamps[0]), ghz=per_ns)
        rows.append(row)
    ref = ops.ingest_chain(Ud, Cd, Bd, prev, forced, beta=0.25)
    same = torch.equal(ref.cids, cids) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in ((ref.blended, blended), (ref.carried, carried), (ref.dists, dists), (ref.stats, stats)))
    return {**{k: float(np.median([r[k] for r in rows])) for k in rows[0]}, "bitwise_as_port": bool(same)}


def main() -> int:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sources = [a.split("=", 1) for a in sys.argv[1:]] or [["port", str(CSRC / "ingest_chain.cu")]]
    for name, path in sources:
        lib = build(name, Path(path), _build.nvcc())
        for shape in SHAPES:
            row = run(lib, *shape)
            print(json.dumps({"source": name, "shape": list(shape),
                              **{k: round(v, 3) if isinstance(v, float) else v for k, v in row.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
