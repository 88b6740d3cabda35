"""Build and load the hand-written CUDA kernels.

The kernels in ``src/repro_torch/csrc/*.cu`` have a plain C interface. At
first use this module compiles each source with ``nvcc`` for ``sm_90a``
(all sources at once, one process each), links the objects into one shared
library under ``build/repro_torch/`` at the repository root, and loads it
with :mod:`ctypes`. A hash of the sources and flags names the library, so an
unchanged tree loads the existing build instead of compiling again. A
failed build raises; nothing falls back to the plain PyTorch versions.

Nothing here runs at import time: the CPU tests import every module of the
package on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("l1.cu", "assign_lerp.cu", "ingest_chain.cu", "chi2.cu", "merge.cu", "uplink.cu", "rnn.cu",
           "flash_fwd.cu", "flash_bwd.cu", "flash_fwd_bf16.cu", "flash_bwd_bf16.cu")
HEADERS = ("common.cuh", "l1_rows.cuh", "flash_common.cuh", "mma_tf32.cuh", "wgmma_bf16.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # ptxas's resource lines and advisories (a serialized wgmma) into build_output
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
# B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap, q_pos0, device, stream
_FLASH_ARGS = [_I64] * 7 + [_F32, _INT, _I64, _F32, _I64, _INT, _P]
# C signature of every entry point: argtypes, restype
_SIGNATURES = {
    # x, c, out, scratch, M, C, N, chunks, device, stream
    "repro_l1_rows": ([_P] * 4 + [_I64] * 4 + [_INT, _P], _INT),
    # u, centers, C, N, chunks, beta, scratch, dists, idx, out, device, stream
    "repro_assign_lerp": ([_P, _P, _I64, _I64, _I64, ctypes.c_double] + [_P] * 4 + [_INT, _P], _INT),
    # U, centers, bcast, prev_forced, S, C, N, chunks, beta, margin, partials, stat_part, dists, cids,
    # stats, blended, carried, nstats (3, or 4 with the center norm), device, stream
    "repro_ingest_chain": ([_P] * 4 + [_I64] * 4 + [ctypes.c_double] * 2 + [_P] * 7 + [_INT, _INT, _P], _INT),
    # C, N, nstats, device, plan (3 int64: blocks, dynamic shared memory bytes, rows on chip)
    "repro_ingest_chain_plan": ([_I64, _I64, _INT, _INT, _P], _INT),
    # fp, ft, ss, seg, out, M, J, S, device, stream
    "repro_chi2": ([_P] * 5 + [_I64] * 3 + [_INT, _P], _INT),
    # vm, va, vt, N, out, device, stream
    "repro_merge_attention": ([_P, _P, _P, _I64, _P, _INT, _P], _INT),
    # plane, anchor_rows, mat, rec, B, n, chunk, device, stream
    "repro_uplink_int8": ([_P] * 4 + [_I64] * 3 + [_INT, _P], _INT),
    # plane, anchor_rows, resid_rows, mat, rec, ws, B, n, k, ws_ints, device, stream
    "repro_uplink_topk": ([_P] * 6 + [_I64] * 4 + [_INT, _P], _INT),
    # B, n, device, plan (2 int64: blocks a row, scratch ints)
    "repro_uplink_topk_plan": ([_I64, _I64, _INT, _P], _INT),
    # desc (24 int64: csrc/rnn.cu RnnDesc), the operands on the host, stream
    "repro_rnn_chain": ([_P, _P, _P], _INT),
    # T, device, plan (6 int64: dynamic shared memory bytes a block, scratch floats, threads a block,
    # blocks a cluster, registers a thread, local bytes a thread)
    "repro_rnn_chain_plan": ([_I64, _INT, _P], _INT),
    "repro_flash_fwd": ([_P] * 5 + _FLASH_ARGS, _INT),
    "repro_flash_dq": ([_P] * 7 + _FLASH_ARGS, _INT),
    "repro_flash_dkv": ([_P] * 8 + _FLASH_ARGS, _INT),
    # q, k, v, dout (may be null), hd, dv: 1 where bf16 flash launches copy by 16-byte cp.async
    "repro_flash_bf16_vec": ([_P] * 4 + [_I64, _I64], _INT),
    # hd, dv: a bf16 flash launch's dynamic shared memory in bytes
    "repro_flash_fwd_bf16_smem": ([_I64, _I64], _INT),
    "repro_flash_dq_bf16_smem": ([_I64, _I64], _INT),
    "repro_flash_dkv_bf16_smem": ([_I64, _I64], _INT),
}
# the bf16 instantiations take the fp32 entry points' arguments (pointers to bf16 rows)
_SIGNATURES.update({f"{name}_bf16": _SIGNATURES[name] for name in (
    "repro_l1_rows", "repro_assign_lerp", "repro_chi2", "repro_merge_attention", "repro_flash_fwd",
    "repro_flash_dq", "repro_flash_dkv")})

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last compile (None: loaded a cached build)
build_output: dict[str, str] = {}  # source -> what nvcc printed compiling it, from this process's compile


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``), or None."""
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return path if os.path.exists(path) else None


def nvcc() -> str:
    path = cuda_tool("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_DIR / f"librepro_torch_{_source_hash()}.so"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> None:
    exe = nvcc()
    tmp = lib_path.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for name in SOURCES:  # one nvcc per source, all running together
        obj = tmp / (Path(name).stem + ".o")
        objs.append(obj)
        cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, p in procs:
        out, _ = p.communicate()
        build_output[name] = out.decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed to compile the kernels:\n" + "\n".join(errors))
    staged = tmp / lib_path.name
    link = subprocess.run(
        [exe, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(staged),
         *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc failed to link the kernels:\n" + link.stdout.decode(errors="replace"))
    os.replace(staged, lib_path)  # atomic: a reader never sees a half-written library
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = library_path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(lib_path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIB = lib
        return lib


def stream(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device (read
    without building a ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index or 0)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")
