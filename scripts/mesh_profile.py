#!/usr/bin/env python3
"""Where the time of a model-mesh pass goes on one GPU.

    python3 scripts/mesh_profile.py

llama3.2-1b at full width (weights from a generator seeded 0) on the pod
mesh repeated over the card (256 shards, ``chip_smoke.py`` phase 3n's
cell): one prefill of 16 x 512 and one train step of 16 x 256 (AdamW,
remat), each after a warm-up call, each traced twice with
``torch.profiler``: once with CUDA activity only (``chip_smoke``'s
``_device_trace``: device busy time, kernels, the idle share of the wall
time) and once with CPU activity (the host's operator calls and their
self time). Prints one line a pass and the operators that take the most
host time.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def host_ops(run) -> tuple[int, float, list]:
    """(operator calls, their self CPU seconds, the top ten by self time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    calls = sum(e.count for e in rows)
    self_s = sum(e.self_cpu_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:10]
    return calls, self_s, [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in top]


def report(label: str, run, units: int) -> None:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof, _ = C._device_trace(run)
    events = C._device_events(prof)
    busy = sum(e.us for e in events) / 1e6
    kernels = len(events)
    calls, self_s, top = host_ops(run)
    print(f"{label}: wall {wall:.3f} s, device busy {busy:.4f} s (idle share {1 - busy / wall:.4f}), {kernels} "
          f"kernels ({kernels / units:.1f} a shard-layer-rank), {calls} aten calls ({calls / units:.1f} a "
          f"shard-layer-rank), their self CPU time {self_s:.3f} s")
    for key, count, ms in top:
        print(f"  {key:<32} {count:8d} calls {ms:10.1f} ms")


def main() -> int:
    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.lm import token_stream
    from repro_torch.kernels import _build
    from repro_torch.launch import sharded
    from repro_torch.launch.serve import place_params
    from repro_torch.models import dist
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import TrainState, make_optimizer, make_prefill_step, make_train_step

    dev = resolve_device("cuda")
    _build.library()  # the kernels are built before any pass is timed
    print("card:", C.sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"))
    cfg = get_config("llama3.2-1b")
    mesh = C._pod_on_card()
    units = 16 * cfg.num_layers * 16  # batch shards x layers x model ranks
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    placed = place_params(cfg, params, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (16, 512), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    prefill = make_prefill_step(cfg)
    with dist.use_mesh(mesh):
        report("prefill 16 x 512 on the pod mesh", lambda: prefill(placed, {"tokens": tokens}), units)
    del placed
    opt = make_optimizer(cfg)
    state = sharded.shard_state(cfg, TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                                                                      device=dev)), mesh)
    del params
    batch = next(token_stream(cfg.vocab_size, seed=0, batch=16, seq=256))
    step = make_train_step(cfg, opt)
    with dist.use_mesh(mesh):
        report("train step 16 x 256 on the pod mesh (remat)", lambda: step(state, batch), units)
    return 0


if __name__ == "__main__":
    sys.exit(main())
