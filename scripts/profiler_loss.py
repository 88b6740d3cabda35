#!/usr/bin/env python3
"""How often a short ``torch.profiler`` session loses device kernels.

    python3 scripts/profiler_loss.py [SECONDS] [--after-main-path]

For SECONDS (default 60) on one GPU, profiles sessions of 50 calls each
(CUDA activity only, as ``chip_smoke.device_ms`` does), rotating over the
port's L1, assign and merge kernels, their plain versions and
``torch.cdist``, and three ways of opening a session: ``bare`` (the calls
right after the profiler starts, the exit right after a synchronize),
``padded`` (an idle host sleep of ``chip_smoke.PROFILER_PAD_S`` at each
end) and ``headed`` (``chip_smoke._device_trace``: padded, and headed by
``chip_smoke.PROFILER_HEAD_KERNELS`` spin kernels that are not counted).
With ``--after-main-path`` it first runs ``chip_smoke.main_path()``, after
which the profiler drops a session's first launches more often. The
profiler never records more kernels than ran, so a session is counted
``short`` when it holds fewer events than the most any session of the same
function held (``lost``: the events it lacks), and ``empty`` when it holds
none. Prints the card's name and power limit and one JSON line. Imports no
JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import PROFILER_PAD_S, _device_events, _device_trace  # noqa: E402

CALLS = 50


def session(fn, pad: float | None) -> int:
    """Events of one session of CALLS calls; ``pad`` None: ``_device_trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if pad is None:
        return len(_device_events(_device_trace(lambda: [fn() for _ in range(CALLS)])[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return len(_device_events(prof))


def main() -> int:
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import l1, ops

    args = [a for a in sys.argv[1:] if a != "--after-main-path"]
    seconds = float(args[0]) if args else 60.0
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    x8, x4, cs = (torch.randn(s, generator=g, device="cuda") for s in ((8, 2304), (4, 783360), (4, 25418)))
    u = cs[0].contiguous()
    vm, va = cs[1].contiguous(), cs[2].contiguous()
    fns = {
        "pairwise_l1 (8, 2304)": lambda: ops.pairwise_l1(x8),
        "pairwise_l1 plain (8, 2304)": lambda: l1.pairwise_l1_plain(x8),
        "cdist (8, 2304)": lambda: torch.cdist(x8, x8, p=1),
        "pairwise_l1 (4, 783360)": lambda: ops.pairwise_l1(x4),
        "l1_distance (1, 4, 25418)": lambda: ops.l1_distance(u, cs),
        "assign_and_lerp (4, 25418)": lambda: ops.assign_and_lerp(u, cs, 0.25),
        "merge_attention (25418,)": lambda: ops.merge_attention(vm, va, u),
    }
    if "--after-main-path" in sys.argv:
        from chip_smoke import main_path

        main_path()
    for fn in fns.values():
        fn()
    counts: dict[tuple[str, str], list[int]] = {}
    modes = (("bare", 0.0), ("padded", PROFILER_PAD_S), ("headed", None))
    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        name = list(fns)[(i // len(modes)) % len(fns)]
        mode, pad = modes[i % len(modes)]
        counts.setdefault((mode, name), []).append(session(fns[name], pad))
        i += 1
    full = {name: max(n for (_, nm), ns in counts.items() if nm == name for n in ns) for name in fns}
    out = {mode: Counter() for mode, _ in modes}
    for (mode, name), ns in counts.items():
        out[mode].update(sessions=len(ns), short=sum(n < full[name] for n in ns), empty=ns.count(0),
                         lost=sum(full[name] - n for n in ns))
    print(json.dumps({"seconds": seconds, "calls_per_session": CALLS, "full_events": full,
                      **{mode: dict(c) for mode, c in out.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
