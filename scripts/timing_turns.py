"""The main loop shared by the kernel timing scripts (``scripts/*_timing.py``).

Each script defines ``measure() -> dict`` and hands it to :func:`main`:

    python3 scripts/<kernels>_timing.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in its
own process, ``measure`` imports the port from ROOT's ``src`` (so it builds
that tree's kernels) and times them on the card. Give roots in turns
(``old new new old``) to compare trees on one card. A script may offer other
measures as flags (``modes``: flag -> function), given before the roots.
Prints the card's name and power limit, then one JSON line per root, whose
``loaded`` names the tree the port was imported from; a root that fails to
build or run is reported and skipped, and the exit code is then 1. Device
time comes from ``chip_smoke.device_ms`` (profiler sessions held to a full count),
per-call time from ``chip_smoke.call_ms`` (CUDA events around back-to-back
calls, host overhead included). Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import call_ms, device_ms  # noqa: E402,F401  (the scripts' two clocks)


def main(script: str, measure, modes: dict | None = None) -> int:
    args = sys.argv[1:]
    flags = [a for a in args[:1] if a in (modes or {})]
    if flags:
        measure, args = modes[flags[0]], args[1:]
    if args[:1] == ["--one"]:
        sys.path.insert(0, str(Path(args[1]).resolve() / "src"))
        # chip_smoke imported this checkout's repro_torch (its H100 constants): drop it, so that ROOT's loads
        for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
            del sys.modules[name]
        import repro_torch
        from repro_torch.common.device import resolve_device

        resolve_device("cuda")
        loaded = str(Path(repro_torch.__file__).resolve().parents[2].relative_to(REPO, walk_up=True))
        print(json.dumps({"root": args[1], "loaded": loaded, **measure()}), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for root in args or [str(REPO)]:
        res = subprocess.run([sys.executable, script, *flags, "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{root}: failed\n{res.stderr[-3000:]}", file=sys.stderr, flush=True)
            failed += 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0
