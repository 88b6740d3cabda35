#!/usr/bin/env python3
"""The JAX reference's fault and defense sweeps at one rate, live, beside
the stored ``BENCH_faults.json`` and ``BENCH_defense.json``: which stored
fields does the reference reproduce today?

Calls ``benchmarks/bench_faults.py::_run`` (retry and drop arms: ``har``,
32 clients, 2,400 s, 30 s windows) and ``benchmarks/bench_defense.py::_run``
(guard off and on, per event and at 30 s: 16 clients, 1,800 s) for seeds
0-2, takes the seed means as the benches do, and prints each field beside
the stored one with ``same`` where they are equal (byte fields compared as
the total bytes over the seeds). The stored files are only read. This is
the reference on the CPU; ``chip_smoke.py`` phase 3h holds the port on the
card to the fields marked here.

With ``--port`` it also runs each arm and seed through the port on the CPU
with the port's own weights (its seeded initial MLP and a broadcast RNN it
pretrains from seed 0), as phase 3h does on the card, and prints the
fields where a seed differs from the reference's: those depend on the
weights, through the broadcasts.

    PYTHONPATH=src python scripts/chaos_reference.py [--rate 0.1] [--port]   (about 3 min, 5 with --port)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
for name in [k for k in os.environ if k.startswith("REPRO_")]:
    del os.environ[name]  # explicit arguments only: no ambient knob

from benchmarks import bench_defense, bench_faults  # noqa: E402

SEEDS = (0, 1, 2)


def _same(key: str, got: float, want: float) -> bool:
    if key.endswith("_MB"):
        return round(got * 1e6 * len(SEEDS)) == round(want * 1e6 * len(SEEDS))
    return got == want


def _report(label: str, runs: list[dict], stored: dict) -> None:
    for key, want in stored.items():
        if key == "final_acc_by_seed":
            continue
        if key == "quarantine":
            for q, w in want.items():
                got = sum(r["quarantine"][q] for r in runs) / len(runs)
                print(f"{label} quarantine.{q}: {got} (stored {w}){'  same' if got == w else ''}")
            continue
        vals = [r[key] for r in runs]
        got = any(vals) if key == "any_nan_acc" else sum(vals) / len(vals)
        print(f"{label} {key}: {got} (stored {want}){'  same' if _same(key, got, want) else ''}")


def _port_arm(label: str, runs: list[dict], arm) -> None:
    """Each seed through the port on the CPU with its own weights (``arm(seed)``
    -> chip_smoke's ``chaos_run`` result), beside the reference's run."""
    for seed, ref in zip(SEEDS, runs):
        mine = arm(seed)
        differ = {k: (mine[k], ref[k]) for k in ref if k != "quarantine" and k in mine and mine[k] != ref[k]}
        print(f"{label} seed {seed}, port with its own weights: differs in {differ}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    rate = args.rate
    stored_f = json.loads((ROOT / "BENCH_faults.json").read_text())["by_rate"][str(rate)]
    stored_d = json.loads((ROOT / "BENCH_defense.json").read_text())["by_rate"][str(rate)]
    if args.port:
        import chip_smoke
        from repro_torch.core.broadcast import pretrain_rnn

        chip_smoke.DEVICE = "cpu"
        rnn = {k: v.numpy() for k, v in pretrain_rnn(0, device="cpu").items()}
    for policy in ("retry", "drop"):
        runs = [bench_faults._run(32, rate, policy, 2400.0, seed=s) for s in SEEDS]
        _report(f"faults {policy}", runs, stored_f[policy])
        if args.port:
            _port_arm(f"faults {policy}", runs, lambda s: chip_smoke.chaos_run(
                32, s, 30.0, 2400.0, chip_smoke._fault_plan(rate, policy, seed=s), None, rnn))
    for wname, window in (("coalesced", 30.0), ("per_event", 0.0)):
        for arm, guard in (("guard_off", False), ("guard_on", True)):
            runs = [bench_defense._run(16, rate, guard, 1800.0, seed=s, window=window) for s in SEEDS]
            _report(f"defense {wname} {arm}", runs, stored_d[wname][arm])
            if args.port:
                _port_arm(f"defense {wname} {arm}", runs, lambda s: chip_smoke.chaos_run(
                    16, s, window, 1800.0, chip_smoke._fault_plan(0.0, poison=rate, seed=s),
                    "on" if guard else "off", rnn))


if __name__ == "__main__":
    main()
