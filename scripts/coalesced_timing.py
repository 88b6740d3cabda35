#!/usr/bin/env python3
"""Wall time of the coalesced path (``chip_smoke.py`` phase 3d) on one GPU.

    python3 scripts/coalesced_timing.py [SPEC ...]

A SPEC is ROOT (a checkout of this repository; default: this one),
optionally followed by ``::`` and server keyword arguments as
``key=value`` pairs joined by commas, e.g.
``.::refine_every=20``. Each spec runs in its own
process: it imports the port from ROOT's ``src`` (building that tree's
kernels), pretrains the broadcast RNN on the card (seed 0, untimed), runs
a 64-upload warm-up, then ``image_recognition`` at phase 3d's settings
(``chip_smoke.COALESCED``: 128 clients, 45 s windows, ``refine_every =
32``, 800 uploads, seed 0), timed on the host clock with the card
synchronized at both ends. Give specs in turns (``a b b a``) to compare on
one card. Prints the card's name and power limit, then one JSON line per
spec: wall seconds, uploads per second, host seconds inside
``handle_uploads``, and the run's ledger (uploads, bytes, events, server
events, final accuracy) so that the runs can be held to each other.
Imports no JAX.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import COALESCED  # noqa: E402


def parse(spec: str) -> tuple[str, dict]:
    root, _, opts = spec.partition("::")
    kw = {}
    for pair in filter(None, opts.split(",")):
        key, _, value = pair.partition("=")
        kw[key] = ast.literal_eval(value)
    return root, kw


def measure(root: str, server_kw: dict) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.core import server as server_mod
    from repro_torch.core.broadcast import pretrain_rnn
    from repro_torch.fl.experiment import run_experiment

    resolve_device("cuda")
    rnn = {k: v.cpu().numpy() for k, v in pretrain_rnn(0, device="cuda").items()}
    run_experiment("image_recognition", "echopfl", device="cuda", rnn_params=rnn,
                   **{**COALESCED, "max_uploads": 64}, **server_kw)

    spent = [0.0]
    handle = server_mod.EchoPFLServer.handle_uploads

    def timed(self, batch):
        t = time.perf_counter()
        try:
            return handle(self, batch)
        finally:
            spent[0] += time.perf_counter() - t

    server_mod.EchoPFLServer.handle_uploads = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, strat, rep = run_experiment("image_recognition", "echopfl", device="cuda", rnn_params=rnn,
                                      **COALESCED, **server_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    uploads = rep.extra["uploads"]
    return {"server_kw": server_kw, "wall_s": wall, "uploads_per_s": uploads / wall,
            "handle_uploads_s": spent[0], "uploads": uploads, "up_bytes": rep.up_bytes,
            "down_bytes": rep.down_bytes, "up_events": rep.up_events, "down_events": rep.down_events,
            "events": dict(Counter(e["kind"] for e in strat.events)),
            "decisions": rep.extra["decisions"], "rnn_broadcasts": rep.extra["rnn_broadcasts"],
            "final_acc": rep.final_acc}


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        root, kw = parse(args[1])
        print(json.dumps({"root": root, **measure(root, kw)}), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for spec in args or [str(REPO)]:
        res = subprocess.run([sys.executable, __file__, "--one", spec], capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{spec}: failed\n{res.stderr[-3000:]}", file=sys.stderr, flush=True)
            failed += 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
