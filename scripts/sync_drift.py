#!/usr/bin/env python3
"""Card against CPU on ``chip_smoke.py`` phase 3e's FedAsyn and FedAvg runs
(``image_recognition``, 20 clients, 1,800 s, seed 0, the same initial MLP
on both devices): the ledgers, the accuracy curves, and how far apart the
global vectors are after each upload (FedAsyn) or round (FedAvg).

Run from the repository root on a machine with a GPU:

    python3 scripts/sync_drift.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.baselines import FedAsyn, FedAvg  # noqa: E402
from repro_torch.common.device import resolve_device  # noqa: E402
from repro_torch.configs.paper_tasks import PAPER_TASKS  # noqa: E402
from repro_torch.fl.experiment import run_experiment  # noqa: E402
from repro_torch.models.mlp import init_mlp  # noqa: E402

CASES = (("fedasyn", FedAsyn, "handle_upload", dict(max_time=1800)),
         ("fedavg", FedAvg, "finish_round", dict(max_time=1800, rounds=40)))


def run(name, cls, method, kw, device, init):
    """One run with the global vector recorded after every ``method`` call."""
    vecs = []
    orig = getattr(cls, method)

    def rec(self, *a, **k):
        out = orig(self, *a, **k)
        vecs.append(self._vec.detach().cpu().numpy().copy())
        return out

    setattr(cls, method, rec)
    try:
        rep = run_experiment("image_recognition", name, num_clients=20, seed=0, device=device, init_params=init,
                             **kw)[3]
    finally:
        setattr(cls, method, orig)
    return vecs, rep


def main() -> int:
    if not torch.cuda.is_available():
        print("sync_drift: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    resolve_device("cuda")
    init = [{k: v.numpy() for k, v in layer.items()}
            for layer in init_mlp(PAPER_TASKS["image_recognition"], torch.Generator().manual_seed(0))]
    for name, cls, method, kw in CASES:
        (vc, rc), (vg, rg) = (run(name, cls, method, kw, dev, init) for dev in ("cpu", "cuda"))
        d = [float(np.abs(a - b).max()) for a, b in zip(vc, vg)]
        rel = [float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(vc, vg)]
        steps = sorted({0, 1, 2, 4, 9, 19, 49, 99, 199, len(d) - 1} & set(range(len(d))))
        same = rc.up_series == rg.up_series and rc.down_series == rg.down_series
        print(f"{name}: steps cpu {len(vc)} card {len(vg)}; ledger same {same}; final acc cpu {rc.final_acc:.4f} "
              f"card {rg.final_acc:.4f}; max |diff| of the global vector after step "
              + ", ".join(f"{i + 1}: {d[i]:.3g} (rel {rel[i]:.3g})" for i in steps))
        print(f"  curves cpu {[(t, round(a, 4)) for t, a in rc.curve][::3]}")
        print(f"  curves card {[(t, round(a, 4)) for t, a in rg.curve][::3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
