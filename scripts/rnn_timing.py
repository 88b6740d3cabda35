#!/usr/bin/env python3
"""Device and per-call times of the port's broadcast RNN kernel on one GPU.

    python3 scripts/rnn_timing.py [ROOT ...]

Times ``csrc/rnn.cu`` through ``kernels/rnn.py`` at the main path's shapes:
a per-event learn and a decision at (S, T) = (1, 10), a per-event upload's
learn and decision (one ``rnn_step`` launch where the tree has it, else a
``rnn_sgd`` call then a ``rnn_want`` call), a (1, 10) chain that learns and
decides (phase 3d's most frequent), the same chain at a window of 128 (past
104 records the kernel runs as a cluster of two blocks), and the (1,200, 10)
pretraining, with the launch plans (registers, spills) at windows of 10 and
128. ``ms``: device time per call (``chip_smoke.device_ms``: the kernel and
its operand copy); ``call_ms``: per call with the host's overhead. ``host
learn`` and ``host upload`` split a per-event call's host time into its
parts (``chip_smoke.rnn_host_split``: entry, checks and packing, copy,
allocation, the C call, views), in microseconds. Roots, turns and output as in
``scripts/timing_turns.py``.
"""
from __future__ import annotations

import sys

from timing_turns import call_ms, device_ms, main

from chip_smoke import rnn_host_split  # noqa: E402  (after timing_turns puts the repository on the path)

T, LR, PRETRAIN_LR = 10, 1e-2, 5e-3


def _rows(rnn, bc) -> dict:
    import numpy as np
    import torch

    p = bc.init_rnn(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(10)
    pre, post = (rng.uniform(0, 1, (T, 1)).astype(np.float32) for _ in range(2))
    if hasattr(rnn, "rnn_step"):
        upload = lambda: rnn.rnn_step(p, pre, post, 1, LR)  # noqa: E731
    else:
        def upload():
            q, _ = rnn.rnn_sgd(p, pre, 1, LR)
            return rnn.rnn_want(q, post)
    one = np.ones(1, bool)
    chain = lambda: rnn.rnn_chain(p, pre[None], post[None], np.ones((1, 2), np.int64), None, one, one, ~one, LR)  # noqa
    long_pre, long_post = (rng.uniform(0, 1, (1, 128, 1)).astype(np.float32) for _ in range(2))
    long = lambda: rnn.rnn_chain(p, long_pre, long_post, np.ones((1, 2), np.int64), None, one, one, ~one, LR)  # noqa
    windows, labels = bc.pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    pretrain = lambda: rnn.rnn_chain(p, windows, None, labels, None, learn, ~learn, ~learn, PRETRAIN_LR)  # noqa
    cases = {"learn (1, 10)": lambda: rnn.rnn_sgd(p, pre, 1, LR), "decision (1, 10)": lambda: rnn.rnn_want(p, post),
             "upload learn + decision (1, 10)": upload, "chain learn + decision (1, 10)": chain,
             "chain learn + decision (1, 128)": long}
    out = {k: {"ms": device_ms(f, 100), "call_ms": call_ms(f, 200, 3)} for k, f in cases.items()}
    out["pretraining (1200, 10)"] = {"ms": device_ms(pretrain, 2), "call_ms": call_ms(pretrain, 3, 3)}
    out["host learn"] = rnn_host_split(rnn, cases["learn (1, 10)"])
    out["host upload"] = rnn_host_split(rnn, upload) if hasattr(rnn, "rnn_step") else None
    return out


def measure() -> dict:
    from repro_torch.core import broadcast as bc
    from repro_torch.kernels import rnn

    return {"plan": {t: rnn.plan(t) for t in (T, 128)}, **_rows(rnn, bc)}


if __name__ == "__main__":
    sys.exit(main(__file__, measure))
