#!/usr/bin/env python3
"""Does a client's training NLL fall under the top-k uplink? The reference
and the port on ``tiny_lm`` (EchoPFL, 8 clients, 900 s, 120 s evaluations,
seed 0, per event), the port given the reference's base, initial delta and
broadcast RNN, each with ``uplink="topk"`` and with no codec.

Each client's first and last trained delta (its own model, what
``ClientFleet.train_client`` returns) is recorded in both packages; the mean
next-token NLL of each on the client's training set is taken with the
port's ``tiny_lm`` task on the CPU, for both packages' deltas alike. Prints
one line a client: first and last NLL in the reference and in the port,
and which of them rose. ``chip_smoke.py``'s falling-NLL gate asks the
last to be below the first.

    PYTHONPATH=src python scripts/topk_nll_check.py   (about 1 min)
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
for name in [k for k in os.environ if k.startswith("REPRO_")]:
    del os.environ[name]  # explicit arguments only: no ambient knob

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn  # noqa: E402
from repro.fl import fleet as jax_fleet  # noqa: E402
from repro.fl.lm_task import default_lm_task as jax_default_lm_task  # noqa: E402
from repro.fl.lm_task import run_lm_experiment as jax_run_lm_experiment  # noqa: E402
from repro_torch.fl import fleet as port_fleet  # noqa: E402
from repro_torch.fl.lm_task import run_lm_experiment  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402

KW = dict(num_clients=8, max_time=900, eval_interval=120, seed=0)


def _recording(cls):
    """Wrap ``cls.train_client`` to keep each client's first and last delta."""
    first, last = {}, {}
    fn = cls.train_client

    def rec(self, cid):
        params, loss = fn(self, cid)
        params = jax.tree_util.tree_map(np.asarray, params) if cls is jax_fleet.ClientFleet else params
        first.setdefault(cid, params)
        last[cid] = params
        return params, loss

    cls.train_client = rec
    return first, last, lambda: setattr(cls, "train_client", fn)


def main() -> None:
    import chip_smoke

    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np, delta_np = to_np(jtask.base.params), to_np(jtask.init_params(jax.random.PRNGKey(0)))
    rnn_np = to_np(jax_pretrain_rnn(jax.random.PRNGKey(0)))
    for uplink in ("topk", None):
        jf, jl, undo = _recording(jax_fleet.ClientFleet)
        try:
            jax_run_lm_experiment("echopfl", uplink=uplink, **KW)
        finally:
            undo()
        tf_, tl, undo = _recording(port_fleet.ClientFleet)
        try:
            task, clients, _, _ = run_lm_experiment("echopfl", device="cpu", base_params=base_np,
                                                    init_params=delta_np, rnn_params=rnn_np, uplink=uplink, **KW)
        finally:
            undo()
        as_port = lambda by: {c: tree_from_numpy(v) for c, v in by.items()}  # noqa: E731
        nll = {name: chip_smoke.upload_nll(task, clients, by).numpy()
               for name, by in (("ref first", as_port(jf)), ("ref last", as_port(jl)), ("port first", tf_),
                                ("port last", tl))}
        print(f"uplink {uplink or 'none'}:")
        for i, c in enumerate(clients):
            ref_up = nll["ref last"][i] >= nll["ref first"][i]
            port_up = nll["port last"][i] >= nll["port first"][i]
            print(f"  client {c.client_id}: reference {nll['ref first'][i]:.6f} -> {nll['ref last'][i]:.6f}"
                  f"{' (rose)' if ref_up else ''}; port {nll['port first'][i]:.6f} -> {nll['port last'][i]:.6f}"
                  f"{' (rose)' if port_up else ''}")


if __name__ == "__main__":
    main()
