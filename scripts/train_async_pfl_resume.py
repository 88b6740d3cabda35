"""The EchoPFL transformer-client example killed and resumed, in the
reference and in the port, on the CPU: each client's first and last round
loss in the killed half and in the resumed half, and whether the
example's closing assertion (every client's loss falls) holds in each.

    PYTHONPATH=src python scripts/train_async_pfl_resume.py [--kill 150] [--steps 300]

The reference runs ``examples/train_async_pfl.py``'s loop as
``tests/test_torch_train_async_pfl.py`` replays it (a server checkpoint
every ``--kill`` rounds); the port runs ``repro_torch.launch.train_async_pfl``
with the reference's initial weights and broadcast RNN. A resumed run
restores only the server and replays each client's token stream from its
start, in both packages.
"""
import argparse
import os
import sys
import tempfile

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
import test_torch_train_async_pfl as parity  # noqa: E402
from repro_torch.launch import train_async_pfl as example  # noqa: E402


def _halves(label: str, runs: list) -> None:
    for part, out in zip(("killed", "resumed"), runs):
        first = {i: v[0] for i, v in out["losses"].items() if v}
        last = {i: v[-1] for i, v in out["losses"].items() if v}
        ok = all(last[i] < first[i] for i in last)
        print(f"{label} {part} (rounds {out['start']}..{out['start'] + len(out['order'])}): "
              f"{ {i: (round(first[i], 4), round(last[i], 4)) for i in first} }, assertion holds: {ok}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kill", type=int, default=150)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    parity.EVERY = args.kill
    with tempfile.TemporaryDirectory() as tmp:
        ref = [parity.reference_example(os.path.join(tmp, "ref"), rounds=args.kill),
               parity.reference_example(os.path.join(tmp, "ref"), rounds=args.steps, resume=True)]
        _halves("reference", ref)
        _, init, _ = parity._reference_setup()
        kw = dict(init_params=jax.tree_util.tree_map(np.asarray, init), verbose=False, ckpt_every=args.kill,
                  rnn_params={k: np.asarray(v) for k, v in ref[0]["server"]._rnn_init.items()},
                  ckpt_dir=os.path.join(tmp, "port"))
        port = [example.run("cpu", steps=args.kill, **kw), example.run("cpu", steps=args.steps, resume=True, **kw)]
        _halves("port", port)


if __name__ == "__main__":
    main()
