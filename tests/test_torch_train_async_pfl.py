"""The EchoPFL transformer-client example (``repro_torch.launch.train_async_pfl``)
against the reference's ``examples/train_async_pfl.py``, on the CPU.

The reference's loop is replayed here with its own functions (its
``main`` writes under a fixed directory and takes no weights): reduced
llama3.2-1b (d_model 64, 2 periods), 4 clients on two token streams, 5
jitted AdamW steps a round, ``EchoPFLServer(init, num_initial_clusters=2,
seed=0)``, arrivals from ``default_rng(0)``, a server checkpoint every 20
rounds (the example's 50, moved so that 40 rounds hold one mid-run). The
port gets the reference's initial weights and its server's pretrained
broadcast RNN. Over 40 rounds: the same arrival order; after every round
the same assignment and the same counts of clusters, broadcasts and
merges; each client's round losses within rtol 1e-4 (fp32 rounding of the
same steps through two packages, 200 AdamW steps, compounded by the
server's blends). A server checkpoint at round 20 written by either
package resumes in the other: the port resumed from the reference's
checkpoint makes the decisions of the reference resumed from the port's,
and both resumed runs start their clients and arrivals afresh, as the
example does.
"""
import functools
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.checkpoint.checkpointer import latest_step as jax_latest_step
from repro.checkpoint.checkpointer import restore_pytree as jax_restore_pytree
from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.configs.base import reduced_config as jax_reduced
from repro.core.server import EchoPFLServer as JaxServer
from repro.data.lm import token_stream as jax_token_stream
from repro.models import init_params as jax_init_params
from repro.models import make_train_step as jax_train_step
from repro.models.steps import TrainState as JaxTrainState
from repro.models.steps import make_optimizer as jax_make_optimizer
from repro_torch.launch import train_async_pfl as example
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ROUNDS, EVERY, CLIENTS, LOSS_RTOL = 40, 20, 4, 1e-4


@functools.lru_cache(maxsize=None)
def _reference_setup():
    cfg = jax_reduced(JAX_ARCHS["llama3.2-1b"], d_model=64, periods=2)
    init = jax_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, init, jax.jit(jax_train_step(cfg))


def reference_example(ckpt_dir: str, rounds: int = ROUNDS, resume: bool = False, rnn_key=None) -> dict:
    """``examples/train_async_pfl.py``'s loop with a checkpoint every
    ``EVERY`` rounds, recording what the port's ``run`` returns."""
    cfg, init, train_step = _reference_setup()
    opt = jax_make_optimizer(cfg)
    streams = [jax_token_stream(cfg.vocab_size, seed=i % 2, batch=4, seq=32) for i in range(CLIENTS)]
    states = [JaxTrainState(init, opt.init(init), jnp.zeros((), jnp.int32)) for _ in range(CLIENTS)]
    server = JaxServer(init, num_initial_clusters=2, seed=0, pretrain_key=rnn_key)
    ck = JaxCheckpointer(ckpt_dir, keep=2)
    start = 0
    if resume:
        step = jax_latest_step(ckpt_dir)
        d = os.path.join(ckpt_dir, f"step_{step:010d}")
        _, extra = jax_restore_pytree(d, like=None)
        template = {"server": server.state_template(extra["server_meta"])}
        tree, extra = jax_restore_pytree(d, like=template)
        server.load_state(tree["server"], extra["server_meta"])
        start = step
    t0 = time.time()
    losses = {i: [] for i in range(CLIENTS)}
    order, history = [], []
    rng = np.random.default_rng(0)
    for rnd in range(start, rounds):
        cid = int(rng.integers(CLIENTS))
        order.append(cid)
        st = states[cid]._replace(params=server.model_for(cid))
        loss = None
        for _ in range(5):
            st, metrics = train_step(st, next(streams[cid]))
            loss = float(metrics["loss"])
        states[cid] = st
        losses[cid].append(loss)
        for dl in server.handle_upload(cid, st.params, 0, 128, t=time.time() - t0):
            states[dl.client_id] = states[dl.client_id]._replace(params=dl.params)
        stats = server.stats()
        history.append({"round": rnd + 1, "assignment": [server.clustering.assignment.get(i) for i in range(CLIENTS)],
                        "clusters": stats["clusters"], "broadcasts": stats["broadcasts"], "merges": stats["merges"]})
        if (rnd + 1) % EVERY == 0:
            tree, meta = server.state_dict()
            ck.save(rnd + 1, {"server": tree}, extra={"server_meta": meta})
    ck.close()
    return {"server": server, "start": start, "order": order, "losses": losses, "history": history}


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _only_step(src_root: str, step: int, dst_root: str) -> str:
    """A checkpoint root holding ``src_root``'s step ``step`` alone."""
    shutil.copytree(_step_dir(src_root, step), _step_dir(dst_root, step))
    return dst_root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_async_pfl")
    ref = reference_example(str(root / "ref"))
    cfg, init, _ = _reference_setup()
    init_np = jax.tree_util.tree_map(np.asarray, init)
    rnn_np = {k: np.asarray(v) for k, v in ref["server"]._rnn_init.items()}
    kw = dict(init_params=init_np, rnn_params=rnn_np, verbose=False)
    port = example.run("cpu", steps=ROUNDS, ckpt_dir=str(root / "port"), ckpt_every=EVERY, **kw)
    # round 20's checkpoint of each package, resumed by the other
    ref_from_port = reference_example(_only_step(str(root / "port"), EVERY, str(root / "a")), resume=True)
    port_from_ref = example.run("cpu", steps=ROUNDS, resume=True, ckpt_dir=_only_step(str(root / "ref"), EVERY,
                                                                                       str(root / "b")), **kw)
    return ref, port, ref_from_port, port_from_ref


def _same_decisions(got: dict, want: dict, rounds: int) -> None:
    assert len(got["order"]) == len(want["order"]) == rounds
    assert got["order"] == want["order"]
    assert got["history"] == want["history"]
    assert got["server"].clustering.assignment == want["server"].clustering.assignment
    for name in ("clusters", "merges", "expansions", "broadcasts", "rnn_broadcasts", "decisions", "staleness"):
        assert got["server"].stats()[name] == want["server"].stats()[name], name
    assert got["server"].events == want["server"].events


def _losses_close(got: dict, want: dict) -> None:
    assert sorted(got["losses"]) == sorted(want["losses"])
    for cid, w in want["losses"].items():
        np.testing.assert_allclose(got["losses"][cid], w, rtol=LOSS_RTOL, err_msg=f"client {cid}")


def test_the_same_arrivals_and_decisions_every_round(runs):
    ref, port, _, _ = runs
    _same_decisions(port, ref, ROUNDS)
    assert port["stats"]["broadcasts"] > 0 and port["stats"]["clusters"] == 2
    # the example's own observation: clients with even and odd ids share token statistics
    a = port["assignment"]
    assert a[0] == a[2] != a[1] == a[3]


def test_losses_within_the_train_steps_tolerance_and_falling(runs):
    ref, port, _, _ = runs
    _losses_close(port, ref)
    example.check_losses_fall(port)


def test_a_checkpoint_of_either_package_resumes_in_the_other(runs):
    ref, port, ref_from_port, port_from_ref = runs
    assert ref_from_port["start"] == port_from_ref["start"] == EVERY
    _same_decisions(port_from_ref, ref_from_port, ROUNDS - EVERY)
    _losses_close(port_from_ref, ref_from_port)
    # a resumed run restarts the arrivals: its order is the uninterrupted run's first 20
    assert port_from_ref["order"] == port["order"][: ROUNDS - EVERY]


def test_restore_server_equals_the_saved_state(runs, tmp_path):
    """The checkpoint at round 40 restored into a fresh server gives the
    saved server's ``state_dict`` bit for bit."""
    _, port, _, _ = runs
    import torch

    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.core.server import EchoPFLServer

    server = port["server"]
    tree, meta = server.state_dict()
    example.Checkpointer(str(tmp_path)).save(ROUNDS, {"server": tree}, extra={"server_meta": meta})
    fresh = EchoPFLServer(server.init_params, num_initial_clusters=2, seed=0, device="cpu",
                          rnn_params={k: v.numpy() for k, v in server._rnn_init.items()})
    assert example.restore_server(fresh, str(tmp_path)) == ROUNDS
    got, got_meta = fresh.state_dict()
    assert got_meta == meta
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in zip(tree_leaves(got), tree_leaves(tree)))
    assert fresh.stats() == server.stats()


def test_cli_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(example, "run", lambda device, **kw: seen.update(device=device, **kw) or
                        {"losses": {0: [2.0, 1.0]}})
    example.main(["--device", "cpu", "--steps", "7", "--resume", "--ckpt-dir", "d"])
    assert seen == {"device": "cpu", "steps": 7, "clients": 4, "local_steps": 5, "resume": True, "ckpt_dir": "d"}
    with pytest.raises(AssertionError, match="must improve"):
        example.check_losses_fall({"losses": {0: [1.0, 2.0]}})
