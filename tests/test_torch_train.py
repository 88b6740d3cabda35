"""Training on the CPU: the port's driver (``repro_torch.launch.train``),
its ``TrainState`` checkpoints and remat, against the reference, at
reduced llama3.2-1b (``tests/torch_train.py`` says how; the MoE and Mamba
archs are ``test_torch_train_zoo.py``'s).

* **Checkpoints.** A ``TrainState`` (AdamW, SGD-momentum, Adafactor with a
  factored slot) saves with the paths ``jax.tree_util.keystr`` gives
  (``.params['embed']``, ``.opt_state.mu['embed']``, ``.opt_state.slots['w'].vr``,
  ``.step``); a plain tuple and a list keep ``[i]``. Either package
  restores the other's, leaf for leaf and bit for bit, the port into its
  own NamedTuples.
* **The driver**, after 1 and 8 steps, against the reference's loop body.
* **Kill and resume.** 3 steps saved at 3, then resumed to 6, in each
  package; each package's checkpoint resumed by the other. As in the
  reference, the resumed run draws its batches from the stream's start.
* **Remat** on and off: the same bits; eval and prefill unchanged.
* ``SHAPES`` equals the reference's; an embedding-input arch exits with
  the reference's message; meshes other than ``smoke`` raise.
"""
import dataclasses
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import restore_pytree as jax_restore_pytree
from repro.checkpoint.checkpointer import save_pytree as jax_save_pytree
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models.steps import TrainState as JaxTrainState
from repro.optim.adafactor import adafactor as jax_adafactor
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import momentum as jax_momentum
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.common.pytrees import tree_leaves, tree_map
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.interop import tree_from_numpy
from repro_torch.launch import train as driver
from repro_torch.models.steps import TrainState
from repro_torch.optim.adafactor import AdafactorState, _FactoredSlot, adafactor
from repro_torch.optim.optimizers import AdamState, MomentumState, adamw, momentum
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)
from torch_train import check_against_reference, check_driver, check_eval_and_prefill, check_remat, port_train, \
    reference_loop, reference_run

NAME = "llama3.2-1b"


# ------------------------------------------------------------------ checkpoints
OPTIMIZERS = {"adamw": (adamw, jax_adamw, AdamState), "momentum": (lambda lr: momentum(lr, 0.9),
              lambda lr: jax_momentum(lr, 0.9), MomentumState), "adafactor": (adafactor, jax_adafactor, AdafactorState)}


def _tree_np():
    """Params with a dict, a list, a plain tuple and a leaf Adafactor
    factors (both trailing axes >= 128)."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f(6, 4), "w": f(130, 129), "blocks": {"slot0": {"wq": f(2, 4, 3)}}, "l": [f(2), (f(3), f(1))]}


def _states(opt_name: str):
    """The same random ``TrainState`` in both packages: the port's and the
    reference's optimizer state structures, every leaf drawn (floats
    normal, the step counters small integers)."""
    port_opt, jax_opt, _ = OPTIMIZERS[opt_name]
    params = _tree_np()
    ts = TrainState(tree_from_numpy(params), None, torch.zeros((), dtype=torch.int32))
    ts = ts._replace(opt_state=port_opt(1e-3).init(ts.params))
    rng = np.random.default_rng(4)

    def draw(t):
        if t.dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, 1000, tuple(t.shape)).astype(np.int32))
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    ts = tree_map(draw, ts)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JaxTrainState(jp, jax_opt(1e-3).init(jp), jnp.zeros((), jnp.int32))
    js = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js), [t.numpy() for t in tree_leaves(ts)])
    return ts, js


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _keystr_paths(tree):
    return [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _manifest_paths(d):
    import json

    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)["paths"]


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_trainstate_saves_with_the_references_paths(opt_name, tmp_path):
    ts, js = _states(opt_name)
    save_pytree(str(tmp_path / "p"), ts)
    paths = _manifest_paths(tmp_path / "p")
    assert paths == _keystr_paths(js)
    assert paths[0] == ".params['blocks']['slot0']['wq']" and paths[-1] == ".step"
    assert ".params['l'][1][0]" in paths and ".opt_state.step" in paths
    if opt_name == "adamw":
        assert ".opt_state.mu['embed']" in paths and ".opt_state.nu['w']" in paths
    if opt_name == "adafactor":
        assert {".opt_state.slots['w'].vr", ".opt_state.slots['w'].vc", ".opt_state.slots['embed']"} <= set(paths)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_trainstate_checkpoints_interchange_bit_for_bit(opt_name, tmp_path):
    ts, js = _states(opt_name)
    _, _, state_cls = OPTIMIZERS[opt_name]
    # the port's, restored in the reference
    save_pytree(str(tmp_path / "p"), ts, extra={"loss": 1.5})
    got, extra = jax_restore_pytree(str(tmp_path / "p"), like=jax.tree_util.tree_map(np.asarray, js))
    assert extra == {"loss": 1.5} and isinstance(got, JaxTrainState)
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(ts)):
        assert a.dtype == b.numpy().dtype and np.array_equal(_bits(a), _bits(b.numpy()))
    # the reference's, restored in the port into its own NamedTuples
    jax_save_pytree(str(tmp_path / "j"), js)
    got, _ = restore_pytree(str(tmp_path / "j"), like=ts)
    assert isinstance(got, TrainState) and isinstance(got.opt_state, state_cls)
    if opt_name == "adafactor":
        assert isinstance(got.opt_state.slots["w"], _FactoredSlot)
    assert isinstance(got.params["l"], list) and type(got.params["l"][1]) is tuple
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(js)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_plain_tuples_and_lists_keep_their_indices(tmp_path):
    tree = {"a": [np.ones(2, np.float32), (np.zeros(1, np.float32), np.full(3, 2.0, np.float32))], "b": (np.ones(1),)}
    save_pytree(str(tmp_path / "t"), tree)
    paths = _manifest_paths(tmp_path / "t")
    assert paths == ["['a'][0]", "['a'][1][0]", "['a'][1][1]", "['b'][0]"] == _keystr_paths(tree)
    got, _ = restore_pytree(str(tmp_path / "t"), like=tree)
    assert type(got["a"]) is list and type(got["a"][1]) is tuple and type(got["b"]) is tuple
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)))


def test_shapes_equal_the_references():
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, spec in JAX_SHAPES.items():
        assert isinstance(SHAPES[name], ShapeSpec)
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(spec), name
    assert (SHAPES["train_4k"].seq_len, SHAPES["train_4k"].kind) == (4096, "train")


# ------------------------------------------------------------------ the driver
@pytest.mark.parametrize("steps", [1, 8])
def test_driver_matches_the_references_loop(steps):
    check_driver(NAME, steps)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Each package stopped at 3 steps (saved at 3) and resumed to 6; each
    package's step-3 checkpoint also resumed by the other."""
    root = tmp_path_factory.mktemp("resume")
    name = NAME
    p, j = str(root / "port"), str(root / "ref")
    first = port_train(name, 3, ckpt_dir=p, ckpt_every=3)
    reference_loop(name, 3, ckpt_dir=j, ckpt_every=3)
    cross = {}
    for label, src in (("port_from_ref", j), ("ref_from_port", p)):
        shutil.copytree(os.path.join(src, "step_0000000003"), str(root / label / "step_0000000003"))
    cross["port_from_ref"] = port_train(name, 6, ckpt_dir=str(root / "port_from_ref"), ckpt_every=3)
    cross["ref_from_port"] = reference_loop(name, 6, ckpt_dir=str(root / "ref_from_port"), ckpt_every=3)
    port = port_train(name, 6, ckpt_dir=p, ckpt_every=3)
    ref = reference_loop(name, 6, ckpt_dir=j, ckpt_every=3)
    return name, first, port, ref, cross, p


def test_killed_and_resumed_run_matches_the_references(resumed):
    name, first, port, ref, _, p = resumed
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert port["start"] == ref["start"] == 3 and len(port["losses"]) == 3
    check_against_reference(name, port, ref["state"], ref["losses"])
    # the reference's resumed run draws batches 0.. again: its first resumed loss is not the uninterrupted step 4's
    assert port["losses"][0] != reference_run(name)["losses"][3]
    assert sorted(os.listdir(p)) == ["step_0000000003", "step_0000000006"]
    # the checkpoint holds the stopped run's state bit for bit
    saved, extra = restore_pytree(os.path.join(p, "step_0000000003"), like=first["state"])
    assert extra == {"loss": first["losses"][-1]}
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(tree_leaves(saved), tree_leaves(first["state"])))


def test_either_packages_checkpoint_resumes_in_the_other(resumed):
    name, _, port, ref, cross, _ = resumed
    assert cross["port_from_ref"]["start"] == cross["ref_from_port"]["start"] == 3
    check_against_reference(name, cross["port_from_ref"], ref["state"], ref["losses"])
    check_against_reference(name, port, cross["ref_from_port"]["state"], cross["ref_from_port"]["losses"])


def test_embedding_input_arch_exits_with_the_references_message(monkeypatch):
    from repro.launch import train as jax_driver
    from repro.models import dist

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "hubert-xlarge", "--reduced", "--mesh", "smoke"])
    try:
        with pytest.raises(SystemExit) as want:
            jax_driver.main()
    finally:
        dist.set_mesh(None)
    with pytest.raises(SystemExit) as got:
        driver.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu", "--steps", "1"])
    assert str(got.value) == str(want.value) and "frontend-stub" in str(got.value)


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_meshes_other_than_smoke_raise(mesh, capsys):
    """``--mesh pod`` and ``multipod`` train a dense decoder one step over
    the CPU repeated, the batch split over every data shard, to the
    one-device run's loss; and every arch with MoE, MLA, Mamba, mLSTM or
    sLSTM layers (none raises now): the MoE archs with the batch split over
    every data shard, routed as one group, the recurrent archs at batch 2
    (one shard, every layer over the 16 model ranks), each to the
    one-device run's loss."""
    batch = "16" if mesh == "pod" else "32"
    args = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "1", "--batch", batch, "--seq", "8"]
    out = driver.main(args + ["--mesh", mesh])
    assert "mesh={'" in capsys.readouterr().out
    plain = driver.main(args)
    assert abs(out["losses"][0] - plain["losses"][0]) <= 1e-6 * plain["losses"][0]
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(plain["state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)
    for arch in ("deepseek-v2-lite-16b", "granite-moe-3b-a800m", "jamba-1.5-large-398b", "xlstm-1.3b"):
        rows = batch if "moe" in arch or "deepseek" in arch else "2"
        args = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1", "--batch", rows, "--seq", "8"]
        got, want = driver.main(args + ["--mesh", mesh]), driver.main(args)
        assert abs(got["losses"][0] - want["losses"][0]) <= 1e-5 * want["losses"][0], arch


def test_cli_trains_reduced_on_the_cpu(tmp_path, capsys):
    out = driver.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
                       "--seq", "8", "--log-every", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    printed = capsys.readouterr().out
    assert "step     2 loss=" in printed and "step     4 loss=" in printed and "done: 4 steps" in printed
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"])) and out["peak_bytes"] is None
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002", "step_0000000004"]
    again = driver.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
                         "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert again["start"] == 4 and again["losses"] == [] and "restored checkpoint at step 4" in capsys.readouterr().out


# ------------------------------------------------------------------ remat
def test_remat_changes_no_bit(monkeypatch):
    check_remat(NAME, monkeypatch)


def test_eval_and_prefill_run_each_layer_once_under_remat(monkeypatch):
    check_eval_and_prefill(NAME, monkeypatch)
