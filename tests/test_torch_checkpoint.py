"""The port's crash-safe checkpointer (``repro_torch.checkpoint``) against
the reference's (``repro.checkpoint.checkpointer``), on the CPU.

The reference's checkpointer cases, each on a tree of CPU tensors and on
the same tree as numpy arrays: a roundtrip, corruption, a structure
mismatch, an atomic overwrite, retention and the latest step, async
snapshot isolation (a leaf written in place after ``save_async``), a kill
during the swap, a kill during staging, and step directories without a
manifest. The leaf paths are ``jax.tree_util.keystr``'s for the MLP
server's state tree, the ``tiny_lm`` server's and a tree with keys ``'2'``
and ``'10'``, nested lists, tuples and ``None``. A checkpoint written by
either package restores in the other with bitwise-equal leaves, paths,
shapes, dtypes and checksum.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro_torch.checkpoint import Checkpointer, latest_step, restore_pytree, save_pytree
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.common.pytrees import tree_map
from repro_torch.interop import tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

KINDS = ("torch", "numpy")


def tree(seed=0, kind="torch"):
    rng = np.random.default_rng(seed)
    t = {
        "layer0": {"w": torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32), "b": torch.zeros(3)},
        "step": torch.tensor(7, dtype=torch.int32),
    }
    return t if kind == "torch" else tree_to_numpy(t)


def leaves(t):
    return [np.asarray(x) for _, x in tck._flatten_with_paths(t)]


def assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_save_restore_roundtrip(tmp_path, kind):
    t = tree(kind=kind)
    save_pytree(str(tmp_path / "ckpt"), t, extra={"note": "hi"})
    got, extra = restore_pytree(str(tmp_path / "ckpt"), like=t)
    assert_tree_equal(t, got)
    assert extra == {"note": "hi"}
    assert all(isinstance(x, np.ndarray) for x in leaves(got))
    flat, _ = restore_pytree(str(tmp_path / "ckpt"))  # no template: {path: leaf}
    assert list(flat) == ["['layer0']['b']", "['layer0']['w']", "['step']"]


@pytest.mark.parametrize("kind", KINDS)
def test_restore_detects_corruption(tmp_path, kind):
    d = str(tmp_path / "ckpt")
    save_pytree(d, tree(kind=kind))
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["checksum"] = "0" * 64
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError):
        restore_pytree(d, like=tree(kind=kind))


@pytest.mark.parametrize("kind", KINDS)
def test_restore_detects_structure_mismatch(tmp_path, kind):
    d = str(tmp_path / "ckpt")
    save_pytree(d, tree(kind=kind))
    with pytest.raises(ValueError):
        restore_pytree(d, like={"other": torch.zeros(3)})


@pytest.mark.parametrize("kind", KINDS)
def test_overwrite_is_atomic_replacement(tmp_path, kind):
    d = str(tmp_path / "ckpt")
    save_pytree(d, tree(0, kind))
    save_pytree(d, tree(1, kind))
    got, _ = restore_pytree(d, like=tree(kind=kind))
    assert_tree_equal(tree(1, kind), got)
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


@pytest.mark.parametrize("kind", KINDS)
def test_checkpointer_retention_and_latest(tmp_path, kind):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s, kind))
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(kept) == 2
    step, got, _ = ck.restore_latest(like=tree(kind=kind))
    assert step == 4
    assert_tree_equal(tree(4, kind), got)
    ck.close()


@pytest.mark.parametrize("kind", KINDS)
def test_async_writer_snapshot_isolation(tmp_path, kind):
    """save_async copies the leaves to host memory at once: a leaf written
    in place afterwards (as plane rows are) must not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=3)
    w = torch.ones(8) if kind == "torch" else np.ones(8, np.float32)
    t = {"w": w}
    ck.save_async(5, t, extra={"k": 1})
    t["w"] *= -1  # in place
    ck.wait()
    step, got, extra = ck.restore_latest(like={"w": np.zeros(8, np.float32)})
    assert step == 5 and extra == {"k": 1}
    np.testing.assert_array_equal(got["w"], np.ones(8))
    ck.close()


def test_async_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=3)

    def exploding_savez(f, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", exploding_savez)
    ck.save_async(1, tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.close()
    assert latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("kind", KINDS)
def test_kill_during_swap_rolls_back_old_checkpoint(tmp_path, monkeypatch, kind):
    """A crash after the old checkpoint was renamed aside, while the staged
    directory fails to move into place, leaves the old one restorable under
    its own name."""
    d = str(tmp_path / "ckpt")
    save_pytree(d, tree(0, kind))
    real_replace = os.replace

    def exploding_replace(src, dst):
        base = os.path.basename(src)
        if base.startswith("tmp.") and not base.startswith("tmp.old."):
            raise OSError("simulated kill at rename")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", exploding_replace)
    with pytest.raises(OSError, match="simulated kill"):
        save_pytree(d, tree(1, kind))
    monkeypatch.undo()
    got, _ = restore_pytree(d, like=tree(kind=kind))
    assert_tree_equal(tree(0, kind), got)
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


@pytest.mark.parametrize("kind", KINDS)
def test_kill_during_staging_leaves_no_visible_step(tmp_path, monkeypatch, kind):
    d = str(tmp_path / "ckpt")

    def exploding_savez(f, **kw):
        f.write(b"partial")
        raise OSError("simulated kill mid-write")

    monkeypatch.setattr(np, "savez", exploding_savez)
    with pytest.raises(OSError, match="mid-write"):
        save_pytree(d, tree(0, kind))
    monkeypatch.undo()
    assert not os.path.exists(d)
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]
    save_pytree(d, tree(1, kind))  # a clean save after it just works
    got, _ = restore_pytree(d, like=tree(kind=kind))
    assert_tree_equal(tree(1, kind), got)


@pytest.mark.parametrize("kind", KINDS)
def test_latest_step_ignores_manifestless_dirs(tmp_path, kind):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, tree(0, kind))
    ck.close()
    fake = tmp_path / "step_0000000002"
    fake.mkdir()
    (fake / "leaves.npz").write_bytes(b"truncated garbage")
    assert latest_step(str(tmp_path)) == 1
    got, _ = restore_pytree(str(tmp_path / "step_0000000001"), like=tree(kind=kind))
    assert_tree_equal(tree(0, kind), got)


# ------------------------------------------------------- the reference's paths
def _mlp_state():
    from repro_torch.fl.experiment import build_clients, build_strategy
    from repro_torch.fl.uplink import UplinkCodec, resolve_uplink

    _, clients, init = build_clients("har", 12, seed=0, samples_per_client=24, device="cpu")
    srv = build_strategy("echopfl", init, clients, seed=0, device="cpu", refine_every=1000,
                         rnn_params=tree_to_numpy(_rnn()))
    srv.attach_uplink_codec(UplinkCodec(init, [c.client_id for c in clients], resolve_uplink("topk"), device="cpu"))
    srv.uplink_codec.seed({c.client_id: init for c in clients})
    for i in range(12):  # client ids past 9: '10' sorts before '2'
        srv.handle_upload(i, [{k: v + (i % 3) * 0.3 for k, v in layer.items()} for layer in init], 0, 24, float(i))
    return srv.state_dict()[0]


def _lm_state():
    from repro_torch.core.server import EchoPFLServer
    from repro_torch.fl.lm_task import build_lm_clients

    _, _, delta = build_lm_clients(3, seq_len=8, n_train=2, n_test=1, device="cpu")
    srv = EchoPFLServer(delta, num_initial_clusters=2, refine_every=1000, rnn_params=tree_to_numpy(_rnn()),
                        device="cpu")
    for i in range(3):
        srv.handle_upload(i, tree_map(lambda v, i=i: v + 0.1 * i, delta), 0, 2, float(i))
    return srv.state_dict()[0]


def _rnn():
    from repro_torch.core.broadcast import init_rnn

    return init_rnn(torch.Generator().manual_seed(0))


def _nested():
    return {"2": [torch.zeros(2), (torch.ones(1), None)], "10": {"b": [np.int32(3)], "a": None},
            "x": [[torch.ones(2, 2)], []], "it's": torch.zeros(())}


@pytest.mark.parametrize("make", [_mlp_state, _lm_state, _nested], ids=["mlp", "tiny_lm", "nested"])
def test_paths_are_the_references_keystr(make, tmp_path):
    t = make()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_to_numpy_any(t))
    want = [jax.tree_util.keystr(kp) for kp, _ in flat]
    paths, got = tck._paths_and_leaves(t)
    assert paths == want and len(want) > 2
    for w, g in zip(jax.tree_util.tree_leaves(tree_to_numpy_any(t)), got):
        assert np.asarray(w).tobytes() == g.tobytes()
    save_pytree(str(tmp_path / "c"), t)
    with open(tmp_path / "c" / "manifest.json") as f:
        assert json.load(f)["paths"] == want
    back, _ = restore_pytree(str(tmp_path / "c"), like=t)
    assert [p for p, _ in tck._flatten_with_paths(back)] == want


def tree_to_numpy_any(t):
    """A tree of tensors and arrays as numpy, ``None`` kept."""
    if isinstance(t, dict):
        return {k: tree_to_numpy_any(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_to_numpy_any(v) for v in t)
    if t is None:
        return None
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------ interchange with the reference
def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_interchange_with_the_reference(tmp_path, writer):
    t_np = tree_to_numpy_any(_mlp_state())
    t_torch = jax.tree_util.tree_map(torch.from_numpy, t_np)
    d = str(tmp_path / "ckpt")
    extra = {"meta": [1, 2.5, "x"]}
    if writer == "reference":
        jck.save_pytree(d, t_np, extra=extra)
        got, got_extra = restore_pytree(d, like=t_torch)
        flat, _ = restore_pytree(d)
    else:
        save_pytree(d, t_torch, extra=extra)
        got, got_extra = jck.restore_pytree(d, like=t_np)
        flat, _ = jck.restore_pytree(d)
    assert got_extra == extra
    ref_paths, ref_leaves = jck._paths_and_leaves(t_np)
    m = _manifest(d)
    assert m["paths"] == ref_paths == list(flat)
    assert m["shapes"] == [list(x.shape) for x in ref_leaves]
    assert m["dtypes"] == [str(x.dtype) for x in ref_leaves]
    assert m["checksum"] == jck._checksum(ref_leaves) == tck._checksum(tck._paths_and_leaves(t_torch)[1])
    for w, g, f in zip(ref_leaves, jax.tree_util.tree_leaves(got), flat.values()):
        assert np.asarray(g).dtype == w.dtype and np.asarray(g).tobytes() == w.tobytes() == f.tobytes()
