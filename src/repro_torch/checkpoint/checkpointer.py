"""Crash-safe checkpoints (counterpart of ``repro.checkpoint.checkpointer``).

- **Atomicity**: a step is staged in ``<parent>/tmp.<uuid>`` (fsynced,
  manifest written last) and renamed into place; an existing step is
  renamed aside first and rolled back if the swap fails, so a kill at any
  point leaves the old checkpoint or the new one whole.
- **Manifest**: ``manifest.json`` holds each leaf's path, shape and dtype,
  a checksum of the payload and a JSON ``extra``; a restore verifies it.
- **Async**: :meth:`Checkpointer.save_async` copies every leaf to host
  memory before it returns and writes on a background thread.
- **Retention**: the newest ``keep`` steps stay.

The files are the reference's: one ``leaves.npz`` a step, leaf paths in
the strings ``jax.tree_util.keystr`` gives (a dict key as ``['key']``, a
NamedTuple field as ``.field``, a list or plain tuple index as ``[0]``;
dict keys sorted, so ``'10'`` comes before ``'2'``, NamedTuple fields in
their order), so a checkpoint written by either package restores in the
other: a ``TrainState`` saves as ``.params['embed']``,
``.opt_state.mu['embed']``, ``.step``.
Leaves may be tensors (on any device), numpy arrays or scalars; restored
leaves are numpy arrays, which the caller moves to its device.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytrees import is_namedtuple, rebuild_seq

PyTree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_with_paths(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` in the reference's pytree order; ``None`` is
    an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if is_namedtuple(tree):  # keystr's GetAttrKey
        return [item for f, x in zip(tree._fields, tree) for item in _flatten_with_paths(x, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree) for item in _flatten_with_paths(x, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _paths_and_leaves(tree: PyTree) -> tuple[list[str], list[np.ndarray]]:
    flat = _flatten_with_paths(tree)
    return [p for p, _ in flat], [_to_numpy(v) for _, v in flat]


def _np_dtype(leaf: Any) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _checksum(leaves: list[np.ndarray]) -> str:
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(str(leaf.shape).encode())
        h.update(str(leaf.dtype).encode())
        h.update(np.ascontiguousarray(leaf).tobytes()[:65536])  # a prefix: cheap, and catches truncation
    return h.hexdigest()


def save_pytree(directory: str, tree: PyTree, extra: dict | None = None) -> None:
    """Atomically write ``tree`` (and the JSON-serializable ``extra``) to
    ``directory``: staged in a ``tmp.<uuid>`` sibling, fsynced, manifest
    last; an existing ``directory`` is renamed aside, not deleted, and only
    then does the staged directory take its name. A kill anywhere leaves the
    old checkpoint or the new one whole under a name :func:`latest_step` and
    :func:`restore_pytree` accept."""
    _save_flat(directory, *_paths_and_leaves(tree), extra)


def _save_flat(directory: str, paths: list[str], leaves: list[np.ndarray], extra: dict | None) -> None:
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"tmp.{uuid.uuid4().hex}")
    old = None
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
            np.savez(f, **{str(i): leaf for i, leaf in enumerate(leaves)})
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "paths": paths,
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype) for x in leaves],
            "checksum": _checksum(leaves),
            "extra": extra or {},
        }
        # the manifest last: its presence marks a step directory as whole
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(directory):
            old = os.path.join(parent, f"tmp.old.{uuid.uuid4().hex}")
            os.replace(directory, old)
        try:
            os.replace(tmp, directory)
        except BaseException:
            if old is not None and not os.path.exists(directory):
                os.replace(old, directory)  # roll the old checkpoint back
                old = None
            raise
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        if old is not None and os.path.isdir(old):
            shutil.rmtree(old, ignore_errors=True)


def restore_pytree(directory: str, like: PyTree | None = None, verify: bool = True) -> tuple[PyTree, dict]:
    """Restore a tree saved by :func:`save_pytree`; returns ``(tree, extra)``.
    With ``like`` the paths must equal the template's, each leaf is cast to
    its template leaf's dtype and the tree takes the template's structure;
    without it the result is ``{path: leaf}``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, "leaves.npz")) as z:
        leaves = [z[str(i)] for i in range(len(manifest["paths"]))]
    if verify and _checksum(leaves) != manifest["checksum"]:
        raise IOError(f"checkpoint {directory} failed checksum verification")
    if like is None:
        return dict(zip(manifest["paths"], leaves)), manifest["extra"]
    flat = _flatten_with_paths(like)
    ref_paths = [p for p, _ in flat]
    if ref_paths != manifest["paths"]:
        raise ValueError(f"checkpoint tree structure mismatch: {set(manifest['paths']) ^ set(ref_paths)}")
    leaves = [leaf.astype(_np_dtype(ref)) for leaf, (_, ref) in zip(leaves, flat)]
    return _rebuild(like, iter(leaves)), manifest["extra"]


def _rebuild(like: PyTree, leaves) -> PyTree:
    """``like``'s structure (dict keys sorted, ``None`` kept) around the
    next leaves of the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return rebuild_seq(like, [_rebuild(x, leaves) for x in like])
    if like is None:
        return None
    return next(leaves)


def latest_step(root: str) -> int | None:
    """The newest step under ``root`` whose manifest reached the disk."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class Checkpointer:
    """Step-indexed checkpoints under ``root`` with an async writer thread."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._errors: list[BaseException] = []
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, paths, leaves, extra = item
            try:
                _save_flat(self._dir(step), paths, leaves, extra)
                self._gc()
            except BaseException as e:  # raised again by the next wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for m in (_STEP_RE.match(n) for n in os.listdir(self.root)) if m)
        for step in steps[: -self.keep]:
            shutil.rmtree(self._dir(step), ignore_errors=True)

    def save(self, step: int, tree: PyTree, extra: dict | None = None) -> None:
        save_pytree(self._dir(step), tree, extra)
        self._gc()

    def save_async(self, step: int, tree: PyTree, extra: dict | None = None) -> None:
        """Queue a save. Every leaf is copied to host memory now: plane rows
        on the card are written in place, so a later write would otherwise
        reach the checkpoint."""
        paths, leaves = _paths_and_leaves(tree)
        self._queue.put((step, paths, [leaf.copy() for leaf in leaves], extra))

    def wait(self) -> None:
        """Block until every queued save is written; raise a writer's error."""
        self._queue.join()
        if self._errors:
            raise self._errors.pop()

    def restore_latest(self, like: PyTree | None = None) -> tuple[int, PyTree, dict] | None:
        step = latest_step(self.root)
        if step is None:
            return None
        tree, extra = restore_pytree(self._dir(step), like=like)
        return step, tree, extra

    def close(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=10)
