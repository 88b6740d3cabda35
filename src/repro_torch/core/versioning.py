"""CI-based client-server version control (paper Sec. 6).

Clusters are *branches*; client updates are *pushes*; broadcast checks are
*pulls*. Multi-thread safety comes from a readers-writer lock per branch:
many concurrent pulls, exclusive pushes — exactly the paper's conflict-
resolution mechanism ("multi-thread and read-write locks to resolve
conflicts among personalized branches").
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

PyTree = Any


class RWLock:
    """Writer-preferring readers-writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


@dataclasses.dataclass
class Commit:
    version: int
    author: Any
    timestamp: float
    message: str


class Branch:
    def __init__(self, name: str, model: PyTree):
        self.name = name
        self._model = model
        self._version = 0
        self._lock = RWLock()
        self.log: list[Commit] = [Commit(0, "server", time.time(), "branch created")]

    def pull(self, have_version: int | None = None) -> tuple[PyTree, int] | None:
        """Fetch (model, version); None if caller is already current."""
        self._lock.acquire_read()
        try:
            if have_version is not None and have_version >= self._version:
                return None
            return self._model, self._version
        finally:
            self._lock.release_read()

    def push(self, author, merge_fn: Callable[[PyTree], PyTree], message: str = "") -> int:
        """Atomically apply ``merge_fn`` (e.g. async aggregation) to the head."""
        self._lock.acquire_write()
        try:
            self._model = merge_fn(self._model)
            self._version += 1
            self.log.append(Commit(self._version, author, time.time(), message))
            return self._version
        finally:
            self._lock.release_write()

    @property
    def version(self) -> int:
        self._lock.acquire_read()
        try:
            return self._version
        finally:
            self._lock.release_read()


class ModelRepo:
    """Branch registry with repo-level lock for branch create/delete/merge."""

    def __init__(self):
        self._branches: dict[str, Branch] = {}
        self._lock = threading.RLock()

    def branch(self, name: str, model: PyTree | None = None) -> Branch:
        with self._lock:
            if name not in self._branches:
                if model is None:
                    raise KeyError(f"branch {name!r} does not exist and no model given")
                self._branches[name] = Branch(name, model)
            return self._branches[name]

    def delete(self, name: str) -> None:
        with self._lock:
            self._branches.pop(name, None)

    def merge_branches(self, dst: str, src: str, merge_fn: Callable[[PyTree, PyTree], PyTree]) -> Branch:
        """Merge src into dst atomically (both write-locked via push)."""
        with self._lock:
            src_b = self._branches[src]
            dst_b = self._branches[dst]
            src_model, _ = src_b.pull()
            dst_b.push("server", lambda head: merge_fn(head, src_model), f"merge {src}")
            self.delete(src)
            return dst_b

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._branches)
