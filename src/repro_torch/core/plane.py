"""Device-resident parameter plane: the server's hot matrix state.

One preallocated ``(capacity, dim)`` fp32 buffer on the device whose rows
are cluster centers, last-broadcast anchors and per-client last uploads,
addressed through an explicit free list; a second, independent plane holds
the client fleet's model rows, and under a compressed uplink a third each
client's anchor (and EF residual). Counterpart of ``repro.core.plane`` without
the mesh placement.

PyTorch tensors are mutable, so the reference's staged write-back with a
donated scatter (``plane.py:86-95``) becomes a write straight into the
buffer: ``write`` copies into the row in place and ``write_rows`` is one
in-place ``index_copy_``. Reads hand out copies (``row`` clones, ``rows``
and ``take`` gather), so a value read before a write keeps its bits, as a
JAX array would; ``row_view`` alone hands out the row itself, for the merge
kernel, which writes the merged center into the main row in place, and
``storage`` the whole store, for the uplink encodes, which advance a
cohort's anchor and residual rows in place.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.common.pytrees import flatten_spec
from repro_torch.kernels.l1 import l1_distance

PyTree = Any


def lerp_vec(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """The canonical mixed-rate blend (1 - t) * a + t * b in the pinned
    two-op form: both products rounded, then the sum; (1 - t) folds in
    double and rounds once, like the reference's static ``t``."""
    return torch.add(torch.mul(a, 1.0 - t), torch.mul(b, t))


def l1_vec(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum |a - b| as a 0-d tensor. On the card it is one ``l1_distance``
    launch, so its bits are those of the L1 kernels' fixed order
    (``csrc/l1_rows.cuh``), which the coalesced ingest chain reproduces; on
    the CPU the plain sum."""
    if a.device.type == "cuda":
        return l1_distance(a, b[None])[0]
    return torch.sum(torch.abs(a - b))


class ParameterPlane:
    """Preallocated ``(capacity, dim)`` row store for flat parameter vectors."""

    def __init__(self, template: PyTree, capacity: int = 32, *, device: torch.device | str = "cpu"):
        self.spec = flatten_spec(template)
        self.dim = self.spec.dim
        self.device = torch.device(device)
        capacity = max(1, int(capacity))
        self._buf = torch.zeros((capacity, self.dim), dtype=torch.float32, device=self.device)
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._used: set[int] = set()

    # ---------------------------------------------------------------- sizing
    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def num_allocated(self) -> int:
        return len(self._used)

    def _grow(self) -> None:
        old_cap = self.capacity
        self._buf = torch.cat([self._buf, torch.zeros_like(self._buf)], dim=0)
        self._free.extend(range(2 * old_cap - 1, old_cap - 1, -1))

    # ------------------------------------------------------------ allocation
    def alloc(self, value: PyTree | torch.Tensor | None = None) -> int:
        """Claim a row; ``value`` (vector or tree) seeds it, else zeros (a
        recycled row never shows its previous tenant)."""
        if not self._free:
            self._grow()
        row = self._free.pop()
        self._used.add(row)
        if value is None:
            self._buf[row].zero_()
        else:
            self.write(row, value)
        return row

    def alloc_many(self, n: int) -> list[int]:
        """Claim ``n`` zeroed rows at once (the uplink codec's anchor and
        residual rows, one a client)."""
        if n <= 0:
            return []
        while len(self._free) < n:
            self._grow()
        rows = [self._free.pop() for _ in range(n)]
        self._used.update(rows)
        self._buf.index_fill_(0, self.index(rows), 0.0)
        return rows

    def free(self, row: int) -> None:
        if row not in self._used:
            raise KeyError(f"row {row} is not allocated")
        self._used.discard(row)
        self._free.append(row)

    # ----------------------------------------------------------------- io
    def as_vec(self, value: PyTree | torch.Tensor) -> torch.Tensor:
        """Coerce a 1-D vector or a tree to a plane row vector."""
        if isinstance(value, torch.Tensor) and value.dim() == 1:
            return value.to(device=self.device, dtype=torch.float32)
        return self.spec.flatten(value).to(self.device)

    def write(self, row: int, value: PyTree | torch.Tensor) -> None:
        if row not in self._used:
            raise KeyError(f"row {row} is not allocated")
        vec = self.as_vec(value)
        if vec.shape != (self.dim,):
            raise ValueError(f"expected ({self.dim},) vector, got {tuple(vec.shape)}")
        self._buf[row].copy_(vec)

    def write_rows(self, row_ids: Sequence[int], matrix: torch.Tensor) -> None:
        """``matrix[i]`` lands in ``row_ids[i]`` (one in-place index copy)."""
        ids = [int(r) for r in row_ids]
        if len(set(ids)) != len(ids):
            raise ValueError("write_rows: duplicate row ids in one batch")
        index = self.index(ids)
        matrix = matrix.to(device=self.device, dtype=torch.float32)
        if tuple(matrix.shape) != (len(ids), self.dim):
            raise ValueError(f"expected ({len(ids)}, {self.dim}) matrix, got {tuple(matrix.shape)}")
        if ids:
            self._buf.index_copy_(0, index, matrix)

    @property
    def storage(self) -> torch.Tensor:
        """The ``(capacity, dim)`` row store itself, for a kernel that reads
        and writes rows by id in place (the uplink encodes); it goes stale
        when the plane grows."""
        return self._buf

    def index(self, row_ids: Sequence[int]) -> torch.Tensor:
        """The allocated rows ``row_ids`` as an int64 tensor on the plane's device."""
        for r in row_ids:
            if r not in self._used:
                raise KeyError(f"row {r} is not allocated")
        return torch.tensor(list(row_ids), dtype=torch.int64, device=self.device)

    def row(self, row: int) -> torch.Tensor:
        """A copy of one ``(dim,)`` row."""
        return self.row_view(row).clone()

    def row_view(self, row: int) -> torch.Tensor:
        """One ``(dim,)`` row itself, not a copy: a write through it lands in
        the plane, and it goes stale when the plane grows. For a kernel that
        reads and writes rows in place (the merge)."""
        if row not in self._used:
            raise KeyError(f"row {row} is not allocated")
        return self._buf[row]

    def take(self, row_ids: Sequence[int]) -> torch.Tensor:
        """``(len(row_ids), dim)`` gather (a copy)."""
        if len(row_ids) == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        index = torch.tensor(list(row_ids), dtype=torch.long, device=self.device)
        return self._buf.index_select(0, index)

    rows = take  # no view cache: a gather is one launch on the card

    # ------------------------------------------------------------ arithmetic
    def lerp_row(self, row: int, value: PyTree | torch.Tensor, t: float) -> None:
        """row <- (1 - t) * row + t * value (the async mixing step)."""
        self.write(row, lerp_vec(self._buf[row], self.as_vec(value), t))

    def copy_row(self, src: int, dst: int) -> None:
        if src not in self._used or dst not in self._used:
            raise KeyError(f"rows {src}, {dst} must be allocated")
        self._buf[dst].copy_(self._buf[src])

    # ------------------------------------------------------------- adapters
    def from_pytree(self, tree: PyTree) -> torch.Tensor:
        return self.spec.flatten(tree).to(self.device)

    def to_pytree(self, row: int) -> PyTree:
        """A tree of a copy of the row (a snapshot: later writes to the row
        do not show in it)."""
        return self.spec.unflatten(self.row_view(row).clone())
