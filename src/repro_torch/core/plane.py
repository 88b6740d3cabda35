"""Device-resident parameter plane: the server's hot matrix state.

One preallocated ``(capacity, dim)`` fp32 buffer on the device whose rows
are cluster centers, last-broadcast anchors and per-client last uploads,
addressed through an explicit free list; a second, independent plane holds
the client fleet's model rows, and under a compressed uplink a third each
client's anchor (and EF residual). Counterpart of ``repro.core.plane``.

PyTorch tensors are mutable, so the reference's staged write-back with a
donated scatter (``plane.py:86-95``) becomes a write straight into the
buffer: ``write`` copies into the row in place and ``write_rows`` is one
in-place ``index_copy_``. Reads hand out copies (``row`` clones, ``rows``
and ``take`` gather), so a value read before a write keeps its bits, as a
JAX array would; ``row_view`` alone hands out the row itself, for the merge
kernel, which writes the merged center into the main row in place, and
``storage`` the whole store, for the uplink encodes, which advance a
cohort's anchor and residual rows in place.

The store is a grid of blocks, one ``(rows_local, dim_local)`` tensor a
shard on that shard's device: one block, the whole buffer, without a mesh.
Under a mesh (``mesh=``, a :class:`~repro_torch.launch.mesh.PlaneMesh`)
row i lives in block ``i // rows_local``, as ``PartitionSpec("plane",
...)`` lays rows out, and the ``model`` axis splits the dim when its
extent divides it (else block r lives on the first device of mesh row
r). Capacity is a multiple of the row shards
and stays one through ``_grow``, which re-splits the store. Reads gather
whole rows onto the mesh's first device (``take(on_mesh="shard")`` hands
the batched kernels their per-shard operands instead); writes go in place
into the owning blocks, so the bits of every row are those of the
unsharded plane. ``row_view`` exists only where a row lies whole in one
block, and ``storage`` and ``index`` only without a mesh (the uplink
codec's plane has none).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.common.pytrees import flatten_spec
from repro_torch.kernels.l1 import l1_distance
from repro_torch.kernels.plane_sharded import MeshRows

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
    """Preallocated ``(capacity, dim)`` row store for flat parameter vectors,
    held as an R x M grid of blocks (1 x 1 without a mesh)."""

    def __init__(self, template: PyTree, capacity: int = 32, *, device: torch.device | str = "cpu",
                 mesh=None, dim_axis: str | None = "model"):
        self.spec = flatten_spec(template)
        self.dim = self.spec.dim
        self.device = torch.device(device)
        self.mesh = mesh
        self.dim_axis = dim_axis
        capacity = max(1, int(capacity))
        if mesh is None:
            self._grid, self._row_shards, self._dim_shards = ((self.device,),), 1, 1
        else:
            if mesh.first_device != self.device:
                raise ValueError(f"plane on {self.device}, its mesh starts on {mesh.first_device}")
            self._grid = mesh.devices
            self._row_shards = mesh.row_shards
            m = mesh.shape.get(dim_axis, 1) if dim_axis is not None else 1
            self._dim_shards = m if m > 1 and self.dim % m == 0 else 1
            capacity = -(-capacity // self._row_shards) * self._row_shards  # equal row shards
        self._blocks = self._zero_blocks(capacity // self._row_shards)  # [row shard][dim chunk]
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._used: set[int] = set()

    # ------------------------------------------------------------ row shards
    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def dim_sharded(self) -> bool:
        return self._dim_shards > 1

    def _zero_blocks(self, rows_local: int) -> list[list[torch.Tensor]]:
        dl = self.dim // self._dim_shards
        return [[torch.zeros((rows_local, dl), dtype=torch.float32, device=self._grid[r][m])
                 for m in range(self._dim_shards)] for r in range(self._row_shards)]

    @property
    def _rows_local(self) -> int:
        return self._blocks[0][0].shape[0]

    def _owner(self, row: int) -> tuple[int, int]:
        return divmod(row, self._rows_local)

    def _chunks(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x``'s last dim cut into the store's dim chunks."""
        return list(torch.chunk(x, self._dim_shards, dim=-1)) if self._dim_shards > 1 else [x]

    def _by_owner(self, row_ids: Sequence[int]) -> dict[int, tuple[list[int], list[int]]]:
        """Owner shard -> (positions in ``row_ids``, local rows), shards in order."""
        groups: dict[int, tuple[list[int], list[int]]] = {}
        for pos, row in enumerate(row_ids):
            r, local = self._owner(int(row))
            g = groups.setdefault(r, ([], []))
            g[0].append(pos)
            g[1].append(local)
        return dict(sorted(groups.items()))

    def row_device(self, row: int) -> torch.device:
        """The device that holds ``row`` whole (the plane's, without a mesh)."""
        if self._dim_shards > 1:
            raise ValueError("row_device: the row is split over the model axis")
        return self._blocks[self._owner(row)[0]][0].device

    # ---------------------------------------------------------------- sizing
    @property
    def capacity(self) -> int:
        return self._row_shards * self._rows_local

    @property
    def num_allocated(self) -> int:
        return len(self._used)

    def _grow(self) -> None:
        # capacity doubles: new block r holds the rows of old blocks 2r and 2r + 1 (zeros past the end)
        old_cap, old, R, rl = self.capacity, self._blocks, self._row_shards, self._rows_local
        new = self._zero_blocks(2 * rl)
        for r in range(R):
            for m in range(self._dim_shards):
                for half, src_r in enumerate((2 * r, 2 * r + 1)):
                    if src_r < R:
                        new[r][m][half * rl:(half + 1) * rl].copy_(old[src_r][m])
        self._blocks = new
        self._free.extend(range(2 * old_cap - 1, old_cap - 1, -1))

    # ------------------------------------------------------------ allocation
    def alloc(self, value: PyTree | torch.Tensor | None = None) -> int:
        """Claim a row; ``value`` (vector or tree) seeds it, else zeros (a
        recycled row never shows its previous tenant)."""
        if not self._free:
            self._grow()
        row = self._free.pop()
        self._used.add(row)
        if value is not None:
            self.write(row, value)
        else:
            r, local = self._owner(row)
            for block in self._blocks[r]:
                block[local].zero_()
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
        for r, (_, local) in self._by_owner(rows).items():
            for block in self._blocks[r]:
                block.index_fill_(0, torch.tensor(local, dtype=torch.int64, device=block.device), 0.0)
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
        r, local = self._owner(row)
        for block, chunk in zip(self._blocks[r], self._chunks(vec)):
            block[local].copy_(chunk)

    def write_rows(self, row_ids: Sequence[int], matrix: torch.Tensor) -> None:
        """``matrix[i]`` lands in ``row_ids[i]`` (one in-place index copy an
        owning shard)."""
        ids = [int(r) for r in row_ids]
        if len(set(ids)) != len(ids):
            raise ValueError("write_rows: duplicate row ids in one batch")
        self._check_used(ids)
        matrix = matrix.to(device=self.device, dtype=torch.float32)
        if tuple(matrix.shape) != (len(ids), self.dim):
            raise ValueError(f"expected ({len(ids)}, {self.dim}) matrix, got {tuple(matrix.shape)}")
        groups = self._by_owner(ids)
        for r, (pos, local) in groups.items():
            sub = matrix if len(groups) == 1 else matrix.index_select(
                0, torch.tensor(pos, dtype=torch.int64, device=self.device))
            for block, chunk in zip(self._blocks[r], self._chunks(sub)):
                block.index_copy_(0, torch.tensor(local, dtype=torch.int64, device=block.device),
                                  chunk.to(block.device).contiguous())

    def _check_used(self, row_ids: Sequence[int]) -> None:
        for r in row_ids:
            if r not in self._used:
                raise KeyError(f"row {r} is not allocated")

    @property
    def storage(self) -> torch.Tensor:
        """The ``(capacity, dim)`` row store itself, for a kernel that reads
        and writes rows by id in place (the uplink encodes); it goes stale
        when the plane grows. Not under a mesh: the store is in blocks."""
        if self.sharded:
            raise ValueError("storage: a sharded plane has no single row store")
        return self._blocks[0][0]

    def index(self, row_ids: Sequence[int]) -> torch.Tensor:
        """The allocated rows ``row_ids`` as an int64 tensor on the plane's
        device (the row ids of :attr:`storage`; not under a mesh)."""
        if self.sharded:
            raise ValueError("index: a sharded plane has no single row store")
        self._check_used(row_ids)
        return torch.tensor(list(row_ids), dtype=torch.int64, device=self.device)

    def row(self, row: int) -> torch.Tensor:
        """A copy of one ``(dim,)`` row (on the mesh's first device)."""
        return self._row_copy(row)

    def _row_copy(self, row: int) -> torch.Tensor:
        self._check_used((row,))
        r, local = self._owner(row)
        parts = [block[local] for block in self._blocks[r]]
        if len(parts) == 1:
            return parts[0].to(self.device, copy=True)
        return torch.cat([p.to(self.device) for p in parts])

    def row_view(self, row: int) -> torch.Tensor:
        """One ``(dim,)`` row itself, not a copy: a write through it lands in
        the plane, and it goes stale when the plane grows. For a kernel that
        reads and writes rows in place (the merge). Under a mesh it lies on
        :meth:`row_device`; a plane whose dim is split has no whole row."""
        if row not in self._used:
            raise KeyError(f"row {row} is not allocated")
        if self._dim_shards > 1:
            raise ValueError("row_view: the row is split over the model axis")
        r, local = self._owner(row)
        return self._blocks[r][0][local]

    def take(self, row_ids: Sequence[int], *, on_mesh: bool | str = False) -> torch.Tensor | MeshRows:
        """``(len(row_ids), dim)`` gather (a copy). Under a mesh ``on_mesh``
        picks the placement: ``False`` or ``True`` (the operand every shard
        of a sharded launch reads, which the launch copies to each shard's
        device) gather onto the mesh's first device; ``"shard"`` gives the
        per-shard operand of a sharded launch (:class:`MeshRows`: the rows
        padded with zeros to a multiple of the row shards, shard k holding
        the k-th block on its devices, in the store's dim chunks). Without
        a mesh ``on_mesh`` is ignored."""
        if on_mesh == "shard" and self.sharded:
            return self._take_shards(list(row_ids))
        groups = self._by_owner(row_ids)
        if len(groups) == 1:  # one owner (always, without a mesh): a gather a dim chunk
            [(r, (_, local))] = groups.items()
            cols = [block.index_select(0, torch.tensor(local, dtype=torch.int64, device=block.device))
                    .to(self.device) for block in self._blocks[r]]
            return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        n, dl = len(row_ids), self.dim // self._dim_shards
        cols = [torch.zeros((n, dl), dtype=torch.float32, device=self.device) for _ in range(self._dim_shards)]
        for r, (pos, local) in groups.items():
            dst = torch.tensor(pos, dtype=torch.int64, device=self.device)
            for col, block in zip(cols, self._blocks[r]):
                src = torch.tensor(local, dtype=torch.int64, device=block.device)
                col.index_copy_(0, dst, block.index_select(0, src).to(self.device))
        return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)

    rows = take  # no view cache: a gather is one launch on the card

    def _take_shards(self, row_ids: list[int]) -> MeshRows:
        """Rows ``row_ids`` laid out over the row shards: block k (rows k*b ..
        (k+1)*b - 1 of the request, zero padded) on shard k's devices, each
        owner's rows copied straight to it."""
        R, n = self._row_shards, len(row_ids)
        b = max(1, -(-n // R))
        dl = self.dim // self._dim_shards
        parts = []
        for k in range(R):
            want = row_ids[k * b:(k + 1) * b]
            chunks = [torch.zeros((b, dl), dtype=torch.float32, device=self._grid[k][m])
                      for m in range(self._dim_shards)]
            for r, (pos, local) in self._by_owner(want).items():
                for dst, block in zip(chunks, self._blocks[r]):
                    src = torch.tensor(local, dtype=torch.int64, device=block.device)
                    dst.index_copy_(0, torch.tensor(pos, dtype=torch.int64, device=dst.device),
                                    block.index_select(0, src).to(dst.device))
            parts.append(chunks)
        return MeshRows(parts, n)

    # ------------------------------------------------------------ arithmetic
    def lerp_row(self, row: int, value: PyTree | torch.Tensor, t: float) -> None:
        """row <- (1 - t) * row + t * value (the async mixing step; under a
        mesh a dim chunk at a time on its shard, the same elementwise bits)."""
        self._check_used((row,))
        r, local = self._owner(row)
        for block, chunk in zip(self._blocks[r], self._chunks(self.as_vec(value))):
            block[local].copy_(lerp_vec(block[local], chunk.to(block.device), t))

    def copy_row(self, src: int, dst: int) -> None:
        if src not in self._used or dst not in self._used:
            raise KeyError(f"rows {src}, {dst} must be allocated")
        (rs, ls), (rd, ld) = self._owner(src), self._owner(dst)
        for a, b in zip(self._blocks[rs], self._blocks[rd]):
            b[ld].copy_(a[ls])

    # ------------------------------------------------------------- adapters
    def from_pytree(self, tree: PyTree) -> torch.Tensor:
        return self.spec.flatten(tree).to(self.device)

    def to_pytree(self, row: int) -> PyTree:
        """A tree of a copy of the row (a snapshot: later writes to the row
        do not show in it)."""
        return self.spec.unflatten(self._row_copy(row))
