"""Data-aware dynamic client clustering (paper Sec. 4).

Counterpart of ``repro.core.clustering``, with its two storage backends,
chosen by the ``backend`` argument (the port reads no ``REPRO_PLANE``):

  * ``plane`` (the default): every center and broadcast anchor is a row of
    a device-resident :class:`~repro_torch.core.plane.ParameterPlane`;
  * ``pytree``: every cluster keeps its center and anchor, and the
    registry each client's last upload, as parameter trees, as the
    reference's original path does. An assign flattens the upload and each
    center and makes one ``l1_distance`` launch; the blend is the two-op
    ``tree_lerp``; a merge flattens the three trees for one
    ``merge_attention`` launch. Its blends and merges are the plane
    backend's bit for bit; the predictor's statistics (:meth:`DynamicClustering.l1`)
    are ``tree_l1`` sums, as in the reference's tree path.

With ``mesh=`` (a :class:`~repro_torch.launch.mesh.PlaneMesh`; plane
backend only) the plane's rows spread over the mesh's devices, and the
batched launches over at least ``mesh_min_rows`` rows (the assign's
centers, the nearest-pair and nearest-center sweeps, and the server's
feedback probes through :meth:`DynamicClustering.launch_kwargs`)
run a launch a shard. Below it the row store stays sharded and the
launch runs on the first device; 0 forces sharded compute. Decisions and
centers do not depend on the mesh (:mod:`repro_torch.kernels.plane_sharded`).

The server sees one interface for both: ``store_upload`` and
``nearest_centers`` for the last uploads, ``Cluster.head`` and
``Cluster.anchor`` for what the branches and the predictor read, and
``DynamicClustering.l1`` for the predictor's statistics.

  * on-arrival assignment (Sec. 4.2): the first C arrivals seed the
    centers; later arrivals go to the nearest center by L1 (Eq. 1), through
    the fused ``assign_and_lerp`` kernel, with switch hysteresis;
  * aggregation: the mixed-rate blend, reusing the fused blend when the
    host-side argmin agrees with the cluster the upload lands in;
  * refinement (Sec. 4.3): Algorithm-1 merge (``merge_attention``),
    nearest-pair search (``l1_distance_pairwise``), expansion.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.device import on_device
from repro_torch.common.pytrees import tree_flat_vector, tree_l1, tree_lerp, tree_map, tree_unflatten_vector
from repro_torch.core.plane import ParameterPlane, l1_vec
from repro_torch.kernels import ops as K

PyTree = Any
BACKENDS = ("plane", "pytree")


def _finite(vec: torch.Tensor) -> bool:
    return bool(torch.isfinite(vec).all())


class Cluster:
    """One cluster branch. In plane mode ``center`` is a tree view of its
    plane row, cached until the row changes; in tree mode the cluster holds
    its center and broadcast anchor as trees, and ``center_vec`` and
    ``broadcast_vec`` flatten them."""

    def __init__(self, cluster_id: int, center: PyTree | None = None, *, plane: ParameterPlane | None = None,
                 row: int | None = None, bcast_row: int | None = None):
        self.cluster_id = cluster_id
        self.version = 0  # bumped on every aggregation into this cluster
        self.members: set = set()
        self.partial_finetune: set = set()  # expansion mode clients
        self.pf_round = -1  # refine round in which partial_finetune was imposed
        self.last_broadcast_version = 0
        self._plane = plane
        self._row = row
        self._bcast_row = bcast_row
        self._center_cache: PyTree | None = None
        self._center_tree: PyTree | None = center if plane is None else None
        self._bcast_tree: PyTree | None = None
        # last-known-good snapshot ring (the ingest guard's rollback): plane
        # rows or trees, written at broadcast time, read by rollback()
        self._snap_rows: list[int] | None = None
        self._snap_trees: list[PyTree | None] | None = None
        self._snap_cursor = 0
        self._snap_count = 0

    @property
    def size(self) -> int:
        return len(self.members)

    # ------------------------------------------------------------ tree views
    @property
    def center(self) -> PyTree:
        if self._plane is None:
            return self._center_tree
        if self._center_cache is None:
            self._center_cache = self._plane.to_pytree(self._row)
        return self._center_cache

    @center.setter
    def center(self, value: PyTree) -> None:
        if self._plane is None:
            self._center_tree = value
        else:
            self._plane.write(self._row, value)
            self._center_cache = None

    @property
    def last_broadcast_center(self) -> PyTree:
        if self._plane is None:
            return self._bcast_tree
        return self._plane.to_pytree(self._bcast_row)

    @last_broadcast_center.setter
    def last_broadcast_center(self, value: PyTree) -> None:
        if self._plane is None:
            self._bcast_tree = value
        else:
            self._plane.write(self._bcast_row, value)

    # ------------------------------------------------------------ flat views
    @property
    def center_vec(self) -> torch.Tensor:
        if self._plane is None:
            return tree_flat_vector(self._center_tree)
        return self._plane.row(self._row)

    @property
    def broadcast_vec(self) -> torch.Tensor:
        if self._plane is None:
            return tree_flat_vector(self._bcast_tree)
        return self._plane.row(self._bcast_row)

    @property
    def head(self) -> PyTree | torch.Tensor:
        """The center as the branch records it and the predictor reads it:
        the tree in tree mode, a copy of the row in plane mode."""
        return self._center_tree if self._plane is None else self.center_vec

    @property
    def anchor(self) -> PyTree | torch.Tensor:
        """The broadcast anchor in :attr:`head`'s form."""
        return self._bcast_tree if self._plane is None else self.broadcast_vec

    def set_center_vec(self, vec: torch.Tensor) -> None:
        if self._plane is None:
            self._center_tree = tree_unflatten_vector(vec, self._center_tree)
            return
        self._plane.write(self._row, vec)
        self._center_cache = None

    def snapshot_broadcast(self) -> None:
        """Record the current center as the broadcast anchor (a row copy, or
        the tree itself) and, with a snapshot ring, as a last-known-good
        rollback point: a center reaches a broadcast only after the guard's
        post-blend check passed it."""
        if self._plane is None:
            self._bcast_tree = self._center_tree
        else:
            self._plane.copy_row(self._row, self._bcast_row)
        self._push_snapshot()

    # ------------------------------------------------- guard snapshot ring
    def ensure_snapshot_ring(self, depth: int) -> None:
        """Allocate the ring's ``depth`` slots (once; 0 allocates nothing)."""
        if depth <= 0 or self._snap_rows is not None or self._snap_trees is not None:
            return
        if self._plane is not None:
            self._snap_rows = [self._plane.alloc() for _ in range(depth)]
        else:
            self._snap_trees = [None] * depth
        self._snap_cursor = 0
        self._snap_count = 0

    def _push_snapshot(self) -> None:
        ring = self._snap_rows if self._plane is not None else self._snap_trees
        if ring is None:
            return
        if self._plane is not None:
            self._plane.copy_row(self._row, ring[self._snap_cursor])
        else:
            ring[self._snap_cursor] = self._center_tree
        self._snap_cursor = (self._snap_cursor + 1) % len(ring)
        self._snap_count = min(self._snap_count + 1, len(ring))

    def rollback(self) -> bool:
        """Restore the center from the newest finite ring entry, then older
        ones, then the broadcast anchor (every cluster has one from birth).
        Returns whether a restore happened; the caller bumps the version,
        records it on the branch and re-broadcasts. A candidate's
        finiteness is one host read."""
        ring = self._snap_rows if self._plane is not None else self._snap_trees
        candidates: list = []
        if ring is not None and self._snap_count:
            for back in range(1, self._snap_count + 1):
                candidates.append(ring[(self._snap_cursor - back) % len(ring)])
        candidates.append(self._bcast_row if self._plane is not None else self._bcast_tree)
        for cand in candidates:
            if self._plane is not None:
                if not _finite(self._plane.row(cand)):
                    continue  # this snapshot is itself corrupt: go older
                self._plane.copy_row(cand, self._row)
                self._center_cache = None
            else:
                if cand is None or not _finite(tree_flat_vector(cand)):
                    continue
                self._center_tree = cand
            return True
        return False

    def release(self) -> None:
        """Return this cluster's plane rows (center, anchor, ring) to the free
        list; a tree-mode cluster holds none."""
        if self._plane is None:
            return
        self._plane.free(self._row)
        self._plane.free(self._bcast_row)
        for r in self._snap_rows or ():
            self._plane.free(r)


class DynamicClustering:
    """Server-side cluster registry with incremental init + refinement."""

    def __init__(self, num_initial: int, mix_rate: float = 0.5, hm: float = 2.0,
                 *, backend: str = "plane", device: torch.device | str = "cpu", mesh=None,
                 mesh_min_rows: int = 128):
        self.num_initial = num_initial
        self.mix_rate = mix_rate
        self.hm = hm  # merge trigger: merge when count > hm * num_initial
        self.device = torch.device(device)
        self.backend = str(backend).lower()
        if self.backend not in BACKENDS:
            raise ValueError(f"clustering backend must be plane|pytree, got {backend!r}")
        self.mesh = mesh if self.backend == "plane" else None
        # below this many rows a batched launch runs on one device (the row
        # store stays sharded); 0 forces sharded compute
        self.mesh_min_rows = int(mesh_min_rows)
        self.plane: ParameterPlane | None = None  # built from the first center's structure
        # > 0 with an ingest guard: the snapshot rows each cluster carries
        # for center rollback (0 allocates nothing)
        self.snapshot_ring = 0
        self.clusters: dict[int, Cluster] = {}
        # client -> its last upload (the expansion and dissolve geometry):
        # a plane row in plane mode, the tree in tree mode
        self.uploads: dict[Any, Any] = {}
        self._next_id = 0
        self.assignment: dict[Any, int] = {}
        self.merges = 0
        self.expansions = 0
        self.peel_counts: dict[Any, int] = {}
        self._last_expand_round: dict[int, int] = {}
        # assign-time flatten + fused blend, reused by the same upload's
        # aggregate: (update, argmin cluster, u, blended, center version)
        self._pending: tuple[Any, int | None, Any, Any, int] | None = None

    # ------------------------------------------------------------------ init
    def _ensure_plane(self, template: PyTree) -> None:
        if self.backend == "plane" and self.plane is None:
            self.plane = ParameterPlane(
                template, capacity=max(8, 4 * self.num_initial), device=self.device, mesh=self.mesh
            )

    def launch_kwargs(self, nrows: int) -> dict:
        """The mesh arguments of a batched launch over ``nrows`` rows, here
        and in the server's feedback probes: none without a sharded plane or
        below ``mesh_min_rows``, so the single-device call stays as it is."""
        if self.plane is None or self.plane.mesh is None or nrows < self.mesh_min_rows:
            return {}
        return {"mesh": self.plane.mesh, "dim_axis": self.plane.dim_axis}

    def _new_cluster(self, center: PyTree | torch.Tensor) -> Cluster:
        """``center`` may be a tree or (plane mode) an already-flat row."""
        if self.backend == "plane":
            self._ensure_plane(center)
            row = self.plane.alloc(center)
            bcast_row = self.plane.alloc()
            self.plane.copy_row(row, bcast_row)
            c = Cluster(self._next_id, plane=self.plane, row=row, bcast_row=bcast_row)
        else:
            c = Cluster(self._next_id, center=center)
            c.last_broadcast_center = center
        c.ensure_snapshot_ring(self.snapshot_ring)
        self.clusters[self._next_id] = c
        self._next_id += 1
        return c

    def restore_cluster(self, cid: int, center: PyTree | torch.Tensor, bcast_center: PyTree | torch.Tensor) -> Cluster:
        """Rebuild one cluster from a checkpoint's center and broadcast
        anchor (a restart; numpy or tensor leaves). Plane rows go center,
        anchor, then the snapshot ring, as in the reference: row order
        decides later allocations. Tree mode keeps trees of tensors of their
        own on the device."""
        if self.backend == "plane":
            self._ensure_plane(center)
            row = self.plane.alloc(center)
            bcast_row = self.plane.alloc(bcast_center)
            c = Cluster(cid, plane=self.plane, row=row, bcast_row=bcast_row)
        else:
            c = Cluster(cid, center=self._device_tree(center))
            c.last_broadcast_center = self._device_tree(bcast_center)
        c.ensure_snapshot_ring(self.snapshot_ring)
        self.clusters[cid] = c
        return c

    def _device_tree(self, tree: PyTree) -> PyTree:
        return tree_map(lambda leaf: on_device(leaf, self.device), tree)

    def drop_cluster(self, cid: int) -> None:
        self.clusters.pop(cid).release()

    def reset(self) -> None:
        """Drop every cluster and every last upload, returning their rows
        (ring rows included), before a restore."""
        for c in self.clusters.values():
            c.release()
        self.clusters = {}
        for client_id in list(self.uploads):
            self.drop_upload(client_id)

    # -------------------------------------------------------- last uploads
    def store_upload(self, client_id, update: PyTree) -> None:
        """Keep ``update`` as the client's last upload: written into its
        plane row (claimed on its first upload), or the tree itself."""
        if self.backend == "pytree":
            self.uploads[client_id] = update
            return
        vec = self.upload_vec(update)
        row = self.uploads.get(client_id)
        if row is None:
            row = self.uploads[client_id] = self.plane.alloc()
        self.plane.write(row, vec)

    def restore_upload(self, client_id, update: PyTree) -> None:
        """A checkpoint's last upload (numpy or tensor leaves)."""
        if self.backend == "pytree":
            self.uploads[client_id] = self._device_tree(update)
            return
        self._ensure_plane(update)
        self.uploads[client_id] = self.plane.alloc(update)

    def upload_tree(self, client_id) -> PyTree:
        """The client's last upload as a tree (a copy of its plane row)."""
        u = self.uploads[client_id]
        return u if self.backend == "pytree" else self.plane.to_pytree(u)

    def drop_upload(self, client_id) -> bool:
        """Forget the client's last upload and free its row; whether it had one."""
        u = self.uploads.pop(client_id, None)
        if u is not None and self.backend == "plane":
            self.plane.free(u)
        return u is not None

    def _upload_matrix(self, uploads: dict[Any, Any], clients: list, on_mesh: bool | str = False):
        """``(len(clients), N)``: the uploads of ``clients`` in ``uploads``
        (plane rows, or trees in tree mode), flattened; ``on_mesh="shard"``
        gives a sharded launch's per-shard operand (:meth:`ParameterPlane.take`)."""
        if self.backend == "pytree":
            return torch.stack([tree_flat_vector(uploads[m]) for m in clients])
        return self.plane.take([uploads[m] for m in clients], on_mesh=on_mesh)

    def _center_matrix(self, cids: list[int], on_mesh: bool | str = False):
        if self.backend == "pytree":
            return torch.stack([self.clusters[c].center_vec for c in cids])
        return self.plane.rows([self.clusters[c]._row for c in cids], on_mesh=on_mesh)

    def nearest_centers(self, clients: list, cids: list[int]) -> dict[Any, int]:
        """Each of ``clients`` with a last upload, to the L1-nearest of the
        clusters ``cids``: one ``l1_distance_pairwise`` launch (one a shard
        under a mesh, the upload rows over it)."""
        have = [m for m in clients if m in self.uploads]
        if not have:
            return {}
        kw = self.launch_kwargs(len(have))
        U = self._upload_matrix(self.uploads, have, on_mesh="shard" if kw else False)
        D = K.l1_distance_pairwise(U, self._center_matrix(cids, on_mesh=bool(kw)), **kw).cpu().numpy()
        return {m: cids[int(np.argmin(d))] for m, d in zip(have, D)}

    def l1(self, a: PyTree | torch.Tensor, b: PyTree | torch.Tensor) -> float:
        """L1 between two :attr:`Cluster.head`-form values: the predictor's
        change and gap statistics (``tree_l1`` in tree mode, as the
        reference's tree path sums leaf by leaf)."""
        return float(tree_l1(a, b) if self.backend == "pytree" else l1_vec(a, b))

    # -------------------------------------------------------------- assign
    def upload_vec(self, update: PyTree) -> torch.Tensor:
        """Flat view of ``update`` (plane mode), reusing the assign-time
        flatten when this is the same object ``assign`` just processed."""
        p = self._pending
        if p is not None and p[0] is update:
            return p[2]
        self._ensure_plane(update)
        u = self.plane.from_pytree(update)
        self._pending = (update, None, u, None, -1)
        return u

    def assign(self, client_id, update: PyTree, switch_margin: float = 0.1) -> tuple[int, bool]:
        """On-arrival assignment (Eq. 1). Returns (cluster_id, is_new_cluster).
        A client only leaves its current cluster when another center is at
        least ``switch_margin`` (relatively) closer."""
        prev = self.assignment.get(client_id)
        if prev is not None and client_id in self.clusters[prev].partial_finetune:
            return prev, False  # expansion members stay put until next merge
        if self.backend == "pytree":
            return self._assign_tree(client_id, update, switch_margin, prev)
        self._ensure_plane(update)
        u = self.plane.from_pytree(update)
        if len(self.clusters) < self.num_initial:
            self._pending = (update, None, u, None, -1)
            c = self._new_cluster(u)
            self._move(client_id, c.cluster_id)
            return c.cluster_id, True
        cids = sorted(self.clusters)
        kw = self.launch_kwargs(len(cids))
        centers = self._center_matrix(cids, on_mesh="shard" if kw else False)
        dists_d, _amin, blended = K.assign_and_lerp(u, centers, self.mix_rate, **kw)
        dists = dists_d.cpu().numpy()  # the one host sync; argmin re-read from it
        cid = cids[int(np.argmin(dists))]
        # the blend is only valid against the center version it came from
        self._pending = (update, cid, u, blended, self.clusters[cid].version)
        if prev is not None and prev in self.clusters and prev != cid:
            d_prev = dists[cids.index(prev)]
            if dists[cids.index(cid)] > (1.0 - switch_margin) * d_prev:
                cid = prev  # not decisively closer: stay
        self._move(client_id, cid)
        return cid, False

    def _assign_tree(self, client_id, update: PyTree, switch_margin: float, prev) -> tuple[int, bool]:
        """Tree mode: flatten the upload and every center, one
        ``l1_distance`` launch, the argmin on the host, the same hysteresis."""
        if len(self.clusters) < self.num_initial:
            c = self._new_cluster(update)
            self._move(client_id, c.cluster_id)
            return c.cluster_id, True
        cids = sorted(self.clusters)
        u = tree_flat_vector(update)
        centers = torch.stack([self.clusters[c].center_vec for c in cids])
        dists = K.l1_distance(u, centers).cpu().numpy()
        cid = cids[int(np.argmin(dists))]
        if prev is not None and prev in self.clusters and prev != cid:
            d_prev = dists[cids.index(prev)]
            if dists[cids.index(cid)] > (1.0 - switch_margin) * d_prev:
                cid = prev  # not decisively closer: stay
        self._move(client_id, cid)
        return cid, False

    def _move(self, client_id, cid: int) -> None:
        prev = self.assignment.get(client_id)
        if prev is not None and prev in self.clusters:
            self.clusters[prev].members.discard(client_id)
            self.clusters[prev].partial_finetune.discard(client_id)
        self.clusters[cid].members.add(client_id)
        self.assignment[client_id] = cid

    # ----------------------------------------------------------- aggregate
    def aggregate(self, cid: int, update: PyTree, weight: float | None = None) -> None:
        """Asynchronous in-cluster aggregation: v_c <- (1-b) v_c + b u (b is
        not decayed by staleness: slow devices' knowledge is kept)."""
        c = self.clusters[cid]
        b = self.mix_rate if weight is None else weight
        if self.backend == "pytree":
            c.center = tree_lerp(c.center, update, b)
            c.version += 1
            return
        p = self._pending
        if (
            p is not None and p[0] is update and p[1] == cid
            and weight is None and c.version == p[4]
        ):
            c.set_center_vec(p[3])  # the fused assign+lerp result
        else:
            u = p[2] if p is not None and p[0] is update else self.upload_vec(update)
            self.plane.lerp_row(c._row, u, b)
            c._center_cache = None
        self._pending = None
        c.version += 1

    # -------------------------------------------------------------- merging
    def should_merge(self) -> bool:
        return len(self.clusters) > self.hm * self.num_initial

    def merge_pair(self, cid_a: int, cid_b: int, local_train_fn: Callable[[PyTree], PyTree]) -> int:
        """Algorithm 1: attention-weighted, training-free merge. The larger
        cluster's center is the main model; ``local_train_fn`` performs the
        one local training pass that yields the posterior direction."""
        a, b = self.clusters[cid_a], self.clusters[cid_b]
        main, aux = (a, b) if a.size >= b.size else (b, a)
        if self.backend == "plane":
            plane = self.plane
            v_trained = plane.from_pytree(local_train_fn(main.center))  # from the pre-merge center
            if not plane.dim_sharded and plane.row_device(main._row) == plane.row_device(aux._row):
                # no row copies: the kernel reads both rows in the plane and
                # writes the merged center over the main row
                v_m = plane.row_view(main._row)
                K.merge_attention(v_m, plane.row_view(aux._row), v_trained.to(v_m.device), out=v_m)
                main._center_cache = None
            else:  # rows split over the model axis or on two devices: whole rows on the first device
                main.set_center_vec(K.merge_attention(plane.row(main._row), plane.row(aux._row), v_trained))
        else:
            v_trained = tree_flat_vector(local_train_fn(main.center))
            main.set_center_vec(K.merge_attention(main.center_vec, aux.center_vec, v_trained))
        main.version += 1
        for client in list(aux.members):
            self._move(client, main.cluster_id)
        main.partial_finetune.clear()  # merge lifts the partial-finetune restriction
        self.drop_cluster(aux.cluster_id)
        self.merges += 1
        return main.cluster_id

    def nearest_pair(self, min_version: int = 2, close_frac: float | None = 0.5) -> tuple[int, int] | None:
        """Closest pair of centers by L1 — the merge candidates. Fresh
        expansions (version < min_version) are exempt while any mature pair
        exists, and a pair only qualifies below ``close_frac`` of the median
        inter-center distance."""
        cids = sorted(self.clusters)
        mature = [c for c in cids if self.clusters[c].version >= min_version]
        if len(mature) >= 2:
            cids = mature
        if len(cids) < 2:
            return None
        kw = self.launch_kwargs(len(cids))
        vecs = self._center_matrix(cids, on_mesh=bool(kw))
        dmat = K.l1_distance_pairwise(vecs, vecs, **kw).cpu().numpy()
        if self.backend == "pytree":
            dmat = dmat.astype(np.float64)  # the reference's tree path fills a float64 matrix, row by row
        off = dmat[~np.eye(len(cids), dtype=bool)]
        median = float(np.median(off))
        dmat = dmat.copy()
        np.fill_diagonal(dmat, np.inf)
        i, j = np.unravel_index(np.argmin(dmat), dmat.shape)
        if close_frac is not None and len(cids) > 2 and dmat[i, j] > close_frac * median:
            return None  # nothing redundant enough to fold
        return (cids[i], cids[j])

    # ------------------------------------------------------------ expansion
    def expand(self, cid: int, feedbacks: dict[Any, float], frac: float = 0.2,
               uploads: dict[Any, int] | None = None, refine_round: int = 0) -> int | None:
        """Sec. 4.3.3: the worst-``frac`` feedback members split into a new
        cluster seeded from the running mean of their last uploads (plane
        rows in ``uploads`` in plane mode, trees in tree mode) and enter
        head-only fine-tuning until the next merging refinement."""
        c = self.clusters[cid]
        if self._last_expand_round.get(cid, -10) >= refine_round - 1:
            return None  # cooldown: let the last split differentiate first
        members = [m for m in c.members if m in feedbacks]
        if len(members) < 3:
            return None
        ranked = sorted(members, key=lambda m: feedbacks[m])  # ascending: low = good fit
        n_bad = max(1, int(len(ranked) * frac))
        median = feedbacks[ranked[len(ranked) // 2]]
        worst = feedbacks[ranked[-1]]
        if worst <= 1e-9 or worst < 2.0 * (median + 1e-12):
            return None  # cluster fits its members uniformly
        bad = [
            m for m in ranked[-n_bad:]
            if feedbacks[m] > 1.5 * (median + 1e-12) and self.peel_counts.get(m, 0) < 3
        ]
        if not bad:
            return None
        have = [m for m in bad if uploads and m in uploads]
        if have:
            vecs = self._upload_matrix(uploads, have)
            seed_center = vecs[0]
            for i in range(1, len(have)):  # running mean, each product rounded (tree_lerp's ops)
                t = 1.0 / (i + 1)
                seed_center = torch.mul(seed_center, 1.0 - t) + torch.mul(vecs[i], t)
        else:
            seed_center = c.center_vec
        if self.backend == "pytree":
            seed_center = tree_unflatten_vector(seed_center, c.center)
        new = self._new_cluster(seed_center)
        for client in bad:
            self._move(client, new.cluster_id)
            new.partial_finetune.add(client)
            self.peel_counts[client] = self.peel_counts.get(client, 0) + 1
        new.pf_round = refine_round
        self._last_expand_round[cid] = refine_round
        self._last_expand_round[new.cluster_id] = refine_round
        self.expansions += 1
        return new.cluster_id
