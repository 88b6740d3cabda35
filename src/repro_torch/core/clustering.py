"""Data-aware dynamic client clustering (paper Sec. 4), plane backend.

Counterpart of ``repro.core.clustering`` with the parameter-plane storage
only: every center and broadcast anchor is a row of a device-resident
:class:`~repro_torch.core.plane.ParameterPlane`.

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

from repro_torch.core.plane import ParameterPlane
from repro_torch.kernels import ops as K

PyTree = Any


class Cluster:
    """One cluster branch; ``center`` is a tree view of its plane row,
    cached until the row changes."""

    def __init__(self, cluster_id: int, *, plane: ParameterPlane, row: int, bcast_row: int):
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
        # last-known-good snapshot ring (the ingest guard's rollback): plane
        # rows written at broadcast time, read by rollback()
        self._snap_rows: list[int] | None = None
        self._snap_cursor = 0
        self._snap_count = 0

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def center(self) -> PyTree:
        if self._center_cache is None:
            self._center_cache = self._plane.to_pytree(self._row)
        return self._center_cache

    @property
    def center_vec(self) -> torch.Tensor:
        return self._plane.row(self._row)

    @property
    def broadcast_vec(self) -> torch.Tensor:
        return self._plane.row(self._bcast_row)

    def set_center_vec(self, vec: torch.Tensor) -> None:
        self._plane.write(self._row, vec)
        self._center_cache = None

    def snapshot_broadcast(self) -> None:
        """Record the current center as the broadcast anchor (a row copy)
        and, with a snapshot ring, as a last-known-good rollback point: a
        center reaches a broadcast only after the guard's post-blend check
        passed it."""
        self._plane.copy_row(self._row, self._bcast_row)
        self._push_snapshot()

    # ------------------------------------------------- guard snapshot ring
    def ensure_snapshot_ring(self, depth: int) -> None:
        """Allocate the ring's ``depth`` rows (once; 0 allocates nothing)."""
        if depth <= 0 or self._snap_rows is not None:
            return
        self._snap_rows = [self._plane.alloc() for _ in range(depth)]
        self._snap_cursor = 0
        self._snap_count = 0

    def _push_snapshot(self) -> None:
        if self._snap_rows is None:
            return
        self._plane.copy_row(self._row, self._snap_rows[self._snap_cursor])
        self._snap_cursor = (self._snap_cursor + 1) % len(self._snap_rows)
        self._snap_count = min(self._snap_count + 1, len(self._snap_rows))

    def rollback(self) -> bool:
        """Restore the center from the newest finite ring entry, then older
        ones, then the broadcast anchor (every cluster has one from birth).
        Returns whether a restore happened; the caller bumps the version,
        records it on the branch and re-broadcasts. A candidate's
        finiteness is one host read."""
        candidates: list[int] = []
        ring = self._snap_rows
        if ring is not None and self._snap_count:
            for back in range(1, self._snap_count + 1):
                candidates.append(ring[(self._snap_cursor - back) % len(ring)])
        candidates.append(self._bcast_row)
        for cand in candidates:
            if not bool(torch.isfinite(self._plane.row_view(cand)).all()):
                continue  # this snapshot is itself corrupt: go older
            self._plane.copy_row(cand, self._row)
            self._center_cache = None
            return True
        return False

    def release(self) -> None:
        """Return this cluster's plane rows (center, anchor, ring) to the free list."""
        self._plane.free(self._row)
        self._plane.free(self._bcast_row)
        for r in self._snap_rows or ():
            self._plane.free(r)


class DynamicClustering:
    """Server-side cluster registry with incremental init + refinement."""

    def __init__(self, num_initial: int, mix_rate: float = 0.5, hm: float = 2.0,
                 *, device: torch.device | str = "cpu"):
        self.num_initial = num_initial
        self.mix_rate = mix_rate
        self.hm = hm  # merge trigger: merge when count > hm * num_initial
        self.device = torch.device(device)
        self.backend = "plane"
        self.plane: ParameterPlane | None = None  # built from the first center's structure
        # > 0 with an ingest guard: the snapshot rows each cluster carries
        # for center rollback (0 allocates nothing)
        self.snapshot_ring = 0
        self.clusters: dict[int, Cluster] = {}
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
        if self.plane is None:
            self.plane = ParameterPlane(
                template, capacity=max(8, 4 * self.num_initial), device=self.device
            )

    def _new_cluster(self, center: PyTree | torch.Tensor) -> Cluster:
        """``center`` may be a tree or an already-flat row."""
        self._ensure_plane(center)
        row = self.plane.alloc(center)
        bcast_row = self.plane.alloc()
        self.plane.copy_row(row, bcast_row)
        c = Cluster(self._next_id, plane=self.plane, row=row, bcast_row=bcast_row)
        c.ensure_snapshot_ring(self.snapshot_ring)
        self.clusters[self._next_id] = c
        self._next_id += 1
        return c

    def restore_cluster(self, cid: int, center: PyTree | torch.Tensor, bcast_center: PyTree | torch.Tensor) -> Cluster:
        """Rebuild one cluster from a checkpoint's center and broadcast
        anchor (a restart). Rows go center, anchor, then the snapshot ring,
        as in the reference: row order decides later allocations."""
        self._ensure_plane(center)
        row = self.plane.alloc(center)
        bcast_row = self.plane.alloc(bcast_center)
        c = Cluster(cid, plane=self.plane, row=row, bcast_row=bcast_row)
        c.ensure_snapshot_ring(self.snapshot_ring)
        self.clusters[cid] = c
        return c

    def drop_cluster(self, cid: int) -> None:
        self.clusters.pop(cid).release()

    def reset(self) -> None:
        """Drop every cluster and return its rows (ring rows included) before a restore."""
        for c in self.clusters.values():
            c.release()
        self.clusters = {}

    # -------------------------------------------------------------- assign
    def upload_vec(self, update: PyTree) -> torch.Tensor:
        """Flat view of ``update``, reusing the assign-time flatten when this
        is the same object ``assign`` just processed."""
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
        self._ensure_plane(update)
        u = self.plane.from_pytree(update)
        if len(self.clusters) < self.num_initial:
            self._pending = (update, None, u, None, -1)
            c = self._new_cluster(u)
            self._move(client_id, c.cluster_id)
            return c.cluster_id, True
        cids = sorted(self.clusters)
        centers = self.plane.rows([self.clusters[c]._row for c in cids])
        dists_d, _amin, blended = K.assign_and_lerp(u, centers, self.mix_rate)
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
        v_trained = self.plane.from_pytree(local_train_fn(main.center))  # from the pre-merge center
        # no row copies: the kernel reads both rows in the plane and writes
        # the merged center over the main row
        v_m = self.plane.row_view(main._row)
        K.merge_attention(v_m, self.plane.row_view(aux._row), v_trained, out=v_m)
        main._center_cache = None
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
        vecs = self.plane.rows([self.clusters[c]._row for c in cids])
        dmat = K.l1_distance_pairwise(vecs, vecs).cpu().numpy()
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
        rows in ``uploads``) and enter head-only fine-tuning until the next
        merging refinement."""
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
            vecs = self.plane.take([uploads[m] for m in have])
            seed_center = vecs[0]
            for i in range(1, len(have)):  # running mean, each product rounded
                t = 1.0 / (i + 1)
                seed_center = torch.mul(seed_center, 1.0 - t) + torch.mul(vecs[i], t)
        else:
            seed_center = self.plane.row(c._row)
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
