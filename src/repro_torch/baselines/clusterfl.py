"""ClusterFL [Ouyang et al. 2021]: synchronous clustering-based PFL
(counterpart of ``repro.baselines.clusterfl``).

Round 0 trains everyone from the seed and clusters the uploaded weights
with a numpy k-means over the flattened rows (the reference's, copied).
Later rounds run FedAvg within each cluster, behind a per-cluster barrier:
a cluster waits only for its own slowest member.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.pytrees import tree_flat_vector, tree_weighted_mean
from repro_torch.core.server import Downlink

PyTree = Any


def kmeans(x: np.ndarray, k: int, rng: np.random.Generator, iters: int = 50, restarts: int = 10) -> np.ndarray:
    """k-means with restarts; returns the best restart's assignment."""
    best_assign, best_inertia = None, np.inf
    for _ in range(restarts):
        centers = x[rng.choice(len(x), size=k, replace=False)].copy()
        assign = np.full(len(x), -1)
        for _ in range(iters):
            d = np.linalg.norm(x[:, None] - centers[None], axis=-1)
            new_assign = np.argmin(d, axis=1)
            if (new_assign == assign).all():
                break
            assign = new_assign
            for c in range(k):
                if (assign == c).any():
                    centers[c] = x[assign == c].mean(0)
        inertia = float((np.linalg.norm(x - centers[assign], axis=-1) ** 2).sum())
        if inertia < best_inertia:
            best_inertia, best_assign = inertia, assign
    return best_assign


class ClusterFL:
    name = "clusterfl"
    is_synchronous = True

    def __init__(self, init_params: PyTree, client_sizes: dict[Any, int], *, num_clusters: int = 4, seed: int = 0):
        self.init_params = init_params
        self.client_sizes = client_sizes
        self.num_clusters = num_clusters
        self.rng = np.random.default_rng(seed)
        self.assignment: dict[Any, int] = {}
        self.centers: dict[int, PyTree] = {}
        self.versions: dict[int, int] = {}
        self._clustered = False

    def initial_models(self, client_ids):
        return {cid: self.init_params for cid in client_ids}

    def model_for(self, client_id):
        cid = self.assignment.get(client_id)
        return self.centers.get(cid, self.init_params)

    def groups(self, client_ids):
        if not self._clustered:
            return {"warmup": list(client_ids)}
        out: dict[int, list] = {}
        for client, cl in self.assignment.items():
            out.setdefault(cl, []).append(client)
        return out

    def select(self, group_id, members, rnd):
        return list(members)  # the per-cluster barrier still waits for every member

    def _mean(self, uploads: dict, members: list) -> PyTree:
        return tree_weighted_mean([uploads[m] for m in members], [self.client_sizes[m] for m in members])

    def finish_round(self, group_id, uploads: dict, t: float):
        if not self._clustered:
            # the warm-up uploads reach the host once, as one (clients, dim) matrix
            vecs = torch.stack([tree_flat_vector(p) for p in uploads.values()]).cpu().numpy()
            ids = list(uploads)
            assign = kmeans(vecs, min(self.num_clusters, len(ids)), self.rng)
            for cid, cl in zip(ids, assign):
                self.assignment[cid] = int(cl)
            for cl in set(assign.tolist()):
                self.centers[cl] = self._mean(uploads, [cid for cid in ids if self.assignment[cid] == cl])
                self.versions[cl] = 1
            self._clustered = True
            return [
                Downlink(cid, self.centers[self.assignment[cid]], 1, self.assignment[cid], "broadcast")
                for cid in ids
            ]
        members = list(uploads)
        center = self._mean(uploads, members)
        self.centers[group_id] = center
        self.versions[group_id] = self.versions.get(group_id, 0) + 1
        return [Downlink(cid, center, self.versions[group_id], group_id, "broadcast") for cid in members]

    def membership_matrix(self, client_ids: list) -> np.ndarray:
        """(n, n) bools: clients i and j share a cluster (an unassigned client
        shares none)."""
        n = len(client_ids)
        out = np.zeros((n, n), bool)
        for i, a in enumerate(client_ids):
            for j, b in enumerate(client_ids):
                out[i, j] = self.assignment.get(a) == self.assignment.get(b) and a in self.assignment
        return out

    def stats(self):
        return {"clusters": len(self.centers)}
