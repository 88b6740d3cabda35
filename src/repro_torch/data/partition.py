"""Non-IID federated partitioners.

Two standard schemes from the FL literature, matching the paper's setups:

- ``shard_partition``: each client holds data from a fixed small number of
  classes (the paper: 2-class/device for CIFAR-10-like, 3-class for
  UbiSound-like), with unbalanced within-class counts.
- ``dirichlet_partition``: class proportions per client drawn from
  Dir(alpha); alpha -> 0 is extreme heterogeneity.
"""
from __future__ import annotations

import numpy as np


def shard_partition(
    labels: np.ndarray,
    num_clients: int,
    classes_per_client: int,
    rng: np.random.Generator,
    unbalanced: bool = True,
) -> list[np.ndarray]:
    """Return per-client index arrays where each client sees a class subset."""
    num_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    cursor = [0] * num_classes
    out: list[np.ndarray] = []
    for i in range(num_clients):
        classes = rng.choice(num_classes, size=classes_per_client, replace=False)
        picks = []
        for c in classes:
            avail = len(by_class[c]) - cursor[c]
            base = len(by_class[c]) * classes_per_client // num_clients
            take = int(base * rng.uniform(0.5, 1.5)) if unbalanced else base
            take = max(1, min(take, avail))
            picks.append(by_class[c][cursor[c] : cursor[c] + take])
            cursor[c] = (cursor[c] + take) % max(len(by_class[c]) - 1, 1)
        out.append(np.concatenate(picks))
    return out


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    rng: np.random.Generator,
    min_size: int = 8,
) -> list[np.ndarray]:
    num_classes = int(labels.max()) + 1
    n = len(labels)
    while True:
        idx_batch: list[list[int]] = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.repeat(alpha, num_clients))
            # Cap clients already holding >= fair share.
            props = props * (np.array([len(b) for b in idx_batch]) < n / num_clients)
            props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for b, part in zip(idx_batch, np.split(idx_c, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in idx_batch) >= min_size:
            return [np.asarray(b) for b in idx_batch]
