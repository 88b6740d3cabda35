"""Synthetic federated tasks mirroring the paper's four applications.

The container is offline, so CIFAR-10 / HAR-UCI / UbiSound / the private
file-cleaning set are replaced by *structured* synthetic counterparts with
matched cardinalities (classes, feature dims, client counts). The generative
model is chosen so the paper's phenomena actually appear:

- K latent *data clusters* (user groups with similar behavior): each cluster
  applies its own orthogonal transform + class-prototype offsets, so models
  trained in the same latent cluster converge to nearby parameters (this is
  what makes clustering-based PFL work, and what Fig. 11 measures).
- Within a cluster, clients hold non-IID *label subsets* via shard/dirichlet
  partitioning (the paper: 2-class/device CIFAR, 3-class UbiSound).
- Optional *distribution shift* events (Fig. 18): a client's transform is
  swapped mid-run to a different latent cluster.

Tasks (paper Sec. 7.1):
  T1 image_recognition   10 classes, dim 128  (CIFAR-10-like)
  T2 har                  6 classes, dim  64  (HAR-UCI-like, 30 users)
  T3 sound_detection      9 classes, dim  96  (UbiSound-like)
  T4 file_cleaning        2 classes, dim 128  (Delete/Retain)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.partition import dirichlet_partition, shard_partition

TASKS = {
    "image_recognition": dict(num_classes=10, dim=128, classes_per_client=2),
    "har": dict(num_classes=6, dim=64, classes_per_client=3),
    "sound_detection": dict(num_classes=9, dim=96, classes_per_client=3),
    "file_cleaning": dict(num_classes=2, dim=128, classes_per_client=2),
}


@dataclasses.dataclass
class ClientDataset:
    """One client's local split. Arrays are host numpy; steps move to device."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    latent_cluster: int  # ground-truth cluster id (for evaluation only)

    @property
    def n(self) -> int:
        return len(self.y_train)

    def label_histogram(self, num_classes: int) -> np.ndarray:
        return np.bincount(self.y_train, minlength=num_classes).astype(np.float64)


@dataclasses.dataclass
class FederatedTask:
    name: str
    num_classes: int
    dim: int
    clients: list[ClientDataset]
    transforms: np.ndarray  # (K, dim, dim) latent-cluster transforms

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def shift_client(self, client_id: int, new_cluster: int, rng: np.random.Generator) -> None:
        """Simulate a data-distribution shift (Fig. 18): resample this client's
        data under another latent cluster's transform."""
        c = self.clients[client_id]
        n_train, n_test = len(c.y_train), len(c.y_test)
        x, y = _sample(
            rng, self.num_classes, self.dim, n_train + n_test,
            self.transforms[new_cluster], labels=np.concatenate([c.y_train, c.y_test]),
        )
        self.clients[client_id] = ClientDataset(
            x_train=x[:n_train], y_train=y[:n_train],
            x_test=x[n_train:], y_test=y[n_train:],
            latent_cluster=new_cluster,
        )


def _prototypes(rng: np.random.Generator, num_classes: int, dim: int) -> np.ndarray:
    protos = rng.normal(size=(num_classes, dim))
    return protos / np.linalg.norm(protos, axis=1, keepdims=True) * 3.0


def _orthogonal(rng: np.random.Generator, dim: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    return q


_PROTO_CACHE: dict[tuple, np.ndarray] = {}


def _sample(rng, num_classes, dim, n, transform, labels=None, noise=1.2):
    key = (num_classes, dim)
    if key not in _PROTO_CACHE:
        _PROTO_CACHE[key] = _prototypes(np.random.default_rng(12345), num_classes, dim)
    protos = _PROTO_CACHE[key]
    if labels is None:
        labels = rng.integers(0, num_classes, size=n)
    x = protos[labels] @ transform.T + noise * rng.normal(size=(n, dim))
    return x.astype(np.float32), labels.astype(np.int32)


def make_task(
    name: str,
    num_clients: int,
    rng: np.random.Generator,
    latent_clusters: int = 4,
    samples_per_client: int = 256,
    partition: str = "shard",
    dirichlet_alpha: float = 0.3,
    test_frac: float = 0.2,
) -> FederatedTask:
    spec = TASKS[name]
    num_classes, dim = spec["num_classes"], spec["dim"]
    transforms = np.stack([_orthogonal(rng, dim) for _ in range(latent_clusters)])

    # The paper's non-IID recipe ("each device contains 2-class data, and the
    # data within each class can be unbalanced"): a latent cluster is a group
    # of devices sharing the *same class subset* (plus its own feature
    # transform); within the cluster, per-class proportions are unbalanced.
    cpc = spec["classes_per_client"]
    subsets = []
    for k in range(latent_clusters):
        start = (k * cpc) % num_classes
        subset = [(start + j) % num_classes for j in range(cpc)]
        subsets.append(np.asarray(sorted(set(subset)), np.int64))

    clients: list[ClientDataset] = []
    assignment = np.sort(rng.integers(0, latent_clusters, size=num_clients))
    for k in range(latent_clusters):
        members = np.flatnonzero(assignment == k)
        for _ in members:
            n_total = samples_per_client + max(1, int(samples_per_client * test_frac))
            if partition == "dirichlet":
                props = rng.dirichlet(np.full(len(subsets[k]), dirichlet_alpha))
            else:  # unbalanced-shard: skewed but nonzero proportions
                props = rng.dirichlet(np.full(len(subsets[k]), 2.0))
            labels = rng.choice(subsets[k], size=n_total, p=props)
            x, y = _sample(rng, num_classes, dim, n_total, transforms[k], labels=labels)
            n_test = max(1, int(n_total * test_frac))
            clients.append(
                ClientDataset(
                    x_train=x[n_test:], y_train=y[n_test:],
                    x_test=x[:n_test], y_test=y[:n_test],
                    latent_cluster=k,
                )
            )
    rng.shuffle(clients)  # client id should not encode the latent cluster
    return FederatedTask(name=name, num_classes=num_classes, dim=dim, clients=clients, transforms=transforms)
