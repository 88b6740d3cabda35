"""FedAsyn [Xie et al. 2019]: fully asynchronous, one global model, a
polynomial staleness decay on each upload's weight — the decay EchoPFL
rejects (counterpart of ``repro.baselines.fedasyn``).

The global model is one flat fp32 vector. Each arrival blends into it as
``(1 - t)·v + t·u`` with each product rounded before the sum; the weight
``t`` is computed in host float64 and cast once to fp32. A coalesced
window's arrivals blend in event order, so per-event and coalesced runs
are the same bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.pytrees import flatten_spec
from repro_torch.core.server import Downlink
from repro_torch.core.staleness import StalenessTracker

PyTree = Any


def _lerp(v: torch.Tensor, u: torch.Tensor, t: np.float32) -> torch.Tensor:
    """``(1 - t)·v + t·u``, ``1 - t`` taken in fp32 as the reference does."""
    return torch.mul(v, float(np.float32(1.0) - t)) + torch.mul(u, float(t))


class FedAsyn:
    name = "fedasyn"
    is_synchronous = False

    def __init__(self, init_params: PyTree, *, alpha: float = 0.6, decay_power: float = 0.5):
        self.spec = flatten_spec(init_params)
        self._vec = self.spec.flatten(init_params)
        self.alpha = alpha
        self.decay_power = decay_power
        self.version = 0
        self.staleness = StalenessTracker()
        self._view: tuple[int, PyTree] = (0, init_params)  # (version, tree) cache

    @property
    def global_model(self) -> PyTree:
        """The global model as a tree of views, made once a version."""
        if self._view[0] != self.version:
            self._view = (self.version, self.spec.unflatten(self._vec))
        return self._view[1]

    def initial_models(self, client_ids):
        return {cid: self.global_model for cid in client_ids}

    def model_for(self, client_id):
        return self.global_model

    def _weight(self, base_version: int, version: int) -> np.float32:
        staleness = max(0, version - base_version)
        self.staleness.record(staleness)
        return np.float32(self.alpha * (1.0 + staleness) ** (-self.decay_power))

    def handle_upload(self, client_id, params, base_version, n_samples, t):
        w = self._weight(base_version, self.version)
        self._vec = _lerp(self._vec, self.spec.flatten(params), w)
        self.version += 1
        return [Downlink(client_id, self.global_model, self.version, 0, "unicast")]

    def handle_uploads(self, batch: list[tuple]) -> list[list[Downlink]]:
        """A coalesced window's arrivals, blended in event order; each sees
        the version the arrivals before it bumped. The window's models reach
        the host in one copy and fan out as views of it."""
        ws = [self._weight(bv, self.version + j) for j, (_, _, bv, _, _) in enumerate(batch)]
        v, models = self._vec, []
        for (_, p, _, _, _), w in zip(batch, ws):
            v = _lerp(v, self.spec.flatten(p), w)
            models.append(v)
        self._vec = v
        host = torch.stack(models).cpu()
        out = []
        for j, (cid, _p, _bv, _n, _t) in enumerate(batch):
            self.version += 1
            self._view = (self.version, self.spec.unflatten(host[j]))
            out.append([Downlink(cid, self._view[1], self.version, 0, "unicast")])
        return out

    def stats(self):
        return {"version": self.version, "staleness": self.staleness.snapshot()}
