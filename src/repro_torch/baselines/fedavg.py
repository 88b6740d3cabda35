"""FedAvg [McMahan et al. 2017]: synchronous, one global model, waits for
every client each round (counterpart of ``repro.baselines.fedavg``).

The global model is one flat fp32 vector in the fleet's row layout. A
round's cohort is averaged as one product ``ws @ us`` over the stacked
``(B, dim)`` uploads; the sample-count weights are normalized in float64
on the host and cast once to fp32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.common.pytrees import flatten_spec
from repro_torch.core.server import Downlink

PyTree = Any


class FedAvg:
    name = "fedavg"
    is_synchronous = True

    def __init__(self, init_params: PyTree, client_sizes: dict[Any, int]):
        self.spec = flatten_spec(init_params)
        self._vec = self.spec.flatten(init_params)
        self.client_sizes = client_sizes
        self.version = 0
        self._view: tuple[int, PyTree] = (0, init_params)  # (version, tree) cache

    @property
    def global_model(self) -> PyTree:
        """The global model as a tree of views into the vector, made once a
        version, so every client's ``model_for`` between rounds gets the
        same object (what the fleet's flatten cache keys on)."""
        if self._view[0] != self.version:
            self._view = (self.version, self.spec.unflatten(self._vec))
        return self._view[1]

    def initial_models(self, client_ids):
        return {cid: self.global_model for cid in client_ids}

    def model_for(self, client_id):
        return self.global_model

    def groups(self, client_ids):
        return {"global": list(client_ids)}

    def select(self, group_id, members, rnd):
        return list(members)  # waits for all devices

    def finish_round(self, group_id, uploads: dict, t: float):
        us = torch.stack([self.spec.flatten(p) for p in uploads.values()])
        w = np.asarray([self.client_sizes[cid] for cid in uploads], dtype=np.float64)
        ws = to_device((w / w.sum()).astype(np.float32), us.device)
        self._vec = torch.matmul(ws, us)
        self.version += 1
        return [Downlink(cid, self.global_model, self.version, 0, "broadcast") for cid in uploads]

    def stats(self):
        return {"version": self.version}
