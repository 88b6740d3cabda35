"""Standalone: each client trains locally, with no federation — the
paper's lower bound (counterpart of ``repro.baselines.standalone``)."""
from __future__ import annotations

from typing import Any

from repro_torch.core.server import Downlink

PyTree = Any


class Standalone:
    name = "standalone"
    is_synchronous = True

    def __init__(self, init_params: PyTree):
        self.init_params = init_params
        self.models: dict[Any, PyTree] = {}

    def initial_models(self, client_ids):
        return {cid: self.init_params for cid in client_ids}

    def model_for(self, client_id):
        return self.models.get(client_id, self.init_params)

    def groups(self, client_ids):
        return {cid: [cid] for cid in client_ids}

    def select(self, group_id, members, rnd):
        return list(members)

    def finish_round(self, group_id, uploads: dict, t: float):
        (cid, params), = uploads.items()
        self.models[cid] = params
        return [Downlink(cid, params, 0, 0, "local")]

    def stats(self):
        return {}
