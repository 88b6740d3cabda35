"""FedSEA [Sun et al. 2022]: semi-asynchronous — the server aggregates what
arrived at periodic synchronization points and drops the updates of
stragglers more than 2 versions behind (counterpart of
``repro.baselines.fedsea``)."""
from __future__ import annotations

from typing import Any

from repro_torch.common.pytrees import tree_lerp, tree_weighted_mean
from repro_torch.core.server import Downlink

PyTree = Any


class FedSEA:
    name = "fedsea"
    is_synchronous = False

    def __init__(self, init_params: PyTree, *, sync_interval: float = 120.0):
        self.global_model = init_params
        self.tick_interval = sync_interval
        self.version = 0
        self.buffer: dict[Any, tuple[PyTree, int]] = {}
        self.dropped = 0

    def initial_models(self, client_ids):
        return {cid: self.global_model for cid in client_ids}

    def model_for(self, client_id):
        return self.global_model

    def handle_upload(self, client_id, params, base_version, n_samples, t):
        if self.version - base_version > 2:  # a straggler past the window: dropped
            self.dropped += 1
            return [Downlink(client_id, self.global_model, self.version, 0, "unicast")]
        self.buffer[client_id] = (params, n_samples)
        return []  # held until the next synchronization point

    def on_tick(self, t):
        if not self.buffer:
            return []
        trees = [p for p, _ in self.buffer.values()]
        weights = [n for _, n in self.buffer.values()]
        incoming = tree_weighted_mean(trees, weights)
        # the buffered average blends into the global model (partial aggregation)
        frac = min(1.0, len(self.buffer) / 4)
        self.global_model = tree_lerp(self.global_model, incoming, 0.5 * frac + 0.25)
        self.version += 1
        out = [Downlink(cid, self.global_model, self.version, 0, "unicast") for cid in self.buffer]
        self.buffer.clear()
        return out

    def stats(self):
        return {"version": self.version, "dropped": self.dropped}
