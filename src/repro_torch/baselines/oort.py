"""Oort [Lai et al. 2021]: synchronous FL with guided participant selection
— a statistical utility discounted by system latency, plus
epsilon-greedy exploration (counterpart of ``repro.baselines.oort``; the
selection is the reference's numpy, the same ``rng`` draws in the same
order)."""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from repro_torch.common.pytrees import tree_weighted_mean
from repro_torch.core.server import Downlink

PyTree = Any


class Oort:
    name = "oort"
    is_synchronous = True

    def __init__(
        self,
        init_params: PyTree,
        client_sizes: dict[Any, int],
        round_time_hint: dict[Any, float],
        *,
        fraction: float = 0.5,
        explore: float = 0.2,
        alpha: float = 2.0,
        seed: int = 0,
    ):
        self.global_model = init_params
        self.client_sizes = client_sizes
        self.round_time_hint = round_time_hint
        self.fraction = fraction
        self.explore = explore
        self.alpha = alpha
        self.version = 0
        self.util: dict[Any, float] = {}
        self.last_selected = 0
        self.rng = np.random.default_rng(seed)

    def initial_models(self, client_ids):
        return {cid: self.global_model for cid in client_ids}

    def model_for(self, client_id):
        return self.global_model

    def groups(self, client_ids):
        return {"global": list(client_ids)}

    def select(self, group_id, members, rnd):
        k = max(1, int(len(members) * self.fraction))
        self.last_selected = k
        if rnd == 0 or not self.util:
            return list(self.rng.choice(members, size=k, replace=False))
        t_ref = float(np.median(list(self.round_time_hint.values())))

        def score(cid):
            stat = self.util.get(cid, max(self.util.values()))  # optimistic for the unexplored
            t_i = self.round_time_hint[cid]
            penalty = (t_ref / t_i) ** self.alpha if t_i > t_ref else 1.0
            return stat * penalty

        n_explore = int(k * self.explore)
        ranked = sorted(members, key=score, reverse=True)
        exploit = ranked[: k - n_explore]
        rest = [m for m in members if m not in exploit]
        explore = list(self.rng.choice(rest, size=min(n_explore, len(rest)), replace=False)) if rest else []
        return exploit + explore

    def finish_round(self, group_id, uploads: dict, t: float):
        trees = list(uploads.values())
        weights = [self.client_sizes[cid] for cid in uploads]
        self.global_model = tree_weighted_mean(trees, weights)
        self.version += 1
        # statistical utility proxy |B_i| * sqrt(|B_i|), as the reference takes it
        for cid in uploads:
            self.util[cid] = self.client_sizes[cid] * math.sqrt(self.client_sizes[cid])
        return [Downlink(cid, self.global_model, self.version, 0, "broadcast") for cid in uploads]

    def stats(self):
        return {"version": self.version, "selected_last_round": self.last_selected}
