"""Simulated mobile client: local training, feedback inputs, and the device
latency model (counterpart of ``repro.core.client``). The workload sits
behind ``task``; ``None`` means the paper's MLP task."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

PyTree = Any


@dataclasses.dataclass
class SimClient:
    client_id: int
    data: Any
    num_classes: int
    device_class: str
    round_time_fn: Any  # () -> seconds of local compute
    local_epochs: int = 5
    lr: float = 0.1

    # protocol state
    model: PyTree | None = None
    base_version: int = 0
    cluster_id: int | None = None
    partial_finetune: bool = False
    task: Any = None

    def _task(self):
        if self.task is None:
            from repro_torch.fl.tasks import MLP_TASK

            self.task = MLP_TASK
        return self.task

    def local_train(self, params: PyTree | None = None) -> tuple[PyTree, Any]:
        """One local training round; the loss comes back as a device scalar."""
        p = params if params is not None else self.model
        return self._task().local_train(
            p, self.data, epochs=self.local_epochs, lr=self.lr,
            head_only=self.partial_finetune,
        )

    def evaluate(self, params: PyTree | None = None) -> float:
        p = params if params is not None else self.model
        if p is None:
            return 0.0
        return self._task().evaluate(p, self.data)

    def feedback_inputs(self, params: PyTree) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(F_pred, F_true, S_soft) on the local training set (Eq. 2/3)."""
        return self._task().feedback_inputs(params, self.data, self.num_classes)

    def compute_time(self) -> float:
        return float(self.round_time_fn())
