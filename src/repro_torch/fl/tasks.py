"""The paper's MLP workload as the fleet engine, the simulator and the
server see it (counterpart of ``repro.fl.tasks``), and :func:`get_task`,
which also resolves the LM task of :mod:`repro_torch.fl.lm_task`.

``MLPTask`` delegates call for call to :mod:`repro_torch.models.mlp`. The
per-client methods take the device from the parameters they are given;
``build_fleet_data`` puts the padded ``(clients, n, ...)`` tensors on the
device it is asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass
class FleetData:
    """Batched device tensors for one fleet: ``train``/``test`` dicts of
    ``(clients, ...)`` tensors and the (clients, J) true label histograms."""

    train: dict[str, torch.Tensor]
    test: dict[str, torch.Tensor]
    f_true: torch.Tensor


def pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a per-client array's leading dim to ``n`` rows."""
    if len(arr) == n:
        return arr
    return np.concatenate([arr, np.zeros((n - len(arr),) + arr.shape[1:], arr.dtype)])


def _device_of(params: PyTree) -> torch.device:
    return params[0]["w"].device


@dataclasses.dataclass(frozen=True)
class MLPTask:
    name: str = "mlp"

    def init_params(self, generator: torch.Generator, cfg=None, device="cpu"):
        from repro_torch.configs.paper_tasks import PAPER_TASKS
        from repro_torch.models.mlp import init_mlp

        return init_mlp(cfg or PAPER_TASKS["image_recognition"], generator, device=device)

    # ---- fleet engine --------------------------------------------------
    def build_fleet_data(self, datasets, device, num_classes) -> FleetData:
        n_tr = max(len(d.y_train) for d in datasets)
        n_te = max(len(d.y_test) for d in datasets)

        def stack(arrs, n, dtype):
            return torch.from_numpy(np.stack([pad_rows(np.asarray(a, dtype), n) for a in arrs])).to(device)

        train = {
            "x": stack([d.x_train for d in datasets], n_tr, np.float32),
            "y": stack([d.y_train for d in datasets], n_tr, np.int64),
            "mask": stack([np.ones(len(d.y_train), np.float32) for d in datasets], n_tr, np.float32),
        }
        test = {
            "x": stack([d.x_test for d in datasets], n_te, np.float32),
            "y": stack([d.y_test for d in datasets], n_te, np.int64),
            "mask": stack([np.ones(len(d.y_test), np.float32) for d in datasets], n_te, np.float32),
        }
        f_true = torch.from_numpy(np.stack([
            d.label_histogram(num_classes).astype(np.float32) for d in datasets
        ])).to(device)
        return FleetData(train=train, test=test, f_true=f_true)

    def fleet_local_train(self, params_b, train, lr, epochs, head, *, max_epochs):
        from repro_torch.models import mlp

        return mlp.fleet_local_train(
            params_b, train["x"], train["y"], train["mask"], lr, epochs, head,
            max_epochs=max_epochs,
        )

    def fleet_evaluate(self, params_b, test):
        from repro_torch.models import mlp

        return mlp.fleet_evaluate(params_b, test["x"], test["y"], test["mask"])

    def fleet_feedback(self, params_b, train, num_classes):
        from repro_torch.models import mlp

        return mlp.fleet_predict_distributions(params_b, train["x"], train["mask"], num_classes)

    # ---- per-client ----------------------------------------------------
    def local_train(self, params, data, *, epochs, lr, head_only):
        from repro_torch.models import mlp

        dev = _device_of(params)
        return mlp.local_train(
            params, torch.as_tensor(data.x_train, device=dev),
            torch.as_tensor(data.y_train, device=dev).long(),
            epochs=epochs, lr=lr, head_only=head_only,
        )

    def evaluate(self, params, data) -> float:
        from repro_torch.models import mlp

        dev = _device_of(params)
        return float(mlp.evaluate(
            params, torch.as_tensor(data.x_test, device=dev),
            torch.as_tensor(data.y_test, device=dev).long(),
        ))

    def feedback_inputs(self, params, data, num_classes):
        from repro_torch.models import mlp

        dev = _device_of(params)
        f_pred, s_soft = mlp.predict_distributions(
            params, torch.as_tensor(data.x_train, device=dev), num_classes
        )
        f_true = data.label_histogram(num_classes)
        return f_pred.cpu().numpy(), f_true.astype(np.float32), s_soft.cpu().numpy()


MLP_TASK = MLPTask()


def get_task(name: str, device: str | torch.device = "cuda"):
    """The task by name: ``mlp`` (the paper's MLPs) or ``lm`` (the
    ``tiny_lm`` personalization task, its base on ``device``)."""
    if name == "mlp":
        return MLP_TASK
    if name == "lm":
        from repro_torch.fl.lm_task import default_lm_task

        return default_lm_task(device)
    raise ValueError(f"unknown task {name!r}: expected 'mlp' or 'lm'")
