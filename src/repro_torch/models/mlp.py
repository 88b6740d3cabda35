"""Small MLP client models for the paper's four tasks (Sec. 7.1).

Parameters are a list of ``{"w": (din, dout), "b": (dout,)}`` dicts, the
reference's layout. Two call planes, as in ``repro.models.mlp``:

* per-client ``local_train`` / ``evaluate`` / ``predict_distributions``;
* fleet ``fleet_local_train`` / ``fleet_evaluate`` /
  ``fleet_predict_distributions`` over a leading client dimension
  (``bmm``), with per-sample validity masks, per-row ``lr``, per-row epoch
  budgets (steps past a budget leave the row untouched) and head-only
  fine-tuning by selecting the body gradients to exact zeros.

Gradients come from autograd; every batched row only ever touches its own
loss, so one backward of the summed losses gives each row its own gradient.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.paper_tasks import MLPTaskConfig

PyTree = Any


def init_mlp(cfg: MLPTaskConfig, generator: torch.Generator, device="cpu") -> list[dict]:
    """Random init from ``generator`` (normal / sqrt(din), zero biases)."""
    dims = (cfg.input_dim, *cfg.hidden, cfg.num_classes)
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=torch.float32) / (din ** 0.5)
        params.append({"w": w.to(device), "b": torch.zeros(dout, device=device)})
    return params


def mlp_forward(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def _leaves(params: list[dict]) -> list[torch.Tensor]:
    return [t for layer in params for t in (layer["b"], layer["w"])]


def _with_grad(params: list[dict]) -> list[dict]:
    return [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]


def _sgd_epoch(params: list[dict], x, y, lr: float, head_only: bool = False):
    p = _with_grad(params)
    with torch.enable_grad():
        logp = torch.log_softmax(mlp_forward(p, x), dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None].long()))
        grads = torch.autograd.grad(loss, _leaves(p))
    new = []
    last = len(p) - 1
    for i, layer in enumerate(p):
        gb, gw = grads[2 * i], grads[2 * i + 1]
        if head_only and i != last:  # partial fine-tuning after expansion (Sec. 4.3.3)
            gb, gw = torch.zeros_like(gb), torch.zeros_like(gw)
        new.append({"b": (layer["b"] - lr * gb).detach(), "w": (layer["w"] - lr * gw).detach()})
    return new, loss.detach()


def local_train(params: list[dict], x: torch.Tensor, y: torch.Tensor, *, epochs: int = 5,
                lr: float = 0.1, head_only: bool = False):
    """Per-client full-batch SGD; returns (params, loss as a device scalar)."""
    loss = torch.zeros((), device=x.device)
    for _ in range(epochs):
        params, loss = _sgd_epoch(params, x, y, lr, head_only=head_only)
    return params, loss


def evaluate(params: list[dict], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(mlp_forward(params, x), dim=-1)
    return torch.mean((pred == y).to(torch.float32))


def predict_distributions(params: list[dict], x: torch.Tensor, num_classes: int):
    """(predicted-label histogram F_c, mean soft-label distribution S_c)."""
    logits = mlp_forward(params, x)
    soft = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits, dim=-1)
    hist = torch.bincount(pred, minlength=num_classes).to(torch.float32)
    return hist, torch.mean(soft, dim=0)


# ------------------------------------------------------------------ fleet
def _bforward(params_b: list[dict], x: torch.Tensor) -> torch.Tensor:
    """Batched forward: leaves (K, ...), x (K, n, din) -> (K, n, classes)."""
    for layer in params_b[:-1]:
        x = torch.relu(torch.bmm(x, layer["w"]) + layer["b"][:, None, :])
    return torch.bmm(x, params_b[-1]["w"]) + params_b[-1]["b"][:, None, :]


def _masked_nll(params_b, x, y, mask) -> torch.Tensor:
    """(K,) mean NLL over each row's valid samples."""
    logp = torch.log_softmax(_bforward(params_b, x), dim=-1)
    per = torch.gather(logp, 2, y[:, :, None].long())[:, :, 0]
    per = torch.where(mask > 0, per, torch.zeros((), device=per.device))
    return -(torch.sum(per, dim=1) / torch.clamp_min(torch.sum(mask, dim=1), 1.0))


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) per-row operand against a (K, ...) leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def fleet_local_train(params_b: list[dict], x, y, mask, lr, epochs, head_frac, *, max_epochs: int):
    """Local training for a whole client batch: ``max_epochs`` steps, row k
    stepping only while ``e < epochs[k]``. Returns (params_b, (K,) losses)."""
    p = [{k: v.detach() for k, v in layer.items()} for layer in params_b]
    K = x.shape[0]
    loss = torch.zeros(K, device=x.device)
    freeze_body = head_frac > 0
    last = len(p) - 1
    for e in range(max_epochs):
        pg = _with_grad(p)
        with torch.enable_grad():
            losses = _masked_nll(pg, x, y, mask)
            grads = torch.autograd.grad(losses.sum(), _leaves(pg))
        active = e < epochs
        new_p = []
        for i, layer in enumerate(pg):
            upd = {}
            for j, name in enumerate(("b", "w")):
                old = layer[name].detach()
                g = grads[2 * i + j]
                if i != last:
                    g = torch.where(_rows(freeze_body, g), torch.zeros((), device=g.device), g)
                new = old - _rows(lr, g) * g
                upd[name] = torch.where(_rows(active, old), new, old)
            new_p.append(upd)
        p = new_p
        loss = torch.where(active, losses.detach(), loss)
    return p, loss


def _masked_accuracy(params_b, x, y, mask) -> torch.Tensor:
    pred = torch.argmax(_bforward(params_b, x), dim=-1)
    correct = torch.where(mask > 0, (pred == y).to(torch.float32), torch.zeros((), device=x.device))
    return torch.sum(correct, dim=1) / torch.clamp_min(torch.sum(mask, dim=1), 1.0)


def fleet_evaluate(params_b, x, y, mask) -> torch.Tensor:
    """(K,) masked accuracies."""
    return _masked_accuracy(params_b, x, y, mask)


def fleet_predict_distributions(params_b, x, mask, num_classes: int):
    """Batched feedback probe: (F (K, J), S (K, J))."""
    logits = _bforward(params_b, x)
    soft = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits, dim=-1)
    valid = (mask > 0)[:, :, None]
    classes = torch.arange(num_classes, device=x.device)
    onehot = ((pred[:, :, None] == classes) & valid).to(torch.float32)
    hist = torch.sum(onehot, dim=1)
    zero = torch.zeros((), device=x.device)
    smean = torch.sum(torch.where(valid, soft, zero), dim=1) / torch.clamp_min(
        torch.sum(mask, dim=1), 1.0
    )[:, None]
    return hist, smean
