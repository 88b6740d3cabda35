"""In-cluster on-demand model broadcast (paper Sec. 5).

Decision rule: broadcast iff the predicted next model change exceeds the
accumulated change since the last broadcast. A 2x128 tanh RNN reads the
cluster's Top-K recent L1-change records and emits [no-bcast, bcast]
logits; it is pre-trained on 1200 synthetic states and fine-tuned online
on every realized ground truth (Eq. 4). Counterpart of
``repro.core.broadcast``; gradients come from autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

PyTree = Any
HIDDEN = 128
NUM_LAYERS = 2


# ---------------------------------------------------------------- RNN model
def init_rnn(generator: torch.Generator, hidden: int = HIDDEN, device="cpu") -> dict:
    """Random RNN weights from ``generator`` (the reference draws these
    with ``jax.random``; its numbers cannot be reproduced here, so a parity
    test hands the reference's weights over instead)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32).to(device)

    params = {}
    dim_in = 1
    for layer in range(NUM_LAYERS):
        params[f"wx{layer}"] = normal(dim_in, hidden) / np.sqrt(dim_in)
        params[f"wh{layer}"] = normal(hidden, hidden) / np.sqrt(hidden)
        params[f"b{layer}"] = torch.zeros(hidden, device=device)
        dim_in = hidden
    params["w_out"] = normal(hidden, 2) / np.sqrt(hidden)
    params["b_out"] = torch.zeros(2, device=device)
    return params


def rnn_logits(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """seq: (T, 1) normalized change records -> (2,) logits."""
    x = seq
    h = None
    for layer in range(NUM_LAYERS):
        wx, wh, b = params[f"wx{layer}"], params[f"wh{layer}"], params[f"b{layer}"]
        h = torch.zeros(wh.shape[0], dtype=seq.dtype, device=seq.device)
        hs = []
        for t in range(x.shape[0]):
            h = torch.tanh(x[t] @ wx + h @ wh + b)
            hs.append(h)
        x = torch.stack(hs)
    return h @ params["w_out"] + params["b_out"]


def _rnn_sgd(params: dict, seq: torch.Tensor, label: int, lr: float) -> tuple[dict, torch.Tensor]:
    """One SGD step on -log softmax(logits)[label]; returns fresh params."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = -torch.log_softmax(rnn_logits(leaves, seq), dim=-1)[label]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def _rnn_want(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """Forward + first-index argmax decision (a device bool)."""
    return torch.argmax(rnn_logits(params, seq)) == 1


def build_seq(records: list, k: int) -> np.ndarray:
    """Normalized (k, 1) change-record window (zero front-padded)."""
    rec = records[-k:]
    rec = [0.0] * (k - len(rec)) + rec
    norm = max(max((abs(r) for r in rec), default=0.0), 1e-12)
    return np.asarray(rec, np.float32)[:, None] / norm


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


# ------------------------------------------------------------- per-cluster
@dataclasses.dataclass
class BroadcastPredictor:
    """Per-cluster predictor state: Top-K records + RNN weights."""

    params: dict
    k: int = 10
    records: list = dataclasses.field(default_factory=list)
    active: bool = True  # deactivated right after expansion (Sec. 5.2.2)
    scale: float = 1.0  # running normalizer for change degrees
    decisions: int = 0
    broadcasts: int = 0

    def observe(self, change: float) -> None:
        self.records.append(float(change))
        self.records = self.records[-max(self.k, 1):]
        self.scale = 0.9 * self.scale + 0.1 * max(abs(change), 1e-12)

    def _seq(self) -> torch.Tensor:
        return torch.from_numpy(build_seq(self.records, self.k)).to(_device_of(self.params))

    def decide(self, accumulated_gap: float, fallback_threshold: float = 1.0) -> bool:
        """RNN decision; when inactive (fresh expansion) never broadcast."""
        self.decisions += 1
        if not self.active:
            self.active = True  # one suppressed decision, then resume
            return False
        if len(self.records) < 2:  # cold start: rule-based fallback
            want = accumulated_gap > fallback_threshold * self.scale
        else:
            want = bool(_rnn_want(self.params, self._seq()))
        if want:
            self.broadcasts += 1
        return want

    def learn(self, label: int, lr: float = 1e-2) -> torch.Tensor:
        """Online fine-tune on the realized ground truth (Eq. 4); returns the
        loss as a device scalar (no host read)."""
        self.params, loss = _rnn_sgd(self.params, self._seq(), label, lr)
        return loss


# ------------------------------------------------------------ maintenance
def predictor_for_expansion(parent: BroadcastPredictor, change_of_new_client: float) -> BroadcastPredictor:
    """Reset records to the new client's change, inherit the RNN weights,
    deactivate broadcast (the center is already fresh)."""
    child = BroadcastPredictor(params=parent.params, k=parent.k, scale=parent.scale)
    child.records = [float(change_of_new_client)]
    child.active = False
    return child


def predictor_for_merge(a: BroadcastPredictor, b: BroadcastPredictor) -> BroadcastPredictor:
    """Resample Top-K records proportional to each side's record variance,
    average the two RNNs in weight space, keep the larger scale."""
    va = float(np.var(a.records)) if len(a.records) > 1 else 0.0
    vb = float(np.var(b.records)) if len(b.records) > 1 else 0.0
    total = va + vb
    k = max(a.k, b.k)
    if total <= 0:
        n_a = min(len(a.records), k // 2)
    else:
        n_a = int(round(k * va / total))
    n_a = min(n_a, len(a.records))
    n_b = min(k - n_a, len(b.records))
    rec_a = sorted(a.records, key=abs)[-n_a:] if n_a else []
    rec_b = sorted(b.records, key=abs)[-n_b:] if n_b else []
    merged_params = {name: 0.5 * (a.params[name] + b.params[name]) for name in a.params}
    out = BroadcastPredictor(params=merged_params, k=k, scale=max(a.scale, b.scale))
    out.records = rec_a + rec_b
    return out


# -------------------------------------------------------------- pretraining
def pretrain_rnn(seed: int, k: int = 10, num_states: int = 1200, lr: float = 5e-3,
                 device="cpu") -> dict:
    """Pre-train on synthetic historical states (Sec. 5.2.1): decaying change
    sequences labeled by the paper's text rule. The reference derives its
    numpy stream from ``jax.random``; the port seeds it from ``seed``."""
    params = init_rnn(torch.Generator().manual_seed(seed), device=device)
    rng = np.random.default_rng(seed)
    for _ in range(num_states):
        decay = rng.uniform(0.6, 1.5)
        base = rng.uniform(0.5, 2.0)
        noise = rng.uniform(0.02, 0.3)
        seq = base * decay ** np.arange(k) * (1 + noise * rng.standard_normal(k))
        seq = np.abs(seq)[::-1]  # oldest -> newest
        accumulated = float(np.sum(seq[-3:]))
        predicted_next = float(seq[-1] / decay)
        label = 1 if predicted_next > 1.15 * accumulated / 3 else 0
        scale = max(float(np.max(seq)), 1e-9)
        x = torch.as_tensor((seq / scale).astype(np.float32)[:, None], device=device)
        params, _ = _rnn_sgd(params, x, label, lr)
    return params
