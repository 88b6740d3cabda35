"""In-cluster on-demand model broadcast (paper Sec. 5).

Decision rule: broadcast iff the predicted next model change exceeds the
accumulated change since the last broadcast. A 2x128 tanh RNN reads the
cluster's Top-K recent L1-change records and emits [no-bcast, bcast]
logits; it is pre-trained on 1200 synthetic states and fine-tuned online
on every realized ground truth (Eq. 4). Counterpart of
``repro.core.broadcast``. The RNN's device work (a learn step, a decision,
a coalesced window's chain, the pretraining) is :mod:`repro_torch.kernels.rnn`:
one launch of ``csrc/rnn.cu`` on the card, autograd on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.rnn import HIDDEN, NUM_LAYERS, rnn_chain, rnn_sgd, rnn_want
from repro_torch.kernels.rnn import rnn_chain_step, rnn_logits  # noqa: F401  (the plain RNN, under its names here)

PyTree = Any
LEARN_LR = 1e-2  # the online fine-tune's SGD step (Eq. 4)
FALLBACK_THRESHOLD = 1.0  # cold start: broadcast iff the gap exceeds this times the change scale


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


# one SGD step (fresh params and the loss) and one decision (a device bool),
# each one rnn_chain launch on the card (kernels/rnn.py)
_rnn_sgd = rnn_sgd
_rnn_want = rnn_want


def predictor_chain(params: dict, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate,
                    lr: float = LEARN_LR) -> tuple[dict, torch.Tensor]:
    """The broadcast predictor's learn/decide steps of one cluster over a
    coalesced window, in order, with no host sync (counterpart of the
    reference's ``ops.predictor_chain``): one ``rnn_chain`` launch on the
    card, its plain version on the CPU.

    ``pre``/``post`` (S, k, 1) are the record windows before and after each
    step's observe, at the cluster's own ``k`` (the reference front-pads to
    a power of two only for its compile cache). ``lab_table`` (S, S + 1)
    ints and ``fb_table`` (S, S + 1) bools hold each step's Eq. 4 label and
    cold-start fallback decision for every "last fired position": column 0
    the window-start anchor, column q + 1 step q fired last. The chain
    carries the RNN weights and the fired position on the device, gathers
    each step's label and fallback decision from the tables there, and
    moves the position where a step wants a broadcast. The three gates are
    host booleans. Returns (final params, wants (S,) device bools), the
    weights and decisions of the serial learn/decide path."""
    return rnn_chain(params, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate, lr)


def build_seq(records: list, k: int) -> np.ndarray:
    """Normalized (k, 1) change-record window (zero front-padded)."""
    rec = records[-k:]
    rec = [0.0] * (k - len(rec)) + rec
    norm = max(max((abs(r) for r in rec), default=0.0), 1e-12)
    return np.asarray(rec, np.float32)[:, None] / norm


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

    def shadow(self) -> "BroadcastPredictor":
        """A copy whose records, scale and decision state can advance
        without touching this predictor (the coalesced planner's structure
        pass); the weights are shared, not copied."""
        return dataclasses.replace(self, records=list(self.records))

    def observe(self, change: float) -> None:
        self.records.append(float(change))
        self.records = self.records[-max(self.k, 1):]
        self.scale = 0.9 * self.scale + 0.1 * max(abs(change), 1e-12)

    def decision_kind(self) -> str:
        """Count a decision and name its rule: ``"inactive"`` (a fresh
        expansion: no broadcast, and the predictor resumes after it),
        ``"fallback"`` (cold start, fewer than two records) or ``"rnn"``."""
        self.decisions += 1
        if not self.active:
            self.active = True  # one suppressed decision, then resume
            return "inactive"
        return "fallback" if len(self.records) < 2 else "rnn"

    @staticmethod
    def fallback_wants(accumulated_gap: float, scale: float, threshold: float = FALLBACK_THRESHOLD) -> bool:
        """The cold-start rule: broadcast iff the gap exceeds the scaled threshold."""
        return accumulated_gap > threshold * scale

    def record_decision(self, want: bool) -> bool:
        """Count a broadcast where ``want``; returns ``want``."""
        if want:
            self.broadcasts += 1
        return want

    def decide(self, accumulated_gap: float, fallback_threshold: float = FALLBACK_THRESHOLD) -> bool:
        """RNN decision; when inactive (fresh expansion) never broadcast."""
        kind = self.decision_kind()
        if kind == "inactive":
            return False
        if kind == "fallback":
            want = self.fallback_wants(accumulated_gap, self.scale, fallback_threshold)
        else:
            want = bool(_rnn_want(self.params, build_seq(self.records, self.k)))
        return self.record_decision(want)

    def apply_decision(self, want: bool) -> bool:
        """:meth:`decide` with its outcome already known (the coalesced
        planner's; an inactive predictor's outcome is no broadcast)."""
        return self.record_decision(self.decision_kind() != "inactive" and want)

    def learn(self, label: int, lr: float = LEARN_LR) -> torch.Tensor:
        """Online fine-tune on the realized ground truth (Eq. 4); returns the
        loss as a device scalar (no host read)."""
        self.params, loss = _rnn_sgd(self.params, build_seq(self.records, self.k), label, lr)
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
    # no weights with the broadcast ablation (enable_broadcast=False): the merge keeps none
    merged_params = None if a.params is None else {name: 0.5 * (a.params[name] + b.params[name])
                                                    for name in a.params}
    out = BroadcastPredictor(params=merged_params, k=k, scale=max(a.scale, b.scale))
    out.records = rec_a + rec_b
    return out


# -------------------------------------------------------------- pretraining
def pretrain_windows(seed: int, k: int = 10, num_states: int = 1200) -> tuple[np.ndarray, np.ndarray]:
    """The synthetic historical states of Sec. 5.2.1 from ``seed``'s numpy
    stream: decaying change sequences labeled by the paper's text rule, as
    (num_states, k, 1) fp32 windows and (num_states, 1) labels. The draws
    do not depend on the weights, so they are all made before the training."""
    rng = np.random.default_rng(seed)
    windows = np.empty((num_states, k, 1), np.float32)
    labels = np.empty((num_states, 1), np.int64)
    for n in range(num_states):
        decay = rng.uniform(0.6, 1.5)
        base = rng.uniform(0.5, 2.0)
        noise = rng.uniform(0.02, 0.3)
        seq = base * decay ** np.arange(k) * (1 + noise * rng.standard_normal(k))
        seq = np.abs(seq)[::-1]  # oldest -> newest
        accumulated = float(np.sum(seq[-3:]))
        predicted_next = float(seq[-1] / decay)
        labels[n, 0] = 1 if predicted_next > 1.15 * accumulated / 3 else 0
        scale = max(float(np.max(seq)), 1e-9)
        windows[n] = (seq / scale).astype(np.float32)[:, None]
    return windows, labels


def pretrain_rnn(seed: int, k: int = 10, num_states: int = 1200, lr: float = 5e-3,
                 device="cpu") -> dict:
    """Pre-train on synthetic historical states (Sec. 5.2.1), one SGD step a
    state in draw order: one ``rnn_chain`` launch of ``num_states`` learn
    steps on the card. The reference derives its numpy stream from
    ``jax.random``; the port seeds it from ``seed``."""
    params = init_rnn(torch.Generator().manual_seed(seed), device=device)
    windows, labels = pretrain_windows(seed, k, num_states)
    learn = np.ones(len(labels), bool)
    params, _ = rnn_chain(params, windows, None, labels, None, learn, ~learn, ~learn, lr)
    return params
