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

from repro_torch.common.device import to_device

PyTree = Any
HIDDEN = 128
NUM_LAYERS = 2
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


def _rnn_sgd(params: dict, seq: torch.Tensor, label: int | torch.Tensor, lr: float) -> tuple[dict, torch.Tensor]:
    """One SGD step on -log softmax(logits)[label]; returns fresh params.
    ``label`` is an int or a (1,) int64 device tensor (read without a host
    sync); both give the same gradient bits."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        logp = torch.log_softmax(rnn_logits(leaves, seq), dim=-1)
        loss = -(logp[label] if isinstance(label, int) else logp.index_select(0, label)[0])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def _rnn_want(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """Forward + first-index argmax decision (a device bool)."""
    return torch.argmax(rnn_logits(params, seq)) == 1


def rnn_chain_step(params: dict, pre: torch.Tensor, post: torch.Tensor, label: torch.Tensor,
                   learn_gate: bool, decide_gate: bool, lr: float) -> tuple[dict, torch.Tensor | None]:
    """One upload's predictor work in a coalesced window (the step of
    :func:`predictor_chain`): the SGD step on the pre-observe window when
    ``learn_gate``, then the broadcast decision on the post-observe window
    when ``decide_gate`` (a device bool, else None). The gates are host
    booleans, so a skipped body costs nothing; ``label`` is a (1,) device
    tensor. The same arithmetic as a serial :meth:`BroadcastPredictor.learn`
    then :meth:`BroadcastPredictor.decide`."""
    if learn_gate:
        params, _ = _rnn_sgd(params, pre, label, lr)
    return params, (_rnn_want(params, post) if decide_gate else None)


def predictor_chain(params: dict, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate,
                    lr: float = LEARN_LR) -> tuple[dict, torch.Tensor]:
    """The broadcast predictor's learn/decide steps of one cluster over a
    coalesced window, in order, with no host sync (counterpart of the
    reference's ``ops.predictor_chain``; plain PyTorch, not a kernel).

    ``pre``/``post`` (S, k, 1) are the record windows before and after each
    step's observe, at the cluster's own ``k`` (the reference front-pads to
    a power of two only for its compile cache). ``lab_table`` (S, S + 1)
    ints and ``fb_table`` (S, S + 1) bools hold each step's Eq. 4 label and
    cold-start fallback decision for every "last fired position": column 0
    the window-start anchor, column q + 1 step q fired last. The chain
    carries the RNN weights and the fired position ``fire`` as a device
    int, gathers each step's label and fallback decision from the tables on
    the device, and moves ``fire`` where a step wants a broadcast. The
    three gates are host booleans. Returns (final params, wants (S,) device
    bools), the weights and decisions of the serial learn/decide path."""
    dev = _device_of(params)
    pre_d = to_device(np.asarray(pre, np.float32), dev)
    post_d = to_device(np.asarray(post, np.float32), dev)
    lab_d = to_device(np.asarray(lab_table, np.int64), dev)
    fb_d = to_device(np.asarray(fb_table, np.bool_), dev)
    fire = torch.zeros(1, dtype=torch.long, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    wants = []
    for p in range(len(learn_gate)):
        params, want = rnn_chain_step(params, pre_d[p], post_d[p], lab_d[p].index_select(0, fire),
                                      bool(learn_gate[p]), bool(decide_gate[p]), lr)
        if fb_gate[p]:
            want = fb_d[p].index_select(0, fire)[0]
        elif want is None:
            want = no
        fire = torch.where(want, p + 1, fire)
        wants.append(want)
    return params, torch.stack(wants)


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

    def shadow(self) -> "BroadcastPredictor":
        """A copy whose records, scale and decision state can advance
        without touching this predictor (the coalesced planner's structure
        pass); the weights are shared, not copied."""
        return dataclasses.replace(self, records=list(self.records))

    def observe(self, change: float) -> None:
        self.records.append(float(change))
        self.records = self.records[-max(self.k, 1):]
        self.scale = 0.9 * self.scale + 0.1 * max(abs(change), 1e-12)

    def _seq(self) -> torch.Tensor:
        return torch.from_numpy(build_seq(self.records, self.k)).to(_device_of(self.params))

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
            want = bool(_rnn_want(self.params, self._seq()))
        return self.record_decision(want)

    def apply_decision(self, want: bool) -> bool:
        """:meth:`decide` with its outcome already known (the coalesced
        planner's; an inactive predictor's outcome is no broadcast)."""
        return self.record_decision(self.decision_kind() != "inactive" and want)

    def learn(self, label: int, lr: float = LEARN_LR) -> torch.Tensor:
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
    # no weights with the broadcast ablation (enable_broadcast=False): the merge keeps none
    merged_params = None if a.params is None else {name: 0.5 * (a.params[name] + b.params[name])
                                                    for name in a.params}
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
