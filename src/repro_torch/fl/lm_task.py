"""Personalized LM fine-tuning as plane rows (counterpart of
``repro.fl.lm_task``).

Each simulated device personalizes a FROZEN decoder base (``tiny_lm`` by
default) by training a small delta tree:

* ``head_a``/``head_b`` — a LoRA factorization of the output head, merged
  into the tied embedding, so it personalizes the input lookup and the
  logits;
* ``wq`` — per-slot LoRA on the attention query projections of the
  stacked blocks, so local training runs the flash-attention kernels
  forward AND backward.

Only the delta rides the wire and becomes a plane row; the base lives in a
:class:`FrozenBase` outside every delta tree. LoRA b-factors start at zero,
so every client's initial row sits at the plane origin. Feedback (Eq. 2/3)
histograms token ids into ``buckets`` classes (``token_id % J``).

The fleet methods batch clients as a leading axis: delta leaves
``(C, ...)``, tokens ``(C, n, S)``, an attention batch of ``C·n``. The base
is shared; :meth:`LMTask.merged` builds each client's merged embedding and
query projection as the reference does. One backward of the summed
per-client losses gives every client its own gradient, exactly, since the
clients' parameters are disjoint. Epoch budgets and the head-only freeze of
the ``wq`` gradients are per-client ``torch.where``s, with no host sync
inside the epoch loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytrees import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import TokenStream, TokenStreamConfig
from repro_torch.fl.tasks import FleetData, pad_rows
from repro_torch.interop import tree_from_numpy
from repro_torch.models.model import forward as model_forward
from repro_torch.models.model import init_params as model_init_params

PyTree = Any


@dataclasses.dataclass(frozen=True, eq=False)
class FrozenBase:
    """Holder of the frozen base parameters: never a leaf of a delta tree,
    so payload bytes and plane rows count the delta alone."""

    params: PyTree


@dataclasses.dataclass
class LMClientData:
    """One client's token sequences, pre-split; ``n`` and
    ``label_histogram`` are what the coordination layers read."""

    tokens_train: np.ndarray  # (n_train, S) int32
    labels_train: np.ndarray  # (n_train, S) int32 next-token targets
    tokens_test: np.ndarray
    labels_test: np.ndarray
    latent_cluster: int = 0

    @property
    def n(self) -> int:
        return len(self.tokens_train)

    def label_histogram(self, num_classes: int) -> np.ndarray:
        """Counts of target tokens per ``token_id % J`` bucket."""
        return np.bincount(
            self.labels_train.reshape(-1) % num_classes, minlength=num_classes
        ).astype(np.float64)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (C,) per-client operand against a (C, ...) leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


@dataclasses.dataclass(frozen=True, eq=False)
class LMTask:
    """The personalization task over LoRA/head deltas on a frozen base."""

    base: FrozenBase
    cfg: ModelConfig
    lora_rank: int = 4
    buckets: int = 16
    name: str = "lm"

    def __post_init__(self):
        cfg = self.cfg
        if (cfg.prefix or cfg.mla is not None or cfg.is_encoder
                or any(s.mixer not in ("attn", "attn_local") or s.ffn != "dense" for s in cfg.pattern)):
            raise NotImplementedError(f"repro_torch: the LM task's per-client query deltas on {cfg.name} need "
                                      f"dense attention layers; MoE, MLA, recurrent, encoder and prefix layers "
                                      f"take no client axis (not ported)")

    @property
    def device(self) -> torch.device:
        return self.base.params["embed"].device

    # ---- delta tree ------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> PyTree:
        """LoRA init on the base's device: ``a`` factors normal / sqrt(d)
        from ``generator``, ``b`` factors zero (an exact zero update)."""
        cfg, r = self.cfg, self.lora_rank
        d, V, P = cfg.d_model, cfg.padded_vocab, cfg.num_periods
        dev = self.device

        def normal(*shape):
            return (torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(d)).to(dev)

        delta: dict[str, Any] = {
            "head_a": normal(d, r),
            "head_b": torch.zeros((r, V), device=dev),
            "wq": {},
        }
        hk = cfg.num_heads * cfg.resolved_head_dim
        for i in range(len(cfg.pattern)):  # every slot is an attention layer
            delta["wq"][f"slot{i}"] = {"a": normal(P, d, r), "b": torch.zeros((P, r, hk), device=dev)}
        return delta

    def merged(self, delta: PyTree) -> PyTree:
        """Base + delta as forward params. A delta with leaves ``(C, ...)``
        gives client-batched params: ``embed (C, V, d)`` and per-slot
        ``wq (P, C, d, H, hd)``."""
        base = self.base.params
        scale = 1.0 / self.lora_rank
        batched = delta["head_a"].dim() == 3
        params = dict(base)
        head_upd = (delta["head_a"] @ delta["head_b"]) * scale  # ([C,] d, V)
        params["embed"] = base["embed"] + head_upd.transpose(-1, -2)  # tied embeddings
        if delta["wq"]:
            blocks = dict(base["blocks"])
            for slot, ab in delta["wq"].items():
                a, b = ab["a"], ab["b"]
                wq = blocks[slot]["mixer"]["wq"]  # (P, d, H, hd)
                if batched:  # (C, P, ...) -> (P, C, ...): the period axis stays in front
                    a, b, wq = a.transpose(0, 1), b.transpose(0, 1), wq[:, None]
                upd = (a @ b) * scale
                mixer = dict(blocks[slot]["mixer"], wq=wq + upd.reshape(*upd.shape[:-1], *wq.shape[-2:]))
                blocks[slot] = dict(blocks[slot], mixer=mixer)
            params["blocks"] = blocks
        return params

    # ---- batched arithmetic (leading client axis) -------------------------
    def _logits(self, delta_b, tokens):
        return model_forward(self.cfg, self.merged(delta_b), {"tokens": tokens})[0].to(torch.float32)

    @staticmethod
    def _denom(mask, seq_len):
        return torch.clamp_min(torch.sum(mask, dim=1) * seq_len, 1.0)

    def _nll(self, delta_b, tokens, labels, mask) -> torch.Tensor:
        """(C,) mean next-token NLL over each client's valid sequences."""
        logp = torch.log_softmax(self._logits(delta_b, tokens), dim=-1)
        per = torch.gather(logp, -1, labels[..., None])[..., 0]  # (C, n, S)
        per = per * mask[:, :, None]
        return -(torch.sum(per, dim=(1, 2)) / self._denom(mask, tokens.shape[-1]))

    def _accuracy(self, delta_b, tokens, labels, mask) -> torch.Tensor:
        pred = torch.argmax(self._logits(delta_b, tokens), dim=-1)
        correct = (pred == labels).to(torch.float32) * mask[:, :, None]
        return torch.sum(correct, dim=(1, 2)) / self._denom(mask, tokens.shape[-1])

    def _distributions(self, delta_b, tokens, mask, num_classes: int):
        """(F_pred (C, J), S_soft (C, J)) over ``token_id % J`` buckets."""
        J = num_classes
        logits = self._logits(delta_b, tokens)  # (C, n, S, V)
        probs = torch.softmax(logits, dim=-1)
        pred = torch.argmax(logits, dim=-1)
        V = logits.shape[-1]
        bucket = torch.nn.functional.one_hot(torch.arange(V, device=logits.device) % J, J).to(torch.float32)
        valid = mask[:, :, None, None]  # (C, n, 1, 1)
        onehot = torch.nn.functional.one_hot(pred % J, J).to(torch.float32) * valid
        hist = torch.sum(onehot, dim=(1, 2))
        sprob = (probs @ bucket) * valid
        return hist, torch.sum(sprob, dim=(1, 2)) / self._denom(mask, tokens.shape[-1])[:, None]

    # ---- fleet engine ------------------------------------------------------
    def build_fleet_data(self, datasets, device, num_classes) -> FleetData:
        n_tr = max(d.n for d in datasets)
        n_te = max(len(d.tokens_test) for d in datasets)

        def stack(attr, n):  # int64: what indexing and gather take
            return torch.from_numpy(np.stack(
                [pad_rows(np.asarray(getattr(d, attr), np.int64), n) for d in datasets]
            )).to(device)

        def masks(n, lens):
            return torch.from_numpy(np.stack([pad_rows(np.ones(k, np.float32), n) for k in lens])).to(device)

        train = {
            "tokens": stack("tokens_train", n_tr),
            "labels": stack("labels_train", n_tr),
            "mask": masks(n_tr, [d.n for d in datasets]),
        }
        test = {
            "tokens": stack("tokens_test", n_te),
            "labels": stack("labels_test", n_te),
            "mask": masks(n_te, [len(d.tokens_test) for d in datasets]),
        }
        f_true = torch.from_numpy(np.stack([
            d.label_histogram(num_classes).astype(np.float32) for d in datasets
        ])).to(device)
        return FleetData(train=train, test=test, f_true=f_true)

    def fleet_local_train(self, params_b, train, lr, epochs, head, *, max_epochs: int):
        """``max_epochs`` full-batch SGD steps on every client's delta;
        client c steps only while ``e < epochs[c]``, and ``head[c] > 0``
        selects its ``wq`` gradients to exact zeros. Returns (delta_b, (C,)
        losses of each client's last active step)."""
        tokens, labels, mask = train["tokens"], train["labels"], train["mask"]
        p = tree_map(lambda t: t.detach(), params_b)
        loss = torch.zeros(tokens.shape[0], device=tokens.device)
        freeze_body = head > 0
        for e in range(max_epochs):
            pg = tree_map(lambda t: t.detach().requires_grad_(True), p)
            with torch.enable_grad():
                losses = self._nll(pg, tokens, labels, mask)
                body = tree_leaves(pg["wq"])
                grads = torch.autograd.grad(losses.sum(), [pg["head_a"], pg["head_b"], *body])
            g_body = iter(torch.where(_rows(freeze_body, g), torch.zeros((), device=g.device), g)
                          for g in grads[2:])
            g_tree = {"head_a": grads[0], "head_b": grads[1], "wq": tree_map(lambda _: next(g_body), pg["wq"])}
            active = e < epochs

            def step(old, g):
                old = old.detach()
                return torch.where(_rows(active, old), old - _rows(lr, g) * g, old)

            p = tree_map(step, pg, g_tree)
            loss = torch.where(active, losses.detach(), loss)
        return p, loss

    def fleet_evaluate(self, params_b, test) -> torch.Tensor:
        with torch.no_grad():
            return self._accuracy(params_b, test["tokens"], test["labels"], test["mask"])

    def fleet_feedback(self, params_b, train, num_classes):
        with torch.no_grad():
            return self._distributions(params_b, train["tokens"], train["mask"], num_classes)

    # ---- per-client entry points (SimClient) ------------------------------
    def _one(self, data, split: str):
        tok = torch.as_tensor(np.asarray(getattr(data, f"tokens_{split}"), np.int64), device=self.device)
        lab = torch.as_tensor(np.asarray(getattr(data, f"labels_{split}"), np.int64), device=self.device)
        return tok[None], lab[None], torch.ones((1, len(tok)), device=self.device)

    def local_train(self, params, data, *, epochs, lr, head_only):
        tok, lab, mask = self._one(data, "train")
        dev = self.device
        new, loss = self.fleet_local_train(
            tree_map(lambda t: t[None], params), {"tokens": tok, "labels": lab, "mask": mask},
            torch.full((1,), lr, device=dev), torch.full((1,), epochs, dtype=torch.int32, device=dev),
            torch.full((1,), 1.0 if head_only else 0.0, device=dev), max_epochs=epochs,
        )
        return tree_map(lambda t: t[0], new), loss[0]

    def evaluate(self, params, data) -> float:
        tok, lab, mask = self._one(data, "test")
        return float(self.fleet_evaluate(tree_map(lambda t: t[None], params),
                                         {"tokens": tok, "labels": lab, "mask": mask})[0])

    def feedback_inputs(self, params, data, num_classes):
        tok, _, mask = self._one(data, "train")
        f_pred, s_soft = self.fleet_feedback(tree_map(lambda t: t[None], params),
                                             {"tokens": tok, "mask": mask}, num_classes)
        f_true = data.label_histogram(num_classes)
        return f_pred[0].cpu().numpy(), f_true.astype(np.float32), s_soft[0].cpu().numpy()


# ---------------------------------------------------------------------------
# data + experiment entry points
# ---------------------------------------------------------------------------


def default_lm_task(device="cuda", *, base_params: PyTree | None = None) -> LMTask:
    """The ``tiny_lm`` task: its base drawn from ``torch.Generator`` seed 0
    on the CPU (the same weights on every device), or ``base_params``
    (numpy, e.g. the reference's) handed over."""
    dev = resolve_device(device)
    cfg = get_config("tiny_lm")
    if base_params is None:
        base = model_init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    else:
        base = tree_from_numpy(base_params, dev)
    return LMTask(base=FrozenBase(base), cfg=cfg)


def make_lm_data(
    num_clients: int,
    *,
    vocab_size: int,
    latent_clusters: int = 4,
    n_train: int = 8,
    n_test: int = 4,
    seq_len: int = 32,
    seed: int = 0,
) -> list[LMClientData]:
    """Per-client token datasets: the clients of a latent cluster share one
    stream distribution and draw their own sequences (the reference's
    draws, in its order)."""
    out = []
    for i in range(num_clients):
        cl = i % latent_clusters
        stream = TokenStream(TokenStreamConfig(
            vocab_size=vocab_size, seq_len=seq_len, batch_size=1,
            seed=7000 + 17 * cl + seed,
        ))
        stream.rng = np.random.default_rng(100_003 * (seed + 1) + i)
        seqs = np.stack([stream._sample_seq(seq_len + 1) for _ in range(n_train + n_test)])
        tok, lab = seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int32)
        out.append(LMClientData(
            tokens_train=tok[:n_train], labels_train=lab[:n_train],
            tokens_test=tok[n_train:], labels_test=lab[n_train:],
            latent_cluster=cl,
        ))
    return out


def build_lm_clients(
    num_clients: int,
    *,
    seed: int = 0,
    latent_clusters: int = 4,
    device_mix: dict | None = None,
    base_round_time: float = 30.0,
    local_epochs: int = 2,
    lr: float = 0.5,
    n_train: int = 8,
    n_test: int = 4,
    seq_len: int = 32,
    task: LMTask | None = None,
    device: str | torch.device = "cuda",
    base_params: PyTree | None = None,
    init_params: PyTree | None = None,
):
    """(clients, task, init_delta). Without ``task`` the ``tiny_lm`` task
    (``base_params`` handed over, else drawn); the initial delta is
    ``init_params`` (numpy) handed over, else drawn from ``seed``."""
    from repro_torch.core.client import SimClient
    from repro_torch.fl.devices import PAPER_SIM_MIX, make_device_fleet

    dev = resolve_device(device)
    task = task or default_lm_task(dev, base_params=base_params)
    rng = np.random.default_rng(seed)
    datasets = make_lm_data(
        num_clients, vocab_size=task.cfg.vocab_size, latent_clusters=latent_clusters,
        n_train=n_train, n_test=n_test, seq_len=seq_len, seed=seed,
    )
    fleet = make_device_fleet(num_clients, rng, device_mix or PAPER_SIM_MIX, base_round_time)
    clients = [
        SimClient(
            client_id=i,
            data=datasets[i],
            num_classes=task.buckets,
            device_class=fleet[i]["class"],
            round_time_fn=fleet[i]["round_time"],
            local_epochs=local_epochs,
            lr=lr,
            task=task,
        )
        for i in range(num_clients)
    ]
    if init_params is None:
        init_delta = task.init_params(torch.Generator().manual_seed(seed))
    else:
        init_delta = tree_from_numpy(init_params, dev)
    return clients, task, init_delta


def run_lm_experiment(
    strategy_name: str,
    *,
    num_clients: int = 8,
    seed: int = 0,
    max_time: float = 1800.0,
    rounds: int = 5,
    eval_interval: float = 120.0,
    network=None,
    local_epochs: int = 2,
    base_round_time: float = 30.0,
    latent_clusters: int = 4,
    n_train: int = 8,
    n_test: int = 4,
    seq_len: int = 32,
    device: str | torch.device = "cuda",
    task: LMTask | None = None,
    base_params: PyTree | None = None,
    init_params: PyTree | None = None,
    rnn_params: dict | None = None,
    coalesce_window: float = 0.0,
    uplink=None,
    plane_mesh=None,
    fleet_mesh=None,
    client_backend: str = "fleet",
    **strategy_kw,
):
    """End-to-end LM personalization run: a synchronous strategy runs
    ``rounds`` round barriers, an asynchronous one the event loop, per event
    or with ``coalesce_window`` > 0 coalesced; ``uplink`` compresses the
    uploaded deltas, ``plane_mesh`` and ``fleet_mesh`` shard the server's
    plane and the fleet (``mesh_min_rows`` rides ``strategy_kw``), and
    ``client_backend`` picks the batched fleet or the per-client loop, as in
    ``run_experiment``. Returns (task, clients, strategy, report) like
    :func:`repro_torch.fl.experiment.run_experiment`."""
    from repro_torch.fl.experiment import build_strategy
    from repro_torch.fl.network import NetworkModel
    from repro_torch.fl.simulator import Simulator
    from repro_torch.launch.mesh import resolve_mesh

    dev = resolve_device(device)
    plane_mesh, fleet_mesh = resolve_mesh(plane_mesh, dev), resolve_mesh(fleet_mesh, dev)
    clients, task, init_delta = build_lm_clients(
        num_clients, seed=seed, latent_clusters=latent_clusters,
        base_round_time=base_round_time, local_epochs=local_epochs,
        n_train=n_train, n_test=n_test, seq_len=seq_len, task=task, device=dev,
        base_params=base_params, init_params=init_params,
    )
    strategy = build_strategy(strategy_name, init_delta, clients, seed=seed, rnn_params=rnn_params,
                              device=dev, plane_mesh=plane_mesh, **strategy_kw)
    sim = Simulator(clients, strategy, network=network or NetworkModel(), eval_interval=eval_interval,
                    seed=seed, coalesce_window=coalesce_window, uplink=uplink, fleet_mesh=fleet_mesh,
                    client_backend=client_backend)
    report = sim.run(max_time=max_time, rounds=rounds)
    report.extra["task"] = "lm"
    report.extra["latent_clusters"] = {c.client_id: c.data.latent_cluster for c in clients}
    return task, clients, strategy, report
