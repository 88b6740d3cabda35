"""Synthetic LM token streams (numpy copy of ``repro.data.lm``, same draw
order): a Zipfian unigram over a permuted support plus a deterministic
first-order Markov successor table, so that next-token loss can fall."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    zipf_a: float = 1.2
    markov_order: int = 1
    markov_weight: float = 0.5
    seed: int = 0


class TokenStream:
    """Next-token-prediction sequences from one stream distribution."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, min(v, 4096) + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._support = self.rng.permutation(v)[: len(ranks)]
        self._probs = probs / probs.sum()
        self._succ = self.rng.integers(0, len(ranks), size=len(ranks))

    def _sample_seq(self, n: int) -> np.ndarray:
        cfg = self.cfg
        idx = np.empty(n, dtype=np.int64)
        idx[0] = self.rng.choice(len(self._probs), p=self._probs)
        unigram = self.rng.choice(len(self._probs), p=self._probs, size=n)
        coins = self.rng.random(n)
        for t in range(1, n):
            if coins[t] < cfg.markov_weight:
                idx[t] = self._succ[idx[t - 1]]
            else:
                idx[t] = unigram[t]
        return self._support[idx]

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        seqs = np.stack([self._sample_seq(cfg.seq_len + 1) for _ in range(cfg.batch_size)])
        return seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int32)


def token_stream(vocab_size: int, seed: int = 0, batch: int = 4, seq: int = 32):
    """Infinite generator of train-step batches ``{"tokens", "labels"}``
    (int32 numpy, ``(batch, seq)``), the reference's draws."""
    stream = TokenStream(TokenStreamConfig(vocab_size=vocab_size, seq_len=seq, batch_size=batch, seed=seed))
    while True:
        tokens, labels = stream.next_batch()
        yield {"tokens": tokens, "labels": labels}
