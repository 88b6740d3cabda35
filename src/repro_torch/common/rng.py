"""Deterministic numpy RNG plumbing (the reference's ``np_rng``)."""
from __future__ import annotations

import hashlib

import numpy as np


def np_rng(seed: int | str) -> np.random.Generator:
    if isinstance(seed, str):
        seed = int.from_bytes(hashlib.sha256(seed.encode()).digest()[:8], "little")
    return np.random.default_rng(seed)
