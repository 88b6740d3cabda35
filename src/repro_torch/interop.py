"""Carry weights between the JAX package and the port as numpy arrays.

The reference draws its MLP init, its broadcast-RNN weights, the LM task's
frozen base and its initial delta with ``jax.random``, which torch cannot
reproduce; a parity test exports them as numpy (``np.asarray`` on each
leaf) and hands them over through these helpers. This module imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.pytrees import rebuild_seq

PyTree = Any


def tree_from_numpy(tree: PyTree, device="cpu") -> PyTree:
    """Nested dicts / lists / tuples of arrays -> the same structure of fp32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild_seq(tree, [tree_from_numpy(v, device) for v in tree])
    return torch.tensor(np.asarray(tree, np.float32)).to(device)


def tree_to_numpy(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild_seq(tree, [tree_to_numpy(v) for v in tree])
    return tree.detach().cpu().numpy()

