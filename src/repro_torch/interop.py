"""Carry weights between the JAX package and the port as numpy arrays.

The reference draws its MLP init and its broadcast-RNN weights with
``jax.random``, which torch cannot reproduce; a parity test exports them as
numpy (``np.asarray`` on each leaf) and hands them over through these
helpers. This module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch


def mlp_params_from_numpy(layers, device="cpu") -> list[dict]:
    """``[{"w": (din, dout), "b": (dout,)}, ...]`` numpy -> fp32 tensors."""
    return [
        {k: torch.tensor(np.asarray(v, np.float32)).to(device) for k, v in layer.items()}
        for layer in layers
    ]


def mlp_params_to_numpy(layers) -> list[dict]:
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()} for layer in layers]


def rnn_params_from_numpy(params: dict, device="cpu") -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32)).to(device) for k, v in params.items()}


def rnn_params_to_numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
