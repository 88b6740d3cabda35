"""Crash-safe checkpoints: the EchoPFL server's restart goes through them."""
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore_pytree, save_pytree

__all__ = ["Checkpointer", "save_pytree", "restore_pytree", "latest_step"]
