"""Model and client-task configurations (copied from the reference).

Importing the package registers ``tiny_lm`` and ``llama3.2-1b`` in
``ARCH_REGISTRY``; ``paper_tasks`` holds the paper's client MLPs."""
from repro_torch.configs.base import (
    ARCH_REGISTRY,
    LayerSpec,
    ModelConfig,
    TrainSpec,
    get_config,
    register_arch,
)
from repro_torch.configs import llama3_2_1b, tiny_lm  # noqa: F401  (registration)
from repro_torch.configs.tiny_lm import TINY_LM

__all__ = ["ARCH_REGISTRY", "TINY_LM", "LayerSpec", "ModelConfig", "TrainSpec",
           "get_config", "register_arch"]
