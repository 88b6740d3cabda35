"""Model and client-task configurations (copied from the reference).

Importing the package registers the dense decoders ``tiny_lm``,
``llama3.2-1b``, ``gemma2-2b``, ``command-r-35b``, ``llama3-405b`` and
``pixtral-12b`` in ``ARCH_REGISTRY``; ``paper_tasks`` holds the paper's
client MLPs."""
from repro_torch.configs.base import (
    ARCH_REGISTRY,
    LayerSpec,
    ModelConfig,
    TrainSpec,
    get_config,
    reduced_config,
    register_arch,
)
from repro_torch.configs import (  # noqa: F401  (registration)
    command_r_35b,
    gemma2_2b,
    llama3_2_1b,
    llama3_405b,
    pixtral_12b,
    tiny_lm,
)
from repro_torch.configs.tiny_lm import TINY_LM

__all__ = ["ARCH_REGISTRY", "TINY_LM", "LayerSpec", "ModelConfig", "TrainSpec",
           "get_config", "reduced_config", "register_arch"]
