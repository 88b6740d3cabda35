"""Model and client-task configurations (copied from the reference).

Importing the package registers the reference's eleven architectures in
``ARCH_REGISTRY``: the dense decoders ``tiny_lm``, ``llama3.2-1b``,
``gemma2-2b``, ``command-r-35b``, ``llama3-405b`` and ``pixtral-12b``; the
MoE decoders ``granite-moe-3b-a800m`` and ``deepseek-v2-lite-16b`` (MLA, a
dense prefix layer); the hybrid ``jamba-1.5-large-398b`` (Mamba, MoE); the
recurrent ``xlstm-1.3b`` (mLSTM, sLSTM); and the encoder ``hubert-xlarge``.
``paper_tasks`` holds the paper's client MLPs."""
from repro_torch.configs.base import (
    ARCH_REGISTRY,
    SHAPES,
    LayerSpec,
    ModelConfig,
    ShapeSpec,
    TrainSpec,
    get_config,
    reduced_config,
    register_arch,
    supports_shape,
)
from repro_torch.configs import (  # noqa: F401  (registration)
    command_r_35b,
    deepseek_v2_lite_16b,
    gemma2_2b,
    granite_moe_3b_a800m,
    hubert_xlarge,
    jamba_1_5_large_398b,
    llama3_2_1b,
    llama3_405b,
    pixtral_12b,
    tiny_lm,
    xlstm_1_3b,
)
from repro_torch.configs.tiny_lm import TINY_LM

__all__ = ["ARCH_REGISTRY", "TINY_LM", "LayerSpec", "ModelConfig", "TrainSpec",
           "get_config", "reduced_config", "register_arch"]
