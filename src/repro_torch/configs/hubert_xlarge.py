"""HuBERT X-Large: a bidirectional encoder of 48 layers, d_model 1280, 16
heads of width 80, d_ff 5120, over 504 cluster units (padded to 512). The
convolutional waveform frontend is a stub: the model takes frame
embeddings ``(batch, frames, d_model)`` with sinusoidal positions added,
and has no decode step."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=48,
        causal=False,
        is_encoder=True,
        embeds_input=True,
        train=TrainSpec(optimizer="adamw", microbatches=1, remat=True),
    )
)
