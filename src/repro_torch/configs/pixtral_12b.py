"""Pixtral 12B's decoder: 40 layers, d_model 5120, 32 heads over 8 KV
heads, d_ff 14,336, vocab 131,072. The vision frontend is a stub: the
backbone takes patch embeddings ``(B, S, d_model)`` (``embeds_input``) and
predicts text tokens."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=40,
        embeds_input=True,
        rope_theta=1_000_000.0,
        train=TrainSpec(optimizer="adamw", microbatches=2, remat=True, dp_shard_params=True),
    )
)
