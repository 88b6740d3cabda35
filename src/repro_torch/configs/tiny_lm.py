"""tiny_lm: CI-sized decoder, the LM personalization task's default frozen
base (d_model 64, 4 heads over 2 KV heads, 2 layers, 256-token vocab)."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

TINY_LM = register_arch(
    ModelConfig(
        name="tiny_lm",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=2,
        head_dim=16,
        tie_embeddings=True,
        rope_theta=10000.0,
        train=TrainSpec(optimizer="sgdm", remat=False),
        notes="CI-sized frozen base for the EchoPFL LM personalization task",
    )
)
