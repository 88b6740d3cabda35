"""Command-R 35B: 40 layers, d_model 8192, 64 heads over 8 KV heads,
d_ff 22,528, vocab 256,000, tied embeddings, no biases."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="command-r-35b",
        family="dense",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256000,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=40,
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        train=TrainSpec(optimizer="adamw", microbatches=4, remat=True, dp_shard_params=True),
    )
)
