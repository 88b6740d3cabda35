"""Llama-3 405B: 126 layers, d_model 16,384, 128 heads over 8 KV heads,
d_ff 53,248, vocab 128,256. Trained with Adafactor and 16 microbatches."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="llama3-405b",
        family="dense",
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=126,
        rope_theta=500000.0,
        train=TrainSpec(optimizer="adafactor", microbatches=16, remat=True, dp_shard_params=True),
    )
)
