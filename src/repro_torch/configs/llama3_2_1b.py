"""Llama-3.2 1B: 16 layers, d_model 2048, 32 heads (GQA, 8 KV heads),
d_ff 8192, vocab 128,256, tied embeddings."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="llama3.2-1b",
        family="dense",
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        pattern=(LayerSpec("attn", "dense"),),
        num_periods=16,
        tie_embeddings=True,
        rope_theta=500000.0,
        train=TrainSpec(optimizer="adamw", microbatches=1, remat=True),
    )
)
