"""IBM Granite MoE 3B-a800m: 32 layers, d_model 1536, 24 heads over 8 KV
heads of width 64, an MoE of 40 experts (top 8), each 512 wide, vocab
49,155 (padded to 49,408), tied embeddings."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoESpec, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        pattern=(LayerSpec("attn", "moe"),),
        num_periods=32,
        moe=MoESpec(num_experts=40, top_k=8, d_expert=512),
        tie_embeddings=True,
        rope_theta=10000.0,
        train=TrainSpec(optimizer="adamw", microbatches=1, remat=True),
    )
)
