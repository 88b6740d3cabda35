"""DeepSeek-V2-Lite 16B: 27 layers, d_model 2048, 16 heads of multi-head
latent attention (a 512-wide compressed KV latent and a 64-wide shared
RoPE key; query/key width 128 + 64, value width 128), vocab 102,400. The
first layer has a dense FFN (d_ff 10,944); the other 26 an MoE of 64
routed experts (top 6) and 2 shared ones, each 1,408 wide."""
from repro_torch.configs.base import LayerSpec, MLASpec, ModelConfig, MoESpec, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,  # qk_nope(128) + qk_rope(64)
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        prefix=(LayerSpec("attn", "dense"),),
        pattern=(LayerSpec("attn", "moe"),),
        num_periods=26,
        mla=MLASpec(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
        rope_theta=10000.0,
        train=TrainSpec(optimizer="adamw", microbatches=4, remat=True, dp_shard_params=True),
        notes="MLA caches the 512-dim latent + 64-dim rope key instead of full KV.",
    )
)
