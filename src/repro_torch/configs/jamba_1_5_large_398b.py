"""Jamba-1.5 Large 398B: 72 layers, d_model 8192, a period of 8 layers
(Mamba x4, attention, Mamba x3; 64 heads over 8 KV heads of width 128),
dense (d_ff 24,576) and MoE FFNs (16 experts, top 2) alternating, vocab
65,536. Only the attention layers keep a KV cache; a Mamba layer's decode
state is O(1) in the sequence."""
from repro_torch.configs.base import LayerSpec, MambaSpec, ModelConfig, MoESpec, TrainSpec, register_arch

_PERIOD = (
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("attn", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
)

CONFIG = register_arch(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        pattern=_PERIOD,
        num_periods=9,
        moe=MoESpec(num_experts=16, top_k=2, d_expert=24576),
        mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
        rope_theta=10000.0,
        train=TrainSpec(optimizer="adafactor", microbatches=16, remat=True, dp_shard_params=True),
    )
)
