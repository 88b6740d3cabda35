"""Gemma-2 2B: 26 layers, d_model 2304, 8 heads over 4 KV heads of width
256, d_ff 9216, vocab 256,000, tied embeddings. Local (sliding window
4,096) and global attention alternate; attention logits soft-capped at 50
and final logits at 30; post-norms; a fixed query scale 1/sqrt(256)."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="gemma2-2b",
        family="dense",
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        pattern=(LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense")),
        num_periods=13,
        sliding_window=4096,
        final_logit_softcap=30.0,
        attn_logit_softcap=50.0,
        query_pre_attn_scalar=256.0,
        use_post_norm=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        train=TrainSpec(optimizer="adamw", microbatches=1, remat=True),
        notes="long_500k skipped: every other layer is global full attention.",
    )
)
