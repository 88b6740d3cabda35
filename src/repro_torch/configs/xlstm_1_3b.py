"""xLSTM 1.3B: 48 blocks, d_model 2048, 4 heads, vocab 50,304, tied
embeddings. Periods of seven mLSTM blocks (matrix memory, chunkwise
parallel) and one sLSTM block (scalar memory, strictly sequential); the
blocks carry their own projections and no FFN (d_ff 0)."""
from repro_torch.configs.base import LayerSpec, ModelConfig, TrainSpec, register_arch

_PERIOD = tuple([LayerSpec("mlstm", "none")] * 7 + [LayerSpec("slstm", "none")])

CONFIG = register_arch(
    ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,
        d_ff=0,
        vocab_size=50304,
        pattern=_PERIOD,
        num_periods=6,
        tie_embeddings=True,
        train=TrainSpec(optimizer="adamw", microbatches=1, remat=True),
    )
)
