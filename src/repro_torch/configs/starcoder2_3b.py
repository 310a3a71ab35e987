"""starcoder2-3b [dense] — GQA(kv=2), RoPE, sliding window 4096, LN+GELU
[arXiv:2402.19173].  Same values as `repro/configs/starcoder2_3b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
        vocab=49152, head_dim=128, rope_theta=1e5,
        window=4096, window_pattern=-1,  # every layer windowed (native 4k SWA)
        act="gelu", norm="layernorm", tie_embeddings=True,
        source="arXiv:2402.19173",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab=512, head_dim=32, window=64, window_pattern=-1,
        act="gelu", norm="layernorm", tie_embeddings=True,
    )
