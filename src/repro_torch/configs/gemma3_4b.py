"""gemma3-4b [dense] — 5:1 local:global sliding-window pattern, GQA(kv=4),
128k context [hf:google/gemma-3-1b-pt].  Same values as
`repro/configs/gemma3_4b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
        vocab=262144, head_dim=256, rope_theta=1e6,
        window=1024, window_pattern=6,  # layers 6,12,... global; rest 1k SWA
        act="swiglu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
        source="hf:google/gemma-3-1b-pt",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab=512, head_dim=64, window=32, window_pattern=2,
        act="swiglu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
    )
