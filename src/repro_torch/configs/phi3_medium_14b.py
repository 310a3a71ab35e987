"""phi3-medium-14b [dense] — RoPE, SwiGLU, GQA(kv=10), an untied head
[arXiv:2404.14219].  Same values as `repro/configs/phi3_medium_14b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
        vocab=100352, head_dim=128, rope_theta=1e4,
        act="swiglu", norm="rmsnorm", tie_embeddings=False,
        source="arXiv:2404.14219",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab=512, head_dim=32, act="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
