"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts top-8 + 1 shared
expert, per-expert d_ff=2048, GQA(kv=8) [arXiv:2501.kimi2].  Same values
as `repro/configs/kimi_k2_1t.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
        vocab=163840, head_dim=128, rope_theta=5e4,
        act="swiglu", norm="rmsnorm", tie_embeddings=False,
        n_experts=384, top_k=8, n_shared_experts=1, capacity_factor=1.25,
        source="arXiv:2501.kimi2",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=512, head_dim=32, act="swiglu", norm="rmsnorm",
        tie_embeddings=False, n_experts=4, top_k=2, n_shared_experts=1,
        capacity_factor=8.0,
    )
