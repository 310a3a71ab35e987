"""dbrx-132b [moe] — 16 experts top-4, fine-grained, GQA(kv=8)
[hf:databricks/dbrx-base].  Same values as `repro/configs/dbrx_132b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
        vocab=100352, head_dim=128, rope_theta=5e5,
        act="swiglu", norm="layernorm", tie_embeddings=False,
        n_experts=16, top_k=4, capacity_factor=1.25,
        source="hf:databricks/dbrx-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, act="swiglu", norm="layernorm",
        tie_embeddings=False, n_experts=4, top_k=2, capacity_factor=8.0,
    )
