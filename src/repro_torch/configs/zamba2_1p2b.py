"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].  Same values as `repro/configs/zamba2_1p2b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab=32000, head_dim=64, act="gelu", norm="rmsnorm",
        tie_embeddings=True,
        ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
        shared_attn_period=6,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, head_dim=32, act="gelu", norm="rmsnorm",
        tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_conv=4, ssm_chunk=16,
        shared_attn_period=2,
    )
