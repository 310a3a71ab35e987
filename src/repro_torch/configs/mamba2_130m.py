"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].  Same values as `repro/configs/mamba2_130m.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=50280, act="swiglu", norm="rmsnorm", tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=512, act="swiglu", norm="rmsnorm", tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_conv=4, ssm_chunk=16,
    )
