"""qwen1.5-110b [dense] — QKV bias, GQA(kv=8), an untied head
[hf:Qwen/Qwen1.5-0.5B].  Same values as `repro/configs/qwen1p5_110b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
        vocab=152064, head_dim=128, rope_theta=1e6, qkv_bias=True,
        act="swiglu", norm="rmsnorm", tie_embeddings=False,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab=512, head_dim=32, qkv_bias=True,
        act="swiglu", norm="rmsnorm", tie_embeddings=False,
    )
