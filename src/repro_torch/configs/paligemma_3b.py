"""paligemma-3b [vlm] — SigLIP(stub) + gemma decoder, GQA(kv=1): a
bidirectional prefix of `n_img_tokens` stub image embeddings before the
text [arXiv:2407.07726].  Same values as `repro/configs/paligemma_3b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
        vocab=257216, head_dim=256, rope_theta=1e4,
        act="swiglu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
        n_img_tokens=256,
        source="arXiv:2407.07726",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512,
        vocab=512, head_dim=64, act="swiglu", norm="rmsnorm",
        tie_embeddings=True, embed_scale=True, n_img_tokens=16,
    )
