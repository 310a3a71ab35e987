"""ViT-B/16 — the paper's own architecture (ImageNet classifier, Beyer et
al. 2022 recipe) [arXiv:2010.11929 / paper §4].  Same values as
`repro/configs/vit_b.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="vit-b16", family="vision",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
        vocab=0, act="gelu", norm="layernorm", tie_embeddings=False,
        n_classes=1000, source="arXiv:2010.11929",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="vit-smoke", family="vision",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=0, act="gelu", norm="layernorm", tie_embeddings=False,
        n_classes=10,
    )
