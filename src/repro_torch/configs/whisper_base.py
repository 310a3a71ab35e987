"""whisper-base [audio] — encoder-decoder, the conv/mel frontend a stub
(1500 frame embeddings come in as the input) [arXiv:2212.04356].  Same
values as `repro/configs/whisper_base.py`."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=51865, act="gelu", norm="layernorm", tie_embeddings=True,
        n_enc_layers=6, enc_seq=1500,
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, act="gelu", norm="layernorm", tie_embeddings=True,
        n_enc_layers=2, enc_seq=64,
    )
