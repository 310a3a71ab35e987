"""Architecture registry: --arch <id> -> (config, smoke_config).

Every architecture of the JAX package's registry is ported: the dense LMs
gemma3-4b, starcoder2-3b, phi3-medium-14b and qwen1.5-110b, the MoE LMs
dbrx-132b and kimi-k2-1t-a32b, the VLM paligemma-3b, the encoder-decoder
whisper-base, the SSM mamba2-130m, the hybrid zamba2-1.2b, and vit-b16.
An unknown id raises `ConfigError("unknown arch ...")`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError

ARCHS: dict[str, str] = {"gemma3-4b": "gemma3_4b",
                         "starcoder2-3b": "starcoder2_3b",
                         "phi3-medium-14b": "phi3_medium_14b",
                         "qwen1.5-110b": "qwen1p5_110b",
                         "dbrx-132b": "dbrx_132b",
                         "kimi-k2-1t-a32b": "kimi_k2_1t",
                         "paligemma-3b": "paligemma_3b",
                         "whisper-base": "whisper_base",
                         "mamba2-130m": "mamba2_130m",
                         "zamba2-1.2b": "zamba2_1p2b", "vit-b16": "vit_b"}

# ids the JAX package registers that this package does not cover: none
NOT_PORTED: tuple[str, ...] = ()


def _mod(arch: str):
    if arch not in ARCHS:
        raise ConfigError(f"unknown arch {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
