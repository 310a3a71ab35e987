"""Config dataclasses (a copy of `repro/configs/base.py`).

The fields match the JAX package's one for one, so a config built here
describes the same model and run there.  Fields of `RunConfig` that name
parts the port does not run yet (sharding, MoE dispatch) are kept so the two configs compare equal; the code that reads them
raises `ConfigError("not ported yet")` where it meets one it cannot run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | vision
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # sliding-window pattern: every `window_pattern`-th layer (1-indexed) is
    # global; others use `window`. window_pattern=0 -> all layers full attention
    # (unless window>0 and window_pattern<0 -> all layers windowed).
    window: int = 0
    window_pattern: int = 0
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d_model) embedding scale
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    shared_attn_period: int = 0      # zamba2: shared attn block every N layers
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub-frontend frame count (whisper: 1500)
    # --- VLM (paligemma) ---
    n_img_tokens: int = 0            # stub-frontend patch count
    # --- vision classifier (paper's ViT) ---
    n_classes: int = 0
    # serving: window used for the long_500k variant on full-attention archs
    long_decode_window: int = 8192
    source: str = ""                 # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (0 = full attention)."""
        if self.window <= 0:
            return 0
        if self.window_pattern < 0:
            return self.window
        if self.window_pattern == 0:
            return self.window
        return 0 if (i + 1) % self.window_pattern == 0 else self.window


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Distribution + numerics policy for a run."""
    sharding: str = "dp"            # dp | fsdp
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # full | save_collectives
    seq_shard_activations: bool = False  # Korthikanti-style sequence parallel
    moe_dispatch_shards: int = 1    # >1: shard-local MoE dispatch
    moe_dispatch: str = "auto"      # auto | sharded | shard_map
    microbatch: int = 1             # grad-accumulation chunks per local step
    optimizer: str = "adamw"        # adamw | sgd
    # H schedule
    # qsr | constant | inverse | cubic | postlocal | swap | parallel
    # | linear_inc | dec_sqrt  (related-work baselines, paper §A)
    schedule: str = "qsr"
    h_base: int = 4
    alpha: float = 0.0175           # QSR growth coefficient
    beta: float = 0.03              # inverse-rule coefficient
    rho: float = 0.0075             # cubic-rule coefficient
    switch_frac: float = 0.5        # post-local / swap switching point
    # lr schedule
    lr_schedule: str = "cosine"     # cosine | linear | step
    peak_lr: float = 0.008
    end_lr: float = 1e-6
    warmup_steps: int = 0
    total_steps: int = 1000
    weight_decay: float = 0.05
    # serving layout
    cache_layout: str = "batch"      # batch | seq_model (flash-decode)
    # sync options (beyond-paper)
    sync_quantize: bool = False      # int8-quantized sync deltas
    outer_momentum: float = 0.0      # DiLoCo-style Nesterov outer optimizer
    # wire mode for the quantized sync payload: auto (exact integer-code
    # sum) | ring-int8 (re-quantizing ring)
    sync_wire: str = "auto"
