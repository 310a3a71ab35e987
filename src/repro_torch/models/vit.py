"""ViT-B/16 classifier — the paper's own architecture (port of
`repro/models/vit.py`; Dosovitskiy et al. 2021, Beyer et al. 2022 recipe:
GAP head, fixed sin-cos positions).

Patch extraction is the reference's reshape + transpose + linear, in the
same element order, so `patch_proj` rows carried across from the JAX
package mean the same pixels.  The reference's `lax.scan` over the stacked
`[L, ...]` layer params is a loop over layer slices.  Attention is the
cross-attention branch of `attn_apply` with kv_source = the normed tokens
(no rope, no mask), which on the card runs the differentiable
`flash_attention` kernel; `remat=True` recomputes each layer in the
backward (`torch.utils.checkpoint`), as `jax.checkpoint` does.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.param import ParamDef


def param_defs(cfg: ModelConfig, patch: int = 16, channels: int = 3) -> dict:
    d = cfg.d_model
    return {
        "patch_proj": ParamDef((patch * patch * channels, d), (None, "embed")),
        "patch_bias": ParamDef((d,), ("embed",), "zeros"),
        "layers": cm.stack_defs({
            "ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
            "attn": cm.attn_defs(cfg), "mlp": cm.mlp_defs(cfg),
        }, cfg.n_layers),
        "final_norm": cm.norm_defs(cfg),
        "head": ParamDef((d, cfg.n_classes), ("embed", None)),
        "head_bias": ParamDef((cfg.n_classes,), (None,), "zeros"),
    }


def _sincos_positions(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] fp32: sin in the even columns, cos in the odd ones, the
    reference's fp32 op order."""
    pos = torch.arange(n, device=device)[:, None].float()
    step = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, device=device).float() * step)
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _block(cfg, lp, h, positions):
    hn = cm.norm_apply(cfg, lp["ln1"], h)
    a, _ = cm.attn_apply(cfg, lp["attn"], hn, positions=positions,
                         use_rope=False, kv_source=hn)
    h = h + a
    return h + cm.mlp_apply(cfg, lp["mlp"], cm.norm_apply(cfg, lp["ln2"], h))


def forward(cfg: ModelConfig, params: dict, images: torch.Tensor, *,
            patch: int = 16, remat: bool = False) -> torch.Tensor:
    """images [B,H,W,C] -> logits [B,n_classes] fp32."""
    b, hh, ww, c = images.shape
    ph, pw = hh // patch, ww // patch
    x = images.reshape(b, ph, patch, pw, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, ph * pw, patch * patch * c)
    h = x.to(params["patch_proj"].dtype) @ params["patch_proj"] \
        + params["patch_bias"]
    h = h + _sincos_positions(ph * pw, cfg.d_model, h.device).to(h.dtype)
    positions = torch.arange(ph * pw, device=h.device)
    for layer in range(cfg.n_layers):
        lp = T.map(lambda t: t[layer], params["layers"])
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _block, cfg, lp, h, positions, use_reentrant=False)
        else:
            h = _block(cfg, lp, h, positions)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    pooled = torch.mean(h, 1)  # GAP head (Beyer et al. 2022)
    return (pooled @ params["head"] + params["head_bias"]).float()


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat=False):
    logits = forward(cfg, params, batch["images"], remat=remat)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def accuracy(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1)
                       == batch["labels"].long()).float())
