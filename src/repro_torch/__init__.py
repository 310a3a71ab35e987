"""PyTorch + CUDA port of the `repro` package.

Mirrors `repro`'s layout and names (the counterpart of `repro/models/common.py`
is `repro_torch/models/common.py`) and keeps its public layouts: q
`[B,Sq,Hq,D]`, caches `[L,B,S,Hkv,hd]`, weights `[in, out]`.  Imports torch,
numpy and the standard library only — never jax, never `repro`.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise (`repro_torch.device`).
"""
