#!/usr/bin/env python3
"""Checks behind the rms_norm / swiglu backward kernels and gemma3-4b
training on the card.

    python3 tools/grad_checks.py digests [CSRC_DIR ...]
    python3 tools/grad_checks.py card_vs_cpu [VARIANT ...]
    python3 tools/grad_checks.py remat_cycle [--device cpu]

`digests`: the sha256 (first 16 hex digits) of `swiglu`'s forward outputs
on its tile path (the cases of `tests/test_torch_cuda.py`
`tile_digest_cases`), built from each CSRC_DIR (a copy of
`src/repro_torch/kernels/csrc/`, for example an earlier commit's, written
out with `git archive REV src/repro_torch/kernels/csrc | tar -x -C DIR`),
or from this checkout's sources when none is given, each into its own
directory under `src/repro_torch/kernels/_build/digests/` (git ignores
it); one JSON line per source, with whether every digest equals the test's
`TILE_DIGESTS`.

`card_vs_cpu [VARIANT ...]`: chip_smoke's `train_gemma3_card_vs_cpu` round
(gemma3-4b at 2 layers, W = 2 x 1 x 128, one round of H = 2 at the peak
lr) run once on the CPU and twice each on the card (whether a round
repeats: the embedding gradient's index_put_ adds in no fixed order): with the port's kernels, with
swiglu's backward plain from the kernel's pair, with `rms_norm` and
`swiglu` plain (autograd of `kernels/ref.py`), with no kernel of the port
in the model (attention plain too), and with each named
`tools/kernel_variants.py` variant's kernels (a regex variant, or
`file:PATH` another source, e.g. the parent's `rmsnorm_bwd.cu`).  For each leaf: the
elements beyond 1e-5 after the round (chip_smoke's rule) and the relative
L2 error of lane 0's first-step gradient.  One JSON line per card run.

`remat_cycle`: the state a two-step `train()` leaves behind after `del`,
with and without remat: how many of its leaves (and whether the engine)
are still alive before and after `gc.collect()`, and on the card the
memory still allocated (reference cycles once held all of it: through
`tree.flatten`, through the engine's batch lambda, and through the frames
of a first `torch.utils.checkpoint` call, which imported torch._dynamo)
(starcoder2-3b at full width and 30 layers, W = 1 x 1 x 1024, as
chip_smoke's `train_lm_full_depth`); with `--device cpu` starcoder2-smoke.

Every mode but `remat_cycle --device cpu` needs one CUDA card; each ends
with the card's name and power limit.
"""
import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def swiglu_from(src: Path):
    """`swiglu_f32` of a library built from the sources in `src` alone
    (an earlier tree need not have this one's other C entries), called
    as the wrapper calls it."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    build.CSRC = src
    build.BUILD_DIR = (ROOT / "src/repro_torch/kernels/_build/digests" /
                       hashlib.sha256(str(src).encode()).hexdigest()[:8])
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = build.BUILD_DIR / f"libreprotorch-{build._digest()}.so"
    if not target.exists():
        build._build(target)
    lib = ctypes.CDLL(str(target))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.swiglu_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.swiglu_f32.restype = i

    def swiglu(x, wg, wi):
        (n, d), f = x.shape, wg.shape[1]
        out = torch.empty(n, f, device=x.device)
        err = lib.swiglu_f32(x.data_ptr(), wg.data_ptr(), wi.data_ptr(),
                             out.data_ptr(), n, d, f,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"swiglu_f32 from {src}: cudaError {err}")
        return out
    return swiglu


def digests(dirs) -> None:
    import test_torch_cuda as tc
    from repro_torch.kernels import build
    for src in dirs or [str(build.CSRC)]:
        src = Path(src).resolve()
        fn = swiglu_from(src)
        got = {f"{n},{d},{f}": tc.tile_digest(fn, *case)
               for (n, d, f), case in tc.tile_digest_cases().items()}
        want = {f"{n},{d},{f}": x for (n, d, f), x in tc.TILE_DIGESTS.items()}
        print(json.dumps({"source": os.path.relpath(src, ROOT),
                          "digests": got, "equal_to_test": got == want}),
              flush=True)


def card_vs_cpu(variants=()) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.data.synthetic import TokenStream, make_train_batch
    from repro_torch.kernels import ops
    from repro_torch.models import api, common, param as pm  # noqa: F401
    cfg, run = cs.lm_setup(2, cs.G3_ARCH)
    lr, w = run.peak_lr, 2
    defs = api.get_module(cfg).param_defs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    host_p = T.map(lambda x: x.cpu(), pm.init_params(defs, gen,
                                                     device="cuda"))
    names = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}/{k}")
        else:
            names.append(pre)
    walk(host_p, "")
    stream = TokenStream(vocab=cfg.vocab, seed=0)
    batches = [make_train_batch(cfg, stream, t, w, 1, 128) for t in range(2)]
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    sync = make_sync(run)
    loss_fn = LU.make_loss(cfg, run)

    def lane0_grads(dev):
        leaves, td = T.flatten(host_p)
        alias = [x.to(dev).requires_grad_(True) for x in leaves]
        loss = loss_fn(T.unflatten(td, alias),
                       T.map(lambda x: x[0].to(dev), batches[0]))
        return [g.cpu() for g in torch.autograd.grad(loss, alias)]

    def rollout(dev):
        st = LU.init_state(cfg, run, T.map(lambda x: x.to(dev), host_p), w)
        for b in batches:
            st, _ = step_fn(st, T.map(lambda x: x.to(dev), b), lr)
        with torch.no_grad():
            st = sync(st)
        return T.leaves(T.map(lambda x: x.cpu(), st["params"]))

    @contextlib.contextmanager
    def plain_rms_norm_swiglu():
        from repro_torch.kernels import ref
        saved = ops.rms_norm, ops.swiglu
        ops.rms_norm, ops.swiglu = ref.rms_norm, ref.swiglu
        try:
            yield
        finally:
            ops.rms_norm, ops.swiglu = saved

    @contextlib.contextmanager
    def swiglu_bwd_plain():
        from repro_torch.kernels import ref
        from repro_torch.kernels import swiglu as _sw
        saved = _sw.swiglu_bwd
        _sw.swiglu_bwd = ref.swiglu_bwd
        try:
            yield
        finally:
            _sw.swiglu_bwd = saved

    def kernel_variant(name):
        """The port's kernels with a `tools/kernel_variants.py` variant's
        in the wrappers' place."""
        import kernel_variants as kv
        from repro_torch.kernels import build as kb
        base = kb.library()
        lib = kv.build([name])[name][0]

        @contextlib.contextmanager
        def ctx():
            kv.using(kv.Kernels(base, lib))
            try:
                yield
            finally:
                kv.using(base)
        return ctx

    g_cpu, p_cpu = lane0_grads("cpu"), rollout("cpu")
    cases = [("kernels", contextlib.nullcontext),
             ("kernels_swiglu_bwd_plain", swiglu_bwd_plain),
             ("plain_rms_norm_swiglu", plain_rms_norm_swiglu),
             ("no_port_kernel", cs.plain_versions_on_card)]
    cases += [(name, kernel_variant(name)) for name in variants]
    for variant, ctx in cases:
        for rep in range(2):          # the embedding's index_put_ order
            with ctx():
                g_card, p_card = lane0_grads("cuda"), rollout("cuda")
            rows = {}
            for nm, gc_, gh, a, b in zip(names, g_card, g_cpu, p_card,
                                         p_cpu):
                rows[nm] = dict(
                    beyond_1e5=int(((a - b).abs()
                                    > 1e-5 * (1 + b.abs())).sum()),
                    allowed=max(1, b.numel() // 2000),
                    grad_rel_l2=float((gc_ - gh).norm() / gh.norm()))
            print(json.dumps({"variant": variant, "repeat": rep,
                              "leaves": rows}), flush=True)
            torch.cuda.empty_cache()


def remat_cycle(device: str) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import tree as T
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.launch.train import train
    from repro_torch.models import common  # noqa: F401
    for remat in (False, True):
        if device == "cpu":
            cfg = R.get_smoke_config(cs.LM_ARCH)
            run = RunConfig(**{**cs.LM_RUN, "total_steps": 2, "remat": remat})
            w, b, seq = 1, 1, 16
        else:
            cfg, run = cs.lm_setup(30, total_steps=2, remat=remat)
            w, b, seq = 1, 1, cs.LM_SEQ
        gc.collect()
        base = torch.cuda.memory_allocated() if device == "cuda" else 0
        eng = RoundEngine(cfg, run, workers=w, b_loc=b, seq=seq, data="host",
                          device=device)
        state, _ = train(cfg, run, workers=w, b_loc=b, seq=seq, data="host",
                         eng=eng, device=device, log_every=0)
        leaves = T.leaves(state)
        refs = [weakref.ref(x) for x in leaves]
        engine = weakref.ref(eng)
        del state, eng, leaves
        alive = sum(r() is not None for r in refs)
        engine_alive = engine() is not None
        held = (torch.cuda.memory_allocated() - base) / 1e9 \
            if device == "cuda" else None
        freed = gc.collect()
        print(json.dumps(dict(
            device=device, arch=cfg.name, layers=cfg.n_layers, remat=remat,
            state_leaves=len(refs), alive_after_del=alive,
            engine_alive_after_del=engine_alive,
            alive_after_gc=sum(r() is not None for r in refs),
            objects_collected=freed, card_gb_held_after_del=held,
            card_gb_held_after_gc=(torch.cuda.memory_allocated() - base)
            / 1e9 if device == "cuda" else None)), flush=True)


def main(argv) -> int:
    if not argv or argv[0] not in ("digests", "card_vs_cpu", "remat_cycle"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    device = "cpu" if "--device" in argv and "cpu" in argv else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("grad_checks: no CUDA device", file=sys.stderr)
        return 1
    if argv[0] == "digests":
        digests(argv[1:])
    elif argv[0] == "card_vs_cpu":
        card_vs_cpu([a for a in argv[1:] if not a.startswith("-")])
    else:
        remat_cycle(device)
    if device == "cuda":
        print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
