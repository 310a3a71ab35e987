"""The port's ViT against the JAX package at vit-smoke with 16 classes (the
configuration `examples/vit_local_adamw.py` trains).

Weights come from the JAX package's own init, carried across as numpy
(`from_numpy_tree`); images and labels are numpy draws from a seed.  Both
packages compute in fp32 and sum in different orders (XLA's CPU reductions
vs torch's): observed ~1e-6 on logits and the loss, ~3e-7 on gradients.
Tolerances: 1e-5 (logits, loss) and 2e-5 (every gradient leaf), an order
of magnitude of room.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import common as jcm
from repro.models import param as jpm
from repro.models import vit as jvit
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import param as tpm
from repro_torch.models import vit as tvit
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
N_CLASSES = 16


def _cfgs():
    j = dataclasses.replace(JR.get_smoke_config("vit-b16"),
                            n_classes=N_CLASSES)
    t = dataclasses.replace(TR.get_smoke_config("vit-b16"),
                            n_classes=N_CLASSES)
    return j, t


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = jpm.init_params(jvit.param_defs(jcfg), jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 6).astype(np.int32)
    return jcfg, tcfg, jp, npt, images, labels


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_vit_configs_match_the_jax_package():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(JR, get)("vit-b16"), getattr(TR, get)("vit-b16")
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tapi.get_module(TR.get_config("vit-b16")) is tvit


def test_vit_b16_param_tree_and_count_match():
    """The full-width tree: 16 leaves, 86,332,648 parameters, the same key
    paths and shapes as the JAX package's."""
    j, t = JR.get_config("vit-b16"), TR.get_config("vit-b16")
    jdefs = jax.tree.leaves(jvit.param_defs(j),
                            is_leaf=lambda x: isinstance(x, jpm.ParamDef))
    tdefs = T.leaves(tvit.param_defs(t))
    assert [d.shape for d in jdefs] == [d.shape for d in tdefs]
    assert len(tdefs) == 16
    assert tpm.count_params(tvit.param_defs(t)) == 86_332_648


def test_layernorm_and_gelu_match_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 128)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(128).astype(np.float32),
         "bias": rng.standard_normal(128).astype(np.float32)}
    got = tcm.norm_apply(tcfg, tpm.from_numpy_tree(p, "cpu"),
                         torch.from_numpy(x)).numpy()
    _close(got, jcm.norm_apply(jcfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x)), LOGIT_TOL)
    mp = {"wi": rng.standard_normal((128, 256)).astype(np.float32) / 11,
          "wo": rng.standard_normal((256, 128)).astype(np.float32) / 16}
    got = tcm.mlp_apply(tcfg, tpm.from_numpy_tree(mp, "cpu"),
                        torch.from_numpy(x)).numpy()
    _close(got, jcm.mlp_apply(jcfg, jax.tree.map(jnp.asarray, mp),
                              jnp.asarray(x)), LOGIT_TOL)


@pytest.mark.parametrize("n,d", [(4, 128), (196, 768)])
def test_sincos_positions_match_jax(n, d):
    """XLA's and torch's fp32 exp may differ by an ulp; the position (up to
    195) multiplies that before the sin: ~1.5e-5 at 196 tokens, so 3e-5."""
    _close(tvit._sincos_positions(n, d).numpy(),
           jvit._sincos_positions(n, d), 3e-5)


def test_vit_logits_match_jax(setup):
    jcfg, tcfg, jp, npt, images, _ = setup
    want = jvit.forward(jcfg, jp, jnp.asarray(images))
    got = tvit.forward(tcfg, tpm.from_numpy_tree(npt, "cpu"),
                       torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (6, N_CLASSES)
    _close(got.numpy(), want, LOGIT_TOL)


def test_vit_224_patch_order_matches_jax():
    """At 224^2 (196 tokens, the main path's) the patch reshape/transpose
    and the position table line up with the reference's: one layer at the
    smoke width, random patch_proj carried across."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, n_layers=1)
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    jp = jpm.init_params(jvit.param_defs(jcfg), jax.random.PRNGKey(5))
    npt = jax.tree.map(np.asarray, jp)
    img = np.random.default_rng(9).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    _close(tvit.forward(tcfg, tpm.from_numpy_tree(npt, "cpu"),
                        torch.from_numpy(img)).numpy(),
           jvit.forward(jcfg, jp, jnp.asarray(img)), LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_loss_and_every_grad_leaf_match_jax(setup, remat):
    jcfg, tcfg, jp, npt, images, labels = setup
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jvit.loss_fn(jcfg, p, batch, remat=remat))(jp)
    leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
    alias = [x.requires_grad_(True) for x in leaves]
    loss = tapi.get_module(tcfg).loss_fn(
        tcfg, T.unflatten(treedef, alias),
        {"images": torch.from_numpy(images),
         "labels": torch.from_numpy(labels)}, remat=remat)
    grads = torch.autograd.grad(loss, alias)
    _close(loss.detach().numpy(), jloss, LOGIT_TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == 16
    for g, jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape
        _close(g.numpy(), jg, GRAD_TOL)


def test_vit_accuracy_equals_jax(setup):
    jcfg, tcfg, jp, npt, images, labels = setup
    jlogits = np.asarray(jvit.forward(jcfg, jp, jnp.asarray(images)))
    top2 = np.sort(jlogits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all()   # no near-tie argmax
    want = jvit.accuracy(jcfg, jp, {"images": jnp.asarray(images),
                                    "labels": jnp.asarray(labels)})
    got = tvit.accuracy(tcfg, tpm.from_numpy_tree(npt, "cpu"),
                        {"images": torch.from_numpy(images),
                         "labels": torch.from_numpy(labels)})
    assert float(got) == float(want)


def test_attn_apply_full_sequence_branches_match_jax():
    """The no-cache causal branch (with rope, a window and a prefix) and the
    cross-attention branch of `attn_apply`, through `_attn_chunked`'s query
    blocking, against the reference at the gemma3 smoke widths."""
    jcfg = JR.get_smoke_config("gemma3-4b")
    tcfg = TR.get_smoke_config("gemma3-4b")
    jp = jpm.init_params(jcm.attn_defs(jcfg), jax.random.PRNGKey(2))
    tp = tpm.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    for kw in (dict(layer_window=8, prefix_len=3), dict(kv_source=src)):
        jkw = {k: jnp.asarray(v) if k == "kv_source" else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if k == "kv_source" else v
               for k, v in kw.items()}
        want, _ = jcm.attn_apply(jcfg, jp, jnp.asarray(x),
                                 positions=jnp.asarray(pos), **jkw)
        got, cache = tcm.attn_apply(tcfg, tp, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos), **tkw)
        assert cache is None
        _close(got.numpy(), want, LOGIT_TOL)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 16)).astype(
        np.float32))
    whole = tcm._attn_chunked(q, q, q, causal=True, window=5, prefix_len=0,
                              q_offset=0)
    blocked = tcm._attn_chunked(q, q, q, causal=True, window=5, prefix_len=0,
                                q_offset=0, q_block=5)     # blocks of 4
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)
