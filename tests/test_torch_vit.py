"""PyTorch port, encoder-only ViT: the ViT-B/L/H config copies, the `vit`
block kind and `models.vit.forward_vit` against the reference's
`repro.core.blocks` / `repro.models.vit`, fused and unfused.

Reduced ViT-B (2 layers, d_model 64, 4 heads x 16, 16 classes, 17
positions), and a reduced ViT-H that keeps ViT-H's head dim of 80
(`reduced()` alone makes the two identical).  The reference's own
initializer makes the weights (norms and the head bias perturbed, so that
the prologues and the bias matter); inputs are numpy-seeded.  The
reference runs its CPU path, the port its kernels' plain versions.
Tolerances: fp32 rtol = atol = 1e-4, bf16 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import blocks as jblocks
from repro.core.precision import BF16 as JBF16
from repro.core.precision import FP32 as JFP32
from repro.models import vit as jvit
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core.precision import BF16, FP32
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree
from repro_torch.models import vit as tvit

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
POLICIES = {"fp32": (JFP32, FP32), "bf16": (JBF16, BF16)}
VITS = ["vit-b", "vit-l", "vit-h"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _configs(model):
    """(reference, port) reduced configs: `vit-h-hd80` keeps ViT-H's head
    dim of 80 at the reduced width."""
    name = "vit-h" if model == "vit-h-hd80" else model
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    if model == "vit-h-hd80":
        jcfg = dataclasses.replace(jcfg, head_dim=80)
        tcfg = dataclasses.replace(tcfg, head_dim=80)
    return jcfg, tcfg


def _models(model, seed=0):
    jcfg, tcfg = _configs(model)
    tree = jax.tree.map(np.asarray,
                        jvit.init_vit(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    norms = [tree["final_norm"]] + [seg[ln] for seg in tree["segments"]
                                    for ln in ("ln1", "ln2")]
    for nrm in norms:
        nrm["scale"] = (1 + 0.1 * rng.standard_normal(nrm["scale"].shape)
                        ).astype(np.float32)
        nrm["bias"] = (0.1 * rng.standard_normal(nrm["bias"].shape)
                       ).astype(np.float32)
    tree["head_b"] = (0.1 * rng.standard_normal(tree["head_b"].shape)
                      ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tvit.vit_params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams, tree


def _plan(fused):
    return dataclasses.replace(UNSHARDED, fuse_epilogues=fused)


def _patches(cfg, B=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.image_seq - 1, tvit.PATCH_DIM)
                               ).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("model", VITS)
def test_vit_config_copy_matches_reference(model, reduced):
    jcfg, tcfg = jax_config(model), get_config(model)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_params() == jcfg.n_params()


def test_vit_params_from_numpy_round_trip_and_shape_check():
    _, tcfg, jparams, tparams, tree = _models("vit-b")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf, np.float32))
    tree["head"] = tree["head"][:, :-8]
    with pytest.raises(ValueError, match="head"):
        tvit.vit_params_from_numpy(tree, tcfg, device="cpu")


def test_init_vit_shapes_and_seed():
    cfg = get_config("vit-h").reduced()
    a = tvit.init_vit(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    b = tvit.init_vit(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    shapes = tvit.vit_param_shapes(cfg)
    assert tuple(a["head"].shape) == shapes["head"] == (64, 16)
    assert tuple(a["patch"].shape) == (tvit.PATCH_DIM, 64)
    assert a["segments"][0]["attn"]["wq"].shape == (2, 64, 64)
    assert a["head"].dtype == torch.bfloat16
    assert torch.equal(a["head"], b["head"])
    assert torch.equal(a["segments"][0]["mlp"]["w1"],
                       b["segments"][0]["mlp"]["w1"])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", ["vit-b", "vit-h-hd80"])
def test_vit_block_full_matches_reference(model, fused):
    jcfg, tcfg, jp, tp, _ = _models(model)
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0])
    tlayer = tptree.layer(tp["segments"][0], 0)
    x = np.random.default_rng(2).standard_normal(
        (2, jcfg.image_seq, jcfg.d_model)).astype(np.float32)
    jx, _, _ = jblocks.block_full("vit", jlayer, jnp.asarray(x),
                                  plan=_plan(fused), cfg=jcfg, policy=JFP32)
    tx, cache = tblocks.block_full("vit", tlayer, torch.tensor(x), cfg=tcfg,
                                   policy=FP32, fused=fused)
    assert cache is None
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL["fp32"])
    # bidirectional: the first position sees the last one (under a causal
    # mask its output would not move at all)
    x2 = x.copy()
    x2[:, -1] += 1.0
    tx2, _ = tblocks.block_full("vit", tlayer, torch.tensor(x2), cfg=tcfg,
                                policy=FP32, fused=fused)
    assert (tx2[:, 0] != tx[:, 0]).any()


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", ["vit-b", "vit-h-hd80"])
def test_forward_vit_matches_reference(model, fused, policy):
    jcfg, tcfg, jp, tp, _ = _models(model, seed=4)
    jpol, tpol = POLICIES[policy]
    x = _patches(jcfg)
    want = jvit.forward_vit(jp, jnp.asarray(x), cfg=jcfg, policy=jpol,
                            plan=_plan(fused))
    got = tvit.forward_vit(tp, torch.tensor(x), cfg=tcfg, policy=tpol,
                           fused=fused)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, jcfg.n_classes)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[policy])


def test_vit_raises_in_block_decode():
    _, tcfg, _, tp, _ = _models("vit-b")
    layer = tptree.layer(tp["segments"][0], 0)
    with pytest.raises(ValueError, match="no decode step"):
        tblocks.block_decode("vit", layer, torch.zeros(2, 64),
                             torch.zeros(2, dtype=torch.int32), {},
                             cfg=tcfg, policy=FP32, block_tables=None)
