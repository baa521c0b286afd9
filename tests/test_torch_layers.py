"""PyTorch port, layer level: `block_full` / `block_decode` for kind `attn`,
fused and unfused, against the reference's `repro.core.blocks` at the
reduced GPT-J and GPT3-XL configs (2 layers, d_model 64), fp32 policy.

The same numpy-seeded weights and inputs go to both sides; the reference
runs its CPU path (the jnp oracles), the port its kernels' plain versions.
Tolerance: rtol = atol = 1e-4 (fp32); KV caches are bf16 on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import blocks as jblocks
from repro.core.precision import FP32 as JFP32
from repro.models import lm as jlm
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core.precision import FP32
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gpt-j", "gpt3-xl"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jparams = jlm.init_lm(jax.random.key(seed), jcfg, jnp.float32)
    # norms are ones/zeros at init: perturb them so the prologues matter
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    for seg in tree["segments"]:
        for ln in ("ln1", "ln2"):
            seg[ln]["scale"] = (1 + 0.1 * rng.standard_normal(
                seg[ln]["scale"].shape)).astype(np.float32)
            seg[ln]["bias"] = (0.1 * rng.standard_normal(
                seg[ln]["bias"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tlm.params_from_numpy(tree, tcfg, dtype=torch.float32,
                                    device="cpu")
    return jcfg, tcfg, jparams, tparams


def _plan(fused):
    """The reference's plan; its KV caches in fp32, as the port's fp32
    policy stores them."""
    return dataclasses.replace(UNSHARDED, fuse_epilogues=fused,
                               kv_cache_dtype="float32")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_full_matches_reference(arch, fused):
    jcfg, tcfg, jp, tp = _models(arch)
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0])
    tlayer = tptree.layer(tp["segments"][0], 0)
    x = np.random.default_rng(1).standard_normal((2, 11, 64)).astype(
        np.float32)
    jx, jcache, _ = jblocks.block_full(
        "attn", jlayer, jnp.asarray(x), plan=_plan(fused), cfg=jcfg,
        policy=JFP32, with_cache=True, max_seq=32, compact_kv=True)
    tx, tcache = tblocks.block_full("attn", tlayer, torch.tensor(x),
                                    cfg=tcfg, policy=FP32, fused=fused,
                                    with_cache=True, max_seq=32,
                                    compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        assert tcache[key].dtype == torch.float32
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **F32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_decode_matches_reference(arch, fused):
    """One paged decode step: the updated residual stream and the pools
    after the new token's K/V append (absent table rows write nothing)."""
    jcfg, tcfg, jp, tp = _models(arch, seed=2)
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0])
    tlayer = tptree.layer(tp["segments"][0], 0)
    rng = np.random.default_rng(3)
    B, NB, BS, KV, hd = 3, 9, 8, jcfg.n_kv_heads, jcfg.head_dim
    pools = [rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
             for _ in range(2)]
    tab = np.array([[2, 5, -1, -1], [0, 7, 1, -1], [-1, -1, -1, -1]],
                   np.int32)
    pos = np.array([12, 20, 3], np.int32)     # slot 2 holds no blocks
    x = rng.standard_normal((B, 64)).astype(np.float32)

    jcache = {"k": jnp.asarray(pools[0]).astype(jnp.bfloat16),
              "v": jnp.asarray(pools[1]).astype(jnp.bfloat16)}
    sink = np.zeros((1, BS, KV, hd), np.float32)
    tcache = {"k": torch.tensor(np.concatenate([pools[0], sink])).bfloat16(),
              "v": torch.tensor(np.concatenate([pools[1], sink])).bfloat16()}
    jy, jc = jblocks.block_decode(
        "attn", jlayer, jnp.asarray(x), jnp.asarray(pos), jcache,
        plan=_plan(fused), cfg=jcfg, policy=JFP32,
        block_tables=jnp.asarray(tab), paged=True)
    ty, tc = tblocks.block_decode("attn", tlayer, torch.tensor(x),
                                  torch.tensor(pos), tcache, cfg=tcfg,
                                  policy=FP32, block_tables=torch.tensor(tab),
                                  fused=fused)
    np.testing.assert_allclose(_np(ty[:2]), _np(jy[:2]), **F32)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[key][:NB]), _np(jc[key]))
