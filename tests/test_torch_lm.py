"""PyTorch port, model level: the config copies, the weight converter, and
teacher-forced residuals / per-position logits of the prefill and paged
decode stacks against the reference (`lm._run_segments_prefill`,
`lm._run_segments_decode`, `embedding.logits_local`), plus the paged pool
contents after the prefill scatter and after decode appends.

Reduced GPT-J / GPT3-XL (2 layers, d_model 64), fp32 policy, numpy-seeded
inputs; tolerance rtol = atol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import cache_layout, make_paged_layout
from repro_torch.models import lm as tlm
from repro_torch.serving.kv_cache import prefill_scatter
from repro_torch.serving.sampling import device_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
# bf16 pools: fp32 values that differ in the last digits can round to
# neighbouring bf16 values
BF16 = dict(rtol=2e-2, atol=2e-2)
# decode logits: the step's own K/V row is rounded to bf16 before it is
# attended, and a one-ulp difference there passes through the final
# LayerNorm (small residual std) to ~2e-4 in the logits
DECODE_LOGITS = dict(rtol=1e-3, atol=1e-3)
ARCHS = ["gpt-j", "gpt3-xl"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.n_params() == jcfg.n_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    jcfg = jax_config("gpt-j").reduced()
    jparams = jlm.init_lm(jax.random.key(4), jcfg, getattr(jnp, dtype))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tlm.params_from_numpy(tree, get_config("gpt-j").reduced(),
                                    dtype=getattr(torch, dtype),
                                    device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, tparams,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))))
    for path, leaf in jleaves:
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(node), np.asarray(leaf, np.float32))


def test_params_from_numpy_rejects_wrong_shape():
    jcfg = jax_config("gpt-j").reduced()
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    tree["embedding"]["unemb"] = tree["embedding"]["unemb"][:, :-1]
    with pytest.raises(ValueError, match="unemb"):
        tlm.params_from_numpy(tree, get_config("gpt-j").reduced(),
                              device="cpu")


def _models(arch):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jparams = jlm.init_lm(jax.random.key(7), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tlm.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_logits(jcfg, jparams, x):
    """Per-position fused-head logits of residuals x [B, S, E]."""
    B, S, E = x.shape
    z, _ = jemb.logits_local(
        x.reshape(B * S, E), jparams["embedding"]["unemb"], plan=UNSHARDED,
        cfg=jcfg, policy=JFP32,
        norm=jops.norm_prologue(jparams["final_norm"], jcfg.norm))
    return z.reshape(B, S, -1)


def _torch_logits(tcfg, tparams, x):
    B, S, E = x.shape
    z = temb.logits_local(
        x.reshape(B * S, E), tparams["embedding"]["unemb"], cfg=tcfg,
        policy=FP32,
        norm=tops.norm_prologue(tparams["final_norm"], tcfg.norm))
    return z.reshape(B, S, -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_prefill_and_decode(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(5)
    B, S, BS, n_dec = 2, 13, 8, 3
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    prompt = tokens[:, :S]

    # -- prefill: residuals and logits at every position
    jx = jlm._embed_sequence(jp, {"tokens": jnp.asarray(prompt)},
                             plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=UNSHARDED, cfg=jcfg, policy=JFP32, max_seq=32,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(prompt), policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=32, compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(_np(_torch_logits(tcfg, tp, tx)),
                               _np(_jax_logits(jcfg, jp, jx)), **F32)

    # -- scatter both compact caches into paged pools
    layout = make_paged_layout(tcfg, 32, num_blocks=10, block_size=BS)
    tpools = cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                          device="cpu")
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    tables[0, :3] = [4, 1, 8]
    tables[1, :3] = [0, 9, 2]
    prefill_scatter(tpools, tcaches, torch.arange(B), torch.tensor(tables),
                    block_size=BS)
    shape = (2, 10, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jpools = ({"k": jnp.zeros(shape, jnp.bfloat16),
               "v": jnp.zeros(shape, jnp.bfloat16)},)
    jpools = make_prefill_scatter((True,), BS)(
        jpools, jcaches, jnp.arange(B, dtype=jnp.int32), jnp.asarray(tables))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tpools[0][key][:, :10]),
                                   _np(jpools[0][key]), **BF16)

    # -- teacher-forced decode steps: logits and pools after each append.
    # Each step starts from the reference's pools: a bf16 cache entry that
    # rounded to its neighbour would otherwise shift later logits by more
    # than the fp32 tolerance.
    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    for i in range(n_dec):
        for key in ("k", "v"):
            tpools[0][key][:, :10] = torch.tensor(
                np.asarray(jpools[0][key], np.float32)).bfloat16()
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=UNSHARDED, policy=JFP32)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=UNSHARDED, cfg=jcfg,
            policy=JFP32, memory_len=0, block_tables=jtab,
            paged_segments=(True,))
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab)
        np.testing.assert_allclose(_np(txd), _np(jxd), **F32)
        np.testing.assert_allclose(
            _np(_torch_logits(tcfg, tp, txd[:, None])),
            _np(_jax_logits(jcfg, jp, jxd[:, None])), **DECODE_LOGITS)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tpools[0][key][:, :10]),
                                       _np(jpools[0][key]), **BF16)


def test_forward_prefill_padded_bucket_matches_exact():
    """Right-padding to a length bucket does not change the next token or
    the true-length KV (causality masks the pads)."""
    _, tcfg, _, tp = _models("gpt-j")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, tcfg.vocab, (1, 11), dtype=np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[:, :11] = prompt
    tok_a, cache_a, pos_a = tlm.forward_prefill(
        tp, torch.tensor(prompt), cfg=tcfg, policy=FP32, max_seq=32,
        compact_kv=True)
    tok_b, cache_b, pos_b = tlm.forward_prefill(
        tp, torch.tensor(padded), cfg=tcfg, policy=FP32, max_seq=32,
        prompt_len=np.array([11]), compact_kv=True)
    assert int(tok_a[0]) == int(tok_b[0]) and int(pos_b[0]) == 11
    np.testing.assert_array_equal(_np(cache_a[0]["k"]),
                                  _np(cache_b[0]["k"][:, :, :11]))


def test_lane_scores_bit_equal_with_reference_noise():
    """Sampling scores: greedy rows raw, sampled rows top-k-masked /
    temperature-scaled / Gumbel-perturbed — bit-equal to the reference in
    fp32 when both see the reference's own threefry noise."""
    rng = np.random.default_rng(8)
    B, V = 4, 256
    z = rng.standard_normal((B, V)).astype(np.float32) * 3
    z[:, 250:] = -1e30                                   # padded columns
    lane = {"temperature": np.array([0.0, 0.7, 1.3, 0.5], np.float32),
            "top_k": np.array([0, 40, 0, 1], np.int32),
            "seed": np.array([1, 2, 3, 4], np.int32),
            "step": np.array([10, 11, 12, 13], np.int32)}

    def gumbel_row(seed, step):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                    step), 0)
        return jax.random.gumbel(key, (V,), jnp.float32)
    noise = np.asarray(jax.vmap(gumbel_row)(jnp.asarray(lane["seed"]),
                                            jnp.asarray(lane["step"])))
    want = jemb._lane_scores(jnp.asarray(z),
                             {k: jnp.asarray(v) for k, v in lane.items()},
                             plan=UNSHARDED)
    got = temb._lane_scores(torch.tensor(z), device_lane(lane, "cpu"),
                            noise=torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_noise_is_keyed_by_seed_and_step():
    lane = {"temperature": np.array([1.0, 1.0, 0.0], np.float32),
            "seed": np.array([5, 5, 5]), "step": np.array([9, 9, 9])}
    g = temb.gumbel_noise(device_lane(lane, "cpu"), 64)
    assert torch.equal(g[0], g[1])                       # same (seed, step)
    assert torch.count_nonzero(g[2]) == 0                # greedy row
    lane["step"] = np.array([9, 10, 9])
    assert not torch.equal(
        temb.gumbel_noise(device_lane(lane, "cpu"), 64)[1], g[1])
