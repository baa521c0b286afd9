"""PyTorch port, the SwiGLU / RMSNorm / GQA `attn` path: phi4-mini-3.8b
against the reference at its reduced config (2 layers, d_model 64, 4 query
heads over 2 KV heads, d_ff 128), fp32 policy, on the CPU.

  * the config copy and the weight converter (`wg / wu / w2`, norms with
    no bias);
  * `block_full` / `block_decode`, fused and unfused, against
    `repro.core.blocks`;
  * teacher-forced logits at every prefill position and after paged decode
    steps, fused and unfused, against the reference `lm`;
  * the engine against the port's own direct forward loop (greedy), and a
    sampled request's tokens against the reference's sampler
    teacher-forced on the same sequence.

Tolerances: fp32 rtol = atol = 1e-4; bf16 KV pools 2e-2; decode logits
1e-3 (a bf16 cache row rounded one ulp apart moves them by ~2e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import blocks as jblocks
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import cache_layout, make_paged_layout
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import prefill_scatter

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

ARCH = "phi4-mini-3.8b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
DECODE_LOGITS = dict(rtol=1e-3, atol=1e-3)
MAX_SEQ = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _plan(fused):
    return UNSHARDED if fused else dataclasses.replace(UNSHARDED,
                                                       fuse_epilogues=False)


@pytest.fixture(scope="module")
def model():
    """Reference weights with the RMSNorm scales perturbed off 1 (so the
    prologues matter), converted through numpy."""
    jcfg, tcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(11), jcfg, jnp.float32))
    rng = np.random.default_rng(11)
    norms = [seg[ln] for seg in tree["segments"] for ln in ("ln1", "ln2")]
    for p in norms + [tree["final_norm"]]:
        p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)
                      ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, tlm.params_from_numpy(tree, tcfg,
                                                      device="cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert reduced or tcfg.padded_vocab == 200192
    assert tcfg.n_params() == jcfg.n_params()


def test_params_from_numpy_swiglu_tree(model):
    _, tcfg, jparams, tparams = model
    seg = tparams["segments"][0]
    assert set(seg["mlp"]) == {"wg", "wu", "w2"}
    assert set(seg["ln1"]) == {"scale"} and set(tparams["final_norm"]) == {
        "scale"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))


@pytest.mark.parametrize("fused", [True, False])
def test_block_full_matches_reference(model, fused):
    jcfg, tcfg, jp, tp = model
    jlayer = jax.tree.map(lambda a: a[1], jp["segments"][0])
    tlayer = tptree.layer(tp["segments"][0], 1)
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
        assert tcache[key].shape == jcache[key].shape == (2, 11, 2, 16)
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **BF16)


@pytest.mark.parametrize("fused", [True, False])
def test_block_decode_matches_reference(model, fused):
    """One paged GQA decode step (G = 2): the updated stream and the pools
    after the append."""
    jcfg, tcfg, jp, tp = model
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0])
    tlayer = tptree.layer(tp["segments"][0], 0)
    rng = np.random.default_rng(3)
    B, NB, BS, KV, hd = 3, 9, 8, jcfg.n_kv_heads, jcfg.head_dim
    pools = [rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
             for _ in range(2)]
    tab = np.array([[2, 5, -1, -1], [0, 7, 1, -1], [4, 3, 6, 8]], np.int32)
    pos = np.array([12, 20, 31], np.int32)
    x = rng.standard_normal((B, 64)).astype(np.float32)
    jcache = {k: jnp.asarray(v).astype(jnp.bfloat16)
              for k, v in zip("kv", pools)}
    sink = np.zeros((1, BS, KV, hd), np.float32)
    tcache = {k: torch.tensor(np.concatenate([v, sink])).bfloat16()
              for k, v in zip("kv", pools)}
    jy, jc = jblocks.block_decode(
        "attn", jlayer, jnp.asarray(x), jnp.asarray(pos), jcache,
        plan=_plan(fused), cfg=jcfg, policy=JFP32,
        block_tables=jnp.asarray(tab), paged=True)
    ty, tc = tblocks.block_decode("attn", tlayer, torch.tensor(x),
                                  torch.tensor(pos), tcache, cfg=tcfg,
                                  policy=FP32, block_tables=torch.tensor(tab),
                                  fused=fused)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[key][:NB]), _np(jc[key]))


def _jax_logits(jcfg, jp, x, fused):
    """Per-position logits of final residuals x [B, S, E]: the fused head
    (final norm as the GEMM prologue) or the unfused chain."""
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    norm = jops.norm_prologue(jp["final_norm"], jcfg.norm)
    if not fused:
        xt, norm = jops.norm(xt, jp["final_norm"], jcfg.norm), None
    z, _ = jemb.logits_local(xt, jp["embedding"]["unemb"], plan=UNSHARDED,
                             cfg=jcfg, policy=JFP32, norm=norm)
    return z.reshape(B, S, -1)


def _torch_logits(tcfg, tp, x, fused):
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    norm = tops.norm_prologue(tp["final_norm"], tcfg.norm)
    if not fused:
        xt, norm = tops.norm(xt, tp["final_norm"], tcfg.norm), None
    z = temb.logits_local(xt, tp["embedding"]["unemb"], cfg=tcfg,
                          policy=FP32, norm=norm)
    return z.reshape(B, S, -1)


@pytest.mark.parametrize("fused", [True, False])
def test_teacher_forced_logits_prefill_and_decode(model, fused):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    B, S, BS, n_dec = 2, 13, 8, 3
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    prompt = tokens[:, :S]

    jx = jlm._embed_sequence(jp, {"tokens": jnp.asarray(prompt)},
                             plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=_plan(fused), cfg=jcfg, policy=JFP32, max_seq=32,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(prompt), policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=32, fused=fused,
                                            compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(_np(_torch_logits(tcfg, tp, tx, fused)),
                               _np(_jax_logits(jcfg, jp, jx, fused)), **F32)

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
    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    for i in range(n_dec):
        # each step starts from the reference's pools (see test_torch_lm)
        for key in ("k", "v"):
            tpools[0][key][:, :10] = torch.tensor(
                np.asarray(jpools[0][key], np.float32)).bfloat16()
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=UNSHARDED, policy=JFP32)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=_plan(fused), cfg=jcfg,
            policy=JFP32, memory_len=0, block_tables=jtab,
            paged_segments=(True,))
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused)
        np.testing.assert_allclose(_np(txd), _np(jxd), **F32)
        np.testing.assert_allclose(
            _np(_torch_logits(tcfg, tp, txd[:, None], fused)),
            _np(_jax_logits(jcfg, jp, jxd[:, None], fused)), **DECODE_LOGITS)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tpools[0][key][:, :10]),
                                       _np(jpools[0][key]), **BF16)


def _direct_tokens(cfg, params, prompt, n_new, fused, block_size=16):
    """Unpadded prefill + greedy paged decode loop, outside the engine."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True, fused=fused)
    layout = make_paged_layout(cfg, MAX_SEQ, -(-MAX_SEQ // block_size),
                               block_size)
    pools = cache_layout(cfg, layout, batch_size=1, policy=FP32,
                         device="cpu")
    table = torch.arange(layout.max_blocks, dtype=torch.int32)[None]
    prefill_scatter(pools, caches, torch.arange(1), table,
                    block_size=block_size)
    toks = [int(tok[0])]
    for _ in range(n_new - 1):
        tok, pools = tlm.forward_decode(params, tok, pos, pools, cfg=cfg,
                                        policy=FP32, block_tables=table,
                                        fused=fused)
        pos = pos + 1
        toks.append(int(tok[0]))
    return toks


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_direct_loop(model, fused):
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg, (5, 9, 16, 23), seed=3)
    eng = InferenceEngine(tcfg, tparams, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, fuse_epilogues=fused, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(r.output) for r in done] == [6] * 4
    for req in done:
        assert _direct_tokens(tcfg, tparams, req.prompt, 6,
                              fused) == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_sampled_engine_tokens_match_reference_sampler(model):
    """A sampled request (T = 0.8, top-k 40) through the port's engine:
    each emitted token is the one the reference's `sample_token` picks,
    with its own threefry noise, from the reference's logits at that
    position, teacher-forced over the same sequence."""
    jcfg, tcfg, jp, tp = model
    prompt = _prompts(tcfg, (14,), seed=8)[0]
    sp = SamplingParams(temperature=0.8, top_k=40, seed=1234)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8, sampling=sp))
    out = eng.run()[0].output
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int32)
    x = jlm._embed_sequence(jp, {"tokens": jnp.asarray(seq)[None]},
                            plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                            with_labels=False)[0]
    x, _ = jlm._run_segments_prefill(jp, x, plan=UNSHARDED, cfg=jcfg,
                                     policy=JFP32, max_seq=MAX_SEQ,
                                     memory=None, memory_len=0,
                                     compact_kv=True)
    n = len(prompt)
    rows = len(out)
    lane = {"temperature": jnp.full((rows,), 0.8, jnp.float32),
            "top_k": jnp.full((rows,), 40, jnp.int32),
            "seed": jnp.full((rows,), 1234, jnp.int32),
            "step": jnp.arange(n, n + rows, dtype=jnp.int32)}
    want = jemb.sample_token(
        x[0, n - 1:], jp["embedding"]["unemb"], lane, plan=UNSHARDED,
        cfg=jcfg, policy=JFP32,
        norm=jops.norm_prologue(jp["final_norm"], jcfg.norm))
    assert out == np.asarray(want).tolist()
