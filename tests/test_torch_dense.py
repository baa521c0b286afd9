"""PyTorch port, the remaining dense decoders: chatglm3-6b (GQA 32 / 2, rope
on half of each head: the decode fold's G = 16 form), deepseek-67b and
internvl2-76b (a VLM backbone behind its patch prefix), held to the JAX
reference on the CPU.

  * the three configs and the two registered drafts field for field, and
    internvl2 without a draft, as in the reference;
  * `core/rope.apply_rope` at fraction 0.5, 1-D and 2-D positions;
  * the decode kernels' plain versions and the port's oracles at H 32 /
    KV 2 (G = 16): the paged partials and normalized decode over bf16,
    fp32 and int8 pools, the dense decode (the TPU kernel's walk and the
    card's split grid), against the reference's Pallas kernels in
    interpret mode; `_fold_shape_ok` takes G = 16 at D 128 and refuses
    G * D > 2048;
  * the weights carried across (`params_from_numpy`) for each config;
  * a chatglm3-shaped narrow config (2 layers, 32 / 2 heads of head_dim 16,
    rope_fraction 0.5: `reduced()` caps the heads at 4 / 2, which cannot
    show G = 16): `forward_prefill` and teacher-forced decode against the
    reference's `lm`;
  * internvl2-76b reduced (4 patches): prefill with seeded patches
    (`frontends.make_batch` equal to the reference's), decode at the
    offset positions, `forward_encode` with patches (last and mean), the
    engine against a direct prefill + decode loop, its prompt cap, the
    prefix's blocks and the chunk / prefix-cache / speculation refusals in
    the reference's words, and the CLI.

Tolerances: fp32 rtol = atol = 1e-4 (caches fp32 in both frameworks); bf16
2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import embedding as jemb
from repro.core import rope as jrope
from repro.core.precision import FP32 as JFP32
from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro.optim.compression import quantize_int8_axiswise as jquant
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import embedding as temb
from repro_torch.core import rope as trope
from repro_torch.core.precision import FP32
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (cache_layout, chunk_support_reason,
                                      make_paged_layout)
from repro_torch.models import frontends as tfront
from repro_torch.models import lm as tlm
from repro_torch.optim.compression import quantize_int8_axiswise
from repro_torch.serving import (InferenceEngine, Request, SpecConfig)
from repro_torch.serving.kv_cache import prefill_scatter
from repro_torch.serving.spec import spec_support_reason

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("chatglm3-6b", "deepseek-67b", "internvl2-76b")
MAX_SEQ = 64
# the reference's plan with fp32 prefill caches, as the port keeps them
# under the fp32 policy
PLAN = dataclasses.replace(UNSHARDED, kv_cache_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS + ("chatglm3-6b-draft",
                                          "deepseek-67b-draft"))
def test_config_copy_matches_reference(name, reduced):
    jcfg, tcfg = jax_config(name), get_config(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.n_params() == jcfg.n_params()


def test_internvl2_has_no_draft():
    from repro.configs import REGISTRY as JREGISTRY
    drafts = sorted(k for k in REGISTRY if k.endswith("-draft"))
    assert drafts == sorted(k for k in JREGISTRY if k.endswith("-draft"))
    assert "internvl2-76b-draft" not in REGISTRY


# --------------------------------------------------------------------------
# partial rope
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 2])
def test_apply_rope_half_fraction_matches_reference(ndim):
    rng = np.random.default_rng(ndim)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7, dtype=np.int32) + 5 if ndim == 1 else
           rng.integers(0, 500, (2, 7)).astype(np.int32))
    got = trope.apply_rope(torch.tensor(x), torch.tensor(pos),
                           theta=10_000.0, fraction=0.5)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            theta=10_000.0, fraction=0.5)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # the second half of each head passes through untouched
    np.testing.assert_array_equal(_np(got)[..., 8:], x[..., 8:])


# --------------------------------------------------------------------------
# the decode kernels at G = 16
# --------------------------------------------------------------------------

def _g16_paged(seed, dtype, D=64):
    """H 32 over KV 2: ragged lengths, absent entries, a hole in row 2."""
    rng = np.random.default_rng(seed)
    B, H, KV, NB, BS = 3, 32, 2, 14, 8
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    tab = np.array([[3, 7, -1, -1, -1, -1],
                    [1, 12, 4, 9, -1, -1],
                    [11, 0, -1, 5, 6, 13]], np.int32)
    lengths = np.array([13, 30, 45], np.int32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    j = [jnp.asarray(a).astype(jd) for a in (q, kp, vp)]
    t = [torch.tensor(a).to(td) for a in (q, kp, vp)]
    return (j, jnp.asarray(tab), jnp.asarray(lengths)), (
        t, torch.tensor(tab), torch.tensor(lengths))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_g16_matches_pallas(dtype):
    (jqkv, jt, jl), (tqkv, tt, tl) = _g16_paged(1, dtype)
    tol = F32 if dtype == "f32" else BF16
    pallas = jfd.paged_decode_attention(*jqkv, jt, jl, interpret=True)
    got = tfd.paged_decode_attention(*tqkv, tt, tl)          # plain (CPU)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(
        _np(tref.paged_decode_attention_ref(*tqkv, tt, tl)), _np(pallas),
        **tol)
    po, pm, pl_ = jfd.paged_decode_partials(*jqkv, jt, jl, interpret=True)
    o, m, l = tfd.paged_decode_partials(*tqkv, tt, tl)
    for a, b in ((o, po), (m, pm), (l, pl_)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    # the split grid the card runs (`paged_splits` at these shapes) merges
    # to the same output
    so, sm, sl = tfd.paged_decode_partials(*tqkv, tt, tl, 3)
    merged = tfd.paged_decode_merge_plain(so, sm, sl, out_dtype=torch.float32)
    np.testing.assert_allclose(_np(merged), _np(pallas), **tol)


def test_paged_decode_g16_int8_pools_match_pallas():
    (jqkv, jt, jl), (tqkv, tt, tl) = _g16_paged(2, "f32")
    jq, jk, jv = jqkv
    kq, ks = quantize_int8_axiswise(tqkv[1], axis=(0, 2))
    vq, vs = quantize_int8_axiswise(tqkv[2], axis=(0, 2))
    jkq, jks = jquant(jk, axis=(0, 2))
    jvq, jvs = jquant(jv, axis=(0, 2))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    sc, jsc = dict(k_scale=ks, v_scale=vs), dict(k_scale=jks, v_scale=jvs)
    pallas = jfd.paged_decode_attention(jq, jkq, jvq, jt, jl,
                                        interpret=True, **jsc)
    got = tfd.paged_decode_attention(tqkv[0], kq, vq, tt, tl, **sc)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)
    np.testing.assert_allclose(
        _np(tref.paged_decode_attention_ref(tqkv[0], kq, vq, tt, tl, **sc)),
        _np(pallas), **F32)
    po, pm, pl_ = jfd.paged_decode_partials(jq, jkq, jvq, jt, jl,
                                            interpret=True, **jsc)
    o, m, l = tfd.paged_decode_partials(tqkv[0], kq, vq, tt, tl, **sc)
    for a, b in ((o, po), (m, pm), (l, pl_)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_decode_g16_matches_pallas(dtype):
    """A draft's linear cache at G = 16: the TPU kernel's walk (the CPU
    path), the card's split grid and the oracle."""
    rng = np.random.default_rng(4)
    B, H, KV, D, S = 3, 32, 2, 64, 96
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    lengths = np.array([1, 37, 96], np.int32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32 if dtype == "f32" else BF16
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).to(td) for a in (q, k, v))
    tl = torch.tensor(lengths)
    pallas = jfd.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                  block_kv=32, interpret=True)
    got = tfd.decode_attention(tq, tk, tv, tl)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    splits = tfd.dense_splits(B, KV, S)
    np.testing.assert_allclose(
        _np(tfd.decode_attention_plain(tq, tk, tv, tl, splits=splits)),
        _np(pallas), **tol)
    np.testing.assert_allclose(
        _np(tref.decode_attention_ref(tq, tk, tv, tl)),
        _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))),
        **tol)


def test_fold_shapes_take_g16_and_refuse_wider():
    assert tfd._fold_shape_ok(32, 2, 128, 2)       # chatglm3: G 16, D 128
    assert tfd._fold_shape_ok(32, 2, 128, 1)       # its int8 pools
    assert tfd._fold_shape_ok(64, 8, 128, 2)       # deepseek / internvl2
    assert not tfd._fold_shape_ok(32, 2, 256, 2)   # G * D = 4096
    assert not tfd._fold_shape_ok(32, 1, 64, 2)    # G = 32
    msg = tfd._shape_error("paged_decode_attention", 32, 1, 64)
    assert "H 32 / KV 1 at D 64" in msg and "16 query heads" in msg
    # chatglm3's serving grid: KV 2 x 4 slots = 8 (kv head, slot) pairs a
    # split, spread over 8 splits of a 512-position table
    assert tfd.paged_splits(4, 2, 32, at_least=tfd.paged_min_splits(
        32, 16)) == 8


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

def _narrow_glm(cfg):
    """chatglm3 reduced, widened back to 32 query heads over 2 kv heads."""
    return dataclasses.replace(cfg.reduced(), n_heads=32, n_kv_heads=2,
                               head_dim=16)


def _model(name, seed):
    if name == "chatglm3-narrow":
        jcfg = _narrow_glm(jax_config("chatglm3-6b"))
        tcfg = _narrow_glm(get_config("chatglm3-6b"))
    else:
        jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for p in ([seg[ln] for seg in tree["segments"] for ln in ("ln1", "ln2")]
              + [tree["final_norm"]]):
        p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)
                      ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def glm():
    return _model("chatglm3-narrow", 3)


@pytest.fixture(scope="module")
def vlm():
    return _model("internvl2-76b", 5)


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_numpy_carries_the_tree(name):
    """The same `attn` + SwiGLU tree: every reference leaf lands unchanged."""
    _, tcfg, jp, tp = _model(name, 1)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves) == sum(1 for _ in _torch_leaves(tp))
    for path, leaf in leaves:
        node = tp
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    assert set(tp["segments"][0]["mlp"]) == {"wg", "wu", "w2"}


def _torch_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _torch_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _torch_leaves(v)
    else:
        yield tree


def _logits(cfg, p, x, fused, ref):
    """Per-position logits of x [B, S, E] through the fused head or the
    unfused chain, in either framework."""
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    if ref:
        norm = jops.norm_prologue(p["final_norm"], cfg.norm)
        if not fused:
            xt, norm = jops.norm(xt, p["final_norm"], cfg.norm), None
        z, _ = jemb.logits_local(xt, p["embedding"]["unemb"], plan=PLAN,
                                 cfg=cfg, policy=JFP32, norm=norm)
    else:
        norm = tops.norm_prologue(p["final_norm"], cfg.norm)
        if not fused:
            xt, norm = tops.norm(xt, p["final_norm"], cfg.norm), None
        z = temb.logits_local(xt, p["embedding"]["unemb"], cfg=cfg,
                              policy=FP32, norm=norm)
    return z.reshape(B, S, -1)


def _plan(fused):
    return PLAN if fused else dataclasses.replace(PLAN, fuse_epilogues=False)


def _teacher_forced(model, fused, *, patches=None, n_dec=3, S=13):
    """Every prefill position's logits, then n_dec teacher-forced paged
    decode steps at positions n_p + S + i, port against reference, caches
    fp32 in both."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    B, BS, NB = 2, 8, 12
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :S])}
    tpatch = None
    n_p = 0
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
        tpatch = torch.tensor(patches)
        n_p = patches.shape[1]
    jx = jlm._embed_sequence(jp, batch, plan=PLAN, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=_plan(fused), cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(tokens[:, :S]), cfg=tcfg,
                             policy=FP32, patches=tpatch)
    assert tx.shape[1] == tlm.total_seq(tcfg, S) == n_p + S
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=MAX_SEQ, fused=fused,
                                            compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(_np(_logits(tcfg, tp, tx, fused, False)),
                               _np(_logits(jcfg, jp, jx, fused, True)),
                               **F32)
    layout = make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB, block_size=BS)
    tpools = cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                          device="cpu")
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    ne = -(-(n_p + S + n_dec) // BS)
    tables[0, :ne] = [4, 1, 8, 10][:ne]
    tables[1, :ne] = [0, 9, 2, 11][:ne]
    prefill_scatter(tpools, tcaches, torch.arange(B), torch.tensor(tables),
                    block_size=BS)
    shape = (jcfg.n_layers, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jpools = ({"k": jnp.zeros(shape, jnp.float32),
               "v": jnp.zeros(shape, jnp.float32)},)
    jpools = make_prefill_scatter((True,), BS)(
        jpools, jcaches, jnp.arange(B, dtype=jnp.int32), jnp.asarray(tables))
    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    for i in range(n_dec):
        pos = np.full((B,), n_p + S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=PLAN, policy=JFP32)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=_plan(fused), cfg=jcfg,
            policy=JFP32, memory_len=0, block_tables=jtab,
            paged_segments=(True,))
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused)
        np.testing.assert_allclose(
            _np(_logits(tcfg, tp, txd[:, None], fused, False)),
            _np(_logits(jcfg, jp, jxd[:, None], fused, True)), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tpools[0][key][:, :NB]),
                                   _np(jpools[0][key]), **F32)


@pytest.mark.parametrize("fused", [True, False])
def test_glm_g16_teacher_forced_matches_reference(glm, fused):
    assert glm[1].n_heads // glm[1].n_kv_heads == 16
    assert glm[1].rope_fraction == 0.5
    _teacher_forced(glm, fused)


def _entry_points(model, patches=None):
    """`forward_prefill` over a right-padded batch (the next token and its
    position, the compact caches) and one `forward_decode` step from it,
    port against reference."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(9)
    B, S, BS = 2, 12, 8
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    plen = np.array([9, 12], np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    kw = {}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
        kw["patches"] = torch.tensor(patches)
    jtok, jcaches, jpos = jlm.forward_prefill(
        jp, batch, plan=PLAN, cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        prompt_len=jnp.asarray(plen), compact_kv=True)
    ttok, tcaches, tpos = tlm.forward_prefill(
        tp, torch.tensor(tokens), cfg=tcfg, policy=FP32, max_seq=MAX_SEQ,
        prompt_len=plen, compact_kv=True, **kw)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tpos.tolist() == np.asarray(jpos).tolist()
    assert tpos.tolist() == (plen + (tcfg.n_patches or 0)).tolist()
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcaches[0][key]),
                                   _np(jcaches[0][key]), **F32)
    NB = 2 * (MAX_SEQ // BS)
    layout = make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB, block_size=BS)
    tables = np.arange(NB, dtype=np.int32).reshape(B, -1)
    tpools = cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                          device="cpu")
    prefill_scatter(tpools, tcaches, torch.arange(B), torch.tensor(tables),
                    block_size=BS)
    shape = (jcfg.n_layers, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jpools = make_prefill_scatter((True,), BS)(
        ({"k": jnp.zeros(shape), "v": jnp.zeros(shape)},), jcaches,
        jnp.arange(B, dtype=jnp.int32), jnp.asarray(tables))
    jnext, _ = jlm.forward_decode(jp, jtok, jpos, jpools, plan=PLAN,
                                  cfg=jcfg, policy=JFP32,
                                  block_tables=jnp.asarray(tables),
                                  paged_segments=(True,))
    tnext, _ = tlm.forward_decode(tp, ttok, tpos, tpools, cfg=tcfg,
                                  policy=FP32,
                                  block_tables=torch.tensor(tables))
    assert tnext.tolist() == np.asarray(jnext).tolist()


def test_glm_g16_entry_points_match_reference(glm):
    _entry_points(glm)


def test_make_batch_matches_reference():
    jcfg = jax_config("internvl2-76b").reduced()
    tcfg = get_config("internvl2-76b").reduced()
    assert tcfg.n_patches == 4
    want = jfront.make_batch(jcfg, "prefill", 3, 20, seed=4)
    got = tfront.make_batch(tcfg, 3, 20, seed=4)
    assert set(got) == set(want) == {"tokens", "patches"}
    assert got["tokens"].shape == (3, 16)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["patches"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got["patches"]), _np(want["patches"]))
    z = tfront.serving_patches(tcfg, 2, device="cpu")
    assert z.shape == (2, 4, tcfg.d_model) and not z.any()
    assert tfront.serving_patches(get_config("chatglm3-6b"), 2,
                                  device="cpu") is None


def _patches(cfg, B, seed):
    return tfront.make_batch(cfg, B, cfg.n_patches + 1,
                             seed=seed)["patches"].float().numpy()


@pytest.mark.parametrize("fused", [True, False])
def test_vlm_teacher_forced_with_patches_matches_reference(vlm, fused):
    _teacher_forced(vlm, fused, patches=_patches(vlm[1], 2, 11))


def test_vlm_entry_points_match_reference(vlm):
    _entry_points(vlm, patches=_patches(vlm[1], 2, 12))


@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_vlm_forward_encode_with_patches_matches_reference(vlm, pooling):
    jcfg, tcfg, jp, tp = vlm
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, jcfg.vocab, (2, 10), dtype=np.int32)
    plen = np.array([6, 10], np.int32)
    patches = _patches(tcfg, 2, 14)
    want = jlm.forward_encode(
        jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)},
        plan=PLAN, cfg=jcfg, policy=JFP32, prompt_len=jnp.asarray(plen),
        pooling=pooling)
    got = tlm.forward_encode(tp, torch.tensor(tokens), cfg=tcfg,
                             policy=FP32, prompt_len=plen, pooling=pooling,
                             patches=torch.tensor(patches))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    with pytest.raises(ValueError, match="patch rows"):
        tlm.forward_encode(tp, torch.tensor(tokens), cfg=tcfg, policy=FP32)


def _direct_tokens(cfg, params, prompt, n_new, block_size=16):
    """Unpadded prefill behind zero patches + greedy paged decode loop,
    outside the engine."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True,
        patches=tfront.serving_patches(cfg, 1, device="cpu"))
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
                                        policy=FP32, block_tables=table)
        pos = pos + 1
        toks.append(int(tok[0]))
    return toks


def test_vlm_engine_matches_direct_loop(vlm):
    _, tcfg, _, tp = vlm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n, dtype=np.int32)
               for n in (5, 9, 16, 59)]
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu", prefix_cache=True)
    r = eng.runner
    assert r.prompt_cap == MAX_SEQ - 1 - 4
    assert r.bucket_for(59) == MAX_SEQ - 4
    # the prefix cache and chunking stay off, in the reference's words
    reason = "patch prefixes occupy unpaged cache positions"
    assert eng.prefix_cache is None and r.prefix_cache_reason == reason
    assert not r.supports_chunked and r.chunk_unsupported_reason == reason
    assert chunk_support_reason(tcfg, r.layout) == reason
    reqs = [Request(uid=u, prompt=p, max_new_tokens=4)
            for u, p in enumerate(prompts)]
    for q in reqs:
        eng.submit(q)
    # blocks count the prefix: 4 + 59 + the decode tail fill 4 blocks
    assert r.blocks_needed(reqs[3]) == r.allocator.blocks_for(4 + 59) == 4
    with pytest.raises(ValueError, match="patch prefix=4"):
        eng.submit(Request(uid=9, prompt=np.zeros(60, np.int32),
                           max_new_tokens=1))
    done = sorted(eng.run(), key=lambda q: q.uid)
    # the longest prompt's first token lands at position 4 + 59 = max_seq
    # - 1, the horizon: it retires there
    assert [len(q.output) for q in done] == [4, 4, 4, 1]
    for q in done:
        assert _direct_tokens(tcfg, tp, q.prompt, len(q.output)) == q.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_vlm_speculation_refused_in_the_reference_words(vlm):
    _, tcfg, _, tp = vlm
    reason = "VLM patch prefixes are not supported in verify chunks"
    assert spec_support_reason(tcfg) == reason
    with pytest.raises(ValueError, match=reason):
        InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                        policy=FP32, device="cpu",
                        spec=SpecConfig(draft="auto", k=2))


def test_cli_serves_the_new_configs_and_says_why(capsys):
    assert tserve.main(["--arch", "internvl2-76b", "--reduced", "--device",
                        "cpu", "--requests", "2", "--batch", "2",
                        "--prompt-len", "12", "--max-new", "3",
                        "--policy", "chunked"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert ("cannot chunk prefills (patch prefixes occupy unpaged cache "
            "positions)") in out
    assert "prefix cache disabled for internvl2-76b-reduced" in out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "internvl2-76b", "--reduced", "--device",
                     "cpu", "--spec-draft", "auto"])
    assert ("VLM patch prefixes are not supported in verify chunks"
            in capsys.readouterr().err)
    assert tserve.main(["--arch", "chatglm3-6b", "--reduced", "--device",
                        "cpu", "--requests", "2", "--batch", "2",
                        "--prompt-len", "12", "--max-new", "3",
                        "--spec-draft", "chatglm3-6b-draft"]) == 0
    assert "spec: draft=chatglm3-6b-draft-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_fit_check(arch, monkeypatch, capsys):
    """On an 80 GB card chatglm3-6b is served whole; deepseek-67b and
    internvl2-76b are refused before any weight is made."""
    monkeypatch.setattr(tserve, "device_memory_bytes", lambda dev: 80 * 10**9)
    cfg = get_config(arch)
    if arch == "chatglm3-6b":
        assert tserve.fit_reason(cfg, "cpu") is None
        return

    def no_init(*a, **k):
        raise AssertionError("weights made before the size check")
    monkeypatch.setattr(tserve.lm, "init_lm", no_init)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", arch, "--device", "cpu"])
    assert exc.value.code == 2
    gb = {"deepseek-67b": "134.8", "internvl2-76b": "141.1"}[arch]
    err = capsys.readouterr().err
    assert f"{gb} GB" in err and "80.0 GB" in err
