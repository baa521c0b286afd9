"""PyTorch port, whisper-base (the encoder-decoder), held to the JAX
reference on the CPU.

  * the config field for field (full and reduced), its parameter count
    (97,165,312), `enc_seq_padded`, the registry's 21 entries and the
    reference's aliases, and no draft;
  * `core/rope.sinusoidal_positions` at several (n, d, offset), odd d
    included, and at the full 1504 x 512 table;
  * the weights carried across (`params_from_numpy`: `enc_segments`,
    `enc_final_norm`, the dec layers' `lnx` / `xattn`);
  * the encoder (`lm._run_encoder`), the `dec` block's full pass with its
    caches (k / v and the cross caches ck / cv) and its decode step with
    the cross step, fused and unfused;
  * `forward_prefill`, then teacher-forced decode steps, over the paged
    layout (the cross caches scattered into their slots' rows) and the
    dense one; the entry points over a right-padded batch; `forward_encode`
    with both poolings; int8 weights and int8 KV teacher-forced on the
    reference's quantized weights;
  * `frontends.make_batch` equal to the reference's (seeded frames, zero
    padding rows), the zero serving frames, a missing or misshapen
    `frames` refused by name, and the frames reaching the logits;
  * the engine against a direct prefill + decode loop (greedy and sampled
    lanes, bf16 and int8 weights and KV), its encodes against
    `forward_encode`, the decode step free of host data, the prefix
    cache, chunked policy and speculation refused in the reference's
    words, and the CLI on reduced whisper.

Free-running engine tokens are compared port against port only.  The
reduced config has 2 + 2 layers, d_model 64 and enc_seq 12 -> 16.
Tolerances: fp32 rtol = atol = 1e-4 (caches fp32 in both frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jax_config
from repro.core import blocks as jblocks
from repro.core import embedding as jemb
from repro.core import rope as jrope
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro.models import quantize as jquant
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import ALIASES, REGISTRY, WHISPER_BASE, get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core import embedding as temb
from repro_torch.core import rope as trope
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import frontends as tfront
from repro_torch.models import lm as tlm
from repro_torch.models.params import layer
from repro_torch.models.quantize import quantize_params
from repro_torch.serving import (EncodeTask, InferenceEngine, Request,
                                 SamplingParams, SpecConfig, make_policy)
from repro_torch.serving.kv_cache import prefill_scatter
from repro_torch.serving.sampling import device_lane, stack_lanes
from repro_torch.serving.spec import spec_support_reason

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 64
NAME = "whisper-base"
# the reference's plan with fp32 prefill caches, as the port keeps them
# under the fp32 policy
PLAN = dataclasses.replace(UNSHARDED, kv_cache_dtype="float32")
CROSS_REASON = "cross-attention memory is not paged"
SPEC_REASON = "encoder-decoder cross-attention memory is not paged"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _plan(fused):
    return PLAN if fused else dataclasses.replace(PLAN, fuse_epilogues=False)


def _jlayer(seg, i):
    return jax.tree.map(lambda a: a[i], seg)


# --------------------------------------------------------------------------
# config and positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    jcfg, tcfg = jax_config(NAME), get_config(NAME)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.enc_seq_padded == jcfg.enc_seq_padded
    assert tcfg.n_params() == jcfg.n_params()
    if reduced:
        assert (tcfg.enc_seq, tcfg.enc_seq_padded) == (12, 16)
    else:
        assert tcfg.n_params() == 97_165_312
        assert (tcfg.enc_seq_padded, tcfg.padded_vocab) == (1504, 51968)


def test_registry_holds_every_reference_entry():
    assert set(REGISTRY) == set(JREGISTRY) and len(REGISTRY) == 21
    assert get_config("whisper_base") is get_config(NAME) is WHISPER_BASE
    from repro.configs import ALIASES as JALIASES
    assert ALIASES == JALIASES
    # no draft, as in the reference
    assert f"{NAME}-draft" not in REGISTRY
    for name, cfg in REGISTRY.items():
        assert cfg.enc_seq_padded == JREGISTRY[name].enc_seq_padded


@pytest.mark.parametrize("n,d,offset", [(16, 64, 0), (12, 9, 3), (100, 512, 0),
                                        (7, 1, 0), (5, 2, 40), (33, 65, 7)])
def test_sinusoidal_positions_match_reference(n, d, offset):
    want = np.asarray(jrope.sinusoidal_positions(n, d, offset))
    got = trope.sinusoidal_positions(n, d, offset)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (n, d // 2 * 2)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_sinusoidal_table_at_full_size():
    """whisper's 1504 x 512 table.  The two packages' fp32 exp can differ by
    one ulp in a frequency (XLA's is not correctly rounded), and row p
    multiplies that by p: the tolerance is 1e-4 plus p x 2^-22, two ulps of
    each frequency times the position."""
    n, d = WHISPER_BASE.enc_seq_padded, WHISPER_BASE.d_model
    want = np.asarray(jrope.sinusoidal_positions(n, d))
    got = trope.sinusoidal_positions(n, d).numpy()
    tol = 1e-4 + np.arange(n)[:, None] * 2.0 ** -22
    assert (np.abs(got - want) <= tol).all()
    np.testing.assert_allclose(got[:64], want[:64], **F32)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def _norms(tree):
    out = [tree["final_norm"], tree["enc_final_norm"]]
    for seg in tree["segments"] + tree["enc_segments"]:
        out += [seg[k] for k in ("ln1", "ln2", "lnx") if k in seg]
    return out


def _model(seed, *, quantized=False):
    jcfg, tcfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for p in _norms(tree):      # unit / zero norms would hide a missed norm
        p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)
                      ).astype(np.float32)
        p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)
                     ).astype(np.float32)
    if quantized:
        tree = jax.tree.map(np.asarray,
                            jquant.quantize_params(jax.tree.map(jnp.asarray,
                                                                tree)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _model(3)


def _frames(cfg, B, seed):
    return tfront.make_batch(cfg, B, 4, seed=seed)["frames"].float().numpy()


def _torch_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _torch_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _torch_leaves(v)
    else:
        yield tree


def test_params_from_numpy_carries_the_tree(model):
    _, tcfg, jp, tp = model
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves) == sum(1 for _ in _torch_leaves(tp))
    for path, leaf in leaves:
        node = tp
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    dec, enc = tp["segments"][0], tp["enc_segments"][0]
    assert set(dec) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert set(enc) == {"ln1", "attn", "ln2", "mlp"}
    assert set(tp["enc_final_norm"]) == {"scale", "bias"}
    shapes = tlm.lm_param_shapes(tcfg)
    assert shapes["segments"][0]["xattn"]["wk"] == (2, 64, 32)
    # the port's own init draws the same tree
    own = tlm.init_lm(tcfg, dtype=torch.float32, device="cpu", seed=0)
    assert sum(t.numel() for t in _torch_leaves(own)) == sum(
        t.numel() for t in _torch_leaves(tp))
    assert not any(torch.equal(a, b) for a, b in zip(
        own["enc_segments"][0]["attn"].values(),
        own["segments"][0]["xattn"].values()))


def test_quantize_params_reaches_cross_attention(model):
    """int8 weights: every projection of the encoder's layers and of the
    decoder's self- and cross-attention, bit-equal to the reference's
    `quantize_params`."""
    _, tcfg, jp, tp = model
    want = jax.tree.map(np.asarray, jquant.quantize_params(jp))
    got = quantize_params(tp)
    for group in ("attn", "xattn", "mlp"):
        for k, leaf in got["segments"][0][group].items():
            ref = want["segments"][0][group][k]
            np.testing.assert_array_equal(leaf["q"].numpy(), ref["q"])
            np.testing.assert_array_equal(leaf["scale"].numpy(),
                                          ref["scale"])
    for k, leaf in got["enc_segments"][0]["attn"].items():
        np.testing.assert_array_equal(
            leaf["q"].numpy(), want["enc_segments"][0]["attn"][k]["q"])
    assert torch.equal(got["enc_final_norm"]["scale"],
                       tp["enc_final_norm"]["scale"])


# --------------------------------------------------------------------------
# encoder and blocks
# --------------------------------------------------------------------------

def _memories(model, fused, B=2, seed=21):
    jcfg, tcfg, jp, tp = model
    frames = _frames(tcfg, B, seed)
    jm = jlm._run_encoder(jp, {"frames": jnp.asarray(frames)},
                          plan=_plan(fused), cfg=jcfg, policy=JFP32)
    tm = tlm._run_encoder(tp, torch.tensor(frames), cfg=tcfg, policy=FP32,
                          fused=fused)
    return frames, jm, tm


@pytest.mark.parametrize("fused", [True, False])
def test_encoder_matches_reference(model, fused):
    _, tcfg, _, _ = model
    _, jm, tm = _memories(model, fused)
    assert tuple(tm.shape) == (2, tcfg.enc_seq_padded, tcfg.d_model)
    np.testing.assert_allclose(_np(tm), _np(jm), **F32)


@pytest.mark.parametrize("fused", [True, False])
def test_dec_block_full_matches_reference(model, fused):
    """One `dec` layer's full pass over a seeded residual stream and the
    encoder's memory, with its caches: k / v at the sequence's length
    (compact, as paged admission takes them) and ck / cv at the memory's
    1504-row analogue (16 rows here)."""
    jcfg, tcfg, jp, tp = model
    _, jm, tm = _memories(model, fused)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    jx, jc, _ = jblocks.block_full(
        "dec", _jlayer(jp["segments"][0], 1), jnp.asarray(x),
        plan=_plan(fused), cfg=jcfg, policy=JFP32, with_cache=True,
        max_seq=MAX_SEQ, memory=jm, memory_len=jcfg.enc_seq_padded,
        compact_kv=True)
    tx, tc = tblocks.block_full("dec", layer(tp["segments"][0], 1),
                                torch.tensor(x), cfg=tcfg, policy=FP32,
                                fused=fused, with_cache=True,
                                max_seq=MAX_SEQ, compact_kv=True, memory=tm)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv"}
    assert tuple(tc["ck"].shape) == (2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    assert tuple(tc["k"].shape) == (2, 11, tcfg.n_kv_heads, tcfg.head_dim)
    for k in tc:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)
    # no cache, the same stream; an encoder layer is the bidirectional
    # `attn` block
    ty, none = tblocks.block_full("dec", layer(tp["segments"][0], 1),
                                  torch.tensor(x), cfg=tcfg, policy=FP32,
                                  fused=fused, memory=tm)
    assert none is None and torch.equal(ty, tx)
    je, _, _ = jblocks.block_full("enc", _jlayer(jp["enc_segments"][0], 0),
                                  jnp.asarray(x), plan=_plan(fused),
                                  cfg=jcfg, policy=JFP32)
    te, _ = tblocks.block_full("enc", layer(tp["enc_segments"][0], 0),
                               torch.tensor(x), cfg=tcfg, policy=FP32,
                               fused=fused)
    np.testing.assert_allclose(_np(te), _np(je), **F32)
    with pytest.raises(ValueError, match="memory"):
        tblocks.block_full("dec", layer(tp["segments"][0], 1),
                           torch.tensor(x), cfg=tcfg, policy=FP32)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_dec_block_decode_matches_reference(model, fused, paged):
    """One `dec` layer's decode step: self-attention over a seeded cache
    (block pools or a dense linear cache), then the cross step over seeded
    ck / cv at memory_len = every row; the self-attention cache gains the
    step's K / V, the cross caches are only read."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    B, KV, hd, We = 2, tcfg.n_kv_heads, tcfg.head_dim, tcfg.enc_seq_padded
    x = rng.standard_normal((B, tcfg.d_model)).astype(np.float32)
    pos = np.array([5, 9], np.int32)
    ck = rng.standard_normal((B, We, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, We, KV, hd)).astype(np.float32)
    if paged:
        NB, BS = 6, 8
        k = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
        v = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
        tables = np.array([[3, 1], [0, 5]], np.int32)
        tk = np.concatenate([k, np.zeros((1, BS, KV, hd), np.float32)])
        tv = np.concatenate([v, np.zeros((1, BS, KV, hd), np.float32)])
        jtab, ttab = jnp.asarray(tables), torch.tensor(tables)
    else:
        k = rng.standard_normal((B, 16, KV, hd)).astype(np.float32)
        v = rng.standard_normal((B, 16, KV, hd)).astype(np.float32)
        tk, tv, jtab, ttab = k, v, None, None
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "ck": jnp.asarray(ck), "cv": jnp.asarray(cv)}
    tcache = {"k": torch.tensor(tk), "v": torch.tensor(tv),
              "ck": torch.tensor(ck), "cv": torch.tensor(cv)}
    jx, jc = jblocks.block_decode(
        "dec", _jlayer(jp["segments"][0], 0), jnp.asarray(x),
        jnp.asarray(pos), jcache, plan=_plan(fused), cfg=jcfg, policy=JFP32,
        memory_len=jcfg.enc_seq_padded, block_tables=jtab, paged=paged)
    tx, tc = tblocks.block_decode(
        "dec", layer(tp["segments"][0], 0), torch.tensor(x),
        torch.tensor(pos), tcache, cfg=tcfg, policy=FP32, block_tables=ttab,
        fused=fused, paged=paged, memory_len=tcfg.enc_seq_padded)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    n = k.shape[0]
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key][:n]), _np(jc[key]), **F32)
    for key, want in (("ck", ck), ("cv", cv)):
        np.testing.assert_array_equal(tc[key].numpy(), want)
    with pytest.raises(ValueError, match="memory_len"):
        tblocks.block_decode("dec", layer(tp["segments"][0], 0),
                             torch.tensor(x), torch.tensor(pos), tcache,
                             cfg=tcfg, policy=FP32, block_tables=ttab,
                             fused=fused, paged=paged, memory_len=We + 1)


def test_enc_and_dec_refuse_steps_they_lack(model):
    _, tcfg, _, tp = model
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="no decode step"):
        tblocks.block_decode("enc", layer(tp["enc_segments"][0], 0), x[:, 0],
                             torch.zeros(1, dtype=torch.int32), {},
                             cfg=tcfg, policy=FP32, block_tables=None)
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        tblocks.block_chunk("dec", layer(tp["segments"][0], 0), x,
                            torch.zeros(1), torch.ones(1), {}, None,
                            cfg=tcfg, policy=FP32)
    with pytest.raises(ValueError, match="unknown block kind"):
        tblocks.block_param_shapes("xyz", tcfg)


# --------------------------------------------------------------------------
# the model: teacher-forced prefill and decode, entry points, encode
# --------------------------------------------------------------------------

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


def _reference_pools(jcfg, jcaches, tables, NB, BS, B, *, int8=False):
    """The reference's paged decode caches after admission: the dec
    segment's pools (int8 with scales when `int8`) and its dense ck / cv
    rows, scattered by its own `make_prefill_scatter`."""
    count, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    shape = (count, NB, BS, KV, hd)
    dt = jnp.int8 if int8 else jnp.float32
    seg = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt),
           "ck": jnp.zeros((count, B, jcfg.enc_seq_padded, KV, hd)),
           "cv": jnp.zeros((count, B, jcfg.enc_seq_padded, KV, hd))}
    if int8:
        seg["ks"] = jnp.zeros((count, NB, KV), jnp.float32)
        seg["vs"] = jnp.zeros((count, NB, KV), jnp.float32)
    return make_prefill_scatter((True,), BS)(
        (seg,), jcaches, jnp.arange(B, dtype=jnp.int32), jnp.asarray(tables))


def _teacher_forced(model, fused, *, paged, n_dec=3, S=13):
    """Every prefill position's logits, then n_dec teacher-forced decode
    steps at positions S + i (the sinusoidal rows at pos), port against
    reference, over the paged layout (block pools; ck / cv in the slots'
    rows) or the dense one (a linear max_seq cache a slot)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    B, BS, NB = 2, 8, 12
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    frames = _frames(tcfg, B, 8)
    batch = {"tokens": jnp.asarray(tokens[:, :S]),
             "frames": jnp.asarray(frames)}
    jm = jlm._run_encoder(jp, batch, plan=_plan(fused), cfg=jcfg,
                          policy=JFP32)
    jx = jlm._embed_sequence(jp, batch, plan=PLAN, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=_plan(fused), cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        memory=jm, memory_len=jcfg.enc_seq_padded, compact_kv=paged)
    tm = tlm._run_encoder(tp, torch.tensor(frames), cfg=tcfg, policy=FP32,
                          fused=fused)
    tx = tlm._embed_sequence(tp, torch.tensor(tokens[:, :S]), cfg=tcfg,
                             policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=MAX_SEQ, fused=fused,
                                            compact_kv=paged, memory=tm)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(_np(_logits(tcfg, tp, tx, fused, False)),
                               _np(_logits(jcfg, jp, jx, fused, True)),
                               **F32)
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(_np(tcaches[0][key]),
                                   _np(jcaches[0][key]), **F32)
    if paged:
        layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB,
                                          block_size=BS)
        tables = np.full((B, layout.max_blocks), -1, np.int32)
        tables[0, :2], tables[1, :2] = [4, 1], [0, 9]
        ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
        jpools = _reference_pools(jcfg, jcaches, tables, NB, BS, B)
    else:
        layout = tsteps.make_dense_layout(tcfg, MAX_SEQ)
        ttab = jtab = tables = None
        jpools = jcaches
    tpools = tsteps.cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                                 device="cpu")
    prefill_scatter(tpools, tcaches, torch.arange(B),
                    None if tables is None else torch.tensor(tables),
                    block_size=layout.block_size,
                    paged_segments=layout.segments)
    for key in ("ck", "cv"):        # the slots' rows, whole
        assert torch.equal(tpools[0][key], tcaches[0][key])
        np.testing.assert_allclose(tpools[0][key].numpy(),
                                   _np(jpools[0][key]), **F32)
    for i in range(n_dec):
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=PLAN, policy=JFP32)
        jxd = jxd + jnp.take(jrope.sinusoidal_positions(jcfg.max_seq,
                                                        jcfg.d_model),
                             jnp.asarray(pos), axis=0)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=_plan(fused), cfg=jcfg,
            policy=JFP32, memory_len=jcfg.enc_seq_padded, block_tables=jtab,
            paged_segments=(paged,))
        txd = tlm._embed_step(tp, torch.tensor(tok), torch.tensor(pos),
                              cfg=tcfg, policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused, paged_segments=layout.segments)
        np.testing.assert_allclose(
            _np(_logits(tcfg, tp, txd[:, None], fused, False)),
            _np(_logits(jcfg, jp, jxd[:, None], fused, True)), **F32)
    n = NB if paged else B
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tpools[0][key][:, :n]),
                                   _np(jpools[0][key]), **F32)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_teacher_forced_matches_reference(model, fused, paged):
    _teacher_forced(model, fused, paged=paged)


def test_entry_points_match_reference(model):
    """`forward_prefill` over a right-padded batch with seeded frames (the
    next token, its position, the compact caches with ck / cv), then
    `forward_decode` steps from it over the paged layout (sinusoidal rows
    at pos, the cross caches in the slots' rows), port against
    reference."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(9)
    B, S, BS = 2, 12, 8
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    plen = np.array([9, 12], np.int32)
    frames = _frames(tcfg, B, 10)
    jtok, jcaches, jpos = jlm.forward_prefill(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
        plan=PLAN, cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        prompt_len=jnp.asarray(plen), compact_kv=True)
    ttok, tcaches, tpos = tlm.forward_prefill(
        tp, torch.tensor(tokens), cfg=tcfg, policy=FP32, max_seq=MAX_SEQ,
        prompt_len=plen, compact_kv=True, frames=torch.tensor(frames))
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tpos.tolist() == np.asarray(jpos).tolist() == plen.tolist()
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(_np(tcaches[0][key]),
                                   _np(jcaches[0][key]), **F32)
    NB = 2 * (MAX_SEQ // BS)
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB,
                                      block_size=BS)
    tables = np.arange(NB, dtype=np.int32).reshape(B, -1)
    tpools = tsteps.cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                                 device="cpu")
    prefill_scatter(tpools, tcaches, torch.arange(B), torch.tensor(tables),
                    block_size=BS)
    jpools = _reference_pools(jcfg, jcaches, tables, NB, BS, B)
    lane = {"temperature": np.array([0.0, 0.9], np.float32),
            "top_k": np.array([0, 8], np.int32),
            "seed": np.array([0, 77], np.int32)}
    for _ in range(3):
        jtok, jpools = jlm.forward_decode(
            jp, jtok, jpos, jpools, plan=PLAN, cfg=jcfg, policy=JFP32,
            lane={k: jnp.asarray(v) for k, v in lane.items()},
            block_tables=jnp.asarray(tables), paged_segments=(True,))
        ttok, tpools = tlm.forward_decode(
            tp, ttok, tpos, tpools, cfg=tcfg, policy=FP32,
            block_tables=torch.tensor(tables), lane=device_lane(lane, "cpu"))
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jpos, tpos = jpos + 1, tpos + 1


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_forward_encode_matches_reference(model, pooling, fused):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, jcfg.vocab, (2, 10), dtype=np.int32)
    plen = np.array([6, 10], np.int32)
    frames = _frames(tcfg, 2, 14)
    want = jlm.forward_encode(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
        plan=_plan(fused), cfg=jcfg, policy=JFP32,
        prompt_len=jnp.asarray(plen), pooling=pooling)
    got = tlm.forward_encode(tp, torch.tensor(tokens), cfg=tcfg,
                             policy=FP32, prompt_len=plen, pooling=pooling,
                             fused=fused, frames=torch.tensor(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_teacher_forced_int8_matches_reference(kv):
    """The reference's own quantized weights (the encoder's projections and
    both attentions' included): the prefill logits at every position, then
    3 teacher-forced decode steps over the paged pools (int8 pools with
    their scales under `kv="int8"`; the cross caches stay fp32 in both),
    each step from the reference's pools, within fp32 1e-4."""
    jcfg, tcfg, jp, tp = _model(5, quantized=True)
    assert tp["segments"][0]["xattn"]["wq"]["q"].dtype == torch.int8
    rng = np.random.default_rng(5)
    B, S, BS, NB, n_dec = 2, 13, 8, 10, 3
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    frames = _frames(tcfg, B, 6)
    batch = {"tokens": jnp.asarray(tokens[:, :S]),
             "frames": jnp.asarray(frames)}
    jm = jlm._run_encoder(jp, batch, plan=PLAN, cfg=jcfg, policy=JFP32)
    jx = jlm._embed_sequence(jp, batch, plan=PLAN, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=PLAN, cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        memory=jm, memory_len=jcfg.enc_seq_padded, compact_kv=True)
    tm = tlm._run_encoder(tp, torch.tensor(frames), cfg=tcfg, policy=FP32)
    np.testing.assert_allclose(_np(tm), _np(jm), **F32)
    tx = tlm._embed_sequence(tp, torch.tensor(tokens[:, :S]), cfg=tcfg,
                             policy=FP32)
    tx, _ = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                      max_seq=MAX_SEQ, compact_kv=True,
                                      memory=tm)
    np.testing.assert_allclose(_np(_logits(tcfg, tp, tx, True, False)),
                               _np(_logits(jcfg, jp, jx, True, True)), **F32)
    int8 = kv == "int8"
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB,
                                      block_size=BS)
    tpools = tsteps.cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                                 device="cpu", kv_dtype=kv)
    assert tpools[0]["ck"].dtype == torch.float32
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    tables[0, :3], tables[1, :3] = [4, 1, 8], [0, 9, 2]
    jpools = _reference_pools(jcfg, jcaches, tables, NB, BS, B, int8=int8)
    prefill_scatter(tpools, tuple({k: torch.tensor(np.asarray(v, np.float32))
                                   for k, v in seg.items()}
                                  for seg in jcaches),
                    torch.arange(B), torch.tensor(tables), block_size=BS)
    keys = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    for key in keys:
        np.testing.assert_array_equal(tpools[0][key][:, :NB].numpy(),
                                      np.asarray(jpools[0][key]))
    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    table = jrope.sinusoidal_positions(jcfg.max_seq, jcfg.d_model)
    for i in range(n_dec):
        for key in keys:
            tpools[0][key][:, :NB] = torch.tensor(np.asarray(jpools[0][key]))
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=PLAN, policy=JFP32)
        jxd = jxd + jnp.take(table, jnp.asarray(pos), axis=0)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=PLAN, cfg=jcfg,
            policy=JFP32, memory_len=jcfg.enc_seq_padded, block_tables=jtab,
            paged_segments=(True,))
        txd = tlm._embed_step(tp, torch.tensor(tok), torch.tensor(pos),
                              cfg=tcfg, policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab)
        np.testing.assert_allclose(_np(txd), _np(jxd), **F32)
        np.testing.assert_allclose(
            _np(_logits(tcfg, tp, txd[:, None], True, False)),
            _np(_logits(jcfg, jp, jxd[:, None], True, True)), **F32)


# --------------------------------------------------------------------------
# frontends and frames
# --------------------------------------------------------------------------

def test_make_batch_matches_reference():
    jcfg, tcfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
    want = jfront.make_batch(jcfg, "prefill", 3, 20, seed=4)
    got = tfront.make_batch(tcfg, 3, 20, seed=4)
    assert set(got) == set(want) == {"tokens", "frames"}
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["frames"].dtype == torch.bfloat16
    assert tuple(got["frames"].shape) == (3, 16, tcfg.d_model)
    np.testing.assert_array_equal(_np(got["frames"]), _np(want["frames"]))
    assert not got["frames"][:, tcfg.enc_seq:].any()
    assert got["frames"][:, :tcfg.enc_seq].abs().sum(-1).all()
    z = tfront.serving_frames(tcfg, 2, device="cpu")
    assert z.shape == (2, 16, tcfg.d_model) and z.dtype == torch.bfloat16
    assert not z.any()
    assert tfront.serving_frames(get_config("gpt-j"), 2, device="cpu") is None
    full = tfront.serving_frames(WHISPER_BASE, 1, device="meta")
    assert tuple(full.shape) == (1, 1504, 512)


def test_missing_or_misshapen_frames_refused(model):
    _, tcfg, _, tp = model
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for frames in (None, torch.zeros((1, 12, tcfg.d_model))):
        with pytest.raises(ValueError, match="frames"):
            tlm.forward_prefill(tp, tokens, cfg=tcfg, policy=FP32,
                                max_seq=MAX_SEQ, frames=frames)
        with pytest.raises(ValueError, match="frames"):
            tlm.forward_encode(tp, tokens, cfg=tcfg, policy=FP32,
                               frames=frames)
    gptj = get_config("gpt-j").reduced()
    with pytest.raises(ValueError, match="without an encoder"):
        tlm.forward_encode(tlm.init_lm(gptj, dtype=torch.float32,
                                       device="cpu"), tokens, cfg=gptj,
                           policy=FP32, frames=torch.zeros((1, 16, 64)))


def test_cross_attention_uses_frames(model):
    """The reference's `test_whisper_cross_attention_uses_frames`, through
    the port: zeroing the frames changes the prefill's logits, and the
    decode step's (through the cross caches)."""
    _, tcfg, _, tp = model
    batch = tfront.make_batch(tcfg, 2, 16, seed=0)
    frames = batch["frames"].float()
    outs = []
    for f in (frames, frames * 0):
        x = tlm._embed_sequence(tp, batch["tokens"], cfg=tcfg, policy=FP32)
        x, caches = tlm._run_segments_prefill(
            tp, x, cfg=tcfg, policy=FP32, max_seq=MAX_SEQ, memory=tlm
            ._run_encoder(tp, f, cfg=tcfg, policy=FP32))
        outs.append((_logits(tcfg, tp, x, True, False), caches))
    assert not torch.allclose(outs[0][0], outs[1][0])
    assert not torch.allclose(outs[0][1][0]["ck"], outs[1][1][0]["ck"])


def test_cache_layout_cross_caches():
    """Every layout gives a dec segment per-slot dense ck / cv at
    enc_seq_padded rows in the activation dtype, int8 KV included (the
    pools alone quantize)."""
    cfg = get_config(NAME)
    paged = tsteps.make_paged_layout(cfg, 512, 128, 16)
    assert paged.segments == (True,)
    for layout, kv in ((paged, None), (paged, "int8"),
                       (tsteps.make_dense_layout(cfg, 512), None)):
        caches = tsteps.cache_layout(cfg, layout, batch_size=4,
                                     policy=FP32,
                                     device="meta", kv_dtype=kv)
        seg = caches[0]
        assert tuple(seg["ck"].shape) == (6, 4, 1504, 8, 64)
        assert seg["ck"].dtype == seg["cv"].dtype == torch.float32
        assert seg["k"].dtype == (torch.int8 if kv else torch.float32)
    # 6 layers x 1504 rows x 8 kv heads x 64 x (k, v) x 2 bytes a slot
    from repro_torch.core.precision import BF16
    caches = tsteps.cache_layout(cfg, paged, batch_size=4, policy=BF16,
                                 device="meta")
    cross = sum(caches[0][k].numel() * 2 for k in ("ck", "cv"))
    assert cross == 4 * 6 * 1504 * 8 * 64 * 2 * 2 == 73_924_608


# --------------------------------------------------------------------------
# the engine, the decode step and the CLI
# --------------------------------------------------------------------------

def _direct_tokens(cfg, params, prompt, n_new, sampling, *, bucket,
                   block_size=8, kv_dtype=None):
    """The engine's path outside the engine: one prefill of the prompt
    right-padded to `bucket` behind zero frames, then a paged decode loop
    (greedy, or the request's sampling lane)."""
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    lane = (None if sampling.is_greedy
            else device_lane(stack_lanes([sampling]), "cpu"))
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(padded), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, prompt_len=np.array([len(prompt)]), lane=lane,
        compact_kv=True, frames=tfront.serving_frames(cfg, 1, device="cpu"))
    layout = tsteps.make_paged_layout(cfg, MAX_SEQ, -(-MAX_SEQ // block_size),
                                      block_size)
    pools = tsteps.cache_layout(cfg, layout, batch_size=1, policy=FP32,
                                device="cpu", kv_dtype=kv_dtype)
    table = torch.arange(layout.max_blocks, dtype=torch.int32)[None]
    prefill_scatter(pools, caches, torch.arange(1), table,
                    block_size=block_size)
    lane = device_lane(stack_lanes([sampling]), "cpu")
    toks = [int(tok[0])]
    for _ in range(n_new - 1):
        tok, pools = tlm.forward_decode(params, tok, pos, pools, cfg=cfg,
                                        policy=FP32, block_tables=table,
                                        lane=lane)
        pos = pos + 1
        toks.append(int(tok[0]))
    return toks


@pytest.mark.parametrize("int8", [False, True])
def test_engine_matches_direct_loop(model, int8):
    """Generate requests (greedy and sampled) through the engine, each
    against the direct loop on the same weights (int8: the engine's
    quantized weights and int8 KV pools, prefilled at the engine's bucket,
    whose pad rows set the last block's scale); no block leaks; the cross
    caches are counted in the KV bytes and stay at the activation
    dtype."""
    _, tcfg, _, tp = model
    kw = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          block_size=8, policy=FP32, device="cpu", **kw)
    r = eng.runner
    rng = np.random.default_rng(3)
    reqs = [Request(uid=u, prompt=rng.integers(0, tcfg.vocab, n,
                                               dtype=np.int32),
                    max_new_tokens=5,
                    sampling=(SamplingParams(temperature=0.9, top_k=8,
                                             seed=40 + u)
                              if u % 2 else SamplingParams()))
            for u, n in enumerate((5, 9, 16, 23))]
    for q in reqs:
        eng.submit(q)
    done = sorted(eng.run(), key=lambda q: q.uid)
    assert [len(q.output) for q in done] == [5] * 4
    params = quantize_params(tp) if int8 else tp
    for q in done:
        assert q.output == _direct_tokens(
            tcfg, params, q.prompt, 5, q.sampling,
            bucket=r.bucket_for(q.prompt_len),
            kv_dtype="int8" if int8 else None), q.uid
    assert eng.allocator.num_free == eng.allocator.num_blocks
    st = eng.stats()
    assert (st.weight_dtype, st.kv_dtype) == (("int8", "int8") if int8
                                              else ("bfloat16", "bfloat16"))
    cross = sum(seg[k].numel() * seg[k].element_size()
                for seg in r.caches for k in ("ck", "cv"))
    assert cross == 2 * 2 * 2 * 16 * 2 * 16 * 4        # fp32 here
    assert r.caches[0]["ck"].dtype == torch.float32
    assert r.kv_pool_bytes() == st.kv_pool_bytes > cross


def test_engine_encodes_match_forward_encode(model):
    """EncodeTasks of both poolings beside generate requests: each
    embedding equals a direct `forward_encode` behind zero frames at the
    runner's bucket."""
    _, tcfg, _, tp = model
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu")
    rng = np.random.default_rng(17)
    encs = [EncodeTask(uid=10 + i, prompt=rng.integers(0, tcfg.vocab, n,
                                                       dtype=np.int32),
                       pooling=pooling)
            for i, (pooling, n) in enumerate((("last", 7), ("mean", 11),
                                              ("last", 20)))]
    eng.submit(Request(uid=0, prompt=rng.integers(0, tcfg.vocab, 9,
                                                  dtype=np.int32),
                       max_new_tokens=3))
    for t in encs:
        eng.submit(t)
    done = eng.run()
    assert len(done) == 4 and eng.stats().encode_batches >= 2
    for t in encs:
        bucket = eng.runner.encode_bucket_for(t.prompt_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :t.prompt_len] = t.prompt
        want = tlm.forward_encode(
            tp, torch.tensor(padded), cfg=tcfg, policy=FP32,
            prompt_len=np.array([t.prompt_len]), pooling=t.pooling,
            frames=tfront.serving_frames(tcfg, 1, device="cpu"))
        np.testing.assert_allclose(np.asarray(t.embedding), _np(want[0]),
                                   **F32)


def test_decode_step_makes_no_tensor_from_host_data(model, monkeypatch):
    """The decode step (the sinusoidal rows at pos, the cross step's
    lengths) makes no tensor from host data: `torch.tensor`, `as_tensor`
    and `from_numpy` raise while it runs (the CPU's proxy for a CUDA graph
    capture); it matches an eager `forward_decode`."""
    _, tcfg, _, tp = model
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, 16, 8)
    caches = tsteps.cache_layout(tcfg, layout, batch_size=2, policy=FP32,
                                 device="cpu")
    rng = np.random.default_rng(2)
    for seg in caches:
        for leaf in seg.values():
            leaf.copy_(torch.tensor(rng.standard_normal(leaf.shape)))
    step = tsteps.make_decode_step(tcfg, tp, caches, policy=FP32,
                                   layout=layout, batch_size=2, device="cpu")
    tables = np.arange(16, dtype=np.int32).reshape(2, 8)
    tokens, pos = np.array([3, 7], np.int32), np.array([10, 33], np.int32)
    lane = {"temperature": np.array([0.0, 0.7], np.float32),
            "top_k": np.array([0, 5], np.int32),
            "seed": np.array([0, 9], np.int32)}
    eager = tuple({k: v.clone() for k, v in seg.items()} for seg in caches)
    want, _ = tlm.forward_decode(tp, torch.tensor(tokens), torch.tensor(pos),
                                 eager, cfg=tcfg, policy=FP32,
                                 block_tables=torch.tensor(tables),
                                 lane=device_lane(lane, "cpu"))

    def refuse(*args, **kwargs):
        raise AssertionError("host data reached a tensor inside the step")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    tok, nxt, _ = step.fn(tokens, pos, tables, lane)
    assert tok.tolist() == want.tolist()
    assert nxt.tolist() == (pos + 1).tolist()
    for seg, seg_e in zip(caches, eager):
        for k in seg:
            assert torch.equal(seg[k], seg_e[k]), k


def test_refusals_in_the_reference_words(model):
    """The prefix cache and chunked prefill need paged resumable state and
    speculation the chunk stack: whisper gets none, with the reference's
    reasons; the engine then serves whole prompts."""
    jcfg, tcfg, _, tp = model
    from repro.launch import steps as jsteps
    from repro.serving import spec as jspec
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu", prefix_cache=True,
                          scheduler=make_policy("chunked", chunk_tokens=8))
    r = eng.runner
    assert eng.prefix_cache is None and r.prefix_cache_reason == CROSS_REASON
    assert not r.supports_chunked and r.chunk_unsupported_reason \
        == CROSS_REASON
    jl = jsteps.make_paged_layout(jcfg, UNSHARDED, MAX_SEQ, 16, 8)
    assert jsteps.chunk_support_reason(jcfg, jl) == CROSS_REASON
    assert spec_support_reason(tcfg) == jspec.spec_support_reason(jcfg) \
        == SPEC_REASON
    with pytest.raises(ValueError, match=SPEC_REASON):
        InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ, policy=FP32,
                        device="cpu", spec=SpecConfig(draft="self", k=2))
    rng = np.random.default_rng(1)
    eng.submit(Request(uid=0, prompt=rng.integers(0, tcfg.vocab, 20,
                                                  dtype=np.int32),
                       max_new_tokens=3))
    done = eng.run()
    assert len(done[0].output) == 3
    st = eng.stats()
    assert st.prefill_chunks == 0 and st.prefill_batches == 1


def test_cli_serves_whisper(capsys):
    assert tserve.main(["--arch", "whisper_base", "--reduced", "--device",
                        "cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "12", "--max-new", "3",
                        "--temperature", "0.7", "--top-k", "8",
                        "--policy", "chunked", "--weight-dtype", "int8",
                        "--kv-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "QUANT" in out
    assert f"cannot chunk prefills ({CROSS_REASON})" in out
    assert (f"prefix cache disabled for {NAME}-reduced — {CROSS_REASON}"
            in out)
    assert tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                        "--requests", "2", "--batch", "2", "--prompt-len",
                        "10", "--task", "encode", "--pooling", "mean"]) == 0
    assert "enc 0:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                     "--spec-draft", "self"])
    assert SPEC_REASON in capsys.readouterr().err
    # whole on an 80 GB card: 0.19 GB of bf16 weights
    assert tserve.fit_reason(WHISPER_BASE, "cpu") is None
