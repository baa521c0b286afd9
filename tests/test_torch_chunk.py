"""PyTorch port, the chunk stack on the CPU against the JAX reference, at
reduced widths:

  * `ref.paged_chunk_partials_ref` against the reference's oracle (fp32
    and bf16 pools, int8 pools with their scales, a lower-triangular
    `tree_mask`, which must equal the causal mask), and `ops`'s routing
    and call count;
  * `_scatter_quantized` bit-equal to the reference's (jitted, as it runs
    there), fresh and already started blocks in one write;
  * `attn_chunk_paged` against the reference's on the same pools: y and
    the pools after the scatter within fp32 1e-4, the port's pools written
    in place, pad tokens to the sink;
  * `forward_chunk` / `_run_chunk_stack` against the reference's for
    GPT-J- and phi4-shaped reduced configs, fused and unfused: three
    chunks of a 40-token prompt, hidden rows and pools after each chunk
    within fp32 1e-4, the sampled tokens equal, and the last chunk's token
    equal to the port's whole-prompt `forward_prefill`;
  * `chunk_support_reason` for every port config, full size and reduced,
    word for word the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as jattn
from repro.core.precision import FP32 as JFP32
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import attention as tattn
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _partials_inputs(rng, dtype, *, B=2, C=6, H=4, KV=2, D=16, NB=12,
                     BS=4, MB=5):
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    if dtype == "int8":
        kp, vp = (rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.05, (NB, KV)).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    tab = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    tab[1, 4] = -1                                # an absent entry
    pos0 = np.array([3, 9], np.int32)
    q_pos = pos0[:, None] + np.arange(C, dtype=np.int32)[None, :]
    lengths = pos0 + np.array([C, C - 2], np.int32)   # row 1: 2 pad queries
    return q, kp, vp, tab, q_pos, lengths, ks, vs


@pytest.mark.parametrize("case", ["fp32", "bf16", "int8", "tree"])
def test_chunk_partials_oracle(case):
    rng = np.random.default_rng(0)
    q, kp, vp, tab, q_pos, lengths, ks, vs = _partials_inputs(
        rng, "int8" if case == "int8" else "fp32")
    C = q.shape[1]
    jdt = jnp.bfloat16 if case == "bf16" else None
    tdt = torch.bfloat16 if case == "bf16" else None
    tree = np.broadcast_to(np.tril(np.ones((C, C), bool)),
                           (q.shape[0], C, C)).copy()

    def jin(x):
        a = jnp.asarray(x)
        return a.astype(jdt) if jdt is not None and x.dtype == np.float32 \
            else a

    def tin(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(tdt) if tdt is not None and x.dtype == np.float32 else t

    kw_j = dict(k_scale=None if ks is None else jnp.asarray(ks),
                v_scale=None if vs is None else jnp.asarray(vs))
    kw_t = dict(k_scale=None if ks is None else torch.from_numpy(ks),
                v_scale=None if vs is None else torch.from_numpy(vs))
    if case == "tree":
        kw_j["tree_mask"] = jnp.asarray(tree)
        kw_t["tree_mask"] = torch.from_numpy(tree)
    args = (q, kp, vp, tab, q_pos, lengths)
    want = jref.paged_chunk_partials_ref(*map(jin, args), **kw_j)
    got = tref.paged_chunk_partials_ref(*map(tin, args), **kw_t)
    tol = BF16 if case == "bf16" else F32
    real = q_pos < lengths[:, None]               # pad queries are garbage
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g)[real], _np(w)[real], **tol)
    if case == "tree":
        causal = tref.paged_chunk_partials_ref(*map(tin, args),
                                               k_scale=None, v_scale=None)
        for a, b in zip(got, causal):
            assert torch.equal(a, b)


def test_chunk_partials_counted_and_routed():
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(x) for x in _partials_inputs(rng, "fp32")[:6]]
    n = ops.paged_chunk_partials.launches
    assert ops.launch_counters()["paged_chunk_partials"] \
        is ops.paged_chunk_partials
    auto = ops.paged_chunk_partials(*args)
    assert ops.paged_chunk_partials.launches == n + 1
    with ops.kernel_mode("ref"):
        ref = ops.paged_chunk_partials(*args)
    assert ops.paged_chunk_partials.launches == n + 1
    for a, b in zip(auto, ref):
        assert torch.equal(a, b)


def test_scatter_quantized_bit_equal():
    """Blocks 5 and 2 start inside the write (fresh: a scale is the amax
    of what lands in the block, the stale one reset); block 1 was started
    before (its scale kept, the chunk's tokens clipped against it); pad
    tokens go to the sink (the reference drops them)."""
    rng = np.random.default_rng(2)
    NB, BS, KV, D = 8, 4, 2, 8
    pool = rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
    scales = rng.uniform(0.001, 0.02, (NB, KV)).astype(np.float32)
    # positions 6..13 of one row: block 1 holds 4..7 (started at 4),
    # block 5 holds 8..11, block 2 holds 12..15; the last token is pad
    pos0, C = 6, 8
    table = np.array([0, 1, 5, 2, 7], np.int32)
    pos = pos0 + np.arange(C)
    x = (rng.standard_normal((C, KV, D)) * 3).astype(np.float32)
    real = np.arange(C) < C - 1
    gb = table[pos // BS]
    off = pos % BS
    fresh = (pos - off) >= pos0
    loc_j = np.where(real, gb, NB)
    jq, js = jax.jit(jattn._scatter_quantized)(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(x[None]),
        jnp.asarray(loc_j[None]), jnp.asarray(off[None]),
        jnp.asarray(fresh[None]))
    tpool = torch.from_numpy(np.concatenate([pool, pool[:1] * 0]))
    tsc = torch.from_numpy(np.concatenate([scales, scales[:1] * 0]))
    ptr = (tpool.data_ptr(), tsc.data_ptr())
    tattn._scatter_quantized(tpool, tsc, torch.from_numpy(x),
                             torch.from_numpy(np.where(real, gb, NB)),
                             torch.from_numpy(off), torch.from_numpy(fresh))
    assert (tpool.data_ptr(), tsc.data_ptr()) == ptr
    np.testing.assert_array_equal(tpool[:NB].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc[:NB].numpy(), np.asarray(js))
    assert not np.array_equal(np.asarray(js)[5], scales[5])   # reset
    np.testing.assert_array_equal(np.asarray(js)[1], scales[1])  # kept


def _attn_case(kv_dtype, seed):
    cfg = get_config("gpt-j").reduced()
    jcfg = jax_config("gpt-j").reduced()
    rng = np.random.default_rng(seed)
    E, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
         for n, s in tattn.attention_param_shapes(cfg).items()}
    B, C, NB, BS, MB = 2, 8, 10, 4, 6
    x = rng.standard_normal((B, C, E)).astype(np.float32)
    pos0 = np.array([4, 0], np.int32)
    clen = np.array([8, 5], np.int32)
    tab = np.full((B, MB), -1, np.int32)
    tab[0, :3] = [6, 1, 3]
    tab[1, :2] = [8, 0]
    if kv_dtype == "int8":
        kp, vp = (rng.integers(-127, 128, (NB, BS, KV, hd)).astype(np.int8)
                  for _ in range(2))
        cache = {"k": kp, "v": vp,
                 "ks": rng.uniform(0.01, 0.05, (NB, KV)).astype(np.float32),
                 "vs": rng.uniform(0.01, 0.05, (NB, KV)).astype(np.float32)}
    else:
        cache = {k: rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
                 for k in ("k", "v")}
    return cfg, jcfg, p, x, pos0, clen, tab, cache, NB


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_attn_chunk_paged_matches_reference(kv_dtype):
    cfg, jcfg, p, x, pos0, clen, tab, cache, NB = _attn_case(kv_dtype, 3)

    def run_ref(p, x, pos0, clen, cache, tab):
        return jattn.attn_chunk_paged(p, x, pos0, clen, cache, tab,
                                      plan=UNSHARDED, cfg=jcfg,
                                      policy=JFP32, residual=x)
    jy, jcache = jax.jit(run_ref)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos0), jnp.asarray(clen),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(tab))
    tcache = {k: torch.from_numpy(np.concatenate([v, v[:1] * 0]))
              for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    tx = torch.from_numpy(x)
    y, out = tattn.attn_chunk_paged(
        {k: torch.from_numpy(v) for k, v in p.items()}, tx,
        torch.from_numpy(pos0), torch.from_numpy(clen), tcache,
        torch.from_numpy(tab), cfg=cfg, policy=FP32, residual=tx)
    assert out is tcache and {k: v.data_ptr() for k, v in out.items()} \
        == ptrs
    real = np.arange(x.shape[1])[None, :] < clen[:, None]
    np.testing.assert_allclose(y.numpy()[real], np.asarray(jy)[real], **F32)
    for k, v in jcache.items():
        got = tcache[k][:NB].numpy()
        if k in ("ks", "vs"):
            np.testing.assert_allclose(got, np.asarray(v), rtol=1e-6)
        elif kv_dtype == "int8":
            # one int8 step where a projection's last-ulp difference
            # crosses a rounding boundary, and nowhere else
            d = np.abs(got.astype(np.int32) - np.asarray(v, np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(got, np.asarray(v), **F32)
    # untouched blocks untouched (the pad tokens went to the sink)
    written = {6, 1, 3, 8, 0}
    for k in ("k", "v"):
        for b in set(range(NB)) - written:
            np.testing.assert_array_equal(tcache[k][b].numpy(), cache[k][b])


ARCHS = ["gpt-j", "phi4-mini-3.8b"]
MAX_SEQ, BS, C, PROMPT = 64, 8, 16, 40


def _plan(fused):
    return UNSHARDED if fused else dataclasses.replace(UNSHARDED,
                                                       fuse_epilogues=False)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_chunk_matches_reference(arch, fused):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = jlm.init_lm(jax.random.key(0), jcfg, jnp.float32)
    tparams = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tcfg.vocab, PROMPT, dtype=np.int32)
    NB = 12
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, NB, BS)
    caches = tsteps.cache_layout(tcfg, layout, batch_size=1, policy=FP32,
                                 device="cpu")
    ptrs = [{k: v.data_ptr() for k, v in seg.items()} for seg in caches]
    jcaches = tuple({k: jnp.asarray(v[:, :NB].numpy())
                     for k, v in seg.items()} for seg in caches)
    table = np.full((1, layout.max_blocks), -1, np.int32)
    table[0, :5] = rng.permutation(NB)[:5]
    plan = _plan(fused)
    for start in range(0, PROMPT, C):
        take = min(C, PROMPT - start)
        tok = np.zeros((1, C), np.int32)
        tok[0, :take] = prompt[start:start + take]
        targs = (torch.from_numpy(tok), torch.tensor([start]),
                 torch.tensor([take]))
        jargs = (jnp.asarray(tok), jnp.asarray([start], jnp.int32),
                 jnp.asarray([take], jnp.int32))
        jx, jcaches, _ = jlm._run_chunk_stack(
            jparams, *jargs, jcaches, jnp.asarray(table), plan=plan,
            cfg=jcfg, policy=JFP32, paged_segments=None)
        jtok, _, jpos = jlm.forward_chunk(
            jparams, *jargs, jcaches, jnp.asarray(table), plan=plan,
            cfg=jcfg, policy=JFP32)
        tx, _, _ = tlm._run_chunk_stack(
            tparams, *targs, caches, torch.from_numpy(table), cfg=tcfg,
            policy=FP32, fused=fused)
        ttok, out, tpos = tlm.forward_chunk(
            tparams, *targs, caches, torch.from_numpy(table), cfg=tcfg,
            policy=FP32, fused=fused)
        assert out is caches
        np.testing.assert_allclose(tx.numpy()[0, :take],
                                   np.asarray(jx)[0, :take], **F32)
        for seg_t, seg_j in zip(caches, jcaches):
            for k in seg_j:
                np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                           np.asarray(seg_j[k]), **F32)
        assert int(tpos[0]) == int(jpos[0]) == start + take
        assert int(ttok[0]) == int(jtok[0])
    assert [{k: v.data_ptr() for k, v in seg.items()} for seg in caches] \
        == ptrs
    # the last chunk's token is the whole-prompt prefill's
    want, _, _ = tlm.forward_prefill(tparams, torch.from_numpy(prompt[None]),
                                     cfg=tcfg, policy=FP32, max_seq=MAX_SEQ,
                                     compact_kv=True, fused=fused)
    assert int(ttok[0]) == int(want[0])


def _reason_cases():
    for name in sorted(REGISTRY):
        if REGISTRY[name].schedule[0][0] == "vit":
            continue
        for reduced in (False, True):
            for max_seq in ((64,) if reduced else (512, 2048)):
                yield name, reduced, max_seq


@pytest.mark.parametrize("name,reduced,max_seq", list(_reason_cases()))
def test_chunk_support_reason_matches_reference(name, reduced, max_seq):
    tcfg, jcfg = get_config(name), jax_config(name)
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    tl = tsteps.make_paged_layout(tcfg, max_seq, 64, 16)
    jl = jsteps.make_paged_layout(jcfg, UNSHARDED, max_seq, 64, 16)
    want = jsteps.chunk_support_reason(jcfg, jl)
    assert tsteps.chunk_support_reason(tcfg, tl) == want
    assert tsteps.chunk_support_reason(tcfg, None) \
        == jsteps.chunk_support_reason(jcfg, None)
    if name in ("gpt-j", "gpt3-xl", "phi4-mini-3.8b"):
        assert want is None
    elif name in ("hymba-1.5b", "mamba2-2.7b") or (
            name == "gemma3-27b" and max_seq > 1024):
        assert want is not None
