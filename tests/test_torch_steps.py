"""PyTorch port, step layer (`repro_torch.launch.steps`) on the CPU, at
reduced widths: GPT-J (paged pools), hymba-1.5b (parallel attention + SSM
heads, ring caches on its local layers) and gemma3-27b (5:1 windowed /
global, ring caches).

  * the decode step callable (static buffers, one host-to-device copy) and
    the eager `lm.forward_decode` give bit-equal tokens and caches over 6
    steps, greedy and sampled rows;
  * one step of the port's decode step against the reference's
    `make_decode_step(..., paged=(nb, bs), with_sampling=True)` (JAX, CPU,
    no mesh) from the same converted weights and caches: every pool within
    fp32 1e-4, pos + 1 equal, greedy tokens equal where the top-2 logit
    margin exceeds 1e-4;
  * the step makes no tensor from host data: `torch.tensor`,
    `torch.as_tensor` and `torch.from_numpy` raise while it runs (the CPU's
    proxy for a CUDA graph capture);
  * the one paged route splits the table from its shapes alone and equals
    the one-split fold at every length 1..max_seq;
  * on the CPU the step runs eagerly: no CUDA call is made.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig
from repro.core.precision import FP32 as JFP32
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.sampling import device_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gpt-j", "hymba-1.5b", "gemma3-27b"]
B, BS, MAX_SEQ = 4, 4, 32
CPU = torch.device("cpu")


def _setup(arch, seed=0, params=None):
    """Seeded fp32 weights, a layout with a full table per slot, caches
    filled with seeded noise, slot positions, tokens and a lane with two
    greedy and two sampled rows."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    if params is None:
        params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu",
                             seed=seed)
    layout = tsteps.make_paged_layout(cfg, MAX_SEQ, B * (MAX_SEQ // BS), BS)
    caches = tsteps.cache_layout(cfg, layout, batch_size=B, policy=FP32,
                                 device="cpu")
    for seg in caches:
        for leaf in seg.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    tables = rng.permutation(layout.num_blocks).reshape(
        B, layout.max_blocks).astype(np.int32)
    pos = rng.integers(3, MAX_SEQ - 8, B).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, B).astype(np.int32)
    lane = {"temperature": np.array([0.0, 0.8, 1.2, 0.0], np.float32),
            "top_k": np.array([0, 40, 0, 5], np.int32),
            "seed": np.array([3, 101, 2**31 - 7, 9], np.int64)}
    return cfg, params, layout, caches, tables, pos, tokens, lane


def _clone(caches):
    return tuple({k: v.clone() for k, v in seg.items()} for seg in caches)


def _step(cfg, params, layout, caches):
    return tsteps.make_decode_step(cfg, params, caches, policy=FP32,
                                   layout=layout, batch_size=B, device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_bit_equal_to_eager_decode(arch):
    cfg, params, layout, caches, tables, pos, tokens, lane = _setup(arch)
    eager = _clone(caches)
    step = _step(cfg, params, layout, caches)
    assert not step.aux["captured"]
    tok_e, pos_e = torch.tensor(tokens), torch.tensor(pos)
    tok_s, pos_s = tokens.copy(), pos.copy()
    for _ in range(6):
        got, got_pos, _ = step.fn(tok_s, pos_s, tables, lane)
        want, _ = tlm.forward_decode(
            params, tok_e, pos_e, eager, cfg=cfg, policy=FP32,
            block_tables=torch.tensor(tables), lane=device_lane(lane, "cpu"),
            paged_segments=layout.segments)
        assert torch.equal(got, want.to(torch.int32))
        assert torch.equal(got_pos, pos_e + 1)
        for seg_s, seg_e in zip(caches, eager):
            for k in seg_s:
                assert torch.equal(seg_s[k], seg_e[k]), k
        tok_s, pos_s = got.numpy().copy(), pos_s + 1
        tok_e, pos_e = want, pos_e + 1


def test_decode_step_matches_reference_step():
    """One step of the port's decode step and of the reference's jitted
    paged decode step, greedy, from the same weights and caches."""
    jcfg = jax_config("gpt-j").reduced()
    jparams = jlm.init_lm(jax.random.key(0), jcfg, jnp.float32)
    tcfg = get_config("gpt-j").reduced()
    tparams = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    _, _, layout, caches, tables, pos, tokens, lane = _setup(
        "gpt-j", seed=1, params=tparams)
    lane = dict(lane, temperature=np.zeros(B, np.float32))
    NB = layout.num_blocks
    bundle = jsteps.make_decode_step(
        jcfg, ShapeConfig("steps_test", "decode", MAX_SEQ, B), None,
        policy=JFP32, max_seq=MAX_SEQ, kv_cache_dtype="float32",
        with_sampling=True, paged=(NB, BS))
    assert bundle.aux["paged"].num_blocks == NB
    jcaches = tuple({k: jnp.asarray(v[:, :NB].numpy()) for k, v in
                     seg.items()} for seg in caches)
    jlane = {"temperature": jnp.asarray(lane["temperature"]),
             "top_k": jnp.asarray(lane["top_k"]),
             "seed": jnp.asarray(lane["seed"].astype(np.int32))}
    jtok, jpos, jcaches = bundle.fn(jparams, jnp.asarray(tokens),
                                    jnp.asarray(pos), jcaches,
                                    jnp.asarray(tables), jlane)

    # the port's logits at this step, for the margin rule
    probe = _clone(caches)
    x = temb.embed_token(tparams["embedding"]["embed"], torch.tensor(tokens),
                         policy=FP32)
    x, _ = tlm._run_segments_decode(tparams, x, torch.tensor(pos), probe,
                                    cfg=tcfg, policy=FP32,
                                    block_tables=torch.tensor(tables))
    z = temb.logits_local(x, tparams["embedding"]["unemb"], cfg=tcfg,
                          policy=FP32, norm=tlm._head_norm(tparams, tcfg,
                                                           True))
    top2 = torch.topk(z, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()

    step = _step(tcfg, tparams, layout, caches)
    tok, pos1, _ = step.fn(tokens, pos, tables, lane)
    np.testing.assert_array_equal(pos1.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos1.numpy(), pos + 1)
    for seg_t, seg_j in zip(caches, jcaches):
        for k in seg_j:
            np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                       np.asarray(seg_j[k]), **F32)
    clear = margin > 1e-4
    skipped = int((~clear).sum())
    assert skipped <= 1, f"{skipped} of {B} rows within 1e-4 of a tie"
    np.testing.assert_array_equal(tok.numpy()[clear],
                                  np.asarray(jtok)[clear])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_makes_no_tensor_from_host_data(arch, monkeypatch):
    cfg, params, layout, caches, tables, pos, tokens, lane = _setup(arch, 2)
    step = _step(cfg, params, layout, caches)

    def refuse(*args, **kwargs):
        raise AssertionError("host data reached a tensor inside the step")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for _ in range(2):
        tok, pos, _ = step.fn(tokens, pos.copy(), tables, lane)
        tokens, pos = tok.numpy().copy(), pos.numpy().copy()
    assert (pos == step.fn.pos.numpy() + 1).all()


def test_paged_route_splits_from_shapes_alone():
    """Slot b holds b + 1 positions (every length 1..max_seq in one
    batch); the route's split count comes from (B, KV, MB, BS) and its
    merged output equals the one-split fold within 1e-5."""
    rng = np.random.default_rng(4)
    H, KV, D, bs, max_seq = 4, 2, 16, 4, 64
    MB, nb = max_seq // bs, 64 * (max_seq // bs)
    q = torch.tensor(rng.standard_normal((max_seq, H, D)), dtype=torch.float32)
    kp, vp = (torch.tensor(rng.standard_normal((nb, bs, KV, D)),
                           dtype=torch.float32) for _ in range(2))
    tab = torch.tensor(rng.permutation(nb)[:max_seq * MB].reshape(
        max_seq, MB).astype(np.int32))
    lengths = torch.arange(1, max_seq + 1, dtype=torch.int32)
    S = tfd.paged_splits(max_seq, KV, MB,
                         at_least=tfd.paged_min_splits(MB, bs))
    assert S > 1
    got = tfd.paged_decode_attention(q, kp, vp, tab, lengths)
    o, m, l = tfd.paged_decode_plain(q, kp, vp, tab, lengths, S)
    assert torch.equal(got, tfd.paged_decode_merge_plain(
        o, m, l, out_dtype=torch.float32))
    one_o, _, one_l = tfd.paged_decode_plain(q, kp, vp, tab, lengths)
    np.testing.assert_allclose(got.numpy(), (one_o / one_l[..., None]).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the split count reads no length: the same at any live lengths
    assert tfd.paged_min_splits(MB, bs) == 1
    assert tfd.paged_min_splits(128, 16) == 4             # gemma3, 2048
    assert tfd.paged_min_splits(2048, 16) == 64           # 32k positions


def test_cpu_engine_runs_the_step_eagerly(monkeypatch):
    """The CPU engine builds its decode step once and never touches CUDA:
    no graph, no stream, no capture."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call on the CPU path")
    for name in ("CUDAGraph", "graph", "Stream", "synchronize",
                 "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    cfg = get_config("hymba-1.5b").reduced()
    cfg = dataclasses.replace(cfg, vocab=250)
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=5)
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          block_size=BS, policy=FP32, device="cpu")
    step = eng.runner.decode_step
    rng = np.random.default_rng(5)
    for uid in range(3):
        sp = SamplingParams(temperature=0.9, seed=uid) if uid else None
        eng.submit(Request(uid=uid, prompt=rng.integers(0, 250, 6 + uid),
                           max_new_tokens=4,
                           sampling=sp or SamplingParams()))
    done = eng.run()
    assert len(done) == 3 and all(len(t.output) == 4 for t in done)
    assert eng.runner.decode_step is step and step.fn.graph is None
    assert not step.aux["captured"] and step.fn.replays == 0
    assert eng.stats().prefill_compiles >= 1
