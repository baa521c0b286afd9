"""PyTorch port, serving level: the InferenceEngine on FCFS at the reduced
GPT-J config, fp32 policy, on the CPU.

  * greedy engine tokens == the port's own unpadded prefill + decode loop;
  * every emitted token is within 1e-3 of the reference's max logit at its
    position, teacher-forced (free-running tokens are never compared across
    frameworks: near-tied logits at random init make that no gate);
  * recompute preemption under a 5-block pool leaves outputs unchanged and
    leaks no block;
  * a sampled request draws the same tokens in slot 0 and in slot 1;
  * the engine and `init_lm` refuse to run on the CPU unless asked.
"""
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
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core.precision import FP32
from repro_torch.launch.steps import cache_layout, make_paged_layout
from repro_torch.models import lm as tlm
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import prefill_scatter

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

MAX_SEQ = 64


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("gpt-j").reduced()
    tcfg = get_config("gpt-j").reduced()
    jparams = jlm.init_lm(jax.random.key(0), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tlm.params_from_numpy(tree, tcfg,
                                                      device="cpu")


def _direct_tokens(cfg, params, prompt, n_new, block_size=16):
    """Unpadded prefill + greedy paged decode loop, outside the engine."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True)
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


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


def _engine(cfg, params, **kw):
    kw.setdefault("batch_size", 2)
    return InferenceEngine(cfg, params, max_seq=MAX_SEQ, policy=FP32,
                           device="cpu", **kw)


def test_engine_matches_direct_loop_and_reference_logits(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts(tcfg, (5, 9, 16, 23), seed=3)
    eng = _engine(tcfg, tparams)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(r.output) for r in done] == [6] * 4
    for req in done:
        assert _direct_tokens(tcfg, tparams, req.prompt, 6) == req.output

        # reference, teacher-forced over prompt + emitted tokens
        seq = np.concatenate([req.prompt, req.output[:-1]]).astype(np.int32)
        x = jlm._embed_sequence(jparams, {"tokens": jnp.asarray(seq)[None]},
                                plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                                with_labels=False)[0]
        x, _ = jlm._run_segments_prefill(jparams, x, plan=UNSHARDED,
                                         cfg=jcfg, policy=JFP32,
                                         max_seq=MAX_SEQ, memory=None,
                                         memory_len=0, compact_kv=True)
        n = len(req.prompt)
        z, _ = jemb.logits_local(
            x[0, n - 1:], jparams["embedding"]["unemb"], plan=UNSHARDED,
            cfg=jcfg, policy=JFP32,
            norm=jops.norm_prologue(jparams["final_norm"], jcfg.norm))
        z = np.asarray(z)
        for i, tok in enumerate(req.output):
            assert z[i, tok] >= z[i].max() - 1e-3, (req.uid, i)
    st = eng.stats()
    assert st.nar_tokens == sum(len(p) for p in prompts)
    assert st.ar_tokens == 4 * 5
    assert st.bucket_hits and st.decode_steps > 0
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_preemption_keeps_outputs_and_leaks_nothing(model):
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg, (12, 14, 9), seed=5)
    eng = _engine(tcfg, tparams, block_size=8, kv_pool_blocks=5)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert eng.stats().preemptions > 0
    assert eng.allocator.num_free == eng.allocator.num_blocks
    for req in done:
        assert len(req.output) == 10
        assert _direct_tokens(tcfg, tparams, req.prompt, 10,
                              block_size=8) == req.output


def test_sampled_request_same_tokens_in_either_slot(model):
    _, tcfg, _, tparams = model
    sampled, greedy = _prompts(tcfg, (10, 11), seed=7)
    sp = SamplingParams(temperature=0.8, top_k=40, seed=123)
    outs = []
    for order in ((sampled, greedy), (greedy, sampled)):
        eng = _engine(tcfg, tparams)
        for uid, p in enumerate(order):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=8,
                               sampling=sp if p is sampled else
                               SamplingParams()))
        eng.step()                                  # admits both
        slot_seen = next(b for b, t in enumerate(eng.slots)
                         if t is not None and t.prompt is sampled)
        eng.run()
        req = next(r for r in eng.completed if r.prompt is sampled)
        outs.append((slot_seen, req.output))
    assert [s for s, _ in outs] == [0, 1]
    assert outs[0][1] == outs[1][1]


def test_streaming_events_match_outputs(model):
    _, tcfg, _, tparams = model
    eng = _engine(tcfg, tparams)
    for uid, p in enumerate(_prompts(tcfg, (6, 13, 7), seed=9)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
    events = list(eng.generate())
    by_uid = {}
    for ev in events:
        by_uid.setdefault(ev.uid, []).append(ev)
    for req in eng.completed:
        assert [e.token for e in by_uid[req.uid]] == req.output
        assert [e.is_last for e in by_uid[req.uid]] == [False] * 3 + [True]


def test_block_allocator_refcounts():
    from repro_torch.serving.kv_cache import BlockAllocator
    a = BlockAllocator(4, 8)
    blk = a.alloc(3)
    assert a.num_free == 1 and a.peak_used == 3 and a.alloc(2) is None
    a.retain(blk[:1])
    a.free(blk)
    assert a.refcount(blk[0]) == 1 and a.num_free == 3
    a.free(blk[:1])
    assert a.num_free == 4
    with pytest.raises(RuntimeError, match="double free"):
        a.free(blk[:1])
    with pytest.raises(RuntimeError, match="retain"):
        a.retain(blk[:1])


def test_entry_points_refuse_cpu_unless_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_lm(tcfg)
