"""PyTorch port, the engine's encode mode: `lm.forward_encode` against the
reference's `repro.models.lm.forward_encode`, and EncodeTask serving.

  * forward_encode, pooling `last` and `mean`, at exact length and
    right-padded to a bucket with `prompt_len`, fused and unfused, at the
    reduced GPT-J and GPT3-XL configs (2 layers, d_model 64), fp32 policy,
    the reference's own weights (norms perturbed): rtol = atol = 1e-4;
  * the encode pass builds no cache and runs the prefill stack unchanged;
  * an engine EncodeTask's embedding equals a direct forward_encode of the
    same prompt;
  * interleaved EncodeTasks leave the port's generate tokens unchanged,
    and never take a slot or a KV block;
  * EncodeTask validation: a bad pooling, an over-long prompt.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.precision import FP32 as JFP32
from repro.models import lm as jlm
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core.precision import FP32
from repro_torch.models import lm as tlm
from repro_torch.serving import EncodeTask, InferenceEngine, Request

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gpt-j", "gpt3-xl"]
MAX_SEQ = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    norms = [tree["final_norm"]] + [seg[ln] for seg in tree["segments"]
                                    for ln in ("ln1", "ln2")]
    for nrm in norms:
        nrm["scale"] = (1 + 0.1 * rng.standard_normal(nrm["scale"].shape)
                        ).astype(np.float32)
        nrm["bias"] = (0.1 * rng.standard_normal(nrm["bias"].shape)
                       ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def gptj():
    return _models("gpt-j")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("pooling", ["last", "mean"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_encode_matches_reference(arch, pooling, padded, fused):
    jcfg, tcfg, jp, tp = _models(arch, seed=3)
    rng = np.random.default_rng(4)
    lens = np.array([13, 9, 16], np.int32)
    S = 16 if padded else 13
    tokens = rng.integers(0, jcfg.vocab, (3, S), dtype=np.int32)
    if padded:
        for j, n in enumerate(lens):
            tokens[j, n:] = 0
    else:
        tokens = tokens[:1]
    plen = lens if padded else None
    want = jlm.forward_encode(
        jp, {"tokens": jnp.asarray(tokens)},
        plan=dataclasses.replace(UNSHARDED, fuse_epilogues=fused), cfg=jcfg,
        policy=JFP32, prompt_len=None if plen is None else jnp.asarray(plen),
        pooling=pooling)
    got = tlm.forward_encode(tp, torch.tensor(tokens), cfg=tcfg, policy=FP32,
                             prompt_len=plen, pooling=pooling, fused=fused)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (tokens.shape[0], jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_encode_pass_builds_no_cache(gptj):
    _, tcfg, _, tp = gptj
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, 11), dtype=np.int32))
    x = tlm._embed_sequence(tp, tokens, policy=FP32)
    y, caches = tlm._run_segments_prefill(tp, x, cfg=tcfg, policy=FP32,
                                          max_seq=0, with_cache=False)
    assert caches is None
    y_cached, caches = tlm._run_segments_prefill(tp, x, cfg=tcfg,
                                                 policy=FP32, max_seq=32)
    assert caches[0]["k"].shape[2] == 32
    assert torch.equal(y, y_cached)


def test_forward_encode_refuses_prefix_configs_and_bad_pooling(gptj):
    _, tcfg, _, tp = gptj
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="patch prefix"):
        tlm.forward_encode(tp, tokens, policy=FP32,
                           cfg=dataclasses.replace(tcfg, n_patches=4))
    with pytest.raises(ValueError, match="pooling"):
        tlm.forward_encode(tp, tokens, cfg=tcfg, policy=FP32, pooling="max")


def _engine(cfg, params, **kw):
    return InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                           policy=FP32, device="cpu", **kw)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused", [True, False])
def test_engine_encode_matches_direct_forward_encode(gptj, fused):
    """Three `last` and two `mean` tasks: the two 10- / 12-token `last`
    ones share bucket 12 and one padded batch; every embedding equals a
    direct unpadded forward_encode of its prompt."""
    _, tcfg, _, tp = gptj
    eng = _engine(tcfg, tp, fuse_epilogues=fused)
    lengths = (10, 30, 12, 7, 20)
    poolings = ("last", "mean", "last", "last", "mean")
    tasks = [EncodeTask(uid=i, prompt=p, pooling=pool) for i, (p, pool) in
             enumerate(zip(_prompts(tcfg, lengths, 6), poolings))]
    for t in tasks:
        eng.submit(t)
    done = eng.run()
    assert sorted(t.uid for t in done) == list(range(5))
    st = eng.stats()
    assert st.encode_batches == 4            # {10, 12} share bucket 12
    assert st.encode_tokens == sum(lengths)
    assert st.padded_encode_tokens == 12 + 12 + 32 + 8 + 24
    assert st.encode_completed == 5 and st.encode_tok_s > 0
    d = st.to_dict()
    assert d["encode_batches"] == 4 and "encode_latency_p50_ms" in d
    assert "ENC" in st.summary()
    for t in tasks:
        assert t.done and t.embedding.shape == (tcfg.d_model,)
        assert t.bucket == eng.runner.encode_bucket_for(t.prompt_len)
        want = tlm.forward_encode(tp, torch.tensor(t.prompt[None]), cfg=tcfg,
                                  policy=FP32, pooling=t.pooling,
                                  fused=fused)
        np.testing.assert_allclose(t.embedding, _np(want[0]), **F32)


def test_interleaved_encodes_leave_generate_tokens_unchanged(gptj):
    _, tcfg, _, tp = gptj
    lengths = (9, 21, 14, 30)
    prompts = _prompts(tcfg, lengths, 7)

    def serve(with_encode):
        eng = _engine(tcfg, tp)
        enc = _prompts(tcfg, (11, 40, 5), 8)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
            if with_encode and uid < 3:
                eng.submit(EncodeTask(uid=100 + uid, prompt=enc[uid],
                                      pooling=("last", "mean")[uid % 2]))
        seen = []
        while eng.has_work():
            eng.step()
            used = eng.allocator.num_blocks - eng.allocator.num_free
            held = sum(len(b) for b in eng.runner._slot_blocks)
            seen.append(used == held)
            assert not any(isinstance(t, EncodeTask) for t in eng.slots)
        assert all(seen)
        assert eng.allocator.num_free == eng.allocator.num_blocks
        out = {t.uid: list(t.output) for t in eng.completed
               if not isinstance(t, EncodeTask)}
        return out, eng.stats()

    plain, st0 = serve(False)
    mixed, st1 = serve(True)
    assert mixed == plain
    assert st0.encode_batches == 0 and st1.encode_batches == 3
    assert st1.prefill_batches == st0.prefill_batches
    assert st1.requests_completed == st0.requests_completed + 3


def test_encode_task_validation(gptj):
    _, tcfg, _, tp = gptj
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="pooling"):
        EncodeTask(uid=0, prompt=prompt, pooling="max")
    with pytest.raises(TypeError, match="prompt"):
        EncodeTask(uid=0)
    eng = _engine(tcfg, tp)
    # an encode pass reserves no decode position: max_seq tokens fit
    eng.submit(EncodeTask(uid=1, prompt=np.zeros(MAX_SEQ, np.int32)))
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(EncodeTask(uid=2, prompt=np.zeros(MAX_SEQ + 1, np.int32)))
    task = EncodeTask(uid=3, prompt=prompt)
    task.pooling = "max"           # submit validates again
    with pytest.raises(ValueError, match="pooling"):
        eng.submit(task)
    done = eng.run()
    assert [t.uid for t in done] == [1]
    assert done[0].embedding.shape == (tcfg.d_model,)


def test_encode_bucket_rule():
    """A causal schedule pads encode batches to the prefill rungs; a
    bidirectional one encodes at exact length."""
    from repro_torch.serving.runner import ModelRunner
    cfg = get_config("gpt-j").reduced()
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu")
    runner = ModelRunner(cfg, params, max_seq=MAX_SEQ, device="cpu")
    assert [runner.encode_bucket_for(n) for n in (3, 9, 13, 40)] == [
        8, 12, 16, 48]
    bidir = dataclasses.replace(cfg, causal=False)
    runner = ModelRunner(bidir, params, max_seq=MAX_SEQ, device="cpu")
    assert [runner.encode_bucket_for(n) for n in (3, 13)] == [3, 13]
