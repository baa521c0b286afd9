"""PyTorch port, training: the optimizer and schedules, the data pipeline,
the kernels' autograd Functions, `ce_loss`, `forward_train`,
`make_train_step` and `vit_loss` against the reference.

Reduced GPT3-XL (2 layers, d_model 64, 4 query heads over 2 kv heads: GQA),
reduced GPT-J and reduced ViT-B; inputs and states made from numpy seeds
and carried across as numpy arrays.  Tolerances (the ground rules of
ROADMAP.md): fp32 1e-4, bf16 2e-2, each as the largest deviation over the
largest reference magnitude of the tensor compared.  Under bf16, where
the reference's own bf16 result lies further from its fp32 result than
2e-2 (its bf16 floor: the MLP's w1 gradient, 3.3e-2 at these sizes, and
at most 3.7e-2 over the leaves gated here; the params after three AdamW
steps, whose update is lr * sign(g) wherever |g| is small, 3.1e-2), the
gate is twice that floor; each failure names the leaf's gap, gate and
floor.  The Functions' explicit backward is held to torch's autograd
through the kernels' plain versions in fp32 (sum order only: 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import embedding as jemb
from repro.core.precision import BF16 as JBF16, FP32 as JFP32
from repro.data import FileStream as JFileStream
from repro.data import SyntheticStream as JSyntheticStream
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import vit as jvit
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import embedding as temb
from repro_torch.core.precision import BF16, FP32
from repro_torch.data import FileStream, SyntheticStream, make_stream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as tnorm
from repro_torch.kernels.epilogue import Epilogue, Prologue
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import vit as tvit
from repro_torch.models.params import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, global_grad_norm,
                               linear_schedule)

torch.set_num_threads(2)

TOL = {"fp32": 1e-4, "bf16": 2e-2}
POLICIES = {"fp32": (FP32, JFP32), "bf16": (BF16, JBF16)}
FN_TOL = 1e-5            # explicit backward vs autograd through plain, fp32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _gap(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, tol, what=""):
    g = _gap(got, want)
    assert g <= tol, f"{what}: {g:.3e} > {tol:.2e}"


def _bf16_close(got, want, want32, what):
    """The bf16 gate (module note): the max-scaled gap within max(2e-2,
    2 x the reference's bf16 floor, its gap to its own fp32 result)."""
    floor = _gap(want, want32)
    _close(got, want, max(TOL["bf16"], 2 * floor),
           f"{what} (bf16 floor {floor:.2e})")


def _made_by(y, name):
    """True when `y` comes out of the autograd Function `name` (through
    views)."""
    fn = y.grad_fn
    while fn is not None and "View" in type(fn).__name__:
        fn = fn.next_functions[0][0]
    return fn is not None and name in type(fn).__name__


def _trees_close(got, want, tol, what):
    gl, wl = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, tol, f"{what} leaf {i}")


# --------------------------------------------------------------------------
# optimizer and schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedules_match_reference(kind):
    args = (3e-4, 7, 40)
    jfn = getattr(jschedule, f"{kind}_schedule")(*args)
    tfn = (linear_schedule if kind == "linear" else cosine_schedule)(*args)
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = float(tfn(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
        assert float(tfn(step)) == got


def _rand_tree(rng, scale=1.0):
    return {"b": (rng.standard_normal((3, 5)) * scale).astype(np.float32),
            "a": {"w": (rng.standard_normal((4, 6)) * scale
                        ).astype(np.float32),
                  "z": (rng.standard_normal((7,)) * scale
                        ).astype(np.float32)}}


def _to_torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_grad_norm_and_clip_match_reference():
    rng = np.random.default_rng(0)
    g = _rand_tree(rng, 3.0)
    axes = [()] * 3
    want_n = float(jadamw.global_grad_norm(jax.tree.map(jnp.asarray, g),
                                           axes))
    assert float(global_grad_norm(_to_torch(g), axes)) == pytest.approx(
        want_n, rel=1e-6)
    for max_norm in (1.0, 1e3):
        jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            axes, max_norm)
        tc, tn = clip_by_global_norm(_to_torch(g), axes, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        _trees_close(tc, jc, 1e-6, f"clip {max_norm}")


def test_adamw_matches_reference():
    rng = np.random.default_rng(1)
    p = _rand_tree(rng)
    jp = jax.tree.map(jnp.asarray, p)
    jo = jadamw.adamw_init(jp)
    tp = _to_torch(p)
    to = adamw_init(tp)
    for step in range(4):
        g = _rand_tree(rng, 0.1)
        jp, jo = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), jo,
                                     step=jnp.asarray(step, jnp.int32),
                                     lr=jnp.asarray(1e-2, jnp.float32))
        tp, to = adamw_update(tp, _to_torch(g), to,
                              step=torch.tensor(step, dtype=torch.int32),
                              lr=1e-2)
    _trees_close(tp, jp, 1e-6, "params")
    _trees_close(to["m"], jo["m"], 1e-6, "m")
    _trees_close(to["v"], jo["v"], 1e-6, "v")


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([10.0, -10.0])}
    opt = adamw_init(params)
    for i in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt = adamw_update(params, grads, opt, step=i, lr=0.1,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1.0


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt3-xl", "internvl2-76b",
                                  "whisper-base"])
def test_synthetic_stream_bit_equal(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    seq = 24 + (tcfg.n_patches or 0)
    js = JSyntheticStream(jcfg, global_batch=4, seq_len=seq, seed=3,
                          host_id=1, n_hosts=2)
    ts = SyntheticStream(tcfg, global_batch=4, seq_len=seq, seed=3,
                         host_id=1, n_hosts=2, device="cpu")
    for step in (0, 5):
        jb, tb = js.batch(step), ts.batch(step)
        assert set(jb) == set(tb)
        for k in jb:
            want = np.asarray(jb[k])
            got = tb[k]
            if k in ("tokens", "labels"):
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    want.view(np.int16))


def test_file_stream_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60_000, 5_000).astype(
        np.uint16).tofile(path)
    jcfg, tcfg = jax_config("gpt-j").reduced(), get_config("gpt-j").reduced()
    js = JFileStream(jcfg, str(path), global_batch=4, seq_len=32)
    ts = FileStream(tcfg, str(path), global_batch=4, seq_len=32,
                    device="cpu")
    for step in (0, 7, 40):
        jb, tb = js.batch(step), ts.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert isinstance(make_stream(tcfg, global_batch=4, seq_len=32,
                                  path=str(path), device="cpu"), FileStream)
    assert isinstance(make_stream(tcfg, global_batch=4, seq_len=32,
                                  path=str(tmp_path / "none.bin"),
                                  device="cpu"), SyntheticStream)


# --------------------------------------------------------------------------
# the kernels' autograd Functions: explicit backward vs autograd of plain
# --------------------------------------------------------------------------

# (norm, activation, residual, bias, fp32 out): q / k / v, out-projection
# and w2, w1, the CE head, the ViT head, and the other epilogues
GEMM_COMBOS = [("layernorm", "none", False, False, False),
               ("none", "none", True, False, False),
               ("layernorm", "i_gelu", False, False, False),
               ("none", "none", False, False, True),
               ("layernorm", "none", False, True, True),
               ("rmsnorm", "gelu", True, True, False),
               ("none", "gelu_exact", False, True, False),
               ("layernorm", "silu", True, False, True)]


@pytest.mark.parametrize("combo", GEMM_COMBOS)
def test_fused_matmul_fn_backward(combo):
    norm, act, res, bias, f32_out = combo
    rng = np.random.default_rng(2)
    M, K, N = 12, 32, 24

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor((rng.standard_normal(shape) * scale + shift
                             ).astype(np.float32), requires_grad=True)

    x, w = t(2, M // 2, K), t(K, N, scale=0.3)
    gamma = t(K, scale=0.1, shift=1.0) if norm != "none" else None
    beta = t(K, scale=0.1) if norm == "layernorm" else None
    b = t(N) if bias else None
    r = t(2, M // 2, N) if res else None
    ins = [v for v in (x, w, gamma, beta, b, r) if v is not None]
    pro = Prologue(norm, gamma, beta, eps=1e-5) if norm != "none" else None
    ep = Epilogue(activation=act, bias=b, residual=r,
                  out_dtype=torch.float32 if f32_out else None)
    y = tops.fused_matmul(x, w, prologue=pro, epilogue=ep,
                          compute_dtype=torch.float32)
    assert _made_by(y, "FusedMatmulFn")
    dy = torch.tensor(rng.standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, ins, dy)
    y2 = tmm.matmul_plain(x.reshape(M, K), w, norm=norm, gamma=gamma,
                          nbeta=beta, bias=b,
                          residual=None if r is None else r.reshape(M, N),
                          activation=act, eps=1e-5, out_dtype=torch.float32)
    want = torch.autograd.grad(y2, ins, dy.reshape(M, N))
    _close(y, y2.reshape(y.shape), FN_TOL, "forward")
    for i, (g, w_) in enumerate(zip(got, want)):
        _close(g, w_, FN_TOL, f"grad {i}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_flash_fn_backward(causal, heads):
    H, KV = heads
    rng = np.random.default_rng(3)
    Skv = 11 if causal else 7

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            requires_grad=True)

    q, k, v = t(2, 11, H, 16), t(2, Skv, KV, 16), t(2, Skv, KV, 16)
    o = tops.flash_attention(q, k, v, causal=causal)
    assert _made_by(o, "FlashAttentionFn")
    do = torch.tensor(rng.standard_normal(o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (q, k, v), do)
    o2 = tfa.flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(o2, (q, k, v), do)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, FN_TOL, f"grad {i}")


def test_layernorm_fn_backward():
    rng = np.random.default_rng(4)

    def t(*shape, shift=0.0):
        return torch.tensor((rng.standard_normal(shape) + shift
                             ).astype(np.float32), requires_grad=True)

    x, g, b = t(3, 5, 32, shift=0.5), t(32, shift=1.0), t(32)
    y = tops.layernorm(x, g, b)
    assert _made_by(y, "LayerNormFn")
    dy = torch.tensor(rng.standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (x, g, b), dy)
    want = torch.autograd.grad(tnorm.layernorm_plain(x, g, b), (x, g, b), dy)
    for i, (a, w) in enumerate(zip(got, want)):
        _close(a, w, FN_TOL, f"grad {i}")


def test_serving_calls_stay_plain():
    """Without grad the entry points are the serving path: no Function."""
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.randn(32, 16)
    with torch.no_grad():
        assert tops.fused_matmul(x, w).grad_fn is None
    assert tops.fused_matmul(x.detach(), w).grad_fn is None


def test_grad_refusals():
    x = torch.randn(4, 32, requires_grad=True)
    q = {"q": torch.ones(32, 16, dtype=torch.int8),
         "scale": torch.ones(16)}
    with pytest.raises(TypeError, match="int8 weights have no gradient"):
        tops.fused_matmul(x, q, compute_dtype=torch.float32)
    qkv = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="window"):
        tops.flash_attention(qkv, qkv, qkv, window=4)
    with pytest.raises(NotImplementedError, match="q_offset"):
        tops.flash_attention(qkv, qkv, qkv, q_offset=3)


# --------------------------------------------------------------------------
# ce_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pol", ["fp32", "bf16"])
def test_ce_loss_matches_reference(pol):
    tpol, jpol = POLICIES[pol]
    cfg = get_config("gpt3-xl").reduced()
    jcfg = jax_config("gpt3-xl").reduced()
    rng = np.random.default_rng(5)
    B, T, E, Vp = 2, 16, cfg.d_model, cfg.padded_vocab
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    w = (rng.standard_normal((E, Vp)) * 0.1).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    valid = rng.random((B, T)) > 0.2

    def jloss(x_, w_):
        s, c = jemb.ce_loss(x_.astype(jpol.compute_dtype),
                            w_.astype(jpol.param_dtype), jnp.asarray(labels),
                            jnp.asarray(valid), plan=UNSHARDED, cfg=jcfg,
                            policy=jpol, chunk=8)
        return s, c

    (js, jc), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ts, tc = temb.ce_loss(tx.to(tpol.compute_dtype), tw.to(tpol.param_dtype),
                          torch.tensor(labels), torch.tensor(valid),
                          cfg=cfg, policy=tpol, chunk=8)
    assert float(tc) == float(jc) == valid.sum()
    assert float(ts.detach()) == pytest.approx(float(js), rel=TOL[pol])
    tg = torch.autograd.grad(ts, (tx, tw))
    for i, (g, w_) in enumerate(zip(tg, jg)):
        _close(g, w_, TOL[pol], f"grad {i}")


# --------------------------------------------------------------------------
# forward_train and the train step
# --------------------------------------------------------------------------

def _ref_params(arch, seed):
    jcfg = jax_config(arch).reduced()
    return jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), jcfg,
                                                jnp.float32))


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[0, -3:] = False
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "valid": valid}
    if cfg.enc_schedule:            # an encoder-decoder's stub frames
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq_padded, cfg.d_model)).astype(np.float32)
    return out


def _jcast(tree, dt):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dt), tree)


@pytest.mark.parametrize("pol", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["gpt3-xl", "gpt-j", "whisper-base"])
def test_forward_train_matches_reference(arch, pol):
    tpol, jpol = POLICIES[pol]
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    tree = _ref_params(arch, 6)
    nb = _batch(cfg, 7)

    def jgrad(pol_):
        def jloss(p):
            return jlm.forward_train(_jcast(p, pol_.param_dtype),
                                     jax.tree.map(jnp.asarray, nb),
                                     plan=UNSHARDED, cfg=jcfg, policy=pol_)
        return jax.value_and_grad(jloss, has_aux=True)(
            jax.tree.map(jnp.asarray, tree))

    (jl, jm), jg = jgrad(jpol)
    tparams = tlm.params_from_numpy(tree, cfg, device="cpu")
    leaves, tdef = tree_flatten(tparams)
    xs = [p.requires_grad_(True) for p in leaves]
    tl, tm = tlm.forward_train(
        tree_map(lambda p: p.to(tpol.param_dtype), tree_unflatten(tdef, xs)),
        {k: torch.tensor(v) for k, v in nb.items()}, cfg=cfg, policy=tpol)
    assert float(tm["tokens"]) == float(jm["tokens"]) == nb["valid"].sum()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL[pol])
    assert float(tm["ce"]) == float(tm["loss"]) == float(tl.detach())
    tg = torch.autograd.grad(tl, xs)
    jgl = jax.tree.leaves(jg)
    assert len(tg) == len(jgl)
    j32 = jax.tree.leaves(jgrad(JFP32)[1]) if pol == "bf16" else None
    for i, (g, w) in enumerate(zip(tg, jgl)):
        if pol == "bf16":
            _bf16_close(g, w, j32[i], f"{arch} grad leaf {i}")
        else:
            _close(g, w, TOL[pol], f"{arch} {pol} grad leaf {i}")


def test_recompute_keeps_the_forward_mode():
    """The kernel mode is thread-local and a CUDA backward runs on
    autograd's device thread: the rematerialized layers and CE chunk must
    recompute in the forward's mode.  Here the backward runs on another
    thread (default mode `auto`) after a `ref`-mode forward; its grads
    equal a same-thread backward's."""
    import threading
    cfg = get_config("gpt3-xl").reduced()
    params = tlm.params_from_numpy(_ref_params("gpt3-xl", 6), cfg,
                                   device="cpu")
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 7).items()}
    leaves, tdef = tree_flatten(params)

    def run(other_thread):
        xs = [p.detach().clone().requires_grad_(True) for p in leaves]
        with tops.kernel_mode("ref"):
            loss, _ = tlm.forward_train(tree_unflatten(tdef, xs), batch,
                                        cfg=cfg, policy=FP32)
        out = {}
        if other_thread:
            t = threading.Thread(target=lambda: out.update(
                g=torch.autograd.grad(loss, xs)))
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        else:
            with tops.kernel_mode("ref"):
                out["g"] = torch.autograd.grad(loss, xs)
        return out["g"]

    for a, b in zip(run(True), run(False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ref_bundle(jcfg, jpol, S, B):
    from repro.configs.base import ShapeConfig
    return jsteps.make_train_step(
        jcfg, ShapeConfig("t", "train", S, B), None, policy=jpol,
        lr_fn=jschedule.cosine_schedule(1e-3, 1, 10))


@pytest.mark.parametrize("pol", ["fp32", "bf16"])
def test_train_step_matches_reference(pol):
    tpol, jpol = POLICIES[pol]
    arch = "gpt3-xl"
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    B, S = 2, 16
    jb = _ref_bundle(jcfg, jpol, S, B)
    jstate = jb.aux["init_state"](11)
    tb = make_train_step(cfg, policy=tpol,
                         lr_fn=cosine_schedule(1e-3, 1, 10), device="cpu")
    tstate = tb.aux["state_from_numpy"](jax.tree.map(np.asarray, jstate))
    js = JSyntheticStream(jcfg, global_batch=B, seq_len=S, seed=9)
    ts = SyntheticStream(cfg, global_batch=B, seq_len=S, seed=9,
                         device="cpu")
    for step in range(3):
        jstate, jm = jb.fn(jstate, js.batch(step))
        tstate, tm = tb.fn(tstate, ts.batch(step))
        for k in ("loss", "ce", "grad_norm", "lr", "tokens"):
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=TOL[pol]), (step, k)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    if pol == "fp32":
        _trees_close(tstate["params"], jstate["params"], TOL[pol], "params")
        return
    jb32 = _ref_bundle(jcfg, JFP32, S, B)
    j32 = jb32.aux["init_state"](11)
    for step in range(3):
        j32, _ = jb32.fn(j32, js.batch(step))
    for i, (g, w, w32) in enumerate(zip(tree_flatten(tstate["params"])[0],
                                        jax.tree.leaves(jstate["params"]),
                                        jax.tree.leaves(j32["params"]))):
        _bf16_close(g, w, w32, f"params leaf {i}")


def test_train_step_loss_decreases():
    cfg = get_config("gpt-j").reduced()
    tb = make_train_step(cfg, lr_fn=lambda s: 1e-3, device="cpu")
    state = tb.aux["init_state"](0)
    batch = SyntheticStream(cfg, global_batch=4, seq_len=32, seed=7,
                            device="cpu").batch(0)
    first = None
    for _ in range(30):
        state, metrics = tb.fn(state, batch)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first - 0.5, (first,
                                                  float(metrics["loss"]))


@pytest.mark.parametrize("arch,word", [
    ("phi4-mini-3.8b", "SwiGLU GEMM (row 2)"),
    ("mamba2-2.7b", "SSD scan"),
    ("hymba-1.5b", "SSD scan"),
    ("mixtral-8x7b", "expert form"),
    ("gemma3-27b", "window")])
def test_forward_train_refusals(arch, word):
    cfg = get_config(arch).reduced()
    assert word in tlm.train_support_reason(cfg)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tlm.forward_train({}, {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                               "labels": torch.zeros(1, 4,
                                                     dtype=torch.int32)},
                          cfg=cfg, policy=FP32)
    for ok in ("gpt3-xl", "gpt-j", "whisper-base"):
        assert tlm.train_support_reason(get_config(ok).reduced()) is None


def test_train_step_mesh_options_refused():
    cfg = get_config("gpt-j").reduced()
    for kw, word in ((dict(grad_compression="int8"), "pod mesh"),
                     (dict(reduce_method="tree"), "one device"),
                     (dict(ssm_seq_parallel=True), "one device")):
        with pytest.raises(ValueError, match=word):
            make_train_step(cfg, device="cpu", **kw)


# --------------------------------------------------------------------------
# ViT
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pol", ["fp32", "bf16"])
def test_vit_loss_matches_reference(pol):
    tpol, jpol = POLICIES[pol]
    cfg, jcfg = get_config("vit-b").reduced(), jax_config("vit-b").reduced()
    tree = jax.tree.map(np.asarray, jvit.init_vit(jax.random.key(2), jcfg,
                                                  jnp.float32))
    rng = np.random.default_rng(8)
    patches = rng.standard_normal((3, cfg.image_seq - 1, tvit.PATCH_DIM)
                                  ).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 3).astype(np.int32)

    def jloss(p):
        return jvit.vit_loss(_jcast(p, jpol.param_dtype),
                             jnp.asarray(patches).astype(jpol.compute_dtype),
                             jnp.asarray(labels), cfg=jcfg, policy=jpol)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    tparams = tvit.vit_params_from_numpy(tree, cfg, device="cpu")
    leaves, tdef = tree_flatten(tparams)
    xs = [p.requires_grad_(True) for p in leaves]
    tl, tm = tvit.vit_loss(
        tree_map(lambda p: p.to(tpol.param_dtype),
                 tree_unflatten(tdef, xs)),
        torch.tensor(patches).to(tpol.compute_dtype), torch.tensor(labels),
        cfg=cfg, policy=tpol)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL[pol])
    assert float(tm["acc"]) == float(jm["acc"])
    tg = torch.autograd.grad(tl, xs)
    for i, (g, w) in enumerate(zip(tg, jax.tree.leaves(jg))):
        _close(g, w, TOL[pol], f"vit {pol} grad leaf {i}")
