"""PyTorch port, the training state around the step: the Checkpointer
(round trip, `keep`, async save, atomic commit, and checkpoints of either
package restored by the other bit for bit, bf16 leaves included), the
fault-tolerance runtime (`run_with_restarts`, `StragglerWatchdog`,
`PreemptionGuard`) against the reference's, the train CLI on the CPU
(resume equal to the uninterrupted run, exit 42 on preemption, the
refusals), and `draft_checkpoint=` on the engine and the serve CLI.
Reduced configs, numpy-seeded states."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.runtime import StragglerWatchdog as JWatchdog
from repro.serving import spec as jspec
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.precision import FP32
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.runtime import (PreemptionGuard, StragglerWatchdog,
                                 run_with_restarts)
from repro_torch.serving import InferenceEngine, Request, SpecConfig
from repro_torch.serving.spec import resolve_draft

torch.set_num_threads(2)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"step": torch.tensor(7, dtype=torch.int32),
            "params": {"w": torch.randn(3, 4, generator=g),
                       "segments": ({"a": torch.randn(2, 5, generator=g)
                                     .bfloat16()},)},
            "opt": {"m": torch.randn(6, generator=g).half()}}


def _bits(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_bit_equal(got, want):
    gl, wl = tree_flatten(got)[0], tree_flatten(want)[0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))


# --------------------------------------------------------------------------
# Checkpointer
# --------------------------------------------------------------------------

def test_round_trip_keep_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        st = _state(step)
        if step == 2:
            ck.save_async(st, step)
            st["params"]["w"].zero_()     # the snapshot was taken already
        else:
            ck.save(st, step)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    like = tree_map(torch.empty_like, _state())
    _assert_bit_equal(ck.restore(like, step=2), _state(2))
    _assert_bit_equal(ck.restore(like), _state(3))
    assert ck.manifest(3)["dtypes"] == ["float16", "bfloat16", "float32",
                                        "int32"]
    meta = tree_map(lambda t: torch.empty_like(t, device="meta"), _state())
    _assert_bit_equal(ck.restore(meta, device="cpu"), _state(3))
    with pytest.raises(ValueError, match="shape"):
        bad = _state()
        bad["params"]["w"] = torch.zeros(4, 3)
        ck.restore(bad)


def test_interrupted_write_leaves_no_step(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(1), 1)
    calls = []
    real = np.save

    def failing(path, arr):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("disk gone")
        real(path, arr)

    monkeypatch.setattr(np, "save", failing)
    with pytest.raises(OSError):
        ck.save(_state(2), 2)
    monkeypatch.setattr(np, "save", real)
    assert ck.all_steps() == [1]
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.tmp"))
    ck.save(_state(2), 2)                 # the stale .tmp is replaced
    assert ck.all_steps() == [1, 2]
    _assert_bit_equal(ck.restore(_state()), _state(2))


def _ref_train_state():
    jcfg = jax_config("gpt3-xl").reduced()
    b = jsteps.make_train_step(jcfg, ShapeConfig("t", "train", 16, 2), None)
    st = b.aux["init_state"](3)
    st["bf16"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                              st["params"])
    return st


def _port_like():
    tb = make_train_step(get_config("gpt3-xl").reduced(),
                         device="cpu")
    like = tb.aux["state_like"]()
    like["bf16"] = tree_map(lambda t: t.to(torch.bfloat16), like["params"])
    return like


def _to_np_bits(leaf):
    a = np.asarray(leaf)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def test_reference_checkpoint_restores_in_port(tmp_path):
    st = _ref_train_state()
    JCheckpointer(str(tmp_path)).save(st, 4)
    got = Checkpointer(str(tmp_path)).restore(_port_like(), device="cpu")
    gl, wl = tree_flatten(got)[0], jax.tree.leaves(st)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(_bits(g), _to_np_bits(w))


def test_port_checkpoint_restores_in_reference(tmp_path):
    st = _ref_train_state()
    like = _port_like()
    port = Checkpointer(str(tmp_path / "a"))
    JCheckpointer(str(tmp_path / "a")).save(st, 1)
    state = port.restore(like, device="cpu")
    port.save(state, 2)
    back = JCheckpointer(str(tmp_path / "a")).restore(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), st),
        step=2)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_to_np_bits(g), _to_np_bits(w))
    man = port.manifest(2)
    assert man["treedef"] == str(jax.tree.structure(st))


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------

def test_run_with_restarts_recovers(tmp_path):
    failed = set()

    def fail_at(step):
        if step == 7 and 7 not in failed:
            failed.add(7)
            return True
        return False

    ck = Checkpointer(str(tmp_path / "a"), keep=10)
    final, executed, restarts = run_with_restarts(
        lambda: {"acc": torch.zeros(())},
        lambda s, step: {"acc": s["acc"] + step}, ck, total_steps=20,
        checkpoint_every=5, fail_at=fail_at)
    assert restarts == 1 and float(final["acc"]) == sum(range(20))
    assert executed > 20


def test_run_with_restarts_gives_up(tmp_path):
    ck = Checkpointer(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="injected"):
        run_with_restarts(lambda: {"x": torch.zeros(())},
                          lambda s, i: s, ck, total_steps=5, max_restarts=2,
                          fail_at=lambda s: True)


def test_straggler_watchdog_matches_reference():
    rng = np.random.default_rng(0)
    dts = 0.1 + 0.005 * rng.standard_normal(60)
    dts[[15, 31, 32, 50]] = (0.5, 0.3, 0.16, 0.9)
    ours, ref = StragglerWatchdog(warmup=3), JWatchdog(warmup=3)
    for step, dt in enumerate(dts):
        assert ours.observe(step, float(dt)) == ref.observe(step, float(dt))
    assert ours.events == ref.events and [e["step"] for e in ours.events]
    assert ours.mean == ref.mean and ours.var == ref.var


def test_preemption_guard_catches_signal():
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.should_stop


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI = ["--arch", "gpt3-xl", "--reduced", "--device", "cpu", "--steps", "5",
       "--global-batch", "2", "--seq", "16", "--log-every", "1"]


def test_cli_resume_equals_uninterrupted(tmp_path, capsys):
    d = str(tmp_path / "ck")
    assert train_cli.main(CLI + ["--checkpoint-dir", d,
                                 "--checkpoint-every", "3"]) == 0
    full = capsys.readouterr().out.splitlines()
    ck = Checkpointer(d)
    assert ck.all_steps() == [3, 5]
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000005"))
    assert train_cli.main(CLI + ["--checkpoint-dir", d, "--resume"]) == 0
    resumed = capsys.readouterr().out.splitlines()
    assert resumed[0] == "resumed from step 3"
    assert resumed[1:] == full[3:], (full, resumed)
    assert full[-1].startswith("done: 5 steps, final loss ")


def test_cli_preemption_exits_42(tmp_path, monkeypatch, capsys):
    class Preempted(PreemptionGuard):
        def __enter__(self):
            super().__enter__()
            self.should_stop = True
            return self

    monkeypatch.setattr(train_cli, "PreemptionGuard", Preempted)
    d = str(tmp_path / "ck")
    assert train_cli.main(CLI + ["--checkpoint-dir", d]) == 42
    assert "preempted: checkpointing and exiting for restart" in \
        capsys.readouterr().out
    assert Checkpointer(d).all_steps() == [1]


def test_cli_refuses_compress():
    with pytest.raises(SystemExit) as exc:
        train_cli.main(CLI + ["--compress", "int8"])
    assert exc.value.code == 2


# --------------------------------------------------------------------------
# draft_checkpoint
# --------------------------------------------------------------------------

def _draft_setup(tmp_path):
    cfg = get_config("gpt-j").reduced()
    spec = SpecConfig(draft="auto", k=3)
    dcfg = resolve_draft(spec, cfg)
    jd = jspec.resolve_draft(jspec.SpecConfig(draft="auto", k=3),
                             jax_config("gpt-j").reduced())
    assert jd.name == dcfg.name
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(5), jd,
                                                jnp.float32))
    JCheckpointer(str(tmp_path)).save(tree, 0)
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=1)
    return cfg, spec, dcfg, tree, params


def _serve(cfg, params, **kw):
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=64, policy=FP32,
                          device="cpu", **kw)
    rng = np.random.default_rng(4)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, 9 + 4 * uid).astype(np.int32), max_new_tokens=6))
    return {t.uid: t.output for t in eng.run()}


def test_draft_checkpoint_serves_as_draft_params(tmp_path):
    cfg, spec, dcfg, tree, params = _draft_setup(tmp_path)
    want = _serve(cfg, params, spec=spec,
                  draft_params=tlm.params_from_numpy(tree, dcfg,
                                                     device="cpu"))
    got = _serve(cfg, params, spec=spec, draft_checkpoint=str(tmp_path))
    assert got == want and all(len(v) == 6 for v in got.values())
    with pytest.raises(ValueError, match="SpecConfig"):
        InferenceEngine(cfg, params, device="cpu",
                        draft_checkpoint=str(tmp_path))
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(cfg, params, device="cpu", spec=spec,
                        draft_params=params, draft_checkpoint=str(tmp_path))
    JCheckpointer(str(tmp_path / "bad")).save({"x": np.zeros(3)}, 0)
    with pytest.raises(ValueError, match="leaves"):
        InferenceEngine(cfg, params, device="cpu", spec=spec,
                        draft_checkpoint=str(tmp_path / "bad"))


def test_serve_cli_draft_checkpoint(tmp_path, capsys):
    cfg, spec, dcfg, tree, params = _draft_setup(tmp_path)
    args = ["--arch", "gpt-j", "--reduced", "--device", "cpu", "--requests",
            "2", "--batch", "2", "--max-new", "4", "--spec-draft", "auto",
            "--spec-k", "3"]
    assert serve.main(args + ["--draft-checkpoint", str(tmp_path)]) == 0
    assert "spec: draft=" in capsys.readouterr().out
