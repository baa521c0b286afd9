"""PyTorch port, the serve CLI (`python -m repro_torch.launch.serve`) on the
CPU at reduced GPT-J: generate traffic (greedy and sampled), int8 serving
(`--weight-dtype int8 --kv-dtype int8`) and encode traffic run and print
the summary; the served tokens and embeddings equal an engine built
directly from the same seeds (the CLI's prefix cache is on by default);
`--draft-checkpoint` without `--spec-draft` and malformed goodput /
tracing values are refused.
Sampling seeds are int32, as the reference's lanes: a seed outside
[-2**31, 2**31) is refused instead of aliasing another."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.sampling import set_lane, stack_lanes, zero_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

BASE = ["--arch", "gpt-j", "--reduced", "--device", "cpu", "--requests",
        "4", "--batch", "2", "--prompt-len", "20", "--min-prompt-len", "6",
        "--max-new", "5", "--max-seq", "64", "--seed", "3"]
CASES = {"greedy": [],
         "sampled": ["--temperature", "0.8", "--top-k", "40"],
         "encode": ["--task", "encode", "--pooling", "mean"],
         "int8": ["--weight-dtype", "int8", "--kv-dtype", "int8",
                  "--temperature", "0.8", "--top-k", "40"]}


def _direct(args):
    """The trace of `args` through an engine built here from the same seed
    (not through `serve.run`)."""
    cfg = get_config(args.arch).reduced()
    params = tlm.init_lm(cfg, dtype=torch.bfloat16, device="cpu",
                         seed=args.seed)
    eng = InferenceEngine(cfg, params, batch_size=args.batch,
                          max_seq=args.max_seq, device="cpu",
                          weight_dtype=args.weight_dtype,
                          kv_dtype=args.kv_dtype)
    for task in serve.build_trace(cfg, args):
        eng.submit(task)
    return {t.uid: t for t in eng.run()}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_cli_runs_and_matches_a_direct_engine(case, capsys):
    argv = BASE + CASES[case]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "decode step eager" in out
    assert "NAR" in out and "AR" in out
    assert ("ENC" in out and "enc 0:" in out) if case == "encode" \
        else "req 0:" in out
    assert ("QUANT w=int8 kv=int8" in out) == (case == "int8")
    args = serve.parser().parse_args(argv)
    _, done, _ = serve.run(args)
    want = _direct(args)
    assert sorted(t.uid for t in done) == sorted(want)
    for t in done:
        if case == "encode":
            np.testing.assert_array_equal(t.embedding, want[t.uid].embedding)
        else:
            assert len(t.output) == 5 and t.output == want[t.uid].output


@pytest.mark.parametrize("flag", [["--draft-checkpoint", "d"],
                                  ["--deadline-ms", "-50"],
                                  ["--deadline-ms", "nan"],
                                  ["--policy", "edf"],
                                  ["--trace-buffer", "0"]])
def test_serve_cli_refuses_unported_flags(flag):
    """`--draft-checkpoint` without `--spec-draft` and malformed values of
    the goodput and tracing flags exit with argparse's code 2."""
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + flag)
    assert exc.value.code == 2


@pytest.mark.parametrize("seed", [2**31, 2**32 + 7, -2**31 - 1])
def test_seed_outside_int32_is_refused(seed):
    """7 and 2**32 + 7 would draw the same noise in an int32 lane: a seed
    outside [-2**31, 2**31) is refused, as the reference's int32 lanes
    refuse it."""
    with pytest.raises(ValueError, match="seed"):
        SamplingParams(temperature=0.8, seed=seed)


def test_int32_seeds_sample_and_lanes_hold_int32():
    """The lanes are int32; the extreme int32 seeds still sample."""
    params = [SamplingParams(temperature=0.8, top_k=5, seed=s)
              for s in (2**31 - 1, -2**31)]
    assert stack_lanes(params)["seed"].dtype == np.int32
    lane = set_lane(zero_lane(2), 1, params[0])
    assert lane["seed"].dtype == np.int32 and lane["seed"][1] == 2**31 - 1
    cfg = get_config("gpt-j").reduced()
    eng = InferenceEngine(cfg, tlm.init_lm(cfg, dtype=torch.float32,
                                           device="cpu", seed=1),
                          batch_size=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(2)
    for uid, sp in enumerate(params):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 6),
                           max_new_tokens=4, sampling=sp))
    done = eng.run()
    assert len(done) == 2 and all(len(t.output) == 4 for t in done)
