"""PyTorch port, the serve CLI (`python -m repro_torch.launch.serve`) on the
CPU at reduced GPT-J: generate traffic (greedy and sampled) and encode
traffic run and print the summary; the served tokens and embeddings equal
an engine built directly from the same seeds; flags of unported features
are refused."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import InferenceEngine

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

BASE = ["--arch", "gpt-j", "--reduced", "--device", "cpu", "--requests",
        "4", "--batch", "2", "--prompt-len", "20", "--min-prompt-len", "6",
        "--max-new", "5", "--max-seq", "64", "--seed", "3"]
CASES = {"greedy": [],
         "sampled": ["--temperature", "0.8", "--top-k", "40"],
         "encode": ["--task", "encode", "--pooling", "mean"]}


def _direct(args):
    """The trace of `args` through an engine built here from the same seed
    (not through `serve.run`)."""
    cfg = get_config(args.arch).reduced()
    params = tlm.init_lm(cfg, dtype=torch.bfloat16, device="cpu",
                         seed=args.seed)
    eng = InferenceEngine(cfg, params, batch_size=args.batch,
                          max_seq=args.max_seq, device="cpu")
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
    args = serve.parser().parse_args(argv)
    _, done, _ = serve.run(args)
    want = _direct(args)
    assert sorted(t.uid for t in done) == sorted(want)
    for t in done:
        if case == "encode":
            np.testing.assert_array_equal(t.embedding, want[t.uid].embedding)
        else:
            assert len(t.output) == 5 and t.output == want[t.uid].output


@pytest.mark.parametrize("flag", [["--spec-draft", "self"],
                                  ["--no-prefix-cache"], ["--overlap"],
                                  ["--policy", "chunked"],
                                  ["--kv-dtype", "int8"]])
def test_serve_cli_refuses_unported_flags(flag):
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + flag)
    assert exc.value.code == 2
