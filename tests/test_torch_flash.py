"""PyTorch port: the flash-attention kernel's Hopper template on the CPU.

The wgmma template (csrc/flash_attention.cu) runs only on the card; here its
arithmetic is held in plain PyTorch (`flash_emulate`: 64-row query tiles,
only the 64-key KV tiles that some row of a tile attends, in order, fp32
scores and statistics, P rounded to bf16, fp32 accumulation) against the
JAX Pallas kernel in interpret mode and against `flash_attention_plain`, at
the head dims the served models use (64, 128, 256): causal and
bidirectional, a sliding window, GQA, a query offset and ragged lengths
(197, and 1100 cut down to 300 with the window cut to 128).  The planner
is held to its rule (wgmma for bf16 at D a multiple of 16 up to 256, simt
for fp32 and for bf16 at other D, a raise for the rest), and the skipped
tiles to exactness: a tile outside a query tile's range is masked for
every real row, one inside is not.

Inputs are bf16 values made from a numpy seed and handed to both
frameworks.  Tolerance: bf16 output, rtol = atol = 2e-2 (conftest); the
emulation against the plain version within 2e-2 x max|plain| (P rounded at
another running max rounds differently; the output is one bf16 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

BF16 = dict(rtol=2e-2, atol=2e-2)
REL = 2e-2

# label -> (B, Sq, Skv, H, KV, causal, window, q_offset)
CASES = {
    "causal S=197": (1, 197, 197, 2, 2, True, 0, 0),
    "bidirectional S=197": (1, 197, 197, 2, 2, False, 0, 0),
    "window 128 S=300": (1, 300, 300, 2, 1, True, 128, 0),
    "gqa 4/2 S=130": (2, 130, 130, 4, 2, True, 0, 0),
    "q_offset 70 Sq=60": (1, 60, 130, 2, 2, True, 0, 70),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, B, Sq, Skv, H, KV, D):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, Sq, H, D)),
            rng.standard_normal((B, Skv, KV, D)),
            rng.standard_normal((B, Skv, KV, D))]
    return [(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
             torch.tensor(x, dtype=torch.float32).bfloat16()) for x in arrs]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_wgmma_flash_vs_pallas_and_plain(case, D):
    B, Sq, Skv, H, KV, causal, window, q_offset = CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _inputs(D + Sq, B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tfa.flash_emulate(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    pallas = jfa.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                 interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **BF16)
    plain = tfa.flash_attention_plain(tq, tk, tv, **kw)
    err = np.abs(_np(got) - _np(plain)).max()
    assert err <= REL * np.abs(_np(plain)).max(), err
    # the CPU wrapper takes the plain version
    assert torch.equal(tfa.flash_attention(tq, tk, tv, **kw), plain)


@pytest.mark.parametrize("case", list(CASES) + ["gemma3 window 1024 S=1100"])
def test_skipped_tiles_are_exactly_the_fully_masked_ones(case):
    """A KV tile outside [j0, j1) of a query tile is masked for every real
    row of it (skipping it is exact); a tile inside has a live pair."""
    if case in CASES:
        _, Sq, Skv, _, _, causal, window, q_offset = CASES[case]
    else:
        Sq, Skv, causal, window, q_offset = 1100, 1100, True, 1024, 0
    T = tfa.FW_TILE
    tiles = tfa.flash_tiles(Sq, Skv, causal=causal, window=window,
                            q_offset=q_offset)
    assert [q0 for q0, _, _ in tiles] == list(range(0, Sq, T))
    for q0, j0, j1 in tiles:
        qpos = np.arange(q0, min(q0 + T, Sq))[:, None] + q_offset
        for j in range(-(-Skv // T)):
            kpos = np.arange(j * T, min(j * T + T, Skv))[None, :]
            ok = np.ones((qpos.shape[0], kpos.shape[1]), bool)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            assert ok.any() == (j0 <= j < j1), (q0, j, j0, j1)


def test_flash_plan():
    bf, f32 = torch.bfloat16, torch.float32
    for D in (16, 64, 80, 128, 192, 256):
        assert tfa.flash_plan(bf, D) == "wgmma"
    for D in (4, 20, 72, 100):
        assert tfa.flash_plan(bf, D) == "simt"
    for D in (64, 128, 256):
        assert tfa.flash_plan(f32, D) == "simt"
    for D in (2, 6, 260, 272):
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_plan(bf, D)
    with pytest.raises(TypeError):
        tfa.flash_plan(torch.float16, 64)
