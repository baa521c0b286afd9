"""PyTorch port, sampling: the threefry-2x32 port (`repro_torch.core.prng`)
against `jax.random` under partitionable threefry, and the port's sampler
against the reference's on the same logits.

  * keys, folded keys, 32-bit random bits and [tiny, 1) uniforms are
    bit-equal to the reference's for 32 (seed, step) pairs, drawn as the
    reference's sampler draws them (int32 lanes under vmap);
  * Gumbel noise agrees to 1e-6 (the two log implementations may differ in
    the last bit);
  * `_lane_scores` / `sample_token` pick the same tokens as the
    reference's on the same logits, with the noise each package draws
    itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps  # noqa: F401  (sets jax_threefry_partitionable)
from repro.configs import get_config as jax_config
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import embedding as temb
from repro_torch.core import prng
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops as tops
from repro_torch.serving.sampling import device_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

V = 517                       # odd width: no even/odd counter split to hide
TINY = float(jnp.finfo(jnp.float32).tiny)
GUMBEL = dict(rtol=1e-6, atol=1e-6)


def _pairs(group):
    """8 (seed, step) int32 pairs per group, 4 groups: small and large
    seeds, negative seeds (the lanes are int32), steps up to 2^31 - 1."""
    rng = np.random.default_rng(100 + group)
    seeds = rng.integers(-2**31, 2**31, 8, dtype=np.int64)
    steps = rng.integers(0, 2**31, 8, dtype=np.int64)
    seeds[:2] = [0, group + 1]
    steps[:2] = [0, 2**31 - 1]
    return seeds.astype(np.int32), steps.astype(np.int32)


def _jax_draw(seeds, steps, fn):
    def row(seed, step):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step),
                               0)
        return fn(k)
    return np.asarray(jax.vmap(row)(jnp.asarray(seeds), jnp.asarray(steps)))


def _torch_key(seeds, steps):
    k = prng.key(torch.tensor(seeds.astype(np.int64)))
    return prng.fold_in(prng.fold_in(k, torch.tensor(steps.astype(np.int64))),
                        0)


@pytest.mark.parametrize("group", range(4))
def test_folded_keys_bit_equal(group):
    seeds, steps = _pairs(group)
    want = _jax_draw(seeds, steps, jax.random.key_data)
    k1, k2 = _torch_key(seeds, steps)
    got = np.stack([k1.numpy(), k2.numpy()], -1).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group", range(4))
def test_random_bits_bit_equal(group):
    seeds, steps = _pairs(group)
    want = _jax_draw(seeds, steps,
                     lambda k: jax.random.bits(k, (V,), jnp.uint32))
    got = prng.random_bits(_torch_key(seeds, steps), V).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("group", range(4))
def test_uniform_bit_equal(group):
    seeds, steps = _pairs(group)
    want = _jax_draw(seeds, steps, lambda k: jax.random.uniform(
        k, (V,), jnp.float32, minval=TINY, maxval=1.0))
    got = prng.uniform(_torch_key(seeds, steps), V, minval=TINY).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("group", range(4))
def test_gumbel_matches(group):
    seeds, steps = _pairs(group)
    want = _jax_draw(seeds, steps,
                     lambda k: jax.random.gumbel(k, (V,), jnp.float32))
    got = prng.gumbel(_torch_key(seeds, steps), V).numpy()
    np.testing.assert_allclose(got, want, **GUMBEL)


def test_python_int_seed_key():
    """`jax.random.key(int)` and the port's `key(int)` hold the same words."""
    for seed in (0, 7, 2**31 - 1):
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        got = [int(w) for w in prng.key(seed)]
        assert got == want.tolist()


def test_gumbel_noise_over_padded_vocab():
    """The sampler's noise at phi4-mini's padded vocabulary (200192): the
    reference's draw for the sampled rows, zeros for the greedy row."""
    Vp = get_config("phi4-mini-3.8b").padded_vocab
    lane = {"temperature": np.array([0.8, 0.0, 1.0], np.float32),
            "seed": np.array([101, 5, 106], np.int64),
            "step": np.array([301, 40, 12], np.int64)}
    got = temb.gumbel_noise(device_lane(lane, "cpu"), Vp).numpy()
    rows = [0, 2]
    want = _jax_draw(lane["seed"][rows].astype(np.int32),
                     lane["step"][rows].astype(np.int32),
                     lambda k: jax.random.gumbel(k, (Vp,), jnp.float32))
    np.testing.assert_allclose(got[rows], want, **GUMBEL)
    assert not got[1].any()


def _lane(B, rng):
    return {"temperature": rng.uniform(0.3, 1.5, B).astype(np.float32)
            * (np.arange(B) % 4 != 0),                  # every 4th greedy
            "top_k": rng.choice([0, 1, 5, 40, 64], B).astype(np.int32),
            "seed": rng.integers(0, 2**31, B).astype(np.int32),
            "step": rng.integers(0, 4096, B).astype(np.int32)}


@pytest.mark.parametrize("seed", range(3))
def test_lane_scores_token_identical(seed):
    """Each package draws its own noise: the argmax of the scores — the
    sampled token — is the same for every row."""
    rng = np.random.default_rng(seed)
    B, Vp = 16, 512
    z = (rng.standard_normal((B, Vp)) * 2).astype(np.float32)
    z[:, 500:] = -1e30                                   # padded columns
    lane = _lane(B, rng)
    want = jemb._lane_scores(jnp.asarray(z),
                             {k: jnp.asarray(v) for k, v in lane.items()},
                             plan=UNSHARDED)
    got = temb._lane_scores(torch.tensor(z), device_lane(lane, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GUMBEL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gpt-j"])
def test_sample_token_identical(arch):
    """`sample_token` end to end — the fused final-norm logits head, top-k,
    temperature, threefry Gumbel noise — on the same residuals and
    weights.  vocab 250 pads to 256, so the noise spans padded columns."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), vocab=250)
    tcfg = dataclasses.replace(get_config(arch).reduced(), vocab=250)
    rng = np.random.default_rng(3)
    B, E = 12, jcfg.d_model
    x = rng.standard_normal((B, E)).astype(np.float32)
    unemb = (rng.standard_normal((E, 256)) * 0.5).astype(np.float32)
    fn = {"scale": (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)}
    if jcfg.norm == "layernorm":
        fn["bias"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    lane = _lane(B, rng)
    want = jemb.sample_token(
        jnp.asarray(x), jnp.asarray(unemb),
        {k: jnp.asarray(v) for k, v in lane.items()}, plan=UNSHARDED,
        cfg=jcfg, policy=JFP32,
        norm=jops.norm_prologue({k: jnp.asarray(v) for k, v in fn.items()},
                                jcfg.norm))
    got = temb.sample_token(
        torch.tensor(x), torch.tensor(unemb), device_lane(lane, "cpu"),
        cfg=tcfg, policy=FP32,
        norm=tops.norm_prologue({k: torch.tensor(v) for k, v in fn.items()},
                                tcfg.norm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
