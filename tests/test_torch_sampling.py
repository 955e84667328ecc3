"""The port's sampler against palu_tpu/runtime/sampling.py: fed JAX's Gumbel
noise for the keys JAX folds (fold_in(fold_in(key(seed), rid), step) per
serving lane), sample_batched and sample must give JAX's token ids, with
per-lane temperature, top-k and top-p; greedy lanes take the argmax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.runtime import sampling as jsampling
from palu_tpu_torch.runtime import sampling

V = 50
LANES = [  # (temperature, top_k, top_p)
    (0.0, 0, 1.0),      # greedy
    (1.0, 8, 1.0),
    (0.7, 0, 0.9),
    (1.3, 12, 0.8),
    (0.0, 5, 0.5),      # greedy whatever its filters
    (2.0, 1, 1.0),      # top-1: the argmax of the scaled logits
]


def jax_noise(shape, device, seed, *folds):
    """JAX's Gumbel noise for key(seed) folded with `folds`: what
    jax.random.categorical adds to the logits. Stands in for the port's
    sampling.gumbel_noise (same signature) in the tests that hold the
    port's tokens equal to JAX's."""
    key = jax.random.key(int(seed))
    for f in folds:
        key = jax.random.fold_in(key, int(f))
    return torch.from_numpy(np.asarray(jax.random.gumbel(key, tuple(shape), jnp.float32))
                            ).to(device)


def _keys(seed, rids, step):
    base = jax.random.key(seed)
    return [jax.random.fold_in(jax.random.fold_in(base, r), step) for r in rids]


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (123, 41)])
def test_sample_batched_matches_jax(seed, step):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(LANES), V)) * 3).astype(np.float32)
    temps, ks, ps = (np.asarray(c) for c in zip(*LANES))
    rids = rng.integers(0, 1000, len(LANES))
    keys = _keys(seed, rids, step)
    want = np.asarray(jsampling.sample_batched(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32), jnp.asarray(ks, jnp.int32),
        jnp.asarray(ps, jnp.float32), jnp.stack(keys)))
    noise = torch.cat([jax_noise((1, V), "cpu", seed, r, step) for r in rids])
    got = sampling.sample_batched(
        torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
        torch.tensor(ks), torch.tensor(ps, dtype=torch.float32), noise)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = temps <= 0
    np.testing.assert_array_equal(got.numpy()[greedy], logits.argmax(-1)[greedy])


@pytest.mark.parametrize("kw", [dict(temperature=1.0, top_k=8), dict(temperature=0.7, top_p=0.9),
                                dict(temperature=1.3, top_k=12, top_p=0.8), dict()])
def test_sample_matches_jax(kw):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, V)) * 3).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(9), 2)
    sp = jsampling.SamplingParams(**kw)
    want = np.asarray(jsampling.sample(jnp.asarray(logits), sp,
                                       key=key if sp.temperature > 0 else None))
    got = sampling.sample(torch.from_numpy(logits), sampling.SamplingParams(**kw),
                          jax_noise((3, V), "cpu", 9, 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_noise_is_a_function_of_its_ids():
    a = sampling.gumbel_noise((2, V), "cpu", 7, 3, 1)
    torch.testing.assert_close(a, sampling.gumbel_noise((2, V), "cpu", 7, 3, 1), rtol=0, atol=0)
    assert not torch.equal(a, sampling.gumbel_noise((2, V), "cpu", 7, 4, 1))
    assert not torch.equal(a, sampling.gumbel_noise((2, V), "cpu", 7, 3, 2))
    assert torch.isfinite(a).all() and a.dtype == torch.float32
    # a standard Gumbel has mean ~0.5772 and variance pi^2 / 6
    big = sampling.gumbel_noise((200_000,), "cpu", 1)
    assert abs(big.mean().item() - 0.5772) < 0.02
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.05
    with pytest.raises(ValueError):
        sampling.sample(torch.zeros(1, V), sampling.SamplingParams(temperature=1.0))
