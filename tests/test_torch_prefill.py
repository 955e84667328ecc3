"""prefill_flash (its plain version on the CPU) against the JAX prefill
kernel in interpret mode at f32 compute with exp2, on the same inputs.
Tolerance 1e-5 of max|ref|: both sides are f32; the kernel runs an online
softmax in base 2, the plain version one softmax over materialized logits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.ops.pallas.prefill_flash import prefill_flash as j_prefill_flash
from palu_tpu_torch.ops.prefill_flash import prefill_flash, prefill_flash_ref

TOL = 1e-5


def _run_both(b=1, nh=4, nkv=4, cq=64, s_max=256, hd=64, off=(0,), kvl=(64,),
              window=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, cq, hd)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s_max, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s_max, hd)).astype(np.float32)
    off, kvl = np.asarray(off, np.int32), np.asarray(kvl, np.int32)
    want = np.asarray(j_prefill_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        jnp.asarray(kvl), block_s=64, interpret=True, compute_dtype=jnp.float32,
        exp2=True, sliding_window=window))
    launches = prefill_flash.launches
    got = prefill_flash(*(torch.from_numpy(a) for a in (q, k, v, off, kvl)),
                        sliding_window=window).numpy()
    assert prefill_flash.launches == launches  # CPU: plain version
    return got, want


def _close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("off,kvl", [((0,), (64,)), ((128,), (192,)), ((192,), (256,))])
def test_prefill_offsets(off, kvl):
    _close(*_run_both(off=off, kvl=kvl, seed=off[0]))


def test_prefill_gqa_and_ragged_lanes():
    _close(*_run_both(b=2, nh=8, nkv=2, off=(64, 0), kvl=(128, 40), seed=3))


def test_prefill_sliding_window():
    _close(*_run_both(b=2, nh=4, nkv=2, off=(128, 64), kvl=(192, 128), window=48, seed=5))


def test_prefill_padded_tail_rows_stay_finite():
    """Rows past kv_len (a padded tail chunk) attend the prefix and stay finite."""
    got, want = _run_both(off=(64,), kvl=(100,), seed=6)
    assert np.isfinite(got).all()
    _close(got, want)


def test_prefill_rejects_bad_shapes():
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 32, 16)  # 3 q-heads over 2 kv heads
    with pytest.raises(ValueError):
        prefill_flash_ref(q, kv, kv, 0, 8)
