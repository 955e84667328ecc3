"""palu_decode_fp / palu_decode_fp_t (their plain versions on the CPU)
against the JAX kernels over unquantized latents: palu_flash_decode (v1,
seq-major) and palu_flash_decode4 (v4, rank-major), in interpret mode at
f32 compute, on the same latents. Tolerance 1e-5 of max|ref|: both sides
compute in f32 and differ only in summation order and in how the RoPE
angles are formed. The plain versions run on one intra-op thread (a
fixture), so their summation order is fixed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.ops.pallas.palu_decode import palu_flash_decode
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4
from palu_tpu_torch.ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref,
                                               palu_decode_fp_t, palu_decode_fp_t_ref)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Pin the plain versions' reduction order: one intra-op thread, so the
    f32 sums do not depend on how the machine's threads are shared."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(b, g, hpg, rk, rv, hd, s_max, kv_len, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    x_k = rng.standard_normal((b, g, s_max, rk)).astype(np.float32)
    x_v = rng.standard_normal((b, g, s_max, rv)).astype(np.float32)
    return q, b_k, x_k, x_v, np.asarray(kv_len, np.int32)


def _run_both(rank_major, b=1, g=2, hpg=4, rk=32, rv=64, hd=64, s_max=256, kv_len=(200,),
              window=None, seed=0):
    q, b_k, x_k, x_v, kvl = _case(b, g, hpg, rk, rv, hd, s_max, kv_len, seed)
    t = torch.from_numpy
    if rank_major:
        xk_t, xv_t = (np.ascontiguousarray(x.swapaxes(2, 3)) for x in (x_k, x_v))
        want = palu_flash_decode4(jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(xk_t),
                                  jnp.asarray(xv_t), jnp.asarray(kvl), rk=rk, rv=rv,
                                  block_s=64, interpret=True, compute_dtype=jnp.float32,
                                  sliding_window=window)
        fn, lat = palu_decode_fp_t, (t(xk_t), t(xv_t))
    else:
        want = palu_flash_decode(jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(x_k),
                                 jnp.asarray(x_v), jnp.asarray(kvl), block_s=64,
                                 interpret=True, compute_dtype=jnp.float32,
                                 sliding_window=window)
        fn, lat = palu_decode_fp, (t(x_k), t(x_v))
    launches = fn.launches
    got = fn(t(q), t(b_k), *lat, t(kvl), sliding_window=window)
    assert fn.launches == launches  # CPU: plain version
    return got.numpy(), np.asarray(want)


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


CASES = {
    "one_lane": dict(kv_len=(200,)),
    "per_lane_kv_len_and_single_token": dict(b=3, kv_len=(1, 177, 256), seed=11),
    "not_a_whole_block": dict(b=2, kv_len=(65, 130), seed=3),
    "sliding_window": dict(b=2, g=3, kv_len=(100, 256), window=50, seed=4),
    "gqa_16_heads_per_group": dict(g=1, hpg=16, kv_len=(130,), seed=9),
    "head_dim_128": dict(hd=128, rk=48, rv=32, kv_len=(150,), seed=5),
}


@pytest.mark.parametrize("rank_major", [False, True], ids=["seq_major", "rank_major"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_fp_matches_jax_kernel(case, rank_major):
    _close(*_run_both(rank_major, **CASES[case]))


def test_layouts_agree_and_reject_bad_input():
    q, b_k, x_k, x_v, kvl = (torch.from_numpy(a) for a in _case(2, 2, 4, 32, 64, 64, 128,
                                                                 (10, 128), 0))
    seq = palu_decode_fp_ref(q, b_k, x_k, x_v, kvl)
    rank = palu_decode_fp_t_ref(q, b_k, x_k.transpose(2, 3), x_v.transpose(2, 3), kvl)
    torch.testing.assert_close(seq, rank, rtol=0, atol=0)
    with pytest.raises(ValueError):  # x_k's rank is not b_k's
        palu_decode_fp_ref(q, b_k, x_k[..., :16], x_v, kvl)
    with pytest.raises(ValueError):  # seq-major latents given to the rank-major entry
        palu_decode_fp_t_ref(q, b_k, x_k, x_v, kvl)
    with pytest.raises(ValueError):  # kv_len per lane
        palu_decode_fp_ref(q, b_k, x_k, x_v, kvl[:1])
