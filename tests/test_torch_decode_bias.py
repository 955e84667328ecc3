"""The pre-RoPE K bias (Qwen2's k_bias) in the port's decodes, their plain
versions on the CPU, against the JAX package on the same inputs:

  - palu_decode_ref in its three K-path modes against JAX's
    palu_flash_decode4_quantized(k_bias=...) in interpret mode at f32
    compute; tolerance 1e-5 of max|ref| for the exact mode (both sides in
    f32, summation order apart) and 2e-3 for the int8 modes (the class of
    tests/test_torch_decode_int8.py: a query-folded operand value on a
    rounding tie may take the neighbouring int8 code on one side);
  - palu_decode_fp_t_ref against palu_flash_decode4(k_bias=...), and
    palu_decode_fp_ref (seq-major; the JAX engine runs that cache with a
    bias through its XLA flash_decode_latent) and the port's
    flash_decode_latent against JAX's flash_decode_latent(k_bias=...);
    1e-5 of max|ref|.

The biases are 0.3 N(0, 1), as JAX's own kernel tests draw them
(tests/test_pallas_decode4.py::_rand_bias), and each case checks that the
bias moves the output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops import attention as jattn
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4, palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.attention import flash_decode_latent
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_t

TOL = {"exact": 1e-5, "int8_dots": 2e-3, "int8_rot": 2e-3}


def _inputs(b, g, hpg, rk, rv, hd, s_max, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    x_k = rng.standard_normal((b, g, s_max, rk)).astype(np.float32)
    x_v = rng.standard_normal((b, g, s_max, rv)).astype(np.float32)
    k_bias = (rng.standard_normal((g, hpg, hd)) * 0.3).astype(np.float32)
    return q, b_k, x_k, x_v, k_bias


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


# (lanes, groups, heads per group, rk, rv, hd, S, kv_len per lane, window)
SHAPES = {
    "two_groups": (2, 2, 4, 32, 64, 64, 256, (200, 256), None),
    "qwen2_one_group_28_heads": (1, 1, 28, 32, 32, 64, 128, (100,), None),
    "sliding_window": (2, 2, 4, 32, 64, 64, 256, (1, 256), 80),
}


@pytest.mark.parametrize("mode", ["exact", "int8_dots", "int8_rot"])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_packed_decode_bias_matches_jax_kernel(mode, sym, shape):
    b, g, hpg, rk, rv, hd, s_max, kvl, window = SHAPES[shape]
    q, b_k, x_k, x_v, k_bias = _inputs(b, g, hpg, rk, rv, hd, s_max, seed=len(shape) + sym)
    jq = jquant.QuantConfig(bits=3, group_size=0, sym=sym, container=4)
    bufs = {}
    for side, x in (("k", x_k), ("v", x_v)):
        codes, scales, zeros = jquant.quantize_affine(jnp.asarray(x), jq)
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes_t(codes, jq.pack_bits))
        bufs[f"x{side}_scale"] = np.array(scales[..., 0])
        if not sym:
            bufs[f"x{side}_zero"] = np.array(zeros[..., 0])
    kv_len = np.asarray(kvl, np.int32)
    knob = {} if mode == "exact" else {mode: True}
    order = ("xk_codes", "xk_scale", "xv_codes", "xv_scale")
    want = np.asarray(palu_flash_decode4_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in order), jnp.asarray(kv_len),
        qcfg=jq, rk=rk, rv=rv, block_s=64, interpret=True, compute_dtype=jnp.float32,
        sliding_window=window, k_bias=jnp.asarray(k_bias),
        **{k: v for k, v in bufs.items() if k.endswith("zero")}, **knob))
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    kw = dict(qcfg=QuantConfig(bits=3, group_size=0, sym=sym, container=4), rk=rk, rv=rv,
              sliding_window=window, block_s=64, **knob)
    args = (torch.from_numpy(q), torch.from_numpy(b_k))
    n = palu_decode.launches
    got = palu_decode(*args, kv_len=torch.from_numpy(kv_len), **tb, **kw,
                      k_bias=torch.from_numpy(k_bias)).numpy()
    assert palu_decode.launches == n  # CPU: plain version
    _close(got, want, TOL[mode])
    unbiased = palu_decode_ref(*args, kv_len=torch.from_numpy(kv_len), **tb, **kw).numpy()
    assert np.abs(got - unbiased).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fp_decodes_bias_match_jax(shape):
    b, g, hpg, rk, rv, hd, s_max, kvl, window = SHAPES[shape]
    q, b_k, x_k, x_v, k_bias = _inputs(b, g, hpg, rk, rv, hd, s_max, seed=7 + len(shape))
    kv_len = np.asarray(kvl, np.int32)
    xk_t, xv_t = (np.ascontiguousarray(x.swapaxes(2, 3)) for x in (x_k, x_v))
    want_t = np.asarray(palu_flash_decode4(
        jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(xk_t), jnp.asarray(xv_t),
        jnp.asarray(kv_len), rk=rk, rv=rv, block_s=64, interpret=True,
        compute_dtype=jnp.float32, sliding_window=window, k_bias=jnp.asarray(k_bias)))
    t = torch.from_numpy
    got_t = palu_decode_fp_t(t(q), t(b_k), t(xk_t), t(xv_t), t(kv_len),
                             sliding_window=window, k_bias=t(k_bias)).numpy()
    _close(got_t, want_t, 1e-5)

    chunk = 64
    xk_j, xv_j = jnp.asarray(x_k), jnp.asarray(x_v)

    def jread(x):
        return lambda i: jax.lax.dynamic_slice_in_dim(x, i * chunk, chunk, axis=2)

    want = np.asarray(jattn.flash_decode_latent(
        jnp.asarray(q), jread(xk_j), jread(xv_j), jnp.asarray(b_k), s_max // chunk,
        chunk, jnp.asarray(kv_len), hd, 10000.0, rv, window, k_bias=jnp.asarray(k_bias)))
    got = palu_decode_fp(t(q), t(b_k), t(x_k), t(x_v), t(kv_len), sliding_window=window,
                         k_bias=t(k_bias)).numpy()
    _close(got, want, 1e-5)
    plain = flash_decode_latent(
        t(q), lambda i: t(x_k)[:, :, i * chunk:(i + 1) * chunk],
        lambda i: t(x_v)[:, :, i * chunk:(i + 1) * chunk], t(b_k), s_max // chunk, chunk,
        t(kv_len), hd, 10000.0, rv, window, k_bias=t(k_bias)).numpy()
    _close(plain, want, 1e-5)
    unbiased = palu_decode_fp(t(q), t(b_k), t(x_k), t(x_v), t(kv_len),
                              sliding_window=window).numpy()
    assert np.abs(got - unbiased).max() > 1e-2 * np.abs(want).max()


def test_decode_bias_shape_is_checked():
    q, b_k, x_k, x_v, k_bias = _inputs(1, 2, 4, 32, 64, 64, 64, seed=0)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        palu_decode_fp(t(q), t(b_k), t(x_k), t(x_v), torch.tensor([10]),
                       k_bias=t(k_bias[:, :2]))
