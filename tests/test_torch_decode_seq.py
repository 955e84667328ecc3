"""palu_decode_seq_quantized (its plain version on the CPU) against the JAX
v1 kernel palu_flash_decode_quantized in interpret mode at f32 compute, on
the same seq-major packed caches. Tolerance 1e-5 of max|ref|: both sides
dequantize and compute in f32 and differ only in summation order and in
how the RoPE angles are formed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops.pallas.palu_decode import palu_flash_decode_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode_seq import (palu_decode_seq_quantized,
                                                palu_decode_seq_quantized_ref)

TOL = 1e-5


def _case(b, g, hpg, rk, rv, hd, s_max, kv_len, bits, sym, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    jq = jquant.QuantConfig(bits=bits, group_size=0, sym=sym)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = rng.standard_normal((b, g, s_max, r)).astype(np.float32)
        codes, scales, base = jquant.quantize(jnp.asarray(x), jq)
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes(codes, bits))
        bufs[f"x{side}_scales"] = np.array(scales)
        bufs[f"x{side}_base"] = np.array(base)
    return q, b_k, bufs, np.asarray(kv_len, np.int32), jq


ORDER = ("xk_codes", "xk_scales", "xk_base", "xv_codes", "xv_scales", "xv_base")


def _run_both(b=1, g=2, hpg=4, rk=32, rv=64, hd=64, s_max=256, kv_len=(200,), bits=4,
              sym=True, window=None, seed=0):
    q, b_k, bufs, kvl, jq = _case(b, g, hpg, rk, rv, hd, s_max, kv_len, bits, sym, seed)
    want = np.asarray(palu_flash_decode_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in ORDER), jnp.asarray(kvl),
        qcfg=jq, rk=rk, rv=rv, block_s=64, interpret=True, compute_dtype=jnp.float32,
        sliding_window=window))
    launches = palu_decode_seq_quantized.launches
    got = palu_decode_seq_quantized(
        torch.from_numpy(q), torch.from_numpy(b_k), *(torch.from_numpy(bufs[k]) for k in ORDER),
        torch.from_numpy(kvl), qcfg=QuantConfig(bits=bits, group_size=0, sym=sym), rk=rk, rv=rv,
        sliding_window=window)
    assert palu_decode_seq_quantized.launches == launches  # CPU: plain version
    return got.numpy(), want


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_decode_seq_matches_jax_kernel(bits, sym):
    _close(*_run_both(bits=bits, sym=sym, seed=bits))


@pytest.mark.parametrize("sym", [True, False])
def test_decode_seq_ragged_lanes(sym):
    _close(*_run_both(b=2, kv_len=(1, 177), bits=3, sym=sym, seed=11))


@pytest.mark.parametrize("sym", [True, False])
def test_decode_seq_sliding_window(sym):
    _close(*_run_both(b=2, g=3, kv_len=(100, 256), bits=3, sym=sym, window=50, seed=4))


def test_decode_seq_gqa_shared_b():
    """GQA: hpg = 16 q-heads per group share their kv head's block of b_k."""
    _close(*_run_both(g=1, hpg=16, kv_len=(130,), bits=4, seed=9))


def test_decode_seq_rejects_bad_input():
    q, b_k, bufs, kvl, _ = _case(1, 2, 4, 32, 64, 64, 128, (10,), 4, True, 0)
    args = (torch.from_numpy(q), torch.from_numpy(b_k),
            *(torch.from_numpy(bufs[k]) for k in ORDER), torch.from_numpy(kvl))
    ok = dict(qcfg=QuantConfig(bits=4, sym=True), rk=32, rv=64)
    palu_decode_seq_quantized_ref(*args, **ok)
    bad = [dict(ok, qcfg=QuantConfig(bits=8, sym=True)),          # no 8-bit unpack
           dict(ok, qcfg=QuantConfig(bits=4, group_size=16)),     # per-chunk scales
           dict(ok, rk=16),                                       # wrong rank
           dict(ok, inv_freq=np.ones(32, np.float32))]            # scaled RoPE
    for kw in bad:
        with pytest.raises(ValueError):
            palu_decode_seq_quantized_ref(*args, **kw)
    with pytest.raises(ValueError):  # scales without their unit axis
        palu_decode_seq_quantized_ref(*args[:3], args[3][..., 0], *args[4:], **ok)
