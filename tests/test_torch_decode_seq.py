"""palu_decode_seq_quantized (its plain version on the CPU) against the JAX
v1 kernel palu_flash_decode_quantized in interpret mode at f32 compute, on
the same seq-major packed caches, and with scaled RoPE (which that kernel
refuses) against JAX's XLA flash_decode_latent over its dequantize of the
same caches. Tolerance 1e-5 of max|ref|: both sides dequantize and compute
in f32 and differ only in summation order and in how the RoPE angles are
formed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops import attention as jattn
from palu_tpu.ops.pallas.palu_decode import palu_flash_decode_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.models import rope as rope_mod
from palu_tpu_torch.models.config import ModelConfig
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
              sym=True, window=None, seed=0, inv_freq=None, rope_scale=1.0):
    q, b_k, bufs, kvl, jq = _case(b, g, hpg, rk, rv, hd, s_max, kv_len, bits, sym, seed)
    if inv_freq is None:
        want = np.asarray(palu_flash_decode_quantized(
            jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in ORDER), jnp.asarray(kvl),
            qcfg=jq, rk=rk, rv=rv, block_s=64, interpret=True, compute_dtype=jnp.float32,
            sliding_window=window, rope_scale=rope_scale))
    else:  # JAX's v1 kernel refuses inv_freq tables: its XLA decode path
        want = _jax_xla_decode(q, b_k, bufs, kvl, jq, rk, rv, window, inv_freq, rope_scale)
    launches = palu_decode_seq_quantized.launches
    got = palu_decode_seq_quantized(
        torch.from_numpy(q), torch.from_numpy(b_k), *(torch.from_numpy(bufs[k]) for k in ORDER),
        torch.from_numpy(kvl), qcfg=QuantConfig(bits=bits, group_size=0, sym=sym), rk=rk, rv=rv,
        sliding_window=window, inv_freq=inv_freq, rope_scale=rope_scale)
    assert palu_decode_seq_quantized.launches == launches  # CPU: plain version
    return got.numpy(), want


def _jax_xla_decode(q, b_k, bufs, kvl, jq, rk, rv, window, inv_freq, rope_scale):
    """JAX's flash_decode_latent over its dequantize of the seq-major cache,
    in 64-position chunks (what the JAX v1 kernel's NotImplementedError
    for scaled-RoPE tables points to)."""
    chunk, s_max = 64, bufs["xk_codes"].shape[2]

    def reader(side, rank):
        codes, scales, base = (jnp.asarray(bufs[f"x{side}_{k}"]) for k in
                               ("codes", "scales", "base"))

        def read(i):
            sl = [jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk, axis=2)
                  for a in (codes, scales, base)]
            return jquant.dequantize(jquant.unpack_codes(sl[0], jq.pack_bits, rank), sl[1],
                                     sl[2], jq, dtype=jnp.float32)
        return read

    return np.asarray(jattn.flash_decode_latent(
        jnp.asarray(q), reader("k", rk), reader("v", rv), jnp.asarray(b_k), s_max // chunk,
        chunk, jnp.asarray(kvl), q.shape[-1], 10000.0, rv, window,
        inv_freq=jnp.asarray(inv_freq), rope_scale=rope_scale))


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


ROPE_SCALING = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64},
}


@pytest.mark.parametrize("scaling", list(ROPE_SCALING))
@pytest.mark.parametrize("sym", [True, False])
def test_decode_seq_scaled_rope_matches_jax_kernel(scaling, sym):
    """Scaled RoPE (llama3; yarn, whose attention scale is not 1) in the
    seq-major decode, against JAX's XLA decode path over the same cache
    (its v1 kernel takes rope_scale but refuses inv_freq tables)."""
    inv_freq, scale = rope_mod.inv_freq_and_scale(
        ModelConfig(hidden_size=256, num_attention_heads=4, num_key_value_heads=4,
                    rope_scaling=ROPE_SCALING[scaling]))
    assert (scale != 1.0) == (scaling == "yarn")
    _close(*_run_both(b=2, kv_len=(150, 256), bits=3, sym=sym, seed=21,
                      inv_freq=np.asarray(inv_freq, np.float32), rope_scale=float(scale)))


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
           dict(ok, rk=16)]                                       # wrong rank
    for kw in bad:
        with pytest.raises(ValueError):
            palu_decode_seq_quantized_ref(*args, **kw)
    with pytest.raises(ValueError):  # scales without their unit axis
        palu_decode_seq_quantized_ref(*args[:3], args[3][..., 0], *args[4:], **ok)
