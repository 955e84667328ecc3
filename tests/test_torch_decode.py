"""palu_decode (its plain version on the CPU) against the JAX decode kernel
palu_flash_decode4_quantized in interpret mode at f32 compute, on the same
packed caches. Tolerance 1e-5 of max|ref|: both sides compute in f32 and
differ only in summation order and in how the RoPE angles are formed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref

TOL = 1e-5


def _case(b, g, hpg, rk, rv, hd, s_max, kv_len, bits, container, sym, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    x_k = rng.standard_normal((b, g, s_max, rk)).astype(np.float32)
    x_v = rng.standard_normal((b, g, s_max, rv)).astype(np.float32)
    jq = jquant.QuantConfig(bits=bits, group_size=0, sym=sym, container=container)
    kc, ks, kz = jquant.quantize_affine(jnp.asarray(x_k), jq)
    vc, vs, vz = jquant.quantize_affine(jnp.asarray(x_v), jq)
    bufs = dict(
        xk_codes=np.asarray(jquant.pack_codes_t(kc, jq.pack_bits)),
        xk_scale=np.asarray(ks[..., 0]),
        xv_codes=np.asarray(jquant.pack_codes_t(vc, jq.pack_bits)),
        xv_scale=np.asarray(vs[..., 0]),
    )
    if not sym:
        bufs.update(xk_zero=np.asarray(kz[..., 0]), xv_zero=np.asarray(vz[..., 0]))
    kvl = np.asarray(kv_len, np.int32)
    return q, b_k, bufs, kvl, jq


def _run_both(b=1, g=2, hpg=4, rk=32, rv=64, hd=64, s_max=256, kv_len=(200,), bits=4,
              container=0, sym=True, window=None, seed=0):
    q, b_k, bufs, kvl, jq = _case(b, g, hpg, rk, rv, hd, s_max, kv_len, bits,
                                  container, sym, seed)
    want = np.asarray(palu_flash_decode4_quantized(
        jnp.asarray(q), jnp.asarray(b_k), bufs["xk_codes"], bufs["xk_scale"],
        bufs["xv_codes"], bufs["xv_scale"], jnp.asarray(kvl), qcfg=jq, rk=rk, rv=rv,
        block_s=64, interpret=True, compute_dtype=jnp.float32, sliding_window=window,
        **{k: v for k, v in bufs.items() if k.endswith("zero")}))
    tq = QuantConfig(bits=bits, group_size=0, sym=sym, container=container)
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    launches = palu_decode.launches
    got = palu_decode(torch.from_numpy(q), torch.from_numpy(b_k), tb["xk_codes"],
                      tb["xk_scale"], tb["xv_codes"], tb["xv_scale"],
                      torch.from_numpy(kvl), qcfg=tq, rk=rk, rv=rv, sliding_window=window,
                      xk_zero=tb.get("xk_zero"), xv_zero=tb.get("xv_zero"))
    assert palu_decode.launches == launches  # CPU: plain version
    return got.numpy(), want


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,container", [(3, 0), (4, 0), (3, 4)])
def test_decode_matches_jax_kernel(bits, container, sym):
    got, want = _run_both(bits=bits, container=container, sym=sym, seed=bits + container)
    _close(got, want)


@pytest.mark.parametrize("sym", [True, False])
def test_decode_ragged_lanes_and_single_token(sym):
    got, want = _run_both(b=2, kv_len=(1, 177), bits=3, container=4, sym=sym, seed=11)
    _close(got, want)


@pytest.mark.parametrize("sym", [True, False])
def test_decode_sliding_window(sym):
    got, want = _run_both(b=2, g=3, kv_len=(100, 256), bits=3, sym=sym, window=50, seed=4)
    _close(got, want)


def test_decode_gqa_shared_b():
    """GQA: hpg = 16 q-heads per group share their kv head's block of b_k."""
    got, want = _run_both(g=1, hpg=16, kv_len=(130,), bits=4, seed=9)
    _close(got, want)


def test_decode_rejects_bad_input():
    q, b_k, bufs, kvl, _ = _case(1, 2, 4, 32, 64, 64, 128, (10,), 4, 0, True, 0)
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    args = (torch.from_numpy(q), torch.from_numpy(b_k), tb["xk_codes"], tb["xk_scale"],
            tb["xv_codes"], tb["xv_scale"], torch.from_numpy(kvl))
    with pytest.raises(ValueError):  # asymmetric config without zero rows
        palu_decode_ref(*args, qcfg=QuantConfig(bits=4, sym=False), rk=32, rv=64)
    with pytest.raises(ValueError):  # wrong rank
        palu_decode_ref(*args, qcfg=QuantConfig(bits=4, sym=True), rk=16, rv=64)
