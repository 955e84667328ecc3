"""The v4 decode's pos_offset, return_stats and layer_idx in the port's
plain versions (palu_decode_ref, palu_decode_fp_t_ref; palu_decode and
palu_decode_fp_t run them on CPU tensors) against the JAX kernels
palu_flash_decode4_quantized / palu_flash_decode4 in interpret mode at f32
compute, on the same caches.

Tolerance 1e-5 of max|ref| for acc, m and l, as tests/test_torch_decode.py
holds the plain decode: both sides compute in f32 and differ in summation
order and in the RoPE angles (JAX forms an offset block's angles in f32,
palu_decode4.py:743-751; at these positions that is below 1e-6). A shard
with no valid column must give m = -1e30 exactly, l = 0 and acc = 0. The
int8 modes at an offset are held at tests/test_torch_decode_int8.py's
2e-3. A layer of a stack must equal the per-layer call bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.models import rope as jrope
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4, palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp_t, palu_decode_fp_t_ref

TOL = 1e-5
INT8_TOL = 2e-3  # tests/test_torch_decode_int8.py
B, G, HPG, RK, RV, HD, S_LOCAL, BLOCK = 2, 2, 2, 32, 64, 64, 128, 64
# global kv_len per lane: at pos_offset 192 the second lane's shard holds no
# valid column (150 <= 192)
KV_LEN = (200, 150)


def _quant_bufs(rng, bits, sym, gs, container=0, s_max=S_LOCAL, lead=()):
    """A packed rank-major cache as JAX's engine stores it (numpy): codes
    (.., B, G, nrows, S), per-row scales (.., B, G, S) or per-chunk row
    stacks (.., B, G, n_sc, S)."""
    jq = jquant.QuantConfig(bits=bits, group_size=gs, sym=sym, container=container)
    bufs = {}
    for side, r in (("k", RK), ("v", RV)):
        x = rng.standard_normal(lead + (B, G, s_max, r)).astype(np.float32)
        codes, scales, zeros = jquant.quantize_affine(jnp.asarray(x), jq)
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes_t(codes, jq.pack_bits))
        rows = (lambda t: np.array(jnp.moveaxis(t, -1, -2))) if gs else (
            lambda t: np.array(t[..., 0]))
        bufs[f"x{side}_scale"] = rows(scales)
        if not sym:
            bufs[f"x{side}_zero"] = rows(zeros)
    return bufs, jq


def _qk(rng, bias=False):
    q = rng.standard_normal((B, G * HPG, HD)).astype(np.float32)
    b_k = (rng.standard_normal((G, HPG, RK, HD)) * 0.1).astype(np.float32)
    k_bias = (rng.standard_normal((G, HPG, HD)) * 0.3).astype(np.float32) if bias else None
    return q, b_k, k_bias


ORDER = ("xk_codes", "xk_scale", "xv_codes", "xv_scale")


def _jax_quant(q, b_k, bufs, jq, kvl, *, pos_offset, stats, k_bias=None, window=None,
               inv=None, scale=1.0, layer_idx=None, **knobs):
    out = palu_flash_decode4_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in ORDER), jnp.asarray(kvl),
        qcfg=jq, rk=RK, rv=RV, block_s=BLOCK, interpret=True, compute_dtype=jnp.float32,
        sliding_window=window, inv_freq_static=inv, rope_scale=scale,
        pos_offset=None if pos_offset is None else jnp.asarray(pos_offset, jnp.int32),
        return_stats=stats, k_bias=None if k_bias is None else jnp.asarray(k_bias),
        layer_idx=None if layer_idx is None else jnp.asarray(layer_idx, jnp.int32),
        **{k: v for k, v in bufs.items() if k.endswith("zero")}, **knobs)
    return tuple(np.asarray(o) for o in out) if stats else np.asarray(out)


def _port_quant(fn, q, b_k, bufs, tq, kvl, *, pos_offset, stats, k_bias=None, window=None,
                inv=None, scale=1.0, layer_idx=None, **knobs):
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    out = fn(torch.from_numpy(q), torch.from_numpy(b_k), kv_len=torch.from_numpy(kvl), **tb,
             qcfg=tq, rk=RK, rv=RV, block_s=BLOCK, sliding_window=window, inv_freq=inv,
             rope_scale=scale, pos_offset=pos_offset, return_stats=stats,
             k_bias=None if k_bias is None else torch.from_numpy(k_bias), layer_idx=layer_idx,
             **knobs)
    return tuple(o.numpy() for o in out) if stats else out.numpy()


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _close_stats(got, want, tol=TOL):
    """(acc, m, l) against JAX's: acc and l at tol of their max; m at tol
    of max|m| over the rows with a valid column, and exactly -1e30 (with
    l = 0 and acc = 0) on the rows without one."""
    (acc, m, l), (jacc, jm, jl) = got, want
    assert acc.shape == jacc.shape and m.shape == jm.shape == l.shape == jl.shape
    _close(acc, jacc, tol)
    _close(l, jl, tol)
    empty = jl == 0
    np.testing.assert_array_equal(l == 0, empty)
    assert np.all(m[empty] == np.float32(-1e30)) and np.all(acc[empty] == 0)
    assert np.all(np.isfinite(acc)) and np.all(np.isfinite(l))
    if (~empty).any():
        ok = ~empty
        assert np.abs(m[ok] - jm[ok]).max() <= tol * np.abs(jm[ok]).max()


OFFSETS = [0, 64, 192]
BITS_SYM = [(3, True), (3, False), (4, True), (4, False)]


@pytest.mark.parametrize("pos_offset", OFFSETS)
@pytest.mark.parametrize("bits,sym", BITS_SYM)
def test_stats_at_offset_match_jax(bits, sym, pos_offset):
    rng = np.random.default_rng(100 + 10 * bits + sym + pos_offset)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, bits, sym, 0)
    tq = QuantConfig(bits=bits, group_size=0, sym=sym)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=pos_offset, stats=True)
    n = palu_decode.launches
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=pos_offset, stats=True)
    assert palu_decode.launches == n  # CPU: the plain version
    _close_stats(got, want)
    if pos_offset == 192:  # the second lane's shard lies past its kv_len
        assert got[2][1].max() == 0 and np.all(got[1][1] == np.float32(-1e30))


@pytest.mark.parametrize("bits,sym", BITS_SYM)
def test_offset_without_stats_matches_jax(bits, sym):
    rng = np.random.default_rng(200 + 10 * bits + sym)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, bits, sym, 0, container=4 if bits == 3 else 0)
    tq = QuantConfig(bits=bits, group_size=0, sym=sym, container=4 if bits == 3 else 0)
    kvl = np.asarray((200, 170), np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=64, stats=False)
    got = _port_quant(palu_decode_ref, q, b_k, bufs, tq, kvl, pos_offset=64, stats=False)
    _close(got, want)


def test_stats_without_offset_normalise_to_the_decode():
    """acc / l of the stats is the normalised decode's output."""
    rng = np.random.default_rng(7)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 3, True, 0)
    tq = QuantConfig(bits=3, group_size=0, sym=True)
    kvl = np.asarray((100, 128), np.int32)
    acc, m, l = _port_quant(palu_decode_ref, q, b_k, bufs, tq, kvl, pos_offset=None,
                            stats=True)
    out = _port_quant(palu_decode_ref, q, b_k, bufs, tq, kvl, pos_offset=None, stats=False)
    _close(acc / l[..., None], out, 1e-6)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("pos_offset", [64, 192])
def test_per_chunk_stats_at_offset_match_jax(sym, pos_offset):
    rng = np.random.default_rng(300 + sym + pos_offset)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 4, sym, 8)
    tq = QuantConfig(bits=4, group_size=8, sym=sym)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=pos_offset, stats=True)
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=pos_offset, stats=True)
    _close_stats(got, want)


@pytest.mark.parametrize("sym", [True, False])
def test_k_bias_stats_at_offset_match_jax(sym):
    rng = np.random.default_rng(400 + sym)
    q, b_k, k_bias = _qk(rng, bias=True)
    bufs, jq = _quant_bufs(rng, 4, sym, 0)
    tq = QuantConfig(bits=4, group_size=0, sym=sym)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=64, stats=True, k_bias=k_bias)
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=64, stats=True,
                      k_bias=k_bias)
    _close_stats(got, want)


def _llama3():
    cfg = JModelConfig(rope_scaling={"rope_type": "llama3", "factor": 4.0,
                                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 16},
                       num_attention_heads=8, num_key_value_heads=8, hidden_size=8 * HD)
    inv, scale = jrope.inv_freq_and_scale(cfg)
    return tuple(float(f) for f in inv), float(scale)


def test_llama3_rope_stats_at_offset_match_jax():
    rng = np.random.default_rng(500)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 3, True, 0)
    tq = QuantConfig(bits=3, group_size=0, sym=True)
    kvl = np.asarray(KV_LEN, np.int32)
    inv, scale = _llama3()
    assert scale == 1.0 and inv != tuple(jrope.inv_freq_and_scale(
        JModelConfig(num_attention_heads=8, num_key_value_heads=8, hidden_size=8 * HD))[0])
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=128, stats=True, inv=inv, scale=scale)
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=128, stats=True,
                      inv=np.asarray(inv), scale=scale)
    _close_stats(got, want)


@pytest.mark.parametrize("pos_offset", [64, 128])
def test_sliding_window_stats_at_offset_match_jax(pos_offset):
    """A window of 100 from kv_len (200, 150): at offset 128 the second
    lane's window (49 .. 149) ends inside the shard, at 64 the first lane's
    (100 .. 199) starts inside it."""
    rng = np.random.default_rng(600 + pos_offset)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 4, False, 0)
    tq = QuantConfig(bits=4, group_size=0, sym=False)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=pos_offset, stats=True, window=100)
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=pos_offset, stats=True,
                      window=100)
    _close_stats(got, want)


@pytest.mark.parametrize("mode", ["int8_dots", "int8_rot"])
@pytest.mark.parametrize("sym", [True, False])
def test_int8_modes_stats_at_offset_match_jax(mode, sym):
    rng = np.random.default_rng(700 + sym + (mode == "int8_rot"))
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 3, sym, 0, container=4)
    tq = QuantConfig(bits=3, group_size=0, sym=sym, container=4)
    kvl = np.asarray((200, 180), np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=128, stats=True, **{mode: True})
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=128, stats=True,
                      **{mode: True})
    _close_stats(got, want, INT8_TOL)
    # the normalised output at the offset too
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=128, stats=False, **{mode: True})
    got = _port_quant(palu_decode_ref, q, b_k, bufs, tq, kvl, pos_offset=128, stats=False,
                      **{mode: True})
    _close(got, want, INT8_TOL)


L = 3


@pytest.mark.parametrize("bits,sym,gs", [(3, True, 0), (4, False, 0), (4, True, 8)])
def test_layer_idx_matches_jax_and_per_layer(bits, sym, gs):
    """An L = 3 stack (tests/test_pallas_decode4.py:173-206): each layer
    through layer_idx against JAX's layer_idx call, and bit for bit the
    port's per-layer call on that layer's buffers."""
    rng = np.random.default_rng(800 + bits + gs)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, bits, sym, gs, lead=(L,))
    tq = QuantConfig(bits=bits, group_size=gs, sym=sym)
    kvl = np.asarray((200, 77), np.int32)
    assert bufs["xk_scale"].shape[0] == L
    for li in range(L):
        want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=None, stats=False, layer_idx=li)
        got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=None, stats=False,
                          layer_idx=li)
        _close(got, want)
        one = {k: np.ascontiguousarray(v[li]) for k, v in bufs.items()}
        per_layer = _port_quant(palu_decode, q, b_k, one, tq, kvl, pos_offset=None,
                                stats=False)
        np.testing.assert_array_equal(got, per_layer)
    with pytest.raises(ValueError, match="layer_idx"):
        _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=None, stats=False,
                    layer_idx=L)


def test_layer_idx_with_offset_and_stats_matches_jax():
    """The three features in one call, as a seq-sharded stacked cache
    would run them."""
    rng = np.random.default_rng(900)
    q, b_k, _ = _qk(rng)
    bufs, jq = _quant_bufs(rng, 3, True, 0, lead=(L,))
    tq = QuantConfig(bits=3, group_size=0, sym=True)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_quant(q, b_k, bufs, jq, kvl, pos_offset=64, stats=True, layer_idx=1)
    got = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=64, stats=True,
                      layer_idx=1)
    _close_stats(got, want)


def _fp_lat(rng, lead=()):
    return (rng.standard_normal(lead + (B, G, RK, S_LOCAL)).astype(np.float32),
            rng.standard_normal(lead + (B, G, RV, S_LOCAL)).astype(np.float32))


def _jax_fp(q, b_k, xk, xv, kvl, *, pos_offset, stats, k_bias=None, layer_idx=None):
    out = palu_flash_decode4(
        jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(xk), jnp.asarray(xv), jnp.asarray(kvl),
        rk=RK, rv=RV, block_s=BLOCK, interpret=True, compute_dtype=jnp.float32,
        pos_offset=None if pos_offset is None else jnp.asarray(pos_offset, jnp.int32),
        return_stats=stats, k_bias=None if k_bias is None else jnp.asarray(k_bias),
        layer_idx=None if layer_idx is None else jnp.asarray(layer_idx, jnp.int32))
    return tuple(np.asarray(o) for o in out) if stats else np.asarray(out)


def _port_fp(fn, q, b_k, xk, xv, kvl, *, pos_offset, stats, k_bias=None, layer_idx=None):
    out = fn(torch.from_numpy(q), torch.from_numpy(b_k), torch.from_numpy(xk),
             torch.from_numpy(xv), torch.from_numpy(kvl), pos_offset=pos_offset,
             return_stats=stats, k_bias=None if k_bias is None else torch.from_numpy(k_bias),
             layer_idx=layer_idx)
    return tuple(o.numpy() for o in out) if stats else out.numpy()


@pytest.mark.parametrize("pos_offset", OFFSETS)
@pytest.mark.parametrize("bias", [False, True])
def test_fp_t_stats_at_offset_match_jax(pos_offset, bias):
    rng = np.random.default_rng(1000 + pos_offset + bias)
    q, b_k, k_bias = _qk(rng, bias)
    xk, xv = _fp_lat(rng)
    kvl = np.asarray(KV_LEN, np.int32)
    want = _jax_fp(q, b_k, xk, xv, kvl, pos_offset=pos_offset, stats=True, k_bias=k_bias)
    n = palu_decode_fp_t.launches
    got = _port_fp(palu_decode_fp_t, q, b_k, xk, xv, kvl, pos_offset=pos_offset, stats=True,
                   k_bias=k_bias)
    assert palu_decode_fp_t.launches == n
    _close_stats(got, want)
    want = _jax_fp(q, b_k, xk, xv, kvl, pos_offset=pos_offset if pos_offset < 192 else 0,
                   stats=False, k_bias=k_bias)
    got = _port_fp(palu_decode_fp_t_ref, q, b_k, xk, xv, kvl,
                   pos_offset=pos_offset if pos_offset < 192 else 0, stats=False,
                   k_bias=k_bias)
    _close(got, want)


def test_fp_t_layer_idx_matches_jax_and_per_layer():
    rng = np.random.default_rng(1100)
    q, b_k, _ = _qk(rng)
    xk, xv = _fp_lat(rng, (L,))
    kvl = np.asarray((200, 77), np.int32)
    for li in range(L):
        want = _jax_fp(q, b_k, xk, xv, kvl, pos_offset=None, stats=False, layer_idx=li)
        got = _port_fp(palu_decode_fp_t, q, b_k, xk, xv, kvl, pos_offset=None, stats=False,
                       layer_idx=li)
        _close(got, want)
        one = _port_fp(palu_decode_fp_t, q, b_k, np.ascontiguousarray(xk[li]),
                       np.ascontiguousarray(xv[li]), kvl, pos_offset=None, stats=False)
        np.testing.assert_array_equal(got, one)
    want = _jax_fp(q, b_k, xk, xv, kvl, pos_offset=64, stats=True, layer_idx=2)
    got = _port_fp(palu_decode_fp_t, q, b_k, xk, xv, kvl, pos_offset=64, stats=True,
                   layer_idx=2)
    _close_stats(got, want)


def test_shards_combine_to_the_unsharded_decode():
    """Four shards of a 512-column cache, each at its pos_offset with
    return_stats, merged with the flash-decoding combine, give the one-call
    decode over the whole cache."""
    rng = np.random.default_rng(1200)
    q, b_k, _ = _qk(rng)
    bufs, _ = _quant_bufs(rng, 3, False, 0, s_max=4 * S_LOCAL)
    tq = QuantConfig(bits=3, group_size=0, sym=False)
    kvl = np.asarray((300, 129), np.int32)
    whole = _port_quant(palu_decode, q, b_k, bufs, tq, kvl, pos_offset=None, stats=False)
    parts = []
    for r in range(4):
        sl = {k: np.ascontiguousarray(v[..., r * S_LOCAL:(r + 1) * S_LOCAL])
              for k, v in bufs.items()}
        parts.append(_port_quant(palu_decode, q, b_k, sl, tq, kvl, pos_offset=r * S_LOCAL,
                                 stats=True))
    m_g = np.max([p[1] for p in parts], axis=0)
    w = [np.exp(p[1] - m_g) for p in parts]
    l_g = sum(wi * p[2] for wi, p in zip(w, parts))
    acc_g = sum(wi[..., None] * p[0] for wi, p in zip(w, parts))
    _close(acc_g / l_g[..., None], whole)
