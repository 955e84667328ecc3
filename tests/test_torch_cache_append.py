"""The port's append (plain version on the CPU) and cache writes against
the JAX package: byte-identical buffers, masked no-op lanes included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.ops.pallas.cache_append import (
    append_supported as j_append_supported, append_token_quantized as j_append)
from palu_tpu.runtime import cache as jcache
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.cache_append import (
    append_supported, append_token_quantized, append_token_quantized_ref)
from palu_tpu_torch.runtime import cache as tcache


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_bufs_equal(tbufs, jbufs):
    assert set(tbufs) == set(jbufs)
    for k in jbufs:
        want = np.asarray(jbufs[k])
        got = tbufs[k].numpy().reshape(want.shape)
        if want.dtype == np.float32:
            got, want = got.view(np.uint32), want.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,container,clip", [(4, 0, 1.0), (3, 4, 1.0), (2, 0, 1.0),
                                                 (8, 0, 1.0), (3, 4, 0.9)])
def test_plain_append_matches_jax_kernel(bits, container, clip, sym):
    kw = dict(bits=bits, group_size=0, sym=sym, container=container, clip_ratio=clip)
    jq, tq = JQuantConfig(**kw), QuantConfig(**kw)
    assert append_supported(tq) and j_append_supported(jq)
    b, g, rank, s_max = 3, 2, 32, 256
    rng = np.random.default_rng(bits + 10 * container)
    lat0 = rng.standard_normal((b, g, s_max, rank)).astype(np.float32)
    jbufs = jcache._encode(jnp.asarray(lat0), jq, jnp.float32)
    lat = rng.standard_normal((b, g, rank)).astype(np.float32)
    pos = np.array([0, 100, 255], np.int32)
    wr = np.array([True, True, False])  # lane 2 must keep its bytes

    want = j_append(jnp.asarray(lat), jbufs["codes_t"], jbufs["scale_t"],
                    jnp.asarray(pos), jnp.asarray(wr), qcfg=jq, rank=rank,
                    zero=None if sym else jbufs["zero_t"], interpret=True)
    tbufs = {k: _t(v) for k, v in jbufs.items()}
    before = tbufs["codes_t"].clone()
    launches = append_token_quantized.launches
    got = append_token_quantized(_t(lat), tbufs["codes_t"], tbufs["scale_t"],
                                 _t(pos), _t(wr), qcfg=tq, rank=rank,
                                 zero=tbufs.get("zero_t"))
    assert append_token_quantized.launches == launches  # CPU: plain version
    assert got[0] is tbufs["codes_t"]  # in place
    names = ["codes_t", "scale_t"] + ([] if sym else ["zero_t"])
    _assert_bufs_equal(tbufs, dict(zip(names, want)))
    assert torch.equal(tbufs["codes_t"][2], before[2])


def test_append_supported_matches_jax():
    for kw in (dict(bits=3, group_size=0, sym=True), dict(bits=3, container=4, sym=True),
               dict(bits=4, group_size=8, sym=True), dict(bits=2), dict(bits=8),
               dict()):
        assert append_supported(QuantConfig(**kw)) == j_append_supported(JQuantConfig(**kw))
    assert not append_supported(None)


def test_append_rejects_bad_input():
    q = QuantConfig(bits=4, sym=True)
    codes = torch.zeros((1, 2, 16, 8), dtype=torch.uint8)
    scale = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError):  # zero given for a symmetric config
        append_token_quantized_ref(torch.zeros(1, 2, 32), codes, scale,
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.bool), qcfg=q, rank=32,
                                   zero=scale)
    with pytest.raises(ValueError):  # exact 3-bit packing is not the kernel's
        append_token_quantized_ref(torch.zeros(1, 2, 32), codes, scale,
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.bool),
                                   qcfg=QuantConfig(bits=3, sym=True), rank=32)


@pytest.mark.parametrize("kw", [dict(bits=3, sym=True, container=4),
                                dict(bits=3, sym=True), dict(bits=4, sym=False)])
def test_cache_after_prefill_and_decode_steps_matches_jax(kw):
    """_encode + write_at_lanes for a prefill, then per-step appends
    (kernel-eligible configs through append_token_quantized, exact 3-bit
    through _encode + write_at_lanes_masked) with idle and full lanes."""
    jq, tq = JQuantConfig(group_size=0, **kw), QuantConfig(group_size=0, **kw)
    b, g, rank, s_max, n0 = 3, 2, 32, 64, 40
    rng = np.random.default_rng(5)
    jb = {k: jnp.zeros(v.shape, v.dtype) for k, v in
          jcache._layer_buffers(b, g, s_max, rank, jnp.float32, jq).items()}
    tb = tcache._layer_buffers(b, g, s_max, rank, tq, "cpu")
    lat = rng.standard_normal((b, g, n0, rank)).astype(np.float32)
    off = np.zeros((b,), np.int32)
    jb = jcache.write_at_lanes(jb, jcache._encode(jnp.asarray(lat), jq, jnp.float32),
                               jnp.asarray(off))
    tcache.write_at_lanes(tb, tcache._encode(_t(lat), tq), _t(off))
    _assert_bufs_equal(tb, jb)

    length = np.array([n0, n0 - 7, s_max], np.int32)  # lane 2 is full
    for step in range(6):
        active = np.array([True, step % 2 == 0, True])
        writeable = active & (length < s_max)
        pos_w = np.minimum(length, s_max - 1)
        tok = rng.standard_normal((b, g, 1, rank)).astype(np.float32)
        jb = jcache.write_at_lanes_masked(
            jb, jcache._encode(jnp.asarray(tok), jq, jnp.float32),
            jnp.asarray(pos_w), jnp.asarray(writeable))
        if append_supported(tq):
            append_token_quantized(_t(tok[:, :, 0]), tb["codes_t"], tb["scale_t"],
                                   _t(pos_w), _t(writeable), qcfg=tq, rank=rank,
                                   zero=tb.get("zero_t"))
        else:
            tcache.write_at_lanes_masked(tb, tcache._encode(_t(tok), tq), _t(pos_w),
                                         _t(writeable))
        length = np.where(writeable, length + 1, length)
    _assert_bufs_equal(tb, jb)
    lat_t = tcache.decode_latents(tb, tq, rank, torch.float32).numpy()
    lat_j = np.asarray(jcache.decode_latents(jb, jq, rank, jnp.float32))
    np.testing.assert_array_equal(lat_t, lat_j)
