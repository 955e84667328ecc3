"""palu_tpu_torch.core.quant against palu_tpu.core.quant: codes, f32 scales
and zeros, and rank-major packed bytes must be bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jq
from palu_tpu_torch.core import quant as tq


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    # rows whose values sit on rounding ties and a constant row (1e-5 clamp)
    x[0, 0, 0] = np.linspace(-4.0, 4.0, 32, dtype=np.float32)
    x[0, 0, 1] = 0.5
    x[1, 2, 3] = 0.0
    return x


@pytest.mark.parametrize("bits,container", [(2, 0), (2, 4), (3, 0), (3, 4), (4, 0), (8, 0)])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("clip", [1.0, 0.9])
def test_quantize_and_pack_bit_identical(bits, container, sym, clip):
    x = _inputs(bits * 10 + container)
    kw = dict(bits=bits, group_size=0, sym=sym, clip_ratio=clip, container=container)
    jcfg, tcfg = jq.QuantConfig(**kw), tq.QuantConfig(**kw)
    jc, js, jz = jq.quantize_affine(jnp.asarray(x), jcfg)
    tc, ts, tz = tq.quantize_affine(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _bits_equal(ts.numpy(), js)
    _bits_equal(tz.numpy(), jz)

    pb = tcfg.pack_bits
    assert tq.packed_nrows(32, pb) == jq.packed_nrows(32, pb)
    jp = np.asarray(jq.pack_codes_t(jc, pb))
    tp = tq.pack_codes_t(tc, pb)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    back = tq.unpack_codes_t(tp, pb, 32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jq.unpack_codes_t(jnp.asarray(jp), pb, 32)))
    np.testing.assert_array_equal(back.numpy(), np.swapaxes(np.asarray(jc), -1, -2))


def test_quantize_per_chunk_scales_bit_identical():
    x = _inputs(7)
    kw = dict(bits=4, group_size=8, sym=False)
    jc, js, jz = jq.quantize_affine(jnp.asarray(x), jq.QuantConfig(**kw))
    tc, ts, tz = tq.quantize_affine(torch.from_numpy(x), tq.QuantConfig(**kw))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _bits_equal(ts.numpy(), js)
    _bits_equal(tz.numpy(), jz)


def test_quant_config_checks_match():
    with pytest.raises(ValueError):
        tq.QuantConfig(bits=4, container=2)
    with pytest.raises(ValueError):
        tq.QuantConfig(bits=3, container=3 + 3)
    assert tq.QuantConfig(bits=3, container=4).pack_bits == 4
    assert not tq.QuantConfig().enabled
    with pytest.raises(ValueError):
        tq.quantize_affine(torch.zeros(2, 8), tq.QuantConfig())
