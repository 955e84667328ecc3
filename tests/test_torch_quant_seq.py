"""The port's seq-major quantization (quantize, dequantize, pack_codes,
unpack_codes, packed_nbytes, fake_quantize) against palu_tpu.core.quant on
the same numpy inputs: bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu_torch.core import quant as tquant

CONFIGS = [dict(bits=b, sym=s, group_size=gs, clip_ratio=c)
           for b in (2, 3, 4, 8) for s in (True, False) for gs, c in ((0, 1.0), (16, 1.0), (0, 0.9))]


def _x(seed, shape=(2, 3, 40, 64)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row hits the 1e-5 scale clamp
    return x


def _same(got: torch.Tensor, want) -> None:
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_quantize_dequantize_bit_exact(kw):
    x = _x(kw["bits"] * 7 + kw["group_size"])
    jc, tc = jquant.QuantConfig(**kw), tquant.QuantConfig(**kw)
    codes, scales, base = jquant.quantize(jnp.asarray(x), jc)
    t_codes, t_scales, t_base = tquant.quantize(torch.from_numpy(x), tc)
    _same(t_codes, codes)
    _same(t_scales, scales)
    _same(t_base, base)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jquant.dequantize(codes, scales, base, jc, dtype=jd)
        got = tquant.dequantize(t_codes, t_scales, t_base, tc, dtype=td)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    _same(tquant.fake_quantize(torch.from_numpy(x), tc), jquant.fake_quantize(jnp.asarray(x), jc))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_pack_unpack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    n = 64
    codes = rng.integers(0, 2**bits, (3, 5, n)).astype(np.uint8)
    packed = jquant.pack_codes(jnp.asarray(codes), bits)
    t_packed = tquant.pack_codes(torch.from_numpy(codes), bits)
    _same(t_packed, packed)
    assert t_packed.shape[-1] == tquant.packed_nbytes(n, bits) == jquant.packed_nbytes(n, bits)
    unpacked = tquant.unpack_codes(t_packed, bits, n)
    _same(unpacked, jquant.unpack_codes(packed, bits, n))
    np.testing.assert_array_equal(unpacked.numpy(), codes)


def test_quantize_then_pack_round_trip():
    """The seq-major cache write path: quantize -> pack -> unpack ->
    dequantize gives fake_quantize's values."""
    x = torch.from_numpy(_x(5))
    cfg = tquant.QuantConfig(bits=3, sym=False)
    codes, scales, base = tquant.quantize(x, cfg)
    back = tquant.unpack_codes(tquant.pack_codes(codes, 3), 3, x.shape[-1])
    got = tquant.dequantize(back, scales, base, cfg, dtype=torch.float32)
    torch.testing.assert_close(got, tquant.fake_quantize(x, cfg), rtol=0, atol=1e-6)


def test_bad_widths_raise():
    with pytest.raises(ValueError):
        tquant.packed_nbytes(64, 5)
    with pytest.raises(ValueError):
        tquant.pack_codes(torch.zeros((2, 6), dtype=torch.uint8), 2)  # 6 % 4
    with pytest.raises(ValueError):
        tquant.unpack_codes(torch.zeros((2, 8), dtype=torch.uint8), 6, 8)
    with pytest.raises(ValueError):
        tquant.quantize(torch.zeros((2, 8)), tquant.QuantConfig(bits=16))
    assert tquant.fake_quantize(torch.ones(3), tquant.QuantConfig(bits=16)).equal(torch.ones(3))
