"""The int8 K-path modes of palu_decode (their plain version on the CPU)
against the JAX kernel palu_flash_decode4_quantized(int8_dots= / int8_rot=)
in interpret mode at f32 compute, on the same packed caches.

Tolerance 2e-3 of max|ref|: both sides quantize the query-folded operand
to int8 with round-half-even, but their f32 products are formed in
another order, so a value on a rounding tie may take the neighbouring
code on one side; one such flip moves a logit by one operand step
(max|operand| / 127 times a code). Each mode is also held against the
exact plain version at the JAX tests' own class (atol 4e-2 / 8e-2,
tests/test_pallas_decode4.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import k_path_mode, palu_decode, palu_decode_ref

TOL = 2e-3
CLASS = {"int8_dots": (4e-2, 2e-2), "int8_rot": (8e-2, 4e-2)}  # (atol, rtol) vs exact


def _case(b, g, hpg, rk, rv, hd, s_max, bits, container, sym, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    jq = jquant.QuantConfig(bits=bits, group_size=0, sym=sym, container=container)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = rng.standard_normal((b, g, s_max, r)).astype(np.float32)
        codes, scales, zeros = jquant.quantize_affine(jnp.asarray(x), jq)
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes_t(codes, jq.pack_bits))
        bufs[f"x{side}_scale"] = np.array(scales[..., 0])
        if not sym:
            bufs[f"x{side}_zero"] = np.array(zeros[..., 0])
    return q, b_k, bufs, jq


def _run(mode, *, b=2, g=2, hpg=4, rk=32, rv=64, hd=64, s_max=256, kv_len=(200, 256),
         bits=3, container=4, sym=True, window=None, block_s=64, seed=0):
    q, b_k, bufs, jq = _case(b, g, hpg, rk, rv, hd, s_max, bits, container, sym, seed)
    kvl = np.asarray(kv_len, np.int32)
    jax_kw = dict(qcfg=jq, rk=rk, rv=rv, block_s=block_s, interpret=True,
                  compute_dtype=jnp.float32, sliding_window=window,
                  **{k: v for k, v in bufs.items() if k.endswith("zero")})
    order = ("xk_codes", "xk_scale", "xv_codes", "xv_scale")
    want = np.asarray(palu_flash_decode4_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in order), jnp.asarray(kvl),
        **jax_kw, **{mode: True}))
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    kw = dict(qcfg=QuantConfig(bits=bits, group_size=0, sym=sym, container=container), rk=rk,
              rv=rv, sliding_window=window, block_s=block_s)
    args = (torch.from_numpy(q), torch.from_numpy(b_k))
    n = palu_decode.launches
    got = palu_decode(*args, kv_len=torch.from_numpy(kvl), **tb, **kw, **{mode: True})
    assert palu_decode.launches == n  # CPU: plain version
    exact = palu_decode_ref(*args, kv_len=torch.from_numpy(kvl), **tb, **kw)
    return got.numpy(), want, exact.numpy()


def _check(mode, got, want, exact):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    atol, rtol = CLASS[mode]
    assert np.allclose(got, exact, atol=atol, rtol=rtol), np.abs(got - exact).max()
    assert np.abs(got - exact).max() > 0  # the mode really quantized the operand


@pytest.mark.parametrize("mode", ["int8_dots", "int8_rot"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("block_s", [64, 128])
def test_int8_modes_match_jax_kernel(mode, sym, block_s):
    _check(mode, *_run(mode, sym=sym, block_s=block_s, seed=block_s + sym))


@pytest.mark.parametrize("mode", ["int8_dots", "int8_rot"])
def test_int8_modes_window_and_widths(mode):
    _check(mode, *_run(mode, g=3, kv_len=(150, 230), window=70, bits=4, container=0, seed=3))
    _check(mode, *_run(mode, kv_len=(1, 77), bits=2, container=0, sym=False, seed=4))


def test_block_size_changes_the_int8_result():
    """The operand scales and tables are per rotation block: another block
    size gives another (equally valid) result; the exact mode ignores it."""
    a, _, exact_a = _run("int8_rot", block_s=64, seed=5)
    b, _, exact_b = _run("int8_rot", block_s=128, seed=5)
    assert np.abs(a - b).max() > 0
    np.testing.assert_array_equal(exact_a, exact_b)


def test_knobs_validated_as_jax():
    qc = QuantConfig(bits=3, sym=True, container=4)
    assert k_path_mode(qc, 128, 128) == "exact"
    assert k_path_mode(qc, 128, 128, int8_dots=True, int8_rot=True) == "int8_rot"
    assert k_path_mode(qc, 128, 128, int8_dots=True) == "int8_dots"
    assert k_path_mode(QuantConfig(bits=3, sym=True), 128, 128, int8_rot=True) == "int8_rot"
    for kw in (dict(int8_dots=True), dict(int8_rot=True)):
        with pytest.raises(ValueError):  # 8-bit codes do not fit the int8 dots
            k_path_mode(QuantConfig(bits=8, sym=True), 128, 128, **kw)
    with pytest.raises(ValueError):  # int32 segment sums would overflow
        k_path_mode(qc, 256, 256, int8_rot=True)
    q, b_k, bufs, _ = _case(1, 2, 4, 32, 64, 64, 256, 3, 4, True, 0)
    with pytest.raises(ValueError):  # block_s must divide S
        palu_decode_ref(torch.from_numpy(q), torch.from_numpy(b_k),
                        kv_len=torch.tensor([10], dtype=torch.int32),
                        **{k: torch.from_numpy(v) for k, v in bufs.items()},
                        qcfg=QuantConfig(bits=3, sym=True, container=4), rk=32, rv=64,
                        block_s=96, int8_dots=True)
