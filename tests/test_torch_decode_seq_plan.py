"""The seq-major packed decode's kernel (csrc/palu_decode_fp_wg.cu,
palu_decode_seq_wg_kernel) as the pure Python functions that mirror it
(ops/palu_decode_seq.py): the shared-memory plan (_seq_plan: ring chunks, B
slots, packed stages) and its launch checks, the unpack of the packed
bytes into the bf16 operand (unit_entry / unpack_units below, numpy
mirrors of the kernel's unit_entry / unpack_chunk) against JAX's
core/quant.unpack_codes bit for bit, and the kernel's arithmetic (exact
operand code + q_min, the per-token scale and -base on the accumulators)
against JAX's palu_flash_decode_quantized in interpret mode at f32. Also
the archived v2 packed decode's mapping onto palu_decode's exact mode (per-row
asym rows, no offset, v2's f32 frequencies), whose plain version
(palu_decode_ref) is held against JAX's palu_flash_decode2_quantized. The
card's test (test_torch_kernels_cuda.py) holds the kernel's own plan against
_seq_plan."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.ops.pallas.archive.palu_decode2 import palu_flash_decode2_quantized
from palu_tpu.ops.pallas.palu_decode import palu_flash_decode_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.archive.palu_decode2 import v2_inv_freq
from palu_tpu_torch.ops.palu_decode import _SMEM_BUDGET, palu_decode_ref
from palu_tpu_torch.ops.palu_decode_seq import _CHUNK, _seq_launch_plan, _seq_plan
from test_torch_decode_seq import ORDER, _case

SMEM_MAX = 232448  # the most shared memory one block may use
TOL = 1e-5
RANKS = range(32, 513, 32)


def unit_entry(r: int, c: int, u: int, pbits: int) -> tuple:
    """The kernel's unit table entry (unit_entry) of 8-rank unit u of
    128-rank chunk c of a side with r ranks: (x, y) as uint32, x = ~0 past
    r, else the main plane's byte j0 | its field's shift << 16; y (3-bit):
    the 1-bit plane's byte | its bit << 10 for ranks r0 .. r0 + 3, the same
    << 16 for r0 + 4 .. r0 + 7."""
    r0 = c * _CHUNK + 8 * u
    if r0 >= r:
        return 0xFFFFFFFF, 0
    pw = 2 if pbits == 3 else pbits
    wpl = r // (8 // pw)
    k = r0 // wpl
    x = (r0 - k * wpl) | ((pw * k) << 16)
    y = 0
    if pbits == 3:
        w1 = r // 8
        for h in range(2):
            rq = r0 + 4 * h
            y |= ((wpl + rq % w1) | ((rq // w1) << 10)) << (16 * h)
    return x, y


def unpack_units(rows: np.ndarray, r: int, pbits: int, qmin: int) -> np.ndarray:
    """The kernel's unpack (unpack_chunk) in numpy: packed rows (T, nbytes)
    uint8 -> (T, r) bf16 operand values as f32, code + q_min, each 8-rank
    unit from its table entry: two little-endian words of the main plane
    shifted and masked per byte, the 1-bit plane's bits << 2 for 3-bit,
    then the bf16 0x4300 | code (128 + code) less 128 - q_min."""
    out = np.zeros((rows.shape[0], r), np.float32)
    mask = 0x0F0F0F0F if pbits == 4 else 0x03030303
    words = rows.astype(np.uint32)

    def word(off):  # the little-endian word at byte off of every row
        return (words[:, off] | words[:, off + 1] << 8 | words[:, off + 2] << 16
                | words[:, off + 3] << 24)

    for c in range(-(-r // _CHUNK)):
        for u in range(16):
            x, y = unit_entry(r, c, u, pbits)
            if x == 0xFFFFFFFF:
                continue
            j0, sh = x & 0xFFFF, x >> 16
            cw = [(word(j0) >> sh) & mask, (word(j0 + 4) >> sh) & mask]
            if pbits == 3:
                for h in range(2):
                    e = y >> (16 * h)
                    cw[h] = cw[h] | ((word(e & 0x3FF) >> ((e >> 10) & 7)) & 0x01010101) << 2
            for h in range(2):
                for i in range(4):
                    bits = (0x4300 | ((cw[h] >> (8 * i)) & 0xFF)).astype(np.uint32) << 16
                    out[:, c * _CHUNK + 8 * u + 4 * h + i] = \
                        bits.view(np.float32) - np.float32(128 - qmin)
    return out


def _check_plan(plan, rk, rv):
    assert plan is not None
    assert plan["smem"] <= SMEM_MAX and plan["smem"] - 1024 <= _SMEM_BUDGET
    # the ring holds one side's chunks (the consumers wait for them at once)
    assert plan["ns"] >= max(-(-rk // 128), -(-rv // 128)) and plan["ns"] <= 8
    assert 1 <= plan["npk"] <= 2 and 1 <= plan["nb"] <= 8


@pytest.mark.parametrize("pbits", [2, 3, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_plan_fits_every_accepted_shape(hd, pbits):
    """Every shape the wrapper accepts (rk and rv 32-512 in steps of 32,
    1-32 heads per group) has a plan within a block's shared memory, whose
    ring holds a side's chunks; the launch check returns it."""
    for rk in RANKS:
        for rv in RANKS:
            for hpg in range(1, 33):
                plan = _seq_plan(hd, rk, rv, hpg, pbits)
                _check_plan(plan, rk, rv)
                assert plan["nt"] == (2 if hpg > 16 else 1)
    assert _seq_launch_plan(hd, 128, 384, 4, pbits, 8192) == _seq_plan(hd, 128, 384, 4, pbits)


def test_plan_at_the_main_shapes():
    """The Llama-2-7B group (4 heads, rk 128, rv 384, 3-bit) keeps B
    resident (128 KB) beside a ring of one whole tile (4 chunks) and one
    packed stage, all 128 producer threads unpacking; rk 256 streams B
    through 2 slots a consumer from threads of their own, 64 unpacking;
    Qwen2-7B's
    28 heads at rk 256 take two 8-head tiles per consumer."""
    llama = _seq_plan(128, 128, 384, 4, 3)
    assert (llama["resident"], llama["ns"], llama["nb"], llama["npk"], llama["nt"],
            llama["unpackers"]) == (1, 4, 2, 1, 1, 128)
    rk256 = _seq_plan(128, 256, 384, 4, 3)
    assert (rk256["resident"], rk256["nb"], rk256["unpackers"]) == (0, 2, 64)
    assert _seq_plan(128, 256, 256, 28, 3)["nt"] == 2
    assert _seq_plan(64, 32, 32, 1, 2)["npk"] == 2  # small stages: two of them


@pytest.mark.parametrize("kw,match", [
    (dict(hd=96), "hd 64 or 128"), (dict(rk=48), "multiples of 32"), (dict(rv=80), "multiples"),
    (dict(rk=544), "up to 512"), (dict(rv=544), "up to 512"), (dict(hpg=33), "32 heads"),
    (dict(hpg=0), "32 heads"), (dict(pbits=8), "pack width"), (dict(s_max=8196), "multiple of 8")])
def test_launch_checks_raise_where_the_kernel_cannot_run(kw, match):
    args = dict(hd=128, rk=128, rv=384, hpg=4, pbits=3, s_max=8192)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        _seq_launch_plan(**args)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_unit_table_covers_each_rank_once(bits):
    """The unit table's 8-rank units of each side cover ranks [0, r) once
    each: the main plane's 8 bytes j0 .. j0 + 7 hold ranks r0 .. r0 + 7 in
    field shift / width (core/quant's plane packing), and units past r are
    marked ~0."""
    for r in RANKS:
        seen = []
        for c in range(4):
            for u in range(16):
                x, y = unit_entry(r, c, u, bits)
                r0 = 128 * c + 8 * u
                if r0 >= r:
                    assert x == 0xFFFFFFFF
                    continue
                pw = 2 if bits == 3 else bits
                j0, sh = x & 0xFFFF, x >> 16
                assert sh % pw == 0 and j0 % 8 == 0
                assert j0 + (sh // pw) * (r // (8 // pw)) == r0
                seen += range(r0, r0 + 8)
        assert seen == list(range(r))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_unpack_matches_jax_unpack_codes_bit_for_bit(bits):
    """Bytes from JAX's quant.pack_codes through the kernel's unpack give
    JAX's unpack_codes + q_min exactly, at every rank count 32-512 (the
    3-bit 1-bit plane of r / 8 bytes is not a multiple of 8 bytes at r = 32
    mod 64), sym and asym."""
    rng = np.random.default_rng(bits)
    for r in RANKS:
        codes = rng.integers(0, 2**bits, (64, r)).astype(np.int8)
        packed = np.asarray(jquant.pack_codes(jnp.asarray(codes), bits))
        want = np.asarray(jquant.unpack_codes(jnp.asarray(packed), bits, r)).astype(np.float32)
        for q_min in (0, -(2 ** (bits - 1))):
            got = unpack_units(packed, r, bits, q_min)
            assert np.array_equal(got, want + q_min), (r, q_min)


def _kernel_emulation(q, b_k, bufs, kvl, bits, sym, rk, rv, window):
    """The kernel's arithmetic in f32 numpy: the operand code + q_min from
    unpack_units, K = scale (B^T operand - base rowsum B) before RoPE, the
    online softmax over 64-token tiles, P^T = p scale_v and each head's
    sum of P^T (-base_v) added to its output."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    half = hd // 2
    s_max = bufs["xk_codes"].shape[2]
    q_min = -(2 ** (bits - 1)) if sym else 0
    inv = (1.0 / 10000.0 ** (np.arange(half, dtype=np.float32) * np.float32(2.0 / hd))).astype(
        np.float32)
    out = np.zeros((b, nh, rv), np.float32)
    for lane in range(b):
        for gi in range(g):
            def operand(side, r):
                rows = bufs[f"x{side}_codes"][lane, gi]
                return unpack_units(rows, r, bits, q_min)  # (S, r)
            xk, xv = operand("k", rk), operand("v", rv)
            sk, ok_ = bufs["xk_scales"][lane, gi, :, 0], -bufs["xk_base"][lane, gi, :, 0]
            sv, ov = bufs["xv_scales"][lane, gi, :, 0], -bufs["xv_base"][lane, gi, :, 0]
            pos = np.arange(s_max, dtype=np.float32)
            ang = (pos[:, None] * inv[None, :]).astype(np.float32)
            cos, sin = np.cos(ang), np.sin(ang)
            valid = pos < kvl[lane]
            if window:
                valid &= pos > kvl[lane] - 1 - window
            for h in range(hpg):
                bh = b_k[gi, h].astype(np.float32)  # (rk, hd)
                kk = (xk @ bh + ok_[:, None] * bh.sum(0)[None, :]) * sk[:, None]
                k1, k2 = kk[:, :half], kk[:, half:]
                rot = np.concatenate([k1 * cos - k2 * sin, k2 * cos + k1 * sin], axis=1)
                lg = rot @ (q[lane, gi * hpg + h] / np.float32(math.sqrt(hd)))
                m, l_, acc, zs = -1e30, 0.0, np.zeros(rv, np.float32), 0.0
                for t0 in range(0, s_max, 64):
                    sl = slice(t0, t0 + 64)
                    x = np.where(valid[sl], lg[sl], -1e30)
                    m_new = max(m, float(x.max()))
                    alpha = math.exp(m - m_new)
                    p = np.where(valid[sl], np.exp(x - m_new), 0.0).astype(np.float32)
                    pv = p * sv[sl]
                    l_ = l_ * alpha + float(p.sum())
                    acc = acc * alpha + pv @ xv[sl]
                    zs = zs * alpha + float(pv @ ov[sl])
                    m = m_new
                out[lane, gi * hpg + h] = (acc + zs) / l_
    return out


@pytest.mark.parametrize("bits,sym,rk,rv,kv_len,window,s_max", [
    (3, True, 32, 64, (200,), None, 256), (3, False, 96, 160, (77, 256), None, 256),
    (2, False, 32, 64, (1, 250), 50, 264), (4, True, 64, 96, (130,), None, 256),
    (4, False, 160, 32, (256, 100), None, 256), (2, True, 128, 64, (255,), 100, 256)])
def test_kernel_arithmetic_matches_jax_kernel(bits, sym, rk, rv, kv_len, window, s_max):
    """The kernel's unpack and affine terms, emulated in f32, against JAX's
    v1 kernel in interpret mode at f32 compute on the same caches (JAX
    quantizes and packs): within 1e-5 of max|JAX| (summation order and the
    last bits of cos / sin). S 264 ends in a partial tile; rk 96 / 160 end
    the K side in a partial rank unit table row and a 1-bit plane of 12 /
    20 bytes."""
    q, b_k, bufs, kvl, jq = _case(len(kv_len), 2, 4, rk, rv, 64, s_max, kv_len, bits, sym,
                                  bits * 7 + rk)
    want = np.asarray(palu_flash_decode_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(bufs[k] for k in ORDER), jnp.asarray(kvl),
        qcfg=jq, rk=rk, rv=rv, block_s=8 if s_max % 64 else 64, interpret=True,
        compute_dtype=jnp.float32, sliding_window=window))
    got = _kernel_emulation(q, b_k, bufs, kvl, bits, sym, rk, rv, window)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _v2_case(bits, sym, seed, b=2, g=2, hpg=4, rk=32, rv=64, hd=64, s_max=256):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    jq = jquant.QuantConfig(bits=bits, group_size=0, sym=sym)
    side = []
    for r in (rk, rv):
        x = rng.standard_normal((b, g, s_max, r)).astype(np.float32)
        c, s, z = jquant.quantize_affine(jnp.asarray(x), jq)
        side.append((np.asarray(jquant.pack_codes_t(c, bits)), np.asarray(s[..., 0]),
                     np.asarray(z[..., 0])))
    return q, b_k, side, jq


@pytest.mark.parametrize("bits,sym,kv_len,window,rope_scale", [
    (3, False, (200, 256), None, 1.0), (3, True, (1, 130), None, 1.0),
    (2, False, (256, 77), 60, 1.0), (4, True, (200, 256), None, 0.75),
    (8, False, (256, 100), None, 1.0)])
def test_v2_mapping_onto_exact_mode_matches_jax(bits, sym, kv_len, window, rope_scale):
    """palu_decode2_quantized's kernel call as the plain exact decode sees
    it: the v2 cache (pack_codes_t codes, per-row scale and zero (B, G, S),
    x = scale * code + zero for sym too) as palu_decode's asym rows with no
    offset, RoPE from v2_inv_freq and rope_scale. palu_decode_ref on that
    mapping matches JAX's palu_flash_decode2_quantized in interpret mode at
    f32 within 1e-5 of max|JAX|."""
    q, b_k, ((kc, ks, kz), (vc, vs, vz)), jq = _v2_case(bits, sym, bits + 10 * len(kv_len))
    kvl = np.asarray(kv_len, np.int32)
    hd, rk, rv = q.shape[-1], b_k.shape[2], 64
    inv_freq = None if rope_scale == 1.0 else \
        (1.0 / 10000.0 ** (np.arange(hd // 2) * 2.0 / hd) * 0.5).astype(np.float32)
    want = np.asarray(palu_flash_decode2_quantized(
        jnp.asarray(q), jnp.asarray(b_k), *(jnp.asarray(a) for a in (kc, ks, kz, vc, vs, vz)),
        jnp.asarray(kvl), qcfg=jq, rk=rk, rv=rv, block_s=64, interpret=True,
        compute_dtype=jnp.float32, sliding_window=window, rope_scale=rope_scale,
        **({} if inv_freq is None else {"inv_freq_static": tuple(float(f) for f in inv_freq)})))
    inv = v2_inv_freq(hd // 2, 10000.0, inv_freq, "cpu")

    def t(a):
        return torch.from_numpy(np.array(a))

    got = palu_decode_ref(
        t(q), t(b_k), t(kc), t(ks), t(vc), t(vs), t(kvl), xk_zero=t(kz), xv_zero=t(vz),
        qcfg=QuantConfig(bits=bits, sym=False), rk=rk, rv=rv, sliding_window=window,
        inv_freq=inv.numpy(), rope_scale=rope_scale)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
