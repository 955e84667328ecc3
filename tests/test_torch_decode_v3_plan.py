"""The v3 packed decode's mapping onto the exact kernel
(csrc/palu_decode_exact.cu's v3 instantiation), on the CPU.

A torch f32 mirror of what the kernel does per 64-token tile (the tile's
rotation formed from its rows of v3's relative tables and its rotation
block's start, cos = c0 rc - s0 rs and sin = s0 rc + c0 rs; K = scale codes^T
B + zero rowsum B before RoPE; the scales and zeros its producer's scale
warp gathers from columns g and G + g of (B, S, 2G) into the stage's rows;
the online softmax over the tiles the kernel walks) is held against JAX's
palu_flash_decode3_quantized in interpret mode at f32 on the same
numpy-seeded inputs (the JAX side quantizes and packs; its codes, scales and
zeros are carried across), within 1e-5 of max|JAX|. Then the rows the
warp gathers equal sz_pack's inputs bit for bit, the plan (v2's) fits where
the A/B runs, and the launch checks refuse what the kernel cannot run. The
mirror runs on one intra-op thread (a fixture)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.core.quant import QuantConfig as JaxQuantConfig
from palu_tpu.ops.pallas.archive.palu_decode3 import palu_flash_decode3_quantized
from palu_tpu.ops.pallas.archive.palu_decode3 import sz_pack as jax_sz_pack
from palu_tpu_torch.core.quant import QuantConfig, packed_nrows, unpack_codes_t
from palu_tpu_torch.ops.archive.palu_decode3 import (q_scaled, sz_pack, v3_launch_plan,
                                                     v3_tables)
from palu_tpu_torch.ops.palu_decode import _exact_plan

TILE = 64  # the kernel's tile (kTile)
TOL = 1e-5
G, HPG, RK, RV, HD, S = 2, 4, 32, 64, 128, 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gathered_rows(sz: torch.Tensor, b: int, g: int, s0: int) -> tuple:
    """The stage's scale and zero rows (64 tokens each) the scale warp
    gathers from sz (B, S, 2G) for group g of lane b and tokens [s0, s0 +
    64): lane ln takes tokens ln and ln + 32, the element at (b, s, g) and
    at (b, s, G + g) of the flat array (b S + s) 2G + g; zeros past S."""
    s_max, two_g = sz.shape[1], sz.shape[2]
    flat = sz.reshape(-1)
    rows = torch.zeros((2, TILE), dtype=torch.float32)
    for ln in range(32):
        for t in (ln, ln + 32):
            s = s0 + t
            if s < s_max:
                row = (b * s_max + s) * two_g + g
                rows[0, t], rows[1, t] = flat[row], flat[row + two_g // 2]
    return rows[0], rows[1]


def kernel_mirror(q, b_k, kc, ksz, vc, vsz, kv_len, *, qcfg, rk, rv, block_s,
                  sliding_window=None, inv_freq=None, rope_scale=1.0, theta=10000.0):
    """The v3 instantiation's function, tile by tile as it applies the
    tables, the scale boxes and the zero term, in f32."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    half, s_max = hd // 2, kc.shape[-1]
    tab = v3_tables(s_max, block_s, hd, theta, inv_freq, rope_scale, "cpu")
    qs = q_scaled(q).float().reshape(b, g, hpg, hd)
    bk = b_k.float()
    rsum = bk.sum(2)  # (G, hpg, hd): the zero term's row sums of B
    out = torch.zeros((b, g, hpg, rv))
    for bi in range(b):
        kvl = int(kv_len[bi])
        vlo = max(0, kvl - sliding_window) if sliding_window else 0
        vhi = min(kvl, s_max)
        for gi in range(g):
            m = torch.full((hpg,), -1e30)
            l = torch.zeros(hpg)
            acc = torch.zeros((hpg, rv))
            for t0 in range(vlo // TILE * TILE, vhi, TILE):  # the tiles the kernel walks
                n = min(TILE, s_max - t0)
                blk, r0 = divmod(t0, block_s)
                rc, rs = tab["rcos"][r0:r0 + n], tab["rsin"][r0:r0 + n]
                c0, s0 = tab["c0"][blk], tab["s0"][blk]
                cos, sin = c0 * rc - s0 * rs, s0 * rc + c0 * rs  # R(s0) R(s - s0)
                ks, kz = (r[:n] for r in gathered_rows(ksz, bi, gi, t0))
                vs, vz = (r[:n] for r in gathered_rows(vsz, bi, gi, t0))
                ck = unpack_codes_t(kc[bi, gi, :, t0:t0 + n], qcfg.pack_bits, rk).float()
                k = (ks[None, :, None] * torch.einsum("rt,hrd->htd", ck, bk[gi])
                     + kz[None, :, None] * rsum[gi][:, None, :])  # (hpg, n, hd)
                k1, k2 = k[..., :half], k[..., half:]
                qh = qs[bi, gi][:, None, :]
                lg = (((k1 * cos - k2 * sin) * qh[..., :half]).sum(-1)
                      + ((k2 * cos + k1 * sin) * qh[..., half:]).sum(-1))
                pos = torch.arange(t0, t0 + n)
                valid = (pos >= vlo) & (pos < vhi)
                lg = torch.where(valid, lg, -1e30)
                m_new = torch.maximum(m, lg.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(lg - m_new[:, None]), 0.0)
                l = l * alpha + p.sum(-1)
                cv = unpack_codes_t(vc[bi, gi, :, t0:t0 + n], qcfg.pack_bits, rv).float()
                acc = acc * alpha[:, None] + (p * vs) @ cv.t() + (p * vz).sum(-1)[:, None]
                m = m_new
            out[bi, gi] = acc / l[:, None]
    return out.reshape(b, nh, rv)


def _case(bits: int, kv_len, seed: int = 0):
    """numpy q, b_k, JAX-packed codes and sz_pack'd scales of both sides."""
    rng = np.random.default_rng(seed)
    b = len(kv_len)
    q = rng.standard_normal((b, G * HPG, HD)).astype(np.float32)
    b_k = (rng.standard_normal((G, HPG, RK, HD)) * 0.1).astype(np.float32)
    out = {"q": q, "b_k": b_k, "kv_len": np.asarray(kv_len, np.int32)}
    for side, r in (("k", RK), ("v", RV)):
        x = rng.standard_normal((b, G, S, r)).astype(np.float32)
        c, s, z = jquant.quantize_affine(jnp.asarray(x),
                                         JaxQuantConfig(bits=bits, group_size=0, sym=False))
        out[f"{side}c"] = np.asarray(jquant.pack_codes_t(c, bits))
        out[f"{side}s"], out[f"{side}z"] = np.asarray(s[..., 0]), np.asarray(z[..., 0])
        out[f"{side}sz"] = np.asarray(jax_sz_pack(s[..., 0], z[..., 0]))
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("block_s", [64, 128])
@pytest.mark.parametrize("bits,window", [(2, None), (3, None), (4, None), (8, None), (3, 100),
                                         (8, 150)])
def test_kernel_mirror_matches_jax(bits, block_s, window):
    """Tiles in several rotation blocks (S 512 in blocks of 64 or 128), a
    kv_len not a multiple of 64 and one past several blocks, a window."""
    x = _case(bits, (455, 200), seed=bits)
    want = np.asarray(palu_flash_decode3_quantized(
        *(jnp.asarray(x[k]) for k in ("q", "b_k", "kc", "ksz", "vc", "vsz", "kv_len")),
        qcfg=JaxQuantConfig(bits=bits, group_size=0), rk=RK, rv=RV, block_s=block_s,
        sliding_window=window, interpret=True, compute_dtype=jnp.float32))
    got = kernel_mirror(*(_t(x[k]) for k in ("q", "b_k", "kc", "ksz", "vc", "vsz", "kv_len")),
                        qcfg=QuantConfig(bits=bits), rk=RK, rv=RV, block_s=block_s,
                        sliding_window=window)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_kernel_mirror_matches_jax_with_scaled_rope():
    """rope_scale folded into the relative tables and an inv_freq override."""
    inv = tuple(float(f) for f in 1.0 / (5e5 ** (np.arange(HD // 2) * 2 / HD)) / 4.0)
    x = _case(3, (300,), seed=9)
    kw = dict(rk=RK, rv=RV, block_s=128)
    want = np.asarray(palu_flash_decode3_quantized(
        *(jnp.asarray(x[k]) for k in ("q", "b_k", "kc", "ksz", "vc", "vsz", "kv_len")),
        qcfg=JaxQuantConfig(bits=3, group_size=0), interpret=True, compute_dtype=jnp.float32,
        inv_freq_static=inv, rope_scale=1.25, **kw))
    got = kernel_mirror(*(_t(x[k]) for k in ("q", "b_k", "kc", "ksz", "vc", "vsz", "kv_len")),
                        qcfg=QuantConfig(bits=3), inv_freq=inv, rope_scale=1.25, **kw)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("g", [3, 4])
@pytest.mark.parametrize("pack", ["port", "jax"])
def test_gathered_rows_are_sz_pack_inputs(pack, g):
    """The scale and zero rows the warp gathers for every group, tile and
    lane are sz_pack's inputs, bit for bit (an odd G too: no TMA row
    alignment binds the gather), with zeros past S."""
    rng = np.random.default_rng(5 + g)
    s = 200
    scale = rng.standard_normal((2, g, s)).astype(np.float32)
    zero = rng.standard_normal((2, g, s)).astype(np.float32)
    sz = (sz_pack(_t(scale), _t(zero)) if pack == "port"
          else _t(np.asarray(jax_sz_pack(jnp.asarray(scale), jnp.asarray(zero)))))
    for b in range(2):
        for gi in range(g):
            for t0 in range(0, s, TILE):
                n = min(TILE, s - t0)
                rs, rz = gathered_rows(sz, b, gi, t0)
                assert np.array_equal(rs[:n].numpy(), scale[b, gi, t0:t0 + n])
                assert np.array_equal(rz[:n].numpy(), zero[b, gi, t0:t0 + n])
                assert not rs[n:].any() and not rz[n:].any()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("rk", [128, 256, 512])
def test_plan_fits_and_is_v2s(bits, rk):
    """At the Llama group (4 heads a group, rv 384) and at rk 256 / 512 the
    v3 plan fits, and it is v2's (the gathered rows take v2's place in the
    stage): the same ring, B slots and bytes."""
    nrk, nrv = packed_nrows(rk, bits), packed_nrows(384, bits)
    v3 = v3_launch_plan(128, rk, 384, 8, 4, nrk, nrv, 65536, 1024)
    assert v3 == _exact_plan(128, rk, 384, 4, 4, nrk, nrv, 1, 1, True)
    assert v3["smem"] <= 232448


@pytest.mark.parametrize("shape,match", [
    (dict(g=0), "G=0"), (dict(block_s=96), "block_s"), (dict(block_s=1024, s_max=1536),
                                                         "block_s"),
    (dict(hd=64), "hd 128"), (dict(rk=520), "rk and"), (dict(rv=40), "rk and"),
    (dict(s_max=48, block_s=48), "at least"), (dict(hpg=9), "heads per group")])
def test_launch_checks_refuse_what_the_kernel_cannot_run(shape, match):
    kw = dict(hd=128, rk=128, rv=384, g=8, hpg=4, s_max=65536, block_s=1024)
    kw.update(shape)
    kw["nrk"], kw["nrv"] = packed_nrows(kw["rk"], 3), packed_nrows(kw["rv"], 3)
    with pytest.raises(ValueError, match=match):
        v3_launch_plan(**kw)
