"""Latent decode attention, v3 (port of
palu_tpu/ops/pallas/archive/palu_decode3.py::palu_flash_decode3_quantized;
the kernel is csrc/palu_decode_exact.cu's v3 instantiation): the function
of palu_decode2_quantized, with RoPE from two small tables and the scales
and zeros packed as one (B, S, 2G) array (`sz_pack`).

RoPE(s) = R(s0) R(s - s0) for the rotation block of `block_s` tokens that
starts at s0: the query is rotated back by s0 with the offset tables
(cos / sin of each block start, (S / block_s, hd/2)) and each token's K by
s - s0 with the relative tables ((block_s, hd/2), rope_scale folded into
cos and sin), both built in float64 and rounded to f32 (`v3_tables`, as the
TPU wrapper's _rel_tables / _offset_tables). The query is pre-scaled by
1/sqrt(hd) and rounded back to its dtype before use, as the TPU wrapper
does. The zero point's logit is formed as the TPU kernel forms it:
cos_rel . A' + sin_rel . C' with A' = cs1 q1' + cs2 q2', C' = cs1 q2' - cs2
q1' (cs the column sums of B's two RoPE halves, q' the rotated query).
`palu_decode3_quantized` launches the kernel for CUDA tensors and runs
`palu_decode3_quantized_ref`, its plain version in f32, for CPU tensors.

The kernel is the exact decode over asym per-row rows (qoff 0, the zero
term on row sums of B) with v3's inputs read as they come: a warp of its
producer gathers each tile's columns g and G + g of (B, S, 2G) into the
stage's scale and zero rows, and each tile's rotation R(s0) R(s - s0) is
formed from its 64 rows of the relative tables and its block's start (cos
= c0 rc - s0 rs, sin = s0 rc + c0 rs; the TPU kernel rotated the query back
by s0 instead: the same function up to f32 rounding). Its plan is v2's;
its one instantiation takes the A/B tool's head dim, 128, and up to 8
heads a group (`v3_launch_plan`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ...core.quant import QuantConfig
from .. import build
from ..palu_decode import _MAX_RK, _TILE, _device_splits, _exact_plan, _scratch
from .palu_decode2 import _check_quant, _codes, _valid, online_step

_V3_HEADS = 8  # heads per group of the kernel's one instantiation (the A/B tool's 4 fit)

__all__ = ["palu_decode3_quantized", "palu_decode3_quantized_ref", "sz_pack", "v3_tables",
           "q_scaled", "v3_launch_plan"]


def sz_pack(scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """(B, G, S) scale + zero -> the kernel's (B, S, 2G) f32 layout: scales
    in columns [0, G), zeros in [G, 2G)."""
    return torch.cat([scale.transpose(1, 2), zero.transpose(1, 2)], dim=-1).float().contiguous()


@functools.lru_cache(maxsize=8)
def _tables(s_max: int, block_s: int, half: int, theta: float, inv_key, rope_scale: float,
            device: str) -> dict:
    if inv_key is not None:
        inv = np.asarray(inv_key, np.float64).reshape(half)
    else:
        inv = 1.0 / theta ** (np.arange(half, dtype=np.float64) * 2 / (2 * half))
    rel = np.arange(block_s, dtype=np.float64)[:, None] * inv[None, :]
    ang0 = (np.arange(s_max // block_s, dtype=np.float64) * block_s)[:, None] * inv[None, :]
    tabs = {"rcos": np.cos(rel) * rope_scale, "rsin": np.sin(rel) * rope_scale,
            "c0": np.cos(ang0), "s0": np.sin(ang0)}
    return {k: torch.from_numpy(v.astype(np.float32)).to(torch.device(device))
            for k, v in tabs.items()}


def v3_tables(s_max: int, block_s: int, hd: int, theta: float, inv_freq, rope_scale: float,
              device) -> dict:
    """{"rcos", "rsin"}: (block_s, hd/2) f32 relative cos / sin times
    rope_scale; {"c0", "s0"}: (S / block_s, hd/2) f32 cos / sin of each
    block start. Built in float64, rounded once."""
    key = None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))
    return _tables(s_max, block_s, hd // 2, float(theta), key, float(rope_scale),
                   str(torch.device(device)))


def q_scaled(q: torch.Tensor) -> torch.Tensor:
    """q / sqrt(hd) in f32 (an IEEE division by a tensor: PyTorch's CUDA
    kernel would multiply by the reciprocal of a Python number), rounded
    back to q's dtype."""
    root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32, device=q.device)
    return (q.float() / root).to(q.dtype)


def _check(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, qcfg, rk, rv, block_s) -> int:
    b, g = q.shape[0], b_k.shape[0]
    s_max = xk_codes.shape[-1]
    rows = {"xk_sz": (xk_sz, (b, s_max, 2 * g)), "xv_sz": (xv_sz, (b, s_max, 2 * g))}
    return _check_quant(q, b_k, xk_codes, xv_codes, kv_len, qcfg, rk, rv, block_s, rows)


def palu_decode3_quantized_ref(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, *,
                               qcfg: QuantConfig, rk: int, rv: int, block_s: int = 1024,
                               theta: float = 10000.0, sliding_window: Optional[int] = None,
                               inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Plain version of palu_decode3_quantized: the TPU kernel's block
    computation in f32."""
    s_max = _check(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, qcfg, rk, rv, block_s)
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    half = hd // 2
    dev = q.device
    tab = v3_tables(s_max, block_s, hd, theta, inv_freq, rope_scale, dev)
    cos, sin = tab["rcos"], tab["rsin"]  # (T, hd/2)
    qf = q_scaled(q).float().reshape(b, g, hpg, hd)
    q1, q2 = qf[..., :half], qf[..., half:]
    bkf = b_k.float()
    b1, b2 = bkf[..., :half], bkf[..., half:]  # (G, hpg, rk, hd/2)
    cs1, cs2 = b1.sum(2), b2.sum(2)  # (G, hpg, hd/2)
    state = (torch.full((b, g, hpg), -1e30, device=dev), torch.zeros((b, g, hpg), device=dev),
             torch.zeros((b, g, hpg, rv), device=dev))
    for j, p0 in enumerate(range(0, s_max, block_s)):
        c0, s0 = tab["c0"][j], tab["s0"][j]
        q1r = q1 * c0 + q2 * s0  # the query rotated back by the block start
        q2r = q2 * c0 - q1 * s0
        ck = _codes(xk_codes, qcfg, rk, p0, block_s)  # (B, G, rk, T)
        xb1 = torch.einsum("bgrt,ghre->bghte", ck, b1)
        xb2 = torch.einsum("bgrt,ghre->bghte", ck, b2)
        r1 = xb1 * cos - xb2 * sin
        r2 = xb2 * cos + xb1 * sin
        lc = (r1 * q1r[..., None, :]).sum(-1) + (r2 * q2r[..., None, :]).sum(-1)
        a_p = cs1 * q1r + cs2 * q2r  # the zero point's virtual key against the tables
        c_p = cs1 * q2r - cs2 * q1r
        lz = (cos * a_p[..., None, :]).sum(-1) + (sin * c_p[..., None, :]).sum(-1)
        ksz = xk_sz[:, p0:p0 + block_s].transpose(1, 2)  # (B, 2G, T)
        lg = ksz[:, :g, None] * lc + ksz[:, g:, None] * lz
        vsz = xv_sz[:, p0:p0 + block_s].transpose(1, 2)
        cv = _codes(xv_codes, qcfg, rv, p0, block_s)

        def value(p):
            return (torch.einsum("bght,bgrt->bghr", p * vsz[:, :g, None], cv)
                    + (p * vsz[:, g:, None]).sum(-1)[..., None])

        pos = torch.arange(p0, p0 + block_s, device=dev)
        state = online_step(state, lg, _valid(kv_len, pos, sliding_window), value)
    m, l, acc = state
    return (acc / l[..., None]).reshape(b, nh, rv)


def v3_launch_plan(hd: int, rk: int, rv: int, g: int, hpg: int, nrk: int, nrv: int, s_max: int,
                   block_s: int) -> dict:
    """The exact kernel's plan for a v3 launch (ops/palu_decode._exact_plan
    over asym per-row rows, v2's); raises ValueError where the kernel cannot
    run: hd other than 128 or more than 8 heads per group (v3's one
    instantiation is the A/B tool's shape), rk or rv not a multiple of 16
    or above 512, S not a multiple of 16 or below 64, block_s not a multiple
    of 64 (a tile would straddle two rotation blocks) or not dividing S, or
    no plan whose tile ring and B fit in a block's shared memory."""
    if (hd != 128 or rk <= 0 or rv <= 0 or rk % 16 or rv % 16 or rk > _MAX_RK
            or rv > _MAX_RK or not 0 < hpg <= _V3_HEADS or g <= 0 or s_max % 16
            or s_max < _TILE or block_s <= 0 or block_s % _TILE or s_max % block_s):
        raise ValueError(f"the v3 kernel needs hd 128, <= {_V3_HEADS} heads per group, rk and "
                         f"rv multiples of 16 up to {_MAX_RK}, S a multiple of 16 and at least "
                         f"{_TILE}, and block_s a multiple of {_TILE} dividing S (hd={hd}, "
                         f"rk={rk}, rv={rv}, G={g}, hpg={hpg}, S={s_max}, block_s={block_s})")
    plan = _exact_plan(hd, rk, rv, hpg, hpg, nrk, nrv, 1, 1, True)
    if plan is None:
        raise ValueError(f"the v3 kernel's tile ring and B do not fit in a block's shared memory "
                         f"at hd {hd}, rk {rk}, rv {rv}, {hpg} heads per group")
    return plan


def palu_decode3_quantized(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, *,
                           qcfg: QuantConfig, rk: int, rv: int, block_s: int = 1024,
                           theta: float = 10000.0, sliding_window: Optional[int] = None,
                           inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over the rank-major packed cache, v3: codes (B, G,
    packed_nrows, S) uint8, xk_sz / xv_sz (B, S, 2G) f32 from sz_pack,
    kv_len (B,). -> (B, nh, rv) f32. block_s is the rotation block. CUDA
    tensors launch the exact kernel's v3 instantiation (b_k bf16, the
    shapes v3_launch_plan takes, 16-byte aligned codes: others raise);
    each launch adds one to `palu_decode3_quantized.launches`."""
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=block_s, theta=theta,
              sliding_window=sliding_window, inv_freq=inv_freq, rope_scale=rope_scale)
    if not q.is_cuda:
        return palu_decode3_quantized_ref(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len,
                                          **kw)
    s_max = _check(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, qcfg, rk, rv, block_s)
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    nrk, nrv = xk_codes.shape[2], xv_codes.shape[2]
    bufs = (xk_codes, xk_sz, xv_codes, xv_sz)
    if b_k.dtype != torch.bfloat16 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the v3 kernel reads b_k as bf16 and q as bf16 or f32, got "
                         f"{b_k.dtype} / {q.dtype}")
    v3_launch_plan(hd, rk, rv, g, hpg, nrk, nrv, s_max, block_s)
    if len({t.device for t in (q, b_k, kv_len, *bufs)}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in bufs) or \
            any(t.data_ptr() % 16 for t in (b_k, xk_codes, xv_codes)):
        raise ValueError("the v3 kernel needs contiguous codes and scales, and its TMA loads "
                         "16-byte aligned codes and b_k")
    dev = q.device
    splits, grid = _device_splits(dev, b * g, s_max)
    tab = v3_tables(s_max, block_s, hd, theta, inv_freq, rope_scale, dev)
    qs = q_scaled(q).contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    # the row sums of B (the zero term's factor) after the outputs
    n_part, scratch, out, _, _ = _scratch(b, nh, rv, splits, False, g * hpg * hd, dev)
    err = build.launcher("palu_decode_exact", "palu_decode_v3", "pi" + "p" * 15 + "i" * 14 + "p")(
        qs.data_ptr(), int(q.dtype == torch.bfloat16), b_k.contiguous().data_ptr(),
        *(t.data_ptr() for t in bufs), kvl.data_ptr(),
        *(tab[k].data_ptr() for k in ("c0", "s0", "rcos", "rsin")),
        scratch[n_part * (2 + rv) + b * nh * rv:].data_ptr(), scratch.data_ptr(),
        scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(), out.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, nrk, nrv, qcfg.pack_bits, int(sliding_window or 0),
        block_s, splits, grid, build.stream_ptr(dev))
    build.check(err, "palu_decode3_quantized")
    palu_decode3_quantized.launches += 1
    return out


palu_decode3_quantized.launches = 0
