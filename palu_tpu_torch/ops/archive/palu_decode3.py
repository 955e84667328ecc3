"""Latent decode attention, v3 (port of
palu_tpu/ops/pallas/archive/palu_decode3.py::palu_flash_decode3_quantized;
the kernel is csrc/palu_decode3.cu): the function of
palu_decode2_quantized, with RoPE from two small tables and the scales and
zeros packed as one (B, S, 2G) array (`sz_pack`).

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
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ...core.quant import QuantConfig
from .. import build
from ..palu_decode import _scratch
from .palu_decode2 import _check_quant, _codes, _launch_setup, _valid, online_step

__all__ = ["palu_decode3_quantized", "palu_decode3_quantized_ref", "sz_pack", "v3_tables",
           "q_scaled"]


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


def palu_decode3_quantized(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, *,
                           qcfg: QuantConfig, rk: int, rv: int, block_s: int = 1024,
                           theta: float = 10000.0, sliding_window: Optional[int] = None,
                           inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over the rank-major packed cache, v3: codes (B, G,
    packed_nrows, S) uint8, xk_sz / xv_sz (B, S, 2G) f32 from sz_pack,
    kv_len (B,). -> (B, nh, rv) f32. block_s is the rotation block (a
    multiple of 64 that divides S for the kernel)."""
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=block_s, theta=theta,
              sliding_window=sliding_window, inv_freq=inv_freq, rope_scale=rope_scale)
    if not q.is_cuda:
        return palu_decode3_quantized_ref(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len,
                                          **kw)
    s_max = _check(q, b_k, xk_codes, xk_sz, xv_codes, xv_sz, kv_len, qcfg, rk, rv, block_s)
    if block_s % 64:
        raise ValueError(f"the v3 kernel needs block_s % 64 == 0, got {block_s}")
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    bufs = (xk_codes, xk_sz, xv_codes, xv_sz)
    dev, splits, per = _launch_setup(q, b_k, bufs, s_max, rk, "palu_decode3_quantized")
    tab = v3_tables(s_max, block_s, hd, theta, inv_freq, rope_scale, dev)
    qs = q_scaled(q).contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    n_part, scratch, out, _, _ = _scratch(b, nh, rv, splits, False, 0, dev)
    err = build.launcher("palu_decode3", "palu_decode3_quantized",
                         "pi" + "p" * 14 + "i" * 14 + "p")(
        qs.data_ptr(), int(q.dtype == torch.bfloat16), b_k.contiguous().data_ptr(),
        *(t.data_ptr() for t in bufs), kvl.data_ptr(),
        *(tab[k].data_ptr() for k in ("c0", "s0", "rcos", "rsin")), scratch.data_ptr(),
        scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(), out.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, xk_codes.shape[2], xv_codes.shape[2], qcfg.pack_bits,
        int(sliding_window or 0), splits, per, block_s, build.stream_ptr(dev))
    build.check(err, "palu_decode3_quantized")
    palu_decode3_quantized.launches += 1
    return out


palu_decode3_quantized.launches = 0
