"""Latent decode attention over the rank-major packed cache (port of
palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized; the
kernel is csrc/palu_decode.cu).

`palu_decode` launches the kernel for CUDA tensors and runs `palu_decode_ref`,
its plain version (flash_decode_latent over decode_latents, in f32), for CPU
tensors. Per-row scales, symmetric or asymmetric, pack widths 2/3/4/8.
Returns (B, nh, rv) f32 latent-space outputs for the U_v-fused o_proj.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..core.quant import QuantConfig, packed_nrows
from ..runtime import cache as cache_lib
from . import build
from .attention import _inv_freq, flash_decode_latent

__all__ = ["palu_decode", "palu_decode_ref"]

_TILE = 64        # tokens per kernel tile (kTile in the source)
_MAX_HEADS = 16   # q-heads per group the kernel holds (kMaxHeads)
_MAX_RK = 128     # 16 * kMaxKSteps


def _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero):
    if not (qcfg.enabled and qcfg.group_size == 0):
        raise ValueError(f"decode needs per-row quantized latents, got {qcfg}")
    if qcfg.pack_bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported pack width {qcfg.pack_bits}")
    if qcfg.sym != (xk_zero is None and xv_zero is None):
        raise ValueError("zero rows must be given exactly when qcfg is asymmetric")
    if q.dim() != 3 or b_k.dim() != 4:
        raise ValueError("q must be (B, nh, hd) and b_k (G, hpg, rk, hd)")
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    if g * hpg != nh or tuple(b_k.shape[2:]) != (rk, hd):
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match q {tuple(q.shape)} / rk {rk}")
    s_max = xk_codes.shape[-1]
    for name, c, r in (("xk_codes", xk_codes, rk), ("xv_codes", xv_codes, rv)):
        want = (b, g, packed_nrows(r, qcfg.pack_bits), s_max)
        if tuple(c.shape) != want or c.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 {want}, got {c.dtype} {tuple(c.shape)}")
    for name, t in (("xk_scale", xk_scale), ("xv_scale", xv_scale),
                    ("xk_zero", xk_zero), ("xv_zero", xv_zero)):
        if t is not None and (t.numel() != b * g * s_max or t.shape[-1] != s_max
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be f32 (B, G, S) or (B, G, 1, S)")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B,), got {tuple(kv_len.shape)}")


def _bufs(codes, scale, zero):
    b, g, _, s_max = codes.shape
    out = {"codes_t": codes, "scale_t": scale.reshape(b, g, 1, s_max)}
    if zero is not None:
        out["zero_t"] = zero.reshape(b, g, 1, s_max)
    return out


def palu_decode_ref(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, *,
                    qcfg: QuantConfig, rk: int, rv: int, theta: float = 10000.0,
                    sliding_window: Optional[int] = None, inv_freq=None,
                    rope_scale: float = 1.0, xk_zero=None, xv_zero=None) -> torch.Tensor:
    """Plain version: dequantize the cache (decode_latents) and run
    flash_decode_latent in f32 on the same inputs, in chunks of up to 512
    positions."""
    _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero)
    s_max = xk_codes.shape[-1]
    chunk = min(512, s_max)
    while s_max % chunk:
        chunk -= 1
    kb = _bufs(xk_codes, xk_scale, xk_zero)
    vb = _bufs(xv_codes, xv_scale, xv_zero)

    def reader(buf, rank):
        def read(idx):
            sl = cache_lib.seq_slice(buf, idx * chunk, chunk)
            return cache_lib.decode_latents(sl, qcfg, rank, torch.float32)
        return read

    return flash_decode_latent(
        q.float(), reader(kb, rk), reader(vb, rv), b_k.float(), s_max // chunk,
        chunk, kv_len, q.shape[-1], theta, rv, sliding_window,
        inv_freq=inv_freq, rope_scale=rope_scale)


@functools.lru_cache(maxsize=8)
def _tables(s_max: int, half: int, theta: float, inv_key, rope_scale: float,
            device: str):
    dev = torch.device(device)
    inv = _inv_freq(2 * half, theta, None if inv_key is None else np.asarray(inv_key), dev)
    freqs = torch.arange(s_max, device=dev).float()[:, None] * inv
    return ((torch.cos(freqs) * rope_scale).contiguous(),
            (torch.sin(freqs) * rope_scale).contiguous())


def _rope_tables(s_max: int, head_dim: int, theta: float, inv_freq, rope_scale: float,
                device) -> tuple:
    """f32 (S, hd/2) cos/sin tables at absolute positions, computed with the
    same f32 operations flash_decode_latent applies per chunk."""
    key = None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))
    return _tables(s_max, head_dim // 2, float(theta), key, float(rope_scale),
                   str(torch.device(device)))


def _lib():
    fn = build.load("palu_decode").palu_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i] + [p] * 14 + [i] * 15 + [ctypes.c_float, p]
        fn.restype = i
    return fn


@functools.lru_cache(maxsize=32)
def _splits(dev: torch.device, n_bg: int, s_max: int):
    """Sequence splits so that about one block (it fills an SM's shared
    memory) runs per SM: (splits, tiles per split)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-s_max // _TILE)
    splits = min(tiles, max(1, -(-sms // n_bg)))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def palu_decode(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, *,
                qcfg: QuantConfig, rk: int, rv: int, theta: float = 10000.0,
                sliding_window: Optional[int] = None, inv_freq=None,
                rope_scale: float = 1.0, xk_zero=None, xv_zero=None) -> torch.Tensor:
    """Decode attention over an affine-quantized rank-major latent cache.

    q (B, nh, hd) roped at the current position; b_k (G, hpg, rk, hd);
    codes (B, G, packed_nrows, S) uint8; scales/zeros (B, G, S) or
    (B, G, 1, S) f32; kv_len (B,) valid positions. -> (B, nh, rv) f32.
    CUDA tensors launch the kernel (b_k must be bf16, as the engine keeps
    it); CPU tensors run the plain version."""
    if not q.is_cuda:
        return palu_decode_ref(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len,
                               qcfg=qcfg, rk=rk, rv=rv, theta=theta,
                               sliding_window=sliding_window, inv_freq=inv_freq,
                               rope_scale=rope_scale, xk_zero=xk_zero, xv_zero=xv_zero)
    _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero)
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    s_max = xk_codes.shape[-1]
    if b_k.dtype != torch.bfloat16:
        raise ValueError(f"the decode kernel reads b_k as bf16, got {b_k.dtype}")
    if hd not in (64, 128) or rk % 16 or rk > _MAX_RK or hpg > _MAX_HEADS or s_max % 16:
        raise ValueError(f"decode kernel needs hd 64 or 128, rk a multiple of 16 up to "
                         f"{_MAX_RK}, S a multiple of 16 and <= {_MAX_HEADS} heads per "
                         f"group (hd={hd}, rk={rk}, S={s_max}, hpg={hpg})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    ts = [q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, xk_zero, xv_zero]
    if len({t.device for t in ts if t is not None}) != 1:
        raise ValueError("all tensors must be on one device")
    bufs = [xk_codes, xk_scale, xv_codes, xv_scale, xk_zero, xv_zero]
    if any(t is not None and not t.is_contiguous() for t in bufs):
        raise ValueError("cache buffers must be contiguous")
    dev = q.device
    cos_t, sin_t = _rope_tables(s_max, hd, theta, inv_freq, rope_scale, dev)
    qc = q.contiguous()
    bk = b_k.contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    splits, per = _splits(dev, b * g, s_max)
    # one allocation: per-split m, l, accumulators, then the output
    n_part = b * nh * splits
    scratch = torch.empty(n_part * (2 + rv) + b * nh * rv, dtype=torch.float32, device=dev)
    out = scratch[n_part * (2 + rv):].view(b, nh, rv)
    asym = not qcfg.sym
    qoff = 0 if asym else 2 ** (qcfg.bits - 1)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _lib()(
        qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(), xk_codes.data_ptr(),
        xk_scale.data_ptr(), ptr(xk_zero), xv_codes.data_ptr(), xv_scale.data_ptr(),
        ptr(xv_zero), kvl.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        scratch.data_ptr(), scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(),
        out.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, xk_codes.shape[2], xv_codes.shape[2],
        qcfg.pack_bits, qoff, int(asym), int(sliding_window or 0), splits, per,
        float(math.sqrt(hd)), build.stream_ptr(dev))
    build.check(err, "palu_decode")
    palu_decode.launches += 1
    return out


palu_decode.launches = 0
