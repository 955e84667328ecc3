"""Latent decode attention over the seq-major packed cache (port of
palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode_quantized, the v1
kernel; the kernel is the packed variant of csrc/palu_decode_fp.cu).

`palu_decode_seq_quantized` launches the kernel for CUDA tensors and runs
`palu_decode_seq_quantized_ref`, its plain version (flash_decode_latent
over `dequantize`d chunks, in f32), for CPU tensors. The cache is the
layout of core/quant.quantize + pack_codes: codes (B, G, S, nbytes) uint8,
per-token scales and base (B, G, S, 1) f32, x = (code + q_min - base) *
scale. Per-row scales only, pack widths 2/3/4 (8 raises, as the JAX
kernel's unpack does). Scaled RoPE (`inv_freq`, `rope_scale`, as JAX's
`inv_freq_static` / `rope_scale`) reaches the kernel through its f32 cos /
sin tables, built as palu_decode builds them. Its `impl` and
`head_major_acc` arguments choose TPU block layouts and are not carried
over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.quant import QuantConfig, dequantize, packed_nbytes, unpack_codes
from . import build
from .attention import flash_decode_latent
from .palu_decode import _MAX_HEADS, _MAX_RK, _device_splits, _rope_tables

__all__ = ["palu_decode_seq_quantized", "palu_decode_seq_quantized_ref"]


def _check(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base, kv_len,
           qcfg, rk, rv):
    if not (qcfg.enabled and qcfg.group_size == 0):
        raise ValueError(f"seq-major decode needs per-row quantized latents, got {qcfg}")
    if qcfg.pack_bits not in (2, 3, 4):
        raise ValueError(f"seq-major decode unpacks 2/3/4-bit codes, got {qcfg.pack_bits}")
    if q.dim() != 3 or b_k.dim() != 4:
        raise ValueError("q must be (B, nh, hd) and b_k (G, hpg, rk, hd)")
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    if g * hpg != nh or tuple(b_k.shape[2:]) != (rk, hd):
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match q {tuple(q.shape)} / rk {rk}")
    s_max = xk_codes.shape[2] if xk_codes.dim() == 4 else -1
    for name, c, r in (("xk_codes", xk_codes, rk), ("xv_codes", xv_codes, rv)):
        want = (b, g, s_max, packed_nbytes(r, qcfg.pack_bits))
        if tuple(c.shape) != want or c.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 {want}, got {c.dtype} {tuple(c.shape)}")
    for name, t in (("xk_scales", xk_scales), ("xk_base", xk_base),
                    ("xv_scales", xv_scales), ("xv_base", xv_base)):
        if tuple(t.shape) != (b, g, s_max, 1) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 (B, G, S, 1), got {t.dtype} {tuple(t.shape)}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B,), got {tuple(kv_len.shape)}")
    return s_max


def palu_decode_seq_quantized_ref(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales,
                                  xv_base, kv_len, *, qcfg: QuantConfig, rk: int, rv: int,
                                  theta: float = 10000.0,
                                  sliding_window: Optional[int] = None, inv_freq=None,
                                  rope_scale: float = 1.0) -> torch.Tensor:
    """Plain version: dequantize the cache in f32 chunks of up to 512
    positions and run flash_decode_latent on them."""
    s_max = _check(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base,
                   kv_len, qcfg, rk, rv)
    chunk = min(512, s_max)
    while s_max % chunk:
        chunk -= 1

    def reader(codes, scales, base, rank):
        def read(idx):
            sl = slice(idx * chunk, (idx + 1) * chunk)
            c = unpack_codes(codes[:, :, sl], qcfg.pack_bits, rank)
            return dequantize(c, scales[:, :, sl], base[:, :, sl], qcfg, torch.float32)
        return read

    return flash_decode_latent(
        q.float(), reader(xk_codes, xk_scales, xk_base, rk),
        reader(xv_codes, xv_scales, xv_base, rv), b_k.float(), s_max // chunk, chunk,
        kv_len, q.shape[-1], theta, rv, sliding_window, inv_freq=inv_freq,
        rope_scale=rope_scale)


def palu_decode_seq_quantized(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales,
                              xv_base, kv_len, *, qcfg: QuantConfig, rk: int, rv: int,
                              theta: float = 10000.0, sliding_window: Optional[int] = None,
                              inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over the seq-major packed latent cache.

    q (B, nh, hd) roped at the current position; b_k (G, hpg, rk, hd);
    codes (B, G, S, packed_nbytes(r)) uint8; scales / base (B, G, S, 1)
    f32; kv_len (B,) valid positions. -> (B, nh, rv) f32. CUDA tensors
    launch the kernel (b_k bf16; rk a multiple of 32 up to 512, rv a
    multiple of 32, S a multiple of 8); CPU tensors run the plain
    version."""
    if not q.is_cuda:
        return palu_decode_seq_quantized_ref(
            q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base, kv_len,
            qcfg=qcfg, rk=rk, rv=rv, theta=theta, sliding_window=sliding_window,
            inv_freq=inv_freq, rope_scale=rope_scale)
    s_max = _check(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base,
                   kv_len, qcfg, rk, rv)
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    if b_k.dtype != torch.bfloat16:
        raise ValueError(f"the decode kernel reads b_k as bf16, got {b_k.dtype}")
    if hd not in (64, 128) or rk % 32 or rk > _MAX_RK or rv % 32 or hpg > _MAX_HEADS \
            or s_max % 8:
        raise ValueError(f"seq-major decode kernel needs hd 64 or 128, rk a multiple of 32 up "
                         f"to {_MAX_RK}, rv a multiple of 32, S a multiple of 8 and <= "
                         f"{_MAX_HEADS} heads per group (hd={hd}, rk={rk}, rv={rv}, "
                         f"S={s_max}, hpg={hpg})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    bufs = [xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base]
    if len({t.device for t in [q, b_k, kv_len, *bufs]}) != 1:
        raise ValueError("all tensors must be on one device")
    if any(not t.is_contiguous() for t in bufs):
        raise ValueError("cache buffers must be contiguous")
    dev = q.device
    cos_t, sin_t = _rope_tables(s_max, hd, theta, inv_freq, rope_scale, dev)
    qc = q.contiguous()
    bk = b_k.contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    splits, per, _ = _device_splits(dev, b * g, s_max)
    # one allocation: per-split m, l, accumulators, then the output
    n_part = b * nh * splits
    scratch = torch.empty(n_part * (2 + rv) + b * nh * rv, dtype=torch.float32, device=dev)
    out = scratch[n_part * (2 + rv):].view(b, nh, rv)
    q_min = -(2 ** (qcfg.bits - 1)) if qcfg.sym else 0
    err = build.launcher("palu_decode_fp", "palu_decode_seq_q", "pi" + "p" * 14 + "i" * 14 + "fp")(
        qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(), xk_codes.data_ptr(),
        xk_scales.data_ptr(), xk_base.data_ptr(), xv_codes.data_ptr(), xv_scales.data_ptr(),
        xv_base.data_ptr(), kvl.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        scratch.data_ptr(), scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(),
        out.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, xk_codes.shape[3], xv_codes.shape[3], qcfg.pack_bits,
        q_min, int(sliding_window or 0), splits, per, float(math.sqrt(hd)),
        build.stream_ptr(dev))
    build.check(err, "palu_decode_seq_quantized")
    palu_decode_seq_quantized.launches += 1
    return out


palu_decode_seq_quantized.launches = 0
