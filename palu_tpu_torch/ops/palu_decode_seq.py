"""Latent decode attention over the seq-major packed cache (port of
palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode_quantized, the v1
kernel; the kernel is palu_decode_seq_wg_kernel of
csrc/palu_decode_fp_wg.cu, the bf16 decodes' pipeline fed by a producer
that unpacks the codes).

`palu_decode_seq_quantized` launches the kernel for CUDA tensors and runs
`palu_decode_seq_quantized_ref`, its plain version (flash_decode_latent
over `dequantize`d chunks, in f32), for CPU tensors. The cache is the
layout of core/quant.quantize + pack_codes: codes (B, G, S, nbytes) uint8,
per-token scales and base (B, G, S, 1) f32, x = (code + q_min - base) *
scale. Per-row scales only, pack widths 2/3/4 (8 raises, as the JAX
kernel's unpack does). Scaled RoPE (`inv_freq`, `rope_scale`, as JAX's
`inv_freq_static` / `rope_scale`) reaches the kernel as its f32
frequencies: it forms each token's rotation from the f32 angle position *
inv_freq, as palu_decode_fp's kernel does. Its `impl` and
`head_major_acc` arguments choose TPU block layouts and are not carried
over.

`_seq_plan` mirrors the kernel's shared-memory plan (make_plan with the
packed stages).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..core.quant import QuantConfig, dequantize, packed_nbytes, unpack_codes
from . import build
from .attention import flash_decode_latent
from .palu_decode import (_MAX_HEADS, _MAX_RK, _SMEM_BUDGET, _TILE, _device_splits, _inv_freq_t,
                          _inv_key, _scratch, _up)

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


_CHUNK = 128              # ranks per ring chunk (kChunk)
_CHUNK_BYTES = _TILE * _CHUNK * 2  # a bf16 chunk: 16 KB
_WG_HEADS = 16            # q-heads per consumer warpgroup (kWgHeads)


def _head_split(hpg: int, nkv: int) -> int:
    """The kernel's q-head split between its two consumers (head_split)."""
    rep = hpg // nkv
    hs = rep * ((nkv + 1) // 2)
    return hs if hs <= _WG_HEADS and hpg - hs <= _WG_HEADS else (hpg + 1) // 2


@functools.lru_cache(maxsize=128)
def _seq_plan(hd: int, rk: int, rv: int, hpg: int, pbits: int) -> Optional[dict]:
    """The packed seq-major kernel's shared-memory plan
    (csrc/palu_decode_fp_wg.cu::plan_for / make_plan with nbk, nbv > 0, the
    same function): `smem` bytes a launch takes, `ns` ring chunks of 16 KB,
    `nb` B slots per consumer, `resident` (B loaded once per work item),
    `npk` packed stages, `nt` 8-head tiles per consumer, `unpackers` (the
    producer threads that unpack: all 128 with B resident, whose loads
    thread 0 issues once per item; else warps 0 and 3, beside threads 32
    and 64 streaming B); None when no plan fits in one block. b_k is JAX's
    repeated form (one B per q-head)."""
    nbk, nbv = packed_nbytes(rk, pbits), packed_nbytes(rv, pbits)
    hs = _head_split(hpg, hpg)
    nt = 2 if max(hs, hpg - hs) > 8 else 1
    npw = 8 * nt
    nck, ncv = -(-rk // _CHUNK), -(-rv // _CHUNK)
    pstage = _up(_TILE * nbk, 128) + _up(_TILE * nbv, 128) + 4 * _TILE * 4
    slot = _CHUNK * hd * 2

    def total(ns: int, nb: int, npk: int) -> int:
        o = _up(ns * _CHUNK_BYTES + 2 * nb * slot, 1024)
        o += 2 * 2 * npw * 128 + 2 * npw * hd * 4 + 2 * npw * _TILE * 4 + 2 * 4 * npw * 4
        o = _up(o, 16) + 2 * 4 * 16 * 8 + ns * 2 * _TILE * 4  # unit table, side rows
        o = _up(o, 128) + npk * pstage
        return _up(o, 8) + 8 * (2 * ns + 4 * nb + npk)

    def take(ns, nb, resident, npk):
        return {"smem": total(ns, nb, npk) + 1024, "ns": ns, "nb": nb, "resident": resident,
                "npk": npk, "nt": nt, "unpackers": 128 if resident else 64}

    least = max(nck, ncv)
    nb_res = max(hs, hpg - hs) * nck
    for ns in range(8, least - 1, -1):  # B resident
        for npk in (2, 1):
            if total(ns, nb_res, npk) <= _SMEM_BUDGET:
                return take(ns, nb_res, 1, npk)
    for nb0 in (2, 1):  # B streamed
        for ns in range(min(8, nck + ncv + 1), least - 1, -1):
            for npk in (2, 1):
                nb = nb0
                if total(ns, nb, npk) > _SMEM_BUDGET:
                    continue
                while nb < 8 and total(ns, nb + 1, npk) <= _SMEM_BUDGET:
                    nb += 1
                return take(ns, nb, 0, npk)
    return None


def _seq_launch_plan(hd: int, rk: int, rv: int, hpg: int, pbits: int, s_max: int) -> dict:
    """_seq_plan for a launch; raises ValueError where the kernel cannot
    run: hd other than 64 and 128, rk or rv not a multiple of 32 or above
    512, more than 32 heads per group, S not a multiple of 8, pack widths
    other than 2, 3 and 4, or no plan that fits in a block's shared
    memory."""
    if (hd not in (64, 128) or rk <= 0 or rv <= 0 or rk % 32 or rv % 32 or rk > _MAX_RK
            or rv > _MAX_RK or not 0 < hpg <= _MAX_HEADS or s_max % 8
            or pbits not in (2, 3, 4)):
        raise ValueError(f"seq-major decode kernel needs hd 64 or 128, rk and rv multiples of 32 "
                         f"up to {_MAX_RK}, S a multiple of 8, <= {_MAX_HEADS} heads per group "
                         f"and pack width 2, 3 or 4 (hd={hd}, rk={rk}, rv={rv}, S={s_max}, "
                         f"hpg={hpg}, pack={pbits})")
    plan = _seq_plan(hd, rk, rv, hpg, pbits)
    if plan is None:
        raise ValueError(f"the seq-major decode kernel's ring, packed stage and B do not fit in "
                         f"a block's shared memory at hd {hd}, rk {rk}, rv {rv}, {hpg} heads per "
                         f"group, {pbits}-bit")
    return plan


def palu_decode_seq_quantized(q, b_k, xk_codes, xk_scales, xk_base, xv_codes, xv_scales,
                              xv_base, kv_len, *, qcfg: QuantConfig, rk: int, rv: int,
                              theta: float = 10000.0, sliding_window: Optional[int] = None,
                              inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over the seq-major packed latent cache.

    q (B, nh, hd) roped at the current position; b_k (G, hpg, rk, hd);
    codes (B, G, S, packed_nbytes(r)) uint8; scales / base (B, G, S, 1)
    f32; kv_len (B,) valid positions. -> (B, nh, rv) f32. CUDA tensors
    launch the kernel (b_k bf16; hd 64 or 128, rk and rv multiples of 32
    up to 512, S a multiple of 8, <= 32 heads per group, 16-byte aligned
    buffers, and shapes whose plan fits in a block's shared memory: others
    raise, _seq_launch_plan); CPU tensors run the plain version."""
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
    _seq_launch_plan(hd, rk, rv, hpg, qcfg.pack_bits, s_max)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    bufs = [xk_codes, xk_scales, xk_base, xv_codes, xv_scales, xv_base]
    if len({t.device for t in [q, b_k, kv_len, *bufs]}) != 1:
        raise ValueError("all tensors must be on one device")
    if any(not t.is_contiguous() for t in bufs):
        raise ValueError("cache buffers must be contiguous")
    if any(t.data_ptr() % 16 for t in [b_k, *bufs]):
        raise ValueError("the kernel's bulk copies need the cache buffers and b_k 16-byte "
                         "aligned")
    dev = q.device
    inv = _inv_freq_t(hd, float(theta), _inv_key(inv_freq), str(dev))
    qc = q.contiguous()
    bk = b_k.contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    splits, grid = _device_splits(dev, b * g, s_max)
    # the row sums of B after the outputs
    n_part, scratch, out, _, _ = _scratch(b, nh, rv, splits, False, g * hpg * hd, dev)
    o0 = n_part * (2 + rv)
    q_min = -(2 ** (qcfg.bits - 1)) if qcfg.sym else 0
    err = build.launcher("palu_decode_fp_wg", "palu_decode_seq_wg",
                         "pi" + "p" * 14 + "i" * 12 + "ff" + "p")(
        qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(), xk_codes.data_ptr(),
        xk_scales.data_ptr(), xk_base.data_ptr(), xv_codes.data_ptr(), xv_scales.data_ptr(),
        xv_base.data_ptr(), kvl.data_ptr(), inv.data_ptr(),
        scratch[o0 + b * nh * rv:].data_ptr(), scratch.data_ptr(),
        scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(), out.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, qcfg.pack_bits, q_min, int(sliding_window or 0), splits,
        grid, float(1.0 / math.sqrt(hd)), float(rope_scale), build.stream_ptr(dev))
    build.check(err, "palu_decode_seq_quantized")
    palu_decode_seq_quantized.launches += 1
    return out


palu_decode_seq_quantized.launches = 0
