"""Latent decode attention, v2 (port of
palu_tpu/ops/pallas/archive/palu_decode2.py::palu_flash_decode2 and
palu_flash_decode2_quantized): RoPE's cos/sin computed in the kernel from
the positions, and the affine dequantization folded past the products.

`palu_decode2` takes bf16 latents, K seq-major (B, G, S, rk) and V
rank-major (B, G, rv, S); its kernel is palu_decode_fp's
(csrc/palu_decode_fp_wg.cu, entry palu_decode_fp_v2): one launch of the
one-wave TMA-ring kernel with the K and V layouts apart, one B per q-head,
palu_decode_fp's plan (`_v2_plan`, ops/palu_decode_fp._fp_plan) and splits,
then the combine kernel. Its instantiations cover the v2 tool's and tests'
shapes (hd 128, at most 16 heads a group: one 8-head tile a consumer);
other shapes raise. `palu_decode2_quantized` takes
the rank-major packed cache (pack_codes_t) with per-row affine scales and
zeros (B, G, S), x = scale * code + zero (quantize_affine's form, sym and
asym alike): the function of palu_decode's exact mode over asym per-row
rows with no offset, so its kernel is csrc/palu_decode_exact.cu
(ops/palu_decode.exact_launch: qoff 0, the zero term on row sums of B,
RoPE from `v2_inv_freq` and rope_scale; palu_decode's launch counters do
not count it). Both return (B, nh, rv)
f32 latent-space outputs, launch their kernel for CUDA tensors and run
their plain version (`*_ref`) for CPU tensors, and count their launches.

The RoPE angle of position s and frequency j is the f32 product s *
inv_freq[j], inv_freq the f32 1 / theta^(2j / hd) (`v2_inv_freq`, as the
TPU kernel's _rope_tables forms it) or the rope_scaling override; cos and
sin are multiplied by rope_scale. The plain versions form their angles the
same way, in f32, and walk the sequence in blocks of `block_s` with the TPU
kernel's online softmax and folds: logit = scale_k (q . RoPE(codes B)) +
zero_k (q . RoPE(colsum B)), out = codes_v (p scale_v) + sum(p zero_v).
The JAX kernels' `compute_dtype` and `interpret` are TPU knobs and are not
carried over: the kernels take bf16 operands with f32 accumulation.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ...core.quant import QuantConfig, packed_nrows, unpack_codes_t
from .. import build
from ..palu_decode import (_MAX_HEADS, _MAX_RK, _TILE, _device_splits, _exact_smem, _scratch,
                           exact_launch)
from ..palu_decode_fp import _fp_plan

__all__ = ["palu_decode2", "palu_decode2_ref", "palu_decode2_quantized",
           "palu_decode2_quantized_ref", "v2_inv_freq"]

# the head dim and q-heads per group palu_decode2's kernel is instantiated
# at (one 8-head tile a consumer)
V2_HD, V2_MAX_HEADS = 128, 16


@functools.lru_cache(maxsize=8)
def _inv_freq(half: int, theta: float, inv_key, device: str) -> torch.Tensor:
    dev = torch.device(device)
    if inv_key is not None:
        return torch.tensor(np.asarray(inv_key, np.float32), device=dev)
    exponent = torch.arange(half, dtype=torch.float32, device=dev) * (2.0 / (2 * half))
    one = torch.ones((), dtype=torch.float32, device=dev)
    return one / torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exponent)


def v2_inv_freq(half: int, theta: float, inv_freq, device) -> torch.Tensor:
    """The v2 kernel's f32 RoPE frequencies (hd/2,): 1 / theta^(f32(j) *
    (2 / hd)) in f32 as the TPU kernel forms them, or the rope_scaling
    override rounded to f32."""
    key = None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))
    if key is not None and len(key) != half:
        raise ValueError(f"inv_freq must have hd/2 = {half} entries, got {len(key)}")
    return _inv_freq(half, float(theta), key, str(torch.device(device)))


def _valid(kv_len: torch.Tensor, pos: torch.Tensor, sliding_window: Optional[int]):
    """(B, 1, 1, T) bool: positions inside each lane's live (windowed) context."""
    kvl = kv_len.to(pos.device).long()[:, None]
    valid = pos[None, :] < kvl
    if sliding_window is not None:
        valid &= pos[None, :] > (kvl - 1) - sliding_window
    return valid[:, None, None, :]


def online_step(state: tuple, lg: torch.Tensor, valid: torch.Tensor, value) -> tuple:
    """One block of the TPU kernels' online softmax: logits lg (B, G, hpg,
    T) masked by valid, then acc = acc * alpha + value(p) with value(p) ->
    (B, G, hpg, rv). state = (m, l, acc)."""
    m, l, acc = state
    lg = torch.where(valid, lg, -1e30)
    m_new = torch.maximum(m, lg.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(lg - m_new[..., None]), 0.0)
    return m_new, l * alpha + p.sum(-1), acc * alpha[..., None] + value(p)


def _v2_ref(q, b_k, kv_len, read_k, read_v, s_max: int, rv: int, block_s: int, theta: float,
            sliding_window, inv_freq, rope_scale: float) -> torch.Tensor:
    """The v2 kernel's function in f32, block by block. read_k(p0, T) ->
    (x (B, G, rk, T) latents or codes, scale, zero (B, G, T) or None);
    read_v(p0, T) -> the same with rv."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    half = hd // 2
    dev = q.device
    qf = q.float().reshape(b, g, hpg, 1, hd)
    q1, q2 = qf[..., :half], qf[..., half:]
    bkf = b_k.float()
    cs = bkf.sum(2)[None, :, :, None, :]  # colsum B: the zero point's virtual key
    inv = v2_inv_freq(half, theta, inv_freq, dev)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    state = (torch.full((b, g, hpg), -1e30, device=dev), torch.zeros((b, g, hpg), device=dev),
             torch.zeros((b, g, hpg, rv), device=dev))
    for p0 in range(0, s_max, block_s):
        pos = torch.arange(p0, p0 + block_s, device=dev)
        freqs = pos.float()[:, None] * inv  # (T, hd/2)
        cos, sin = torch.cos(freqs), torch.sin(freqs)
        if rope_scale != 1.0:
            cos, sin = cos * rope_scale, sin * rope_scale

        def rope_dot(x):  # (..., T, hd) -> q . RoPE(x), (B, G, hpg, T)
            x1, x2 = x[..., :half], x[..., half:]
            return (((x1 * cos - x2 * sin) * q1).sum(-1) + ((x2 * cos + x1 * sin) * q2).sum(-1))

        xk, ks, kz = read_k(p0, block_s)
        lg = rope_dot(torch.einsum("bgrt,ghrd->bghtd", xk, bkf))
        if ks is not None:
            lg = ks[:, :, None] * lg + kz[:, :, None] * rope_dot(cs)
        xv, vs, vz = read_v(p0, block_s)

        def value(p):
            if vs is None:
                return torch.einsum("bght,bgrt->bghr", p, xv)
            return (torch.einsum("bght,bgrt->bghr", p * vs[:, :, None], xv)
                    + (p * vz[:, :, None]).sum(-1)[..., None])

        state = online_step(state, lg * scale, _valid(kv_len, pos, sliding_window), value)
    m, l, acc = state
    return (acc / l[..., None]).reshape(b, nh, rv)


def _check_common(q, b_k, kv_len, s_max: int, block_s: int):
    if q.dim() != 3 or b_k.dim() != 4:
        raise ValueError("q must be (B, nh, hd) and b_k (G, hpg, rk, hd)")
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    if g * hpg != nh or b_k.shape[3] != hd:
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match q {tuple(q.shape)}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B,), got {tuple(kv_len.shape)}")
    if block_s < 1 or s_max % block_s:
        raise ValueError(f"block_s {block_s} must divide S {s_max}")


def _check_fp(q, b_k, x_k, x_v_t, kv_len, block_s):
    if x_k.dim() != 4 or x_v_t.dim() != 4:
        raise ValueError("x_k must be (B, G, S, rk) and x_v_t (B, G, rv, S)")
    b, g, s_max = q.shape[0], b_k.shape[0], x_k.shape[2]
    _check_common(q, b_k, kv_len, s_max, block_s)
    if tuple(x_k.shape) != (b, g, s_max, b_k.shape[2]) or tuple(x_v_t.shape[:2]) != (b, g) \
            or x_v_t.shape[3] != s_max:
        raise ValueError(f"x_k {tuple(x_k.shape)} / x_v_t {tuple(x_v_t.shape)} do not match "
                         f"q {tuple(q.shape)} and b_k {tuple(b_k.shape)}")
    return s_max, x_v_t.shape[2]


def palu_decode2_ref(q, b_k, x_k, x_v_t, kv_len, *, block_s: int = 1024,
                     theta: float = 10000.0, sliding_window: Optional[int] = None,
                     inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Plain version of palu_decode2, in f32."""
    s_max, rv = _check_fp(q, b_k, x_k, x_v_t, kv_len, block_s)

    def read_k(p0, n):
        return x_k[:, :, p0:p0 + n].float().transpose(-1, -2), None, None

    def read_v(p0, n):
        return x_v_t[..., p0:p0 + n].float(), None, None

    return _v2_ref(q, b_k, kv_len, read_k, read_v, s_max, rv, block_s, theta, sliding_window,
                   inv_freq, rope_scale)


def _launch_setup(q, b_k, tensors, s_max: int, rk: int, what: str) -> torch.device:
    """Checks shared by the kernels; returns the device."""
    hd, hpg = q.shape[2], b_k.shape[1]
    if b_k.dtype != torch.bfloat16:
        raise ValueError(f"{what} reads b_k as bf16, got {b_k.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    if hd not in (64, 128) or rk % 16 or rk > _MAX_RK or hpg > _MAX_HEADS or s_max % 16:
        raise ValueError(f"{what} needs hd 64 or 128, rk a multiple of 16 up to {_MAX_RK}, S a "
                         f"multiple of 16 and <= {_MAX_HEADS} heads per group (hd={hd}, "
                         f"rk={rk}, S={s_max}, hpg={hpg})")
    if len({t.device for t in (q, b_k, *tensors)}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cache buffers, scales and zeros must be contiguous")
    return q.device


def _v2_plan(hd: int, rk: int, rv: int, hpg: int):
    """palu_decode2's shared-memory plan: palu_decode_fp's (_fp_plan, one B
    per q-head; the K and V chunks are 16 KB in either layout), or None
    where the kernel has no instantiation or no plan fits (hd other than
    128, more than 16 heads a group)."""
    if hd != V2_HD or hpg > V2_MAX_HEADS:
        return None
    plan = _fp_plan(hd, rk, rv, hpg, hpg)
    return plan if plan is not None and plan["nt"] == 1 else None


def palu_decode2(q, b_k, x_k, x_v_t, kv_len, *, block_s: int = 1024, theta: float = 10000.0,
                 sliding_window: Optional[int] = None, inv_freq=None,
                 rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over bf16 latents, v2's layout: q (B, nh, hd) roped
    at the current position, b_k (G, hpg, rk, hd), x_k (B, G, S, rk)
    seq-major and x_v_t (B, G, rv, S) rank-major pre-RoPE latents, kv_len
    (B,). -> (B, nh, rv) f32. block_s (dividing S) is the plain version's
    sequence block; the kernel walks 64-token tiles in its own splits. CUDA
    tensors launch the kernel (hd 128, rk a multiple of 16 and rv of 8,
    both up to 512, S a multiple of 16, at most 16 heads a group: other
    shapes raise); CPU tensors run the plain version."""
    if not q.is_cuda:
        return palu_decode2_ref(q, b_k, x_k, x_v_t, kv_len, block_s=block_s, theta=theta,
                                sliding_window=sliding_window, inv_freq=inv_freq,
                                rope_scale=rope_scale)
    s_max, rv = _check_fp(q, b_k, x_k, x_v_t, kv_len, block_s)
    b, nh, hd = q.shape
    g, hpg, rk = b_k.shape[:3]
    if x_k.dtype != torch.bfloat16 or x_v_t.dtype != torch.bfloat16 or rv % 8 or rv > _MAX_RK:
        raise ValueError(f"palu_decode2 reads bf16 latents with rv a multiple of 8 up to "
                         f"{_MAX_RK}, got {x_k.dtype} / {x_v_t.dtype}, rv {rv}")
    dev = _launch_setup(q, b_k, (x_k, x_v_t), s_max, rk, "palu_decode2")
    if _v2_plan(hd, rk, rv, hpg) is None:
        raise ValueError(f"palu_decode2's kernel is instantiated at hd {V2_HD} and at most "
                         f"{V2_MAX_HEADS} heads a group (one 8-head tile a consumer: the v2 "
                         f"tool's and tests' shapes), with a tile ring and B that fit in a "
                         f"block; got hd {hd}, {hpg} heads, rk {rk}, rv {rv}")
    bk = b_k.contiguous()
    if any(t.data_ptr() % 16 for t in (x_k, x_v_t, bk)):
        raise ValueError("the kernel's TMA loads need the latents and b_k 16-byte aligned")
    splits, grid = _device_splits(dev, b * g, s_max)
    inv = v2_inv_freq(hd // 2, theta, inv_freq, dev)
    kvl = kv_len.to(torch.int32).contiguous()
    n_part, scratch, out, _, _ = _scratch(b, nh, rv, splits, False, 0, dev)
    err = build.launcher("palu_decode_fp_wg", "palu_decode_fp_v2",
                         "pi" + "p" * 9 + "i" * 10 + "ffp")(
        q.contiguous().data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(),
        x_k.data_ptr(), x_v_t.data_ptr(), kvl.data_ptr(), inv.data_ptr(), scratch.data_ptr(),
        scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(), out.data_ptr(), b, g, hpg,
        hd, rk, rv, s_max, int(sliding_window or 0), splits, grid, float(1.0 / math.sqrt(hd)),
        float(rope_scale), build.stream_ptr(dev))
    build.check(err, "palu_decode2")
    palu_decode2.launches += 1
    return out


def _check_quant(q, b_k, xk_codes, xv_codes, kv_len, qcfg: QuantConfig, rk: int, rv: int,
                 block_s: int, rows: dict) -> int:
    """Validate the packed cache; rows maps names to (tensor, shape).
    Returns S."""
    if not (qcfg.enabled and qcfg.group_size == 0):
        raise ValueError(f"the v2 / v3 decodes take per-row quantized latents, got {qcfg}")
    if qcfg.pack_bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported pack width {qcfg.pack_bits}")
    s_max = xk_codes.shape[-1]
    _check_common(q, b_k, kv_len, s_max, block_s)
    b, g = q.shape[0], b_k.shape[0]
    if b_k.shape[2] != rk:
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match rk {rk}")
    for name, c, r in (("xk_codes", xk_codes, rk), ("xv_codes", xv_codes, rv)):
        want = (b, g, packed_nrows(r, qcfg.pack_bits), s_max)
        if tuple(c.shape) != want or c.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 {want}, got {c.dtype} {tuple(c.shape)}")
    for name, (t, shape) in rows.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} {tuple(t.shape)}")
    return s_max


def _codes(codes, qcfg: QuantConfig, rank: int, p0: int, n: int) -> torch.Tensor:
    """(B, G, rank, n) f32 codes of positions [p0, p0 + n)."""
    return unpack_codes_t(codes[..., p0:p0 + n], qcfg.pack_bits, rank).float()


def palu_decode2_quantized_ref(q, b_k, xk_codes, xk_scale, xk_zero, xv_codes, xv_scale,
                               xv_zero, kv_len, *, qcfg: QuantConfig, rk: int, rv: int,
                               block_s: int = 1024, theta: float = 10000.0,
                               sliding_window: Optional[int] = None, inv_freq=None,
                               rope_scale: float = 1.0) -> torch.Tensor:
    """Plain version of palu_decode2_quantized, in f32: the TPU kernel's
    folds on unpacked codes, block by block."""
    b, g = q.shape[0], b_k.shape[0]
    s_max = xk_codes.shape[-1]
    rows = {n: (t, (b, g, s_max)) for n, t in (("xk_scale", xk_scale), ("xk_zero", xk_zero),
                                                ("xv_scale", xv_scale), ("xv_zero", xv_zero))}
    _check_quant(q, b_k, xk_codes, xv_codes, kv_len, qcfg, rk, rv, block_s, rows)

    def reader(codes, scale, zero, rank):
        def read(p0, n):
            return (_codes(codes, qcfg, rank, p0, n), scale[..., p0:p0 + n],
                    zero[..., p0:p0 + n])
        return read

    return _v2_ref(q, b_k, kv_len, reader(xk_codes, xk_scale, xk_zero, rk),
                   reader(xv_codes, xv_scale, xv_zero, rv), s_max, rv, block_s, theta,
                   sliding_window, inv_freq, rope_scale)


def palu_decode2_quantized(q, b_k, xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero,
                           kv_len, *, qcfg: QuantConfig, rk: int, rv: int, block_s: int = 1024,
                           theta: float = 10000.0, sliding_window: Optional[int] = None,
                           inv_freq=None, rope_scale: float = 1.0) -> torch.Tensor:
    """Decode attention over the rank-major packed cache, v2: codes (B, G,
    packed_nrows, S) uint8, scale and zero (B, G, S) f32 each (x = scale *
    code + zero), kv_len (B,). -> (B, nh, rv) f32. block_s (dividing S) is
    the plain version's sequence block. CUDA tensors launch the exact
    kernel (rv also a multiple of 16 up to 512, S at least 64, and shapes
    whose tile ring and B fit in a block's shared memory: others raise)."""
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=block_s, theta=theta,
              sliding_window=sliding_window, inv_freq=inv_freq, rope_scale=rope_scale)
    if not q.is_cuda:
        return palu_decode2_quantized_ref(q, b_k, xk_codes, xk_scale, xk_zero, xv_codes,
                                          xv_scale, xv_zero, kv_len, **kw)
    b, nh, hd = q.shape
    g, hpg = b_k.shape[:2]
    s_max = xk_codes.shape[-1]
    rows = {n: (t, (b, g, s_max)) for n, t in (("xk_scale", xk_scale), ("xk_zero", xk_zero),
                                                ("xv_scale", xv_scale), ("xv_zero", xv_zero))}
    _check_quant(q, b_k, xk_codes, xv_codes, kv_len, qcfg, rk, rv, block_s, rows)
    bufs = (xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero)
    dev = _launch_setup(q, b_k, bufs, s_max, rk, "palu_decode2_quantized")
    nrk, nrv = xk_codes.shape[2], xv_codes.shape[2]
    if rv % 16 or rv > _MAX_RK or s_max < _TILE \
            or _exact_smem(hd, rk, rv, hpg, hpg, nrk, nrv, 1, 1, 1) < 0:
        raise ValueError(f"palu_decode2_quantized's kernel (the exact decode) needs rv a "
                         f"multiple of 16 up to {_MAX_RK}, S >= {_TILE} and a tile ring and B "
                         f"that fit in a block's shared memory (hd={hd}, rk={rk}, rv={rv}, "
                         f"S={s_max}, hpg={hpg})")
    out = exact_launch(q, b_k, *bufs, kv_len, pbits=qcfg.pack_bits, qoff=0, rk=rk, rv=rv,
                       window=int(sliding_window or 0),
                       inv=v2_inv_freq(hd // 2, theta, inv_freq, dev), rope_scale=rope_scale)
    palu_decode2_quantized.launches += 1
    return out


palu_decode2.launches = 0
palu_decode2_quantized.launches = 0
