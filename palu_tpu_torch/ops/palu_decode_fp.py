"""Latent decode attention over the unquantized latent caches (port of
palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode, the v1 kernel over
seq-major latents, and palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4,
the v4 kernel over rank-major latents; both are csrc/palu_decode_fp_wg.cu).

`palu_decode_fp` takes seq-major latents (B, G, S, r), `palu_decode_fp_t`
rank-major latents (B, G, r, S). Each launches the kernel for CUDA tensors
(latents and b_k in bf16, as the engine keeps them) and runs its plain
version, flash_decode_latent over the raw latents in f32, for CPU tensors.
Both return (B, nh, rv) f32 latent-space outputs for the U_v-fused o_proj
and count their launches separately. b_k is JAX's (G, hpg, rk, hd), one B
per q-head, or the compact GQA form (G, hpg / rep, rk, hd), one per
kv-head, as palu_decode takes it (its module docstring); the plain
versions expand the compact form, the kernel rebuilds K once per kv-head.
Both take `k_bias` in b_k's form, Qwen2's pre-RoPE K bias, added to the
rebuilt K before RoPE: the v4 kernel's `k_bias`, and for the seq-major
layout what JAX's engine runs through its XLA flash_decode_latent (the JAX
v1 kernel has no bias).
`palu_decode_fp_t` also takes the v4 kernel's `pos_offset`, `return_stats`
and `layer_idx` (ops/palu_decode.py's docstring; the stacked latents are
(L, B, G, r, S)) for the sequence-parallel and the layer-stacked decodes;
the v1 kernel has none of them.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..runtime import cache as cache_lib
from . import build
from .attention import flash_decode_latent
from .palu_decode import (_MAX_HEADS, _MAX_RK, _SMEM_BUDGET, _TILE, FEATURES, _device_splits,
                          _expand, _inv_freq_t, _layer, _lead, _stats, _up, count_features)
from .palu_decode_seq import _CHUNK, _CHUNK_BYTES, _head_split

__all__ = ["palu_decode_fp", "palu_decode_fp_ref", "palu_decode_fp_t", "palu_decode_fp_t_ref"]


def _check(q, b_k, x_k, x_v, kv_len, rank_major: bool, k_bias=None, layer_idx=None):
    """Validate shapes (of one layer of stacked latents with layer_idx);
    returns (rk, rv, S)."""
    lead = _lead(x_k, layer_idx)
    if lead:
        if x_v.shape[0] != lead[0]:
            raise ValueError(f"x_k and x_v stack {lead[0]} and {x_v.shape[0]} layers")
        x_k, x_v = x_k[0], x_v[0]
    if q.dim() != 3 or b_k.dim() != 4 or x_k.dim() != 4 or x_v.dim() != 4:
        raise ValueError("q must be (B, nh, hd), b_k (G, hpg or hpg / rep, rk, hd) and the "
                         "latents 4-D (5-D stacked)")
    b, nh, hd = q.shape
    g, nkv, rk = b_k.shape[0], b_k.shape[1], b_k.shape[2]
    if nh % g or (nh // g) % nkv or b_k.shape[3] != hd:
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match q {tuple(q.shape)}: its "
                         f"second axis must divide the {nh // max(g, 1)} q-heads per group")
    ax_s, ax_r = (3, 2) if rank_major else (2, 3)
    s_max, rv = x_k.shape[ax_s], x_v.shape[ax_r]
    layout = "(B, G, r, S)" if rank_major else "(B, G, S, r)"
    for name, x, r in (("x_k", x_k, rk), ("x_v", x_v, rv)):
        if tuple(x.shape[:2]) != (b, g) or x.shape[ax_s] != s_max or x.shape[ax_r] != r:
            raise ValueError(f"{name} must be {layout} with B {b}, G {g}, S {s_max}, r {r}; "
                             f"got {tuple(x.shape)}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B,), got {tuple(kv_len.shape)}")
    if k_bias is not None and tuple(k_bias.shape) != (g, nkv, hd):
        raise ValueError(f"k_bias must follow b_k's form, (G, {nkv}, hd) = {(g, nkv, hd)}, "
                         f"got {tuple(k_bias.shape)}")
    return rk, rv, s_max


def _ref(q, b_k, x_k, x_v, kv_len, rank_major, theta, sliding_window, inv_freq,
         rope_scale, k_bias, pos_offset=None, return_stats=False, layer_idx=None):
    rk, rv, s_max = _check(q, b_k, x_k, x_v, kv_len, rank_major, k_bias, layer_idx)
    b_k, k_bias = _expand(q, b_k, k_bias)
    x_k, x_v = _layer(x_k, layer_idx), _layer(x_v, layer_idx)
    chunk = min(512, s_max)
    while s_max % chunk:
        chunk -= 1
    key = "lat_t" if rank_major else "lat"

    def reader(x, rank):
        def read(idx):
            sl = cache_lib.seq_slice({key: x}, idx * chunk, chunk)
            return cache_lib.decode_latents(sl, None, rank, torch.float32)
        return read

    out = flash_decode_latent(
        q.float(), reader(x_k, rk), reader(x_v, rv), b_k.float(), s_max // chunk, chunk,
        kv_len, q.shape[-1], theta, rv, sliding_window, inv_freq=inv_freq,
        rope_scale=rope_scale, k_bias=k_bias, pos_offset=int(pos_offset or 0),
        return_stats=return_stats)
    if return_stats:
        return _stats(*out, q.shape[0], q.shape[1], rv)
    return out


@functools.lru_cache(maxsize=64)
def _fp_plan(hd: int, rk: int, rv: int, hpg: int, nkv: int, ring: int = 0) -> Optional[dict]:
    """The kernel's shared-memory plan over bf16 latents
    (csrc/palu_decode_fp_wg.cu::plan_for / make_plan, the same function):
    `smem` bytes a launch takes, `ns` ring chunks of 16 KB, `nb` B slots per
    consumer, `resident` (B loaded once per work item), `nt` 8-head tiles a
    consumer, `hsplit` (consumer 0's q-heads); None when no plan fits in one
    block. ring > 0: a ring of that many chunks and no B slot (the
    dissection's modes with no K work)."""
    hs = _head_split(hpg, nkv)
    rep = hpg // nkv
    nkv0 = (hs - 1) // rep + 1 if hs > 0 else 0
    nkv1 = (hpg - 1) // rep + 1 - hs // rep if hpg > hs else 0
    nt = 2 if max(hs, hpg - hs) > 8 else 1
    npw = 8 * nt
    nck, ncv = -(-rk // _CHUNK), -(-rv // _CHUNK)
    slot = _CHUNK * hd * 2

    def total(ns: int, nb: int) -> int:
        o = _up(ns * _CHUNK_BYTES + 2 * nb * slot, 1024)
        o += 2 * 2 * npw * 128 + 2 * npw * hd * 4 + 2 * npw * _TILE * 4 + 2 * 3 * npw * 4
        return _up(o, 8) + 8 * (2 * ns + 4 * nb)

    def take(ns, nb, resident):
        t = total(ns, nb)
        return None if t > _SMEM_BUDGET else {"smem": t + 1024, "ns": ns, "nb": nb,
                                              "resident": resident, "nt": nt, "hsplit": hs}

    if ring:
        return take(ring, 0, 0)
    nb_res = max(nkv0, nkv1) * nck or 1
    for ns in range(8, nck, -1):  # B resident, the ring at least a tile's K chunks plus one
        if total(ns, nb_res) <= _SMEM_BUDGET:
            return take(ns, nb_res, 1)
    for ns in range(min(8, nck + ncv + 1), nck, -1):  # B streamed through nb >= 2 slots
        nb = 2
        if total(ns, nb) > _SMEM_BUDGET:
            continue
        while nb < 8 and total(ns, nb + 1) <= _SMEM_BUDGET:
            nb += 1
        return take(ns, nb, 0)
    return None


@functools.lru_cache(maxsize=64)
def _smem(hd: int, rk: int, rv: int, hpg: int, nkv: int) -> int:
    """The kernel's shared memory at these shapes, or -1 when no plan of it
    fits in one block."""
    return build.launcher("palu_decode_fp_wg", "palu_decode_fp_wg_smem", "i" * 5)(
        hd, rk, rv, hpg, nkv)


def _launch(q, b_k, x_k, x_v, kv_len, rank_major, theta, sliding_window, inv_freq,
            rope_scale, k_bias, pos_offset=None, return_stats=False, layer_idx=None):
    rk, rv, s_max = _check(q, b_k, x_k, x_v, kv_len, rank_major, k_bias, layer_idx)
    b, nh, hd = q.shape
    g, nkv = b_k.shape[0], b_k.shape[1]
    hpg = nh // g
    if b_k.dtype != torch.bfloat16 or x_k.dtype != torch.bfloat16 or x_v.dtype != torch.bfloat16:
        raise ValueError(f"the fp decode kernel reads b_k and the latents as bf16, got "
                         f"{b_k.dtype}, {x_k.dtype}, {x_v.dtype}")
    if (hd not in (64, 128) or rk % 16 or rk > _MAX_RK or rv % 8 or rv > _MAX_RK
            or hpg > _MAX_HEADS or s_max % 8):
        raise ValueError(f"fp decode kernel needs hd 64 or 128, rk a multiple of 16 and rv "
                         f"of 8, both up to {_MAX_RK}, S a multiple of 8 and <= {_MAX_HEADS} "
                         f"heads per group (hd={hd}, rk={rk}, rv={rv}, S={s_max}, hpg={hpg})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    if len({t.device for t in (q, b_k, x_k, x_v, kv_len, k_bias) if t is not None}) != 1:
        raise ValueError("all tensors must be on one device")
    if not (x_k.is_contiguous() and x_v.is_contiguous()):
        raise ValueError("cache buffers must be contiguous")
    if any(t.data_ptr() % 16 for t in (x_k, x_v, b_k)):
        raise ValueError("the kernel's TMA loads need the latents and b_k 16-byte aligned")
    if _smem(hd, rk, rv, hpg, nkv) < 0:
        raise ValueError(f"the fp decode kernel's tile ring and B do not fit in a block's "
                         f"shared memory at hd {hd}, rk {rk}, rv {rv}, {hpg} heads per group "
                         f"over {nkv} kv-heads")
    dev = q.device
    off = int(pos_offset or 0)
    if off < 0:
        raise ValueError(f"pos_offset must be >= 0, got {off}")
    inv = _inv_freq_t(hd, float(theta), None if inv_freq is None else tuple(
        float(x) for x in np.asarray(inv_freq)), str(dev))
    qc = q.contiguous()
    bk = b_k.contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    kbias = None if k_bias is None else k_bias.float().contiguous()
    splits, grid = _device_splits(dev, b * g, s_max)
    # one allocation: per-split m, l, accumulators, then the output (and
    # with return_stats its m and l)
    n_part = b * nh * splits
    n_out = b * nh * (rv + (2 if return_stats else 0))
    scratch = torch.empty(n_part * (2 + rv) + n_out, dtype=torch.float32, device=dev)
    out = scratch[n_part * (2 + rv):n_part * (2 + rv) + b * nh * rv].view(b, nh, rv)
    m_out = l_out = None
    if return_stats:
        m_out = scratch[-2 * b * nh:-b * nh].view(b, nh)
        l_out = scratch[-b * nh:].view(b, nh)
    err = build.launcher("palu_decode_fp_wg", "palu_decode_fp_wg",
                         "pi" + "p" * 10 + "i" * 15 + "ff" + "ppp")(
        qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(), x_k.data_ptr(),
        x_v.data_ptr(), kvl.data_ptr(), None if kbias is None else kbias.data_ptr(),
        inv.data_ptr(), scratch.data_ptr(), scratch[n_part:].data_ptr(),
        scratch[2 * n_part:].data_ptr(), out.data_ptr(), b, g, hpg, nkv, hd, rk, rv, s_max,
        int(rank_major), int(sliding_window or 0), splits, grid, int(layer_idx or 0),
        x_k.shape[0] if layer_idx is not None else 1, off, float(1.0 / math.sqrt(hd)),
        float(rope_scale), None if m_out is None else m_out.data_ptr(),
        None if l_out is None else l_out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "palu_decode_fp_t" if rank_major else "palu_decode_fp")
    return (out, m_out, l_out) if return_stats else out


def palu_decode_fp_ref(q, b_k, x_k, x_v, kv_len, *, theta: float = 10000.0,
                       sliding_window: Optional[int] = None, inv_freq=None,
                       rope_scale: float = 1.0, k_bias=None) -> torch.Tensor:
    """Plain version of palu_decode_fp: flash_decode_latent in f32 over the
    seq-major latents, in chunks of up to 512 positions."""
    return _ref(q, b_k, x_k, x_v, kv_len, False, theta, sliding_window, inv_freq, rope_scale,
                k_bias)


def palu_decode_fp(q, b_k, x_k, x_v, kv_len, *, theta: float = 10000.0,
                   sliding_window: Optional[int] = None, inv_freq=None,
                   rope_scale: float = 1.0, k_bias=None) -> torch.Tensor:
    """Decode attention over seq-major latents.

    q (B, nh, hd) roped at the current position; b_k (G, hpg, rk, hd) or
    the compact (G, hpg / rep, rk, hd); x_k (B, G, S, rk), x_v (B, G, S,
    rv) pre-RoPE latents; kv_len (B,) valid positions; k_bias None or (G,
    b_k.shape[1], hd). -> (B, nh, rv) f32. CUDA tensors launch the kernel
    (csrc/palu_decode_fp_wg.cu: hd 64 or 128, rk a multiple of 16 and rv of
    8, both up to 512, S a multiple of 8, <= 32 heads per group, and shapes
    whose tile ring and B fit in a block's shared memory: others raise);
    CPU tensors run the plain version."""
    if not q.is_cuda:
        return palu_decode_fp_ref(q, b_k, x_k, x_v, kv_len, theta=theta,
                                  sliding_window=sliding_window, inv_freq=inv_freq,
                                  rope_scale=rope_scale, k_bias=k_bias)
    out = _launch(q, b_k, x_k, x_v, kv_len, False, theta, sliding_window, inv_freq, rope_scale,
                  k_bias)
    palu_decode_fp.launches += 1
    return out


def palu_decode_fp_t_ref(q, b_k, xk_t, xv_t, kv_len, *, theta: float = 10000.0,
                         sliding_window: Optional[int] = None, inv_freq=None,
                         rope_scale: float = 1.0, k_bias=None,
                         pos_offset: Optional[int] = None, return_stats: bool = False,
                         layer_idx: Optional[int] = None):
    """Plain version of palu_decode_fp_t: flash_decode_latent in f32 over
    the rank-major latents (layer layer_idx of stacked ones), in chunks of
    up to 512 positions."""
    return _ref(q, b_k, xk_t, xv_t, kv_len, True, theta, sliding_window, inv_freq, rope_scale,
                k_bias, pos_offset, return_stats, layer_idx)


def palu_decode_fp_t(q, b_k, xk_t, xv_t, kv_len, *, theta: float = 10000.0,
                     sliding_window: Optional[int] = None, inv_freq=None,
                     rope_scale: float = 1.0, k_bias=None, pos_offset: Optional[int] = None,
                     return_stats: bool = False, layer_idx: Optional[int] = None):
    """Decode attention over rank-major latents xk_t (B, G, rk, S), xv_t
    (B, G, rv, S), or (L, ...) stacks of them with layer_idx; otherwise as
    palu_decode_fp. pos_offset and return_stats as in palu_decode (then
    (acc, m, l) is returned); each feature a launch uses adds one to
    `palu_decode_fp_t.feature_launches`."""
    if not q.is_cuda:
        return palu_decode_fp_t_ref(q, b_k, xk_t, xv_t, kv_len, theta=theta,
                                    sliding_window=sliding_window, inv_freq=inv_freq,
                                    rope_scale=rope_scale, k_bias=k_bias,
                                    pos_offset=pos_offset, return_stats=return_stats,
                                    layer_idx=layer_idx)
    out = _launch(q, b_k, xk_t, xv_t, kv_len, True, theta, sliding_window, inv_freq, rope_scale,
                  k_bias, pos_offset, return_stats, layer_idx)
    palu_decode_fp_t.launches += 1
    count_features(palu_decode_fp_t, pos_offset, return_stats, layer_idx)
    return out


palu_decode_fp.launches = 0
palu_decode_fp_t.launches = 0
palu_decode_fp_t.feature_launches = dict.fromkeys(FEATURES, 0)
