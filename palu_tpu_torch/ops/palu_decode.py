"""Latent decode attention over the rank-major packed cache (port of
palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized; the
kernels are csrc/palu_decode_exact.cu for the exact modes and
csrc/palu_decode_i8.cu for the int8 ones).

`palu_decode` launches the kernel for CUDA tensors and runs `palu_decode_ref`,
its plain version, for CPU tensors. b_k is JAX's (G, hpg, rk, hd), one B
per q-head, or the compact GQA form (G, hpg / rep, rk, hd), one per
kv-head, where the rep q-heads h * rep .. h * rep + rep - 1 of a group read
kv-head h (rep = nh / (G * b_k.shape[1]), from the shapes); k_bias follows
b_k's form. The plain version expands the compact form with
repeat_interleave; the kernels rebuild K once per kv-head. Per-row scales
(B, G, S) or per-chunk row stacks (B, G, rank // group_size, S) (the
reference's --lt_group_size), symmetric or asymmetric, pack widths
2/3/4/8. Returns (B, nh, rv) f32 latent-space outputs for the U_v-fused
o_proj. `k_bias` adds
Qwen2's pre-RoPE K bias: K = lat @ B + b before RoPE in the exact mode; in
the int8 modes, as in the JAX kernel, the cache-independent logit term
U_b . rcos + V_b . rsin with U_b = a1 b1 + a2 b2 and V_b = a2 b1 - a1 b2 (a1 /
a2 the query rotated to the block's start), added after the per-token scale.

The K path runs in one of three modes, as in the JAX kernel:
  exact     - K rebuilt from the codes in f32 (the plain version is
              flash_decode_latent over decode_latents, in f32);
  int8_dots - the query is folded into the reconstruction operand per
              rotation block of `block_s` tokens (bq1 = a1 B1^T + a2 B2^T,
              bq2 = a2 B1^T - a1 B2^T, a1/a2 the query rotated to the
              block's start), the operand is quantized to int8 per row and
              dotted with the raw codes in int32, then rotated in f32
              against the block-relative tables;
  int8_rot  - the operand quantized per head, the rotation done in int32
              against int8 tables round(cos_rel * 63 / cmax), floats only
              on each head's sum.
Both int8 modes take unsigned codes and fold the symmetric offset, or the
asymmetric zero rows, into a correction built from the quantized
operand's row sums (the JAX default `fold_qoff`); their result depends on
`block_s`. They take per-row scales only: a per-chunk scale cannot fold
past the dots (JAX's asserts, palu_decode4.py:678-690), so per-chunk caches
run the exact mode, which dequantizes each rank chunk before its dots.

Three more features of the JAX kernel serve the sequence-parallel and the
layer-stacked decodes, in every mode:
  pos_offset   - the buffer holds one sequence shard: column t is absolute
                 position pos_offset + t. RoPE takes the absolute position
                 (the exact mode's kernel forms each token's rotation from
                 it, the int8 modes rotate the query by each block's
                 absolute start); kv_len stays absolute and the window
                 with it.
  return_stats - return (acc (B, nh, rv), m (B, nh), l (B, nh)) f32: the
                 accumulator not divided by the softmax denominator l, and
                 the running max m, for the cross-shard combine
                 (ops/attention.py). A shard with no valid column gives
                 m = -1e30, l = 0, acc = 0.
  layer_idx    - the cache buffers carry a leading layer axis, codes
                 (L, B, G, nrows, S), per-row scales and zeros (L, B, G, S)
                 (runtime/cache.stacked_squeeze) or per-chunk row stacks
                 (L, B, G, n_sc, S); the kernel reads layer layer_idx of
                 them itself.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..core.quant import QuantConfig, packed_nrows, unpack_codes_t
from ..runtime import cache as cache_lib
from . import build
from .attention import _inv_freq, flash_decode_latent

__all__ = ["palu_decode", "palu_decode_ref", "k_path_mode", "FEATURES"]

_TILE = 64        # tokens per kernel tile (kTile in the sources)
_MAX_HEADS = 32   # q-heads per group the kernels hold (kMaxHeads): Qwen2-7B has 28
_MAX_RK = 512     # kMaxRank: a G-LRD group's rank at group size 4 and hd 128


def _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero, k_bias=None, layer_idx=None):
    if not qcfg.enabled:
        raise ValueError(f"decode needs quantized latents, got {qcfg}")
    gs = qcfg.group_size
    if gs > 0 and (gs % 8 or rk % gs or rv % gs):
        raise ValueError(f"per-chunk scales need a chunk that is a multiple of 8 and divides "
                         f"rk {rk} and rv {rv}, got group_size {gs}")
    if qcfg.pack_bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported pack width {qcfg.pack_bits}")
    if qcfg.sym != (xk_zero is None and xv_zero is None):
        raise ValueError("zero rows must be given exactly when qcfg is asymmetric")
    if q.dim() != 3 or b_k.dim() != 4:
        raise ValueError("q must be (B, nh, hd) and b_k (G, hpg or hpg / rep, rk, hd)")
    b, nh, hd = q.shape
    g, nkv = b_k.shape[0], b_k.shape[1]
    if nh % g or (nh // g) % nkv or tuple(b_k.shape[2:]) != (rk, hd):
        raise ValueError(f"b_k {tuple(b_k.shape)} does not match q {tuple(q.shape)} / rk {rk}: "
                         f"its second axis must divide the {nh // max(g, 1)} q-heads per group")
    s_max = xk_codes.shape[-1]
    lead = _lead(xk_codes, layer_idx)
    for name, c, r in (("xk_codes", xk_codes, rk), ("xv_codes", xv_codes, rv)):
        want = lead + (b, g, packed_nrows(r, qcfg.pack_bits), s_max)
        if tuple(c.shape) != want or c.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 {want}, got {c.dtype} {tuple(c.shape)}")
    n_l = lead[0] if lead else 1
    for name, t, r in (("xk_scale", xk_scale, rk), ("xv_scale", xv_scale, rv),
                       ("xk_zero", xk_zero, rk), ("xv_zero", xv_zero, rv)):
        if t is None:
            continue
        if gs > 0:
            if tuple(t.shape) != lead + (b, g, r // gs, s_max) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {lead} + (B, G, {r // gs}, S) row stacks")
        elif (t.numel() != n_l * b * g * s_max or t.shape[:len(lead)] != lead
              or t.shape[-1] != s_max or t.dtype != torch.float32):
            raise ValueError(f"{name} must be f32 {lead} + (B, G, S) or (B, G, 1, S)")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B,), got {tuple(kv_len.shape)}")
    if k_bias is not None and tuple(k_bias.shape) != (g, nkv, hd):
        raise ValueError(f"k_bias must follow b_k's form, (G, {nkv}, hd) = {(g, nkv, hd)}, "
                         f"got {tuple(k_bias.shape)}")


def _expand(q, b_k, k_bias) -> tuple:
    """b_k and k_bias in JAX's repeated form, one row per q-head (a copy
    only when given the compact form)."""
    rep = q.shape[1] // (b_k.shape[0] * b_k.shape[1])
    if rep == 1:
        return b_k, k_bias
    return (b_k.repeat_interleave(rep, dim=1),
            None if k_bias is None else k_bias.repeat_interleave(rep, dim=1))


def _lead(buf: torch.Tensor, layer_idx) -> tuple:
    """The leading layer axis, (L,), of a layer-stacked buffer (layer_idx
    given; raises when it is out of range), else ()."""
    if layer_idx is None:
        return ()
    n_l = buf.shape[0]
    if not 0 <= int(layer_idx) < n_l:
        raise ValueError(f"layer_idx {layer_idx} outside a stack of {n_l} layers")
    return (n_l,)


def _layer(t, layer_idx):
    """Layer layer_idx of a stacked buffer, for the plain versions."""
    return t if t is None or layer_idx is None else t[int(layer_idx)]


def _stats(m, l, acc, b: int, nh: int, rv: int) -> tuple:
    """(m, l, acc) over (B, G, hpg[, rv]) -> (acc (B, nh, rv), m (B, nh),
    l (B, nh)), the JAX kernel's return_stats order."""
    return acc.reshape(b, nh, rv), m.reshape(b, nh), l.reshape(b, nh)


def k_path_mode(qcfg: QuantConfig, rk: int, hd: int, *, int8_dots: bool = False,
                int8_rot: bool = False) -> str:
    """Validate the int8 K-path knobs as palu_decode4._call4 does and name
    the mode: "exact", "int8_dots" or "int8_rot" (which wins over
    int8_dots, as in the JAX kernel)."""
    pb = qcfg.pack_bits
    if (int8_dots or int8_rot) and qcfg.group_size > 0:
        raise ValueError("int8_dots / int8_rot need per-row scales (group_size 0): a "
                         "per-chunk scale cannot fold past the int8 dots")
    if (int8_dots or int8_rot) and pb > 4:
        raise ValueError("int8_dots / int8_rot need sub-byte codes (pack width <= 4)")
    if int8_rot and 63 * 127 * (2**pb - 1) * rk * (hd // 2) >= 2**31:
        raise ValueError(f"int8_rot int32 segment sums would overflow at rk={rk}, "
                         f"half={hd // 2}, pack={pb}")
    return "int8_rot" if int8_rot else "int8_dots" if int8_dots else "exact"


def _bufs(codes, scale, zero):
    """A cache-layer view (codes_t, scale_t, zero_t) with (B, G, n_sc, S)
    scale rows."""
    b, g, _, s_max = codes.shape
    out = {"codes_t": codes, "scale_t": scale.reshape(b, g, -1, s_max)}
    if zero is not None:
        out["zero_t"] = zero.reshape(b, g, -1, s_max)
    return out


def _inv_freq64(half: int, theta: float, inv_key) -> np.ndarray:
    if inv_key is not None:
        return np.asarray(inv_key, np.float64).reshape(half)
    return 1.0 / theta ** (np.arange(half, dtype=np.float64) * 2 / (2 * half))


@functools.lru_cache(maxsize=8)
def _int8_tables(s_max: int, block_s: int, half: int, theta: float, inv_key,
                 rope_scale: float, device: str, pos_offset: int = 0) -> dict:
    """The int8 modes' tables, built in f64 and rounded as the JAX wrapper
    does: c0 / s0 (S / block_s, hd/2) f32, the rotation at each block's
    absolute start pos_offset + j * block_s; rcos / rsin (block_s, hd/2)
    f32, the block-relative rotation; cos8 / sin8 (block_s, hd/2) int8 at
    scale 63 / cmax, and its inverse. (JAX forms the offset block angles in
    f32, palu_decode4.py:743-751; f64 here: at 64K that is ~4e-3 rad
    closer to the exact angle.)"""
    inv = _inv_freq64(half, theta, inv_key)
    rel = np.arange(block_s, dtype=np.float64)[:, None] * inv[None, :]
    rcos = (np.cos(rel) * rope_scale).astype(np.float32)
    rsin = (np.sin(rel) * rope_scale).astype(np.float32)
    cmax = float(max(np.abs(rcos).max(), np.abs(rsin).max(), 1e-9))
    i8q = 63.0 / cmax
    ang0 = (pos_offset + np.arange(s_max // block_s, dtype=np.float64) * block_s)[:, None] \
        * inv[None, :]
    dev = torch.device(device)
    out = {"c0": np.cos(ang0).astype(np.float32), "s0": np.sin(ang0).astype(np.float32),
           "rcos": rcos, "rsin": rsin, "cos8": np.round(rcos * i8q).astype(np.int8),
           "sin8": np.round(rsin * i8q).astype(np.int8)}
    out = {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
    out["i8r_inv"] = float(1.0 / i8q)
    return out


def _tables8(s_max, block_s, hd, theta, inv_freq, rope_scale, device, pos_offset=0) -> dict:
    if block_s < 1 or s_max % block_s:
        raise ValueError(f"block_s {block_s} must divide S {s_max}")
    key = None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))
    return _int8_tables(s_max, block_s, hd // 2, float(theta), key, float(rope_scale),
                        str(torch.device(device)), int(pos_offset))


def _int8_ref(q, b_k, kb, vb, kv_len, qcfg, rk, rv, theta, sliding_window, inv_freq,
              rope_scale, block_s, rot: bool, k_bias=None, pos_offset: int = 0,
              return_stats: bool = False):
    """Plain version of the int8 K-path modes, block by block as the JAX
    kernel runs them; the int32 dots are f32 products of integers (exact
    below 2^24) and int8_rot's int32 rotation sums run in f64 (exact).
    k_bias adds its logit term in f32 after the scale and the correction."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    half = hd // 2
    s_max = kb["codes_t"].shape[-1]
    tab = _tables8(s_max, block_s, hd, theta, inv_freq, rope_scale, q.device, pos_offset)
    qf = (q.float() / math.sqrt(hd)).reshape(b, g, hpg, hd)
    q1, q2 = qf[..., :half], qf[..., half:]
    bkt = b_k.float().transpose(-1, -2)  # (G, hpg, hd, rk)
    b1, b2 = bkt[:, :, :half], bkt[:, :, half:]
    ks = kb["scale_t"].reshape(b, g, 1, s_max)
    qoff = 2 ** (qcfg.bits - 1)
    kz = kb["zero_t"].reshape(b, g, 1, s_max) if "zero_t" in kb else ks * float(-qoff)
    rcos, rsin = tab["rcos"].t(), tab["rsin"].t()  # (hd/2, block_s)
    kvl = kv_len.to(q.device).long()[:, None] - pos_offset  # column coordinates
    if k_bias is not None:
        kb1, kb2 = k_bias.float()[..., :half], k_bias.float()[..., half:]  # (G, hpg, hd/2)
    m = torch.full((b, g, hpg), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, hpg, rv), dtype=torch.float32, device=q.device)

    def quant(bq):
        amax = bq.abs().amax(-1, keepdim=True)  # (B, G, hpg, hd/2, 1)
        if rot:
            amax = amax.amax(-2, keepdim=True)
        s = torch.clamp(amax, min=1e-30) * float(np.float32(1.0 / 127.0))
        return torch.round(bq / s), s[..., 0]

    for j in range(s_max // block_s):
        p0 = j * block_s
        c, s = tab["c0"][j], tab["s0"][j]
        a1 = (q1 * c + q2 * s)[..., None]
        a2 = (q2 * c - q1 * s)[..., None]
        n1, s1 = quant(a1 * b1 + a2 * b2)  # (B, G, hpg, hd/2, rk)
        n2, s2 = quant(a2 * b1 - a1 * b2)
        ck = unpack_codes_t(kb["codes_t"][..., p0:p0 + block_s], qcfg.pack_bits,
                            rk).float()  # (B, G, rk, block_s) unsigned
        u = torch.einsum("bgher,bgrt->bghet", n1, ck)
        v = torch.einsum("bgher,bgrt->bghet", n2, ck)
        if rot:
            t1 = (tab["cos8"].t().double() * u.double()).sum(-2).float()
            t2 = (tab["sin8"].t().double() * v.double()).sum(-2).float()
            inv = float(np.float32(tab["i8r_inv"]))
            lg = t1 * (s1 * inv) + t2 * (s2 * inv)
        else:
            lg = (u * s1[..., None] * rcos + v * s2[..., None] * rsin).sum(-2)
        lg = lg * ks[..., p0:p0 + block_s]
        r1 = n1.sum(-1) * s1  # row sums of the quantized operand, (B, G, hpg, hd/2)
        r2 = n2.sum(-1) * s2
        corr = torch.einsum("bghe,et->bght", r1, rcos) + torch.einsum("bghe,et->bght", r2, rsin)
        lg = lg + corr * kz[..., p0:p0 + block_s]
        if k_bias is not None:  # cache-independent: after the scale and correction
            ub = a1[..., 0] * kb1 + a2[..., 0] * kb2  # (B, G, hpg, hd/2)
            vb_ = a2[..., 0] * kb1 - a1[..., 0] * kb2
            lg = lg + (torch.einsum("bghe,et->bght", ub, rcos)
                       + torch.einsum("bghe,et->bght", vb_, rsin))
        pos = p0 + torch.arange(block_s, device=q.device)[None, :]
        valid = pos < kvl
        if sliding_window is not None:
            valid &= pos > (kvl - 1) - sliding_window
        valid = valid[:, None, None, :]
        lg = torch.where(valid, lg, -1e30)
        m_new = torch.maximum(m, lg.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(lg - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        xv = cache_lib.decode_latents(cache_lib.seq_slice(vb, p0, block_s), qcfg, rv,
                                      torch.float32)
        acc = acc * alpha[..., None] + torch.einsum("bght,bgtr->bghr", p, xv)
        m = m_new
    if return_stats:
        return _stats(m, l, acc, b, nh, rv)
    return (acc / l[..., None]).reshape(b, nh, rv)


def palu_decode_ref(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, *,
                    qcfg: QuantConfig, rk: int, rv: int, theta: float = 10000.0,
                    sliding_window: Optional[int] = None, inv_freq=None,
                    rope_scale: float = 1.0, xk_zero=None, xv_zero=None,
                    block_s: int = 1024, int8_dots: bool = False,
                    int8_rot: bool = False, k_bias=None, pos_offset: Optional[int] = None,
                    return_stats: bool = False, layer_idx: Optional[int] = None):
    """Plain version. Exact mode: dequantize the cache (decode_latents, per
    row or per chunk) and run flash_decode_latent in f32 on the same inputs,
    in chunks of up to 512 positions. int8 modes: _int8_ref. layer_idx
    takes layer layer_idx of the stacked buffers. The compact b_k / k_bias
    form is expanded first."""
    _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero, k_bias, layer_idx)
    b_k, k_bias = _expand(q, b_k, k_bias)
    xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero = (
        _layer(t, layer_idx) for t in (xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero))
    off = int(pos_offset or 0)
    mode = k_path_mode(qcfg, rk, q.shape[-1], int8_dots=int8_dots, int8_rot=int8_rot)
    if mode != "exact":
        return _int8_ref(q, b_k, _bufs(xk_codes, xk_scale, xk_zero),
                         _bufs(xv_codes, xv_scale, xv_zero), kv_len, qcfg, rk, rv, theta,
                         sliding_window, inv_freq, rope_scale, block_s, mode == "int8_rot",
                         k_bias, off, return_stats)
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

    out = flash_decode_latent(
        q.float(), reader(kb, rk), reader(vb, rv), b_k.float(), s_max // chunk,
        chunk, kv_len, q.shape[-1], theta, rv, sliding_window,
        inv_freq=inv_freq, rope_scale=rope_scale, k_bias=k_bias, pos_offset=off,
        return_stats=return_stats)
    if return_stats:
        return _stats(*out, q.shape[0], q.shape[1], rv)
    return out


@functools.lru_cache(maxsize=8)
def _tables(s_max: int, half: int, theta: float, inv_key, rope_scale: float,
            device: str):
    dev = torch.device(device)
    inv = _inv_freq(2 * half, theta, None if inv_key is None else np.asarray(inv_key), dev)
    freqs = torch.arange(s_max, device=dev).float()[:, None] * inv
    return ((torch.cos(freqs) * rope_scale).contiguous(),
            (torch.sin(freqs) * rope_scale).contiguous())


def _rope_tables(s_max: int, head_dim: int, theta: float, inv_freq, rope_scale: float,
                device, pos_offset: int = 0) -> tuple:
    """f32 (S, hd/2) cos/sin tables at absolute positions pos_offset + t,
    computed with the same f32 operations flash_decode_latent applies per
    chunk. With an offset the rows are a view of a table of pos_offset + S
    rows (each row is computed on its own, so the table's length does not
    change its values)."""
    key = None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))
    cos_t, sin_t = _tables(pos_offset + s_max, head_dim // 2, float(theta), key, float(rope_scale),
                           str(torch.device(device)))
    if pos_offset:
        return cos_t[pos_offset:pos_offset + s_max], sin_t[pos_offset:pos_offset + s_max]
    return cos_t, sin_t


def _splits(sms: int, blocks_per_sm: int, n_bg: int, s_max: int) -> tuple:
    """The sequence split of a decode launch over n_bg (lane, group) pairs:
    (splits, blocks). A work item is one (lane, group, split); the items
    number at most sms * blocks_per_sm when n_bg allows (at least one split
    each), and the blocks, which loop over the items, never exceed one
    wave. The kernels cut each lane's valid tiles into the splits
    (_item_tiles); no split of a whole-S lane is empty."""
    tiles = -(-s_max // _TILE)
    slots = sms * blocks_per_sm
    splits = min(tiles, max(1, slots // n_bg))
    splits = -(-tiles // -(-tiles // splits))
    return splits, min(n_bg * splits, slots)


def _item_tiles(kv_len: int, pos_offset: int, window: Optional[int], s_max: int, splits: int,
                split: int) -> tuple:
    """The tiles [t0, t1) that work item `split` of a (lane, group) walks in
    the one-wave decode kernels (csrc/decode_common.cuh::tile_range, the
    same function): the lane's valid columns [vlo, vhi) (kv_len and the
    window in column coordinates, column t at absolute position pos_offset
    + t) cover tiles [lo, lo + n), cut into runs of ceil(n / splits); a
    split past them is empty (t1 <= t0)."""
    kvl = kv_len - pos_offset
    vlo = max(0, kvl - window) if window else 0
    vhi = max(0, min(kvl, s_max))
    lo = vlo // _TILE
    n = max(0, -(-vhi // _TILE) - lo)
    per = -(-n // splits)
    t0 = lo + split * per
    return t0, min(t0 + per, lo + n)


def _item_visits(kv_len: int, pos_offset: int, window: Optional[int], s_max: int, splits: int,
                 split: int, nch: int, block_s: int) -> list:
    """The visits of work item `split` in the int8 modes' kernel
    (csrc/palu_decode_i8.cu::visit_at): (head chunk, tile, new operand) for
    each of the nch head chunks over the item's tiles (_item_tiles), in
    order; a new operand at each chunk's first tile and where a rotation
    block of block_s tokens starts."""
    t0, t1 = _item_tiles(kv_len, pos_offset, window, s_max, splits, split)
    return [(c, t, t == t0 or t * _TILE % block_s == 0)
            for c in range(nch) for t in range(t0, t1)]


_SMEM_BUDGET = 232448 - 1024  # a block's shared memory, less the 1024-byte alignment slack


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


@functools.lru_cache(maxsize=64)
def _i8_plan(hd: int, rk: int, rv: int, hpg: int, nrk: int, nrv: int, asym: bool, mode: int,
             bias: bool) -> Optional[dict]:
    """The int8 kernel's shared-memory plan (csrc/palu_decode_i8.cu::
    make_plan, the same function): `smem` bytes a launch takes, `ns` tile
    stages, `nob` operand slots, `nst` staging buffers of B and `chunk`
    heads per slot (`nch` chunks), or None when no plan fits in one block.
    A stage holds one 64-token tile of the K and V byte planes and the
    scale (and zero) rows; a slot holds `chunk` heads' int8 operands (hd
    rows of ceil(rk / 128) 128-byte blocks) and three per-row f32 arrays
    (two without a bias); a staging buffer `bch` ranks of one head's B in
    bf16 (min(rk, 128), else 64, else 32); the A tile the tile's codes as
    s8. Preferred: all heads in two slots, then in one, with 3 stages (2
    last) and 2 staging buffers before 1, all with the largest staging
    buffers before any with smaller ones; else the most heads per chunk
    that fit."""
    np_ = 8 if hpg <= 8 else 32
    nbox_k, nbox_v = -(-nrk // 256), -(-nrv // 256)
    rows_k, rows_v = -(-nrk // nbox_k), -(-nrv // nbox_v)
    stage = _up(nbox_k * rows_k * _TILE, 128) + _up(nbox_v * rows_v * _TILE, 128)
    stage += 2 * _up(_TILE * 4, 128) * (2 if asym else 1)
    head = -(-rk // 128) * hd * 128
    half = hd // 2

    def total(ns: int, nob: int, nst: int, bch: int, chunk: int) -> int:
        slot = _up(chunk * head + chunk * hd * 4 * (3 if bias else 2), 1024)
        t = _up(ns * stage, 1024) + nob * slot + nst * bch * hd * 2
        t = _up(t, 1024) + -(-rk // 128) * _TILE * 128  # the A tile
        t += 2 * _TILE * (half + 4) * 4 + (_up(2 * _TILE * (half + 4), 16) if mode == 2 else 0)
        t += 2 * chunk * _TILE * 4
        t = _up(t, 1024) + 2 * np_ * 128
        t += hpg * _TILE * 4 + rv * 4 + rk * 4 + 4 * _MAX_HEADS * 4 + 4 * chunk * hd * 4
        return _up(t, 8) + 8 * (2 * ns + 2 * nob + nst + 4)

    tries = [(nob, ns, nst) for nob, ns, nst in ((2, 3, 2), (2, 3, 1), (1, 3, 2), (1, 3, 1),
                                                  (1, 2, 1))]
    bchs = [min(rk, 128)] + [b for b in (64, 32) if b < min(rk, 128)]
    for chunks in ((hpg,), range(hpg - 1, 0, -1)):
        for bch in bchs:
            for nob, ns, nst in tries:
                for chunk in chunks:
                    t = total(ns, nob, nst, bch, chunk)
                    if t <= _SMEM_BUDGET:
                        return {"smem": t + 1024, "ns": ns, "nob": nob, "nst": nst, "bch": bch,
                                "chunk": chunk, "nch": -(-hpg // chunk)}
    return None


def _i8_launch_plan(hd: int, rk: int, rv: int, hpg: int, nrk: int, nrv: int, asym: bool,
                    mode: int, bias: bool, block_s: int, s_max: int) -> dict:
    """The int8 kernel's plan for a launch (_i8_plan); raises ValueError
    where the kernel cannot run: hd other than 64 and 128, rk not a
    multiple of 32 or above 512, rv above 512, more than 32 heads per group,
    block_s not a multiple of 64 (a tile would straddle two rotation blocks)
    or not dividing S, or no plan that fits in a block's shared memory."""
    if (hd not in (64, 128) or rk <= 0 or rk % 32 or rk > _MAX_RK or rv > _MAX_RK
            or hpg > _MAX_HEADS or block_s <= 0 or block_s % _TILE or s_max % block_s):
        raise ValueError(f"the int8 modes' kernel needs hd 64 or 128, rk a multiple of 32 up to "
                         f"{_MAX_RK}, rv <= {_MAX_RK}, <= {_MAX_HEADS} heads per group and "
                         f"block_s a multiple of {_TILE} dividing S (hd={hd}, rk={rk}, rv={rv}, "
                         f"hpg={hpg}, block_s={block_s}, S={s_max})")
    plan = _i8_plan(hd, rk, rv, hpg, nrk, nrv, bool(asym), mode, bool(bias))
    if plan is None:
        raise ValueError(f"the int8 decode kernel's tile ring and one head's operand do not fit "
                         f"in a block's shared memory at hd {hd}, rk {rk}, rv {rv}")
    return plan


@functools.lru_cache(maxsize=32)
def _device_splits(dev: torch.device, n_bg: int, s_max: int) -> tuple:
    """_splits on the device's SMs at one block per SM (each decode block
    fills most of an SM's shared memory)."""
    return _splits(torch.cuda.get_device_properties(dev).multi_processor_count, 1, n_bg, s_max)


def _inv_key(inv_freq):
    """A hashable form of an inv_freq override (None: the theta default)."""
    return None if inv_freq is None else tuple(float(x) for x in np.asarray(inv_freq))


@functools.lru_cache(maxsize=8)
def _inv_freq_t(hd: int, theta: float, inv_key, device: str) -> torch.Tensor:
    """The (hd / 2,) f32 RoPE frequencies flash_decode_latent uses, on the
    device, for the exact kernel's in-kernel rotation."""
    return _inv_freq(hd, theta, None if inv_key is None else np.asarray(inv_key),
                     torch.device(device)).contiguous()


@functools.lru_cache(maxsize=64)
def _exact_plan(hd: int, rk: int, rv: int, hpg: int, nkv: int, nrk: int, nrv: int, nsk: int,
                nsv: int, asym: bool) -> Optional[dict]:
    """The exact kernel's shared-memory plan (csrc/palu_decode_exact.cu::
    make_plan, the same function): `smem` bytes a launch takes, `ns` tile
    stages of `stage` bytes (the K and V byte planes of a 64-token tile,
    then its scale and zero rows), `nb` B slots of `rc` ranks (`nrc` chunks
    a kv-head), `resident` (all of B once per work item); None when no plan
    fits in one block."""
    np_ = 8 if hpg <= 8 else 32
    nbox_k, nbox_v = -(-nrk // 256), -(-nrv // 256)
    o = _up(nbox_k * -(-nrk // nbox_k) * _TILE, 128)
    o = _up(o + nbox_v * -(-nrv // nbox_v) * _TILE, 128)
    for n in (nsk, nsk if asym else 0, nsv, nsv if asym else 0):
        o = _up(o + n * _TILE * 4, 128)
    stage = _up(o, 1024)

    def tail(at: int, ns: int, nb: int) -> int:
        t = _up(at, 1024) + 2 * np_ * 128
        for n in (2 * _TILE * (hd // 2 + 4), hpg * hd, hpg * _TILE, rk, rv, 4 * _MAX_HEADS):
            t = _up(t + n * 4, 16)
        return t + 8 * (2 * ns + 2 * nb + 4)

    def take(ns, nb, rc, resident, total):
        return {"smem": total + 1024, "ns": ns, "nb": nb, "rc": rc, "nrc": -(-rk // rc),
                "resident": resident, "stage": stage}

    rc_res = min(rk, 128)
    for ns in (4, 3):  # B resident
        nb = nkv * -(-rk // rc_res)
        total = tail(ns * stage + nb * rc_res * hd * 2, ns, nb)
        if total <= _SMEM_BUDGET:
            return take(ns, nb, rc_res, 1, total)
    for i, rc in enumerate((rc_res, 64, 32, 16)):  # B streamed through nb >= 2 slots
        if i > 0 and rc >= rc_res:
            continue
        slot = rc * hd * 2
        nb = 2
        while nb < 8 and tail(3 * stage + (nb + 1) * slot, 3, nb + 1) <= _SMEM_BUDGET:
            nb += 1
        total = tail(3 * stage + nb * slot, 3, nb)
        if total <= _SMEM_BUDGET:
            return take(3, nb, rc, 0, total)
    return None


@functools.lru_cache(maxsize=64)
def _exact_smem(hd, rk, rv, hpg, nkv, nrk, nrv, nsk, nsv, asym) -> int:
    """The exact kernel's shared memory at these shapes, or -1 when no plan
    of it fits in one block."""
    return build.launcher("palu_decode_exact", "palu_decode_exact_smem", "i" * 10)(
        hd, rk, rv, hpg, nkv, nrk, nrv, nsk, nsv, asym)


def palu_decode(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, *,
                qcfg: QuantConfig, rk: int, rv: int, theta: float = 10000.0,
                sliding_window: Optional[int] = None, inv_freq=None,
                rope_scale: float = 1.0, xk_zero=None, xv_zero=None,
                block_s: int = 1024, int8_dots: bool = False,
                int8_rot: bool = False, k_bias=None, pos_offset: Optional[int] = None,
                return_stats: bool = False, layer_idx: Optional[int] = None):
    """Decode attention over an affine-quantized rank-major latent cache.

    q (B, nh, hd) roped at the current position; b_k (G, hpg, rk, hd), or
    the compact (G, hpg / rep, rk, hd) (module docstring); codes (B, G,
    packed_nrows, S) uint8; scales/zeros (B, G, S) or (B, G, 1, S) f32 per
    row, (B, G, rank // group_size, S) per chunk; kv_len (B,) valid
    positions; k_bias None or (G, b_k.shape[1], hd) pre-RoPE K bias. ->
    (B, nh, rv) f32. int8_dots / int8_rot select the int8 K-path modes over
    rotation blocks of block_s tokens (module docstring; per-row scales
    only). CUDA tensors launch a kernel: the exact modes
    csrc/palu_decode_exact.cu (hd 64 or 128, rk a multiple of 16 up to 512,
    rv up to 512, S a multiple of 16 and at least 64, <= 32 heads per group,
    and shapes whose tile ring and B fit in a block's shared memory: others
    raise), the int8 modes csrc/palu_decode_i8.cu (also rk % 32 == 0 and
    block_s % 64 == 0, and a plan whose tile ring and one head's operand fit,
    _i8_plan); b_k must be bf16, as the engine keeps it. CPU tensors run the
    plain version. Each launch adds one to `palu_decode.launches` and to
    its mode's count in `palu_decode.mode_launches` ("chunked" for
    per-chunk scales), one to `palu_decode.k_bias_launches` when it carries
    a bias, and one to each feature it uses in
    `palu_decode.feature_launches` ("pos_offset", "return_stats",
    "layer_idx"). pos_offset, return_stats and layer_idx: the module
    docstring; with return_stats the result is (acc, m, l)."""
    if not q.is_cuda:
        return palu_decode_ref(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len,
                               qcfg=qcfg, rk=rk, rv=rv, theta=theta,
                               sliding_window=sliding_window, inv_freq=inv_freq,
                               rope_scale=rope_scale, xk_zero=xk_zero, xv_zero=xv_zero,
                               block_s=block_s, int8_dots=int8_dots, int8_rot=int8_rot,
                               k_bias=k_bias, pos_offset=pos_offset,
                               return_stats=return_stats, layer_idx=layer_idx)
    _check(q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, qcfg, rk, rv,
           xk_zero, xv_zero, k_bias, layer_idx)
    mode = k_path_mode(qcfg, rk, q.shape[-1], int8_dots=int8_dots, int8_rot=int8_rot)
    if qcfg.group_size > 0:
        mode = "chunked"
    exact = mode in ("exact", "chunked")
    b, nh, hd = q.shape
    g, nkv = b_k.shape[0], b_k.shape[1]
    hpg = nh // g
    s_max = xk_codes.shape[-1]
    nrk, nrv = xk_codes.shape[-2], xv_codes.shape[-2]
    if b_k.dtype != torch.bfloat16:
        raise ValueError(f"the decode kernels read b_k as bf16, got {b_k.dtype}")
    if (hd not in (64, 128) or rk % 16 or rk > _MAX_RK or hpg > _MAX_HEADS or s_max % 16
            or (exact and (rv > _MAX_RK or s_max < _TILE))):
        raise ValueError(f"decode kernel needs hd 64 or 128, rk a multiple of 16 up to "
                         f"{_MAX_RK}, S a multiple of 16 and <= {_MAX_HEADS} heads per "
                         f"group; the exact modes also rv <= {_MAX_RK} and S >= {_TILE} "
                         f"(hd={hd}, rk={rk}, rv={rv}, S={s_max}, hpg={hpg})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    ts = [q, b_k, xk_codes, xk_scale, xv_codes, xv_scale, kv_len, xk_zero, xv_zero, k_bias]
    if len({t.device for t in ts if t is not None}) != 1:
        raise ValueError("all tensors must be on one device")
    bufs = [xk_codes, xk_scale, xv_codes, xv_scale, xk_zero, xv_zero]
    if any(t is not None and not t.is_contiguous() for t in bufs):
        raise ValueError("cache buffers must be contiguous")
    dev = q.device
    off = int(pos_offset or 0)
    if off < 0:
        raise ValueError(f"pos_offset must be >= 0, got {off}")
    asym = not qcfg.sym
    nsk = rk // qcfg.group_size if mode == "chunked" else 1
    nsv = rv // qcfg.group_size if mode == "chunked" else 1
    if exact and _exact_smem(hd, rk, rv, hpg, nkv, nrk, nrv, nsk, nsv, int(asym)) < 0:
        raise ValueError(f"the exact decode kernel's tile ring and B do not fit in a block's "
                         f"shared memory at hd {hd}, rk {rk}, rv {rv}, {hpg} heads per group, "
                         f"{nrk} + {nrv} code rows and {nsk} + {nsv} scale rows per token"
                         f"{' (asym)' if asym else ''}")
    if not exact:
        _i8_launch_plan(hd, rk, rv, hpg, nrk, nrv, asym, _MODES[mode], k_bias is not None,
                        block_s, s_max)
    qoff = 0 if asym else 2 ** (qcfg.bits - 1)
    if exact:
        inv = _inv_freq_t(hd, float(theta), _inv_key(inv_freq), str(dev))
        out = exact_launch(q, b_k, xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero,
                           kv_len, pbits=qcfg.pack_bits, qoff=qoff, rk=rk, rv=rv,
                           window=int(sliding_window or 0), inv=inv, rope_scale=rope_scale,
                           nsk=nsk, nsv=nsv, k_bias=k_bias, pos_offset=off, layer_idx=layer_idx,
                           return_stats=return_stats)
    else:
        qc = q.contiguous()
        bk = b_k.contiguous()
        kbias = None if k_bias is None else k_bias.float().contiguous()
        kvl = kv_len.to(torch.int32).contiguous()
        splits, grid = _device_splits(dev, b * g, s_max)
        n_part, scratch, out, m_out, l_out = _scratch(b, nh, rv, splits, return_stats, 0, dev)
        common = (qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(),
                  xk_codes.data_ptr(), xk_scale.data_ptr(), _ptr(xk_zero), xv_codes.data_ptr(),
                  xv_scale.data_ptr(), _ptr(xv_zero), kvl.data_ptr())
        parts = (scratch.data_ptr(), scratch[n_part:].data_ptr(),
                 scratch[2 * n_part:].data_ptr(), out.data_ptr())
        tab = _tables8(s_max, block_s, hd, theta, inv_freq, rope_scale, dev, off)
        err = build.launcher("palu_decode_i8", "palu_decode_i8",
                             "pi" + "p" * 19 + "i" * 21 + "ff" + "ppp")(
            *common, *(_ptr(tab.get(k)) for k in ("c0", "s0", "rcos", "rsin", "cos8", "sin8")),
            _ptr(kbias), *parts, b, g, hpg, nkv, hd, rk, rv, s_max, nrk, nrv, qcfg.pack_bits,
            qoff, int(asym), int(sliding_window or 0), splits, grid, _MODES[mode], block_s,
            int(layer_idx or 0), xk_codes.shape[0] if layer_idx is not None else 1, off,
            float(math.sqrt(hd)), float(tab["i8r_inv"]), _ptr(m_out), _ptr(l_out),
            build.stream_ptr(dev))
        build.check(err, f"palu_decode ({mode})")
        if return_stats:
            out = (out, m_out, l_out)
    palu_decode.launches += 1
    palu_decode.mode_launches[mode] += 1
    palu_decode.k_bias_launches += k_bias is not None
    count_features(palu_decode, pos_offset, return_stats, layer_idx)
    return out


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _scratch(b: int, nh: int, rv: int, splits: int, return_stats: bool, n_extra: int, dev):
    """One allocation: per-split m, l, accumulators, the output (and with
    return_stats its m and l), then n_extra f32. Returns (n_part, scratch,
    out, m_out, l_out)."""
    n_part = b * nh * splits
    n_out = b * nh * (rv + (2 if return_stats else 0))
    scratch = torch.empty(n_part * (2 + rv) + n_out + n_extra, dtype=torch.float32, device=dev)
    o0 = n_part * (2 + rv)
    out = scratch[o0:o0 + b * nh * rv].view(b, nh, rv)
    m_out = l_out = None
    if return_stats:
        m_out = scratch[o0 + b * nh * rv:o0 + b * nh * (rv + 1)].view(b, nh)
        l_out = scratch[o0 + b * nh * (rv + 1):o0 + n_out].view(b, nh)
    return n_part, scratch, out, m_out, l_out


def exact_launch(q, b_k, xk_codes, xk_scale, xk_zero, xv_codes, xv_scale, xv_zero, kv_len, *,
                 pbits: int, qoff: int, rk: int, rv: int, window: int, inv: torch.Tensor,
                 rope_scale: float, nsk: int = 1, nsv: int = 1, k_bias=None,
                 pos_offset: int = 0, layer_idx: Optional[int] = None,
                 return_stats: bool = False):
    """One launch of csrc/palu_decode_exact.cu (the checks are the
    caller's): K = scale (B^T (code - qoff)) [+ zero rowsum B] [+ k_bias]
    per scale chunk, zeros given (asym) or None, RoPE at the f32 angle
    position * inv (inv (hd / 2,) f32 on the device) times rope_scale. ->
    out (B, nh, rv), or (acc, m, l) with return_stats."""
    b, nh, hd = q.shape
    g, nkv = b_k.shape[0], b_k.shape[1]
    s_max = xk_codes.shape[-1]
    asym = xk_zero is not None
    dev = q.device
    qc = q.contiguous()
    bk = b_k.contiguous()
    kbias = None if k_bias is None else k_bias.float().contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    splits, grid = _device_splits(dev, b * g, s_max)
    # the asym row sums of B after the outputs
    n_part, scratch, out, m_out, l_out = _scratch(b, nh, rv, splits, return_stats,
                                                  g * nkv * nsk * hd if asym else 0, dev)
    n_out = b * nh * (rv + (2 if return_stats else 0))
    err = build.launcher("palu_decode_exact", "palu_decode_exact",
                         "pi" + "p" * 15 + "i" * 21 + "ff" + "ppp")(
        qc.data_ptr(), int(q.dtype == torch.bfloat16), bk.data_ptr(), xk_codes.data_ptr(),
        xk_scale.data_ptr(), _ptr(xk_zero), xv_codes.data_ptr(), xv_scale.data_ptr(),
        _ptr(xv_zero), kvl.data_ptr(), _ptr(kbias), inv.data_ptr(),
        scratch[n_part * (2 + rv) + n_out:].data_ptr(), scratch.data_ptr(),
        scratch[n_part:].data_ptr(), scratch[2 * n_part:].data_ptr(), out.data_ptr(),
        b, g, nh // g, nkv, hd, rk, rv, s_max, xk_codes.shape[-2], xv_codes.shape[-2], pbits,
        qoff, int(asym), window, nsk, nsv, splits, grid, int(layer_idx or 0),
        xk_codes.shape[0] if layer_idx is not None else 1, int(pos_offset),
        float(1.0 / math.sqrt(hd)), float(rope_scale), _ptr(m_out), _ptr(l_out),
        build.stream_ptr(dev))
    build.check(err, "palu_decode_exact")
    return (out, m_out, l_out) if return_stats else out


FEATURES = ("pos_offset", "return_stats", "layer_idx")


def count_features(fn, pos_offset, return_stats: bool, layer_idx) -> None:
    """Add one launch of `fn` to each feature the call used."""
    fn.feature_launches["pos_offset"] += pos_offset is not None
    fn.feature_launches["return_stats"] += bool(return_stats)
    fn.feature_launches["layer_idx"] += layer_idx is not None


# the modes counted per launch; the int8 ones are the MODE template argument
# of csrc/palu_decode_i8.cu, exact and chunked (the exact K path over
# per-row and per-chunk scales) run csrc/palu_decode_exact.cu
_MODES = {"exact": 0, "int8_dots": 1, "int8_rot": 2, "chunked": 3}
palu_decode.launches = 0
palu_decode.mode_launches = dict.fromkeys(_MODES, 0)
palu_decode.k_bias_launches = 0
palu_decode.feature_launches = dict.fromkeys(FEATURES, 0)
