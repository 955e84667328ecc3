"""Latent KV cache (port of palu_tpu/runtime/cache.py: the quantized
layouts, rank-major and seq-major, and the two unquantized layouts).

Per layer and side (k, v), with per-row (group_size == 0) quantization:
  codes_t (B, G, nrows, S) uint8   packed codes, sequence on the last axis
  scale_t (B, G, 1, S)     f32     per-token scale
  zero_t  (B, G, 1, S)     f32     per-token zero (asymmetric only)
so x ~= scale * code + zero. Without quantization (qcfg None) the latents
are stored in the engine dtype, seq-major by default or rank-major:
  lat   (B, G, S, r)   the layout of the v1 decode kernel
  lat_t (B, G, r, S)   rank_major_fp: the layout of the v4 decode kernel
Keys ending in "_t" carry the sequence on their last axis, the others on
the axis before it. Latents are cached pre-RoPE. A side whose projection
is dense (no VT) holds roped K or V instead, {"lat": (B, n_kv, S, hd)} in
the engine dtype, as in the JAX package. Buffer names, layouts and key
order are the JAX package's, so caches compare byte for byte and the
profiler seeds them from one numpy stream in the same order.

With per-chunk quantization (group_size > 0, the reference's
--lt_group_size) the scale and zero rows stack one row per contiguous
rank chunk, (B, G, rank // group_size, S), when the chunk is a multiple
of 8 and divides the rank (`rank_major_chunked`); the decode kernel
dequantizes each chunk before its dots. Other chunk sizes take JAX's
seq-major layout:
  codes  (B, G, S, nbytes)              uint8  packed codes (pack_codes)
  scales (B, G, S, rank // group_size)  f32
  base   (B, G, S, rank // group_size)  f32    zero point
so x ~= (code + q_min - base) * scale (core/quant.dequantize). No kernel
reads it, in JAX as here: the engine appends it with the plain masked
write and decodes it with ops/attention.flash_decode_latent. A chunk that
does not divide the rank raises JAX's ValueError when latents are encoded
(quant._group).

The JAX package returns new buffers and relies on buffer donation for
in-place updates; here the write helpers update the buffers in place.

Two more layouts serve the layer-stacked and the sequence-parallel
decodes:
  stacked  - init_cache_stacked: {"stack": {"k": bufs, "v": bufs},
             "length"}, every leaf with a leading (L, ...) layer axis and
             per-row scale / zero leaves squeezed to (L, B, G, S)
             (stacked_squeeze), the shapes the decode kernels read with
             layer_idx; layer_view / stacked_unsqueeze give one layer's
             buffers in the per-layer shapes, as views, so writes through
             them land in the stack;
  seq shard - init_cache with s_max = S_local: a process of a mesh with a
             `seq` axis of n holds S_local = s_max / n columns of every
             leaf (per-chunk row stacks too: their last axis is the
             sequence), absolute positions [rank * S_local, (rank + 1) *
             S_local). shard_write places a write at position p on the
             process that owns p, at p - rank * S_local; the others write
             nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core import quant
from ..models.config import ModelConfig
from ..ops import build

__all__ = [
    "rank_major", "rank_major_chunked", "quantized", "init_cache", "cache_nbytes", "decode_latents",
    "seq_slice", "write_at_lanes", "write_at_lanes_masked", "init_cache_stacked",
    "stacked_squeeze", "stacked_unsqueeze", "layer_view", "write_at_lanes_stacked",
    "shard_write",
]


def rank_major(qcfg: Optional[quant.QuantConfig]) -> bool:
    """True when the cache uses the rank-major packed layout with per-row
    scales (the layout of the decode kernel)."""
    return qcfg is not None and qcfg.enabled and qcfg.group_size == 0


def rank_major_chunked(qcfg: Optional[quant.QuantConfig], rank: int) -> bool:
    """True when a per-chunk (group_size > 0) cache of this rank takes the
    rank-major layout: the chunk is a multiple of 8 and divides the rank,
    so the scale / zero rows are (rank // group_size, S)."""
    return (qcfg is not None and qcfg.enabled and qcfg.group_size > 0
            and qcfg.group_size % 8 == 0 and rank % qcfg.group_size == 0)


def quantized(qcfg: Optional[quant.QuantConfig]) -> bool:
    """True when the cache holds quantized codes, False for raw latents."""
    return qcfg is not None and qcfg.enabled


def _seq_axis(key: str, ndim: int) -> int:
    """Sequence axis of a buffer leaf: last for rank-major ("_t") keys, the
    one before it otherwise."""
    return ndim - 1 if key.endswith("_t") else ndim - 2


def _layer_buffers(batch: int, groups: int, s_max: int, rank: int,
                   qcfg: Optional[quant.QuantConfig], device, dtype=torch.bfloat16,
                   rank_major_fp: bool = False) -> Dict[str, torch.Tensor]:
    if not quantized(qcfg):
        if rank_major_fp:
            return {"lat_t": torch.zeros((batch, groups, rank, s_max), dtype=dtype,
                                         device=device)}
        return {"lat": torch.zeros((batch, groups, s_max, rank), dtype=dtype, device=device)}
    n_sc = rank // qcfg.group_size if qcfg.group_size > 0 else 1
    if not (rank_major(qcfg) or rank_major_chunked(qcfg, rank)):
        seq = (batch, groups, s_max)
        return {"codes": torch.zeros(seq + (quant.packed_nbytes(rank, qcfg.pack_bits),),
                                     dtype=torch.uint8, device=device),
                "scales": torch.zeros(seq + (n_sc,), dtype=torch.float32, device=device),
                "base": torch.zeros(seq + (n_sc,), dtype=torch.float32, device=device)}
    nrows = quant.packed_nrows(rank, qcfg.pack_bits)
    bufs = {
        "codes_t": torch.zeros((batch, groups, nrows, s_max), dtype=torch.uint8,
                               device=device),
        "scale_t": torch.zeros((batch, groups, n_sc, s_max), dtype=torch.float32,
                               device=device),
    }
    if not qcfg.sym:
        bufs["zero_t"] = torch.zeros((batch, groups, n_sc, s_max),
                                     dtype=torch.float32, device=device)
    return bufs


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               qcfg: Optional[quant.QuantConfig], device="cuda", dtype=torch.bfloat16,
               rank_major_fp: bool = False) -> Dict[str, Any]:
    """Build the cache: per layer {"k": bufs, "v": bufs} plus per-lane
    lengths. `dtype` applies to unquantized caches (qcfg None) and to dense
    sides, `rank_major_fp` to unquantized latents."""
    device = build.require_cuda(device)
    g = cfg.num_kv_groups
    dense = (batch, cfg.num_key_value_heads, s_max, cfg.head_dim)
    layers = []
    for i in range(cfg.num_hidden_layers):
        entry = {}
        for side in ("k", "v"):
            r = cfg.uniform_rank_for(i, f"{side}_proj")
            entry[side] = ({"lat": torch.zeros(dense, dtype=dtype, device=device)} if r is None
                           else _layer_buffers(batch, g, s_max, r, qcfg, device, dtype,
                                               rank_major_fp))
        layers.append(entry)
    return {"layers": layers,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_cache_stacked(cfg: ModelConfig, batch: int, s_max: int,
                       qcfg: Optional[quant.QuantConfig], device="cuda", dtype=torch.bfloat16,
                       rank_major_fp: bool = False) -> Dict[str, Any]:
    """The layer-stacked cache: {"stack": {"k": bufs, "v": bufs}, "length"}
    with every leaf (L, ...) and per-row scales squeezed (stacked_squeeze).
    Needs every layer low-rank at one k rank and one v rank."""
    device = build.require_cuda(device)
    n_l = cfg.num_hidden_layers
    ranks = {side: {cfg.uniform_rank_for(i, f"{side}_proj") for i in range(n_l)}
             for side in ("k", "v")}
    if any(len(r) != 1 for r in ranks.values()):
        raise ValueError("stacked cache requires uniform ranks per layer")
    if any(None in r for r in ranks.values()):
        raise ValueError("stacked cache requires low-rank k and v")
    stack = {}
    for side, (r,) in ranks.items():
        one = stacked_squeeze(_layer_buffers(batch, cfg.num_kv_groups, s_max, r, qcfg, device,
                                             dtype, rank_major_fp), qcfg)
        stack[side] = {k: torch.zeros((n_l,) + tuple(v.shape), dtype=v.dtype, device=device)
                       for k, v in one.items()}
    return {"stack": stack, "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def stacked_squeeze(bufs: Dict[str, torch.Tensor], qcfg) -> Dict[str, torch.Tensor]:
    """Per-row (group_size 0) scale / zero leaves without their unit n_sc
    axis, (.., G, 1, S) -> (.., G, S), as the stacked layout keeps them;
    per-chunk row stacks unchanged."""
    if not quantized(qcfg) or qcfg.group_size > 0:
        return bufs
    return {k: v[..., 0, :] if k in ("scale_t", "zero_t") else v for k, v in bufs.items()}


def stacked_unsqueeze(bufs: Dict[str, torch.Tensor], qcfg) -> Dict[str, torch.Tensor]:
    """Inverse of stacked_squeeze on one layer's view: the unit n_sc axis
    back, so decode_latents and seq_slice see the per-layer shapes."""
    if not quantized(qcfg) or qcfg.group_size > 0:
        return bufs
    return {k: v[..., None, :] if k in ("scale_t", "zero_t") else v for k, v in bufs.items()}


def layer_view(stack: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a stacked {"k", "v"} tree, as views of the stack."""
    return {side: {k: v[i] for k, v in bufs.items()} for side, bufs in stack.items()}


def write_at_lanes_stacked(buf: Dict[str, torch.Tensor], update: Dict[str, torch.Tensor],
                           pos: torch.Tensor, layer_idx: int,
                           mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-lane write of update (stacked_squeeze'd leaves (B, G, .., S_new))
    into layer layer_idx of a stacked buffer tree, in place; with `mask`
    (B,) the masked-out lanes keep their content. Returns buf."""
    view = {k: v[layer_idx] for k, v in buf.items()}
    if mask is None:
        write_at_lanes(view, update, pos)
    else:
        write_at_lanes_masked(view, update, pos, mask)
    return buf


def shard_write(pos: torch.Tensor, writeable: torch.Tensor, lo: int,
                s_local: int) -> tuple:
    """Where one token's write at absolute positions pos (B,) lands in a
    sequence shard holding [lo, lo + s_local): (local positions, clamped
    into the shard, and the write mask writeable & owned). A lane whose
    position another shard owns writes nothing here."""
    owned = (pos >= lo) & (pos < lo + s_local)
    return torch.clamp(pos - lo, 0, s_local - 1), writeable & owned


def cache_nbytes(cache: Dict[str, Any]) -> int:
    """Total cache footprint in bytes."""
    total = cache["length"].numel() * cache["length"].element_size()
    entries = [cache["stack"]] if "stack" in cache else cache["layers"]
    for entry in entries:
        for side in entry.values():
            total += sum(t.numel() * t.element_size() for t in side.values())
    return total


def _encode(latents: torch.Tensor, qcfg: Optional[quant.QuantConfig], dtype=None,
            rank_major_fp: bool = False) -> Dict[str, torch.Tensor]:
    """latents (B, G, S, r) -> buffer update dict in the cache's layout;
    unquantized latents are stored in `dtype`."""
    if not quantized(qcfg):
        lat = latents.to(dtype)
        return {"lat_t": lat.transpose(-1, -2)} if rank_major_fp else {"lat": lat}
    if not (rank_major(qcfg) or rank_major_chunked(qcfg, latents.shape[-1])):
        codes, scales, base = quant.quantize(latents, qcfg)
        return {"codes": quant.pack_codes(codes, qcfg.pack_bits),
                "scales": scales.float(), "base": base.float()}
    codes, scales, zeros = quant.quantize_affine(latents, qcfg)
    # scales (B, G, S, n_sc) -> (B, G, n_sc, S): sequence on the last axis
    # (n_sc = 1 per row, rank // group_size per chunk)
    upd = {
        "codes_t": quant.pack_codes_t(codes, qcfg.pack_bits),
        "scale_t": scales.float().transpose(-1, -2),
    }
    if not qcfg.sym:
        upd["zero_t"] = zeros.float().transpose(-1, -2)
    return upd


def decode_latents(buf: Dict[str, torch.Tensor], qcfg: Optional[quant.QuantConfig],
                   rank: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Read back latents (B, G, S, r) from a layer buffer, dequantizing."""
    if "lat_t" in buf:
        return buf["lat_t"].transpose(-1, -2).to(dtype)
    if "lat" in buf:
        return buf["lat"].to(dtype)
    if "codes" in buf:
        return quant.dequantize(quant.unpack_codes(buf["codes"], qcfg.pack_bits, rank),
                                buf["scales"], buf["base"], qcfg, dtype=dtype)
    codes = quant.unpack_codes_t(buf["codes_t"], qcfg.pack_bits, rank).float()

    def rows(a):  # (B, G, n_sc, S) -> one row per rank
        return a if a.shape[-2] == 1 else a.repeat_interleave(rank // a.shape[-2], dim=-2)

    if qcfg.sym:
        lat = (codes - 2 ** (qcfg.bits - 1)) * rows(buf["scale_t"])
    else:  # affine: x = scale * code + zero
        lat = codes * rows(buf["scale_t"]) + rows(buf["zero_t"])
    return lat.transpose(-1, -2).to(dtype)


def seq_slice(buf: Dict[str, torch.Tensor], start: int, size: int) -> Dict[str, torch.Tensor]:
    """View of `size` positions at `start` along every leaf's sequence axis."""
    return {k: a.narrow(_seq_axis(k, a.dim()), start, size) for k, a in buf.items()}


def _lane_index(u: torch.Tensor, pos: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-lane sequence indices pos[b] + j along `axis`, broadcast to u's
    shape."""
    s_new = u.shape[axis]
    idx = pos.long()[:, None] + torch.arange(s_new, device=u.device)[None, :]
    shape = [u.shape[0]] + [1] * (u.dim() - 1)
    shape[axis] = s_new
    return idx.reshape(shape).expand_as(u)


def write_at_lanes(buf: Dict[str, torch.Tensor], update: Dict[str, torch.Tensor],
                   pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-lane write in place: each update leaf lands at each lane's own
    offset pos[b] along its sequence axis. Returns buf."""
    for k, u in update.items():
        ax = _seq_axis(k, u.dim())
        buf[k].scatter_(ax, _lane_index(u, pos, ax), u.to(buf[k].dtype))
    return buf


def write_at_lanes_masked(buf: Dict[str, torch.Tensor],
                          update: Dict[str, torch.Tensor], pos: torch.Tensor,
                          mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """write_at_lanes that is a true no-op for masked-out lanes: their slot
    is re-written with its current content, so idle lanes and full lanes
    (pos clamped to s_max - 1 by the caller) are never corrupted."""
    for k, u in update.items():
        ax = _seq_axis(k, u.dim())
        idx = _lane_index(u, pos, ax)
        cur = torch.gather(buf[k], ax, idx)
        keep = mask.reshape((u.shape[0],) + (1,) * (u.dim() - 1))
        buf[k].scatter_(ax, idx, torch.where(keep, u.to(cur.dtype), cur))
    return buf
