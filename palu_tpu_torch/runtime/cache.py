"""Latent KV cache in the rank-major packed layout (port of the per-row
rank-major part of palu_tpu/runtime/cache.py).

Per layer and side (k, v), with per-row (group_size == 0) quantization:
  codes_t (B, G, nrows, S) uint8   packed codes, sequence on the last axis
  scale_t (B, G, 1, S)     f32     per-token scale
  zero_t  (B, G, 1, S)     f32     per-token zero (asymmetric only)
so x ~= scale * code + zero. Latents are cached pre-RoPE. Buffer names and
layouts are the JAX package's, so caches compare byte for byte.

The JAX package returns new buffers and relies on buffer donation for
in-place updates; here the write helpers update the buffers in place.
Per-chunk (group_size > 0) scales, unquantized and seq-major caches come
with later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core import quant
from ..models.config import ModelConfig
from ..ops import build

__all__ = [
    "rank_major", "init_cache", "cache_nbytes", "decode_latents", "seq_slice",
    "write_at_lanes", "write_at_lanes_masked",
]


def rank_major(qcfg: Optional[quant.QuantConfig]) -> bool:
    """True when the cache uses the rank-major packed layout with per-row
    scales (the layout of the decode kernel)."""
    return qcfg is not None and qcfg.enabled and qcfg.group_size == 0


def _check_layout(qcfg) -> None:
    if not rank_major(qcfg):
        raise NotImplementedError(
            "the port's cache holds per-row quantized latents "
            "(QuantConfig(bits < 16, group_size=0)); unquantized and per-chunk "
            "caches come with a later slice of the port")


def _layer_buffers(batch: int, groups: int, s_max: int, rank: int,
                   qcfg: quant.QuantConfig, device) -> Dict[str, torch.Tensor]:
    _check_layout(qcfg)
    nrows = quant.packed_nrows(rank, qcfg.pack_bits)
    bufs = {
        "codes_t": torch.zeros((batch, groups, nrows, s_max), dtype=torch.uint8,
                               device=device),
        "scale_t": torch.zeros((batch, groups, 1, s_max), dtype=torch.float32,
                               device=device),
    }
    if not qcfg.sym:
        bufs["zero_t"] = torch.zeros((batch, groups, 1, s_max),
                                     dtype=torch.float32, device=device)
    return bufs


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               qcfg: quant.QuantConfig, device="cuda") -> Dict[str, Any]:
    """Build the cache: per layer {"k": bufs, "v": bufs} plus per-lane
    lengths. Every layer must have low-rank k and v."""
    device = build.require_cuda(device)
    g = cfg.num_kv_groups
    layers = []
    for i in range(cfg.num_hidden_layers):
        rk = cfg.uniform_rank_for(i, "k_proj")
        rv = cfg.uniform_rank_for(i, "v_proj")
        if rk is None or rv is None:
            raise NotImplementedError(
                f"layer {i} has a dense k/v projection; the port's cache holds "
                "low-rank latents only")
        layers.append({
            "k": _layer_buffers(batch, g, s_max, rk, qcfg, device),
            "v": _layer_buffers(batch, g, s_max, rv, qcfg, device),
        })
    return {"layers": layers,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_nbytes(cache: Dict[str, Any]) -> int:
    """Total cache footprint in bytes."""
    total = cache["length"].numel() * cache["length"].element_size()
    for entry in cache["layers"]:
        for side in entry.values():
            total += sum(t.numel() * t.element_size() for t in side.values())
    return total


def _encode(latents: torch.Tensor, qcfg: quant.QuantConfig) -> Dict[str, torch.Tensor]:
    """latents (B, G, S, r) -> buffer update dict (sequence on the last axis)."""
    _check_layout(qcfg)
    codes, scales, zeros = quant.quantize_affine(latents, qcfg)
    # scales (B, G, S, 1) -> (B, G, 1, S): sequence on the last axis
    upd = {
        "codes_t": quant.pack_codes_t(codes, qcfg.pack_bits),
        "scale_t": scales.float().transpose(-1, -2),
    }
    if not qcfg.sym:
        upd["zero_t"] = zeros.float().transpose(-1, -2)
    return upd


def decode_latents(buf: Dict[str, torch.Tensor], qcfg: quant.QuantConfig,
                   rank: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Read back latents (B, G, S, r) from a layer buffer, dequantizing."""
    codes = quant.unpack_codes_t(buf["codes_t"], qcfg.pack_bits, rank).float()
    if qcfg.sym:
        lat = (codes - 2 ** (qcfg.bits - 1)) * buf["scale_t"]
    else:  # affine: x = scale * code + zero
        lat = codes * buf["scale_t"] + buf["zero_t"]
    return lat.transpose(-1, -2).to(dtype)


def seq_slice(buf: Dict[str, torch.Tensor], start: int, size: int) -> Dict[str, torch.Tensor]:
    """View of `size` positions at `start` along every leaf's sequence axis."""
    return {k: a[..., start:start + size] for k, a in buf.items()}


def _lane_index(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-lane sequence indices pos[b] + j, broadcast to u's shape."""
    s_new = u.shape[-1]
    idx = pos.long()[:, None] + torch.arange(s_new, device=u.device)[None, :]
    return idx.reshape((u.shape[0],) + (1,) * (u.dim() - 2) + (s_new,)).expand_as(u)


def write_at_lanes(buf: Dict[str, torch.Tensor], update: Dict[str, torch.Tensor],
                   pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-lane write in place: update (B, ..., S_new) lands at each lane's
    own offset pos[b] along the sequence axis. Returns buf."""
    for k, u in update.items():
        buf[k].scatter_(-1, _lane_index(u, pos), u.to(buf[k].dtype))
    return buf


def write_at_lanes_masked(buf: Dict[str, torch.Tensor],
                          update: Dict[str, torch.Tensor], pos: torch.Tensor,
                          mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """write_at_lanes that is a true no-op for masked-out lanes: their slot
    is re-written with its current content, so idle lanes and full lanes
    (pos clamped to s_max - 1 by the caller) are never corrupted."""
    for k, u in update.items():
        idx = _lane_index(u, pos)
        cur = torch.gather(buf[k], -1, idx)
        keep = mask.reshape((u.shape[0],) + (1,) * (u.dim() - 1))
        buf[k].scatter_(-1, idx, torch.where(keep, u.to(cur.dtype), cur))
    return buf
