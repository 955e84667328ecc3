"""Decode-step cache append: quantize + pack + masked column write, one
kernel launch per layer side (port of
palu_tpu/ops/pallas/cache_append.py::append_token_quantized; the kernel is
csrc/cache_append.cu).

`append_token_quantized` launches the kernel for CUDA tensors and runs
`append_token_quantized_ref`, its plain version, for CPU tensors. Both
update the cache buffers in place (the JAX op aliases them under
donation) and are bit-identical to quantize_affine + pack_codes_t followed
by write_at_lanes_masked: lanes with writeable == 0 keep their bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.quant import QuantConfig, packed_nrows
from ..runtime import cache as cache_lib
from . import build

__all__ = ["append_supported", "append_token_quantized", "append_token_quantized_ref"]


def append_supported(qcfg: Optional[QuantConfig]) -> bool:
    """True when the append kernel covers this config: per-row rank-major
    quantized cache at a byte-aligned pack width."""
    return (qcfg is not None and qcfg.enabled and qcfg.group_size == 0
            and qcfg.pack_bits in (2, 4, 8))


def _check(lat, codes, scale, pos, writeable, qcfg, rank, zero):
    if not append_supported(qcfg):
        raise ValueError(f"append kernel needs per-row scales at pack width 2/4/8, got {qcfg}")
    if (zero is not None) == qcfg.sym:
        raise ValueError("zero buffer must be given exactly when qcfg is asymmetric")
    if lat.dim() != 3 or lat.shape[-1] != rank:
        raise ValueError(f"lat must be (B, G, {rank}), got {tuple(lat.shape)}")
    b, g, _ = lat.shape
    nrows = packed_nrows(rank, qcfg.pack_bits)
    s_max = codes.shape[-1]
    if tuple(codes.shape) != (b, g, nrows, s_max) or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 (B, G, {nrows}, S), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    for name, buf in (("scale", scale), ("zero", zero)):
        if buf is None:
            continue
        if buf.numel() != b * g * s_max or buf.dtype != torch.float32 or buf.shape[-1] != s_max:
            raise ValueError(f"{name} must be f32 (B, G, S) or (B, G, 1, S)")
    if tuple(pos.shape) != (b,) or tuple(writeable.shape) != (b,):
        raise ValueError("pos and writeable must be (B,)")
    devs = {t.device for t in (lat, codes, scale, pos, writeable) if t is not None}
    if zero is not None:
        devs.add(zero.device)
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")


def append_token_quantized_ref(lat, codes, scale, pos, writeable, *,
                               qcfg: QuantConfig, rank: int, zero=None):
    """Plain version: quantize_affine + pack_codes_t of the one-token column,
    then the masked per-lane write. Updates the buffers in place and
    returns them."""
    _check(lat, codes, scale, pos, writeable, qcfg, rank, zero)
    b, g, _ = lat.shape
    s_max = codes.shape[-1]
    bufs = {"codes_t": codes, "scale_t": scale.view(b, g, 1, s_max)}
    if zero is not None:
        bufs["zero_t"] = zero.view(b, g, 1, s_max)
    upd = cache_lib._encode(lat[:, :, None, :], qcfg)
    cache_lib.write_at_lanes_masked(bufs, upd, pos, writeable.bool())
    return (codes, scale) if zero is None else (codes, scale, zero)


def append_token_quantized(lat, codes, scale, pos, writeable, *,
                           qcfg: QuantConfig, rank: int, zero=None):
    """Quantize one token's latents lat (B, G, rank) and write them into the
    rank-major packed cache at per-lane positions pos (B,) (the caller
    clamps them), for lanes with writeable != 0. CUDA tensors launch the
    kernel, CPU tensors run the plain version. In place; returns
    (codes, scale[, zero])."""
    if not lat.is_cuda:
        return append_token_quantized_ref(lat, codes, scale, pos, writeable,
                                          qcfg=qcfg, rank=rank, zero=zero)
    _check(lat, codes, scale, pos, writeable, qcfg, rank, zero)
    if lat.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lat must be bf16 or f32, got {lat.dtype}")
    for name, buf in (("codes", codes), ("scale", scale), ("zero", zero)):
        if buf is not None and not buf.is_contiguous():
            raise ValueError(f"{name} buffer must be contiguous (written in place)")
    b, g, _ = lat.shape
    lat_c = lat.contiguous()
    pos_i = pos.to(torch.int32).contiguous()
    wr_b = writeable.to(torch.bool).contiguous()
    clip = qcfg.clip_ratio < 1.0
    err = build.launcher("cache_append", "palu_cache_append", "pippppp" + "i" * 8 + "fip")(
        lat_c.data_ptr(), int(lat.dtype == torch.bfloat16), codes.data_ptr(),
        scale.data_ptr(), zero.data_ptr() if zero is not None else None,
        pos_i.data_ptr(), wr_b.data_ptr(), b, g, rank, codes.shape[2],
        codes.shape[-1], qcfg.bits, qcfg.pack_bits, int(qcfg.sym),
        float(qcfg.clip_ratio), int(clip), build.stream_ptr(lat.device))
    build.check(err, "cache_append")
    append_token_quantized.launches += 1
    return (codes, scale) if zero is None else (codes, scale, zero)


append_token_quantized.launches = 0
