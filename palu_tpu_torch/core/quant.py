"""Latent quantization for the rank-major packed KV cache (port of the
rank-major part of palu_tpu/core/quant.py).

Quantization is affine per row (`group_size == 0`) or per contiguous chunk
of the last dim: x ~= scale * code + zero with unsigned codes in
[0, 2^bits). Symmetric: q in [-2^(b-1), 2^(b-1)-1], scale =
clip_ratio * absmax / qmax; asymmetric: q in [0, 2^b - 1], scale =
(max - min).clamp(1e-5) / qmax, base = round(-min / scale). The f32
arithmetic follows the JAX module op for op, so codes, scales and zeros
are bit-identical to it (`torch.round` and `jnp.round` both round half to
even). XLA's rewrites of that arithmetic are copied on purpose, since
they decide the last bit: a division by the constant q_max becomes a
multiplication by the f32 reciprocal, the clip multiply folds into that
constant (sym), and the asym range w_max * clip - w_min * clip contracts
into one fused multiply-add. Divisions by tensors stay IEEE divisions.

Rank-major packing: codes (..., S, n) -> uint8 (..., rows, S). For pack
width p in {2, 4, 8} byte row j, bit-field k holds the code of rank index
k * (n / s) + j (s = 8 / p fields per byte). Exact 3-bit stores a 2-bit
plane (n/4 rows) followed by a 1-bit plane (n/8 rows); code = lo | hi << 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "QuantConfig",
    "quantize_affine",
    "packed_nrows",
    "pack_codes_t",
    "unpack_codes_t",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Latent quantizer configuration.

    `container` (0 = same as `bits`) widens the storage field per code
    without changing the quantization grid: bits=3, container=4 keeps the
    8-level 3-bit codes but stores them in nibbles."""

    bits: int = 16
    group_size: int = 0  # 0 = one scale per row (last dim)
    sym: bool = False
    clip_ratio: float = 1.0
    container: int = 0  # storage field width; 0 = bits (exact packing)

    def __post_init__(self):
        if self.container and self.container != self.bits:
            if self.container not in (2, 4, 8) or self.container < self.bits:
                raise ValueError(
                    f"container {self.container} must be a power-of-two "
                    f"field width >= bits ({self.bits})")

    @property
    def pack_bits(self) -> int:
        """Storage field width per code (>= bits)."""
        return self.container or self.bits

    @property
    def enabled(self) -> bool:
        return self.bits < 16


def _group(x: torch.Tensor, group_size: int) -> torch.Tensor:
    n = x.shape[-1]
    if group_size > 0:
        if n % group_size:
            raise ValueError(f"last dim {n} not divisible by group_size {group_size}")
        return x.reshape(x.shape[:-1] + (n // group_size, group_size))
    return x.reshape(x.shape[:-1] + (1, n))


def _scales_base(x: torch.Tensor, bits: int, sym: bool, clip_ratio: float):
    """Per-group scales and zero-point ("base") in fp32. x is grouped."""
    xf = x.float()
    clip = clip_ratio < 1.0
    if sym:
        q_max = 2 ** (bits - 1) - 1
        q_min = -(2 ** (bits - 1))
        w_max = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-5)
        # XLA folds (w_max * clip) * (1 / q_max) into one constant product
        inv = np.float32(1.0 / q_max)
        scales = w_max * float(np.float32(clip_ratio) * inv if clip else inv)
        base = torch.zeros_like(scales)
    else:
        q_max = 2**bits - 1
        q_min = 0
        w_max = xf.amax(dim=-1, keepdim=True)
        w_min = xf.amin(dim=-1, keepdim=True)
        if clip:
            # XLA contracts w_max * clip - w_min * clip into
            # fma(w_max, clip, -(w_min * clip)); f64 holds the exact product
            w_min = w_min * clip_ratio
            c = float(np.float32(clip_ratio))
            diff = (w_max.double() * c - w_min.double()).float()
        else:
            diff = w_max - w_min
        scales = torch.clamp(diff, min=1e-5) * (1.0 / q_max)
        base = torch.clamp(torch.round(-w_min / scales), q_min, q_max)
    return scales, base, q_min, q_max


def quantize_affine(x: torch.Tensor, cfg: QuantConfig):
    """x ~= scale * code + zero with unsigned uint8 codes in [0, 2^bits).

    group_size == 0: returns (codes, scales (...,), zeros (...,));
    group_size > 0: scales/zeros are (..., n // group_size)."""
    if not cfg.enabled:
        raise ValueError("quantize_affine needs bits < 16")
    g = _group(x, cfg.group_size)
    scales, base, q_min, q_max = _scales_base(g, cfg.bits, cfg.sym, cfg.clip_ratio)
    q = torch.clamp(torch.round(g.float() / scales) + base, q_min, q_max)
    codes = (q - q_min).to(torch.uint8).reshape(x.shape)
    zeros = (q_min - base) * scales
    return codes, scales.squeeze(-1), zeros.squeeze(-1)


def packed_nrows(n: int, bits: int) -> int:
    """Byte rows of the rank-major packed layout for n codes."""
    if bits in (1, 2, 4, 8):
        return n * bits // 8
    if bits == 3:
        return 3 * (n // 8)
    raise ValueError(f"unsupported pack width: {bits}")


def _pack_plane_t(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes (..., S, n) with values < 2^bits -> (..., n*bits/8, S) bytes."""
    n = codes.shape[-1]
    s = 8 // bits
    w = n // s
    fields = codes.reshape(codes.shape[:-1] + (s, w)).to(torch.uint8)
    packed = fields[..., 0, :]
    for k in range(1, s):
        packed = packed | (fields[..., k, :] << (bits * k))
    return packed.movedim(-2, -1)


def _unpack_plane_t(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., n*bits/8, S) -> (..., n, S) codes in natural rank order."""
    s = 8 // bits
    mask = 2**bits - 1
    return torch.cat([(packed >> (bits * k)) & mask for k in range(s)], dim=-2)


def pack_codes_t(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned codes (..., S, n) rank-major -> uint8 (..., rows, S)."""
    codes = codes.to(torch.uint8)
    if bits in (1, 2, 4):
        return _pack_plane_t(codes, bits)
    if bits == 3:
        lo = _pack_plane_t(codes & 3, 2)
        hi = _pack_plane_t(codes >> 2, 1)
        return torch.cat([lo, hi], dim=-2)
    if bits == 8:
        return codes.transpose(-1, -2)
    raise ValueError(f"unsupported pack width: {bits}")


def unpack_codes_t(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of pack_codes_t -> uint8 codes (..., n, S)."""
    if bits in (1, 2, 4):
        return _unpack_plane_t(packed, bits)
    if bits == 3:
        lo = _unpack_plane_t(packed[..., : n // 4, :], 2)
        hi = _unpack_plane_t(packed[..., n // 4 :, :], 1)
        return lo | (hi << 2)
    if bits == 8:
        return packed
    raise ValueError(f"unsupported pack width: {bits}")
