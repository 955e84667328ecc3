"""Latent quantization (port of palu_tpu/core/quant.py): the rank-major
packed layout of the KV cache and the seq-major one of the v1 decode kernel.

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

Seq-major (`quantize` / `dequantize` / `pack_codes` / `unpack_codes`):
codes, scales and the zero-point `base` as JAX returns them. Codes are
int8 in [0, 2^bits) biased by q_min; XLA's float-to-int8 conversion
saturates, so 8-bit asymmetric codes above 127 read 127 here too. Planar
packing along the last dim: for p in {1, 2, 4} the code of index i sits
in byte i mod (n / s), bit-field i div (n / s) (s = 8 / p); exact 3-bit is
a 2-bit plane (n/4 bytes) followed by a 1-bit plane (n/8 bytes).

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
    "fake_quantize",
    "quantize",
    "dequantize",
    "pack_codes",
    "unpack_codes",
    "packed_nbytes",
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
    hadamard: bool = False  # latents rotated by Hadamard fusion at load (a record)
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


def _quantized_grid(x: torch.Tensor, cfg: QuantConfig):
    """Grouped x -> (q, scales, base, q_min): q the clipped integer grid
    values in f32."""
    g = _group(x, cfg.group_size)
    scales, base, q_min, q_max = _scales_base(g, cfg.bits, cfg.sym, cfg.clip_ratio)
    q = torch.clamp(torch.round(g.float() / scales) + base, q_min, q_max)
    return q, scales, base, q_min


def fake_quantize(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize round trip in f32, returned in x's dtype."""
    if not cfg.enabled:
        return x
    q, scales, base, _ = _quantized_grid(x, cfg)
    return ((q - base) * scales).reshape(x.shape).to(x.dtype)


def quantize(x: torch.Tensor, cfg: QuantConfig):
    """Seq-major quantization -> (codes int8 in [0, 2^bits), scales, base),
    scales and base (..., 1) per row or (..., n // group_size)."""
    if not cfg.enabled:
        raise ValueError("quantize needs bits < 16")
    q, scales, base, q_min = _quantized_grid(x, cfg)
    codes = torch.clamp(q - q_min, -128, 127).to(torch.int8).reshape(x.shape)
    return codes, scales.squeeze(-1), base.squeeze(-1)


def dequantize(codes: torch.Tensor, scales: torch.Tensor, base: torch.Tensor,
               cfg: QuantConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """(code + q_min - base) * scale in f32, returned in `dtype`."""
    q_min = -(2 ** (cfg.bits - 1)) if cfg.sym else 0
    g = _group(codes, cfg.group_size)
    out = (g.float() + q_min - base[..., None]) * scales[..., None]
    return out.reshape(codes.shape).to(dtype)


def _pack_plane(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Last-dim codes (values < 2^bits) -> n * bits / 8 bytes per row."""
    n = codes.shape[-1]
    s = 8 // bits
    if n % s:
        raise ValueError(f"last dim {n} must be divisible by {s} for {bits}-bit packing")
    fields = codes.reshape(codes.shape[:-1] + (s, n // s))
    packed = fields[..., 0, :]
    for k in range(1, s):
        packed = packed | (fields[..., k, :] << (bits * k))
    return packed


def _unpack_plane(packed: torch.Tensor, bits: int) -> torch.Tensor:
    s = 8 // bits
    mask = 2**bits - 1
    return torch.cat([(packed >> (bits * k)) & mask for k in range(s)], dim=-1)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned codes (< 2^bits) along the last dim into uint8 planes;
    3-bit: the 2-bit plane (n/4 bytes), then the 1-bit plane (n/8)."""
    codes = codes.to(torch.uint8)
    if bits in (1, 2, 4):
        return _pack_plane(codes, bits)
    if bits == 3:
        return torch.cat([_pack_plane(codes & 3, 2), _pack_plane(codes >> 2, 1)], dim=-1)
    if bits == 8:
        return codes
    raise ValueError(f"unsupported pack width: {bits}")


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of pack_codes -> uint8 codes of last-dim length n."""
    if bits in (1, 2, 4):
        return _unpack_plane(packed, bits)
    if bits == 3:
        lo = _unpack_plane(packed[..., : n // 4], 2)
        hi = _unpack_plane(packed[..., n // 4:], 1)
        return lo | (hi << 2)
    if bits == 8:
        return packed
    raise ValueError(f"unsupported pack width: {bits}")


def packed_nbytes(n: int, bits: int) -> int:
    """Bytes per row of n codes at the given width (seq-major layout)."""
    if bits in (1, 2, 4, 8):
        return n * bits // 8
    if bits == 3:
        return n // 4 + n // 8
    raise ValueError(f"unsupported pack width: {bits}")


def quantize_affine(x: torch.Tensor, cfg: QuantConfig):
    """x ~= scale * code + zero with unsigned uint8 codes in [0, 2^bits).

    group_size == 0: returns (codes, scales (...,), zeros (...,));
    group_size > 0: scales/zeros are (..., n // group_size)."""
    if not cfg.enabled:
        raise ValueError("quantize_affine needs bits < 16")
    q, scales, base, q_min = _quantized_grid(x, cfg)
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
