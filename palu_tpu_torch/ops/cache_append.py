"""Decode-step cache append: quantize + pack + masked column write of one
token, both sides of a layer in one kernel launch (port of
palu_tpu/ops/pallas/cache_append.py::append_token_quantized; the kernel is
csrc/cache_append.cu).

`append_kv_quantized` writes the K and V sides of one layer;
`append_token_quantized`, the counterpart of the TPU function, writes one
side through the same kernel. Both launch the kernel for CUDA tensors and
run the plain version (`*_ref`) for CPU tensors. They update the cache
buffers in place (the JAX op aliases them under donation) and are
bit-identical to quantize_affine + pack_codes_t followed by
write_at_lanes_masked: lanes with writeable == 0, or a position outside
the cache, keep their bytes.

`KVAppend` is what both run: built on one layer's buffers, it checks their
shapes, dtypes, contiguity and device and resolves the launcher once, so a
call checks only the latents and launches (the engine keeps one per layer
and cache: the decode step is host-bound). A latent that is not contiguous
raises; it is not copied.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.quant import QuantConfig, packed_nrows
from ..runtime import cache as cache_lib
from . import build

__all__ = ["append_supported", "append_kv_quantized", "append_kv_quantized_ref",
           "append_token_quantized", "append_token_quantized_ref", "KVAppend"]

_LAT_DTYPES = (torch.bfloat16, torch.float32)


def append_supported(qcfg: Optional[QuantConfig]) -> bool:
    """True when the append kernel covers this config: per-row rank-major
    quantized cache at a byte-aligned pack width."""
    return (qcfg is not None and qcfg.enabled and qcfg.group_size == 0
            and qcfg.pack_bits in (2, 4, 8))


class _Plan(ctypes.Structure):
    """Mirror of cache_append.cu's Plan (filled once per layer's buffers)."""
    _fields_ = [("codes", ctypes.c_void_p * 2), ("scale", ctypes.c_void_p * 2),
                ("zero", ctypes.c_void_p * 2), ("G", ctypes.c_int * 2),
                ("rank", ctypes.c_int * 2), ("sides", ctypes.c_int), ("B", ctypes.c_int),
                ("S", ctypes.c_int), ("bits", ctypes.c_int), ("pbits", ctypes.c_int),
                ("sym", ctypes.c_int), ("do_clip", ctypes.c_int),
                ("clip_ratio", ctypes.c_float)]


def _check_side(bufs: dict, qcfg: QuantConfig, rank: int) -> tuple:
    """One side's buffers: codes (B, G, nrows, S) uint8, scale (and zero
    when asymmetric) f32 (B, G, S) or (B, G, 1, S), on one device. Returns
    (B, G, S)."""
    codes, scale, zero = bufs["codes_t"], bufs["scale_t"], bufs.get("zero_t")
    if (zero is not None) == qcfg.sym:
        raise ValueError("zero buffer must be given exactly when qcfg is asymmetric")
    nrows = packed_nrows(rank, qcfg.pack_bits)
    if rank <= 0 or rank % (8 // qcfg.pack_bits):
        raise ValueError(f"rank {rank} does not fill whole bytes at pack width "
                         f"{qcfg.pack_bits}")
    if codes.dim() != 4 or codes.shape[2] != nrows or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 (B, G, {nrows}, S), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    b, g, _, s_max = codes.shape
    for name, buf in (("scale", scale), ("zero", zero)):
        if buf is None:
            continue
        if buf.numel() != b * g * s_max or buf.dtype != torch.float32 or buf.shape[-1] != s_max:
            raise ValueError(f"{name} must be f32 (B, G, S) or (B, G, 1, S)")
    if len({t.device for t in (codes, scale, zero) if t is not None}) != 1:
        raise ValueError("a side's buffers must be on one device")
    return b, g, s_max


class KVAppend:
    """The append of one layer's sides (K and V, or one side) into their
    buffers, checked once here: `bufs` holds each side's {"codes_t",
    "scale_t"[, "zero_t"]}, `ranks` each side's rank. A call
    KVAppend(...)(lats, pos, writeable) quantizes lats[i] (B, G, rank_i)
    into side i at per-lane positions pos (B,) (the caller clamps them) for
    lanes with writeable != 0, in place: one kernel launch for CUDA
    buffers (counted on `counter`), the plain version for CPU ones."""

    def __init__(self, bufs, ranks, *, qcfg: QuantConfig, counter=None):
        if not append_supported(qcfg):
            raise ValueError(f"append kernel needs per-row scales at pack width 2/4/8, "
                             f"got {qcfg}")
        if not 1 <= len(bufs) == len(ranks) <= 2:
            raise ValueError("one or two sides")
        shapes = [_check_side(b, qcfg, r) for b, r in zip(bufs, ranks)]
        if len({(b, s) for b, _, s in shapes}) != 1:
            raise ValueError(f"the sides differ in lanes or positions: {shapes}")
        devs = {b["codes_t"].device for b in bufs}
        if len(devs) != 1:
            raise ValueError(f"all buffers must be on one device, got {devs}")
        self.qcfg = qcfg
        self.device = devs.pop()
        self.batch, _, self.s_max = shapes[0]
        self.lat_shapes = tuple((b, g, r) for (b, g, _), r in zip(shapes, ranks))
        self.counter = counter if counter is not None else append_kv_quantized
        if not self.device.type == "cuda":
            self._bufs = bufs  # the plain version writes them
            return
        if any(not t.is_contiguous() for b in bufs for t in b.values()):
            raise ValueError("cache buffers must be contiguous (the kernel writes them in place)")
        plan = _Plan()
        for i, (b, r) in enumerate(zip(bufs, ranks)):
            plan.codes[i] = b["codes_t"].data_ptr()
            plan.scale[i] = b["scale_t"].data_ptr()
            plan.zero[i] = b["zero_t"].data_ptr() if "zero_t" in b else None
            plan.G[i], plan.rank[i] = shapes[i][1], r
        plan.sides, plan.B, plan.S = len(bufs), self.batch, self.s_max
        plan.bits, plan.pbits, plan.sym = qcfg.bits, qcfg.pack_bits, int(qcfg.sym)
        plan.do_clip, plan.clip_ratio = int(qcfg.clip_ratio < 1.0), qcfg.clip_ratio
        self._plan = plan
        self._plan_ptr = ctypes.addressof(plan)
        self._index = self.device.index if self.device.index is not None else \
            torch.cuda.current_device()
        self._launch = build.launcher("cache_append", "palu_cache_append", "pppippp")

    def __call__(self, lats, pos, writeable) -> None:
        if len(lats) != len(self.lat_shapes):
            raise ValueError(f"{len(self.lat_shapes)} latents expected, got {len(lats)}")
        dt = lats[0].dtype
        for lat, shape in zip(lats, self.lat_shapes):
            if lat.shape != shape or lat.dtype != dt or dt not in _LAT_DTYPES:
                raise ValueError(f"latents must be bf16 or f32 {shape} of one dtype, got "
                                 f"{lat.dtype} {tuple(lat.shape)}")
            if not lat.is_contiguous():
                raise ValueError("latents must be contiguous (not copied)")
        if pos.shape != (self.batch,) or writeable.shape != (self.batch,):
            raise ValueError("pos and writeable must be (B,)")
        if self.device.type != "cuda":
            if any(t.device != self.device for t in (*lats, pos, writeable)):
                raise ValueError(f"all tensors must be on {self.device}")
            for lat, bufs in zip(lats, self._bufs):
                _append_ref(lat, bufs, pos, writeable, self.qcfg)
            return
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        if writeable.dtype != torch.bool:
            writeable = writeable.to(torch.bool)
        idx = self._index
        if any(t.get_device() != idx for t in (*lats, pos, writeable)):
            raise ValueError(f"all tensors must be on cuda:{idx}")
        if not (pos.is_contiguous() and writeable.is_contiguous()):
            raise ValueError("pos and writeable must be contiguous")
        err = self._launch(self._plan_ptr, lats[0].data_ptr(),
                           lats[1].data_ptr() if len(lats) == 2 else None,
                           int(dt == torch.bfloat16), pos.data_ptr(), writeable.data_ptr(),
                           torch._C._cuda_getCurrentRawStream(idx))
        build.check(err, "cache_append")
        self.counter.launches += 1


def _append_ref(lat, bufs: dict, pos, writeable, qcfg: QuantConfig) -> None:
    """quantize_affine + pack_codes_t of the one-token column lat (B, G,
    rank), then the masked per-lane write into one side's buffers."""
    b, g, _ = lat.shape
    s_max = bufs["codes_t"].shape[-1]
    view = {"codes_t": bufs["codes_t"], "scale_t": bufs["scale_t"].view(b, g, 1, s_max)}
    if "zero_t" in bufs:
        view["zero_t"] = bufs["zero_t"].view(b, g, 1, s_max)
    upd = cache_lib._encode(lat[:, :, None, :], qcfg)
    cache_lib.write_at_lanes_masked(view, upd, pos, writeable.bool())


def _side(codes, scale, zero) -> dict:
    bufs = {"codes_t": codes, "scale_t": scale}
    if zero is not None:
        bufs["zero_t"] = zero
    return bufs


def append_kv_quantized_ref(lat_k, lat_v, bufs_k, bufs_v, pos, writeable, *,
                            qcfg: QuantConfig, rank_k: int, rank_v: int) -> None:
    """Plain version of append_kv_quantized (each side as
    append_token_quantized_ref), in place."""
    for lat, bufs, rank in ((lat_k, bufs_k, rank_k), (lat_v, bufs_v, rank_v)):
        append_token_quantized_ref(lat, bufs["codes_t"], bufs["scale_t"], pos, writeable,
                                   qcfg=qcfg, rank=rank, zero=bufs.get("zero_t"))


def append_kv_quantized(lat_k, lat_v, bufs_k, bufs_v, pos, writeable, *,
                        qcfg: QuantConfig, rank_k: int, rank_v: int) -> None:
    """Quantize one token's K and V latents lat_k (B, G, rank_k), lat_v (B,
    G, rank_v) and write them into their rank-major packed caches bufs_k,
    bufs_v ({"codes_t", "scale_t"[, "zero_t"]}) at per-lane positions pos
    (B,) (the caller clamps them), for lanes with writeable != 0: one
    kernel launch for CUDA tensors, the plain version for CPU tensors. In
    place."""
    if not lat_k.is_cuda:
        return append_kv_quantized_ref(lat_k, lat_v, bufs_k, bufs_v, pos, writeable,
                                       qcfg=qcfg, rank_k=rank_k, rank_v=rank_v)
    KVAppend((bufs_k, bufs_v), (rank_k, rank_v), qcfg=qcfg)((lat_k, lat_v), pos, writeable)


append_kv_quantized.launches = 0


def _check_lat(lat, rank: int) -> None:
    if lat.dim() != 3 or lat.shape[-1] != rank:
        raise ValueError(f"lat must be (B, G, {rank}), got {tuple(lat.shape)}")


def append_token_quantized_ref(lat, codes, scale, pos, writeable, *,
                               qcfg: QuantConfig, rank: int, zero=None):
    """Plain version of append_token_quantized: quantize_affine +
    pack_codes_t of the one-token column, then the masked per-lane write.
    Updates the buffers in place and returns them."""
    if not append_supported(qcfg):
        raise ValueError(f"append kernel needs per-row scales at pack width 2/4/8, got {qcfg}")
    bufs = _side(codes, scale, zero)
    b, g, _ = _check_side(bufs, qcfg, rank)
    _check_lat(lat, rank)
    if tuple(lat.shape[:2]) != (b, g):
        raise ValueError(f"lat (B, G) {tuple(lat.shape[:2])} differs from the cache's {(b, g)}")
    if tuple(pos.shape) != (b,) or tuple(writeable.shape) != (b,):
        raise ValueError("pos and writeable must be (B,)")
    if len({t.device for t in (lat, codes, pos, writeable)}) != 1:
        raise ValueError("all tensors must be on one device")
    _append_ref(lat, bufs, pos, writeable, qcfg)
    return (codes, scale) if zero is None else (codes, scale, zero)


def append_token_quantized(lat, codes, scale, pos, writeable, *,
                           qcfg: QuantConfig, rank: int, zero=None):
    """Quantize one token's latents lat (B, G, rank) and write them into the
    rank-major packed cache at per-lane positions pos (B,) (the caller
    clamps them), for lanes with writeable != 0. CUDA tensors launch the
    kernel (with one side), CPU tensors run the plain version. In place;
    returns (codes, scale[, zero])."""
    if not lat.is_cuda:
        return append_token_quantized_ref(lat, codes, scale, pos, writeable,
                                          qcfg=qcfg, rank=rank, zero=zero)
    _check_lat(lat, rank)
    KVAppend((_side(codes, scale, zero),), (rank,), qcfg=qcfg,
             counter=append_token_quantized)((lat,), pos, writeable)
    return (codes, scale) if zero is None else (codes, scale, zero)


append_token_quantized.launches = 0
