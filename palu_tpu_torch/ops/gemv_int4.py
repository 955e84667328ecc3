"""Int4 weight-only GEMVs for decode-sized inputs (port of
palu_tpu/ops/pallas/gemv_int4.py::gemv_int4 and mlp_gemv_int4; the kernels
are csrc/gemv_int4.cu).

Weights are core/wquant.quantize_weight4 storage with 128-row groups:
{"wq4": (K/2, N) uint8, "ws": (K/128, N) f32}; rows r and r + 64 of each
group share a byte (low / high nibble) and codes 0..15 stand for -8..7.
x has 1 to 8 rows; results are in x.dtype. CUDA tensors launch the
kernels, CPU tensors run the plain versions (`*_ref`), which dequantize
group by group in f32: y = sum_g (x_g @ (q_g - 8)) * s_g.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .gemv_int8 import check_cuda, check_rows, split_k

__all__ = ["gemv_int4", "gemv_int4_ref", "mlp_gemv_int4", "mlp_gemv_int4_ref", "GROUP"]

GROUP = 128        # rows per scale group (kGroup); core/wquant.W4_GROUP
_BLOCK_N = 128     # output columns per block (kBlockN)


def _check_weight(w, k: int) -> None:
    wq, ws = w["wq4"], w["ws"]
    if wq.dtype != torch.uint8 or wq.dim() != 2 or 2 * wq.shape[0] != k:
        raise ValueError(f"wq4 must be uint8 (K/2={k // 2}, N), got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    n = wq.shape[1]
    if n % _BLOCK_N:
        raise ValueError(f"N={n} must be a multiple of {_BLOCK_N}")
    if k % GROUP or ws.dtype != torch.float32 or tuple(ws.shape) != (k // GROUP, n):
        raise ValueError(f"the kernels need {GROUP}-row groups: ws must be f32 "
                         f"({k // GROUP}, {n}) for K={k}, got {ws.dtype} {tuple(ws.shape)}")


def _check(x, w) -> None:
    check_rows(x)
    _check_weight(w, x.shape[1])


def _check_mlp(x, wg, wu, wd) -> None:
    check_rows(x)
    hdim = x.shape[1]
    for w in (wg, wu):
        _check_weight(w, hdim)
    if tuple(wu["wq4"].shape) != tuple(wg["wq4"].shape):
        raise ValueError("gate and up weights differ in shape")
    _check_weight(wd, wg["wq4"].shape[1])
    if wd["wq4"].shape[1] != hdim:
        raise ValueError(f"down weight must be (I/2, {hdim}), got {tuple(wd['wq4'].shape)}")


def _group_dot(x, w) -> torch.Tensor:
    """x (B, K) @ dequant(w) in f32, one 128-row group at a time."""
    b, k = x.shape
    ng = k // GROUP
    u = w["wq4"].reshape(ng, GROUP // 2, -1)
    codes = torch.cat([u & 0xF, u >> 4], dim=1).float() - 8.0   # (ng, 128, N)
    part = torch.bmm(x.float().reshape(b, ng, GROUP).transpose(0, 1), codes)  # (ng, B, N)
    return (part * w["ws"][:, None, :]).sum(0)


def gemv_int4_ref(x, w) -> torch.Tensor:
    """Plain version of gemv_int4."""
    _check(x, w)
    return _group_dot(x, w).to(x.dtype)


def mlp_gemv_int4_ref(x, wg, wu, wd) -> torch.Tensor:
    """Plain version of mlp_gemv_int4: h = silu(x Wg) * (x Wu) rounded to
    x.dtype, then h @ Wd."""
    _check_mlp(x, wg, wu, wd)
    h = (F.silu(_group_dot(x, wg)) * _group_dot(x, wu)).to(x.dtype)
    return _group_dot(h, wd).to(x.dtype)


def gemv_int4(x, w) -> torch.Tensor:
    """y = x @ dequant(w) for x (B <= 8, K), in x.dtype. CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    if not x.is_cuda:
        return gemv_int4_ref(x, w)
    _check(x, w)
    wq, ws = w["wq4"], w["ws"]
    check_cuda(x, (x, wq, ws), (wq, ws))
    b, k = x.shape
    n = wq.shape[1]
    dev = x.device
    splits, gps = split_k(dev, n // _BLOCK_N, k // GROUP, b)
    part = torch.empty(splits * b * n, dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    err = build.launcher("gemv_int4", "palu_gemv_int4", "piiiipppiipp")(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), b, k, n, wq.data_ptr(), ws.data_ptr(),
        part.data_ptr(), splits, gps, out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "gemv_int4")
    gemv_int4.launches += 1
    return out


gemv_int4.launches = 0


def mlp_gemv_int4(x, wg, wu, wd) -> torch.Tensor:
    """SwiGLU MLP over int4 weights for x (B <= 8, H): silu(x Wg) * (x Wu)
    rounded to x.dtype, then @ Wd. CUDA tensors launch the kernels; CPU
    tensors run the plain version."""
    if not x.is_cuda:
        return mlp_gemv_int4_ref(x, wg, wu, wd)
    _check_mlp(x, wg, wu, wd)
    b, hdim = x.shape
    inter = wg["wq4"].shape[1]
    ts = [x] + [w[key] for w in (wg, wu, wd) for key in ("wq4", "ws")]
    check_cuda(x, ts, ts[1:])
    dev = x.device
    s1, g1 = split_k(dev, 2 * inter // _BLOCK_N, hdim // GROUP, b)
    s2, g2 = split_k(dev, hdim // _BLOCK_N, inter // GROUP, b)
    part = torch.empty(s1 * b * 2 * inter + s2 * b * hdim, dtype=torch.float32, device=dev)
    h = torch.empty((b, inter), dtype=x.dtype, device=dev)
    out = torch.empty((b, hdim), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    err = build.launcher("gemv_int4", "palu_mlp_gemv_int4", "piiiipppppppiippiipp")(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), b, hdim, inter,
        *[t.data_ptr() for t in ts[1:]],
        part.data_ptr(), s1, g1, h.data_ptr(), part[s1 * b * 2 * inter:].data_ptr(), s2, g2,
        out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "mlp_gemv_int4")
    mlp_gemv_int4.launches += 1
    return out


mlp_gemv_int4.launches = 0
