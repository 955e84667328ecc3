"""Int8 weight-only GEMVs for decode-sized inputs (port of
palu_tpu/ops/pallas/gemv_int8.py::gemv_int8 and mlp_gemv_int8; the kernels
are csrc/gemv_int8.cu).

Weights are core/wquant.quantize_weight storage: {"wq8": (K, N) int8,
"ws": (1, N) f32}, per-output-channel scales applied after the sum. x has
1 to 8 rows; results are in x.dtype. CUDA tensors launch the kernels, CPU
tensors run the plain versions (`*_ref`, f32 products of the codes). The
weight may be a transposed view with K contiguous (the tied int8 lm_head,
embedding codes (V, H) read as (H, V)); the kernel reads it in place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import build

__all__ = ["gemv_int8", "gemv_int8_ref", "mlp_gemv_int8", "mlp_gemv_int8_ref",
           "MAX_ROWS", "split_k", "check_rows", "check_cuda"]

MAX_ROWS = 8       # rows a kernel takes (PALU_SWITCH_B)
_BLOCK_N = 128     # output columns per block (kBlockN)
_UNIT = 128        # contraction rows per split unit (kUnit)
_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=256)
def split_k(dev: torch.device, col_blocks: int, units: int, rows: int):
    """Split `units` 128-row units of the contraction over blocks so that
    about four blocks run per SM, with x's slice (rows x units x 128 f32)
    kept within 32 KB of shared memory: (splits, units per split)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    per = min(max(1, -(-units // want)), max(1, 64 // rows))
    return -(-units // per), per


def check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x must be (B, K) with 1 <= B <= {MAX_ROWS}, got {tuple(x.shape)}")


def _check_weight(w, k: int) -> None:
    wq, ws = w["wq8"], w["ws"]
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"wq8 must be int8 (K={k}, N), got {wq.dtype} {tuple(wq.shape)}")
    if wq.shape[1] % _BLOCK_N:
        raise ValueError(f"N={wq.shape[1]} must be a multiple of {_BLOCK_N}")
    if ws.dtype != torch.float32 or ws.numel() != wq.shape[1]:
        raise ValueError(f"ws must be f32 (1, {wq.shape[1]}), got {ws.dtype} {tuple(ws.shape)}")


def _check(x, w) -> None:
    check_rows(x)
    _check_weight(w, x.shape[1])


def _dot(x, w) -> torch.Tensor:
    """(x @ codes) * ws in f32."""
    return (x.float() @ w["wq8"].float()) * w["ws"].reshape(1, -1)


def gemv_int8_ref(x, w) -> torch.Tensor:
    """Plain version of gemv_int8."""
    _check(x, w)
    return _dot(x, w).to(x.dtype)


def _check_mlp(x, wg, wu, wd) -> None:
    check_rows(x)
    hdim = x.shape[1]
    for w in (wg, wu):
        _check_weight(w, hdim)
    if tuple(wu["wq8"].shape) != tuple(wg["wq8"].shape):
        raise ValueError("gate and up weights differ in shape")
    _check_weight(wd, wg["wq8"].shape[1])
    if wd["wq8"].shape[1] != hdim:
        raise ValueError(f"down weight must be (I, {hdim}), got {tuple(wd['wq8'].shape)}")


def mlp_gemv_int8_ref(x, wg, wu, wd) -> torch.Tensor:
    """Plain version of mlp_gemv_int8: gate/up scales before silu, h in
    x.dtype, the down scale after its sum."""
    _check_mlp(x, wg, wu, wd)
    h = (F.silu(_dot(x, wg)) * _dot(x, wu)).to(x.dtype)
    return _dot(h, wd).to(x.dtype)


def check_cuda(x, tensors, aligned=()) -> None:
    """What the kernels take: x bf16 or f32, all tensors on one device, and
    the `aligned` ones contiguous from a 16-byte boundary."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    dev = x.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("all tensors must be on one device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in aligned):
        raise ValueError("weights and scales must be contiguous and 16-byte aligned")


def _scales(ws: torch.Tensor) -> torch.Tensor:
    if not ws.is_contiguous():
        raise ValueError("ws must be contiguous")
    return ws


def _layout(wq: torch.Tensor):
    """(ldw, k_major) of a (K, N) int8 weight, N contiguous or K contiguous;
    each row or column must start on a 4-byte (K-major) or 8-byte boundary."""
    if wq.stride(1) == 1:
        ldw, k_major, align = wq.stride(0), 0, 8
    elif wq.stride(0) == 1:
        ldw, k_major, align = wq.stride(1), 1, 4
        if wq.shape[0] % 4:
            raise ValueError(f"K-major weight needs K % 4 == 0, got K={wq.shape[0]}")
    else:
        raise ValueError(f"wq8 must have N or K contiguous, strides {wq.stride()}")
    if ldw % align or wq.data_ptr() % 16:
        raise ValueError(f"wq8 rows must be {align}-byte aligned (ldw={ldw})")
    return ldw, k_major


def gemv_int8(x, w) -> torch.Tensor:
    """y = x @ dequant(w) for x (B <= 8, K): (x @ codes) * ws in f32, cast to
    x.dtype. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return gemv_int8_ref(x, w)
    _check(x, w)
    wq = w["wq8"]
    ws = _scales(w["ws"])
    check_cuda(x, (x, wq, ws))
    ldw, k_major = _layout(wq)
    b, k = x.shape
    n = wq.shape[1]
    dev = x.device
    xc = x.contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    if k_major:
        splits, ups, part = 0, 0, None
    else:
        splits, ups = split_k(dev, n // _BLOCK_N, -(-k // _UNIT), b)
        part = torch.empty(splits * b * n, dtype=torch.float32, device=dev)
    err = build.launcher("gemv_int8", "palu_gemv_int8", "piiiipiippiipp")(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), b, k, n, wq.data_ptr(), ldw, k_major,
        ws.data_ptr(), None if part is None else part.data_ptr(), splits, ups,
        out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "gemv_int8")
    gemv_int8.launches += 1
    return out


gemv_int8.launches = 0


def mlp_gemv_int8(x, wg, wu, wd) -> torch.Tensor:
    """SwiGLU MLP over int8 weights for x (B <= 8, H): silu(x Wg) * (x Wu)
    rounded to x.dtype, then @ Wd. Weights row-major (N contiguous). CUDA
    tensors launch the kernels; CPU tensors run the plain version."""
    if not x.is_cuda:
        return mlp_gemv_int8_ref(x, wg, wu, wd)
    _check_mlp(x, wg, wu, wd)
    b, hdim = x.shape
    inter = wg["wq8"].shape[1]
    weights = [wg["wq8"], wu["wq8"], wd["wq8"]]
    scales = [_scales(w["ws"]) for w in (wg, wu, wd)]
    check_cuda(x, [x] + weights + scales, weights)
    dev = x.device
    s1, u1 = split_k(dev, 2 * inter // _BLOCK_N, -(-hdim // _UNIT), b)
    s2, u2 = split_k(dev, hdim // _BLOCK_N, -(-inter // _UNIT), b)
    part = torch.empty(s1 * b * 2 * inter + s2 * b * hdim, dtype=torch.float32, device=dev)
    h = torch.empty((b, inter), dtype=x.dtype, device=dev)
    out = torch.empty((b, hdim), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    err = build.launcher("gemv_int8", "palu_mlp_gemv_int8", "piiiipppppppiippiipp")(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), b, hdim, inter,
        weights[0].data_ptr(), scales[0].data_ptr(), weights[1].data_ptr(),
        scales[1].data_ptr(), weights[2].data_ptr(), scales[2].data_ptr(),
        part.data_ptr(), s1, u1, h.data_ptr(), part[s1 * b * 2 * inter:].data_ptr(), s2, u2,
        out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "mlp_gemv_int8")
    mlp_gemv_int8.launches += 1
    return out


mlp_gemv_int8.launches = 0
