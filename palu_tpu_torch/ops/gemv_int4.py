"""Int4 weight-only GEMVs for decode-sized inputs (port of
palu_tpu/ops/pallas/gemv_int4.py::gemv_int4 and mlp_gemv_int4; the kernels
are csrc/gemv_int4.cu).

Weights are core/wquant.quantize_weight4 storage with 128-row groups:
{"wq4": (K/2, N) uint8, "ws": (K/128, N) f32}; rows r and r + 64 of each
group share a byte (low / high nibble) and codes 0..15 stand for -8..7.
x has 1 to 8 rows; results are in x.dtype. CUDA tensors launch the
kernels, CPU tensors run the plain versions (`*_ref`), which dequantize
group by group in f32: y = sum_g (x_g @ (q_g - 8)) * s_g.

gemv_int4 over a bf16 x runs one launch of a register-streamed
tensor-core kernel (csrc/gemv_int4.cu; `gemv4_route`): gemv4_n32 (a block
of 16 warps per 32 columns, no cluster) where N / 32 column blocks fit the
card in one wave, else gemv4_ldg (128-column blocks, the contraction split
over a cluster) on the plan of `gemv4_plan`. On an H100 80GB HBM3 (700 W;
tools/gemv_ab.py) this beat the split pass at Llama-2-7B's q_proj,
w_fused and lm_head at 1 and 8 rows. mlp_gemv_int4 over a bf16
x runs the streaming tensor-core kernels (csrc/gemv_common.cuh, namespace
ring) in two launches on the plan of `mlp_plan` where they are the faster
(`use_stream_mlp`). Over an f32 x (tensor cores would round it to bf16),
and mlp_gemv_int4 where the streaming kernels are the slower, the CUDA-core
split pass (`split_k`) and its reduce kernels run.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import build
from .gemv_int8 import (KIND_DOWN, KIND_GATE_UP, LDG_CLUSTERS, MAX_ROWS, check_cuda,
                        check_rows, device_capacity, device_sms, ldg_plan, split_k, stream_plan)

__all__ = ["gemv_int4", "gemv_int4_ref", "mlp_gemv_int4", "mlp_gemv_int4_ref", "GROUP",
           "mlp_plan", "use_stream_mlp", "gemv4_plan", "gemv4_route", "LDG_BLOCKS_PER_SM",
           "N32_COLS"]

GROUP = 128        # rows per scale group (kGroup); core/wquant.W4_GROUP
_BLOCK_N = 128     # output columns per block (kBlockN)
# palu_mlp_gemv_int4_stream: x, B, H, I, six weight tensors, h's scratch,
# two plans, out, timeline, stream
_STREAM_SIG = "piii" + "p" * 7 + "i" * 4 + "ppp"
# gemv4_ldg's blocks per SM (__launch_bounds__(256, 2): 128 registers a
# thread), and its plan's costs in tiles (ops/gemv_int8.ldg_plan)
LDG_BLOCKS_PER_SM = 2
LDG_COSTS = (1, 1)


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


# On an H100 80GB HBM3 (700 W; tools/gemv_ab.py, three A/B calls) the
# streaming MLP was 0.38x the split pass at Llama-2-7B's width and 8 rows
# and faster from 2 rows, 0.83-0.93x at Qwen2-7B's (H 3584 x I 18944,
# 68 Mi) at 1 row, but 1.02-1.04x at Llama-2-7B's (4096 x 11008, 45 Mi) at
# 1 row. Only these two widths were measured at 1 row: the boundary between
# them is unmeasured, so a width from 45 to 68 Mi (4096 x 14336, 5120 x
# 13824) takes a route that no measurement backs.
MLP_STREAM_MIN_1ROW = 64 << 20


def use_stream_mlp(hdim: int, inter: int, rows: int) -> bool:
    """Whether mlp_gemv_int4 over a bf16 x takes the streaming kernels:
    from 2 rows, or at 1 row when H x I reaches MLP_STREAM_MIN_1ROW."""
    return rows >= 2 or hdim * inter >= MLP_STREAM_MIN_1ROW


def mlp_plan(sms: int, hdim: int, inter: int, rows: int, capacity=(None, None)):
    """The streaming MLP's two launches, each (cluster, grid) of
    gemv_int8.stream_plan: gate and up (I / 128 column blocks, H / 128
    groups), then down (H / 128 column blocks, I / 128 groups), with each
    kind's cluster capacity; None when either leaves no room for a ring (the
    split pass runs instead)."""
    first = stream_plan(sms, KIND_GATE_UP, inter // GROUP, hdim // GROUP, rows, capacity[0])
    second = stream_plan(sms, KIND_DOWN, hdim // GROUP, inter // GROUP, rows, capacity[1])
    return None if first is None or second is None else (first, second)


@functools.lru_cache(maxsize=256)
def _device_mlp_plan(dev: torch.device, hdim: int, inter: int, rows: int):
    """mlp_plan on the card of `dev` (its SMs and cluster capacities), cached
    so that a call makes one lookup (the decode step is host-bound)."""
    return mlp_plan(device_sms(dev), hdim, inter, rows,
                    (device_capacity(dev, KIND_GATE_UP), device_capacity(dev, KIND_DOWN)))


def gemv4_plan(sms: int, k: int, n: int, rows: int, capacity=None) -> tuple:
    """Launch plan of gemv_int4 over a bf16 x (gemv4_ldg): (cluster, grid)
    of gemv_int8.ldg_plan over the N / 128 column blocks and K / 128 groups,
    two blocks per SM, `capacity` the card's clusters of each size in
    LDG_CLUSTERS. The kernel's time does not vary with x's rows (mma.sync
    takes 8), so neither does the plan; `rows` is checked (1 to 8)."""
    if k <= 0 or k % GROUP or n <= 0 or n % _BLOCK_N or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"gemv4_ldg takes K a positive multiple of {GROUP}, N of {_BLOCK_N} "
                         f"and 1 to {MAX_ROWS} rows: K={k}, N={n}, rows={rows}")
    return ldg_plan(sms, LDG_BLOCKS_PER_SM, n // _BLOCK_N, k // GROUP, capacity, LDG_COSTS)


N32_COLS = 32  # gemv4_n32's columns of a block (kColsN); one block of 16 warps per SM


def gemv4_route(sms: int, k: int, n: int, rows: int, capacity=None) -> tuple:
    """gemv_int4's tensor-core launch over a bf16 x: ("n32", N / 32 blocks)
    where the narrow column blocks fit the card in one wave (one block per
    SM), else ("ldg", gemv4_plan)."""
    if n % N32_COLS == 0 and 0 < n // N32_COLS <= sms:
        gemv4_plan(sms, k, n, rows, capacity)  # the same checks
        return "n32", n // N32_COLS
    return "ldg", gemv4_plan(sms, k, n, rows, capacity)


@functools.lru_cache(maxsize=64)
def _device_ldg_capacity(dev: torch.device) -> tuple:
    """Clusters of each size in LDG_CLUSTERS that the card of `dev` runs of
    gemv4_ldg's blocks at once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(dev):
        fn = build.launcher("gemv_int4", "palu_gemv4_ldg_max_clusters", "i")
        caps = tuple(fn(c) for c in LDG_CLUSTERS)
    if min(caps) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {caps}")
    return caps


@functools.lru_cache(maxsize=256)
def _device_gemv4_route(dev: torch.device, k: int, n: int, rows: int) -> tuple:
    """gemv4_route on the card of `dev`, cached (the decode step is
    host-bound: a call makes one lookup)."""
    return gemv4_route(device_sms(dev), k, n, rows, _device_ldg_capacity(dev))


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
    the kernel (bf16 x: one launch of gemv4_n32 or gemv4_ldg, gemv4_route;
    f32 x: the split pass and its reduce kernel); CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return gemv_int4_ref(x, w)
    _check(x, w)
    wq, ws = w["wq4"], w["ws"]
    check_cuda(x, (x, wq, ws), (wq, ws))
    b, k = x.shape
    n = wq.shape[1]
    dev = x.device
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    if x.dtype == torch.bfloat16:
        if xc.data_ptr() % 16:  # x is read 16 bytes at a time
            xc = xc.clone()
        kind, plan = _device_gemv4_route(dev, k, n, b)
        if kind == "n32":
            err = build.launcher("gemv_int4", "palu_gemv_int4_n32", "piiippppp")(
                xc.data_ptr(), b, k, n, wq.data_ptr(), ws.data_ptr(), out.data_ptr(), None,
                build.stream_ptr(dev))
        else:
            err = build.launcher("gemv_int4", "palu_gemv_int4_ldg", "piiippiippp")(
                xc.data_ptr(), b, k, n, wq.data_ptr(), ws.data_ptr(), *plan, out.data_ptr(),
                None, build.stream_ptr(dev))
    else:
        splits, gps = split_k(dev, n // _BLOCK_N, k // GROUP, b)
        part = torch.empty(splits * b * n, dtype=torch.float32, device=dev)
        err = build.launcher("gemv_int4", "palu_gemv_int4", "piiiipppiipp")(
            xc.data_ptr(), 0, b, k, n, wq.data_ptr(), ws.data_ptr(), part.data_ptr(), splits,
            gps, out.data_ptr(), build.stream_ptr(dev))
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
    out = torch.empty((b, hdim), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    plan = None
    if x.dtype == torch.bfloat16 and use_stream_mlp(hdim, inter, b):
        plan = _device_mlp_plan(dev, hdim, inter, b)
    if plan is not None:
        if xc.data_ptr() % 16:
            xc = xc.clone()
        hp = torch.empty(b * inter // 2, dtype=torch.int32, device=dev)  # h's fragments
        err = build.launcher("gemv_int4", "palu_mlp_gemv_int4_stream", _STREAM_SIG)(
            xc.data_ptr(), b, hdim, inter, *[t.data_ptr() for t in ts[1:]], hp.data_ptr(),
            *plan[0], *plan[1], out.data_ptr(), None, build.stream_ptr(dev))
    else:
        s1, g1 = split_k(dev, 2 * inter // _BLOCK_N, hdim // GROUP, b)
        s2, g2 = split_k(dev, hdim // _BLOCK_N, inter // GROUP, b)
        part = torch.empty(s1 * b * 2 * inter + s2 * b * hdim, dtype=torch.float32,
                           device=dev)
        h = torch.empty((b, inter), dtype=x.dtype, device=dev)
        err = build.launcher("gemv_int4", "palu_mlp_gemv_int4", "piiiipppppppiippiipp")(
            xc.data_ptr(), int(x.dtype == torch.bfloat16), b, hdim, inter,
            *[t.data_ptr() for t in ts[1:]],
            part.data_ptr(), s1, g1, h.data_ptr(), part[s1 * b * 2 * inter:].data_ptr(), s2,
            g2, out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "mlp_gemv_int4")
    mlp_gemv_int4.launches += 1
    return out


mlp_gemv_int4.launches = 0
