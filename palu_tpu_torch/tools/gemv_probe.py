"""The bf16 GEMV streaming floor on the card (port of
tools/tpu_gemv_probe.py): an (M, K) @ (K, N) GEMV and its twin on W^T
stored (N, K), each one launch on the tensor cores (csrc/gemv_bf16.cu),
beside PyTorch's matmuls and the port's int8 weight-only GEMVs, at
K = N = 4096.

Probes (the JAX tool's names):
  pallas    - the kernel on W (K, N), x (1, K);  pallasT - on W^T (N, K);
  xla       - library: torch.matmul(x, W);  xla8 - the same at 8 rows;
  xlaT      - library: x @ (W^T)^T through F.linear on W^T;
  all3      - library: q, vt_k and vt_v products of one step, concatenated;
  nop       - library: an elementwise multiply of x (launch floor);
  i8, i8noscale, bfmlp, i8mlp3 - library: int8 weights converted in
              PyTorch, at the MLP shape 4096 x 11008;
  kgemv, kmlp - the port's gemv_int8 / mlp_gemv_int8 kernels at that shape.
Every timed call finds L2 cold (the 33.5 MB weight would stay in the 50 MB
L2 across back-to-back calls and read above the memory rate). The kernels
are held against their plain versions within 2^-7 of max|plain|. Usage:

  python -m palu_tpu_torch.tools.gemv_probe [probe ...] [--nch N] [--bn BN] [--kbn KBN]
  python -m palu_tpu_torch.tools.gemv_probe --use_cpu pallas pallasT
"""

from __future__ import annotations

import argparse
import functools
from typing import List

import torch
import torch.nn.functional as F

from ..ops import build
from ..ops.gemv_int8 import LDG_CLUSTERS, device_sms, gemv_int8, ldg_plan, mlp_gemv_int8
from . import common

__all__ = ["gemv_bf16", "gemv_bf16_t", "gemv_bf16_ref", "gemv_bf16_t_ref", "make_inputs",
           "parser", "run", "main", "DEFAULT_PROBES", "GEMV_TOL", "gemv_t_plan", "gemv_plan",
           "KN_COLS", "KN_UNIT"]

K = N = 4096
K2, N2 = 4096, 11008
DEFAULT_PROBES = ["xla", "xla8", "xlaT", "pallas", "pallasT", "all3"]
ALL_PROBES = DEFAULT_PROBES + ["nop", "kmlp", "kgemv", "i8", "i8noscale", "bfmlp", "i8mlp3"]
# bf16 output of f32 sums against the plain f32 product rounded once: the
# GEMVs' class (one bf16 rounding apart), as a share of max|plain|
GEMV_TOL = 2.0 ** -7
# gemv_bf16's kernel (csrc/gemv_bf16.cu, gemv_kn): a column block is KN_COLS
# outputs, a unit KN_UNIT contraction rows of it; two blocks of 8 warps per
# SM (its ~120 registers a thread leave room for them)
KN_COLS = 64
KN_UNIT = 32
KN_BLOCKS_PER_SM = 2
KN_COSTS = (4, 2)  # the plan's costs in units (ops/gemv_int8.ldg_plan; set from card sweeps)
# gemv_bf16_t's kernel (csrc/gemv_bf16.cu, namespace tldg): a column block
# is T_ROWS rows of W^T, blocks of 8 or 16 warps split the contraction of
# their column blocks
T_ROWS = 16


def gemv_bf16_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of gemv_bf16: the f32 product rounded to bf16."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def gemv_bf16_t_ref(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Plain version of gemv_bf16_t."""
    return (x.float() @ wt.float().t()).to(torch.bfloat16)


def gemv_plan(sms: int, k: int, n: int, rows: int, capacity=None) -> tuple:
    """Launch plan of gemv_bf16's kernel: (cluster, grid) of
    ops/gemv_int8.ldg_plan over ceil(N / KN_COLS) column blocks and
    ceil(K / KN_UNIT) units, KN_BLOCKS_PER_SM blocks per SM, `capacity` the
    card's clusters of each size in LDG_CLUSTERS. The kernel's time does
    not vary with x's rows (mma.sync takes 8), so neither does the plan;
    `rows` is checked (1 to 8)."""
    if k <= 0 or k % 8 or n <= 0 or n % 8 or not 1 <= rows <= 8:
        raise ValueError(f"gemv_bf16 takes K and N positive multiples of 8 and 1 to 8 rows: "
                         f"K={k}, N={n}, rows={rows}")
    return ldg_plan(sms, KN_BLOCKS_PER_SM, -(-n // KN_COLS), -(-k // KN_UNIT), capacity,
                    KN_COSTS)


@functools.lru_cache(maxsize=64)
def _device_capacity(dev: torch.device) -> tuple:
    """Clusters of each size in LDG_CLUSTERS of gemv_bf16's blocks that the
    card of `dev` runs at once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(dev):
        fn = build.launcher("gemv_bf16", "gemv_bf16_max_clusters", "i")
        caps = tuple(fn(c) for c in LDG_CLUSTERS)
    if min(caps) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {caps}")
    return caps


@functools.lru_cache(maxsize=256)
def _device_plan(dev: torch.device, k: int, n: int, rows: int) -> tuple:
    return gemv_plan(device_sms(dev), k, n, rows, _device_capacity(dev))


@functools.lru_cache(maxsize=256)
def gemv_t_plan(sms: int, k: int, n: int, bn: int) -> tuple:
    """Launch plan of gemv_bf16_t's kernel: (warps per block, column
    blocks per block). Each block owns cpb column blocks of T_ROWS outputs
    (at most bn // T_ROWS: `bn`, a multiple of T_ROWS, bounds the columns
    of a block) and splits their contraction over warps // cpb warps each.
    Blocks of 8 warps where the column blocks fill the card (at least one
    per SM), of 16 below that; more than one column block per block only
    where two blocks per SM stay busy (ceil(col_blocks / cpb) >= 2 * sms)."""
    if bn < T_ROWS or bn % T_ROWS:
        raise ValueError(f"gemv_bf16_t takes bn a positive multiple of {T_ROWS} (the most "
                         f"output columns of a block), got {bn}")
    if k <= 0 or k % 8 or n <= 0:
        raise ValueError(f"gemv_bf16_t takes K a positive multiple of 8 and N > 0: K={k}, N={n}")
    col_blocks = -(-n // T_ROWS)
    warps = 8 if col_blocks >= sms else 16
    cpb = 1
    while 2 * cpb <= min(warps, bn // T_ROWS) and -(-col_blocks // (2 * cpb)) >= 2 * sms:
        cpb *= 2
    return warps, cpb


def _check_operands(x, w, transposed: bool) -> tuple:
    m, k = x.shape
    n = w.shape[0] if transposed else w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.dim() != 2 or \
            (w.shape[1] if transposed else w.shape[0]) != k:
        raise ValueError(f"x (M, K) and the weight must be bf16 with K {k}, got {x.dtype} "
                         f"{tuple(x.shape)}, {w.dtype} {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.device != w.device:
        raise ValueError("x and the weight must be contiguous and on one device")
    return m, k, n


def _launch_t(x, wt, bn: int) -> torch.Tensor:
    m, k, n = _check_operands(x, wt, True)
    if not 1 <= m <= 8:
        raise ValueError(f"gemv_bf16_t takes 1 to 8 rows of x, got {m}")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("gemv_bf16_t reads x and W^T 16 bytes at a time: both 16-byte aligned")
    dev = x.device
    warps, cpb = gemv_t_plan(torch.cuda.get_device_properties(dev).multi_processor_count,
                               k, n, bn)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = build.launcher("gemv_bf16", "gemv_bf16_t_one", "ppp" + "i" * 5 + "p")(
        x.data_ptr(), wt.data_ptr(), y.data_ptr(), m, k, n, warps, cpb, build.stream_ptr(dev))
    build.check(err, "gemv_bf16_t")
    return y


def _launch(x, w, bn: int) -> torch.Tensor:
    m, k, n = _check_operands(x, w, False)
    if not 1 <= m <= 8 or k % 8 or n % 8 or bn < KN_COLS or bn % KN_COLS:
        raise ValueError(f"gemv_bf16 takes 1 to 8 rows, K and N multiples of 8 and BN a "
                         f"positive multiple of {KN_COLS}: M={m}, K={k}, N={n}, BN={bn}")
    if w.data_ptr() % 16:
        raise ValueError("gemv_bf16 reads W 16 bytes at a time: W must be 16-byte aligned")
    if x.data_ptr() % 16:
        x = x.clone()
    cluster, grid = _device_plan(x.device, k, n, m)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = build.launcher("gemv_bf16", "gemv_bf16", "ppp" + "i" * 5 + "pp")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, cluster, grid, None,
        build.stream_ptr(x.device))
    build.check(err, "gemv_bf16")
    return y


def gemv_bf16(x: torch.Tensor, w: torch.Tensor, bn: int = 512) -> torch.Tensor:
    """y (M, N) bf16 = x (M, K) bf16 @ w (K, N) bf16 in one launch
    (gemv_plan). `bn`, the TPU tool's N tile, is kept for its interface:
    the kernel's blocks take KN_COLS columns at a time, so any positive
    multiple of KN_COLS runs the same launch. CUDA tensors launch the
    kernel, CPU tensors run the plain version."""
    if not x.is_cuda:
        return gemv_bf16_ref(x, w)
    y = _launch(x, w, bn)
    gemv_bf16.launches += 1
    return y


def gemv_bf16_t(x: torch.Tensor, wt: torch.Tensor, bn: int = 512) -> torch.Tensor:
    """y (M, N) bf16 = x (M, K) bf16 @ wt^T, wt (N, K) bf16 stored
    transposed: one launch (gemv_t_plan; bn, a multiple of 16, bounds
    the output columns of a block). CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if not x.is_cuda:
        return gemv_bf16_t_ref(x, wt)
    y = _launch_t(x, wt, bn)
    gemv_bf16_t.launches += 1
    return y


gemv_bf16.launches = 0
gemv_bf16_t.launches = 0


def make_inputs(dev: torch.device, gen: torch.Generator, k: int = K, n: int = N,
                k2: int = K2, n2: int = N2, mlp: bool = True) -> dict:
    """The tool's operands from one generator: W (K, N) * 0.02 and its
    transpose stored, x1 (1, K) and x8 (8, K) * 0.1, vt_k (K, 1024) and
    vt_v (K, 3072) * 0.02, all bf16; the int8 MLP weights (codes in
    [-127, 128), f32 scales * 0.001) and their bf16 twin at K2 x N2 (when
    `mlp`)."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)

    w = normal((k, n), 0.02)
    out = {"W": w, "WT": w.t().contiguous(), "x1": normal((1, k), 0.1),
           "x8": normal((8, k), 0.1), "vt_k": normal((k, 1024), 0.02),
           "vt_v": normal((k, 3072), 0.02)}
    if not mlp:
        return out
    out["x2"], out["W2bf"] = normal((1, k2), 0.1), normal((k2, n2), 0.02)
    s_up = (torch.randn((1, n2), generator=gen, device=dev) * 0.001)
    out["W8"] = {"wq8": codes((k2, n2)), "ws": s_up}
    out["W8b"] = {"wq8": codes((k2, n2)), "ws": s_up}
    out["W8d"] = {"wq8": codes((n2, k2)),
                  "ws": torch.randn((1, k2), generator=gen, device=dev) * 0.001}
    return out


def _mm8(c, w):
    """The tool's mm8: x @ codes in f32 (codes converted to bf16), scaled."""
    y = (c @ w["wq8"].to(torch.bfloat16)).float()
    return (y * w["ws"]).to(torch.bfloat16)


def _nbytes(*ts) -> int:
    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += sum(v.numel() * v.element_size() for v in t.values())
        else:
            total += t.numel() * t.element_size()
    return total


def _probe(name: str, x: dict, bn: int, kbn: int):
    """(fn, bytes, kernel plain version or None, library name, library fn)."""
    W, WT, x1 = x["W"], x["WT"], x["x1"]
    n = W.shape[1]
    y1 = torch.empty((1, n), dtype=torch.bfloat16)
    if name == "pallas":
        return (lambda: gemv_bf16(x1, W, bn), _nbytes(W, x1, y1), lambda: gemv_bf16_ref(x1, W),
                "torch.matmul(x, W)", lambda: x1 @ W)
    if name == "pallasT":
        return (lambda: gemv_bf16_t(x1, WT, bn), _nbytes(WT, x1, y1),
                lambda: gemv_bf16_t_ref(x1, WT), "F.linear(x, W^T)", lambda: F.linear(x1, WT))
    if name == "xla":
        return lambda: x1 @ W, _nbytes(W, x1, y1), None, None, None
    if name == "xla8":
        return lambda: x["x8"] @ W, _nbytes(W, x["x8"]) + 8 * n * 2, None, None, None
    if name == "xlaT":
        return lambda: F.linear(x1, WT), _nbytes(WT, x1, y1), None, None, None
    if name == "all3":
        def all3():
            return torch.cat([x1 @ W, x1 @ x["vt_k"], x1 @ x["vt_v"]], 1)
        return all3, _nbytes(W, x["vt_k"], x["vt_v"], x1) + (n + 4096) * 2, None, None, None
    if name == "nop":
        return lambda: x1 * 1.0001, _nbytes(x1) * 2, None, None, None
    if kbn not in (0, 128):
        raise SystemExit(f"KBN={kbn}: the port's int8 GEMV kernels take blocks of 128 "
                         "columns (KBN 0 or 128)")
    x2, W8 = x["x2"], x["W8"]
    k2 = x2.shape[1]
    y2 = torch.empty((1, W8["wq8"].shape[1]), dtype=torch.bfloat16)
    if name == "kgemv":
        return lambda: gemv_int8(x2, W8), _nbytes(W8, x2, y2), None, None, None
    if name == "kmlp":
        return (lambda: mlp_gemv_int8(x2, W8, x["W8b"], x["W8d"]),
                _nbytes(W8, x["W8b"], x["W8d"], x2) + k2 * 2, None, None, None)
    if name == "i8":
        return lambda: _mm8(x2, W8), _nbytes(W8, x2, y2), None, None, None
    if name == "i8noscale":
        return (lambda: (x2 @ W8["wq8"].to(torch.bfloat16)), _nbytes(W8["wq8"], x2, y2), None,
                None, None)
    if name == "bfmlp":
        return lambda: x2 @ x["W2bf"], _nbytes(x["W2bf"], x2, y2), None, None, None
    if name == "i8mlp3":
        def mlp3():
            h = F.silu(_mm8(x2, W8).float()).to(torch.bfloat16) * _mm8(x2, x["W8b"])
            return _mm8(h, x["W8d"])
        return mlp3, _nbytes(W8, x["W8b"], x["W8d"], x2) + k2 * 2, None, None, None
    raise SystemExit(f"unknown probe {name}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("probes", nargs="*", default=DEFAULT_PROBES)
    p.add_argument("--nch", type=int, default=common.env_int("NCH", 96),
                   help="timed calls per probe")
    p.add_argument("--bn", type=int, default=common.env_int("BN", 512),
                   help="output columns per block of the bf16 kernels")
    p.add_argument("--kbn", type=int, default=common.env_int("KBN", 0),
                   help="block_n of kgemv / kmlp: 0 (the kernels' own) or 128")
    p.add_argument("--k", type=int, default=K, help="contraction of W (K, N)")
    p.add_argument("--n", type=int, default=N, help="output columns of W (K, N)")
    p.add_argument("--k2", type=int, default=K2, help="hidden width of the int8 MLP probes")
    p.add_argument("--n2", type=int, default=N2, help="inner width of the int8 MLP probes")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per probe")
    return p


def run(args) -> List[dict]:
    """Every probe once (kernels held against their plain versions), then
    timed with L2 cold. Returns the records."""
    dev = common.device_of(args.use_cpu)
    unknown = set(args.probes) - set(ALL_PROBES)
    if unknown:
        raise SystemExit(f"unknown probe {sorted(unknown)[0]}")
    x = make_inputs(dev, common.generator(dev), args.k, args.n, args.k2, args.n2,
                    mlp=not set(args.probes) <= set(ALL_PROBES[:7]))
    recs = []
    for name in args.probes:
        fn, nbytes, ref, lib_name, lib = _probe(name, x, args.bn, args.kbn)
        counter = {"pallas": gemv_bf16, "pallasT": gemv_bf16_t}.get(name)
        n0 = counter.launches if counter else 0
        rec = {"probe": "gemv", "variant": name, "bytes": nbytes}
        if ref is not None:
            rec["held"] = common.held(fn(), ref(), GEMV_TOL)
        rec.update(common.time_call(fn, dev, args.nch))
        if counter:
            rec["launches"] = counter.launches - n0
        if dev.type == "cuda":
            rec["bound_us"], rec["bound_by"] = common.bound_us(nbytes)
            rec["gb_per_s"] = nbytes / rec["us"] / 1e3
            if ref is not None:
                rec["plain_us"] = common.device_us(ref, 3)
                rec["library"], rec["library_us"] = lib_name, common.device_us(lib, args.nch)
        recs.append(rec)
    return recs


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        print(f"device: {dev} K={args.k} N={args.n} BN={args.bn} timed calls={args.nch} "
              f"W={args.k * args.n * 2 / 1e6:.1f}MB", flush=True)
    recs = run(args)
    for rec in recs:
        common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs if "held" in r):
        raise SystemExit("gemv_probe: a kernel disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
