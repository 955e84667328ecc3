"""Does a W8A8 MLP beat the production w8a16 one on the card? (port of
tools/tpu_mlp_a8_probe.py): the SwiGLU MLP with the activation row
quantized to int8 in the kernel and int8 x int8 products summed in int32
(`mlp_a8`, csrc/mlp_a8.cu), against the port's mlp_gemv_int8 (int8
weights converted, bf16 activations), at the MLP shape of Llama-2-7B.

Variants (the JAX tool's names):
  w8a16 - the production mlp_gemv_int8 kernel;
  a8    - mlp_a8, held against its plain version mlp_a8_ref: the output
          within 2^-7 of max|plain|, the activation codes xq bit for bit,
          every code of h within 1 (silu's last bits differ between the
          kernel and PyTorch's CPU silu).
Then the JAX tool's summary line: a8's relative error against w8a16 and
the bound. Beside a8's time the record carries yardsticks: mlp_gemv_int8,
the dense bf16 MLP (F.silu(x Wg) * (x Wu) @ Wd in three matmuls) and
torch._int_mm over the three products (x padded to 32 rows: _int_mm takes
more than 16). Every timed call finds L2 cold. Usage:

  python -m palu_tpu_torch.tools.mlp_a8_probe [variant ...] [--h H] [--inter I] [--bn BN]
  python -m palu_tpu_torch.tools.mlp_a8_probe --use_cpu --h 256 --inter 512 --bn 128
"""

from __future__ import annotations

import argparse
import functools
from typing import List

import torch
import torch.nn.functional as F

from ..core.wquant import _div, quantize_weight
from ..ops import build
from ..ops.gemv_int8 import MAX_ROWS, mlp_gemv_int8
from . import common

__all__ = ["mlp_a8", "mlp_a8_ref", "qw", "make_inputs", "parser", "run", "main", "VARIANTS",
           "GEMV_TOL"]

H, INTER, BN = 4096, 11008, 256
VARIANTS = ["w8a16", "a8"]
# bf16 output of f32 sums against the plain version: one bf16 rounding
# apart plus a code of h across a rounding edge, as a share of max|plain|
GEMV_TOL = 2.0 ** -7
_BLOCKS_PER_SM = 4
_COLS = 128  # columns per block of the kernels (kCols)


def _check(x, wg, wu, wd, bn: int) -> tuple:
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x must be (B, H) with 1 <= B <= {MAX_ROWS}, got {tuple(x.shape)}")
    hdim = x.shape[1]
    inter = wg["wq8"].shape[1]
    for name, w, shape in (("wg", wg, (hdim, inter)), ("wu", wu, (hdim, inter)),
                           ("wd", wd, (inter, hdim))):
        if w["wq8"].dtype != torch.int8 or tuple(w["wq8"].shape) != shape:
            raise ValueError(f"{name}['wq8'] must be int8 {shape}, got {w['wq8'].dtype} "
                             f"{tuple(w['wq8'].shape)}")
        if w["ws"].dtype != torch.float32 or w["ws"].numel() != shape[1]:
            raise ValueError(f"{name}['ws'] must be f32 (1, {shape[1]})")
    if bn < 1 or inter % bn:
        raise ValueError(f"bn {bn} must divide I {inter}")
    return hdim, inter


def _idot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 sum of integer rows a with int8 codes w, converted to f32
    once: in f64, where every such sum is exact."""
    return (a.double() @ w.double()).float()


def mlp_a8_ref(x, wg, wu, wd, bn: int = BN, codes: bool = False):
    """Plain version of mlp_a8 (the TPU kernel's steps in PyTorch): -> out
    (B, H) in x.dtype, or (out, xq (B, H) int8, hq (B, I) int8) with
    codes."""
    _check(x, wg, wu, wd, bn)
    inter = wg["wq8"].shape[1]
    xb = x.float()
    xs = torch.clamp(_div(xb.abs().amax(1, keepdim=True), 127.0), min=1e-30)
    xq = torch.round(xb / xs)
    g = _idot(xq, wg["wq8"]) * (xs * wg["ws"].reshape(1, -1))
    u = _idot(xq, wu["wq8"]) * (xs * wu["ws"].reshape(1, -1))
    h = F.silu(g) * u
    acc = torch.zeros((x.shape[0], wd["wq8"].shape[1]), dtype=torch.float32, device=x.device)
    hqs = []
    for n0 in range(0, inter, bn):  # per tile of bn columns of I, in order
        ht = h[:, n0:n0 + bn]
        hs = torch.clamp(_div(ht.abs().amax(1, keepdim=True), 127.0), min=1e-30)
        hq = torch.round(ht / hs)
        acc = acc + _idot(hq, wd["wq8"][n0:n0 + bn]) * hs
        hqs.append(hq)
    out = (acc * wd["ws"].reshape(1, -1)).to(x.dtype)
    if codes:
        return out, xq.to(torch.int8), torch.cat(hqs, 1).to(torch.int8)
    return out


@functools.lru_cache(maxsize=16)
def _split(dev: torch.device, col_blocks: int, hdim: int) -> tuple:
    """(splits, rows per split) of the gate/up contraction: about four
    blocks per SM, rows a multiple of 32 (8 warps x 4-row groups)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    krange = -(-(-(-hdim // want)) // 32) * 32
    return -(-hdim // krange), krange


def mlp_a8(x, wg, wu, wd, bn: int = BN, codes: bool = False):
    """W8A8 SwiGLU MLP for x (B <= 8, H) bf16 over int8 weights {"wq8",
    "ws"}: gate and up (H, I), down (I, H). -> out (B, H) bf16, or (out,
    xq, hq) with codes. bn is the tile of I that each h scale covers (part
    of the function). CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    if not x.is_cuda:
        return mlp_a8_ref(x, wg, wu, wd, bn, codes)
    hdim, inter = _check(x, wg, wu, wd, bn)
    if x.dtype != torch.bfloat16 or hdim % _COLS or inter % _COLS or bn % 4:
        raise ValueError(f"the W8A8 kernel takes bf16 x, H and I multiples of {_COLS} and bn a "
                         f"multiple of 4 (x {x.dtype}, H={hdim}, I={inter}, bn={bn})")
    weights = [w["wq8"] for w in (wg, wu, wd)]
    scales = [w["ws"] for w in (wg, wu, wd)]
    ts = [x, *weights, *scales]
    if len({t.device for t in ts}) != 1 or not all(t.is_contiguous() for t in ts) or \
            any(t.data_ptr() % 16 for t in weights):
        raise ValueError("x and the weights must be contiguous on one device, the codes "
                         "16-byte aligned")
    b, dev = x.shape[0], x.device
    splits, krange = _split(dev, inter // _COLS, hdim)
    sums = torch.empty(2 * b * inter, dtype=torch.int32, device=dev)
    part = torch.empty((inter // bn) * b * hdim + b, dtype=torch.float32, device=dev)
    xq = torch.empty((b, hdim), dtype=torch.int8, device=dev)
    hq = torch.empty((b, inter), dtype=torch.int8, device=dev)
    out = torch.empty((b, hdim), dtype=torch.bfloat16, device=dev)
    err = build.launcher("mlp_a8", "palu_mlp_a8", "p" * 14 + "i" * 6 + "p")(
        x.data_ptr(), weights[0].data_ptr(), scales[0].data_ptr(), weights[1].data_ptr(),
        scales[1].data_ptr(), weights[2].data_ptr(), scales[2].data_ptr(), sums.data_ptr(),
        sums[b * inter:].data_ptr(), part.data_ptr(), xq.data_ptr(),
        part[(inter // bn) * b * hdim:].data_ptr(), hq.data_ptr(), out.data_ptr(), b, hdim,
        inter, bn, splits, krange, build.stream_ptr(dev))
    build.check(err, "mlp_a8")
    mlp_a8.launches += 1
    return (out, xq, hq) if codes else out


mlp_a8.launches = 0


def qw(gen: torch.Generator, shape: tuple, dev: torch.device) -> dict:
    """The tool's weight: N(0, 1) * 0.02 in f32, quantized per output
    channel to {"wq8" int8, "ws" (1, N) f32} (wquant.quantize_weight)."""
    return quantize_weight(torch.randn(shape, generator=gen, device=dev) * 0.02)


def make_inputs(dev: torch.device, gen: torch.Generator, hdim: int = H,
                inter: int = INTER) -> dict:
    """x (1, H) bf16 N(0, 1) * 0.1 and the three weights, from one generator."""
    x = (torch.randn((1, hdim), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    return {"x": x, "wg": qw(gen, (hdim, inter), dev), "wu": qw(gen, (hdim, inter), dev),
            "wd": qw(gen, (inter, hdim), dev)}


def held_codes(got: tuple, want: tuple) -> dict:
    """mlp_a8's outputs against the plain version's: out within GEMV_TOL,
    xq exact, every code of h within 1 (the count that differ reported)."""
    out = common.held(got[0].float(), want[0].float(), GEMV_TOL)
    xq = common.held(got[1], want[1], None)
    dh = (got[2].cpu().int() - want[2].cpu().int()).abs()
    hq = {"max_code_diff": int(dh.max()), "codes_differing": int((dh > 0).sum()),
          "codes": dh.numel(), "ok": int(dh.max()) <= 1}
    return {"ok": out["ok"] and xq["ok"] and hq["ok"], "max_abs_err": out["max_abs_err"],
            "max_rel_err": out.get("max_rel_err"), "tol": GEMV_TOL, "out": out, "xq": xq,
            "hq": hq}


def _nbytes(x: dict) -> int:
    """Bytes the MLP must move: the three weights' codes and scales, x, out."""
    total = sum(t.numel() * t.element_size() for w in ("wg", "wu", "wd")
                for t in x[w].values())
    return total + 2 * x["x"].numel() * x["x"].element_size()


def _yardsticks(x: dict, dev: torch.device, nch: int) -> dict:
    """Device us of the PyTorch yardsticks (not the same function): the
    dense bf16 MLP and torch._int_mm over the three products (x padded to
    32 rows), beside the production mlp_gemv_int8."""
    out = {"mlp_gemv_int8_us": common.device_us(
        lambda: mlp_gemv_int8(x["x"], x["wg"], x["wu"], x["wd"]), nch)}
    dense = {w: (x[w]["wq8"].float() * x[w]["ws"]).to(torch.bfloat16)
             for w in ("wg", "wu", "wd")}
    xb = x["x"]
    out["dense_bf16_mlp_us"] = common.device_us(
        lambda: (F.silu(xb @ dense["wg"]) * (xb @ dense["wu"])) @ dense["wd"], nch)
    del dense
    x32 = torch.zeros((32, xb.shape[1]), dtype=torch.int8, device=dev)
    h32 = torch.zeros((32, x["wg"]["wq8"].shape[1]), dtype=torch.int8, device=dev)
    out["int_mm_3_us"] = common.device_us(
        lambda: (torch._int_mm(x32, x["wg"]["wq8"]), torch._int_mm(x32, x["wu"]["wq8"]),
                 torch._int_mm(h32, x["wd"]["wq8"])), nch)
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", default=VARIANTS)
    p.add_argument("--h", type=int, default=common.env_int("H", H), help="hidden width")
    p.add_argument("--inter", type=int, default=common.env_int("INTER", INTER),
                   help="intermediate width")
    p.add_argument("--bn", type=int, default=common.env_int("BN", BN),
                   help="columns of I per tile (each tile's h has its own scale)")
    p.add_argument("--nch", type=int, default=common.env_int("CHAIN", 64),
                   help="timed calls per variant")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per variant")
    return p


def run(args) -> List[dict]:
    """Each variant once (a8 held against its plain version), then timed
    with L2 cold; then the summary. Returns the records."""
    dev = common.device_of(args.use_cpu)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variant {sorted(unknown)[0]}")
    x = make_inputs(dev, common.generator(dev), args.h, args.inter)
    ops = (x["x"], x["wg"], x["wu"], x["wd"])
    nbytes = _nbytes(x)
    fns = {"w8a16": (mlp_gemv_int8, lambda: mlp_gemv_int8(*ops)),
           "a8": (mlp_a8, lambda: mlp_a8(*ops, bn=args.bn))}
    recs, outs = [], {}
    for name in args.variants:
        counter, fn = fns[name]
        n0 = counter.launches
        rec = {"probe": "mlp_a8", "variant": name, "bytes": nbytes}
        outs[name] = fn()
        if name == "a8":
            rec["held"] = held_codes(mlp_a8(*ops, bn=args.bn, codes=True),
                                     mlp_a8_ref(*ops, bn=args.bn, codes=True))
        rec.update(common.time_call(fn, dev, args.nch))
        rec["kernel"], rec["launches"] = counter.__name__, counter.launches - n0
        if dev.type == "cuda":
            # the int8 products: 2 * B * H * I per weight, on the int8 rate
            # that a tensor-core kernel would reach (half the bf16 time)
            rec["bound_us"], rec["bound_by"] = common.bound_us(
                nbytes, 3 * args.h * args.inter)
            if name == "a8":
                rec["plain_us"] = common.device_us(lambda: mlp_a8_ref(*ops, bn=args.bn), 3)
                rec.update(_yardsticks(x, dev, args.nch))
                rec["library"] = ("torch._int_mm over the three products, x padded to 32 "
                                  "rows (the products only)")
                rec["library_us"] = rec["int_mm_3_us"]
        recs.append(rec)
    summary = {"probe": "mlp_a8", "variant": "summary", "h": args.h, "inter": args.inter,
               "bn": args.bn}
    if {"w8a16", "a8"} <= outs.keys():
        a, b = outs["w8a16"].float(), outs["a8"].float()
        summary["rel_err"] = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    if dev.type == "cuda":
        summary["floor_us"] = common.bound_us(nbytes)[0]
        summary.update({r["variant"]: r["us"] for r in recs})
    recs.append(summary)
    return recs


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        nbytes = 3 * args.h * args.inter
        print(f"device: {dev} H={args.h} I={args.inter} BN={args.bn} timed calls={args.nch} "
              f"floor {nbytes / common.PEAK_BYTES_PER_S * 1e6:.1f} us "
              f"({nbytes / 2**20:.0f} MB int8)", flush=True)
    recs = run(args)
    for rec in recs:
        if rec["variant"] == "summary":
            if args.json:
                common.emit(rec, True)
            elif "rel_err" in rec:
                print(f"# a8 vs w8a16 max rel err: {rec['rel_err']:.4f}", flush=True)
        else:
            common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs if "held" in r):
        raise SystemExit("mlp_a8_probe: the kernel disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
