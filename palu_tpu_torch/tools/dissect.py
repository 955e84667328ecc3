"""Dissect the production latent decode's time on the card (port of
tools/tpu_dissect.py): palu_decode_fp over seq-major bf16 latents
(csrc/palu_decode_fp.cu), run in five modes of its own split kernel.

Modes (the JAX tool's names):
  full      - the production instantiation itself: its output is
              palu_decode_fp's, bit for bit;
  novalue   - the V contraction dropped; emits each head's softmax
              statistics (m, l);
  nologits  - the K rebuild and q dot replaced by fake logits, 1e-6 times
              each token's x_k summed over ranks (the block's own group; the
              TPU block held every group and summed group 0's); value path
              kept;
  dmaonly   - the tile loads kept, every loaded element added into an exact
              checksum, no products;
  noop      - the tile loads kept, each 16-byte piece folded once into the
              checksum, nothing else.
Then the split of full's time: the K rebuild (full - nologits), the value
path (full - novalue), the loads plus grid (dmaonly, noop), beside the
production palu_decode_fp call. Every mode is held against its plain
version on the same inputs; full also against palu_decode_fp. Usage:

  python -m palu_tpu_torch.tools.dissect [seq] [block_s] [mode,mode,...]
  python -m palu_tpu_torch.tools.dissect 512 128 --use_cpu

block_s is the plain versions' sequence block (the TPU grid's block); the
kernel walks the production decode's 64-token tiles in its own split.
"""

from __future__ import annotations

import argparse
import math
from typing import List

import torch

from ..ops import build
from ..ops.palu_decode import _rope_tables, _splits
from ..ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_ref
from . import common

__all__ = ["palu_decode_fp_dissect", "dissect_ref", "make_inputs", "parser", "run", "main",
           "MODES", "DECODE_TOL"]

MODES = ("full", "novalue", "nologits", "dmaonly", "noop")
G, HPG, RK, RV, HD = 8, 4, 128, 384, 128
THETA = 10000.0
TILE = 64  # the kernel's tile (kTile)
# the decode kernels' tolerance against their plain versions (share of
# max|plain|): the bf16 class of docs/PARITY.md item 5
DECODE_TOL = 2e-3


def _check(q, b_k, x_k, x_v, kv_len):
    if q.dim() != 3 or b_k.dim() != 4 or x_k.dim() != 4 or x_v.dim() != 4:
        raise ValueError("q must be (B, nh, hd), b_k (G, hpg, rk, hd), the latents (B, G, S, r)")
    b, nh, hd = q.shape
    g, hpg, rk = b_k.shape[:3]
    if g * hpg != nh or b_k.shape[3] != hd or tuple(x_k.shape[:2]) != (b, g) or \
            x_k.shape[3] != rk or tuple(x_v.shape[:3]) != tuple(x_k.shape[:3]) or \
            tuple(kv_len.shape) != (b,):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, b_k {tuple(b_k.shape)}, "
                         f"x_k {tuple(x_k.shape)}, x_v {tuple(x_v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")


def _walked(x: torch.Tensor, kv_len: torch.Tensor) -> list:
    """Per lane, the latents of the tiles the kernel walks: every 64-token
    tile that holds a position below kv_len."""
    s = x.shape[2]
    return [x[i, :, :min(s, -(-int(n) // TILE) * TILE)] for i, n in enumerate(kv_len.tolist())]


def dissect_ref(mode: str, q, b_k, x_k, x_v, kv_len, *, block_s: int = 512,
                theta: float = THETA) -> dict:
    """Plain version of every mode, in f32, over blocks of block_s tokens
    with the online softmax. -> {"out" (B, nh, rv), "stats" (B, nh, 2) =
    (m, l)} for full / novalue / nologits; {"checksum" (1,) int64,
    "sum" the f64 sum of the walked elements} for dmaonly, {"checksum"} for
    noop."""
    _check(q, b_k, x_k, x_v, kv_len)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "noop":
        return {"checksum": common.fold16(*_walked(x_k, kv_len), *_walked(x_v, kv_len))}
    if mode == "dmaonly":
        walked = _walked(x_k, kv_len) + _walked(x_v, kv_len)
        ck = sum((t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF).sum()
                 for t in walked)
        return {"checksum": ck.reshape(1), "sum": sum(t.double().sum() for t in walked)}
    b, nh, hd = q.shape
    g, hpg, rk = b_k.shape[:3]
    s_max, rv, half = x_k.shape[2], x_v.shape[3], hd // 2
    dev = q.device
    cos_t, sin_t = _rope_tables(s_max, hd, theta, None, 1.0, dev)
    qf = q.float().reshape(b, g, hpg, hd)
    bkf = b_k.float()
    m = torch.full((b, g, hpg), -1e30, device=dev)
    l = torch.zeros((b, g, hpg), device=dev)
    acc = torch.zeros((b, g, hpg, rv), device=dev)
    for s0 in range(0, s_max, block_s):
        xk = x_k[:, :, s0:s0 + block_s].float()                       # (B, G, T, rk)
        n = xk.shape[2]
        if mode == "nologits":
            lg = (xk.sum(-1) * 1e-6)[:, :, None, :].expand(b, g, hpg, n)
        else:
            k = torch.einsum("bgtr,ghrd->bghtd", xk, bkf)             # (B, G, hpg, T, hd)
            c, sn = cos_t[s0:s0 + n], sin_t[s0:s0 + n]
            k1, k2 = k[..., :half], k[..., half:]
            r1, r2 = k1 * c - k2 * sn, k2 * c + k1 * sn
            lg = (torch.einsum("bghtd,bghd->bght", r1, qf[..., :half]) +
                  torch.einsum("bghtd,bghd->bght", r2, qf[..., half:])) / math.sqrt(hd)
        pos = torch.arange(s0, s0 + n, device=dev)
        valid = (pos[None, :] < kv_len[:, None])[:, None, None, :]    # (B, 1, 1, T)
        lg = torch.where(valid, lg, torch.tensor(-1e30, device=dev))
        m_new = torch.maximum(m, lg.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(lg - m_new[..., None]), torch.tensor(0.0, device=dev))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bght,bgtr->bghr", p,
                                                    x_v[:, :, s0:s0 + n].float())
        m = m_new
    stats = torch.stack([m, l], -1).reshape(b, nh, 2)
    return {"out": (acc / l[..., None]).reshape(b, nh, rv), "stats": stats}


def palu_decode_fp_dissect(mode: str, q, b_k, x_k, x_v, kv_len, *,
                           theta: float = THETA) -> torch.Tensor:
    """One mode of palu_decode_fp's kernel over seq-major bf16 latents
    x_k (B, G, S, rk), x_v (B, G, S, rv) (rk <= 128, every head's B in
    shared memory), q (B, nh, hd), b_k (G, hpg, rk, hd), kv_len (B,). ->
    full / nologits: (B, nh, rv) f32; novalue: (B, nh, 2) f32 (m, l);
    dmaonly / noop: (1,) int64 checksum. CUDA tensors launch the kernel in
    palu_decode_fp's own split grid; CPU tensors run dissect_ref."""
    if not q.is_cuda:
        ref = dissect_ref(mode, q, b_k, x_k, x_v, kv_len, theta=theta)
        return ref["stats"] if mode == "novalue" else ref.get("out", ref.get("checksum"))
    _check(q, b_k, x_k, x_v, kv_len)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, nh, hd = q.shape
    g, hpg, rk = b_k.shape[:3]
    s_max, rv = x_k.shape[2], x_v.shape[3]
    if any(t.dtype != torch.bfloat16 for t in (b_k, x_k, x_v)) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("b_k and the latents must be bf16, q bf16 or f32")
    if hd not in (64, 128) or rk % 16 or rk > 128 or rv % 8 or s_max % 8 or hpg > 32:
        raise ValueError(f"the dissection needs hd 64 or 128, rk a multiple of 16 up to 128, "
                         f"rv and S multiples of 8 and <= 32 heads per group (hd={hd}, "
                         f"rk={rk}, rv={rv}, S={s_max}, hpg={hpg})")
    if not (x_k.is_contiguous() and x_v.is_contiguous()):
        raise ValueError("cache buffers must be contiguous")
    dev = q.device
    cos_t, sin_t = _rope_tables(s_max, hd, theta, None, 1.0, dev)
    splits, per = _splits(dev, b * g, s_max)
    # palu_decode_fp's scratch layout (per-split m, l, accumulators, out),
    # then the statistics and the checksums
    n_part = b * nh * splits
    n_f = n_part * (2 + rv) + b * nh * rv
    scratch = torch.empty(n_f + b * nh * 2, dtype=torch.float32, device=dev)
    out = scratch[n_part * (2 + rv):n_f].view(b, nh, rv)
    stats = scratch[n_f:].view(b, nh, 2)
    cks = torch.empty(b * g * splits + 1, dtype=torch.int64, device=dev)
    qc, kvl = q.contiguous(), kv_len.to(torch.int32).contiguous()
    err = build.launcher("palu_decode_fp", "palu_decode_fp_dissect", "ipip" + "p" * 12 +
                         "i" * 9 + "fp")(
        MODES.index(mode), qc.data_ptr(), int(q.dtype == torch.bfloat16),
        b_k.contiguous().data_ptr(), x_k.data_ptr(), x_v.data_ptr(), kvl.data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), scratch.data_ptr(), scratch[n_part:].data_ptr(),
        scratch[2 * n_part:].data_ptr(), cks.data_ptr(), out.data_ptr(), stats.data_ptr(),
        cks[b * g * splits:].data_ptr(), b, g, hpg, hd, rk, rv, s_max, splits, per,
        float(math.sqrt(hd)), build.stream_ptr(dev))
    build.check(err, f"palu_decode_fp_dissect ({mode})")
    palu_decode_fp_dissect.launches += 1
    if mode in ("full", "nologits"):
        return out
    return stats if mode == "novalue" else cks[b * g * splits:]


palu_decode_fp_dissect.launches = 0


def make_inputs(seq: int, dev: torch.device, gen: torch.Generator) -> dict:
    """The tool's operands at batch 1 from one generator: q0 (1, 32, 128),
    b_k (8, 4, 128, 128) * 0.1, x_k (1, 8, S, 128), x_v (1, 8, S, 384), all
    bf16 normal, kv_len = S."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return {"q": normal((1, G * HPG, HD)), "b_k": normal((G, HPG, RK, HD)) * 0.1,
            "x_k": normal((1, G, seq, RK)), "x_v": normal((1, G, seq, RV)),
            "kv_len": torch.full((1,), seq, dtype=torch.int32, device=dev)}


def _held(mode: str, got, ref: dict) -> dict:
    if mode in ("dmaonly", "noop"):
        return common.held(got, ref["checksum"], None)
    if mode == "novalue":  # m and l apart: their scales differ
        hm = common.held(got[..., 0], ref["stats"][..., 0], DECODE_TOL)
        hl = common.held(got[..., 1], ref["stats"][..., 1], DECODE_TOL)
        return {"ok": hm["ok"] and hl["ok"], "m": hm, "l": hl,
                "max_abs_err": max(hm["max_abs_err"], hl["max_abs_err"])}
    return common.held(got, ref["out"], DECODE_TOL)


def _work(mode: str, x: dict) -> tuple:
    """(bytes, bf16 flops) that the mode's function needs."""
    q, b_k, xk, xv = x["q"], x["b_k"], x["x_k"], x["x_v"]
    b, nh, hd = q.shape
    s, rk, rv = xk.shape[2], xk.shape[3], xv.shape[3]
    nbytes = sum(t.numel() * t.element_size() for t in (xk, xv))
    flops = {"full": 2 * b * nh * s * (rk * hd + hd + rv),
             "novalue": 2 * b * nh * s * (rk * hd + hd),
             "nologits": b * xk.shape[1] * s * rk + 2 * b * nh * s * rv}.get(mode, 0)
    if mode in ("full", "novalue"):
        nbytes += (q.numel() + b_k.numel()) * 2
    out = {"full": b * nh * rv * 4, "nologits": b * nh * rv * 4, "novalue": b * nh * 8}
    return nbytes + out.get(mode, 8), flops


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("seq", nargs="?", type=int, default=65536)
    p.add_argument("block_s", nargs="?", type=int, default=1024)
    p.add_argument("modes", nargs="?", default=",".join(MODES))
    p.add_argument("--nch", type=int, default=common.env_int("NCH", 32),
                   help="timed calls per mode")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per mode")
    return p


def run(args) -> List[dict]:
    """Every mode once, held against its plain version, then timed; full
    also against palu_decode_fp (bitwise) and palu_decode_fp_ref. Then the
    production call and the split. Returns the records."""
    dev = common.device_of(args.use_cpu)
    modes = args.modes.split(",")
    x = make_inputs(args.seq, dev, common.generator(dev))
    ops = (x["q"], x["b_k"], x["x_k"], x["x_v"], x["kv_len"])
    recs, us = [], {}
    sdpa = None
    for mode in modes:
        n0 = palu_decode_fp_dissect.launches
        got = palu_decode_fp_dissect(mode, *ops)
        ref = dissect_ref(mode, *ops, block_s=args.block_s)
        nbytes, flops = _work(mode, x)
        rec = {"probe": "dissect", "variant": mode, "bytes": nbytes, "flops": flops,
               "held": _held(mode, got, ref)}
        if mode == "full":
            prod = palu_decode_fp(*ops)
            rec["bitwise_equal_palu_decode_fp"] = bool(torch.equal(got, prod))
            rec["vs_palu_decode_fp_ref"] = common.held(got, palu_decode_fp_ref(*ops), DECODE_TOL)
            rec["held"]["ok"] = (rec["held"]["ok"] and rec["vs_palu_decode_fp_ref"]["ok"] and
                                 (dev.type == "cpu" or rec["bitwise_equal_palu_decode_fp"]))
        if mode in ("dmaonly", "noop"):
            rec["checksum"] = int(got[0])
        rec.update(common.time_call(lambda: palu_decode_fp_dissect(mode, *ops), dev, args.nch))
        rec["launches"] = palu_decode_fp_dissect.launches - n0
        if dev.type == "cuda":
            rec["plain_us"] = common.device_us(
                lambda: dissect_ref(mode, *ops, block_s=args.block_s), 2)
            if mode in ("dmaonly", "noop"):
                rec["library"] = "torch.sum over x_k and x_v"
                rec["library_us"] = common.device_us(
                    lambda: [torch.sum(t, dtype=torch.float32) for t in ops[2:4]], args.nch)
            else:
                if sdpa is None:
                    sdpa = _dense_sdpa(x, dev)
                rec["library"] = ("scaled_dot_product_attention over dense bf16 K/V of the "
                                  "same context (the attention Palu replaces)")
                rec["library_us"] = common.device_us(sdpa, args.nch)
            rec["bound_us"], rec["bound_by"] = common.bound_us(nbytes, flops)
            us[mode] = rec["us"]
        recs.append(rec)
    if dev.type == "cuda":
        prod = {"probe": "dissect", "variant": "palu_decode_fp",
                "us": common.device_us(lambda: palu_decode_fp(*ops), args.nch)}
        prod["bound_us"], prod["bound_by"] = common.bound_us(*_work("full", x))
        recs.append(prod)
        split = {"probe": "dissect", "variant": "split", "seq": args.seq}
        if {"full", "nologits"} <= us.keys():
            split["k_rebuild_us"] = us["full"] - us["nologits"]
        if {"full", "novalue"} <= us.keys():
            split["value_path_us"] = us["full"] - us["novalue"]
        for mode in ("dmaonly", "noop"):
            if mode in us:
                split[f"{mode}_us"] = us[mode]
        recs.append(split)
    return recs


def _dense_sdpa(x: dict, dev: torch.device):
    """One scaled_dot_product_attention call for the decode token over dense
    bf16 K/V of the same context (32 heads, hd 128): the yardstick."""
    gen = common.generator(dev, 1)
    b, nh, hd = x["q"].shape
    s = x["x_k"].shape[2]
    q = torch.randn((b, nh, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, nh, s, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, nh, s, hd), generator=gen, device=dev).to(torch.bfloat16)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        nbytes = G * args.seq * (RK + RV) * 2
        print(f"device: {dev} seq={args.seq} block_s={args.block_s} read={nbytes / 1e6:.0f}MB "
              f"bound={nbytes / common.PEAK_BYTES_PER_S * 1e6:.1f}us", flush=True)
    recs = run(args)
    for rec in recs:
        if rec["variant"] == "split":
            if not args.json:
                print("split: " + ", ".join(f"{k} {v:.2f}" for k, v in rec.items()
                                            if k.endswith("_us")), flush=True)
            else:
                common.emit(rec, True)
        else:
            common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs if "held" in r):
        raise SystemExit("dissect: a mode disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
