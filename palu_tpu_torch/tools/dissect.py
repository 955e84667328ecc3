"""Dissect a latent decode's time on the card (port of
tools/tpu_dissect.py): the kernel palu_decode_fp launches over seq-major
bf16 latents (csrc/palu_decode_fp_wg.cu), run in five modes.

Modes (the JAX tool's names):
  full      - that kernel whole, through palu_decode_fp's own launcher
              (its plan and splits): bit-identical to palu_decode_fp;
  novalue   - the V products dropped (the V chunks still stream); emits
              each head's softmax statistics (m, l);
  nologits  - no B streamed, no K product and no rotation: fake logits, 1e-6
              times each token's x_k summed over ranks (the block's own
              group; the TPU block held every group and summed group 0's),
              feed the softmax and the V products;
  dmaonly   - the TMA ring of cache chunks kept, every staged element's
              16-bit pattern added into an exact checksum, no products;
  noop      - the same ring, each 16-byte piece folded once (the XOR of its
              four words) into the checksum, nothing else.
The modes with no K work (nologits, dmaonly, noop) keep palu_decode_fp's
ring depth and stage no B (`dissect_plan`). The checksums count the cache's
own elements: a box's ranks past r and tokens past S arrive as zeros and
add 0, as the plain version (which never sees them) counts them. Then the
split of full's time: the K rebuild (full - nologits), the value path (full
- novalue), the loads plus grid (dmaonly, noop), beside the production
palu_decode_fp call. Every mode is held against its plain version on the
same inputs; full also bit for bit against palu_decode_fp. Usage:

  python -m palu_tpu_torch.tools.dissect [seq] [block_s] [mode,mode,...]
  python -m palu_tpu_torch.tools.dissect 512 128 --use_cpu

block_s is the plain versions' sequence block (the TPU grid's block); the
kernel walks the production decode's 64-token tiles in its own splits.
"""

from __future__ import annotations

import argparse
import math
from typing import List

import torch

from ..ops import build
from ..ops.palu_decode import _device_splits, _inv_freq_t, _rope_tables
from ..ops.palu_decode_fp import _fp_plan, _launch, palu_decode_fp, palu_decode_fp_ref
from . import common

__all__ = ["palu_decode_fp_dissect", "dissect_ref", "dissect_plan", "dissect_route",
           "make_inputs", "parser", "run", "main", "MODES", "DECODE_TOL"]

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


def dissect_plan(mode: str, hd: int, rk: int, rv: int, hpg: int) -> dict:
    """The shared-memory plan a mode launches with, one B per q-head
    (csrc/palu_decode_fp_wg.cu::dissect_plan, the same function): full and
    novalue take palu_decode_fp's (ops/palu_decode_fp._fp_plan); the modes
    with no K work its ring depth and no B slot. Raises ValueError where the
    kernel cannot run: no plan fits, or (the cut modes, instantiated at the
    tool's shape) a head dim other than 128 or more than one 8-head tile a
    consumer (over 16 heads a group)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode != "full" and hd != 128:
        raise ValueError(f"the dissection's cut modes take hd 128 (the tool's), got {hd}")
    plan = _fp_plan(hd, rk, rv, hpg, hpg)
    if plan is None:
        raise ValueError(f"the decode kernel's tile ring and B do not fit in a block's shared "
                         f"memory at hd {hd}, rk {rk}, rv {rv}, {hpg} heads per group")
    if mode != "full" and plan["nt"] != 1:
        raise ValueError(f"the dissection's cut modes take at most 16 heads a group, got {hpg}")
    if mode in ("nologits", "dmaonly", "noop"):
        plan = _fp_plan(hd, rk, rv, hpg, hpg, ring=plan["ns"])
    return plan


def dissect_route(mode: str) -> tuple:
    """(source, C entry point) a mode launches: full palu_decode_fp's own
    kernel, the others its body's dissection instantiations."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return ("palu_decode_fp_wg", "palu_decode_fp_wg" if mode == "full" else
            "palu_decode_fp_dissect")


def palu_decode_fp_dissect(mode: str, q, b_k, x_k, x_v, kv_len, *,
                           theta: float = THETA) -> torch.Tensor:
    """One mode of the decode kernel over seq-major bf16 latents x_k (B, G,
    S, rk), x_v (B, G, S, rv), q (B, nh, hd), b_k (G, hpg, rk, hd), kv_len
    (B,). -> full / nologits: (B, nh, rv) f32; novalue: (B, nh, 2) f32 (m,
    l); dmaonly / noop: (1,) int64 checksum. CUDA tensors launch the kernel
    at palu_decode_fp's splits (full: palu_decode_fp's launch itself; the
    others: palu_decode_fp's shapes at hd 128 with at most 16 heads a
    group, dissect_plan); CPU tensors run dissect_ref."""
    if not q.is_cuda:
        ref = dissect_ref(mode, q, b_k, x_k, x_v, kv_len, theta=theta)
        return ref["stats"] if mode == "novalue" else ref.get("out", ref.get("checksum"))
    _check(q, b_k, x_k, x_v, kv_len)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "full":
        out = _launch(q, b_k, x_k, x_v, kv_len, False, theta, None, None, 1.0, None)
        palu_decode_fp_dissect.launches += 1
        return out
    b, nh, hd = q.shape
    g, hpg, rk = b_k.shape[:3]
    s_max, rv = x_k.shape[2], x_v.shape[3]
    if any(t.dtype != torch.bfloat16 for t in (b_k, x_k, x_v)) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("b_k and the latents must be bf16, q bf16 or f32")
    if rk % 16 or rk > 512 or rv % 8 or rv > 512 or s_max % 8:
        raise ValueError(f"the dissection needs rk a multiple of 16 and rv of 8, both up to "
                         f"512, and S a multiple of 8 (rk={rk}, rv={rv}, S={s_max})")
    dissect_plan(mode, hd, rk, rv, hpg)
    if not (x_k.is_contiguous() and x_v.is_contiguous()) or \
            any(t.data_ptr() % 16 for t in (x_k, x_v, b_k)):
        raise ValueError("cache buffers must be contiguous and 16-byte aligned")
    dev = q.device
    inv = _inv_freq_t(hd, float(theta), None, str(dev))
    splits, grid = _device_splits(dev, b * g, s_max)
    # the decodes' scratch layout (per-split m, l, accumulators, out), then
    # the statistics and the checksum
    n_part = b * nh * splits
    n_f = n_part * (2 + rv) + b * nh * rv
    scratch = torch.empty(n_f + b * nh * 2, dtype=torch.float32, device=dev)
    out = scratch[n_part * (2 + rv):n_f].view(b, nh, rv)
    stats = scratch[n_f:].view(b, nh, 2)
    ck = torch.empty(1, dtype=torch.int64, device=dev)
    qc, kvl = q.contiguous(), kv_len.to(torch.int32).contiguous()
    err = build.launcher("palu_decode_fp_wg", "palu_decode_fp_dissect", "ipip" + "p" * 10 +
                         "i" * 9 + "fp")(
        MODES.index(mode), qc.data_ptr(), int(q.dtype == torch.bfloat16),
        b_k.contiguous().data_ptr(), x_k.data_ptr(), x_v.data_ptr(), kvl.data_ptr(),
        inv.data_ptr(), scratch.data_ptr(), scratch[n_part:].data_ptr(),
        scratch[2 * n_part:].data_ptr(), out.data_ptr(), stats.data_ptr(), ck.data_ptr(),
        b, g, hpg, hd, rk, rv, s_max, splits, grid, float(1.0 / math.sqrt(hd)),
        build.stream_ptr(dev))
    build.check(err, f"palu_decode_fp_dissect ({mode})")
    palu_decode_fp_dissect.launches += 1
    if mode == "nologits":
        return out
    return stats if mode == "novalue" else ck


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
    also against palu_decode_fp_ref. Then the production call and the
    split. Returns the records."""
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
            rec["vs_palu_decode_fp_ref"] = common.held(got, palu_decode_fp_ref(*ops), DECODE_TOL)
            checks = ["held", "vs_palu_decode_fp_ref"]
            if dev.type == "cuda":  # the production kernel: bit for bit
                rec["vs_palu_decode_fp"] = common.held(got, palu_decode_fp(*ops), None)
                checks.append("vs_palu_decode_fp")
            rec["held"]["ok"] = all(rec[k]["ok"] for k in checks)
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
                    sdpa = common.dense_sdpa(x["q"].shape, x["x_k"].shape[2], dev)
                rec["library"] = common.SDPA_YARDSTICK
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
