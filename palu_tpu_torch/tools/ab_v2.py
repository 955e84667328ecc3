"""A/B of the decode generations on the card at the headline point (port of
tools/tpu_ab_v2.py): 32 heads in 8 groups of 4, hd 128, group ranks rk 128
/ rv 384, batch 1, a 64K context, over bf16 latents and packed caches.

Variants (the JAX tool's names; a trailing number is the code width):
  v1     - palu_decode_fp: seq-major bf16 latents, table RoPE;
  v1q<b> - palu_decode_seq_quantized: the seq-major packed cache;
  v2     - palu_decode2: K seq-major, V rank-major, cos/sin in the kernel;
  v2q<b> - palu_decode2_quantized: the rank-major packed cache, affine
           scales and zeros (B, G, S), cos/sin in the kernel;
  v3q<b> - palu_decode3_quantized: the same cache with scales and zeros
           packed (B, S, 2G) and block-relative RoPE tables (on the exact
           kernel, which forms each tile's rotation from them);
  v4a<b> - palu_decode, asym; v4q<b> - palu_decode, sym (exact K path);
  v4g<b> - palu_decode over per-chunk scales (GSZ ranks per scale, 128);
  v4     - palu_decode_fp_t: rank-major bf16 latents;
  v4s<b>, v4q<b>r - the TPU's seg_sum and bf16-rotation layouts, which the
           port does not carry: the v4q<b> kernel runs, and the record says
           so ("same_as");
  xla    - the PyTorch composite flash_decode_latent over the bf16 latents
           in chunks of BS (no kernel), timed as a yardstick.
Each kernel variant is held against its plain version within 2e-3 of
max|plain| and timed on the card (device time, L2 cold), beside its bound
(bytes of the cache it walks over the memory rate, or the K rebuild's
2 nh rk hd flops per token over the bf16 tensor-core rate) and the
yardstick, scaled_dot_product_attention over dense bf16 K/V of the same
context (timed once). The plain versions, and the composite, launch about
a thousand small kernels a call, and profiling one takes seconds: each
kernel's plain version is timed once, at the first variant that runs it,
and the composite over 2 calls. KVL below SEQ leaves the blocks past it
unwalked. Usage:

  python -m palu_tpu_torch.tools.ab_v2 [variant ...] [--seq S] [--kvl N] [--bs BS]
  python -m palu_tpu_torch.tools.ab_v2 --use_cpu --seq 512 --bs 128 v1 v2 v2q3 v3q3
"""

from __future__ import annotations

import argparse
import time
from typing import List

import torch

from ..core.quant import (QuantConfig, pack_codes, pack_codes_t, quantize,
                          quantize_affine)
from ..ops.archive.palu_decode2 import (palu_decode2, palu_decode2_quantized,
                                        palu_decode2_quantized_ref, palu_decode2_ref)
from ..ops.archive.palu_decode3 import (palu_decode3_quantized, palu_decode3_quantized_ref,
                                        sz_pack)
from ..ops.attention import flash_decode_latent
from ..ops.palu_decode import palu_decode, palu_decode_ref
from ..ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref, palu_decode_fp_t,
                                  palu_decode_fp_t_ref)
from ..ops.palu_decode_seq import palu_decode_seq_quantized, palu_decode_seq_quantized_ref
from . import common

__all__ = ["make_inputs", "variant", "parser", "run", "main", "DEFAULT_VARIANTS",
           "ALL_VARIANTS", "DECODE_TOL"]

G, HPG, RK, RV, HD = 8, 4, 128, 384, 128
NH = G * HPG
THETA = 10000.0
TILE = 64  # the decode kernels' tile of tokens
DEFAULT_VARIANTS = ["v1", "v2", "v2q3", "v2q4"]
# every kind the JAX tool's make_fn knows, at the widths the A/B compares;
# the 3-bit variant of each kernel first (its plain version is the one timed)
ALL_VARIANTS = ["v1", "v2", "v1q3", "v2q3", "v2q2", "v2q4", "v3q3", "v3q2", "v3q4", "v4a3",
                "v4s3", "v4g3", "v4q3", "v4q3r", "v4", "xla"]
# the decode kernels' tolerance against their plain versions (share of
# max|plain|): the bf16 class of docs/PARITY.md item 5
DECODE_TOL = 2e-3


def make_inputs(seq: int, kvl: int, dev: torch.device, gen: torch.Generator) -> dict:
    """The tool's operands at batch 1: q0 (1, 32, 128), b_k (8, 4, 128, 128)
    * 0.1, x_k (1, 8, S, 128), x_v (1, 8, S, 384), all bf16 normal;
    kv_len (1,) = KVL."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return {"q": normal((1, NH, HD)), "b_k": normal((G, HPG, RK, HD)) * 0.1,
            "x_k": normal((1, G, seq, RK)), "x_v": normal((1, G, seq, RV)),
            "kv_len": torch.full((1,), kvl, dtype=torch.int32, device=dev)}


def _affine(x: torch.Tensor, qcfg: QuantConfig) -> tuple:
    """quantize_affine + pack_codes_t: (codes, scale, zero) with per-row
    (B, G, S) or per-chunk (B, G, n_chunks, S) scale rows."""
    c, s, z = quantize_affine(x, qcfg)
    rows = (lambda t: t.transpose(-1, -2)) if qcfg.group_size else (lambda t: t[..., 0])
    return (pack_codes_t(c, qcfg.pack_bits).contiguous(), rows(s).contiguous(),
            rows(z).contiguous())


def _split(name: str) -> tuple:
    """(kind, bits, suffix) of a variant name: "v4q3r" -> ("v4q", 3, "r")."""
    for kind in ("v1q", "v2q", "v3q", "v4a", "v4s", "v4g", "v4q"):
        if name.startswith(kind):
            rest = name[len(kind):]
            suffix = "r" if kind == "v4q" and rest.endswith("r") else ""
            digits = rest[:len(rest) - len(suffix)]
            if digits.isdigit():
                return kind, int(digits), suffix
    if name in ("v1", "v2", "v4", "xla"):
        return name, None, ""
    raise SystemExit(f"unknown variant {name}")


def variant(name: str, x: dict, block_s: int, gsz: int = 128) -> dict:
    """{"fn": the kernel call, "ref": its plain version (None for xla),
    "counter": the wrapper whose launches it adds to, "cache": the cache
    tensors it reads, "same_as": the variant whose kernel runs, if another}."""
    q, b_k, x_k, x_v, kvl = x["q"], x["b_k"], x["x_k"], x["x_v"], x["kv_len"]
    kind, bits, suffix = _split(name)
    out = {"same_as": None}
    if kind == "v1":
        ops = (q, b_k, x_k, x_v, kvl)
        out.update(fn=lambda: palu_decode_fp(*ops), ref=lambda: palu_decode_fp_ref(*ops),
                   counter=palu_decode_fp, cache=(x_k, x_v))
    elif kind == "v2":
        x_v_t = x_v.transpose(2, 3).contiguous()
        ops = (q, b_k, x_k, x_v_t, kvl)
        out.update(fn=lambda: palu_decode2(*ops, block_s=block_s),
                   ref=lambda: palu_decode2_ref(*ops, block_s=block_s), counter=palu_decode2,
                   cache=(x_k, x_v_t))
    elif kind == "v4":
        xt = [t.transpose(2, 3).contiguous() for t in (x_k, x_v)]
        ops = (q, b_k, *xt, kvl)
        out.update(fn=lambda: palu_decode_fp_t(*ops), ref=lambda: palu_decode_fp_t_ref(*ops),
                   counter=palu_decode_fp_t, cache=tuple(xt))
    elif kind == "xla":
        def composite():
            def reader(t):
                return lambda i: t[:, :, i * block_s:(i + 1) * block_s]
            return flash_decode_latent(q, reader(x_k), reader(x_v), b_k,
                                       x_k.shape[2] // block_s, block_s, kvl, HD, THETA, RV)
        out.update(fn=composite, ref=None, counter=None, cache=(x_k, x_v))
    elif kind == "v1q":
        qcfg = QuantConfig(bits=bits, group_size=0)
        bufs = []
        for lat in (x_k, x_v):
            c, s, b = quantize(lat, qcfg)
            bufs += [pack_codes(c, qcfg.pack_bits).contiguous(), s.contiguous(), b.contiguous()]
        kw = dict(qcfg=qcfg, rk=RK, rv=RV)
        out.update(fn=lambda: palu_decode_seq_quantized(q, b_k, *bufs, kvl, **kw),
                   ref=lambda: palu_decode_seq_quantized_ref(q, b_k, *bufs, kvl, **kw),
                   counter=palu_decode_seq_quantized, cache=tuple(bufs))
    elif kind in ("v2q", "v3q"):
        qcfg = QuantConfig(bits=bits, group_size=0)
        (kc, ks, kz), (vc, vs, vz) = _affine(x_k, qcfg), _affine(x_v, qcfg)
        kw = dict(qcfg=qcfg, rk=RK, rv=RV, block_s=block_s)
        if kind == "v2q":
            bufs = (kc, ks, kz, vc, vs, vz)
            fn, ref = palu_decode2_quantized, palu_decode2_quantized_ref
        else:
            bufs = (kc, sz_pack(ks, kz), vc, sz_pack(vs, vz))
            fn, ref = palu_decode3_quantized, palu_decode3_quantized_ref
        out.update(fn=lambda: fn(q, b_k, *bufs, kvl, **kw),
                   ref=lambda: ref(q, b_k, *bufs, kvl, **kw), counter=fn, cache=bufs)
    else:  # v4a / v4s / v4g / v4q: palu_decode
        qcfg = QuantConfig(bits=bits, group_size=gsz if kind == "v4g" else 0,
                           sym=kind != "v4a")
        (kc, ks, kz), (vc, vs, vz) = _affine(x_k, qcfg), _affine(x_v, qcfg)
        kw = dict(qcfg=qcfg, rk=RK, rv=RV)
        if kind == "v4a":
            kw.update(xk_zero=kz, xv_zero=vz)
        bufs = (kc, ks, vc, vs) + ((kz, vz) if kind == "v4a" else ())
        if kind == "v4s" or suffix:
            out["same_as"] = f"v4q{bits}"
        out.update(fn=lambda: palu_decode(q, b_k, kc, ks, vc, vs, kvl, **kw),
                   ref=lambda: palu_decode_ref(q, b_k, kc, ks, vc, vs, kvl, **kw),
                   counter=palu_decode, cache=bufs)
    return out


def _work(x: dict, cache: tuple) -> tuple:
    """(bytes, bf16 flops) of one decode: the cache bytes of the tiles
    walked below kv_len (plus q, b_k and the output), and 2 nh (rk hd + hd
    + rv) flops per walked token (the K rebuild, the q dot, the value sum)."""
    s = x["x_k"].shape[2]
    walked = min(s, -(-int(x["kv_len"].max()) // TILE) * TILE)
    nbytes = sum(t.numel() * t.element_size() for t in cache) * walked / s
    nbytes += (x["q"].numel() + x["b_k"].numel()) * 2 + NH * RV * 4
    return nbytes, 2 * NH * walked * (RK * HD + HD + RV)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", default=DEFAULT_VARIANTS)
    p.add_argument("--seq", type=int, default=common.env_int("SEQ", 65536),
                   help="cache positions S")
    p.add_argument("--kvl", type=int, default=None,
                   help="live context (default KVL, else S): blocks past it do no work")
    p.add_argument("--bs", type=int, default=common.env_int("BS", 1024),
                   help="sequence block of the plain versions and v3's rotation block")
    p.add_argument("--gsz", type=int, default=common.env_int("GSZ", 128),
                   help="ranks per scale of v4g")
    p.add_argument("--nch", type=int, default=common.env_int("CHAIN", 32),
                   help="timed calls per variant")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per variant")
    return p


def run(args) -> List[dict]:
    """Every variant once, held against its plain version, then timed with
    L2 cold beside its bound and the SDPA yardstick. Returns the records."""
    dev = common.device_of(args.use_cpu)
    kvl = args.kvl if args.kvl is not None else common.env_int("KVL", args.seq)
    for name in args.variants:
        _split(name)
    x = make_inputs(args.seq, kvl, dev, common.generator(dev))
    recs, sdpa_us, plain_timed = [], None, set()
    for name in args.variants:
        t0 = time.perf_counter()
        v = variant(name, x, args.bs, args.gsz)
        counter = v["counter"]
        n0 = counter.launches if counter else 0
        nbytes, flops = _work(x, v["cache"])
        rec = {"probe": "ab_v2", "variant": name, "seq": args.seq, "kvl": kvl,
               "bytes": nbytes, "flops": flops}
        if v["same_as"]:
            rec["same_as"] = v["same_as"]
        if v["ref"] is not None:
            rec["held"] = common.held(v["fn"](), v["ref"](), DECODE_TOL)
        rec.update(common.time_call(v["fn"], dev, args.nch if counter else 2))
        if counter:
            rec["kernel"], rec["launches"] = counter.__name__, counter.launches - n0
        if dev.type == "cuda":
            rec["bound_us"], rec["bound_by"] = common.bound_us(nbytes, flops)
            if v["ref"] is not None and counter.__name__ not in plain_timed:
                plain_timed.add(counter.__name__)
                rec["plain_us"] = common.device_us(v["ref"], 1)
            if sdpa_us is None:  # one function for every variant: timed once
                sdpa_us = common.device_us(common.dense_sdpa(x["q"].shape, kvl, dev), args.nch)
            rec["library"], rec["library_us"] = common.SDPA_YARDSTICK, sdpa_us
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
        del v
    return recs


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        nbytes = G * args.seq * (RK + RV) * 2
        print(f"device: {dev} seq={args.seq} block_s={args.bs} timed calls={args.nch} "
              f"bf16 bound={nbytes / common.PEAK_BYTES_PER_S * 1e6:.0f}us", flush=True)
    recs = run(args)
    for rec in recs:
        common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs if "held" in r):
        raise SystemExit("ab_v2: a kernel disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
