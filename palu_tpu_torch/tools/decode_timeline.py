"""Where a tile's time goes in the bf16 latent decode kernel
(csrc/palu_decode_fp_wg.cu) or in the packed decode's int8 modes
(csrc/palu_decode_i8.cu, --kernel i8), on the card.

It copies the kernel's sources into a temporary directory and builds two
patched variants with nvcc beside the unpatched library:
  timeline   - clock64 stamps at the phase boundaries of each tile, taken by
               thread 0 of each consumer warpgroup of block 0 and read back
               by an added C function: the median cycles of each phase over
               the block's tiles;
  loads_only - the consumers wait for and release every chunk but compute
               nothing: the time the TMA ring alone takes to stream the cache.
Then it times the unpatched kernel and the loads-only variant (device ms, L2
cold) and prints one JSON line per case. With --kernel i8 it stamps the int8
kernel's three roles in block 0 instead (no loads-only variant): per visit
the K warpgroup (operand and tile waits, the A tile, the first head's
products and the wait for the rotation rows, the heads' products and
epilogues, the softmax) and the V warpgroup (the correction and bias, the
rotation rows, the waits for P^T, the value product), per operand build the builder warps. Usage,
on a machine with the card:

  python3 -m palu_tpu_torch.tools.decode_timeline [--seq 65536] [--lanes 1]
      [--kv_len N] [--layout seq|rank] [--kernel fp|i8]
      [--mode int8_dots|int8_rot] [--block_s 512]

Llama-2-7B group shapes (8 groups of 4 heads, rk 128, rv 384, hd 128); the
int8 kernel over the 3-bit cache in nibble containers (sym).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..ops import build
from ..ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_t
from . import common

G, HPG, RK, RV, HD = 8, 4, 128, 384, 128
MAX_TILES = 100  # tiles of block 0 recorded per consumer
STAMPS = 12      # stamps per tile
# (first stamp, last stamp) of each phase of a tile
PHASES = {"rotation+k_wait": (0, 2), "kv_head0_products": (2, 3), "epilogue0": (3, 4),
          "kv_head1_products": (4, 5), "epilogue1+release": (5, 6), "softmax": (6, 7),
          "v_products": (7, 8)}

# (anchor in the kernel source, text put before it or after it): each
# anchor must occur exactly once
_PRELUDE = f"""__device__ long long g_tl[{2 * MAX_TILES * STAMPS}];
extern "C" int tl_read(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl)); }}
extern "C" int tl_clear() {{
  static long long z[{2 * MAX_TILES * STAMPS}];
  return (int)cudaMemcpyToSymbol(g_tl, z, sizeof(z));
}}
#define TL(e) do {{ if (blockIdx.x == 0 && wt == 0 && tile - w.t0 < {MAX_TILES}) \\
  g_tl[(c * {MAX_TILES} + tile - w.t0) * {STAMPS} + (e)] = clock64(); }} while (0)
"""
_STAMPS = [
    ("namespace {\n\nusing namespace hopper;", "before", _PRELUDE),
    ("      float rcs[HD / 16][2][2], rsn[HD / 16][2][2];", "before", "      TL(0);\n"),
    ("      for (int j = j0; j < j1; ++j) {\n        float kv[NACC];", "before", "      TL(2);\n"),
    ("          if (!L.resident) mbar_arrive(my_bempty + 8 * slot);", "before",
     "          if (bc == L.nck - 1) TL(3 + 2 * (j - j0));\n"),
    ("                     min(h1, (j + 1) * a.rep) - h0, ta, qd);", "after",
     "\n        TL(4 + 2 * (j - j0));"),
    ("      named_sync(sync_id, kWG);  // every head's logits", "before", "      TL(6);\n"),
    ("      fence_async_shared();      // P^T is read by wgmma", "before", "      TL(7);\n"),
    ("      v_product(it + L.nck);", "after", "\n      TL(8);"),
]
# loads only: the consumers skip the rotation, the products, the epilogues
# and the softmax, and still wait for and release every chunk
_LOADS_ONLY = [
    ("      rotation<HD>(rcs, rsn,", "before", "      if (0)\n"),
    ("      for (int j = j0; j < j1; ++j) {\n        float kv[NACC];", "before",
     "      if (0)\n"),
    ("      for (int hb = 0; hb < nhw; hb += 4) {", "before", "      if (0)\n"),
    ("wgmma_v<RMV ? 0 : 1>(vacc[mt],", "before", "if (0) "),
]


# the int8 kernel: stamps of role r (0 K, 1 V, 2 builder) at entry i (a visit,
# or a build) of block 0
_I8_PRELUDE = f"""__device__ long long g_tl[{3 * MAX_TILES * STAMPS}];
extern "C" int tl_read(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl)); }}
extern "C" int tl_clear() {{
  static long long z[{3 * MAX_TILES * STAMPS}];
  return (int)cudaMemcpyToSymbol(g_tl, z, sizeof(z));
}}
#define TLI(r, i, e, who) do {{ if (blockIdx.x == 0 && (who) == 0 && (i) >= 0 && \\
  (i) < {MAX_TILES}) g_tl[((r) * {MAX_TILES} + (i)) * {STAMPS} + (e)] = clock64(); }} while (0)
"""
I8_PHASES = {"k": {"operand+tile_wait": (0, 1), "a_tile": (1, 2),
                   "head0_products+rows_wait": (2, 3), "heads": (3, 4), "softmax": (4, 5)},
             "v": {"rows+correction": (0, 3), "rows_wait+store": (3, 1),
                   "product_waits": (1, 4), "value_product": (4, 2)},
             "builder": {"scales": (0, 4), "slot_wait": (4, 2), "rows+arrive": (2, 1)}}
_I8_STAMPS = [
    ("namespace {\n\nusing namespace hopper;", "before", _I8_PRELUDE),
    ("        if (v.newb) {  // the last operand's products are done", "before",
     "        TLI(0, vi, 0, wt);\n"),
    ("        const uint8_t* stage = sm + st * L.stage_bytes;\n        const uint8_t* kbytes",
     "before", "        TLI(0, vi, 1, wt);\n"),
    ("        const uint32_t at = base + L.atile;", "before", "        TLI(0, vi, 2, wt);\n"),
    ("          if (hc == 0) mbar_wait(rope_full, it & 1);  // this visit's rows", "after",
     "\n          if (hc == 0) TLI(0, vi, 3, wt);"),
    ("        mbar_arrive(rope_empty);  // the rotation", "before", "        TLI(0, vi, 4, wt);\n"),
    ("        mbar_arrive(empty + 8 * st);  // the stage is read (the V scales above)", "before",
     "        TLI(0, vi, 5, wt);\n"),
    ("          const float* rc = a.rcos + static_cast<size_t>(row0) * HALF;", "before",
     "          TLI(1, vi, 0, wt);\n"),
    ("          if (it > 0) mbar_wait(rope_empty, (it - 1) & 1);  // the K side", "before",
     "          TLI(1, vi, 3, wt);\n"),
    ("          mbar_arrive(rope_full);\n          ++it;", "before", "          TLI(1, vi, 1, wt);\n"),
    ("        const uint8_t* stage = sm + st * L.stage_bytes;\n        packed::v_tile", "before",
     "        TLI(1, vi - 1, 4, wt);\n"),
    ("        if (vi < nv) mbar_arrive(p_empty);", "after", "\n        TLI(1, vi - 1, 2, wt);"),
    ("          build_scales<HD, MODE>(a, &tm_b, st,", "before", "          TLI(2, ob, 0, bt);\n"),
    ("          mbar_wait(oempty + 8 * s, ((ob / L.nob) & 1) ^ 1);", "before",
     "          TLI(2, ob, 4, bt);\n"),
    ("          build_rows<HD, MODE>(a, &tm_b, slot_at(s),", "before", "          TLI(2, ob, 2, bt);\n"),
    ("          mbar_arrive(ofull + 8 * s);", "after", "\n          TLI(2, ob, 1, bt);"),
]


def _patch(src: str, edits) -> str:
    for anchor, where, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"decode_timeline: anchor not found once: {anchor[:50]!r}")
        src = src.replace(anchor, text + anchor if where == "before" else anchor + text)
    return src


def _build(tmp: str, name: str, edits, source: str = "palu_decode_fp_wg") -> ctypes.CDLL:
    src = open(build.CSRC / f"{source}.cu").read()
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(_patch(src, edits))
    out = os.path.join(tmp, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(out)


def run_i8(args) -> list:
    """The int8 kernel's timeline (module docstring)."""
    from ..core.quant import QuantConfig, pack_codes_t, quantize_affine
    from ..ops.palu_decode import palu_decode

    dev = torch.device("cuda")
    gen = common.generator(dev)
    lanes, s_max = args.lanes, args.seq
    kv_len = args.kv_len or s_max
    qcfg = QuantConfig(bits=3, sym=True, container=4)
    q = torch.randn((lanes, G * HPG, HD), generator=gen, device=dev).bfloat16()
    b_k = (torch.randn((G, HPG, RK, HD), generator=gen, device=dev) / RK**0.5).bfloat16()
    bufs = {}
    for side, r in (("k", RK), ("v", RV)):
        c, sc, _ = quantize_affine(torch.randn((lanes, G, s_max, r), generator=gen, device=dev),
                                   qcfg)
        bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = sc[..., 0].contiguous()
    kvl = torch.full((lanes,), kv_len, dtype=torch.int32, device=dev)
    call = lambda: palu_decode(q, b_k, kv_len=kvl, **bufs, qcfg=qcfg, rk=RK, rv=RV,  # noqa: E731
                               block_s=args.block_s, **{args.mode: True})
    orig = build.load("palu_decode_i8")
    tmp = tempfile.mkdtemp(prefix="decode_timeline_")
    try:
        for hdr in build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, tmp)
        tl = _build(tmp, "timeline_i8", _I8_STAMPS, "palu_decode_i8")
        rec = {"tool": "decode_timeline", "kernel": "i8", "mode": args.mode,
               "device": torch.cuda.get_device_name(0), "lanes": lanes, "s_max": s_max,
               "kv_len": kv_len, "block_s": args.block_s, "ms": common.device_us(call, 10) / 1e3}
        build._LIBS["palu_decode_i8"] = tl
        tl.tl_clear()
        call()
        torch.cuda.synchronize()
        buf = np.zeros(3 * MAX_TILES * STAMPS, np.int64)
        tl.tl_read(ctypes.c_void_p(buf.ctypes.data))
        t = buf.reshape(3, MAX_TILES, STAMPS).astype(np.float64)
        for r, role in enumerate(("k", "v", "builder")):
            used = sorted({e for ab in I8_PHASES[role].values() for e in ab})
            d = t[r][(t[r][:, used] > 0).all(axis=1)]
            rec[f"{role}_entries"] = len(d)
            rec[f"{role}_cycles"] = {name: float(np.median(d[:, b] - d[:, a])) if len(d) else None
                                     for name, (a, b) in I8_PHASES[role].items()}
            if role != "builder" and len(d) > 1:
                rec[f"{role}_cycles"]["visit"] = float(np.median(np.diff(d[:, 0])))
    finally:
        build._LIBS["palu_decode_i8"] = orig
        shutil.rmtree(tmp, ignore_errors=True)
    return [rec]


def run(args) -> list:
    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs an NVIDIA GPU with nvcc")
    if args.kernel == "i8":
        return run_i8(args)
    dev = torch.device("cuda")
    gen = common.generator(dev)
    lanes, s_max = args.lanes, args.seq
    kv_len = args.kv_len or s_max
    rm = args.layout == "rank"
    fn = palu_decode_fp_t if rm else palu_decode_fp
    q = torch.randn((lanes, G * HPG, HD), generator=gen, device=dev).bfloat16()
    b_k = (torch.randn((G, HPG, RK, HD), generator=gen, device=dev) / RK**0.5).bfloat16()
    lat = [torch.randn((lanes, G, s_max, r), generator=gen, device=dev).bfloat16()
           for r in (RK, RV)]
    if rm:
        lat = [x.transpose(-1, -2).contiguous() for x in lat]
    kvl = torch.full((lanes,), kv_len, dtype=torch.int32, device=dev)
    call = lambda: fn(q, b_k, *lat, kvl)  # noqa: E731
    orig = build.load("palu_decode_fp_wg")
    tmp = tempfile.mkdtemp(prefix="decode_timeline_")
    try:
        for hdr in build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, tmp)
        tl = _build(tmp, "timeline", _STAMPS)
        loads = _build(tmp, "loads_only", _LOADS_ONLY)
        rec = {"tool": "decode_timeline", "device": torch.cuda.get_device_name(0),
               "layout": args.layout, "lanes": lanes, "s_max": s_max, "kv_len": kv_len,
               "ms": common.device_us(call, 10) / 1e3}
        build._LIBS["palu_decode_fp_wg"] = loads
        rec["loads_only_ms"] = common.device_us(call, 10) / 1e3
        build._LIBS["palu_decode_fp_wg"] = tl
        tl.tl_clear()
        call()
        torch.cuda.synchronize()
        buf = np.zeros(2 * MAX_TILES * STAMPS, np.int64)
        tl.tl_read(ctypes.c_void_p(buf.ctypes.data))
        t = buf.reshape(2, MAX_TILES, STAMPS).astype(np.float64)
        n = int((t[0, :, 0] > 0).sum())
        rec["tiles_of_block0"] = n
        for c in range(2):
            d = t[c, :n]
            rec[f"consumer{c}_cycles"] = {
                name: float(np.median(d[:, b] - d[:, a])) for name, (a, b) in PHASES.items()}
            rec[f"consumer{c}_cycles"]["tile"] = float(np.median(np.diff(d[:, 0])))
    finally:
        build._LIBS["palu_decode_fp_wg"] = orig
        shutil.rmtree(tmp, ignore_errors=True)
    return [rec]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seq", type=int, default=65536)
    p.add_argument("--lanes", type=int, default=1)
    p.add_argument("--kv_len", type=int, default=0, help="valid tokens per lane (0: S)")
    p.add_argument("--layout", choices=("seq", "rank"), default="seq")
    p.add_argument("--kernel", choices=("fp", "i8"), default="fp")
    p.add_argument("--mode", choices=("int8_dots", "int8_rot"), default="int8_rot")
    p.add_argument("--block_s", type=int, default=512, help="rotation block of the int8 modes")
    recs = run(p.parse_args(argv))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
