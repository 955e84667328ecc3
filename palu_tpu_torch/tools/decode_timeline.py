"""Where a tile's time goes in the bf16 latent decode kernel
(csrc/palu_decode_fp_wg.cu), on the card.

It copies the kernel's sources into a temporary directory and builds two
patched variants with nvcc beside the unpatched library:
  timeline   - clock64 stamps at the phase boundaries of each tile, taken by
               thread 0 of each consumer warpgroup of block 0 and read back
               by an added C function: the median cycles of each phase over
               the block's tiles;
  loads_only - the consumers wait for and release every chunk but compute
               nothing: the time the TMA ring alone takes to stream the cache.
Then it times the unpatched kernel and the loads-only variant (device ms, L2
cold) and prints one JSON line per case. Usage, on a machine with the card:

  python3 -m palu_tpu_torch.tools.decode_timeline [--seq 65536] [--lanes 1]
      [--kv_len N] [--layout seq|rank]

Llama-2-7B group shapes (8 groups of 4 heads, rk 128, rv 384, hd 128).
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
    ("wgmma_v<RM ? 0 : 1>(vacc[mt],", "before", "if (0) "),
]


def _patch(src: str, edits) -> str:
    for anchor, where, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"decode_timeline: anchor not found once: {anchor[:50]!r}")
        src = src.replace(anchor, text + anchor if where == "before" else anchor + text)
    return src


def _build(tmp: str, name: str, edits) -> ctypes.CDLL:
    src = open(build.CSRC / "palu_decode_fp_wg.cu").read()
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(_patch(src, edits))
    out = os.path.join(tmp, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(out)


def run(args) -> list:
    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs an NVIDIA GPU with nvcc")
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
    recs = run(p.parse_args(argv))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
