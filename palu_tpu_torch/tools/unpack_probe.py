"""What sub-byte extraction costs on the card (port of
tools/tpu_unpack_probe.py): rank-major packed codes (G, rows, S) streamed
by TMA through an mbarrier ring and unpacked, one launch a call, one wave
of blocks over (group, BS-token block) items (csrc/unpack_probe.cu), at
the headline shape g 8, rk 128, rv 384, S 64K.

Variants (the JAX tool's names):
  base      - stream the 4-bit codes, no extraction (a checksum of the bytes);
  ext4nc    - extract 4-bit codes, each part converted to bf16 and summed
              in registers;
  ext4cc    - extract, assemble bf16 (64 ranks x 64 tokens) boxes in shared
              memory in the 128-byte swizzle (as the seq-major packed
              decode's producer writes its chunks), read each back;
  ext4mm    - extract in registers into wgmma A fragments (as the exact
              decode's K warpgroup does): the K product against B (g, rk,
              64) and the V product against p (g, BS, 8);
  ext4ccmm  - the same products on SS wgmma over the assembled boxes;
  ext3nc / ext3cc - the same over 3-bit bit planes;
  conv8     - convert int8 codes (twice the bytes of 4-bit).
Each integer variant returns the exact integer total of the values it
extracted, held exactly against the plain version; the mm variants return
the (group, block) sums of their products, held within the bf16 class.
`unpack_plan` and `unpack_items` mirror the kernel's shared-memory plan and
item walk. Usage:

  python -m palu_tpu_torch.tools.unpack_probe [variant ...] [--seq S] [--bs N] [--nch N]
  python -m palu_tpu_torch.tools.unpack_probe --use_cpu --seq 1024 --bs 256
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops import build
from . import common

__all__ = ["unpack_probe", "unpack_probe_ref", "unpack4_parts", "unpack3_parts", "token_sums",
           "unpack_plan", "unpack_items", "make_inputs", "parser", "run", "main", "VARIANTS",
           "MM_TOL"]

VARIANTS = ("base", "ext4nc", "ext4cc", "ext4mm", "ext4ccmm", "ext3nc", "ext3cc", "conv8")
G, RK, RV, HD = 8, 128, 384, 128
W = HD // 2
# the mm variants' sums of bf16 products with f32 accumulation against the
# plain version's f64: the bf16 class (docs/PARITY.md item 5), as a share
# of max|plain|
MM_TOL = 2e-3
# the kernel's tile (a ring stage) of tokens, its deepest ring, a block's
# shared memory (227 KB) less the base's alignment slack, an assembled box
TILE, MAX_STAGES, SMEM_MAX, BOX_BYTES = 128, 8, 232448, 64 * 128


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def _code_rows(variant: str, r: int) -> int:
    return r // 2 if variant in VARIANTS[:5] else r if variant == "conv8" else 3 * r // 8


def _boxes(rows: int) -> tuple:
    """(box rows, boxes) of one side's TMA loads: at most 256 rows a box,
    a multiple of 8 when there are several."""
    n = -(-rows // 256)
    return (rows if n == 1 else _up(-(-rows // n), 8)), n


def unpack_plan(variant: str, rk: int, rv: int) -> Optional[dict]:
    """The kernel's shared-memory plan (csrc/unpack_probe.cu::make_plan, the
    same function): `smem` bytes a launch takes, `ns` ring stages of
    `stage` bytes (each a 128-token tile, its K then its V code rows, each
    side 1024-aligned; TMA boxes of `br_*` rows, `nbox_*` of them; the mm
    variants' stage ends with the tile's 128 rows of p, 2 KB), the cc
    boxes a warpgroup assembles per side (`ccb_*`: 64 ranks x 64 tokens, 8
    KB), B's rows (`b_rows`, mm: ext4mm's in whole 128-rank chunks), and the offsets of B, p^T (two 1 KB
    buffers a warpgroup, mm), the boxes (two buffers a warpgroup, three
    with products), the reduction rows and the barriers. The deepest ring
    up to 8 stages that fits; None when 2 stages do not."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    cc, mm = variant in ("ext4cc", "ext4ccmm", "ext3cc"), variant in ("ext4mm", "ext4ccmm")
    rows_k, rows_v = _code_rows(variant, rk), _code_rows(variant, rv)
    (br_k, nbox_k), (br_v, nbox_v) = _boxes(rows_k), _boxes(rows_v)

    def ccb(r: int) -> int:
        return 0 if not cc else -(-(r // 8) // 8) if variant == "ext3cc" else -(-(r // 2) // 32)

    ccb_k, ccb_v = ccb(rk), ccb(rv)
    b_rows = _up(rk, 128) if variant == "ext4mm" else 64 * ccb_k if variant == "ext4ccmm" else 0
    side_v = _up(nbox_k * br_k * 128, 1024)
    side_p = side_v + _up(nbox_v * br_v * 128, 1024)
    stage = side_p + (TILE * 8 * 2 if mm else 0)
    nbuf = (3 if mm else 2) if cc else 0
    for ns in range(MAX_STAGES, 1, -1):
        b = ns * stage
        pt = _up(b + b_rows * 128, 1024)
        asm = pt + (2 * 2 * 1024 if mm else 0)
        red = asm + 2 * nbuf * BOX_BYTES
        bars = _up(red + (2 * 8 * 2 * 4 if mm else 0), 8)
        total = bars + 2 * 8 * ns
        if total <= SMEM_MAX - 1024:
            return {"smem": total + 1024, "ns": ns, "stage": stage, "side_v": side_v,
                    "side_p": side_p, "rows_k": rows_k,
                    "load_bytes": (nbox_k * br_k + nbox_v * br_v) * 128 + stage - side_p,
                    "rows_v": rows_v, "br_k": br_k, "nbox_k": nbox_k, "br_v": br_v,
                    "nbox_v": nbox_v, "ccb_k": ccb_k, "ccb_v": ccb_v, "b_rows": b_rows,
                    "b": b, "pt": pt, "asm": asm, "red": red, "bars": bars}
    return None


def unpack_items(n_items: int, grid: int) -> list:
    """The kernel's item walk: block b's work items [b N / grid, (b + 1) N /
    grid) of the N = G * S / BS (group, block) items, item i being group i
    // (S / BS), block i % (S / BS)."""
    return [range(b * n_items // grid, (b + 1) * n_items // grid) for b in range(grid)]


def unpack4_parts(c: torch.Tensor) -> list:
    """The two 4-bit parts of a (rows, ...) code array: low then high
    nibble, as int32 (the JAX tool's unpack4_parts)."""
    c = c.to(torch.int32)
    return [c & 15, (c >> 4) & 15]


def unpack3_parts(c: torch.Tensor, rank: int) -> list:
    """The eight 3-bit parts of (3 * rank / 8, ...) bit planes: part k takes
    bit k of planes 0, 1 and 2 as its bits 0, 1 and 2 (the JAX tool's
    unpack3_parts)."""
    c = c.to(torch.int32)
    r = rank // 8
    b0, b1, b2 = c[:r], c[r:2 * r], c[2 * r:3 * r]
    return [((b0 >> k) & 1) | (((b1 >> k) & 1) << 1) | (((b2 >> k) & 1) << 2)
            for k in range(8)]


def _values(variant: str, codes: torch.Tensor, rank: int) -> torch.Tensor:
    """The extracted values of one side's codes (G, rows, S), in rank order
    (G, rank, S), int32."""
    if variant == "conv8":
        return codes.to(torch.int32)
    if variant.startswith("ext3"):
        return torch.cat(unpack3_parts(codes.transpose(0, 1), rank), 0).transpose(0, 1)
    return torch.cat(unpack4_parts(codes.transpose(0, 1)), 0).transpose(0, 1)


def token_sums(variant: str, kc: torch.Tensor, vc: torch.Tensor, rk: int,
               rv: int) -> torch.Tensor:
    """(S,) int64: every extracted value of both sides summed over groups
    and ranks, per token."""
    return sum(_values(variant, c, r).to(torch.int64).sum((0, 1))
               for c, r in ((kc, rk), (vc, rv)))


def _mm_ref(kc, vc, b1, p, rk, rv, bs) -> torch.Tensor:
    """(2, G, S / BS) f32: per group and block, the sum of K's products
    x^T . B and of V's x . p, exact in f64 (sums of products regrouped:
    sum_t sum_r x[r, t] * (sum_w B[r, w]), the same for p)."""
    g, s = kc.shape[0], kc.shape[2]
    nb = s // bs
    xk = _values("ext4", kc, rk).to(torch.int64).reshape(g, rk, nb, bs).sum(-1)   # (G, rk, nb)
    k = (xk.double() * b1.double().sum(-1)[:, :, None]).sum(1)
    xv = _values("ext4", vc, rv).to(torch.int64).sum(1).reshape(g, nb, bs)         # (G, nb, BS)
    v = (xv.double() * p.double().sum(-1)[:, None, :]).sum(-1)
    return torch.stack([k, v]).float()


def unpack_probe_ref(variant: str, kc, vc, b1=None, p=None, *, rk: int, rv: int,
                     bs: int) -> torch.Tensor:
    """Plain version: base the fold16 checksum of the codes; the integer
    variants the (1,) int64 total of the extracted values; the mm variants
    (2, G, S / BS) f32 product sums."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "base":
        return common.fold16(kc, vc)
    if variant in ("ext4mm", "ext4ccmm"):
        return _mm_ref(kc, vc, b1, p, rk, rv, bs)
    return token_sums(variant, kc, vc, rk, rv).sum().reshape(1)


def unpack_probe(variant: str, kc, vc, b1=None, p=None, *, rk: int, rv: int,
                 bs: int) -> torch.Tensor:
    """Stream and unpack rank-major codes kc (G, rows_k, S), vc (G, rows_v,
    S) in BS-token blocks: rows = rank / 2 (4-bit, base), 3 * rank / 8
    (3-bit, uint8) or rank (conv8, int8); the mm variants also take b1 (G,
    rk, W) and p (G, BS, 8) bf16. Returns what unpack_probe_ref returns.
    CUDA tensors launch the kernel (one launch a call), CPU tensors run the
    plain version."""
    if not kc.is_cuda:
        return unpack_probe_ref(variant, kc, vc, b1, p, rk=rk, rv=rv, bs=bs)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    g, s = kc.shape[0], kc.shape[2]
    four = variant in VARIANTS[:5]
    want_dtype = torch.int8 if variant == "conv8" else torch.uint8
    mm = variant in ("ext4mm", "ext4ccmm")
    rows_k, rows_v = _code_rows(variant, rk), _code_rows(variant, rv)
    if tuple(kc.shape) != (g, rows_k, s) or tuple(vc.shape) != (g, rows_v, s) or \
            kc.dtype != want_dtype or vc.dtype != want_dtype:
        raise ValueError(f"{variant}: codes must be {want_dtype} (G, {rows_k}, S) and "
                         f"(G, {rows_v}, S), got {tuple(kc.shape)}, {tuple(vc.shape)}")
    if bs % TILE or s % bs or rk % (32 if four else 8) or rv % (32 if four else 8):
        raise ValueError(f"the unpack kernel needs BS a multiple of {TILE} dividing S and "
                         f"ranks multiples of {32 if four else 8} (BS={bs}, S={s}, rk={rk}, "
                         f"rv={rv})")
    if mm and (b1 is None or p is None or tuple(b1.shape[:2]) != (g, rk) or
               b1.shape[2] % 16 or b1.shape[2] > 64 or tuple(p.shape) != (g, bs, 8) or
               b1.dtype != torch.bfloat16 or p.dtype != torch.bfloat16 or rv > 512):
        raise ValueError("the mm variants take b1 (G, rk, W) bf16 with W a multiple of 16 up "
                         "to 64, p (G, BS, 8) bf16 and rv up to 512")
    ts = [kc, vc] + ([b1, p] if mm else [])
    if any(not t.is_contiguous() or t.device != kc.device or t.data_ptr() % 16 for t in ts):
        raise ValueError("inputs must be contiguous, 16-byte aligned and on one device")
    if unpack_plan(variant, rk, rv) is None:
        raise ValueError(f"{variant}: two stages of the unpack kernel's ring do not fit in a "
                         f"block's shared memory at rk {rk}, rv {rv}")
    nb = s // bs
    grid = min(g * nb, torch.cuda.get_device_properties(kc.device).multi_processor_count)
    out = torch.empty((2, g, nb) if mm else (1,), dtype=torch.float32 if mm else torch.int64,
                      device=kc.device)
    err = build.launcher("unpack_probe", "unpack_probe", "ipppppp" + "i" * 7 + "p")(
        VARIANTS.index(variant), kc.data_ptr(), vc.data_ptr(),
        b1.data_ptr() if mm else None, p.data_ptr() if mm else None,
        out.data_ptr() if mm else None, None if mm else out.data_ptr(), g, rk, rv,
        b1.shape[2] if mm else 0, s, bs, grid, build.stream_ptr(kc.device))
    build.check(err, f"unpack_probe ({variant})")
    unpack_probe.launches += 1
    return out


unpack_probe.launches = 0


def make_inputs(seq: int, bs: int, dev: torch.device, gen: torch.Generator) -> dict:
    """The tool's arrays from one generator: 4-bit codes pk4 (8, 64, S), pv4
    (8, 192, S), 3-bit planes pk3 (8, 48, S), pv3 (8, 144, S), uniform in
    [0, 255); int8 codes ck8 (8, 128, S), cv8 (8, 384, S) in [-127, 127);
    b1 (8, 128, 64) and the stand-in p bv (8, BS, 8), bf16 normal * 0.1."""
    def codes(rows, lo=0, hi=255, dtype=torch.uint8):
        return torch.randint(lo, hi, (G, rows, seq), generator=gen, device=dev).to(dtype)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)

    return {"pk4": codes(RK // 2), "pv4": codes(RV // 2), "pk3": codes(3 * RK // 8),
            "pv3": codes(3 * RV // 8), "ck8": codes(RK, -127, 127, torch.int8),
            "cv8": codes(RV, -127, 127, torch.int8), "b1": normal((G, RK, W)),
            "bv": normal((G, bs, 8))}


def _operands(variant: str, x: dict) -> tuple:
    if variant.startswith("ext3"):
        return x["pk3"], x["pv3"], None, None
    if variant == "conv8":
        return x["ck8"], x["cv8"], None, None
    if variant in ("ext4mm", "ext4ccmm"):
        return x["pk4"], x["pv4"], x["b1"], x["bv"]
    return x["pk4"], x["pv4"], None, None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--seq", type=int, default=common.env_int("SEQ", 65536))
    p.add_argument("--bs", type=int, default=common.env_int("BS", 1024),
                   help="tokens per block")
    p.add_argument("--nch", type=int, default=common.env_int("NCH", 64),
                   help="timed calls per variant")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per variant")
    return p


def run(args) -> List[dict]:
    """Every variant once, held against its plain version, then timed.
    Returns the records."""
    dev = common.device_of(args.use_cpu)
    x = make_inputs(args.seq, args.bs, dev, common.generator(dev))
    kw = dict(rk=RK, rv=RV, bs=args.bs)
    recs = []
    for v in args.variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v}")
        ops = _operands(v, x)
        n0 = unpack_probe.launches
        got = unpack_probe(v, *ops, **kw)
        want = unpack_probe_ref(v, *ops, **kw)
        mm = v in ("ext4mm", "ext4ccmm")
        nbytes = sum(t.numel() * t.element_size() for t in ops if t is not None) + got.numel() * \
            got.element_size()
        flops = 2 * G * args.seq * (RK * W + RV * 8) if mm else 0
        rec = {"probe": "unpack", "variant": v, "bytes": nbytes, "flops": flops,
               "values": 0 if v == "base" else G * args.seq * (RK + RV),
               "held": common.held(got, want, MM_TOL if mm else None)}
        if not mm:
            rec["total"] = int(got[0])
        rec.update(common.time_call(lambda: unpack_probe(v, *ops, **kw), dev, args.nch))
        rec["launches"] = unpack_probe.launches - n0
        if dev.type == "cuda":
            rec["plain_us"] = common.device_us(lambda: unpack_probe_ref(v, *ops, **kw), 2)
            rec["library"], rec["library_us"] = None, None
            rec["bound_us"], rec["bound_by"] = common.bound_us(nbytes, flops)
        recs.append(rec)
    return recs


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        print(f"device: {dev} seq={args.seq} BS={args.bs} timed calls={args.nch} "
              f"values={G * args.seq * (RK + RV) / 1e6:.0f}M", flush=True)
    recs = run(args)
    for rec in recs:
        common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs):
        raise SystemExit("unpack_probe: a variant disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
