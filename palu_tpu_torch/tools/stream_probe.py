"""The streaming floor of the latent cache on the card (port of
tools/tpu_stream_probe.py): a grid that stages the cache into shared memory
tile by tile and does no compute (csrc/stream_probe.cu), in three layouts,
beside PyTorch's own reductions over the same bytes.

Probes (the JAX tool's names):
  bs<N>     - split-g planes (1, 8, S, 128) + (1, 8, S, 384) bf16, as the v1
              decode reads them; N tokens per block.
  merged<N> - one (S, 8 * 512) array; each tile one contiguous run.
  konly<N>  - the K plane alone (134 MB at 64K).
  xla<N>    - library: a loop of torch.sum over N-token slices of both planes.
  xlasum    - library: one torch.sum over each plane.

Each kernel probe returns the tool's (8, 128) f32 output, c + the number of
N-token blocks, and an exact checksum of every byte read, both held against
the plain version (exact). Usage:

  python -m palu_tpu_torch.tools.stream_probe [probe ...] [--seq S] [--nch N]
  python -m palu_tpu_torch.tools.stream_probe --use_cpu --seq 1024 bs256 xlasum
"""

from __future__ import annotations

import argparse
from typing import List, Sequence

import torch

from ..ops import build
from . import common

__all__ = ["stream_probe", "stream_probe_ref", "make_inputs", "parser", "run", "main",
           "DEFAULT_PROBES"]

G, RK, RV = 8, 128, 384
DEFAULT_PROBES = ["bs1024", "bs4096", "merged1024", "merged4096", "konly1024", "xla2048",
                  "xlasum"]


def _planes(arrays: Sequence[torch.Tensor]):
    """Each array as (planes, S, width bytes); the same planes and S."""
    if not 1 <= len(arrays) <= 2 or any(a.dim() != 3 for a in arrays):
        raise ValueError("stream_probe takes one or two (planes, S, width) arrays")
    planes, s = arrays[0].shape[0], arrays[0].shape[1]
    for a in arrays:
        if tuple(a.shape[:2]) != (planes, s) or (a.shape[2] * a.element_size()) % 16:
            raise ValueError(f"arrays must share (planes, S) and have rows of a multiple of "
                             f"16 bytes, got {[tuple(x.shape) for x in arrays]}")
    return planes, s


def stream_probe_ref(c: torch.Tensor, arrays: Sequence[torch.Tensor], block_rows: int):
    """Plain version: (c + 1 for each block of block_rows rows, added in
    order as the TPU grid's steps add it, fold16 of every byte of the
    arrays)."""
    _, s = _planes(arrays)
    out = c.clone()
    for _ in range(-(-s // block_rows)):
        out = out + 1.0
    return out, common.fold16(*arrays)


def stream_probe(c: torch.Tensor, arrays: Sequence[torch.Tensor], block_rows: int,
                 tile_rows: int):
    """Stream `arrays` ((planes, S, width) each, contiguous, the same
    planes and S) through shared memory: block (i, p) takes rows [i *
    block_rows, (i + 1) * block_rows) of plane p in tiles of tile_rows rows.
    c (8, 128) f32. -> (out (8, 128) f32 = c + blocks along S, checksum
    (1,) int64). CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if not c.is_cuda:
        return stream_probe_ref(c, arrays, block_rows)
    planes, s = _planes(arrays)
    if c.shape != (8, 128) or c.dtype != torch.float32:
        raise ValueError(f"c must be (8, 128) f32, got {c.dtype} {tuple(c.shape)}")
    if any(not a.is_contiguous() or a.device != c.device for a in arrays):
        raise ValueError("arrays must be contiguous and on c's device")
    blocks = -(-s // block_rows)
    part = torch.empty(planes * blocks + 1, dtype=torch.int64, device=c.device)
    out = torch.empty((8, 128), dtype=torch.float32, device=c.device)
    w = [a.shape[2] * a.element_size() for a in arrays]
    a1 = arrays[1] if len(arrays) > 1 else None
    err = build.launcher("stream_probe", "stream_probe", "pipiiiiippppp")(
        arrays[0].data_ptr(), w[0], None if a1 is None else a1.data_ptr(),
        w[1] if a1 is not None else 0, planes, s, block_rows, tile_rows, part.data_ptr(),
        c.contiguous().data_ptr(), out.data_ptr(), part[planes * blocks:].data_ptr(),
        build.stream_ptr(c.device))
    build.check(err, "stream_probe")
    stream_probe.launches += 1
    return out, part[planes * blocks:]


stream_probe.launches = 0


def make_inputs(seq: int, dev: torch.device, gen: torch.Generator) -> dict:
    """The tool's arrays from one generator: x_k (1, 8, S, 128), x_v (1, 8,
    S, 384) and the merged x_m (S, 8 * 512), bf16 normal."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return {"x_k": normal((1, G, seq, RK)), "x_v": normal((1, G, seq, RV)),
            "x_m": normal((seq, G * (RK + RV)))}


def _kernel_probe(name: str, x: dict):
    """(arrays, block rows, tile rows) of a kernel probe."""
    for prefix, arrays, tile in (("bs", [x["x_k"][0], x["x_v"][0]], 64),
                                 ("merged", [x["x_m"][None]], 8),
                                 ("konly", [x["x_k"][0]], 64)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return arrays, int(name[len(prefix):]), tile
    return None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("probes", nargs="*", default=DEFAULT_PROBES)
    p.add_argument("--seq", type=int, default=common.env_int("SEQ", 65536))
    p.add_argument("--nch", type=int, default=common.env_int("NCH", 16),
                   help="timed calls per probe")
    p.add_argument("--use_cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true", help="one JSON record per probe")
    return p


def run(args) -> List[dict]:
    """Every probe once: its output held against the plain version (kernel
    probes), its device time, bound and yardstick. Returns the records."""
    dev = common.device_of(args.use_cpu)
    x = make_inputs(args.seq, dev, common.generator(dev))
    c = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    recs = []
    for name in args.probes:
        kp = _kernel_probe(name, x)
        if kp is not None:
            arrays, rows, tile = kp
            nbytes = sum(a.numel() * a.element_size() for a in arrays) + 2 * c.numel() * 4
            n0 = stream_probe.launches
            out, ck = stream_probe(c, arrays, rows, tile)
            want_out, want_ck = stream_probe_ref(c, arrays, rows)
            h_out, h_ck = common.held(out, want_out, None), common.held(ck, want_ck, None)
            rec = {"probe": "stream", "variant": name, "bytes": nbytes, "checksum": int(ck[0]),
                   "held": {"ok": h_out["ok"] and h_ck["ok"], "out": h_out, "checksum": h_ck,
                            "max_abs_err": max(h_out["max_abs_err"], h_ck["max_abs_err"])}}
            rec.update(common.time_call(lambda: stream_probe(c, arrays, rows, tile), dev,
                                        args.nch))
            if dev.type == "cuda":
                rec["plain_us"] = common.device_us(lambda: stream_probe_ref(c, arrays, rows), 3)
                rec["library"] = "torch.sum over the same arrays"
                rec["library_us"] = common.device_us(
                    lambda: [torch.sum(a, dtype=torch.float32) for a in arrays], args.nch)
            rec["launches"] = stream_probe.launches - n0
        elif name == "xlasum" or (name.startswith("xla") and name[3:].isdigit()):
            xk, xv = x["x_k"], x["x_v"]
            nbytes = (xk.numel() + xv.numel()) * 2
            if name == "xlasum":
                def fn():
                    return torch.sum(xk, dtype=torch.float32) + torch.sum(xv, dtype=torch.float32)
            else:
                n = int(name[3:])

                def fn():
                    s = torch.zeros((), dtype=torch.float32, device=dev)
                    for i in range(0, args.seq, n):
                        s = s + torch.sum(xk[:, :, i:i + n], dtype=torch.float32) + \
                            torch.sum(xv[:, :, i:i + n], dtype=torch.float32)
                    return s
            rec = {"probe": "stream", "variant": name, "bytes": nbytes,
                   "library": "torch.sum", **common.time_call(fn, dev, args.nch)}
        else:
            raise SystemExit(f"unknown probe {name}")
        if "us" in rec:
            rec["bound_us"], rec["bound_by"] = common.bound_us(rec["bytes"])
            rec["gb_per_s"] = rec["bytes"] / rec["us"] / 1e3
        recs.append(rec)
    return recs


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    dev = common.device_name(args.use_cpu)
    if not args.json:
        print(f"device: {dev} seq={args.seq} timed calls={args.nch} "
              f"full={G * args.seq * (RK + RV) * 2 / 1e6:.0f}MB", flush=True)
    recs = run(args)
    for rec in recs:
        common.emit(rec, args.json)
    if any(not r["held"]["ok"] for r in recs if "held" in r):
        raise SystemExit("stream_probe: a kernel disagreed with its plain version")
    return recs


if __name__ == "__main__":
    main()
