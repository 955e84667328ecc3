"""Continuous-batching serving throughput bench (port of
palu_tpu/cli/serve_bench.py): a stream of synthetic requests with mixed
prompt lengths through the port's ServingEngine on a random-weight model.
The decode kernels run on the card (the JAX CLI's use_pallas on a TPU);
--use_cpu runs their plain versions on the CPU.

  python -m palu_tpu_torch.cli.serve_bench --num_requests 32 --lanes 8 \\
      --prompt_len 512 --max_new_tokens 64
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_requests", type=int, default=16)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--prompt_len", type=int, default=256)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--s_max", type=int, default=1024)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=16)
    p.add_argument("--head_dim", type=int, default=128)
    p.add_argument("--group_size", type=int, default=4)
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--lt_bits", type=int, default=16)
    p.add_argument("--lt_sym", action="store_true")
    p.add_argument("--lt_container", type=int, default=0)
    p.add_argument("--weight_bits", type=int, default=16,
                   help="8 = int8 weight-only storage; 4 = packed int4 with "
                        "per-group-128 scales (core/wquant)")
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--decode_chunk", type=int, default=256)
    p.add_argument("--pallas_block", type=int, default=2048,
                   help="rotation block of the int8 K-path modes (rounded down to a "
                        "divisor of s_max)")
    p.add_argument("--int8_rot", action="store_true",
                   help="full-int decode kernel (throughput mode)")
    p.add_argument("--use_cpu", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("--steady_steps", type=int, default=0,
                   help="also measure the steady-state decode cadence over N steps "
                        "with all lanes active, with the fixed cost of a device "
                        "round trip (a trivial op and its fetch) measured and removed")
    p.add_argument("--sample_frac", type=float, default=0.0,
                   help="fraction of requests using temperature sampling "
                        "(exercises the batched sampler)")
    p.add_argument("--chained_ref", type=int, default=0,
                   help="also measure the bare engine's chained TPOT over N steps at "
                        "the same shape (the serving loop's per-step overhead = "
                        "steady corrected step minus this)")
    return p


def _round_trip_s(dev: torch.device, lanes: int) -> float:
    """Median seconds of a trivial device op and its fetch."""
    na = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    (na + 1).cpu()
    t = []
    for _ in range(20):
        t0 = time.perf_counter()
        (na + 1).cpu()
        t.append(time.perf_counter() - t0)
    return float(np.median(t))


def run(args):
    """-> (record, ServingEngine): the JAX CLI's record and the engine."""
    from ..core.quant import QuantConfig
    from ..models import llama
    from ..models.config import ModelConfig
    from ..ops import build
    from ..runtime import profiler
    from ..runtime.engine import EngineConfig
    from ..runtime.sampling import SamplingParams
    from ..runtime.serving import ServingEngine

    dev = build.require_cuda("cpu" if args.use_cpu else "cuda")
    g = args.num_heads // args.group_size
    hwr = {}
    for i in range(args.num_layers):
        hwr[f"model.layers.{i}.self_attn.k_proj"] = [args.rank] * g
        hwr[f"model.layers.{i}.self_attn.v_proj"] = [args.rank] * g
    cfg = ModelConfig(
        vocab_size=args.vocab_size,
        hidden_size=args.num_heads * args.head_dim,
        intermediate_size=args.num_heads * args.head_dim * 2,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads,
        num_key_value_heads=args.num_heads,
        max_position_embeddings=args.s_max,
        head_group_size=args.group_size,
        head_wise_ranks=hwr,
    )
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16)
    qcfg = (QuantConfig(bits=args.lt_bits, sym=args.lt_sym, container=args.lt_container)
            if args.lt_bits < 16 else None)
    srv = ServingEngine(params, cfg, EngineConfig(
        s_max=args.s_max, batch=args.lanes, dtype=torch.bfloat16, qcfg=qcfg,
        decode_chunk=args.decode_chunk, weight_bits=args.weight_bits, device=str(dev),
        pallas_block=args.pallas_block, kernel_int8_rot=args.int8_rot))

    rng = np.random.default_rng(0)
    for rid in range(args.num_requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        sp = (SamplingParams(temperature=1.0, top_k=32)
              if rng.random() < args.sample_frac else None)
        srv.submit(rid, rng.integers(1, cfg.vocab_size, (1, plen)), args.max_new_tokens,
                   sampling=sp)

    steady = None
    if args.steady_steps:
        # fill every lane (admission + prefill), then time the pure decode
        # cadence: each step() ends in a fetch of its tokens, whose fixed
        # round-trip cost is measured alone and removed
        while srv.sched.num_queued() and srv.step():
            if all(a != -1 for a in srv.sched.active()):
                break
        srv.step()
        t_null = _round_trip_s(dev, args.lanes)
        t_steps = []
        for _ in range(args.steady_steps):
            t0 = time.perf_counter()
            if not srv.step():
                break
            t_steps.append(time.perf_counter() - t0)
        step_wall = float(np.median(t_steps)) if t_steps else float("nan")
        corrected = max(step_wall - t_null, 1e-9)
        steady = {
            "step_wall_ms": round(step_wall * 1e3, 3),
            "dispatch_fetch_ms": round(t_null * 1e3, 3),
            "step_corrected_ms": round(corrected * 1e3, 3),
            "steady_tokens_per_s": round(args.lanes / corrected, 1),
            "steady_steps_measured": len(t_steps),
        }
        if args.chained_ref:
            ref = profiler.profile_tpot_chained(srv.engine, args.prompt_len,
                                                n_steps=args.chained_ref, k_calls=3)
            steady["engine_chained_tpot_ms"] = round(ref["tpot_ms"], 3)
            steady["serving_overhead_ms"] = round(corrected * 1e3 - ref["tpot_ms"], 3)

    srv.step()  # the JAX CLI's compile step; here the kernels' first launches
    t0 = time.perf_counter()
    srv.run_until_done()
    elapsed = time.perf_counter() - t0
    stats = srv.sched.stats()
    out = {
        "requests": stats["finished"],
        "total_tokens": stats["tokens"],
        "elapsed_s": round(elapsed, 3),
        "tokens_per_s": round(stats["tokens"] / elapsed, 1),
        "lanes": args.lanes,
        "scheduler": type(srv.sched).__name__,
    }
    if steady:
        out["steady"] = steady
    return out, srv


def main(argv=None):
    args = parser().parse_args(argv)
    out, _ = run(args)
    print(json.dumps(out) if args.json else out)
    return out


if __name__ == "__main__":
    main()
