"""Reconstruction-kernel micro-bench (port of
palu_tpu/cli/run_latency_kernel.py): the fused latent decode kernel
("ours": palu_decode_fp over bf16 latents, or with --lt_bits < 16
palu_decode_seq_quantized over seq-major packed codes) against the plain
PyTorch latent decode ("xla": the key is the JAX CLI's, the function is
ops/attention.flash_decode_latent) and a dense-KV decode over dense bf16 K/V
("WX": on the card ops/attention.dense_decode_sdpa, the one
scaled_dot_product_attention call the engine's dense layers run, where the
JAX CLI compiles one XLA scan; with --use_cpu the plain
ops/attention.dense_flash_decode), across sequence lengths. Times are host-clock microseconds per call up to a device sync
(median, p20, p80 of 50 after 10 warm-up calls).

  python -m palu_tpu_torch.cli.run_latency_kernel --total_rank 1024 \\
      --target_seq_lens 4096 16384 65536
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _bench(fn, dev: torch.device, warmup: int = 10, rep: int = 50):
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(rep):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e6)
    t = np.asarray(times)
    return float(np.median(t)), float(np.percentile(t, 20)), float(np.percentile(t, 80))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--total_rank", type=int, default=1024)
    parser.add_argument("--total_rank_v", type=int, default=None)
    parser.add_argument("--num_heads", type=int, default=32)
    parser.add_argument("--head_dim", type=int, default=128)
    parser.add_argument("--group_size", type=int, default=4)
    parser.add_argument("--target_seq_lens", nargs="+", type=int,
                        default=[4096, 16384, 65536, 262144])
    parser.add_argument("--block_s", type=int, default=512,
                        help="sequence blocks: s_max rounds up to them, and the plain "
                             "providers read chunks of this size")
    parser.add_argument("--lt_bits", type=int, default=16)
    parser.add_argument("--providers", nargs="+", default=["WX", "xla", "ours"],
                        help="ours = the port's kernel; xla = its plain PyTorch latent "
                             "decode (the JAX CLI's key); WX = dense-KV decode "
                             "(scaled_dot_product_attention on the card)")
    parser.add_argument("--use_cpu", action="store_true",
                        help="run on the CPU: the kernels' plain versions")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    from ..core.quant import QuantConfig, pack_codes, quantize
    from ..ops import build
    from ..ops.attention import dense_decode_sdpa, dense_flash_decode, flash_decode_latent
    from ..ops.palu_decode_fp import palu_decode_fp
    from ..ops.palu_decode_seq import palu_decode_seq_quantized

    dev = build.require_cuda("cpu" if args.use_cpu else "cuda")
    g = args.num_heads // args.group_size
    hpg = args.num_heads // g
    rk = args.total_rank // g
    rv = (args.total_rank_v or args.total_rank) // g
    hd = args.head_dim
    rng = np.random.default_rng(0)

    def randn(shape, scale=1.0):
        x = rng.standard_normal(shape)
        return torch.from_numpy((x * scale if scale != 1.0 else x).astype(np.float32)).to(
            dev, torch.bfloat16)

    rows = []
    for seq_len in args.target_seq_lens:
        s_max = (seq_len + args.block_s - 1) // args.block_s * args.block_s
        q = randn((1, args.num_heads, hd))
        b_k = randn((g, hpg, rk, hd), 0.1)
        x_k = randn((1, g, s_max, rk))
        x_v = randn((1, g, s_max, rv))
        kvl = torch.full((1,), seq_len, dtype=torch.int32, device=dev)
        row = {"seq_len": seq_len}

        if "ours" in args.providers:
            if args.lt_bits < 16:
                qc = QuantConfig(bits=args.lt_bits, group_size=0)
                kc, ks, kb = quantize(x_k, qc)
                vc, vs, vb = quantize(x_v, qc)
                kcp, vcp = pack_codes(kc, args.lt_bits), pack_codes(vc, args.lt_bits)

                def fn():
                    return palu_decode_seq_quantized(q, b_k, kcp, ks, kb, vcp, vs, vb, kvl,
                                                     qcfg=qc, rk=rk, rv=rv)
            else:
                def fn():
                    return palu_decode_fp(q, b_k, x_k, x_v, kvl)
            row["ours_us"], row["ours_p20"], row["ours_p80"] = _bench(fn, dev)

        if "xla" in args.providers:
            chunk = args.block_s

            def plain():
                return flash_decode_latent(
                    q, lambda i: x_k[:, :, i * chunk:(i + 1) * chunk],
                    lambda i: x_v[:, :, i * chunk:(i + 1) * chunk], b_k, s_max // chunk,
                    chunk, kvl, hd, 10000.0, rv, None)

            row["xla_us"], _, _ = _bench(plain, dev)

        if "WX" in args.providers:
            # dense-KV flash-decode baseline: reads 2 * nh * hd * seq values
            k_dense = randn((1, args.num_heads, s_max, hd))
            v_dense = randn((1, args.num_heads, s_max, hd))
            if dev.type == "cuda":
                def dense():
                    return dense_decode_sdpa(q, k_dense, v_dense, kvl)
            else:
                def dense():
                    return dense_flash_decode(q, k_dense, v_dense, kvl, args.block_s)
            row["WX_us"], _, _ = _bench(dense, dev)
            del k_dense, v_dense

        rows.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            parts = [f"seq={seq_len}"]
            for key in ("WX_us", "xla_us", "ours_us"):
                if key in row:
                    parts.append(f"{key.split('_')[0]}={row[key]:.0f}us")
            print("  ".join(parts), flush=True)
    return rows


if __name__ == "__main__":
    main()
