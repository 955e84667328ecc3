"""A/B of the latent decodes between two checkouts on one card.

Run it by path, once per checkout and in turns (parent, this, this,
parent), from the root of this checkout:

    python3 palu_tpu_torch/tools/decode_ab.py <checkout root> <tag> [sections]

`sections` (comma-separated; every one by default): exact, fp, seq, v2q,
v3q, dissect, v2, unpack.

It imports the given checkout's own chip_smoke (so its own kernels and
helpers; run by path, this package is not imported first) and prints one
JSON line of device times (chip_smoke.device_ms: torch.profiler, L2 cold)
of palu_decode at the Llama-2-7B group shapes at 8K and at
latency_attention's 64K point (exact, int8_dots and int8_rot, blocks of
512), the int8 modes at serve_bench_int8_rot's shape (8 lanes, S 4096,
kv_len 1024-2080, rk = rv = 128, blocks of 2048) and with the K bias at
Qwen2-7B's shape on the compact b_k, Qwen2-7B's exact decode with the K
bias at 8K and its per-chunk decode at 8 lanes (S 4096, kv_len 2048) on
JAX's repeated b_k and, with a tag starting with "new", on the compact
one, rk 256 and 512 at 8K, one 16K shard with return_stats, the one 64K
call and layer_idx on an L = 4 stack (each mode); then the bf16 decodes
palu_decode_fp / palu_decode_fp_t at the Llama-2-7B group at 8K and at
64K, at the `serving` phase's shape (8 lanes, S 4096, kv_len 2048), at
Qwen2-7B's with the K bias (JAX's repeated b_k and, with a tag starting
with "new", the compact one), at rk 256 and 512, and palu_decode_fp_t on
one 16K shard with return_stats and with layer_idx on an L = 4 stack at
64K. Then (`seq`) palu_decode_seq_quantized over the 3-bit seq-major cache
(run_latency_kernel's --lt_bits 3) at the Llama-2-7B group, batch 1, S =
kv_len = 4K, 8K, 16K and 64K, at rk 256 and 512 (8K), and at 16 q-heads
per group (8K, rk = rv = 256); and (`v2q`) palu_decode2_quantized at ab_v2's
v2q3 shape (8 groups of 4, rk 128, rv 384, the 3-bit rank-major cache,
S = kv_len = 64K). Then (`v3q`) palu_decode3_quantized at ab_v2's v3q2,
v3q3 and v3q4 (64K, rotation blocks of 1024) and v3q3 at 8K, each held
against its plain version first; and (`dissect`) the dissection's five
modes at the tool's shape (64K) beside palu_decode_fp on the same
inputs. Then (`v2`) palu_decode2 over ab_v2's bf16 latents (K seq-major, V
rank-major) at 64K, at kv_len 40000 (ab_v2_kvl's point) and at 8K, each
held against its plain version first, beside palu_decode_fp (ab_v2's v1)
on the same inputs; and (`unpack`) the unpack probe's eight variants at
the tool's shape (BS 1024) and ext4cc / ext4ccmm at BS 128 and 4096, each
held against its plain version first."""
import json
import os
import sys
import time

SECTIONS = ("exact", "fp", "seq", "v2q", "v3q", "dissect", "v2", "unpack")


def main(root: str, tag: str, sections=SECTIONS) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}

    def kv(*n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    def t(name, fn, iters=20):
        res[name] = cs.device_ms(fn, iters)

    if "exact" in sections:
        _exact(cs, tag, gen, kv, t)
    if "fp" in sections:
        _fp(cs, tag, gen, kv, t)
    if "seq" in sections:
        _seq(cs, gen, kv, t)
    if "v2q" in sections or "v3q" in sections:
        _v2q_v3q(cs, gen, t, sections)
    if "dissect" in sections:
        d = cs.dissect.make_inputs(65536, torch.device("cuda"), gen)
        ops = (d["q"], d["b_k"], d["x_k"], d["x_v"], d["kv_len"])
        for mode in cs.dissect.MODES:
            t(f"dissect_{mode}", lambda: cs.dissect.palu_decode_fp_dissect(mode, *ops), 10)
        t("dissect_palu_decode_fp", lambda: cs.palu_decode_fp(*ops), 10)
        del d, ops
    if "v2" in sections:
        _v2(cs, gen, t)
    if "unpack" in sections:
        _unpack(cs, gen, t)
    print(json.dumps({"ab": tag, "root": root, "seconds": round(time.perf_counter() - t0, 1),
                      **res}), flush=True)


def _seq(cs, gen, kv, t) -> None:
    """palu_decode_seq_quantized (the module docstring's list)."""
    seq, ref = cs.palu_decode_seq_quantized, cs.palu_decode_seq_quantized_ref
    qcfg = cs.QuantConfig(bits=3, group_size=0)
    llama = [(s, cs.RK, cs.RV, cs.G, cs.HPG) for s in (4096, 8192, 16384, 65536)]
    for s, rk, rv, g, hpg in llama + [(8192, 256, cs.RV, cs.G, cs.HPG),
                                      (8192, 512, cs.RV, cs.G, cs.HPG),
                                      (8192, 256, 256, cs.NH // 16, 16)]:
        q, b_k, bufs = cs._seq_inputs(qcfg, 1, s, gen, rk, rv, g, hpg)
        skw = dict(qcfg=qcfg, rk=rk, rv=rv)
        label = f"seq_{s // 1024}k" + ("" if rk == cs.RK else f"_rk{rk}") + \
            ("" if hpg == cs.HPG else f"_hpg{hpg}")
        cs._held_decode(label, seq(q, b_k, kv_len=kv(s), **bufs, **skw),
                        ref(q, b_k, kv_len=kv(s), **bufs, **skw))
        t(label, lambda: seq(q, b_k, kv_len=kv(s), **bufs, **skw), 10 if s > 8192 else 20)
        del q, b_k, bufs


def _v2q_v3q(cs, gen, t, sections) -> None:
    """palu_decode2_quantized and palu_decode3_quantized (the module
    docstring's list)."""
    import torch

    x = cs.ab_v2.make_inputs(65536, 65536, torch.device("cuda"), gen)
    if "v2q" in sections:
        v = cs.ab_v2.variant("v2q3", x, 1024)
        t("v2q3_64k", v["fn"], 10)
        del v
    if "v3q" not in sections:
        return
    for name in ("v3q3", "v3q2", "v3q4"):
        v = cs.ab_v2.variant(name, x, 1024)
        cs._held_decode(f"{name}_64k", v["fn"](), v["ref"]())
        t(f"{name}_64k", v["fn"], 10)
        del v
    del x
    x = cs.ab_v2.make_inputs(8192, 8192, torch.device("cuda"), gen)
    v = cs.ab_v2.variant("v3q3", x, 1024)
    cs._held_decode("v3q3_8k", v["fn"](), v["ref"]())
    t("v3q3_8k", v["fn"])


def _v2(cs, gen, t) -> None:
    """palu_decode2 beside palu_decode_fp on the same latents (the module
    docstring's list)."""
    import torch

    for s, kvl, label in ((65536, 65536, "64k"), (65536, 40000, "kvl40000"),
                          (8192, 8192, "8k")):
        x = cs.ab_v2.make_inputs(s, kvl, torch.device("cuda"), gen)
        for name in ("v2", "v1"):
            v = cs.ab_v2.variant(name, x, 1024)
            if name == "v2":
                cs._held_decode(f"v2_{label}", v["fn"](), v["ref"]())
            t(f"{name}_{label}", v["fn"], 10 if s > 8192 else 20)
            del v
        del x


def _unpack(cs, gen, t) -> None:
    """The unpack probe's variants (the module docstring's list)."""
    import torch

    up = cs.unpack_probe
    for bs, variants in ((1024, up.VARIANTS), (128, ("ext4cc", "ext4ccmm")),
                         (4096, ("ext4cc", "ext4ccmm"))):
        x = up.make_inputs(65536, bs, torch.device("cuda"), gen)
        kw = dict(rk=up.RK, rv=up.RV, bs=bs)
        for name in variants:
            ops = up._operands(name, x)
            got, want = up.unpack_probe(name, *ops, **kw), up.unpack_probe_ref(name, *ops, **kw)
            mm = name in ("ext4mm", "ext4ccmm")
            if not up.common.held(got, want, up.MM_TOL if mm else None)["ok"]:
                raise AssertionError(f"unpack {name} BS {bs}: not held")
            t(f"unpack_{name}" + ("" if bs == 1024 else f"_bs{bs}"),
              lambda: up.unpack_probe(name, *ops, **kw))
        del x


def _exact(cs, tag, gen, kv, t) -> None:
    """palu_decode in its modes (the module docstring's list)."""
    import torch

    pd = cs.palu_decode
    kw = dict(qcfg=cs.FLAGSHIP, rk=cs.RK, rv=cs.RV)
    i8 = {mode: dict(block_s=512, **{mode: True}) for mode in ("int8_dots", "int8_rot")}
    q, b_k, bufs = cs._decode_inputs(cs.FLAGSHIP, 1, cs.G, cs.HPG, 8192, gen)
    t("llama_8k", lambda: pd(q, b_k, kv_len=kv(8192), **bufs, **kw))
    for mode, mk in i8.items():
        t(f"{mode}_8k", lambda: pd(q, b_k, kv_len=kv(8192), **bufs, **kw, **mk))
    q, b_k, bufs = cs._decode_inputs(cs.FLAGSHIP, 1, cs.G, cs.HPG, cs.ATTN_S, gen)
    t("llama_64k", lambda: pd(q, b_k, kv_len=kv(cs.ATTN_KV), **bufs, **kw), 10)
    for mode, mk in i8.items():
        t(f"{mode}_64k", lambda: pd(q, b_k, kv_len=kv(cs.ATTN_KV), **bufs, **kw, **mk), 10)
    del q, b_k, bufs
    # serve_bench_int8_rot's shape: 8 lanes, S 4096, kv_len 1024-2080, rk = rv
    # = 128, rotation blocks of 2048
    q, b_k, bufs = cs._decode_inputs(cs.FLAGSHIP, 8, cs.G, cs.HPG, 4096, gen, cs.RK)
    kv8 = kv(1024, 1100, 1500, 2000, 2047, 2048, 2049, 2080)
    for mode in i8:
        t(f"{mode}_serve_bench", lambda: pd(q, b_k, kv_len=kv8, **bufs, qcfg=cs.FLAGSHIP,
                                            rk=cs.RK, rv=cs.RK, block_s=2048, **{mode: True}))
    del q, b_k, bufs

    g, hpg, rk, rv = cs.QWEN2_SHAPE
    rep = hpg // cs.QNKV
    for label, qcfg, lanes, s, n in (("qwen2_bias_8k", cs.FLAGSHIP, 1, 8192, 8192),
                                     ("qwen2_chunked_8lanes", cs.CHUNKED, 8, 4096, 2048)):
        q, b_k, bufs = cs._decode_inputs(qcfg, lanes, g, hpg, s, gen, rv, rk)
        kb = cs._k_bias(g, hpg, gen)
        kvl = torch.full((lanes,), n, dtype=torch.int32, device="cuda")
        qkw = dict(qcfg=qcfg, rk=rk, rv=rv)
        t(f"{label}_repeated", lambda: pd(q, b_k, kv_len=kvl, **bufs, **qkw, k_bias=kb))
        if tag.startswith("new"):  # the engine's form: one B and bias per kv-head
            bc, kbc = b_k[:, ::rep].contiguous(), kb[:, ::rep].contiguous()
            t(f"{label}_compact", lambda: pd(q, bc, kv_len=kvl, **bufs, **qkw, k_bias=kbc))
        if qcfg is cs.FLAGSHIP:  # the int8 modes on the compact form (every checkout's)
            bc, kbc = b_k[:, ::rep].contiguous(), kb[:, ::rep].contiguous()
            for mode, mk in i8.items():
                t(f"{mode}_{label}_compact", lambda: pd(q, bc, kv_len=kvl, **bufs, **qkw,
                                                        k_bias=kbc, **mk))
        del q, b_k, bufs

    for r in cs.BIG_RANKS:
        q, b_k, bufs = cs._decode_inputs(cs.FLAGSHIP, 1, cs.G, cs.HPG, 8192, gen, cs.RV, r)
        t(f"rk{r}_8k", lambda: pd(q, b_k, kv_len=kv(8192), **bufs, qcfg=cs.FLAGSHIP, rk=r,
                                  rv=cs.RV))
        del q, b_k, bufs

    s_loc = cs.S64 // cs.N_SHARDS
    q, b_k, _ = cs._decode_inputs(cs.FLAGSHIP, 1, cs.G, cs.HPG, 16, gen)
    stack = cs._stacked(lambda: cs._decode_inputs(cs.FLAGSHIP, 1, cs.G, cs.HPG, cs.S64, gen)[2],
                        4)
    one = {k: v[0] for k, v in stack.items()}
    sh = cs._shard(one, 1, s_loc)
    t("shard16k_stats", lambda: pd(q, b_k, kv_len=kv(cs.S64), **sh, **kw, pos_offset=s_loc,
                                   return_stats=True))
    t("one_call_64k", lambda: pd(q, b_k, kv_len=kv(cs.S64), **one, **kw), 10)
    t("layer_idx_64k", lambda: pd(q, b_k, kv_len=kv(cs.S64), **stack, **kw, layer_idx=2), 10)
    for mode, mk in i8.items():
        t(f"{mode}_shard16k_stats", lambda: pd(q, b_k, kv_len=kv(cs.S64), **sh, **kw, **mk,
                                               pos_offset=s_loc, return_stats=True))
        t(f"{mode}_layer_idx_64k", lambda: pd(q, b_k, kv_len=kv(cs.S64), **stack, **kw, **mk,
                                              layer_idx=2), 10)
    del stack, one, sh


def _fp(cs, tag, gen, kv, t) -> None:
    """The bf16 decodes palu_decode_fp / palu_decode_fp_t (the module
    docstring's list)."""
    import torch

    g, hpg, rk, rv = cs.QWEN2_SHAPE
    rep = hpg // cs.QNKV
    s_loc = cs.S64 // cs.N_SHARDS
    fp, fp_t = cs.palu_decode_fp, cs.palu_decode_fp_t
    q, b_k, seq, rank = cs._fp_inputs(1, cs.G, cs.HPG, 8192, gen)
    t("fp_8k", lambda: fp(q, b_k, *seq, kv(8192)))
    t("fp_t_8k", lambda: fp_t(q, b_k, *rank, kv(8192)))
    q, b_k, seq, rank = cs._fp_inputs(1, cs.G, cs.HPG, cs.S64, gen)
    t("fp_64k", lambda: fp(q, b_k, *seq, kv(cs.S64)), 10)
    t("fp_t_64k", lambda: fp_t(q, b_k, *rank, kv(cs.S64)), 10)
    del seq
    stack = [torch.stack([x] * 4) for x in rank]
    t("fp_t_layer_idx_64k", lambda: fp_t(q, b_k, *stack, kv(cs.S64), layer_idx=2), 10)
    sh = [x[..., s_loc:2 * s_loc].contiguous() for x in rank]
    t("fp_t_shard16k_stats", lambda: fp_t(q, b_k, *sh, kv(cs.S64), pos_offset=s_loc,
                                          return_stats=True))
    del rank, stack, sh
    q, b_k, seq, _ = cs._fp_inputs(8, cs.G, cs.HPG, 4096, gen)
    t("fp_serving_8lanes", lambda: fp(q, b_k, *seq, torch.full((8,), 2048, dtype=torch.int32,
                                                                   device="cuda")))
    del seq
    q, b_k, seq, rank = cs._fp_inputs(1, g, hpg, 8192, gen, rk, rv)
    kb = cs._k_bias(g, hpg, gen).float()
    for name, fn, lat in (("fp", fp, seq), ("fp_t", fp_t, rank)):
        t(f"{name}_qwen2_bias_8k_repeated", lambda: fn(q, b_k, *lat, kv(8192), k_bias=kb))
        if tag.startswith("new"):
            bc, kbc = b_k[:, ::rep].contiguous(), kb[:, ::rep].contiguous()
            t(f"{name}_qwen2_bias_8k_compact", lambda: fn(q, bc, *lat, kv(8192), k_bias=kbc))
    del seq, rank
    for r in cs.BIG_RANKS:
        q, b_k, seq, rank = cs._fp_inputs(1, cs.G, cs.HPG, 8192, gen, r, cs.RV)
        t(f"fp_rk{r}_8k", lambda: fp(q, b_k, *seq, kv(8192)))
        t(f"fp_t_rk{r}_8k", lambda: fp_t(q, b_k, *rank, kv(8192)))
        del seq, rank


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3].split(",") if len(sys.argv) > 3 else SECTIONS)
