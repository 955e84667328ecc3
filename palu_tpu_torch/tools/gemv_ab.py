"""A/B of the weight-only GEMVs between two checkouts on one card.

Run it by path, once per checkout and in turns (parent, this, this,
parent), from the root of this checkout:

    python3 palu_tpu_torch/tools/gemv_ab.py <checkout root> <tag> [--timeline] [--e2e]

It imports the given checkout's own chip_smoke (so its own kernels and
wrappers; run by path, this package is not imported first) and prints one
JSON line of device times at 1 and 8 rows of x (bf16), L2 cold (a 64 MB
write before each call), each as [device ms, span ms], and each wrapper's
host time per call at both (`host_us_...`, the median of five
chip_smoke.host_us runs of 100 calls issued while a sleep kernel holds the
card; `host_us_..._runs` lists the five): device ms sums the
call's kernel durations (torch.profiler), span runs from its first
kernel's start to its last one's end (the gaps between its kernels
included). Shapes:
gemv_int8 at VT_k 4096 x 1024, VT_v 4096 x 3072, q_proj 4096 x 4096,
w_fused 12288 x 4096 and lm_head 4096 x 32000 (Llama-2-7B at rank 128 /
384 per group of 4); mlp_gemv_int4 and mlp_gemv_int8 at Llama-2-7B's
H 4096, I 11008 and Qwen2-7B's H 3584, I 18944; gemv_int4 at q_proj,
w_fused and lm_head. Weights are random from seed 7, quantized on the card.

--timeline (a checkout with the streaming kernels only) adds per-block
stamps of the streaming kernels at the main-path shapes, 1 row: the
medians over blocks of the time to the first tile, the tile loop, the
cluster sums, and the end of the last block (us), from the kernels'
`tl` argument (ring::kStamps per block).

--e2e adds the decode steps that reach these kernels, set up as the
checkout's chip_smoke sets up serve_w4 and lanes_w4 (Llama-2-7B at full
depth, int4 weights with int8 VT and embedding, random weights from its
seed): one decode step at batch 1 after a 7000-token prompt and 32 new
tokens, and at batch 8 after 1024-token prompts and 8 new tokens. Each
reports wall ms, device busy ms (the sum of kernel durations,
torch.profiler) and the device's idle share per step, over 8 steps, with
the kernels that take the most device time."""
import json
import os
import re
import sys
import time

INT8 = {"vt_k": (4096, 1024), "vt_v": (4096, 3072), "q_proj": (4096, 4096),
        "w_fused": (12288, 4096), "lm_head": (4096, 32000)}
INT4 = {"q_proj": (4096, 4096), "w_fused": (12288, 4096), "lm_head": (4096, 32000)}
MLP = {"llama": (4096, 11008), "qwen2": (3584, 18944)}


def profile_call(fn, iters: int, flush, tries: int = 3) -> tuple:
    """(device ms, span ms) of one call of fn, L2 cold. A profile with no
    device rows (seen now and then) is taken again; `tries` in a row raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not evs and tries > 1:
        return profile_call(fn, iters, flush, tries - 1)
    total, spans, cur = 0.0, [], None
    for e in evs:
        if re.search("fill", e.name, re.I):  # the flush: a call ends here
            if cur:
                spans.append(cur[1] - cur[0])
            cur = None
            continue
        total += e.time_range.end - e.time_range.start
        cur = [e.time_range.start, e.time_range.end] if cur is None else \
            [cur[0], max(cur[1], e.time_range.end)]
    if cur:
        spans.append(cur[1] - cur[0])
    if not spans:
        raise RuntimeError("torch.profiler recorded no device time")
    return round(total / iters / 1e3, 6), round(sum(spans) / len(spans) / 1e3, 6)


def timeline(cs, res: dict, flush) -> None:
    """Per-block stamps of the streaming kernels (module docstring)."""
    import numpy as np
    import torch
    from palu_tpu_torch.ops import build
    from palu_tpu_torch.ops import gemv_int4 as g4
    from palu_tpu_torch.ops import gemv_int8 as g8

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    stamps = 10

    def summary(t, grid):
        t = t.reshape(grid, stamps).astype(np.float64)
        med = lambda a, b: float(np.median(t[:, b] - t[:, a]) / 1e3)  # noqa: E731
        return {"blocks": grid, "first_tile_us": med(0, 4), "tiles_us": med(4, 5),
                "to_sums_us": med(5, 6), "sums_us": med(6, 7),
                "end_us": float((t[:, 7].max() - t[:, 0].min()) / 1e3)}

    for tag, (k, n) in INT8.items():
        w = cs._qweight(8, k, n, gen)
        x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
        plan = g8.gemv8_plan(g8.device_sms(dev), k, n, 1, g8.device_capacity(dev, g8.KIND_INT8))
        tl = torch.zeros(plan[1] * stamps, dtype=torch.int64, device="cuda")
        out = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")
        flush.zero_()
        build.check(build.launcher("gemv_int8", "palu_gemv_int8_stream", "piiipipiiippp")(
            x.data_ptr(), 1, k, n, w["wq8"].data_ptr(), n, w["ws"].data_ptr(), *plan, 1,
            out.data_ptr(), tl.data_ptr(), build.stream_ptr(dev)), "gemv_int8")
        torch.cuda.synchronize()
        res[f"timeline_gemv_int8_{tag}"] = {"plan": plan, **summary(tl.cpu().numpy(), plan[1])}
    for tag, (h, inter) in MLP.items():
        ws = [cs._qweight(4, h, inter, gen), cs._qweight(4, h, inter, gen),
              cs._qweight(4, inter, h, gen)]
        x = torch.randn((1, h), generator=gen, device="cuda").bfloat16()
        plans = g4.mlp_plan(g8.device_sms(dev), h, inter, 1,
                            (g8.device_capacity(dev, 0), g8.device_capacity(dev, 1)))
        grids = plans[0][1], plans[1][1]
        tl = torch.zeros(sum(grids) * stamps, dtype=torch.int64, device="cuda")
        hp = torch.empty(inter // 2, dtype=torch.int32, device="cuda")
        out = torch.empty((1, h), dtype=torch.bfloat16, device="cuda")
        flush.zero_()
        build.check(build.launcher("gemv_int4", "palu_mlp_gemv_int4_stream", g4._STREAM_SIG)(
            x.data_ptr(), 1, h, inter, *[w[key].data_ptr() for w in ws for key in ("wq4", "ws")],
            hp.data_ptr(), *plans[0], *plans[1], out.data_ptr(), tl.data_ptr(),
            build.stream_ptr(dev)), "mlp_gemv_int4")
        torch.cuda.synchronize()
        t = tl.cpu().numpy()
        res[f"timeline_mlp_gemv_int4_{tag}"] = {
            "plans": plans, "gate_up": summary(t[:grids[0] * stamps], grids[0]),
            "down": summary(t[grids[0] * stamps:], grids[1])}


def e2e(cs, res: dict, steps: int = 8) -> None:
    """Decode steps of serve_w4 and lanes_w4 (module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step(eng):
        cache = eng.last_cache
        tok = np.zeros((eng.batch, 1), np.int64)
        eng.decode(tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.decode(tok, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / steps * 1e3
        return {"lanes": eng.batch, "context": int(cache["length"].max()),
                **cs._breakdown(prof, wall_ms, steps)}

    cfg = cs.llama7b(cs.LAYERS)
    eng, _ = cs._engine(cfg, cs.W4)
    eng.generate(cs._prompts(1, (7000,))[0], max_new_tokens=32)
    res["e2e_serve_w4"] = step(eng)
    lanes, _ = cs._engine(cfg, cs.W4, batch=8, params=eng.params, s_max=2048)
    del eng
    lanes.generate(cs._prompts(2, (1024,), lanes=8)[0], max_new_tokens=8)
    res["e2e_lanes_w4"] = step(lanes)


def main(root: str, tag: str, with_timeline: bool, with_e2e: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}

    def t(name, fn, iters=20):
        res[name] = profile_call(fn, iters, flush)

    def rows_of(k):
        return {r: torch.randn((r, k), generator=gen, device="cuda").bfloat16() for r in (1, 8)}

    def host(name, fn, reps=5):
        runs = sorted(cs.host_us(fn)["us"] for _ in range(reps))
        res[f"host_us_{name}"] = round(runs[reps // 2], 2)
        res[f"host_us_{name}_runs"] = [round(u, 2) for u in runs]

    for name, (k, n) in INT8.items():
        w = cs._qweight(8, k, n, gen)
        for r, x in rows_of(k).items():
            t(f"gemv_int8_{name}_r{r}", lambda: cs.gemv_int8(x, w))
            if name in ("vt_k", "q_proj"):
                host(f"gemv_int8_{name}_r{r}", lambda: cs.gemv_int8(x, w))
        del w
    for name, (h, inter) in MLP.items():
        for bits, fn in ((4, cs.mlp_gemv_int4), (8, cs.mlp_gemv_int8)):
            ws = [cs._qweight(bits, h, inter, gen), cs._qweight(bits, h, inter, gen),
                  cs._qweight(bits, inter, h, gen)]
            for r, x in rows_of(h).items():
                t(f"mlp_gemv_int{bits}_{name}_r{r}", lambda: fn(x, *ws))
                if bits == 4:
                    host(f"mlp_gemv_int4_{name}_r{r}", lambda: fn(x, *ws))
            del ws
    for name, (k, n) in INT4.items():
        w = cs._qweight(4, k, n, gen)
        for r, x in rows_of(k).items():
            t(f"gemv_int4_{name}_r{r}", lambda: cs.gemv_int4(x, w))
        del w
    if with_timeline:
        timeline(cs, res, flush)
    del flush
    if with_e2e:
        e2e(cs, res)
    print(json.dumps({"ab": tag, "root": root, "device": torch.cuda.get_device_name(0),
                      "seconds": round(time.perf_counter() - t0, 1), **res}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--timeline" in sys.argv[3:], "--e2e" in sys.argv[3:])
