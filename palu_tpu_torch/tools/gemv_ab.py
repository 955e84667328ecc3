"""A/B of the GEMVs and the Hadamard transform between two checkouts on one
card.

Run it by path, once per checkout and in turns (parent, this, this,
parent), from the root of this checkout:

    python3 palu_tpu_torch/tools/gemv_ab.py <checkout root> <tag> [--timeline] [--e2e]
        [--only=int8,mlp,int4,bf16,bf16t,hadamard,floor,append,mlp8plans]

It imports the given checkout's own chip_smoke (so its own kernels and
wrappers; run by path, this package is not imported first) and prints one
JSON line of device times at 1 and 8 rows of x (bf16), L2 cold (a 64 MB
in-place bitwise_not before each call, its kernel left out by name), each
as [device ms, span ms], and each wrapper's host time per call at both
(`host_us_...`, the median of five chip_smoke.host_us runs of 100 calls
made while a sleep kernel holds the card; `host_us_..._runs` lists the
five): device ms sums the call's kernel durations (torch.profiler), span
runs from its first kernel's start to its last one's end (the gaps
between its kernels included). Shapes: gemv_int8 at VT_k 4096 x 1024,
VT_v 4096 x 3072, q_proj 4096 x 4096, w_fused 12288 x 4096 and lm_head
4096 x 32000 (Llama-2-7B at rank 128 / 384 per group of 4);
mlp_gemv_int4 and mlp_gemv_int8 at Llama-2-7B's H 4096, I 11008 and
Qwen2-7B's H 3584, I 18944; gemv_int4 at q_proj, w_fused and lm_head
beside torch._weight_int4pack_mm on the same codes (`..._int4pack`,
chip_smoke._int_library) and the wrapper's host time at q_proj;
gemv_bf16 (the probe tool's GEMV over W (K, N), tools/gemv_probe.py) at
K x N 4096 x 4096, 4096 x 1024 and 12288 x 4096 beside torch.matmul on
the same W (`..._matmul`); gemv_bf16_t (its W^T GEMV) at K x N
4096 x 4096, 4096 x 1024 and 12288 x 4096 beside F.linear on the same
W^T (`..._F.linear`); hadamard_transform at chip_smoke.check_hadamard's
timed shapes in f32 and bf16 beside torch.matmul against the dense
matrix in x's type (`..._matmul`) and a copy of x (`..._clone`); floor:
how fast the card streams a 4096 x 4096 bf16 matrix (33.5 MB) with
nothing computed, by each load path (csrc/stream_floor.cu of this tool's
own checkout, built here with nvcc: 16-byte ld.global.nc, cp.async into
a 4-stage ring, cp.async.bulk of row segments into an mbarrier ring), and
8.9 MB and 26.7 MB (gemv_int4's q_proj and w_fused bytes, codes and
scales) by 16-byte loads, and gemv_int4's q_proj and w_fused codes (4096-byte
rows) and the int8 MLP's gate and down codes contiguously and in the tile
pattern (64-row tiles of 128 bytes read 16 bytes a lane, as gemv4_ldg and
mlp8_ldg, or of 32 bytes read 4 bytes a lane, as gemv4_n32), as [us,
TB/s]; append: one decode step's cache append of a layer of serve (batch
1, Llama-2-7B's groups: K latents at rank 128 and V at 384, 8 groups, bf16,
the 3-bit sym cache in nibbles, S 8192) as the checkout's engine runs it
(one launch of ops/cache_append.KVAppend for both sides, or the two
one-side append_token_quantized calls before it), its device ms, L2 cold,
and host us; mlp8plans (a checkout with mlp8_ldg): each launch of the int8
MLP at 1 row on the plans of MLP8_SWEEP, (block warps, cluster, grid),
Llama-2-7B's and Qwen2-7B's widths, its device us. --only takes a comma
list of those groups (default: all).
Weights are random from seed 7, quantized on the card.

--timeline (a checkout with the streaming kernels only) adds per-block
stamps of the streaming kernels at the main-path shapes, 1 row: the
medians over blocks of the time to the first tile, the tile loop, the
cluster sums, and the end of the last block (us), from the kernels'
`tl` argument (ring::kStamps per block); and, in a checkout with the
register-streamed kernels, theirs (ldg::kStamps: first data, tiles, the
last block's tiles, the cluster exchange, output, end, and the SMs the
blocks ran on) with each launch's device time, for gemv4_ldg on the
plans of LDG4_PLANS, gemv4_n32, and gemv_bf16's gemv_kn on KN_PLANS,
with both kernels' cluster capacities.

--e2e adds the decode steps that reach these kernels, set up as the
checkout's chip_smoke sets up serve_w4 and lanes_w4 (Llama-2-7B at full
depth, int4 weights with int8 VT and embedding, random weights from its
seed): one decode step at batch 1 after a 7000-token prompt and 32 new
tokens, and at batch 8 after 1024-token prompts and 8 new tokens; then at
int8 weights (serve_w8's configuration, all 32 layers) at batch 1 after a
1000-token prompt and 8 new tokens. Each
reports wall ms, device busy ms (the sum of kernel durations,
torch.profiler) and the device's idle share per step, over 8 steps, with
the kernels that take the most device time."""
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))  # before main changes the directory
INT8 = {"vt_k": (4096, 1024), "vt_v": (4096, 3072), "q_proj": (4096, 4096),
        "w_fused": (12288, 4096), "lm_head": (4096, 32000)}
INT4 = {"q_proj": (4096, 4096), "w_fused": (12288, 4096), "lm_head": (4096, 32000)}
MLP = {"llama": (4096, 11008), "qwen2": (3584, 18944)}


def profile_call(fn, iters: int, flush, tries: int = 3) -> tuple:
    """(device ms, span ms) of one call of fn, L2 cold: the events of one
    profile cut at each flush kernel (a call's kernels follow its flush;
    events before the first recorded flush are dropped), means over the
    calls. The same cut as this checkout's tools/common.profile_calls, kept
    here because the tool imports the other checkout's package. A profile
    with no device events (seen now and then) is taken again; `tries` in a
    row raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in evs:
        if "bitwise_not" in e.name:  # the flush: the next call starts
            if cur and cur[1] is not None:
                calls.append(cur)
            cur = [0.0, None, None]
            continue
        if cur is None:
            continue
        cur[0] += e.time_range.end - e.time_range.start
        cur[1] = e.time_range.start if cur[1] is None else cur[1]
        cur[2] = e.time_range.end if cur[2] is None else max(cur[2], e.time_range.end)
    if cur and cur[1] is not None:
        calls.append(cur)
    if not calls:
        if tries > 1:
            return profile_call(fn, iters, flush, tries - 1)
        raise RuntimeError("torch.profiler recorded no device time")
    return (round(sum(c[0] for c in calls) / len(calls) / 1e3, 6),
            round(sum(c[2] - c[1] for c in calls) / len(calls) / 1e3, 6))


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
        flush.bitwise_not_()
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
        flush.bitwise_not_()
        build.check(build.launcher("gemv_int4", "palu_mlp_gemv_int4_stream", g4._STREAM_SIG)(
            x.data_ptr(), 1, h, inter, *[w[key].data_ptr() for w in ws for key in ("wq4", "ws")],
            hp.data_ptr(), *plans[0], *plans[1], out.data_ptr(), tl.data_ptr(),
            build.stream_ptr(dev)), "mlp_gemv_int4")
        torch.cuda.synchronize()
        t = tl.cpu().numpy()
        res[f"timeline_mlp_gemv_int4_{tag}"] = {
            "plans": plans, "gate_up": summary(t[:grids[0] * stamps], grids[0]),
            "down": summary(t[grids[0] * stamps:], grids[1])}


# register-streamed kernels' launches timed and stamped by --timeline:
# gemv4_ldg on these (cluster, clusters) plans, gemv4_n32 (one block per 32
# columns) and gemv_bf16's gemv_kn
LDG4_PLANS = {"q_proj": [(4, 32), (2, 32), (4, 16)], "w_fused": [(4, 32), (2, 32)],
              "lm_head": [(1, 250), (1, 132)]}
KN_PLANS = {"4096x4096": [(2, 64), (4, 62), (8, 30)], "12288x4096": [(2, 64), (8, 30)]}


def ldg_timeline(cs, res: dict, flush) -> None:
    """The register-streamed kernels' stamps (ldg::kStamps per block, 1
    row) and device times on the plans above, their cluster capacities,
    and the SMs their blocks ran on (a checkout that has them)."""
    import numpy as np
    import torch
    from palu_tpu_torch.ops import build
    from palu_tpu_torch.ops import gemv_int4 as g4
    from palu_tpu_torch.tools import gemv_probe as gp

    if not hasattr(g4, "gemv4_route"):
        return
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    res["ldg_capacity_gemv4_ldg"] = g4._device_ldg_capacity(dev)
    res["ldg_capacity_gemv_kn"] = gp._device_capacity(dev)

    def summary(t, grid):
        t = t.reshape(grid, 8).astype(np.float64)
        t0 = t[:, 0].min()
        med = lambda a, b: round(float(np.median(t[:, b] - t[:, a])) / 1e3, 3)  # noqa: E731
        sms = np.bincount(t[:, 7].astype(int))
        return {"blocks": grid, "first_data_us": med(0, 1), "tiles_us": med(1, 2),
                "last_tiles_done_us": round(float((t[:, 2] - t0).max()) / 1e3, 3),
                "exchange_us": med(3, 4), "out_us": med(4, 5),
                "end_us": round(float(t[:, 5].max() - t0) / 1e3, 3),
                "sms": int((sms > 0).sum()), "sms_with_2": int((sms > 1).sum())}

    def stamped(name, launch, grid):
        tl = torch.zeros(grid * 8, dtype=torch.int64, device="cuda")
        flush.bitwise_not_()
        launch(tl.data_ptr())
        torch.cuda.synchronize()
        res[name] = {"device_us": round(profile_call(lambda: launch(None), 20, flush)[0] * 1e3,
                                        3), **summary(tl.cpu().numpy(), grid)}

    ldg = build.launcher("gemv_int4", "palu_gemv_int4_ldg", "piiippiippp")
    n32 = build.launcher("gemv_int4", "palu_gemv_int4_n32", "piiippppp")
    for tag, plans in LDG4_PLANS.items():
        k, n = INT4[tag]
        w = cs._qweight(4, k, n, gen)
        x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
        out = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")
        args = (x.data_ptr(), 1, k, n, w["wq4"].data_ptr(), w["ws"].data_ptr())
        for c, ncl in plans:
            stamped(f"timeline_gemv4_ldg_{tag}_c{c}x{ncl}", lambda tl: build.check(
                ldg(*args, c, c * ncl, out.data_ptr(), tl, build.stream_ptr(dev)), "ldg"), c * ncl)
        if n // g4.N32_COLS <= g8_sms(dev):
            stamped(f"timeline_gemv4_n32_{tag}", lambda tl: build.check(
                n32(*args, out.data_ptr(), tl, build.stream_ptr(dev)), "n32"), n // g4.N32_COLS)
        del w
    kn = build.launcher("gemv_bf16", "gemv_bf16", "ppp" + "i" * 5 + "pp")
    for tag, plans in KN_PLANS.items():
        k, n = BF16[tag]
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
        x = (torch.randn((1, k), generator=gen, device="cuda") * 0.1).bfloat16()
        y = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")
        for c, ncl in plans:
            stamped(f"timeline_gemv_kn_{tag}_c{c}x{ncl}", lambda tl: build.check(
                kn(x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, k, n, c, c * ncl, tl,
                   build.stream_ptr(dev)), "gemv_kn"), c * ncl)
        del w


def g8_sms(dev) -> int:
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    del lanes
    torch.cuda.empty_cache()
    w8, _ = cs._engine(cfg, cs.W8)
    w8.generate(cs._prompts(3, (1000,))[0], max_new_tokens=8)
    res["e2e_serve_w8"] = step(w8)


BF16_T = {"4096x4096": (4096, 4096), "4096x1024": (4096, 1024), "12288x4096": (12288, 4096)}
BF16 = BF16_T  # W (K, N) at the same K x N
HADAMARD = ((4096, 256), (512, 256), (4096, 128), (4096, 352), (4096, 480), (4096, 512))
GROUPS = ("int8", "mlp", "int4", "bf16", "bf16t", "hadamard", "floor", "append", "mlp8plans")
# mlp8plans: (H, I), gate / up plans, down plans (down: 8-warp blocks)
MLP8_SWEEP = {"llama": ((4096, 11008),
                        [(16, 1, 86), (8, 1, 86), (8, 2, 172), (8, 4, 248), (8, 8, 240),
                         (8, 3, 237), (8, 5, 235), (8, 6, 234), (8, 7, 224)],
                        [(8, 7, 224), (8, 6, 192), (8, 4, 128), (8, 8, 240), (8, 2, 64)]),
              "qwen2": ((3584, 18944),
                        [(8, 1, 148), (8, 2, 264), (8, 3, 222), (8, 4, 248), (8, 8, 240)],
                        [(8, 8, 224), (8, 7, 196), (8, 4, 112)])}
# floor: (path, rows per block or stage, segment bytes, stages, blocks,
# rows streamed[, bytes a row: 8192 unless given]); path 0 ld.global.nc, 1 cp.async, 2
# cp.async.bulk, 3 gemv_int4's tile pattern (rows: the tile order, 1 row
# group major; segment: the bytes a lane loads, 16 as gemv4_ldg, 4 as
# gemv4_n32); 4096 rows are 33.5 MB, 1088 gemv_int4's q_proj (8.9 MB),
# 3264 its w_fused (26.7 MB)
FLOOR = {"ldg_528x256": (0, 0, 0, 0, 528, 4096), "ldg_2112x256": (0, 0, 0, 0, 2112, 4096),
         "cpasync_16x1KB": (1, 16, 1024, 4, 0, 4096), "cpasync_8x2KB": (1, 8, 2048, 4, 0, 4096),
         "bulk_16x512B_s6": (2, 16, 512, 6, 0, 4096), "bulk_16x1KB_s4": (2, 16, 1024, 4, 0, 4096),
         "bulk_8x4KB_s2": (2, 8, 4096, 2, 0, 4096), "bulk_1x8KB_s4": (2, 1, 8192, 4, 0, 4096),
         "bulk_64x128B_s4": (2, 64, 128, 4, 0, 4096),
         "ldg_528x256_8.9MB": (0, 0, 0, 0, 528, 1088),
         "ldg_2112x256_8.9MB": (0, 0, 0, 0, 2112, 1088),
         "ldg_528x256_26.7MB": (0, 0, 0, 0, 528, 3264),
         "ldg_2112x256_26.7MB": (0, 0, 0, 0, 2112, 3264),
         # gemv_int4's codes at their own geometry (4096-byte rows): q_proj
         # 2048 rows (8.4 MB), w_fused 6144 (25.2 MB), read contiguously and
         # in its tile pattern
         "ldg_2112x256_q_proj": (0, 0, 0, 0, 2112, 2048, 4096),
         "tiles_w16_264_q_proj": (3, 1, 16, 0, 264, 2048, 4096),
         "tiles_w4_264_q_proj": (3, 1, 4, 0, 264, 2048, 4096),
         "ldg_2112x256_w_fused": (0, 0, 0, 0, 2112, 6144, 4096),
         "tiles_w16_264_w_fused": (3, 1, 16, 0, 264, 6144, 4096),
         "tiles_w4_264_w_fused": (3, 1, 4, 0, 264, 6144, 4096),
         # the int8 MLP's weights (Llama-2-7B): gate or up (4096 rows of 11008
         # bytes) and down (11008 rows of 4096 bytes), 45.1 MB each,
         # contiguously and in mlp8_ldg's tile pattern (64-row tiles of 128
         # bytes read 16 bytes a lane)
         "ldg_2112x256_mlp_gate": (0, 0, 0, 0, 2112, 4096, 11008),
         "tiles_w16_264_mlp_gate": (3, 1, 16, 0, 264, 4096, 11008),
         "ldg_2112x256_mlp_down": (0, 0, 0, 0, 2112, 11008, 4096),
         "tiles_w16_264_mlp_down": (3, 1, 16, 0, 264, 11008, 4096)}


def floor(res: dict, flush) -> None:
    """The floor group (module docstring)."""
    import ctypes
    import subprocess
    import tempfile

    import torch
    src = os.path.join(_HERE, "..", "csrc", "stream_floor.cu")
    lib_path = os.path.join(tempfile.mkdtemp(), "stream_floor.so")
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stream_floor.argtypes = [i, p, i, i, i, i, i, i, p, p]
    shapes = {(v[5], v[6] if len(v) > 6 else 8192) for v in FLOOR.values()}
    ws = {(rows, rb): torch.randint(0, 255, (rows, rb), dtype=torch.uint8, device="cuda")
          for rows, rb in sorted(shapes)}
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (path, r, seg, stages, blocks, rows, *rest) in FLOOR.items():
        rb = rest[0] if rest else 8192
        w = ws[(rows, rb)]

        def call():
            err = lib.stream_floor(path, w.data_ptr(), rows, rb, r, seg, stages, blocks,
                                   sink.data_ptr(), stream)
            if err:
                raise RuntimeError(f"stream_floor {name}: CUDA error {err}")
        ms = profile_call(call, 30, flush)[0]
        res[f"floor_{name}"] = [ms * 1e3, w.numel() / (ms * 1e-3) / 1e12]


def append(cs, res: dict, gen, flush, host) -> None:
    """The append group (module docstring)."""
    import torch

    pos = torch.tensor([4099], dtype=torch.int32, device="cuda")
    wr = torch.tensor([True], device="cuda")
    sides = []
    for rank in (cs.RK, cs.RV):
        nrows = cs.packed_nrows(rank, cs.FLAGSHIP.pack_bits)
        sides.append((rank, torch.randn((1, cs.G, rank), generator=gen, device="cuda").bfloat16(),
                      torch.randint(0, 256, (1, cs.G, nrows, 8192), generator=gen,
                                    device="cuda", dtype=torch.uint8),
                      torch.rand((1, cs.G, 1, 8192), generator=gen, device="cuda")))
    if hasattr(cs, "KVAppend"):  # one launch a layer for both sides
        layer = cs.KVAppend([{"codes_t": c, "scale_t": s} for _, _, c, s in sides],
                            [r for r, _, _, _ in sides], qcfg=cs.FLAGSHIP)
        lats = [lat for _, lat, _, _ in sides]

        def call():
            layer(lats, pos, wr)
    else:  # the two one-side calls of the engine before it
        def call():
            for rank, lat, codes, scale in sides:
                cs.append_token_quantized(lat, codes, scale, pos, wr, qcfg=cs.FLAGSHIP,
                                          rank=rank)
    res["append_layer"] = profile_call(call, 50, flush)
    host("append_layer", call)


def mlp8_plans(cs, res: dict, gen, flush) -> None:
    """The mlp8plans group (module docstring): each launch timed alone,
    the other on the first plan of its list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from palu_tpu_torch.ops import build
    from palu_tpu_torch.ops import gemv_int8 as g8

    dev = torch.device("cuda")
    fn = build.launcher("gemv_int8", "palu_mlp_gemv_int8_ldg", g8.MLP8_SIG)

    def per_launch(call, iters=20):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                call()
            torch.cuda.synchronize()
        us = {"gate_up": [], "down": []}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "mlp8_ldg" in e.name:
                kind = "gate_up" if "mlp8_ldg<2" in e.name else "down"
                us[kind].append(e.time_range.end - e.time_range.start)
        return {k: round(sum(v) / len(v), 2) for k, v in us.items() if v}

    for tag, ((h, inter), gus, dns) in MLP8_SWEEP.items():
        ws = [cs._qweight(8, h, inter, gen), cs._qweight(8, h, inter, gen),
              cs._qweight(8, inter, h, gen)]
        ptrs = [t.data_ptr() for w in ws for t in (w["wq8"], w["ws"])]
        x = torch.randn((1, h), generator=gen, device="cuda").bfloat16()
        hb = torch.empty((1, inter), dtype=torch.bfloat16, device="cuda")
        out = torch.empty((1, h), dtype=torch.bfloat16, device="cuda")
        for which, plans in (("gate_up", gus), ("down", dns)):
            for plan in plans:
                p1 = plan if which == "gate_up" else gus[0]
                p2 = plan[1:] if which == "down" else dns[0][1:]

                def call():
                    build.check(fn(x.data_ptr(), 1, h, inter, *ptrs, hb.data_ptr(), *p1, *p2,
                                   out.data_ptr(), build.stream_ptr(dev)), "mlp8_ldg")
                key = f"mlp8_{tag}_{which}_w{plan[0]}_c{plan[1]}x{plan[2] // plan[1]}"
                res[key] = per_launch(call)[which]
        del ws


def main(root: str, tag: str, with_timeline: bool, with_e2e: bool, only=GROUPS) -> None:
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

    for name, (k, n) in INT8.items() if "int8" in only else ():
        w = cs._qweight(8, k, n, gen)
        for r, x in rows_of(k).items():
            t(f"gemv_int8_{name}_r{r}", lambda: cs.gemv_int8(x, w))
            if name in ("vt_k", "q_proj"):
                host(f"gemv_int8_{name}_r{r}", lambda: cs.gemv_int8(x, w))
        del w
    for name, (h, inter) in MLP.items() if "mlp" in only else ():
        for bits, fn in ((4, cs.mlp_gemv_int4), (8, cs.mlp_gemv_int8)):
            ws = [cs._qweight(bits, h, inter, gen), cs._qweight(bits, h, inter, gen),
                  cs._qweight(bits, inter, h, gen)]
            for r, x in rows_of(h).items():
                t(f"mlp_gemv_int{bits}_{name}_r{r}", lambda: fn(x, *ws))
                if bits == 4:
                    host(f"mlp_gemv_int4_{name}_r{r}", lambda: fn(x, *ws))
            del ws
    for name, (k, n) in INT4.items() if "int4" in only else ():
        w = cs._qweight(4, k, n, gen)
        lib, _ = cs._int_library(w)
        for r, x in rows_of(k).items():
            t(f"gemv_int4_{name}_r{r}", lambda: cs.gemv_int4(x, w))
            if lib is not None:
                t(f"gemv_int4_{name}_r{r}_int4pack", lambda: lib(x))
            if name == "q_proj":
                host(f"gemv_int4_{name}_r{r}", lambda: cs.gemv_int4(x, w))
        del w, lib
    for name, (k, n) in BF16.items() if "bf16" in only else ():
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
        for r, x in rows_of(k).items():
            t(f"gemv_bf16_{name}_r{r}", lambda: cs.gemv_probe.gemv_bf16(x, w))
            t(f"gemv_bf16_{name}_r{r}_matmul", lambda: torch.matmul(x, w))
        del w
    for name, (k, n) in BF16_T.items() if "bf16t" in only else ():
        wt = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
        for r, x in rows_of(k).items():
            t(f"gemv_bf16_t_{name}_r{r}", lambda: cs.gemv_probe.gemv_bf16_t(x, wt))
            t(f"gemv_bf16_t_{name}_r{r}_F.linear", lambda: torch.nn.functional.linear(x, wt))
        del wt
    for rows, n in HADAMARD if "hadamard" in only else ():
        h32 = torch.from_numpy(cs.full_hadamard_matrix(n)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
            h = h32.to(dt)
            t(f"hadamard_{rows}x{n}_{str(dt)[6:]}", lambda: cs.hadamard_transform(x), 50)
            t(f"hadamard_{rows}x{n}_{str(dt)[6:]}_matmul", lambda: torch.matmul(x, h.T), 50)
            t(f"hadamard_{rows}x{n}_{str(dt)[6:]}_clone", lambda: x.clone(), 50)
    if "floor" in only:
        floor(res, flush)
    if "append" in only:
        append(cs, res, gen, flush, host)
    if "mlp8plans" in only:
        mlp8_plans(cs, res, gen, flush)
    if with_timeline:
        timeline(cs, res, flush)
        ldg_timeline(cs, res, flush)
    del flush
    if with_e2e:
        e2e(cs, res)
    print(json.dumps({"ab": tag, "root": root, "device": torch.cuda.get_device_name(0),
                      "seconds": round(time.perf_counter() - t0, 1), **res}), flush=True)


if __name__ == "__main__":
    opts = [a.split("=", 1)[1].split(",") for a in sys.argv[3:] if a.startswith("--only=")]
    if opts and not set(opts[-1]) <= set(GROUPS):
        raise SystemExit(f"--only takes groups of {GROUPS}, got {opts[-1]}")
    main(sys.argv[1], sys.argv[2], "--timeline" in sys.argv[3:], "--e2e" in sys.argv[3:],
         tuple(opts[-1]) if opts else GROUPS)
