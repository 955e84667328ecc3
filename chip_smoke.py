#!/usr/bin/env python3
"""Drive palu_tpu_torch on one NVIDIA GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - the card (nvidia-smi name and power limit), TF32 off;
  2. build    - nvcc builds every kernel of the main path from csrc/;
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the main path's shapes (7B widths), with the device times
                (torch.profiler, L2 cold) of the kernel, the plain version
                and, where one PyTorch call computes the same function, that
                call;
  4. e2e      - a 2-layer model at 7B widths: one 2048-token request and 16
                teacher-forced decode steps through the kernels (bf16) on the
                card, against the same run on the CPU (plain versions, f32);
  5. serve    - the main path at full depth: a 32-layer Llama-2-7B-width
                Palu model (random weights from a seed, 3-bit latents in
                nibble containers) answers three requests (1000 / 3000 /
                7000-token prompts, 32 new tokens each) through
                Engine.generate, with the launch counters reset just before
                and read just after; then where the time of one decode step
                and of one 7000-token prefill goes (torch.profiler);
then the nvidia-smi line, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from palu_tpu_torch.core.quant import QuantConfig, packed_nrows, pack_codes_t, quantize_affine
from palu_tpu_torch.models import llama
from palu_tpu_torch.models.config import ModelConfig
from palu_tpu_torch.ops import build
from palu_tpu_torch.ops.cache_append import append_token_quantized, append_token_quantized_ref
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.ops.prefill_flash import prefill_flash, prefill_flash_ref
from palu_tpu_torch.runtime.cache import cache_nbytes
from palu_tpu_torch.runtime.engine import Engine, EngineConfig

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, for each kernel's bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Tolerances, as a share of max|plain|.
# Decode returns f32 and computes in f32 from bf16 weights and integer
# codes; the plain version runs the same math in f32 in another order: the
# bf16-class bound of the JAX kernels' own parity check (docs/PARITY.md
# item 5) is 2e-3.
DECODE_TOL = 2e-3
# Prefill returns bf16 (as the JAX kernel does) and feeds P to the second
# product in bf16: the 2e-3 class plus half a bf16 ulp of output rounding
# (2^-9 of a value), against the plain version in f32.
PREFILL_TOL = 2e-3 + 2.0**-9
# End to end, bf16 on the card against f32 on the CPU (same bf16-rounded
# weights): every projection, norm and residual rounds to bf16, and ~2% of
# latents land across a 3-bit quantization boundary and take the
# neighbouring code. The same comparison between the port's plain paths in
# bf16 and in f32 on the CPU, at hidden 1024, gives 3-4e-2 of max|logits|
# per step, while halving the decode attention output moves the logits by
# ~0.3. 0.1 of max|logits| passes the first and fails the second.
E2E_TOL = 0.1

FLAGSHIP = QuantConfig(bits=3, group_size=0, sym=True, container=4)
G, HPG, RK, RV, HD, NH = 8, 4, 128, 384, 128, 32  # Llama-2-7B, Palu group 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def llama7b(layers: int) -> ModelConfig:
    """Llama-2-7B widths with Palu head groups of 4 and per-group ranks
    128 (K) / 384 (V): rank_k 1024, rank_v 3072 in total."""
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [RK] * G
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [RV] * G
    return ModelConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                       num_hidden_layers=layers, num_attention_heads=NH,
                       num_key_value_heads=NH, head_group_size=4, head_wise_ranks=ranks)


_FLUSH = None


def device_ms(fn, iters: int) -> float:
    """Device time of one call of fn: the kernel time torch.profiler sums
    over `iters` calls, each after a 64 MB write that leaves L2 (50 MB)
    cold as a layer's call inside a model step finds it, less the writes'
    own time measured alone. Host time between launches is not counted."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()

    def kernel_ms(with_fn: bool) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _FLUSH.zero_()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in _device_events(prof)) / 1e3

    return (kernel_ms(True) - kernel_ms(False)) / iters


def _device_events(prof):
    """The profiler's device-side rows (kernels, copies, memsets), so that
    time the host ops own is not counted twice."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    per = build.build_all()
    regs = {}
    for name in build.SOURCES:
        log = build._lib_path(name).with_suffix(".log")
        if log.exists():
            regs[name] = [l.strip() for l in log.read_text().splitlines()
                          if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in per.items()}, "ptxas": regs})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _append_case(qcfg: QuantConfig, rank: int, b: int, s_max: int, gen):
    nrows = packed_nrows(rank, qcfg.pack_bits)
    codes = torch.randint(0, 256, (b, G, nrows, s_max), generator=gen, device="cuda",
                          dtype=torch.uint8)
    scale = torch.rand((b, G, 1, s_max), generator=gen, device="cuda")
    zero = None if qcfg.sym else torch.randn((b, G, 1, s_max), generator=gen, device="cuda")
    lat = torch.randn((b, G, rank), generator=gen, device="cuda").to(torch.bfloat16)
    return lat, codes, scale, zero


def check_append(gen) -> dict:
    s_max, worst, cases = 8192, 0.0, 0
    pos = torch.tensor([4099, 8191], dtype=torch.int32, device="cuda")
    wr = torch.tensor([True, False], device="cuda")  # lane 1 must keep its bytes
    for qcfg in (FLAGSHIP, QuantConfig(bits=3, sym=False, container=4),
                 QuantConfig(bits=2, sym=True), QuantConfig(bits=8, sym=False)):
        for rank in (RK, RV):
            lat, codes, scale, zero = _append_case(qcfg, rank, 2, s_max, gen)
            ref = [t.clone() if t is not None else None for t in (codes, scale, zero)]
            before = codes.clone()
            append_token_quantized(lat, codes, scale, pos, wr, qcfg=qcfg, rank=rank, zero=zero)
            append_token_quantized_ref(lat, ref[0], ref[1], pos, wr, qcfg=qcfg, rank=rank,
                                       zero=ref[2])
            torch.cuda.synchronize()
            for got, want in zip((codes, scale, zero), ref):
                if got is not None and not torch.equal(got, want):
                    raise AssertionError(f"append not bit-exact for {qcfg} rank {rank}")
            if not torch.equal(codes[1], before[1]) or torch.equal(codes[0], before[0]):
                raise AssertionError("append wrote a masked lane or skipped a live one")
            cases += 1

    # times at the main path's shapes: batch 1, one K-side and one V-side call
    pos1 = torch.tensor([4099], dtype=torch.int32, device="cuda")
    wr1 = torch.tensor([True], device="cuda")
    sides = [(r, _append_case(FLAGSHIP, r, 1, s_max, gen)) for r in (RK, RV)]

    def run(fn):
        def go():
            for r, (lat, codes, scale, _) in sides:
                fn(lat, codes, scale, pos1, wr1, qcfg=FLAGSHIP, rank=r)
        return go

    ms = device_ms(run(append_token_quantized), 50) / 2
    plain_ms = device_ms(run(append_token_quantized_ref), 10) / 2
    nbytes = sum(G * (r * 2 + packed_nrows(r, 4) + 4) + 8 for r in (RK, RV)) / 2
    flops = sum(G * r * 6 for r in (RK, RV)) / 2
    bms, by = bound_ms(nbytes, flops)
    out = {"name": "cache_append", "route": "cuda",
           "source": "palu_tpu_torch/csrc/cache_append.cu",
           "replaces": "palu_tpu/ops/pallas/cache_append.py:136",
           "max_abs_err": worst, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit({"phase": "kernel", "cases": cases, "bit_exact": True, **out})
    return out


def _decode_inputs(qcfg: QuantConfig, b: int, g: int, hpg: int, s_max: int, gen):
    q = torch.randn((b, g * hpg, HD), generator=gen, device="cuda").to(torch.bfloat16)
    b_k = (torch.randn((g, hpg, RK, HD), generator=gen, device="cuda")
           / math.sqrt(RK)).to(torch.bfloat16)
    bufs = {}
    for side, r in (("k", RK), ("v", RV)):
        lat = torch.randn((b, g, s_max, r), generator=gen, device="cuda")
        codes, scales, zeros = quantize_affine(lat, qcfg)
        bufs[f"x{side}_codes"] = pack_codes_t(codes, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = scales[..., 0].contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = zeros[..., 0].contiguous()
    return q, b_k, bufs


def check_decode(gen) -> dict:
    s_max, worst_rel, worst_abs, cases = 8192, 0.0, 0.0, 0
    specs = [  # (qcfg, kv_len per lane, window, heads per group)
        (QuantConfig(bits=3, sym=True), (1, 777), None, HPG),
        (QuantConfig(bits=3, sym=False), (777, 8192), None, HPG),
        (FLAGSHIP, (8192, 1), None, HPG),
        (QuantConfig(bits=4, sym=False), (1, 8192), None, HPG),
        (QuantConfig(bits=4, sym=True), (777, 8192), None, HPG),
        (FLAGSHIP, (777, 8192), 1024, HPG),  # sliding window
        (FLAGSHIP, (777, 8192), None, 16),   # GQA: nh 32 over nkv 8 -> 2 groups of 16
    ]
    for qcfg, kvl, window, hpg in specs:
        g = NH // hpg
        q, b_k, bufs = _decode_inputs(qcfg, 2, g, hpg, s_max, gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        kw = dict(qcfg=qcfg, rk=RK, rv=RV, sliding_window=window)
        got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
        want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (torch.isfinite(got).all() and rel <= DECODE_TOL):
            raise AssertionError(f"decode {qcfg} kv {kvl} window {window} hpg {hpg}: "
                                 f"rel err {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        cases += 1

    # times at the main path's shape: batch 1, the flagship cache full to 8192
    q, b_k, bufs = _decode_inputs(FLAGSHIP, 1, G, HPG, s_max, gen)
    kv_len = torch.tensor([s_max], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=FLAGSHIP, rk=RK, rv=RV)
    ms = device_ms(lambda: palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw), 20)
    plain_ms = device_ms(lambda: palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw), 3)
    n = s_max
    nbytes = (sum(t.numel() * t.element_size() for t in bufs.values())
              + q.numel() * 2 + b_k.numel() * 2 + NH * RV * 4)
    # K reconstruct + logits + P.V, per head per token
    flops = 2 * NH * n * (RK * HD + HD + RV)
    bms, by = bound_ms(nbytes, flops)
    out = {"name": "palu_decode", "route": "cuda",
           "source": "palu_tpu_torch/csrc/palu_decode.cu",
           "replaces": "palu_tpu/ops/pallas/palu_decode4.py:899",
           "max_abs_err": worst_abs, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit({"phase": "kernel", "cases": cases, "max_rel_err": worst_rel, "tol": DECODE_TOL,
          "bytes": nbytes, "flops": flops, **out})
    return out


def _prefill_inputs(b, nh, nkv, cq, s, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return rnd(b, nh, cq, HD), rnd(b, nkv, s, HD), rnd(b, nkv, s, HD)


def check_prefill(gen) -> dict:
    cq, worst_rel, worst_abs, cases = 512, 0.0, 0.0, 0
    off = torch.tensor([0, 3584], dtype=torch.int32, device="cuda")
    kvl = off + cq
    for nkv, window in ((NH, None), (8, None), (NH, 1024)):
        q, k, v = _prefill_inputs(2, NH, nkv, cq, 4096, gen)
        got = prefill_flash(q, k, v, off, kvl, sliding_window=window)
        want = prefill_flash_ref(q.float(), k.float(), v.float(), off, kvl,
                                 sliding_window=window)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (torch.isfinite(got).all() and rel <= PREFILL_TOL):
            raise AssertionError(f"prefill nkv {nkv} window {window}: rel err {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        cases += 1

    # times at the main path's shape: the 512-row chunk at offset 3584
    q, k, v = _prefill_inputs(1, NH, NH, cq, 4096, gen)
    o1 = torch.tensor([3584], dtype=torch.int32, device="cuda")
    k1 = o1 + cq
    ms = device_ms(lambda: prefill_flash(q, k, v, o1, k1), 20)
    plain_ms = device_ms(lambda: prefill_flash_ref(q, k, v, o1, k1), 3)
    pos = torch.arange(4096, device="cuda")
    mask = pos[None, :] <= (3584 + torch.arange(cq, device="cuda"))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: sdpa(q, k, v, attn_mask=mask), 20)
    pairs = sum(3584 + i + 1 for i in range(cq))
    flops = 4 * NH * HD * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(nbytes, flops)
    out = {"name": "prefill_flash", "route": "cuda",
           "source": "palu_tpu_torch/csrc/prefill_flash.cu",
           "replaces": "palu_tpu/ops/pallas/prefill_flash.py:257",
           "max_abs_err": worst_abs, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    emit({"phase": "kernel", "cases": cases, "max_rel_err": worst_rel, "tol": PREFILL_TOL,
          "bytes": nbytes, "flops": flops, **out})
    return out


# ---------------------------------------------------------------------------
# 4. end-to-end parity, 2 layers at full width
# ---------------------------------------------------------------------------


def _stepwise(eng, ids, forced):
    logits, cache = eng.prefill_chunked(ids, chunk_size=512)
    out = [logits.float().cpu()]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int64), cache)
        out.append(logits.float().cpu())
    return torch.cat(out, dim=1), cache


def phase_e2e() -> None:
    cfg = llama7b(2)
    params = _tree_to(llama.init_params(cfg, torch.Generator().manual_seed(0)), "cpu",
                      torch.bfloat16)
    params_gpu = _tree_to(params, "cuda", torch.bfloat16)
    params_cpu = _tree_to(params, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (1, 2048))
    forced = rng.integers(0, cfg.vocab_size, 16)
    ecfg = EngineConfig(s_max=4096, batch=1, qcfg=FLAGSHIP, decode_chunk=512)
    gpu = Engine(params_gpu, cfg, ecfg)
    t0 = time.perf_counter()
    got, gcache = _stepwise(gpu, ids, forced)
    gpu_s = time.perf_counter() - t0
    cpu = Engine(params_cpu, cfg, dataclasses.replace(ecfg, dtype=torch.float32, device="cpu"))
    t0 = time.perf_counter()
    want, ccache = _stepwise(cpu, ids, forced)
    cpu_s = time.perf_counter() - t0
    rel = ((got - want).abs().max() / want.abs().max()).item()
    diff = total = 0
    for gl, cl in zip(gcache["layers"], ccache["layers"]):
        for side in ("k", "v"):
            diff += int((gl[side]["codes_t"].cpu() != cl[side]["codes_t"]).sum())
            total += cl[side]["codes_t"].numel()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit({"phase": "e2e", "layers": 2, "prompt": 2048, "steps": 16,
          "max_rel_err": rel, "tol": E2E_TOL, "top1_agreement": top1,
          "cache_code_bytes_differing": diff, "cache_code_bytes": total,
          "gpu_decode_paths": sorted(gpu._decode_paths),
          "cpu_decode_paths": sorted(cpu._decode_paths),
          "gpu_s": gpu_s, "cpu_s": cpu_s})
    if not (torch.isfinite(got).all() and rel <= E2E_TOL):
        raise AssertionError(f"end-to-end logits rel err {rel} > {E2E_TOL}")
    if gpu._decode_paths != {"palu_decode-kernel"}:
        raise AssertionError(f"GPU engine took {gpu._decode_paths}")


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return None if tree is None else tree.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# 5. the main path at full depth
# ---------------------------------------------------------------------------


class _CheckedEngine(Engine):
    """Engine that records, without a host sync, whether every logits
    tensor it returns is finite, and times its prefills."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.finite = []
        self.prefill_s = []
        self.last_cache = None

    def prefill_auto(self, input_ids, cache=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = super().prefill_auto(input_ids, cache)
        torch.cuda.synchronize()
        self.prefill_s.append(time.perf_counter() - t0)
        self.finite.append(torch.isfinite(logits).all())
        self.last_cache = cache
        return logits, cache

    def decode(self, token_ids, cache, active=None):
        logits, cache = super().decode(token_ids, cache, active)
        self.finite.append(torch.isfinite(logits).all())
        return logits, cache


def phase_serve() -> dict:
    cfg = llama7b(32)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = _CheckedEngine(params, cfg, EngineConfig(s_max=8192, batch=1, decode_chunk=512,
                                                   qcfg=FLAGSHIP))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (1000, 3000, 7000)]
    new_tokens = 32
    counters = (append_token_quantized, palu_decode, prefill_flash)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    requests = []
    for ids in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.generate(ids, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        prefill_s = eng.prefill_s[-1]
        requests.append({"prompt": ids.shape[1], "new_tokens": int(toks.shape[1]),
                         "prefill_s": prefill_s,
                         "decode_ms_per_token": (total_s - prefill_s) / new_tokens * 1e3,
                         "cache_nbytes": cache_nbytes(eng.last_cache)})
    launches = {fn.__name__: fn.launches for fn in counters}
    steps = new_tokens * len(prompts)
    finite = bool(torch.stack(eng.finite).all().item())
    emit({"phase": "serve", "model": "Llama-2-7B widths, 32 layers, bf16, random (seed 0)",
          "qcfg": dataclasses.asdict(FLAGSHIP), "init_s": init_s, "requests": requests,
          "decode_steps": steps, "launches": launches, "logits_finite": finite,
          "decode_paths": sorted(eng._decode_paths),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if not finite:
        raise AssertionError("non-finite logits on the main path")
    if eng._decode_paths != {"palu_decode-kernel"}:
        raise AssertionError(f"main path took {eng._decode_paths}")
    want = {"palu_decode": cfg.num_hidden_layers * steps,
            "append_token_quantized": 2 * cfg.num_hidden_layers * steps}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {n}")
    if launches["prefill_flash"] <= 0:
        raise AssertionError("prefill_flash never launched")
    decode_breakdown(eng)
    prefill_breakdown(eng, prompts[-1])
    return launches


def _breakdown(prof, wall_ms: float, per: int) -> dict:
    kernels = [(e.key, e.self_device_time_total / 1e3 / per, e.count // per)
               for e in _device_events(prof)]
    busy_ms = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": sum(k[2] for k in kernels),
            "top": [{"kernel": k[0][:80], "ms": k[1], "launches": k[2]} for k in top]}


def prefill_breakdown(eng, ids) -> None:
    """Where one prefill's time goes (the last request's prompt again):
    wall time, device busy time, idle share, and the top kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.prefill_auto(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "prefill_breakdown", "prompt": ids.shape[1],
          **_breakdown(prof, wall_ms, 1)})


def decode_breakdown(eng, steps: int = 4) -> None:
    """Where one decode step's time goes at the last request's context:
    wall time per step, device busy time (kernels, torch.profiler), the
    device's idle share, and the kernels that take the most device time."""
    cache = eng.last_cache
    tok = np.zeros((1, 1), np.int64)
    eng.decode(tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode(tok, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    emit({"phase": "decode_breakdown", "context": int(cache["length"][0]),
          "per": "step", **_breakdown(prof, wall_ms, steps)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    kernels = [check_append(gen), check_decode(gen), check_prefill(gen)]
    phase_e2e()
    launches = phase_serve()
    names = {"cache_append": "append_token_quantized", "palu_decode": "palu_decode",
             "prefill_flash": "prefill_flash"}
    for k in kernels:
        k["launches"] = launches[names[k["name"]]]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
