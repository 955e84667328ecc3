#!/usr/bin/env python3
"""Drive palu_tpu_torch on one NVIDIA GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - the card (nvidia-smi name and power limit), TF32 off;
  2. build    - nvcc builds every kernel from csrc/, all sources at once;
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the main path's shapes (7B widths), with the device times
                (torch.profiler, L2 cold) of the kernel, the plain version
                and a PyTorch yardstick (for the GEMVs: the dense bf16
                product that weight quantization replaces, and PyTorch's
                own int4 / int8 weight-only call where the card's torch
                has one), and for the GEMVs the host time of one call;
  4. e2e      - a 2-layer model at 7B widths: one 2048-token request and 16
                teacher-forced decode steps through the kernels (bf16) on the
                card, against the same run on the CPU (plain versions, f32);
     e2e_w4   - the same under weight_bits=4, vt_bits=8, embed_bits=8; the
                card's quantized codes and scales must equal the CPU's;
     e2e_w8   - the same under weight_bits=8, vt_bits=8, embed_bits=8;
  5. serve    - the main path at full depth: a 32-layer Llama-2-7B-width
                Palu model (random weights from a seed, 3-bit latents in
                nibble containers) answers three requests (1000 / 3000 /
                7000-token prompts, 32 new tokens each) through
                Engine.generate, with the launch counters reset just before
                and read just after; then where the time of one decode step
                and of one 7000-token prefill goes (torch.profiler);
     serve_w4 - the same model and traffic under the README's configuration
                (int4 weights, int8 VT and embedding) with exact GEMV launch
                counts per step, and its two breakdowns;
     lanes_w4 - that engine at batch 8 (the GEMV kernels' 8-row edge);
     serve_w8 - int8 weights, 4 layers at full width, one request;
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

from palu_tpu_torch.core import wquant
from palu_tpu_torch.core.quant import QuantConfig, packed_nrows, pack_codes_t, quantize_affine
from palu_tpu_torch.models import llama
from palu_tpu_torch.models.config import ModelConfig
from palu_tpu_torch.ops import build
from palu_tpu_torch.ops.cache_append import append_token_quantized, append_token_quantized_ref
from palu_tpu_torch.ops.gemv_int4 import (gemv_int4, gemv_int4_ref, mlp_gemv_int4,
                                          mlp_gemv_int4_ref)
from palu_tpu_torch.ops.gemv_int8 import (gemv_int8, gemv_int8_ref, mlp_gemv_int8,
                                          mlp_gemv_int8_ref)
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
# GEMVs return bf16 like their plain versions, which compute in f32 from
# the same codes: one bf16 rounding of the output apart (2^-8 of a value),
# plus the bf16 rounding of the MLP's h; 2^-7 of max|plain|.
GEMV_TOL = 2.0**-7

FLAGSHIP = QuantConfig(bits=3, group_size=0, sym=True, container=4)
G, HPG, RK, RV, HD, NH = 8, 4, 128, 384, 128, 32  # Llama-2-7B, Palu group 4
HID, INTER, VOCAB, LAYERS = 4096, 11008, 32000, 32
W4 = dict(weight_bits=4, vt_bits=8, embed_bits=8)  # the README's configuration
W8 = dict(weight_bits=8, vt_bits=8, embed_bits=8)
COUNTERS = (append_token_quantized, palu_decode, prefill_flash, gemv_int4, mlp_gemv_int4,
            gemv_int8, mlp_gemv_int8)


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


def _qweight(bits: int, k: int, n: int, gen):
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    return wquant.quantize_weight4(w) if bits == 4 else wquant.quantize_weight(w)


def _dense(w) -> torch.Tensor:
    """The dense bf16 weight that a quantized one replaces (yardstick only)."""
    if "wq4" in w:
        return wquant.unpack_weight4(w).to(torch.bfloat16)
    return (w["wq8"].float() * w["ws"]).to(torch.bfloat16)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def host_us(fn, iters: int = 100) -> dict:
    """Host time of one call of fn in microseconds: `iters` calls issued
    while a sleep kernel holds the device, so that no call waits for it.
    `device_woke` says the sleep ended before the last call was issued
    (then `us` is an upper bound)."""
    fn()
    torch.cuda.synchronize()
    asleep = torch.cuda.Event()
    torch.cuda._sleep(1 << 30)  # ~0.5 s at the H100's 1.98 GHz
    asleep.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    woke = asleep.query()
    torch.cuda.synchronize()
    return {"us": t / iters * 1e6, "device_woke": woke}


def _has_cuda_kernel(op: str) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{op}", "CUDA")


def _int_library(w):
    """A PyTorch call computing the same weight-only product from integer
    codes, where the card's torch has one: (fn of x, name), else (None,
    why). Yardstick only, never on the path. int4: `_weight_int4pack_mm`
    on the codes repacked to its layout (zero 0, scales rounded to bf16);
    int8: `_weight_int8pack_mm` on the (N, K) codes."""
    if "wq4" in w:
        if not _has_cuda_kernel("_weight_int4pack_mm"):
            return None, "torch._weight_int4pack_mm has no CUDA kernel in this torch"
        k2, n = w["wq4"].shape
        u = w["wq4"].reshape(2 * k2 // 128, 64, n)
        codes = torch.cat([u & 0xF, u >> 4], dim=1).reshape(2 * k2, n).t().contiguous()
        packed = torch._convert_weight_to_int4pack(codes[:, ::2] << 4 | codes[:, 1::2], 8)
        sz = torch.stack([w["ws"], torch.zeros_like(w["ws"])], dim=-1).to(torch.bfloat16)
        return (lambda x: torch._weight_int4pack_mm(x, packed, 128, sz),
                "torch._weight_int4pack_mm (bf16 scales)")
    if not _has_cuda_kernel("_weight_int8pack_mm"):
        return None, "torch._weight_int8pack_mm has no CUDA kernel in this torch"
    wt = w["wq8"].t().contiguous()  # (N, K); the tied head's codes are this already
    s = w["ws"].reshape(-1).to(torch.bfloat16)
    return (lambda x: torch._weight_int8pack_mm(x, wt, s),
            "torch._weight_int8pack_mm (bf16 scales)")


def _held(name, got, want) -> tuple:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    if not (torch.isfinite(got).all() and got.dtype == want.dtype and rel <= GEMV_TOL):
        raise AssertionError(f"{name}: rel err {rel} > {GEMV_TOL}")
    return err, rel


def _kernel_line(name, bits, cases, mix, per, worst_abs, worst_rel, host) -> dict:
    """Per-launch numbers on the main path at batch 1: each case's time
    weighted by its launches per decode step (`mix`)."""
    total = sum(mix.values())

    def avg(key):
        return sum(per[c][key] * m for c, m in mix.items()) / total

    nbytes, flops = avg("bytes"), avg("flops")
    bms, by = bound_ms(nbytes, flops)
    src = f"gemv_int{bits}"
    line = {"name": name, "route": "cuda", "source": f"palu_tpu_torch/csrc/{src}.cu",
            "replaces": f"palu_tpu/ops/pallas/{src}.py:{cases}",
            "max_abs_err": worst_abs, "ms": avg("ms"), "kernel_ms": avg("ms"),
            "plain_ms": avg("plain_ms"), "bound_ms": bms, "bound_by": by,
            "library_ms": avg("library_ms")}
    emit({"phase": "kernel", "max_rel_err": worst_rel, "tol": GEMV_TOL, "rows": [1, 8],
          "device_ms": line["ms"],
          "main_path_mix": mix, "per_shape_batch1": per, "host_us_per_call": host,
          "library_call": "bf16 torch.matmul of x by the dequantized weight(s)", **line})
    return line


def check_gemv(gen, bits: int) -> dict:
    """gemv_int4 at q_proj, w_fused and lm_head; gemv_int8 at VT_k and VT_v
    (the README path), at q_proj, w_fused and the row-major lm_head (the
    weight_bits=8 path: weight 0 in the README mix) and on the transposed
    tied int8 head (on no served path)."""
    fn, ref = (gemv_int4, gemv_int4_ref) if bits == 4 else (gemv_int8, gemv_int8_ref)
    dense_shapes = {"q_proj": (HID, NH * HD), "w_fused": (NH * RV, HID), "lm_head": (HID, VOCAB)}
    if bits == 4:
        shapes = dense_shapes
        mix = {"q_proj": LAYERS, "w_fused": LAYERS, "lm_head": 1}
    else:
        shapes = {"vt_k": (HID, G * RK), "vt_v": (HID, G * RV), **dense_shapes,
                  "tied_head": (HID, VOCAB)}
        mix = {"vt_k": LAYERS, "vt_v": LAYERS}
    per, host, worst_abs, worst_rel = {}, {}, 0.0, 0.0
    for label, (k, n) in shapes.items():
        if label == "tied_head":
            emb = torch.randn((n, k), generator=gen, device="cuda") * 0.02
            w = wquant.tied_head({"embed": wquant.quantize_embed(emb)})  # a transposed view
        else:
            w = _qweight(bits, k, n, gen)
        for rows in (1, 8):
            x = torch.randn((rows, k), generator=gen, device="cuda").to(torch.bfloat16)
            err, rel = _held(f"{fn.__name__} {label} rows {rows}", fn(x, w), ref(x, w))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        x1 = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
        dense = _dense(w)
        lib, lib_name = _int_library(w)
        per[label] = {"ms": device_ms(lambda: fn(x1, w), 20),
                      "plain_ms": device_ms(lambda: ref(x1, w), 5),
                      "library_ms": device_ms(lambda: torch.matmul(x1, dense), 20),
                      "int_library_call": lib_name,
                      "int_library_ms": None if lib is None else device_ms(lambda: lib(x1), 20),
                      "bytes": _nbytes(*w.values()) + 2 * (k + n), "flops": 2 * k * n}
        if lib is not None:  # how close the yardstick's function is to ours
            want = ref(x1, w).float()
            per[label]["int_library_rel_err"] = (
                (lib(x1).float() - want).abs().max() / want.abs().max()).item()
        if not host:  # the first (most launched) shape
            host = {"shape": label, "wrapper": host_us(lambda: fn(x1, w)),
                    "wdot": host_us(lambda: wquant.wdot(x1, w, set())),
                    "bf16_matmul": host_us(lambda: torch.matmul(x1, dense))}
        del w, dense, lib
    cases = "139" if bits == 4 else "126"
    return _kernel_line(fn.__name__, bits, cases, mix, per, worst_abs, worst_rel, host)


def check_mlp(gen, bits: int) -> dict:
    """The fused SwiGLU MLP at H 4096, I 11008 (every layer of its path)."""
    fn, ref = (mlp_gemv_int4, mlp_gemv_int4_ref) if bits == 4 else (mlp_gemv_int8,
                                                                      mlp_gemv_int8_ref)
    ws = [_qweight(bits, HID, INTER, gen), _qweight(bits, HID, INTER, gen),
          _qweight(bits, INTER, HID, gen)]
    worst_abs, worst_rel = 0.0, 0.0
    for rows in (1, 8):
        x = torch.randn((rows, HID), generator=gen, device="cuda").to(torch.bfloat16)
        err, rel = _held(f"{fn.__name__} rows {rows}", fn(x, *ws), ref(x, *ws))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    x1 = torch.randn((1, HID), generator=gen, device="cuda").to(torch.bfloat16)
    dg, du, dd = (_dense(w) for w in ws)

    def dense_mlp():
        return torch.matmul(torch.nn.functional.silu(x1 @ dg) * (x1 @ du), dd)

    per = {"mlp": {
        "ms": device_ms(lambda: fn(x1, *ws), 20),
        "plain_ms": device_ms(lambda: ref(x1, *ws), 5),
        "library_ms": device_ms(dense_mlp, 20),
        "int_library_call": "none: no single PyTorch call computes the SwiGLU MLP",
        "int_library_ms": None,
        "bytes": sum(_nbytes(*w.values()) for w in ws) + 4 * HID,
        "flops": 6 * HID * INTER}}
    p = dict(zip(("gate", "up", "down"), ws))
    host = {"shape": "mlp", "wrapper": host_us(lambda: fn(x1, *ws)),
            "mlp_forward": host_us(lambda: llama.mlp_forward(x1, p, set())),
            "bf16_matmul": host_us(dense_mlp)}
    cases = "96" if bits == 4 else "80"
    return _kernel_line(fn.__name__, bits, cases, {"mlp": LAYERS}, per, worst_abs, worst_rel,
                        host)


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


def _quantized_leaves(tree, path="params"):
    """(path, tensor) for every code and scale tensor of quantized weights."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("wq4", "wq8", "eq8", "ws", "es"):
                yield f"{path}/{k}", v
            else:
                yield from _quantized_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _quantized_leaves(v, f"{path}/{i}")


def phase_e2e(tag: str = "e2e", wkw=None) -> None:
    wkw = wkw or {}
    cfg = llama7b(2)
    params = _tree_to(llama.init_params(cfg, torch.Generator().manual_seed(0)), "cpu",
                      torch.bfloat16)
    params_gpu = _tree_to(params, "cuda", torch.bfloat16)
    params_cpu = _tree_to(params, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (1, 2048))
    forced = rng.integers(0, cfg.vocab_size, 16)
    ecfg = EngineConfig(s_max=4096, batch=1, qcfg=FLAGSHIP, decode_chunk=512, **wkw)
    gpu = Engine(params_gpu, cfg, ecfg)
    del params_gpu
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
    # the engine quantized its weights on the card: codes and scales must be
    # the CPU's, bit for bit
    qleaves = dict(_quantized_leaves(cpu.params))
    qdiff = [p for p, t in _quantized_leaves(gpu.params)
             if p not in qleaves or not torch.equal(t.cpu(), qleaves[p])]
    emit({"phase": tag, "layers": 2, "prompt": 2048, "steps": 16, **wkw,
          "max_rel_err": rel, "tol": E2E_TOL, "top1_agreement": top1,
          "cache_code_bytes_differing": diff, "cache_code_bytes": total,
          "quantized_tensors": len(qleaves), "quantized_tensors_differing": qdiff,
          "gpu_decode_paths": sorted(gpu._decode_paths | gpu._gemv_paths),
          "cpu_decode_paths": sorted(cpu._decode_paths | cpu._gemv_paths),
          "gpu_s": gpu_s, "cpu_s": cpu_s})
    if not (torch.isfinite(got).all() and rel <= E2E_TOL):
        raise AssertionError(f"{tag}: end-to-end logits rel err {rel} > {E2E_TOL}")
    if gpu._decode_paths != {"palu_decode-kernel"}:
        raise AssertionError(f"GPU engine took {gpu._decode_paths}")
    if wkw and (qdiff or len(qleaves) != len(dict(_quantized_leaves(gpu.params)))
                or not qleaves):
        raise AssertionError(f"{tag}: card and CPU quantized weights differ: {qdiff}")
    if wkw and not all(p.endswith("-kernel") for p in gpu._gemv_paths):
        raise AssertionError(f"{tag}: GPU engine took {gpu._gemv_paths}")


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


def expected_launches(layers: int, wkw: dict, steps: int) -> dict:
    """Exact kernel launches of `steps` decode steps at batch <= 8 (prefill
    runs the matmul paths, never the GEMVs)."""
    bits = wkw.get("weight_bits", 16)
    vt8 = wkw.get("vt_bits", 16) == 8
    per_step = {"append_token_quantized": 2 * layers, "palu_decode": layers,
                "gemv_int4": 0, "mlp_gemv_int4": 0, "gemv_int8": 0, "mlp_gemv_int8": 0}
    if bits == 4:
        per_step["gemv_int4"] = 2 * layers + 1   # q_proj, w_fused, lm_head
        per_step["mlp_gemv_int4"] = layers
    elif bits == 8:
        per_step["gemv_int8"] = 2 * layers + 1
        per_step["mlp_gemv_int8"] = layers
    if vt8:
        per_step["gemv_int8"] += 2 * layers      # VT_k, VT_v
    return {k: v * steps for k, v in per_step.items()}


def _weight_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_weight_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_weight_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def serve(tag: str, eng: "_CheckedEngine", prompts, new_tokens: int, extra=None) -> dict:
    """Answer `prompts` in turn through Engine.generate with every launch
    counter set to 0 just before and read just after; check finite logits,
    the kernel paths and the exact decode launches."""
    cfg = eng.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS:
        fn.launches = 0
    eng._gemv_paths.clear()
    requests = []
    for ids in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.generate(ids, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        prefill_s = eng.prefill_s[-1]
        requests.append({"prompt": ids.shape[1], "lanes": ids.shape[0],
                         "new_tokens": int(toks.shape[1]), "prefill_s": prefill_s,
                         "decode_ms_per_token": (total_s - prefill_s) / new_tokens * 1e3,
                         "cache_nbytes": cache_nbytes(eng.last_cache)})
    launches = {fn.__name__: fn.launches for fn in COUNTERS}
    steps = new_tokens * len(prompts)
    finite = bool(torch.stack(eng.finite).all().item())
    wkw = {k: getattr(eng.ecfg, k) for k in ("weight_bits", "vt_bits", "embed_bits")}
    emit({"phase": tag, "model": f"Llama-2-7B widths, {cfg.num_hidden_layers} layers, bf16, "
          "random (seed 0)", "qcfg": dataclasses.asdict(FLAGSHIP), **wkw,
          "requests": requests, "decode_steps": steps, "launches": launches,
          "logits_finite": finite, "decode_paths": sorted(eng._decode_paths),
          "gemv_paths": sorted(eng._gemv_paths), "weight_bytes": _weight_bytes(eng.params),
          "max_memory_allocated": torch.cuda.max_memory_allocated(), **(extra or {})})
    if not finite:
        raise AssertionError(f"{tag}: non-finite logits")
    if eng._decode_paths != {"palu_decode-kernel"}:
        raise AssertionError(f"{tag}: took {eng._decode_paths}")
    if not all(p.endswith("-kernel") or p == "dense-matmul" for p in eng._gemv_paths):
        raise AssertionError(f"{tag}: decode took {eng._gemv_paths}")
    for name, n in expected_launches(cfg.num_hidden_layers, wkw, steps).items():
        if launches[name] != n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, expected {n}")
    if launches["prefill_flash"] <= 0:
        raise AssertionError(f"{tag}: prefill_flash never launched")
    return launches


def _engine(cfg, wkw, batch=1, params=None, s_max=8192):
    """A checked engine on seeded random bf16 weights (or `params`); returns
    it and the seconds the weights took to make."""
    t0 = time.perf_counter()
    if params is None:
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   dtype=torch.bfloat16)
    eng = _CheckedEngine(params, cfg, EngineConfig(s_max=s_max, batch=batch, decode_chunk=512,
                                                   qcfg=FLAGSHIP, **wkw))
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _prompts(seed: int, lens, lanes: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (lanes, n)) for n in lens]


def phase_serve() -> dict:
    """bf16 weights at full depth, then the decode and prefill breakdowns."""
    eng, init_s = _engine(llama7b(LAYERS), {})
    prompts = _prompts(1, (1000, 3000, 7000))
    launches = serve("serve", eng, prompts, 32, {"init_s": init_s})
    decode_breakdown(eng, "serve")
    prefill_breakdown(eng, prompts[-1], "serve")
    return launches


def phase_serve_w4() -> dict:
    """The README's configuration at full depth and the same traffic, its
    breakdowns, then the same weights at batch 8 (lanes_w4)."""
    cfg = llama7b(LAYERS)
    eng, init_s = _engine(cfg, W4)
    prompts = _prompts(1, (1000, 3000, 7000))
    launches = serve("serve_w4", eng, prompts, 32, {"init_s": init_s})
    decode_breakdown(eng, "serve_w4")
    prefill_breakdown(eng, prompts[-1], "serve_w4")
    lanes, _ = _engine(cfg, W4, batch=8, params=eng.params, s_max=2048)
    del eng
    serve("lanes_w4", lanes, _prompts(2, (1024,), lanes=8), 8)
    return launches


def phase_serve_w8() -> dict:
    """int8 weights, VT and embedding at full width, 4 layers, one request."""
    eng, init_s = _engine(llama7b(4), W8)
    return serve("serve_w8", eng, _prompts(3, (1000,)), 32,
                 {"init_s": init_s, "reduced": "4 of 32 layers"})


def _breakdown(prof, wall_ms: float, per: int) -> dict:
    kernels = [(e.key, e.self_device_time_total / 1e3 / per, e.count // per)
               for e in _device_events(prof)]
    busy_ms = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": sum(k[2] for k in kernels),
            "top": [{"kernel": k[0][:80], "ms": k[1], "launches": k[2]} for k in top]}


def prefill_breakdown(eng, ids, tag: str) -> None:
    """Where one prefill's time goes (the last request's prompt again):
    wall time, device busy time, idle share, and the top kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.prefill_auto(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "prefill_breakdown", "of": tag, "prompt": ids.shape[1],
          **_breakdown(prof, wall_ms, 1)})


def decode_breakdown(eng, tag: str, steps: int = 4) -> None:
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
    emit({"phase": "decode_breakdown", "of": tag, "context": int(cache["length"][0]),
          "per": "step", **_breakdown(prof, wall_ms, steps)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    kernels = [check_append(gen), check_decode(gen), check_prefill(gen),
               check_gemv(gen, 4), check_mlp(gen, 4), check_gemv(gen, 8), check_mlp(gen, 8)]
    phase_e2e()
    phase_e2e("e2e_w4", W4)
    phase_e2e("e2e_w8", W8)
    launches = phase_serve()
    launches_w4 = phase_serve_w4()
    launches_w8 = phase_serve_w8()
    # each kernel's launches on the run of its path: the bf16 serve for the
    # cache and attention kernels, serve_w4 for the int4 GEMVs and the int8
    # VT GEMV, serve_w8 for the int8 MLP
    source = {"cache_append": ("append_token_quantized", launches),
              "palu_decode": ("palu_decode", launches),
              "prefill_flash": ("prefill_flash", launches),
              "gemv_int4": ("gemv_int4", launches_w4),
              "mlp_gemv_int4": ("mlp_gemv_int4", launches_w4),
              "gemv_int8": ("gemv_int8", launches_w4),
              "mlp_gemv_int8": ("mlp_gemv_int8", launches_w8)}
    for k in kernels:
        counter, run = source[k["name"]]
        k["launches"] = run[counter]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
