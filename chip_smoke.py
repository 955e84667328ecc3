#!/usr/bin/env python3
"""Drive palu_tpu_torch on one NVIDIA GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - the card (nvidia-smi name and power limit), TF32 off;
  2. build    - nvcc builds every kernel from csrc/, all sources at once,
                and the SASS of the prefill kernel and of the exact and the
                bf16 decode kernels must hold wgmma (HGMMA) and TMA loads
                (UTMALDG), gemv_bf16's mma.sync (HMMA), the Hadamard
                kernels' shuffles and bulk copies, with no spill in any
                Hadamard mix instantiation, and mma.sync with no local
                memory in the register-streamed GEMVs (gemv4_n32,
                gemv4_ldg, gemv_kn, and mlp8_ldg of the int8 MLP), the
                append kernel's shuffles with no local memory and no
                spill, the archived v2 bf16 decode's MT 6 instantiation
                with wgmma, TMA and no local memory, the unpack probe's
                TMA and wgmma; the kernels' registers and spills from ptxas;
                every phase's line carries t_s, seconds since the start;
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the main path's shapes (7B widths; the append: one launch a
                layer for both sides, bit-exact, with its host time per
                layer; the int8 MLP: two launches a call), with the device times
                (torch.profiler, L2 cold: the durations of the call's own
                kernels in one profile, each call after a 64 MB flush left
                out by name; a kernel row under its bound raises) of the
                kernel, the plain version
                and a PyTorch yardstick (for the GEMVs: the dense bf16
                product that weight quantization replaces, and PyTorch's
                own int4 / int8 weight-only call where the card's torch
                has one; for the fp decode kernels: scaled_dot_product_attention
                over dense bf16 K/V, the attention Palu replaces; for the
                prefill, SDPA with the same mask, also at Qwen2-7B's 28 / 4
                heads), and for the GEMVs the host time of one call and the
                device kernels per call;
  4. e2e      - a 2-layer model at 7B widths: one 2048-token request and 16
                teacher-forced decode steps through the kernels (bf16) on the
                card, against the same run on the CPU (plain versions, f32);
     e2e_w4   - the same under weight_bits=4, vt_bits=8, embed_bits=8 (4
                teacher-forced steps); the card's quantized codes and
                scales must equal the CPU's;
     e2e_w8   - the same under weight_bits=8, vt_bits=8, embed_bits=8;
     e2e_fp, e2e_fp_t - the same over the unquantized bf16 latent caches
                (qcfg None), seq-major and rank-major;
     e2e_qwen2, e2e_qwen2_w4 - 2 layers of Qwen2-7B (its published config
                read by hf_io.config_from_hf; nonzero q/k/v biases; one
                G-LRD group of 28 q-heads at ranks 256) over the 3-bit cache,
                a 1024-token request, bf16 (16 steps) and under int4
                weights (4 steps); every
                decode launch carries the K bias and o_bias_corr equals the
                CPU's;
     e2e_chunked - the same 2 layers over the per-chunk cache (3-bit asym,
                one scale and zero per 32 ranks): each palu_decode launch
                held against palu_decode_ref, the logits against an engine
                on palu_decode_ref;
  5. serve    - the main path at full depth: a 32-layer Llama-2-7B-width
                Palu model (random weights from a seed, 3-bit latents in
                nibble containers) answers three requests (1000 / 3000 /
                7000-token prompts, 32 new tokens each) through
                Engine.generate, with the launch counters reset just before
                and read just after; then where the time of one decode step
                and of one 7000-token prefill goes (torch.profiler);
     serve_fp - the first 8 layers of the same weights and the same traffic
                over the unquantized rank-major cache (rank_major_fp:
                palu_decode_fp_t), exact launches per step, and its two
                breakdowns;
     serving  - the same weights through the ServingEngine (serve_bench's
                default: unquantized seq-major latents, palu_decode_fp) on
                the native scheduler: 8 lanes, chunked prefill interleaved
                with decode, 24 requests of 64 new tokens, 6 of them sampled,
                then a decode breakdown with all 8 lanes decoding;
     serve_w4 - the same model and traffic as serve under the README's
                configuration (int4 weights, int8 VT and embedding) with
                exact GEMV launch counts per step, and its two breakdowns;
     lanes_w4 - that engine at batch 8 (the GEMV kernels' 8-row edge);
     serve_w8 - int8 weights, 4 layers at full width, one request;
     serve_qwen2 - Qwen2-7B at full width and 28 layers over the 3-bit cache,
                serve's traffic, with its breakdowns (the Llama weights freed
                first);
     serving_qwen2 - those weights through the ServingEngine over the
                per-chunk cache: 8 lanes, 16 requests, 4 of them sampled,
                and its 8-lane decode breakdown;
  6. the latency entry points (palu_tpu_torch/cli), counts set to 0 just
     before each run and read just after:
     latency_kernel    - run_latency_kernel at 4K / 16K / 64K over bf16
                latents and the exact 3-bit seq-major cache
                (palu_decode_seq_quantized), providers WX and ours, and
                xla (the plain PyTorch decode) at 4K and 16K;
     latency_attention - run_latency_attention at a 64K prompt: the 3-bit
                cache exact, with int8_rot and with int8_dots, and dense KV,
                1 layer each; the 3-bit cache at 32 layers, as is and with
                int8_rot; each with the decode path and launches per step
                asserted and a decode breakdown;
     serve_bench_int8_rot - serve_bench --int8_rot at 32 layers, 8 lanes, 16
                requests on the native scheduler;
  7. the compression path (palu_tpu_torch/compression):
     compress  - a dense 32-layer Llama-2-7B-width model on the card through
                search_ranks (fisher_uniform, ratio 0.5, synthetic
                calibration), whitening and compress_params with Hadamard
                fusion (the FWHT kernel: exact launches asserted), then
                served over the 3-bit cache at group ranks above 128
                (one more step holds each layer's palu_decode against its
                plain version on the served cache), with the phase's time
                split into Fisher, whiten, decomposition and serve;
     compress_check - at 2 layers: with and without Hadamard fusion the
                forward logits agree, the card's engine over the fused
                params and bf16 latents agrees with the CPU's f32 forward,
                and over the 3-bit cache every palu_decode launch agrees
                with palu_decode_ref on the same inputs and the per-step
                logits with an engine that runs palu_decode_ref instead;
     compress_cli - `python -m palu_tpu_torch.cli.compress` on a 2-layer
                checkpoint written by hf_io.save_checkpoint, read back by
                hf_io.load_params and served;
     evals    - the accuracy track (palu_tpu_torch/evals) on that
                compressed checkpoint: cli.common.load_for_eval with
                --lt_hadamard (FWHT launches exact, 2 per group and side;
                logits within E2E_TOL of the unfused load), perplexity on
                seeded synthetic tokens (2 windows of 1024, bf16, against
                the port's f32 CPU run: each unquantized window's NLL within
                NLL_TOL, with the 3-bit hook the gap reported and the hook's
                move held above the unquantized gap; 4 timed windows of
                2048),
                run_zero_shot on in-code fixtures of the six tasks with a
                byte-level tokenizer (each bucketed score within BUCKET_TOL
                of the request scored alone and unpadded, f32, greedy flags
                equal), run_longbench on qasper / trec fixtures (~1500-token
                contexts) over the 3-bit cache at s_max 4096 (every
                palu_decode launch held against palu_decode_ref; prefill,
                append and decode launches exact) and
                TorchLM.generate_until with a stop string on that engine.
  Phase 3 also holds every decode kernel with Qwen2's K bias at the
  Qwen2-7B shape (G 1 x 28 heads) and the Llama shape (check_decode_bias),
  palu_decode over per-chunk scales (check_decode_chunked), every decode
  kernel with llama3 and yarn RoPE tables (check_decode_rope), the
  seq-major packed decode (check_decode_seq) and the
  packed decode's int8 K-path modes (check_decode_int8, also against the
  exact decode) against their plain versions, every decode kernel at group
  ranks 256 and 512 and at ranks that end in a partial rank chunk
  (check_decode_ranks), the Hadamard transform at the
  compression path's shapes (check_hadamard), and the engine's dense-KV
  decode on CUDA (one scaled_dot_product_attention call) against its plain
  version (dense_sdpa);
  8. probes - after phase 3, the four probe entry points
     (palu_tpu_torch/tools: dissect, stream_probe, unpack_probe,
     gemv_probe) at the JAX tools' default sizes (S 64K, g 8, rk 128, rv
     384; GEMV 4096 x 4096) with every variant, counts 0 just before each
     and read just after: each kernel variant held against its plain
     version (checksums and integer totals exact, the dissect within
     DECODE_TOL and its `full` mode (palu_decode_fp's own kernel, the
     others cut from its body in csrc/palu_decode_fp_wg.cu) bit-identical
     to palu_decode_fp and within DECODE_TOL of palu_decode_fp_ref, the
     unpack products within the bf16 class, the GEMVs within GEMV_TOL),
     with its device time, bound and yardstick; the kernels line gains
     palu_decode_fp_dissect, stream_probe, unpack_probe, gemv_bf16 and
     gemv_bf16_t with the launches of that run; then the last two tool
     entry points: ab_v2 (the decode generations' A/B at S 64K with
     every variant kind, v1 .. v4 and the PyTorch composite, then v2, v2q3
     and v3q3 again at kv_len 40000 < S) and mlp_a8_probe (H 4096, I
     11008, bn 256), each decode variant held within DECODE_TOL and mlp_a8
     within GEMV_TOL with its activation codes bit-exact and every code of
     h within 1; the kernels line gains palu_decode2,
     palu_decode2_quantized, palu_decode3_quantized and mlp_a8;
  9. the v4 decode's features (pos_offset, return_stats, layer_idx):
     decode_stats - with phase 3: a 64K cache (BASELINE.md's point) cut
                into four 16384-column shards, each through palu_decode
                (exact, int8_dots, int8_rot; per-chunk scales and the K bias
                at Qwen2-7B's shape) and palu_decode_fp_t with pos_offset
                and return_stats, held against its plain version (a shard
                with no valid column exactly m -1e30, l 0, acc 0), the
                shards combined against the one-call kernel, layer_idx on
                L = 4 stacks bit-identical to the per-layer call; times of
                the one call, each shard, the statistics variant and the
                layer_idx call beside their bounds and SDPA over the same
                columns;
     serve_stacked - after serve, on its weights: Engine.generate with
                stacked_decode=True (8 of serve's 32 layers, the 7000-token
                request, every palu_decode launched with layer_idx), then
                held against the unrolled engine over 8 steps (logits and
                cache bytes identical), both decode breakdowns; the same at
                2 layers over rank_major_fp (palu_decode_fp_t with
                layer_idx);
     serve_seq  - the engine on a 1 x 1 ("data", "seq") mesh under NCCL at
                world size 1, serve's request at 8 of its layers (serve runs
                all 32) with every decode launch a statistics one, logits
                against the unsharded engine's; and 2 layers over
                rank_major_fp;
     seq_ranks  - after serve_w8: two processes on the one card under gloo
                (seq 2, 4 layers), each step's logits against the world-1
                engine's on the same cache;
     the kernels line gains palu_decode_stats and palu_decode_fp_t_stats
     (launches of serve_seq) and palu_decode_layer_idx and
     palu_decode_fp_t_layer_idx (launches of serve_stacked);
then the nvidia-smi line, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from palu_tpu_torch.cli import common as cli_common
from palu_tpu_torch.cli import run_latency_attention, run_latency_kernel, serve_bench
from palu_tpu_torch.compression import (compress_params, search_ranks, synthetic_batches,
                                        whiten_scale_matrices)
from palu_tpu_torch.compression.rank_search import rank_search
from palu_tpu_torch.core import wquant
from palu_tpu_torch.core.hadamard import full_hadamard_matrix, get_hadK
from palu_tpu_torch.core.quant import (QuantConfig, pack_codes, packed_nrows, pack_codes_t,
                                       quantize, quantize_affine)
from palu_tpu_torch.evals import lm_eval_adapter as evals_lm_eval
from palu_tpu_torch.evals import longbench as evals_longbench
from palu_tpu_torch.evals import ppl as evals_ppl
from palu_tpu_torch.evals import zero_shot as evals_zero_shot
from palu_tpu_torch.models import hf_io, llama
from palu_tpu_torch.models.config import ModelConfig
from palu_tpu_torch.ops import build
from palu_tpu_torch.ops.archive.palu_decode2 import palu_decode2, palu_decode2_quantized
from palu_tpu_torch.ops.archive.palu_decode3 import palu_decode3_quantized
from palu_tpu_torch.ops.attention import dense_decode_sdpa, dense_flash_decode
from palu_tpu_torch.ops.cache_append import (KVAppend, append_kv_quantized,
                                             append_kv_quantized_ref, append_supported,
                                             append_token_quantized,
                                             append_token_quantized_ref)
from palu_tpu_torch.ops import gemv_int4 as gemv_int4_mod
from palu_tpu_torch.ops.gemv_int4 import (gemv_int4, gemv_int4_ref, mlp_gemv_int4,
                                          mlp_gemv_int4_ref)
from palu_tpu_torch.ops import gemv_int8 as gemv_int8_mod
from palu_tpu_torch.ops.gemv_int8 import (gemv_int8, gemv_int8_ref, mlp_gemv_int8,
                                          mlp_gemv_int8_ref)
from palu_tpu_torch.ops.hadamard import (MAX_N, hadamard_transform,
                                         hadamard_transform_ref)
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref,
                                               palu_decode_fp_t, palu_decode_fp_t_ref)
from palu_tpu_torch.ops.palu_decode_seq import (palu_decode_seq_quantized,
                                                palu_decode_seq_quantized_ref)
from palu_tpu_torch.ops.prefill_flash import prefill_flash, prefill_flash_ref
from palu_tpu_torch.runtime import engine as engine_mod
from palu_tpu_torch.runtime import profiler
from palu_tpu_torch.runtime.cache import cache_nbytes, decode_latents
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from palu_tpu_torch.runtime.sampling import SamplingParams
from palu_tpu_torch.runtime.serving import NativeScheduler, ServingEngine
from palu_tpu_torch.tools import (ab_v2, common, dissect, gemv_probe, mlp_a8_probe,
                                  stream_probe, unpack_probe)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# and int8 tensor-core rates and the f32 rate outside the tensor cores, for
# each kernel's bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12

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
COUNTERS = (append_kv_quantized, append_token_quantized, palu_decode, palu_decode_fp,
            palu_decode_fp_t, palu_decode_seq_quantized, prefill_flash, gemv_int4, mlp_gemv_int4,
            gemv_int8, mlp_gemv_int8, hadamard_transform, dissect.palu_decode_fp_dissect,
            stream_probe.stream_probe, unpack_probe.unpack_probe, gemv_probe.gemv_bf16,
            gemv_probe.gemv_bf16_t, palu_decode2, palu_decode2_quantized,
            palu_decode3_quantized, mlp_a8_probe.mlp_a8)
INT8_MODES = ("int8_dots", "int8_rot")  # palu_decode's int8 K-path modes
# the int8 modes' deviation from the exact decode: the JAX kernel tests'
# class (tests/test_pallas_decode4.py), (atol, rtol) for allclose
INT8_DEV = {"int8_dots": (4e-2, 2e-2), "int8_rot": (8e-2, 4e-2)}
# the decode kernels' yardstick (library_ms)
SDPA_YARDSTICK = ("scaled_dot_product_attention, one decode token over dense bf16 K/V of "
                  "the same context (a different function: the attention Palu replaces)")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries `t_s`, the seconds since
    the script started (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


# the v4 decodes whose launches count their features (pos_offset,
# return_stats, layer_idx), and the names those counts take
FEATURED = (palu_decode, palu_decode_fp_t)
FEATURE_NAMES = {"pos_offset": "pos_offset", "return_stats": "stats", "layer_idx": "layer_idx"}


def reset_counts() -> None:
    """Every wrapper's launch count (and palu_decode's per mode and with a
    K bias, and the v4 decodes' per feature) to 0."""
    for fn in COUNTERS:
        fn.launches = 0
    for mode in palu_decode.mode_launches:
        palu_decode.mode_launches[mode] = 0
    palu_decode.k_bias_launches = 0
    for fn in FEATURED:
        for f in fn.feature_launches:
            fn.feature_launches[f] = 0


def read_counts() -> dict:
    """Launches per wrapper, plus palu_decode's int8 modes as
    palu_decode_int8_dots / palu_decode_int8_rot, its per-chunk-scale
    launches as palu_decode_chunked and those with a K bias as
    palu_decode_k_bias (all also in palu_decode's), and the launches of
    palu_decode and palu_decode_fp_t with each feature as <name>_stats,
    <name>_pos_offset and <name>_layer_idx."""
    out = {fn.__name__: fn.launches for fn in COUNTERS}
    out.update({f"palu_decode_{m}": palu_decode.mode_launches[m]
                for m in (*INT8_MODES, "chunked")})
    out["palu_decode_k_bias"] = palu_decode.k_bias_launches
    for fn in FEATURED:
        out.update({f"{fn.__name__}_{FEATURE_NAMES[f]}": n
                    for f, n in fn.feature_launches.items()})
    return out


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


# Qwen2-7B as published (huggingface.co/Qwen/Qwen2-7B, config.json), read by
# the port's own config reader (models/hf_io.config_from_hf)
QWEN2_7B = {"model_type": "qwen2", "hidden_size": 3584, "intermediate_size": 18944,
            "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
            "vocab_size": 152064, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
            "tie_word_embeddings": False, "use_sliding_window": False,
            "sliding_window": 131072, "max_window_layers": 28,
            "max_position_embeddings": 131072, "hidden_act": "silu",
            "torch_dtype": "bfloat16"}
QWEN2_SOURCE = "huggingface.co/Qwen/Qwen2-7B config.json"
# Palu groups of 4 kv heads: one group (G 1) of 28 q-heads; the uniform rank
# search at ratio 0.5 gives 256 of the group dim 512 to k and to v
QG, QHPG, QRANK, QNKV, QNH = 1, 28, 256, 4, 28
QVOCAB, QHID, QINTER = (QWEN2_7B[k] for k in ("vocab_size", "hidden_size",
                                                 "intermediate_size"))
# the ServingEngine cache of serving_qwen2 and e2e_chunked: 3-bit asym with
# one scale and zero per 32 ranks (the reference's --lt_group_size 32)
CHUNKED = QuantConfig(bits=3, group_size=32, sym=False, container=4)
# a chunked 3-bit engine against one on palu_decode_ref, on the same card:
# only a latent whose code sits on a rounding edge of the bf16-vs-f32
# difference can move (compress_check's class, PERF.md)
E2E_CHUNKED_TOL = 1e-2


def qwen2_7b(layers: int) -> ModelConfig:
    """Qwen2-7B from its published config (layers cut to `layers`), Palu
    ranks from rank_search "uniform" at ratio 0.5 with head groups of 4."""
    cfg = hf_io.config_from_hf(dict(QWEN2_7B, num_hidden_layers=layers), head_group_size=4)
    names = [f"model.layers.{i}.self_attn.{w}" for i in range(layers)
             for w in ("k_proj", "v_proj")]
    sel, _, _ = rank_search(cfg, names, 0.5, "uniform", 4)
    if {r for rs in sel.values() for r in rs} != {QRANK}:
        raise AssertionError(f"uniform 0.5 gave ranks {sel}")
    return dataclasses.replace(cfg, head_wise_ranks=sel)


def qwen2_params(cfg: ModelConfig, device="cuda") -> dict:
    """Random bf16 weights from seed 0 (llama.init_params) with nonzero q, k
    and v biases, 0.3 N(0, 1) from the same generator (init_params makes
    zero biases, which would hide a missing bias fold)."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16)
    for layer in params["layers"]:
        for which in ("q_proj", "k_proj", "v_proj"):
            p = layer["attn"][which]
            p["b"] = (torch.randn(p["b"].shape, generator=gen, device=device) * 0.3).to(
                torch.bfloat16)
    return params


def device_ms(fn, iters: int) -> float:
    """Device time of one call of fn: the durations of fn's own kernels
    that torch.profiler records over `iters` calls in one profile, each
    call after a 64 MB in-place bitwise_not that leaves L2 (50 MB) cold as
    a layer's call inside a model step finds it; the flush's kernels are
    left out by name (tools/common.profile_calls: no wrapper of the port
    launches bitwise_not, and a fill or copy that fn launches counts).
    Host time between launches is not counted. A profile with no device
    events (seen once, at the tied-head GEMV) is taken again; three in a
    row raise."""
    return common.device_us(fn, iters) / 1e3


def device_span_ms(fn, iters: int) -> dict:
    """One call of fn, L2 cold as in device_ms: `ms` sums its kernels'
    durations, `span_ms` runs from its first kernel's start to its last
    one's end (the gaps between a call's kernels included); means over the
    calls of one profile (tools/common.profile_calls)."""
    calls = common.profile_calls(fn, iters)
    return {"ms": sum(c[0] for c in calls) / len(calls) / 1e3,
            "span_ms": sum(c[1] for c in calls) / len(calls) / 1e3}


def _device_events(prof):
    """The profiler's device-side rows (kernels, copies, memsets), so that
    time the host ops own is not counted twice."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def check_bound(name: str, ms: float, bound: float) -> None:
    """A device time under the least time the card could take for the same
    work is a fault of the measurement (a warm L2, a kernel left out or
    counted twice), not a number for the table: raise."""
    if not ms >= bound:
        raise AssertionError(f"{name}: device time {ms} ms under its bound {bound} ms")


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0, f32_flops: float = 0.0):
    """max(bytes / memory rate, operations / peak rate): bf16 `flops`,
    `int8_ops` on the int8 tensor-core path and `f32_flops` outside the
    tensor cores, their times added."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
             + f32_flops / PEAK_F32_FLOPS) * 1e3
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
    start_sass(build.SOURCES)
    regs = {}
    for name in build.SOURCES:
        log = build._lib_path(name).with_suffix(".log")
        if log.exists():
            regs[name] = [l.strip() for l in log.read_text().splitlines()
                          if re.search(r"Used \d+ registers", l) or "spill" in l]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in per.items()}, "ptxas": regs,
          "prefill_sass": hopper_sass("prefill_flash"),
          "decode_sass": {**hopper_sass("palu_decode_exact"),
                          "ptxas": regs.get("palu_decode_exact", [])},
          "fp_decode_sass": {**hopper_sass("palu_decode_fp_wg"),
                             "ptxas": regs.get("palu_decode_fp_wg", [])},
          # the seq-major packed decode: wgmma and TMA (B) in its own
          # instantiations, bulk copies of the packed tiles, no local memory
          # or spill
          "seq_decode_sass": seq_decode_sass(),
          # the v3 decode's and the dissection's instantiations, reported
          # beside the gated ones: registers and spill stores of each
          "v3_decode_ptxas": kernel_ptxas("palu_decode_exact", "palu_decode_v3_kernel"),
          "dissect_ptxas": kernel_ptxas("palu_decode_fp_wg", "palu_decode_fp_dissect_kernel"),
          # the archived v2 bf16 decode's instantiations (MT 4 / 6 / 8): no
          # local memory at MT 6, the tool's rv 384; the unpack probe's eight
          # variants on TMA (all) and wgmma (the mm variants)
          "v2_decode_ptxas": {**kernel_ptxas("palu_decode_fp_wg", "palu_decode_fp_v2_kernel"),
                              "mt6_sass": kernel_sass("palu_decode_fp_wg",
                                                      "palu_decode_fp_v2_kernelILi6E",
                                                      ("HGMMA", "UTMALDG", "LDL", "STL"))},
          "unpack_ptxas": {**kernel_ptxas("unpack_probe", "unpack_kernel"),
                           "sass": hopper_sass("unpack_probe")},
          "i8_decode_sass": {**hopper_sass("palu_decode_i8", reported=("IMMA",)),
                             "ptxas": regs.get("palu_decode_i8", [])},
          # the streaming GEMVs: mma.sync, TMA tiles, bulk copies (int4
          # scales and x, h), the cluster barrier; ptxas' lines of the two
          "gemv_sass": {**{f"gemv_int4_{k}": v for k, v in hopper_sass(
                            "gemv_int4", GEMV_SASS + ("UBLKCP",)).items()},
                        **{f"gemv_int8_{k}": v for k, v in hopper_sass(
                            "gemv_int8", GEMV_SASS).items()},
                        "ptxas": regs.get("gemv_int4", []) + regs.get("gemv_int8", [])},
          # gemv_bf16_t: mma.sync on operands loaded into registers (no
          # shared-memory ring); the Hadamard mix: shuffles, bf16 tiles by
          # bulk copies, and no local memory in any mix instantiation
          "gemv_bf16_sass": {**hopper_sass("gemv_bf16", ("HMMA",), ("LDL", "STL")),
                             "spills": kernel_spills("gemv_bf16", "gemv_t_kernel")},
          # the register-streamed one-launch GEMVs (gemv_int4 over a bf16 x on
          # narrow or clustered column blocks, gemv_bf16 over W (K, N)):
          # mma.sync counted, no local memory and no spill
          "ldg_sass": {name: {**kernel_sass(src, name, ("HMMA", "LDG", "LDL", "STL")),
                              "spills": kernel_spills(src, name, must_be_zero=True)}
                       for src, name in (("gemv_int4", "gemv4_n32"), ("gemv_int4", "gemv4_ldg"),
                                         ("gemv_bf16", "gemv_kn"), ("gemv_int8", "mlp8_ldg"))},
          # the append: warp shuffles, no shared memory, no local memory or spill
          "append_sass": {**kernel_sass("cache_append", "append_kernel", ("SHFL", "LDL", "STL")),
                          "spills": kernel_spills("cache_append", "append_kernel",
                                                  must_be_zero=True)},
          "hadamard_sass": {**hopper_sass("hadamard", ("SHFL", "UBLKCP"), ("LDL", "STL")),
                            "mix_spills": kernel_spills("hadamard", "mix_kernel",
                                                        must_be_zero=True)}})
    _SASS.clear()  # the dumps are read


def seq_decode_sass() -> dict:
    """SASS counts of palu_decode_seq_wg_kernel's instantiation on the main
    path (hd 128, one 8-head tile a consumer, 6 V blocks: the Llama group,
    rv 384): raises without HGMMA, UTMALDG (B) and UBLKCP (the packed tiles),
    on LDL / STL or on a spill there; the spills of every instantiation
    reported (at 16 heads a consumer or 8 V blocks the consumers' registers
    spill, as in the bf16 decodes' instantiations)."""
    main = "palu_decode_seq_wg_kernelILi128ELi1ELi6E"
    out = kernel_sass("palu_decode_fp_wg", main, ("HGMMA", "UTMALDG", "UBLKCP", "LDL", "STL"))
    if "cuobjdump" not in out and not (out["HGMMA"] and out["UTMALDG"] and out["UBLKCP"]):
        raise AssertionError(f"{main} SASS lacks wgmma or TMA: {out}")
    spills = kernel_spills("palu_decode_fp_wg", "palu_decode_seq_wg_kernel")
    if any(v for k, v in spills.items() if k.startswith("ILi128ELi1ELi6E")):
        raise AssertionError(f"{main} spills: {spills}")
    return {**out, "spills": spills}


def kernel_spills(source: str, kernel: str, must_be_zero: bool = False) -> dict:
    """Spill stores in bytes of each instantiation of `kernel` in
    csrc/<source>.cu (kernel_ptxas); must_be_zero raises on any."""
    report = kernel_ptxas(source, kernel)
    if "log" in report:
        return report
    out = {k: v.get("spill_stores", 0) for k, v in report.items()}
    if must_be_zero and any(out.values()):
        raise AssertionError(f"{source}: {kernel} spills: {out}")
    return out


def kernel_ptxas(source: str, kernel: str) -> dict:
    """ptxas' registers and spill stores (bytes) of each instantiation of
    `kernel` in csrc/<source>.cu, from the build log (mangled names
    shortened to their template arguments); raises when the log has none."""
    log = build._lib_path(source).with_suffix(".log")
    if not log.exists():
        return {"log": "not found"}
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1).split(kernel)[-1][:24] if kernel in m.group(1) else None
            if name is not None:
                out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            out[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out[name]["registers"] = int(m.group(1))
            name = None
    if not out:
        raise AssertionError(f"{source}: no ptxas report of {kernel}")
    return out


# cuobjdump -sass of each source's library: a running dump (process, output
# file) until sass_of reads it, then its text
_SASS: dict = {}


def start_sass(sources) -> None:
    """Start cuobjdump -sass of the named sources' libraries all at once
    (a large library takes tens of seconds alone); sass_of waits for one."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return
    for source in sources:
        if source not in _SASS:
            out = tempfile.TemporaryFile(mode="w+")
            _SASS[source] = (subprocess.Popen([tool, "-sass", str(build._lib_path(source))],
                                              stdout=out, text=True), out)


def sass_of(source: str) -> str:
    """The SASS of csrc/<source>.cu's library (its dump started if it was
    not), read once."""
    start_sass([source])
    entry = _SASS[source]
    if isinstance(entry, tuple):
        proc, out = entry
        if proc.wait(timeout=300) != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args)
        out.seek(0)
        _SASS[source] = out.read()
        out.close()
    return _SASS[source]


def kernel_sass(source: str, kernel: str, ops) -> dict:
    """Counts of `ops` in the SASS of the kernels of csrc/<source>.cu whose
    name holds `kernel` (cuobjdump -sass, split at its "Function :"
    headers). Raises when no such kernel is found, when it has no HMMA
    (mma.sync) where HMMA is counted, or when it uses local memory (LDL /
    STL: a spill or a runtime-indexed array)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    sass = sass_of(source)
    parts = [p for p in re.split(r"\n\s*Function : ", sass)[1:]
             if kernel in p.split("\n", 1)[0]]
    if not parts:
        raise AssertionError(f"{source}: no SASS of {kernel}")
    counts = {op: sum(len(re.findall(rf"\b{re.escape(op)}\b", p)) for p in parts)
              for op in ops}
    if ("HMMA" in counts and not counts["HMMA"]) or counts.get("LDL") or counts.get("STL"):
        raise AssertionError(f"{source} {kernel}: SASS {counts}")
    return counts


# what the streaming GEMVs' design stands on: mma.sync (HMMA), TMA tile
# loads, and the cluster barrier that orders the K splits' pushed sums
GEMV_SASS = ("HMMA", "UTMALDG", "UCGABAR_ARV", "UCGABAR_WAIT")


def hopper_sass(source: str, required=("HGMMA", "UTMALDG"), reported=()) -> dict:
    """Counts of Hopper instructions in the SASS of csrc/<source>.cu
    (cuobjdump -sass): `required` must each appear (default HGMMA, wgmma,
    and UTMALDG, TMA loads), `reported` are counted only (IMMA, mma.sync's
    int8 form, which the int8 decode must not use). Raises when a required
    one is missing; reports why when cuobjdump is not there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    sass = sass_of(source)
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in (*required, *reported)}
    missing = [op for op in required if not counts[op]]
    if missing:
        raise AssertionError(f"{source} SASS lacks {missing}: {counts}")
    return counts


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _append_side(qcfg: QuantConfig, rank: int, b: int, g: int, s_max: int, gen):
    """A token's latents (B, G, rank) bf16 and one side's cache buffers of
    random bytes, scales and zeros."""
    bufs = {"codes_t": torch.randint(0, 256, (b, g, packed_nrows(rank, qcfg.pack_bits), s_max),
                                     generator=gen, device="cuda", dtype=torch.uint8),
            "scale_t": torch.rand((b, g, 1, s_max), generator=gen, device="cuda")}
    if not qcfg.sym:
        bufs["zero_t"] = torch.randn((b, g, 1, s_max), generator=gen, device="cuda")
    lat = torch.randn((b, g, rank), generator=gen, device="cuda").to(torch.bfloat16)
    return lat, bufs


# the append's cases: every pack width, sym and asym, a clip; the ranks of
# Llama-2-7B's groups of 4 (K 128, V 384, G 8) and of Qwen2-7B's (256, G 1)
APPEND_QCFGS = (FLAGSHIP, QuantConfig(bits=3, sym=False, container=4),
                QuantConfig(bits=2, sym=True), QuantConfig(bits=8, sym=False),
                QuantConfig(bits=4, sym=True, clip_ratio=0.9))
APPEND_RANKS = ((G, RK, RV), (QG, QRANK, QRANK))


def check_append(gen) -> dict:
    """The one-launch append of a layer's two sides (append_kv_quantized)
    and the one-side append_token_quantized (the same kernel) against their
    plain versions on 3 lanes at positions 4099, S - 1 and 0, lane 1
    masked: bit-exact, the masked lane's bytes kept, one launch a call. Then
    at serve's shapes (batch 1, ranks 128 / 384, the 3-bit cache) one
    layer's append as the engine runs it (KVAppend, built once): device ms,
    host us per layer, and the host us of the checking call and of the two
    one-side calls the engine made before."""
    s_max, cases = 8192, 0
    pos = torch.tensor([4099, s_max - 1, 0], dtype=torch.int32, device="cuda")
    wr = torch.tensor([True, False, True], device="cuda")  # lane 1 must keep its bytes

    def held(got, want, before, what):
        torch.cuda.synchronize()
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"append not bit-exact: {what} {k}")
        if not torch.equal(got["codes_t"][1], before[1]) or \
                torch.equal(got["codes_t"][0], before[0]):
            raise AssertionError(f"append wrote a masked lane or skipped a live one: {what}")

    for qcfg in APPEND_QCFGS:
        for g, rk, rv in APPEND_RANKS:
            (lk, bk), (lv, bv) = (_append_side(qcfg, r, 3, g, s_max, gen) for r in (rk, rv))
            ref = [{k: t.clone() for k, t in b.items()} for b in (bk, bv)]
            before = [b["codes_t"].clone() for b in (bk, bv)]
            n = append_kv_quantized.launches
            append_kv_quantized(lk, lv, bk, bv, pos, wr, qcfg=qcfg, rank_k=rk, rank_v=rv)
            if append_kv_quantized.launches != n + 1:
                raise AssertionError("append_kv_quantized: not one launch a call")
            append_kv_quantized_ref(lk, lv, *ref, pos, wr, qcfg=qcfg, rank_k=rk, rank_v=rv)
            for side, got, want, b0 in zip("kv", (bk, bv), ref, before):
                held(got, want, b0, f"{qcfg} ranks {rk}/{rv} side {side}")
            lat, bufs = _append_side(qcfg, rv, 3, g, s_max, gen)
            ref, before = {k: t.clone() for k, t in bufs.items()}, bufs["codes_t"].clone()
            append_token_quantized(lat, bufs["codes_t"], bufs["scale_t"], pos, wr, qcfg=qcfg,
                                   rank=rv, zero=bufs.get("zero_t"))
            append_token_quantized_ref(lat, ref["codes_t"], ref["scale_t"], pos, wr,
                                       qcfg=qcfg, rank=rv, zero=ref.get("zero_t"))
            held(bufs, ref, before, f"{qcfg} one side rank {rv}")
            cases += 1

    # one layer of serve: batch 1, both sides through one KVAppend
    pos1 = torch.tensor([4099], dtype=torch.int32, device="cuda")
    wr1 = torch.tensor([True], device="cuda")
    (lk, bk), (lv, bv) = (_append_side(FLAGSHIP, r, 1, G, s_max, gen) for r in (RK, RV))
    layer = KVAppend((bk, bv), (RK, RV), qcfg=FLAGSHIP)
    lats = (lk, lv)

    def two_calls():
        for lat, b, r in ((lk, bk, RK), (lv, bv, RV)):
            append_token_quantized(lat, b["codes_t"], b["scale_t"], pos1, wr1, qcfg=FLAGSHIP,
                                   rank=r)

    ms = device_ms(lambda: layer(lats, pos1, wr1), 50)
    plain_ms = device_ms(lambda: append_kv_quantized_ref(lk, lv, bk, bv, pos1, wr1,
                                                         qcfg=FLAGSHIP, rank_k=RK, rank_v=RV),
                         10)
    kernels = kernels_per_call(lambda: layer(lats, pos1, wr1))
    host = {"engine_KVAppend": host_us(lambda: layer(lats, pos1, wr1)),
            "append_kv_quantized": host_us(lambda: append_kv_quantized(
                lk, lv, bk, bv, pos1, wr1, qcfg=FLAGSHIP, rank_k=RK, rank_v=RV)),
            "two_append_token_quantized": host_us(two_calls)}
    if kernels != 1:
        raise AssertionError(f"append: {kernels} kernels a layer")
    nbytes = sum(G * (r * 2 + packed_nrows(r, 4) + 4) for r in (RK, RV)) + 8
    flops = sum(G * r * 6 for r in (RK, RV))
    bms, by = bound_ms(nbytes, flops)
    out = {"name": "cache_append", "route": "cuda",
           "source": "palu_tpu_torch/csrc/cache_append.cu",
           "replaces": "palu_tpu/ops/pallas/cache_append.py:136",
           "max_abs_err": 0.0, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    emit({"phase": "kernel", "cases": cases, "bit_exact": True, "per": "layer, both sides",
          "kernels_per_call": kernels, "host_us_per_layer": host, **out})
    return out


def _decode_inputs(qcfg: QuantConfig, b: int, g: int, hpg: int, s_max: int, gen, rv: int = RV,
                   rk: int = RK):
    """q, b_k and a rank-major packed cache: per-row scales (B, G, S), or
    per-chunk row stacks (B, G, rank // group_size, S)."""
    q = torch.randn((b, g * hpg, HD), generator=gen, device="cuda").to(torch.bfloat16)
    b_k = (torch.randn((g, hpg, rk, HD), generator=gen, device="cuda")
           / math.sqrt(rk)).to(torch.bfloat16)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        lat = torch.randn((b, g, s_max, r), generator=gen, device="cuda")
        codes, scales, zeros = quantize_affine(lat, qcfg)
        bufs[f"x{side}_codes"] = pack_codes_t(codes, qcfg.pack_bits).contiguous()
        rows = (lambda t: t.transpose(-1, -2)) if qcfg.group_size else (lambda t: t[..., 0])
        bufs[f"x{side}_scale"] = rows(scales).contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = rows(zeros).contiguous()
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
           "source": "palu_tpu_torch/csrc/palu_decode_exact.cu",
           "replaces": "palu_tpu/ops/pallas/palu_decode4.py:899",
           "max_abs_err": worst_abs, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by,
           "library_ms": device_ms(_dense_kv_sdpa(1, s_max, gen), 20)}
    emit({"phase": "kernel", "cases": cases, "max_rel_err": worst_rel, "tol": DECODE_TOL,
          "bytes": nbytes, "flops": flops, "library_call": SDPA_YARDSTICK, **out})
    return out


# run_latency_attention at --prompt_len 65536: s_max 66048, rotation blocks
# of 512 (129 of them); kv_len 65600 lies in the last block
ATTN_S, ATTN_KV, ATTN_BLOCK = 66048, 65600, 512


def _held_decode(what: str, got, want) -> tuple:
    """(abs, rel) error of a decode kernel's output against its plain
    version; raises past DECODE_TOL."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if not (torch.isfinite(got).all() and rel <= DECODE_TOL):
        raise AssertionError(f"{what}: rel err {rel}")
    return err, rel


def check_decode_int8(gen) -> list:
    """palu_decode's int8 K-path modes against their plain versions at
    check_decode's shapes with rotation blocks of 512 and 2048 tokens, at
    serve_bench_int8_rot's shape (8 lanes, rank 128 per group for K and
    V, S 4096, block 2048) and at latency_attention's 64K point (where the
    exact decode is held too), and each one's deviation from the exact
    plain version (asserted within the JAX tests' class, INT8_DEV). Then
    device times at batch 1 with the flagship cache full to 8192, and at
    the 64K point."""
    s_max = 8192
    specs = [  # (qcfg, kv_len per lane, window, heads per group, rv, S, blocks)
        (QuantConfig(bits=3, sym=True), (1, 777), None, HPG, RV, s_max, (512, 2048)),
        (QuantConfig(bits=3, sym=False), (777, 8192), None, HPG, RV, s_max, (512, 2048)),
        (FLAGSHIP, (8192, 1), None, HPG, RV, s_max, (512, 2048)),
        (QuantConfig(bits=4, sym=False), (1, 8192), None, HPG, RV, s_max, (512, 2048)),
        (FLAGSHIP, (777, 8192), 1024, HPG, RV, s_max, (512, 2048)),
        (FLAGSHIP, (777, 8192), None, 16, RV, s_max, (512, 2048)),
        # serve_bench_int8_rot: prompts of 1024-2048 tokens plus 32 new ones
        (FLAGSHIP, (1024, 1100, 1500, 2000, 2047, 2048, 2049, 2080), None, HPG, RK, 4096,
         (2048,)),
        (FLAGSHIP, (ATTN_KV,), None, HPG, RV, ATTN_S, (ATTN_BLOCK,)),
    ]
    worst = {m: {"rel": 0.0, "abs": 0.0, "dev_abs": 0.0, "dev_rel": 0.0} for m in INT8_MODES}
    cases = 0
    for qcfg, kvl, window, hpg, rv, s, blocks in specs:
        q, b_k, bufs = _decode_inputs(qcfg, len(kvl), NH // hpg, hpg, s, gen, rv)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        kw = dict(qcfg=qcfg, rk=RK, rv=rv, sliding_window=window)
        exact = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
        if s == ATTN_S:  # the exact kernel at latency_attention's point
            _held_decode(f"palu_decode at S {s} kv {kvl}",
                         palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw), exact)
        for mode in INT8_MODES:
            for block_s in blocks:
                what = (f"{mode} {qcfg} kv {kvl} window {window} hpg {hpg} rv {rv} S {s} "
                        f"block {block_s}")
                got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, block_s=block_s,
                                  **{mode: True})
                want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, block_s=block_s,
                                       **{mode: True})
                err, rel = _held_decode(what, got, want)
                dev = (got - exact).abs().max().item()
                atol, rtol = INT8_DEV[mode]
                if not torch.allclose(got, exact, atol=atol, rtol=rtol):
                    raise AssertionError(f"{what}: {dev} from the exact decode")
                w = worst[mode]
                w["rel"], w["abs"] = max(w["rel"], rel), max(w["abs"], err)
                w["dev_abs"] = max(w["dev_abs"], dev)
                w["dev_rel"] = max(w["dev_rel"], dev / exact.abs().max().item())
                cases += 1
        del q, b_k, bufs, exact

    q, b_k, bufs = _decode_inputs(FLAGSHIP, 1, G, HPG, s_max, gen)
    kv_len = torch.tensor([s_max], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=FLAGSHIP, rk=RK, rv=RV)
    n = s_max
    nbytes = (sum(t.numel() * t.element_size() for t in bufs.values())
              + q.numel() * 2 + b_k.numel() * 2 + NH * RV * 4)
    library_ms = device_ms(_dense_kv_sdpa(1, s_max, gen), 20)
    # and at run_latency_attention's 64K point, beside the exact mode
    q64, b_k64, bufs64 = _decode_inputs(FLAGSHIP, 1, G, HPG, ATTN_S, gen)
    kv64 = torch.tensor([ATTN_KV], dtype=torch.int32, device="cuda")
    at_64k = {mode: device_ms(lambda: palu_decode(q64, b_k64, kv_len=kv64, **bufs64, **kw,
                                                  block_s=ATTN_BLOCK, **{mode: True}), 10)
              for mode in INT8_MODES}
    at_64k["exact"] = device_ms(lambda: palu_decode(q64, b_k64, kv_len=kv64, **bufs64, **kw), 10)
    del q64, b_k64, bufs64
    lines = []
    for mode in INT8_MODES:
        timed = {}
        for block_s in (512, 2048):
            # int8 dots for K (u and v: 2 * rk * hd per token and head), bf16
            # for the logits and P.V, f32 for the operand build per block
            int8_ops = 2 * NH * n * RK * HD
            flops = 2 * NH * n * (HD + RV)
            f32_flops = (n // block_s) * NH * HD * RK * 4
            bms, by = bound_ms(nbytes, flops, int8_ops, f32_flops)
            timed[f"block_{block_s}"] = {
                "ms": device_ms(lambda: palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw,
                                                    block_s=block_s, **{mode: True}), 20),
                "plain_ms": device_ms(lambda: palu_decode_ref(
                    q, b_k, kv_len=kv_len, **bufs, **kw, block_s=block_s, **{mode: True}), 3),
                "bytes": nbytes, "int8_ops": int8_ops, "flops": flops, "f32_flops": f32_flops,
                "bound_ms": bms, "bound_by": by}
        main = timed["block_512"]  # run_latency_attention's block at 64K
        line = {"name": f"palu_decode_{mode}", "route": "cuda",
                "source": "palu_tpu_torch/csrc/palu_decode_i8.cu",
                "replaces": ("palu_tpu/ops/pallas/palu_decode4.py:361" if mode == "int8_dots"
                             else "palu_tpu/ops/pallas/palu_decode4.py:448"),
                "max_abs_err": worst[mode]["abs"], "ms": main["ms"], "kernel_ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": library_ms}
        emit({"phase": "kernel", "cases": cases // len(INT8_MODES),
              "max_rel_err": worst[mode]["rel"],
              "tol": DECODE_TOL, "exact_deviation": {
                  "max_abs": worst[mode]["dev_abs"], "max_rel": worst[mode]["dev_rel"],
                  "allclose_atol_rtol": INT8_DEV[mode]},
              "timed": timed, "b1_s66048_kv65600_block512_ms": at_64k,
              "library_call": SDPA_YARDSTICK, **line})
        lines.append(line)
    return lines


def _seq_inputs(qcfg: QuantConfig, b: int, s_max: int, gen, rk: int = RK, rv: int = RV,
                g: int = G, hpg: int = HPG):
    """q, b_k and a seq-major packed cache (quantize + pack_codes) at the 7B
    group shapes (ranks rk / rv)."""
    q = torch.randn((b, g * hpg, HD), generator=gen, device="cuda").to(torch.bfloat16)
    b_k = (torch.randn((g, hpg, rk, HD), generator=gen, device="cuda")
           / math.sqrt(rk)).to(torch.bfloat16)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        lat = torch.randn((b, g, s_max, r), generator=gen, device="cuda")
        codes, scales, base = quantize(lat, qcfg)
        bufs[f"x{side}_codes"] = pack_codes(codes, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scales"] = scales.contiguous()
        bufs[f"x{side}_base"] = base.contiguous()
    return q, b_k, bufs


SEQ_REPEATS = 24  # calls of one seq decode that must agree bit for bit


def check_decode_seq(gen) -> dict:
    """The seq-major packed decode against its plain version at S 8192:
    exact 3-bit and 4-bit, sym and asym, at batch 1 (kv_len 8000, not a
    whole tile) and over two ragged lanes, and a sliding window; then at
    run_latency_kernel's 3-bit shapes (batch 1, S = kv_len = 4096, 16384
    and 65536). SEQ_REPEATS calls at batch 1, S 8192 must be bit-identical.
    Then its device time at batch 1 with that cache full to 8192 and to
    65536, and the dense-KV SDPA yardstick."""
    s_max = 8192
    specs = [  # (qcfg, kv_len per lane, window)
        (QuantConfig(bits=3, sym=False), (8000,), None),
        (QuantConfig(bits=3, sym=True), (8000,), None),
        (QuantConfig(bits=4, sym=False), (8000,), None),
        (QuantConfig(bits=4, sym=True), (8000,), None),
        (QuantConfig(bits=3, sym=False), (777, 8192), None),
        (QuantConfig(bits=2, sym=True), (1, 4097), None),
        (QuantConfig(bits=3, sym=True), (8000,), 1024),
    ]
    worst_rel, worst_abs = 0.0, 0.0
    qcfg = QuantConfig(bits=3, group_size=0)  # run_latency_kernel --lt_bits 3
    specs += [(qcfg, (n,), None) for n in (4096, 16384)]
    for qcfg_i, kvl, window in specs:
        q, b_k, bufs = _seq_inputs(qcfg_i, len(kvl), max(s_max, *kvl), gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        kw = dict(qcfg=qcfg_i, rk=RK, rv=RV, sliding_window=window)
        err, rel = _held_decode(
            f"seq decode {qcfg_i} kv {kvl} window {window}",
            palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
            palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        del q, b_k, bufs

    q, b_k, bufs = _seq_inputs(qcfg, 1, s_max, gen)
    kv_len = torch.tensor([s_max], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=RK, rv=RV)
    first = palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw)
    for _ in range(SEQ_REPEATS - 1):  # the ring, stages and splits: bit-identical repeats
        if not torch.equal(palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
                           first):
            raise AssertionError("seq decode: a repeated call differs")
    n = s_max
    nbytes = (sum(t.numel() * t.element_size() for t in bufs.values())
              + q.numel() * 2 + b_k.numel() * 2 + NH * RV * 4)
    flops = 2 * NH * n * (RK * HD + HD + RV)
    bms, by = bound_ms(nbytes, flops)
    ms = device_ms(lambda: palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw), 20)
    plain_ms = device_ms(lambda: palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs,
                                                               **kw), 3)
    del q, b_k, bufs
    q, b_k, bufs = _seq_inputs(qcfg, 1, 65536, gen)  # run_latency_kernel's 64K point
    kv64 = torch.tensor([65536], dtype=torch.int32, device="cuda")
    err, rel = _held_decode(
        f"seq decode {qcfg} kv 65536",
        palu_decode_seq_quantized(q, b_k, kv_len=kv64, **bufs, **kw),
        palu_decode_seq_quantized_ref(q, b_k, kv_len=kv64, **bufs, **kw))
    worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
    ms_64k = device_ms(lambda: palu_decode_seq_quantized(q, b_k, kv_len=kv64, **bufs, **kw), 10)
    out = {"name": "palu_decode_seq_quantized", "route": "cuda",
           "source": "palu_tpu_torch/csrc/palu_decode_fp_wg.cu",
           "replaces": "palu_tpu/ops/pallas/palu_decode.py:559",
           "max_abs_err": worst_abs, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by,
           "library_ms": device_ms(_dense_kv_sdpa(1, s_max, gen), 20)}
    emit({"phase": "kernel", "cases": len(specs) + 1, "max_rel_err": worst_rel,
          "tol": DECODE_TOL, "layout": "(B, G, S, nbytes)", "bytes": nbytes, "flops": flops,
          "bit_identical_repeats": SEQ_REPEATS,
          "b1_s65536_ms": ms_64k, "library_call": SDPA_YARDSTICK, **out})
    return out


def check_dense_sdpa(gen) -> None:
    """The dense-KV decode the engine runs on CUDA (one
    scaled_dot_product_attention call, not a kernel of the port) against
    its plain version (ops/attention.dense_flash_decode, what the CPU
    runs) on the same bf16 K/V: 32 heads, S 8192, ragged lanes, a sliding
    window and GQA, and at run_latency_attention's 64K point (batch 1, S
    66048, kv_len 65600); then both times there."""
    tol = DECODE_TOL + 2.0**-9  # SDPA returns bf16: plus half a bf16 ulp
    worst = 0.0
    for nkv, kvl, window in ((NH, (777, 8192), None), (NH, (8192, 5000), 1024),
                             (8, (1, 8192), None)):
        q = torch.randn((2, NH, HD), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((2, nkv, 8192, HD), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        got = dense_decode_sdpa(q, k, v, kv_len, window)
        want = dense_flash_decode(q, k, v, kv_len, 512, window)
        torch.cuda.synchronize()
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        if not (torch.isfinite(got).all() and rel <= tol):
            raise AssertionError(f"dense SDPA decode nkv {nkv} kv {kvl}: rel err {rel}")
        worst = max(worst, rel)
    s, n = ATTN_S, ATTN_KV
    q = torch.randn((1, NH, HD), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, NH, s, HD), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kv_len = torch.tensor([n], dtype=torch.int32, device="cuda")
    want = dense_flash_decode(q, k, v, kv_len, ATTN_BLOCK)
    rel = ((dense_decode_sdpa(q, k, v, kv_len).float() - want).abs().max()
           / want.abs().max()).item()
    if rel > tol:
        raise AssertionError(f"dense SDPA decode at S {s} kv {n}: rel err {rel}")
    worst = max(worst, rel)
    nbytes = 2 * NH * n * HD * 2 + 2 * q.numel() * 2
    bms, by = bound_ms(nbytes, 4 * NH * n * HD)
    emit({"phase": "dense_sdpa", "cases": 4, "max_rel_err": worst, "tol": tol,
          "what": "the engine's dense-KV decode on CUDA: torch scaled_dot_product_attention "
                  "(a library call), held against ops/attention.dense_flash_decode",
          "s_max": s, "kv_len": n,
          "sdpa_ms": device_ms(lambda: dense_decode_sdpa(q, k, v, kv_len), 20),
          "plain_ms": device_ms(lambda: dense_flash_decode(q, k, v, kv_len, 512), 3),
          "bound_ms": bms, "bound_by": by})


def _fp_inputs(b: int, g: int, hpg: int, s_max: int, gen, rk: int = RK, rv: int = RV):
    """q, b_k and bf16 latents in both layouts: seq-major (B, G, S, r) and
    rank-major (B, G, r, S) holding the same values."""
    q = torch.randn((b, g * hpg, HD), generator=gen, device="cuda").to(torch.bfloat16)
    b_k = (torch.randn((g, hpg, rk, HD), generator=gen, device="cuda")
           / math.sqrt(rk)).to(torch.bfloat16)
    lat = [torch.randn((b, g, s_max, r), generator=gen, device="cuda").to(torch.bfloat16)
           for r in (rk, rv)]
    return q, b_k, lat, [x.transpose(-1, -2).contiguous() for x in lat]


def _dense_kv_sdpa(b: int, n: int, gen, nh: int = NH, nkv: int = NH):
    """The yardstick: one scaled_dot_product_attention call for a decode
    token over dense bf16 K/V of n positions, nh q-heads over nkv kv-heads
    (GQA when fewer) (the attention Palu replaces, not the same function)."""
    q = torch.randn((b, nh, 1, HD), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, nkv, n, HD), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, nkv, n, HD), generator=gen, device="cuda").to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, enable_gqa=nkv != nh)


def check_decode_fp(gen) -> list:
    """Both unquantized-cache decode kernels (csrc/palu_decode_fp_wg.cu)
    against their plain versions: the 7B shapes at S 8192 with kv_len 8000
    (not a whole tile), a sliding window, 8 lanes with their own kv_len, 16
    q-heads per group (GQA), and 8 lanes whose kv_len stays well under S
    4096 (the splits cut each lane's valid tiles); Qwen2-7B's group (28
    q-heads, ranks 256) on the compact b_k and K bias (4 kv-heads, as the
    engine keeps them) at batch 1 and 8 lanes; and palu_decode_fp at
    run_latency_kernel's shapes (batch 1, S = kv_len = 4096, 16384 and
    65536). Then each one's device time at batch 1 with the cache full to
    8192, and palu_decode_fp's at the `serving` phase's shape (8 lanes, S
    4096, kv_len 2048)."""
    s_max = 8192
    specs = [  # (lanes, kv_len per lane, window, heads per group, S)
        (1, (8000,), None, HPG, s_max),
        (2, (777, 8192), 1024, HPG, s_max),
        (8, (1, 63, 64, 65, 1000, 4097, 8000, 8192), None, HPG, s_max),
        (2, (777, 8192), None, 16, s_max),
        (8, (1, 63, 64, 65, 130, 700, 1000, 2048), None, HPG, 4096),
    ]
    fns = {"palu_decode_fp": (palu_decode_fp, palu_decode_fp_ref, 0),
           "palu_decode_fp_t": (palu_decode_fp_t, palu_decode_fp_t_ref, 1)}
    worst = {name: [0.0, 0.0] for name in fns}
    for lanes, kvl, window, hpg, s in specs:
        q, b_k, seq, rank = _fp_inputs(lanes, NH // hpg, hpg, s, gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        for name, (fn, ref, rm) in fns.items():
            lat = rank if rm else seq
            err, rel = _held_decode(f"{name} lanes {lanes} kv {kvl} window {window} hpg {hpg}",
                                    fn(q, b_k, *lat, kv_len, sliding_window=window),
                                    ref(q, b_k, *lat, kv_len, sliding_window=window))
            worst[name] = [max(worst[name][0], rel), max(worst[name][1], err)]
        del q, b_k, seq, rank
    g, hpg, rk, rv = QWEN2_SHAPE
    rep = hpg // QNKV
    for kvl in ((s_max,), LANES8):  # Qwen2-7B, compact b_k and K bias
        q, b_k, seq, rank = _fp_inputs(len(kvl), g, hpg, s_max, gen, rk, rv)
        b_kc, kbc = b_k[:, ::rep].contiguous(), _k_bias(g, QNKV, gen).float()
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        for name, (fn, ref, rm) in fns.items():
            lat = rank if rm else seq
            err, rel = _held_decode(f"{name} qwen2 compact lanes {len(kvl)}",
                                    fn(q, b_kc, *lat, kv_len, k_bias=kbc),
                                    ref(q, b_kc, *lat, kv_len, k_bias=kbc))
            worst[name] = [max(worst[name][0], rel), max(worst[name][1], err)]
        del q, b_k, seq, rank
    for n in (4096, 16384, 65536):  # run_latency_kernel --lt_bits 16: batch 1, S = kv_len
        q, b_k, seq, _ = _fp_inputs(1, G, HPG, n, gen)
        kv_len = torch.tensor([n], dtype=torch.int32, device="cuda")
        err, rel = _held_decode(f"palu_decode_fp S {n}", palu_decode_fp(q, b_k, *seq, kv_len),
                                palu_decode_fp_ref(q, b_k, *seq, kv_len))
        worst["palu_decode_fp"] = [max(worst["palu_decode_fp"][0], rel),
                                   max(worst["palu_decode_fp"][1], err)]
        del q, b_k, seq

    lines = []
    for name, (fn, ref, rm) in fns.items():
        timed = {}
        for label, lanes, s, n in (("b1_s8192", 1, s_max, s_max), ("b8_s4096", 8, 4096, 2048)):
            if rm and lanes > 1:
                continue  # the rank-major kernel's path (serve_fp) runs batch 1
            q, b_k, seq, rank = _fp_inputs(lanes, G, HPG, s, gen)
            lat = rank if rm else seq
            kv_len = torch.full((lanes,), n, dtype=torch.int32, device="cuda")
            nbytes = lanes * G * (RK + RV) * n * 2 + q.numel() * 2 + b_k.numel() * 2 + \
                lanes * NH * RV * 4
            flops = 2 * lanes * NH * n * (RK * HD + HD + RV)
            bms, by = bound_ms(nbytes, flops)
            timed[label] = {"lanes": lanes, "s_max": s, "kv_len": n,
                            "ms": device_ms(lambda: fn(q, b_k, *lat, kv_len), 20),
                            "plain_ms": device_ms(lambda: ref(q, b_k, *lat, kv_len), 3),
                            "library_ms": device_ms(_dense_kv_sdpa(lanes, n, gen), 20),
                            "bytes": nbytes, "flops": flops, "bound_ms": bms, "bound_by": by}
            del q, b_k, seq, rank
        main = timed["b1_s8192"]
        out = {"name": name, "route": "cuda",
               "source": "palu_tpu_torch/csrc/palu_decode_fp_wg.cu",
               "replaces": ("palu_tpu/ops/pallas/palu_decode4.py:997" if rm
                            else "palu_tpu/ops/pallas/palu_decode.py:492"),
               "max_abs_err": worst[name][1], "ms": main["ms"], "kernel_ms": main["ms"],
               "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"], "library_ms": main["library_ms"]}
        emit({"phase": "kernel", "cases": len(specs) + 2 + (0 if rm else 3),
              "max_rel_err": worst[name][0],
              "tol": DECODE_TOL, "layout": "(B, G, r, S)" if rm else "(B, G, S, r)",
              "library_call": SDPA_YARDSTICK, "timed": timed, **out})
        lines.append(out)
    return lines


# the ranks a compressed 7B model's groups reach: 512 is group_dim (group
# size 4, hd 128), 256 the uniform search at ratio 0.5
BIG_RANKS = (256, 512)
# (rk, rv) pairs of the `compress` phase's layers whose K rank ends in a
# partial rank chunk (128 + 64, 256 + 32, 256 + 96, 384 + 32)
PARTIAL_RANKS = ((192, 192), (288, 320), (352, 384), (416, 448))


def _rot_overflows(rk: int) -> bool:
    """JAX's int32 overflow check of int8_rot at FLAGSHIP's pack width and
    hd 128 (palu_decode4.py:691): rk 280 and above raise."""
    return 63 * 127 * (2**FLAGSHIP.pack_bits - 1) * rk * (HD // 2) >= 2**31


def check_decode_ranks(gen) -> dict:
    """Every decode kernel against its plain version at rk 256 and 512 with
    rv 384 and 512, at the compress phase's (rk, rv) pairs whose last rank
    chunk is partial (PARTIAL_RANKS), over two ragged lanes at S 8192:
    palu_decode exact (3-bit in nibble containers, exact 3-bit, 4-bit asym)
    and int8_dots; int8_rot below rk 280, and above it must raise (JAX's
    int32 overflow check); palu_decode_fp, palu_decode_fp_t and
    palu_decode_seq_quantized; and 16 q-heads per group (GQA) at rk = rv =
    512. Then each one's device time at
    batch 1, S 8192, rv 384 and rk 256 / 512 (the rk-128 times are those of
    the kernel phases)."""
    s_max = 8192
    worst, cases = {}, 0

    def held(name, what, got, want):
        nonlocal cases
        err, rel = _held_decode(f"{name} {what}", got, want)
        w = worst.setdefault(name, [0.0, 0.0])
        worst[name] = [max(w[0], rel), max(w[1], err)]
        cases += 1

    seq_q = QuantConfig(bits=3, group_size=0)  # run_latency_kernel --lt_bits 3
    shapes = [(rk, rv, G, HPG) for rk in BIG_RANKS for rv in (RV, 512)]
    shapes += [(rk, rv, G, HPG) for rk, rv in PARTIAL_RANKS]
    shapes.append((512, 512, NH // 16, 16))
    for rk, rv, g, hpg in shapes:
        kv_len = torch.tensor((777, 8192), dtype=torch.int32, device="cuda")
        what = f"rk {rk} rv {rv} hpg {hpg}"
        for qcfg in (FLAGSHIP, QuantConfig(bits=3, sym=True), QuantConfig(bits=4, sym=False)):
            q, b_k, bufs = _decode_inputs(qcfg, 2, g, hpg, s_max, gen, rv, rk)
            kw = dict(qcfg=qcfg, rk=rk, rv=rv)
            held("palu_decode", f"{what} {qcfg}", palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
                 palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
            if qcfg == FLAGSHIP:
                for mode in INT8_MODES:
                    mk = dict(kw, block_s=512, **{mode: True})
                    if mode == "int8_rot" and _rot_overflows(rk):
                        try:
                            palu_decode(q, b_k, kv_len=kv_len, **bufs, **mk)
                        except ValueError:
                            continue
                        raise AssertionError(f"int8_rot at rk {rk} did not raise")
                    held(f"palu_decode_{mode}", what,
                         palu_decode(q, b_k, kv_len=kv_len, **bufs, **mk),
                         palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **mk))
            del q, b_k, bufs
        q, b_k, seq, rank = _fp_inputs(2, g, hpg, s_max, gen, rk, rv)
        held("palu_decode_fp", what, palu_decode_fp(q, b_k, *seq, kv_len),
             palu_decode_fp_ref(q, b_k, *seq, kv_len))
        held("palu_decode_fp_t", what, palu_decode_fp_t(q, b_k, *rank, kv_len),
             palu_decode_fp_t_ref(q, b_k, *rank, kv_len))
        del q, b_k, seq, rank
        q, b_k, bufs = _seq_inputs(seq_q, 2, s_max, gen, rk, rv, g, hpg)
        kw = dict(qcfg=seq_q, rk=rk, rv=rv)
        held("palu_decode_seq_quantized", what,
             palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
             palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
        del q, b_k, bufs

    times = {}
    kv1 = torch.tensor([s_max], dtype=torch.int32, device="cuda")
    for rk in BIG_RANKS:
        t = times[f"rk{rk}"] = {}
        q, b_k, bufs = _decode_inputs(FLAGSHIP, 1, G, HPG, s_max, gen, RV, rk)
        kw = dict(qcfg=FLAGSHIP, rk=rk, rv=RV)
        t["palu_decode"] = device_ms(lambda: palu_decode(q, b_k, kv_len=kv1, **bufs, **kw), 20)
        for mode in INT8_MODES:
            if mode == "int8_rot" and _rot_overflows(rk):
                continue
            t[f"palu_decode_{mode}"] = device_ms(lambda: palu_decode(
                q, b_k, kv_len=kv1, **bufs, **kw, block_s=512, **{mode: True}), 20)
        del q, b_k, bufs
        q, b_k, seq, rank = _fp_inputs(1, G, HPG, s_max, gen, rk, RV)
        t["palu_decode_fp"] = device_ms(lambda: palu_decode_fp(q, b_k, *seq, kv1), 20)
        t["palu_decode_fp_t"] = device_ms(lambda: palu_decode_fp_t(q, b_k, *rank, kv1), 20)
        del q, b_k, seq, rank
        q, b_k, bufs = _seq_inputs(seq_q, 1, s_max, gen, rk, RV)
        kw = dict(qcfg=seq_q, rk=rk, rv=RV)
        t["palu_decode_seq_quantized"] = device_ms(
            lambda: palu_decode_seq_quantized(q, b_k, kv_len=kv1, **bufs, **kw), 20)
        del q, b_k, bufs
    out = {"phase": "decode_ranks", "cases": cases, "tol": DECODE_TOL,
           "max_rel_err": {k: v[0] for k, v in worst.items()},
           "max_abs_err": {k: v[1] for k, v in worst.items()},
           "partial_chunk_ranks": PARTIAL_RANKS,
           "int8_rot_from_rk280": "raised ValueError (int32 overflow check)",
           "b1_s8192_rv384_ms": times}
    emit(out)
    return out


def _k_bias(g: int, hpg: int, gen):
    """A pre-RoPE K bias as the engine keeps it: 0.3 N(0, 1) in bf16."""
    return (torch.randn((g, hpg, HD), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)


def _decode_bound(bufs_bytes: int, lanes: int, nh: int, n: int, rk: int, rv: int,
                  int8: bool = False, block_s: int = 512, nkv: Optional[int] = None) -> tuple:
    """(bound ms, by, bytes, ops) of one latent decode: cache, q, b_k and
    output bytes; the K rebuild once per distinct kv-head and token (nkv
    of them in all groups; nh when every q-head has its own B), the
    logits and P.V per head and token (the int8 modes' K rebuild, which
    folds the query in per head, on the int8 path, their operand build in
    f32)."""
    nkv = nh if nkv is None else nkv
    nbytes = bufs_bytes + lanes * nh * HD * 2 + nkv * rk * HD * 2 + lanes * nh * rv * 4
    if int8:
        int8_ops = 2 * lanes * nh * n * rk * HD
        flops = 2 * lanes * nh * n * (HD + rv)
        f32_flops = lanes * (n // block_s) * nh * HD * rk * 4
        bms, by = bound_ms(nbytes, flops, int8_ops, f32_flops)
        return bms, by, nbytes, {"int8_ops": int8_ops, "flops": flops, "f32_flops": f32_flops}
    flops = 2 * lanes * n * (nkv * rk * HD + nh * (HD + rv))
    bms, by = bound_ms(nbytes, flops)
    return bms, by, nbytes, {"flops": flops}


# (G, heads per group, rk, rv): Qwen2-7B's one group of 28 q-heads at the
# uniform 0.5 ranks, and the Llama-2-7B shape
QWEN2_SHAPE, LLAMA_SHAPE = (QG, QHPG, QRANK, QRANK), (G, HPG, RK, RV)
LANES8 = (1, 63, 64, 65, 1000, 4097, 8000, 8192)


def check_decode_bias(gen) -> dict:
    """Every decode kernel with Qwen2's pre-RoPE K bias against its plain
    version at DECODE_TOL: palu_decode in its three K-path modes (rotation
    blocks of 512), palu_decode_fp and palu_decode_fp_t, at the Qwen2-7B
    shape (G 1 x 28 q-heads, rk = rv = 256) and the Llama shape (G 8 x 4),
    batch 1 with S = kv_len = 8192 and 8 lanes of their own kv_len;
    palu_decode also on the compact form at Qwen2-7B's (b_k and the bias
    per kv-head: 4 for 28 q-heads, as the engine keeps them). Then each
    one's device time at the Qwen2-7B shape, batch 1, S 8192 (palu_decode
    on the compact form, the exact mode also on the repeated one), beside
    its plain version's and SDPA over dense bf16 GQA K/V (28 q-heads over 4
    kv-heads), and the exact decode without the bias there (the bf16
    decodes on both forms too). Returns the
    kernels line's palu_decode_k_bias (the exact mode); its bound counts
    the K rebuild once per kv-head."""
    s_max = 8192
    worst, cases = {}, 0
    names = ("palu_decode", "palu_decode_int8_dots", "palu_decode_int8_rot", "palu_decode_fp",
             "palu_decode_fp_t")

    def held(name, what, got, want):
        nonlocal cases
        err, rel = _held_decode(f"{name} with k_bias {what}", got, want)
        w = worst.setdefault(name, [0.0, 0.0])
        worst[name] = [max(w[0], rel), max(w[1], err)]
        cases += 1

    for label, (g, hpg, rk, rv) in (("qwen2", QWEN2_SHAPE), ("llama", LLAMA_SHAPE)):
        for kvl in ((s_max,), LANES8):
            what = f"{label} lanes {len(kvl)}"
            kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
            kb = _k_bias(g, hpg, gen)
            q, b_k, bufs = _decode_inputs(FLAGSHIP, len(kvl), g, hpg, s_max, gen, rv, rk)
            forms = [("", b_k, kb)]
            if label == "qwen2":  # the engine's compact form: one B and bias per kv-head
                rep = hpg // QNKV
                forms.append((" compact", b_k[:, ::rep].contiguous(), kb[:, ::rep].contiguous()))
            for form, bk_f, kb_f in forms:
                for name, knob in zip(names[:3], ({}, {"int8_dots": True}, {"int8_rot": True})):
                    kw = dict(qcfg=FLAGSHIP, rk=rk, rv=rv, k_bias=kb_f, block_s=512, **knob)
                    held(name, what + form, palu_decode(q, bk_f, kv_len=kv_len, **bufs, **kw),
                         palu_decode_ref(q, bk_f, kv_len=kv_len, **bufs, **kw))
            del bufs
            q, b_k, seq, rank = _fp_inputs(len(kvl), g, hpg, s_max, gen, rk, rv)
            held("palu_decode_fp", what, palu_decode_fp(q, b_k, *seq, kv_len, k_bias=kb),
                 palu_decode_fp_ref(q, b_k, *seq, kv_len, k_bias=kb))
            held("palu_decode_fp_t", what, palu_decode_fp_t(q, b_k, *rank, kv_len, k_bias=kb),
                 palu_decode_fp_t_ref(q, b_k, *rank, kv_len, k_bias=kb))
            del q, b_k, seq, rank

    g, hpg, rk, rv = QWEN2_SHAPE
    nh = g * hpg
    kv1 = torch.tensor([s_max], dtype=torch.int32, device="cuda")
    kb = _k_bias(g, hpg, gen)
    library_ms = device_ms(_dense_kv_sdpa(1, s_max, gen, QNH, QNKV), 20)
    timed = {}
    q, b_k, bufs = _decode_inputs(FLAGSHIP, 1, g, hpg, s_max, gen, rv, rk)
    rep = hpg // QNKV
    b_kc, kbc = b_k[:, ::rep].contiguous(), kb[:, ::rep].contiguous()
    for name, knob in zip(names[:3], ({}, {"int8_dots": True}, {"int8_rot": True})):
        kw = dict(qcfg=FLAGSHIP, rk=rk, rv=rv, k_bias=kbc, block_s=512, **knob)
        bms, by, nbytes, ops = _decode_bound(_nbytes(*bufs.values(), kbc), 1, nh, s_max,
                                             rk, rv, int8=bool(knob), nkv=g * QNKV)
        timed[name] = {
            "ms": device_ms(lambda: palu_decode(q, b_kc, kv_len=kv1, **bufs, **kw), 20),
            "plain_ms": device_ms(lambda: palu_decode_ref(q, b_kc, kv_len=kv1, **bufs, **kw),
                                  3),
            "bytes": nbytes, **ops, "bound_ms": bms, "bound_by": by}
    timed["palu_decode"]["no_bias_ms"] = device_ms(
        lambda: palu_decode(q, b_kc, kv_len=kv1, **bufs, qcfg=FLAGSHIP, rk=rk, rv=rv), 20)
    timed["palu_decode"]["repeated_form_ms"] = device_ms(  # 28 B, one per q-head
        lambda: palu_decode(q, b_k, kv_len=kv1, **bufs, qcfg=FLAGSHIP, rk=rk, rv=rv, k_bias=kb),
        20)
    del bufs
    q, b_k, seq, rank = _fp_inputs(1, g, hpg, s_max, gen, rk, rv)
    for name, fn, ref, lat in (("palu_decode_fp", palu_decode_fp, palu_decode_fp_ref, seq),
                               ("palu_decode_fp_t", palu_decode_fp_t, palu_decode_fp_t_ref,
                                rank)):
        bms, by, nbytes, ops = _decode_bound(_nbytes(*lat, kb), 1, nh, s_max, rk, rv)
        cbms, cby, _, _ = _decode_bound(_nbytes(*lat, kbc), 1, nh, s_max, rk, rv,
                                        nkv=g * QNKV)
        timed[name] = {"ms": device_ms(lambda: fn(q, b_k, *lat, kv1, k_bias=kb), 20),
                       "plain_ms": device_ms(lambda: ref(q, b_k, *lat, kv1, k_bias=kb), 3),
                       "bytes": nbytes, **ops, "bound_ms": bms, "bound_by": by,
                       # the engine's form: K rebuilt for the 4 kv-heads, not 28
                       "compact_ms": device_ms(lambda: fn(q, b_kc, *lat, kv1, k_bias=kbc), 20),
                       "compact_bound_ms": cbms, "compact_bound_by": cby}
    del q, b_k, seq, rank
    main = timed["palu_decode"]
    out = {"name": "palu_decode_k_bias", "route": "cuda",
           "source": "palu_tpu_torch/csrc/palu_decode_exact.cu",
           "replaces": "palu_tpu/ops/pallas/palu_decode4.py:932",
           "max_abs_err": worst["palu_decode"][1], "ms": main["ms"], "kernel_ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": library_ms}
    emit({"phase": "kernel", "what": "decode kernels with the pre-RoPE K bias (Qwen2)",
          "cases": cases, "tol": DECODE_TOL,
          "max_rel_err": {k: v[0] for k, v in worst.items()},
          "max_abs_err": {k: v[1] for k, v in worst.items()},
          "b1_s8192_qwen2_g1_hpg28_rk256_rv256": timed,
          "library_call": "scaled_dot_product_attention(enable_gqa=True), one decode token "
                          "over dense bf16 K/V of 28 q-heads over 4 kv-heads (a different "
                          "function: the attention Palu replaces)", **out})
    return out


def check_decode_chunked(gen) -> dict:
    """palu_decode over per-chunk scales (chunk 32: the exact kernel's K
    rebuild folded per scale chunk) against its plain version at
    DECODE_TOL: sym, asym, and asym with the K bias, at the Qwen2-7B shape
    and the Llama shape over two lanes (kv_len 777 and 8192, S 8192), and at
    serving_qwen2's shape (8 lanes, S 4096, asym with the bias). Then its
    device time at the Qwen2-7B shape, batch 1, S 8192 (asym with the bias:
    serving_qwen2's cache), and at serving_qwen2's 8 lanes, beside the
    plain version's and SDPA over dense GQA K/V. At the Qwen2-7B shape
    the kernel is also held, and timed, on the compact form (b_k and the
    bias per kv-head, as the engine keeps them). The int8 modes must raise
    (per-row scales only). Returns the kernels line's palu_decode_chunked;
    its bound counts the K rebuild once per kv-head."""
    s_max, worst_rel, worst_abs, cases = 8192, 0.0, 0.0, 0
    sym = dataclasses.replace(CHUNKED, sym=True)
    specs = [(shape, qcfg, bias, kvl, s)
             for shape in (QWEN2_SHAPE, LLAMA_SHAPE)
             for qcfg, bias in ((sym, False), (CHUNKED, False), (CHUNKED, True))
             for kvl, s in (((777, s_max), s_max),)]
    specs.append((QWEN2_SHAPE, CHUNKED, True, (256, 700, 1024, 1500, 2047, 2048, 2080, 2100),
                  4096))
    for (g, hpg, rk, rv), qcfg, bias, kvl, s in specs:
        q, b_k, bufs = _decode_inputs(qcfg, len(kvl), g, hpg, s, gen, rv, rk)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        kb = _k_bias(g, hpg, gen) if bias else None
        kw = dict(qcfg=qcfg, rk=rk, rv=rv, k_bias=kb)
        forms = [("", b_k, kb)]
        if hpg == QHPG:  # the engine's compact form: one B and bias per kv-head
            rep = hpg // QNKV
            forms.append((" compact", b_k[:, ::rep].contiguous(),
                          None if kb is None else kb[:, ::rep].contiguous()))
        for form, bk_f, kb_f in forms:
            kwf = dict(kw, k_bias=kb_f)
            err, rel = _held_decode(
                f"chunked decode g {g} hpg {hpg} {qcfg} bias {bias} kv {kvl}{form}",
                palu_decode(q, bk_f, kv_len=kv_len, **bufs, **kwf),
                palu_decode_ref(q, bk_f, kv_len=kv_len, **bufs, **kwf))
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
            cases += 1
        for mode in INT8_MODES:
            try:
                palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, block_s=512, **{mode: True})
            except ValueError:
                continue
            raise AssertionError(f"{mode} took per-chunk scales")
        del q, b_k, bufs

    g, hpg, rk, rv = QWEN2_SHAPE
    nh = g * hpg
    timed = {}
    for label, lanes, s, n in (("b1_s8192", 1, s_max, s_max), ("b8_s4096", 8, 4096, 2048)):
        q, b_k, bufs = _decode_inputs(CHUNKED, lanes, g, hpg, s, gen, rv, rk)
        kv_len = torch.full((lanes,), n, dtype=torch.int32, device="cuda")
        rep = hpg // QNKV  # the engine's compact form
        b_k, kb = b_k[:, ::rep].contiguous(), _k_bias(g, hpg, gen)[:, ::rep].contiguous()
        kw = dict(qcfg=CHUNKED, rk=rk, rv=rv, k_bias=kb)
        # the bytes of the first n positions: what this run reads
        per_pos = _nbytes(*bufs.values()) / s
        bms, by, nbytes, ops = _decode_bound(int(per_pos * n) + kb.numel() * 2, lanes, nh, n,
                                             rk, rv, nkv=g * QNKV)
        timed[label] = {
            "lanes": lanes, "s_max": s, "kv_len": n,
            "ms": device_ms(lambda: palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw), 20),
            "plain_ms": device_ms(lambda: palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw),
                                  3),
            "library_ms": device_ms(_dense_kv_sdpa(lanes, n, gen, QNH, QNKV), 20),
            "bytes": nbytes, **ops, "bound_ms": bms, "bound_by": by}
        del q, b_k, bufs
    main = timed["b1_s8192"]
    out = {"name": "palu_decode_chunked", "route": "cuda",
           "source": "palu_tpu_torch/csrc/palu_decode_exact.cu",
           "replaces": "palu_tpu/ops/pallas/palu_decode4.py:968",
           "max_abs_err": worst_abs, "ms": main["ms"], "kernel_ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"]}
    emit({"phase": "kernel", "what": "palu_decode over per-chunk scales (chunk 32)",
          "cases": cases, "tol": DECODE_TOL, "max_rel_err": worst_rel,
          "int8_modes": "raised ValueError (per-row scales only)", "timed": timed,
          "library_call": "scaled_dot_product_attention(enable_gqa=True) over dense bf16 "
                          "K/V, 28 q-heads over 4 kv-heads", **out})
    return out


# scaled-RoPE tables the decode kernels must hold: Llama-3.1's llama3 and a
# yarn table (its attention scale is not 1)
ROPE_SCALING = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 4096},
}


def check_decode_rope(gen) -> None:
    """Every decode kernel with scaled-RoPE tables against its plain version
    on the same tables, at DECODE_TOL: palu_decode in its three modes,
    palu_decode_fp, palu_decode_fp_t and palu_decode_seq_quantized, at the
    Llama shape over two lanes (kv_len 777 and 8192, S 8192), with a
    llama3 table and a yarn table."""
    from palu_tpu_torch.models import rope as rope_mod

    s_max = 8192
    kv_len = torch.tensor((777, s_max), dtype=torch.int32, device="cuda")
    worst, cases, scales = {}, 0, {}
    for scaling, rs in ROPE_SCALING.items():
        inv_freq, scale = rope_mod.inv_freq_and_scale(dataclasses.replace(
            llama7b(1), rope_scaling=rs))
        rope = dict(inv_freq=np.asarray(inv_freq, np.float32), rope_scale=float(scale))
        scales[scaling] = rope["rope_scale"]

        def held(name, got, want):
            nonlocal cases
            err, rel = _held_decode(f"{name} with {scaling} RoPE", got, want)
            w = worst.setdefault(name, [0.0, 0.0])
            worst[name] = [max(w[0], rel), max(w[1], err)]
            cases += 1

        q, b_k, bufs = _decode_inputs(FLAGSHIP, 2, G, HPG, s_max, gen)
        for name, knob in (("palu_decode", {}), ("palu_decode_int8_dots", {"int8_dots": True}),
                           ("palu_decode_int8_rot", {"int8_rot": True})):
            kw = dict(qcfg=FLAGSHIP, rk=RK, rv=RV, block_s=512, **rope, **knob)
            held(name, palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
                 palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
        del q, b_k, bufs
        q, b_k, seq, rank = _fp_inputs(2, G, HPG, s_max, gen)
        held("palu_decode_fp", palu_decode_fp(q, b_k, *seq, kv_len, **rope),
             palu_decode_fp_ref(q, b_k, *seq, kv_len, **rope))
        held("palu_decode_fp_t", palu_decode_fp_t(q, b_k, *rank, kv_len, **rope),
             palu_decode_fp_t_ref(q, b_k, *rank, kv_len, **rope))
        del q, b_k, seq, rank
        sq = QuantConfig(bits=3, group_size=0)
        q, b_k, bufs = _seq_inputs(sq, 2, s_max, gen)
        kw = dict(qcfg=sq, rk=RK, rv=RV, **rope)
        held("palu_decode_seq_quantized",
             palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
             palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
        del q, b_k, bufs
    if scales["yarn"] == 1.0:
        raise AssertionError("the yarn table's rope_scale is 1: it would hold nothing")
    emit({"phase": "decode_rope", "cases": cases, "tol": DECODE_TOL,
          "rope_scaling": ROPE_SCALING, "rope_scale": scales,
          "max_rel_err": {k: v[0] for k, v in worst.items()},
          "max_abs_err": {k: v[1] for k, v in worst.items()}})


# Hadamard tolerances, as a share of max|plain| (plain in f32 on the same
# input): f32 butterfly sums against the dense product's sums in another
# order; a bf16 output is one bf16 rounding more, as PREFILL_TOL
HAD_TOL = {torch.float32: 1e-5, torch.bfloat16: PREFILL_TOL}
# the fuse_hadamard path's ranks: every multiple of 32 up to 512 covers each
# K of get_hadK (1, 12, 28, 36, 40, 44, 52, 60)
HAD_RANKS = tuple(range(32, 513, 32))


def check_hadamard(gen) -> dict:
    """hadamard_transform against its plain version in f32 on the same
    input (TF32 off): f32 and bf16 at fuse_hadamard's shapes, VT_g^T (4096,
    r) and U_g (512, r), for r
    in 128 / 256 / 352 / 384 / 480 / 512, (512, r) for every rank multiple
    of 32 and n 4096, both orientations of H_K, and the JAX kernel test's
    sizes (tests/test_fwht_kernel.py). Then device times at (4096, 256)
    f32, the uniform 0.5 search's rank, and at the other path ranks, beside
    the plain version's and one torch.matmul against the dense matrix, and
    in bf16 at (4096, 256 / 352 / 480) beside the bf16 matmul; each time
    held above its bound (check_bound)."""
    shapes = [(rows, r) for rows in (4096, 512) for r in (128, 256, 352, 384, 480, 512)]
    shapes += [(512, r) for r in HAD_RANKS] + [(512, 4096), (37, 128), (37, 96), (37, 352),
                                               (37, 1024), (3, 5, 128)]
    worst = {str(dt): [0.0, 0.0] for dt in HAD_TOL}
    cases = 0
    for shape in shapes:
        for dt, tol in HAD_TOL.items():
            for transpose in ((False, True) if shape[-1] in (96, 352, 480) else (False,)):
                x = torch.randn(shape, generator=gen, device="cuda").to(dt)
                got = hadamard_transform(x, transpose=transpose)
                want = hadamard_transform_ref(x.float(), transpose=transpose)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                rel = err / want.abs().max().item()
                if not (got.dtype == dt and torch.isfinite(got).all() and rel <= tol):
                    raise AssertionError(f"hadamard {shape} {dt} transpose {transpose}: "
                                         f"rel err {rel}")
                w = worst[str(dt)]
                worst[str(dt)] = [max(w[0], rel), max(w[1], err)]
                cases += 1
    for n in (4097, 8192):
        try:
            hadamard_transform(torch.zeros((2, n), device="cuda"))
        except ValueError:
            continue
        raise AssertionError(f"hadamard_transform took n {n} > {MAX_N}")

    timed = {}
    for rows, r, dt in [(4096, 256, torch.float32), (512, 256, torch.float32),
                        (4096, 128, torch.float32), (4096, 352, torch.float32),
                        (4096, 480, torch.float32), (4096, 512, torch.float32),
                        (4096, 256, torch.bfloat16), (4096, 352, torch.bfloat16),
                        (4096, 480, torch.bfloat16)]:
        x = torch.randn((rows, r), generator=gen, device="cuda").to(dt)
        h = torch.from_numpy(full_hadamard_matrix(r)).cuda().to(dt)
        _, k = get_hadK(r)
        nbytes = 2 * rows * r * x.element_size()
        f32_flops = rows * r * (math.log2(r // k) + k + 1)
        bms, by = bound_ms(nbytes, 0.0, f32_flops=f32_flops)
        tag = f"{rows}x{r}" + ("" if dt == torch.float32 else "_bf16")
        ms = device_ms(lambda: hadamard_transform(x), 50)
        check_bound(f"hadamard_transform {tag}", ms, bms)
        timed[tag] = {
            "K": k, "ms": ms, "plain_ms": device_ms(lambda: hadamard_transform_ref(x), 20),
            "library_ms": device_ms(lambda: torch.matmul(x, h.T), 50),
            "copy_ms": device_ms(lambda: x.clone(), 50),
            "bytes": nbytes, "f32_flops": f32_flops, "bound_ms": bms, "bound_by": by}
    main = timed["4096x256"]
    out = {"name": "hadamard_transform", "route": "cuda",
           "source": "palu_tpu_torch/csrc/hadamard.cu",
           "replaces": "palu_tpu/ops/pallas/fwht.py:56",
           "max_abs_err": max(w[1] for w in worst.values()), "ms": main["ms"],
           "kernel_ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"]}
    emit({"phase": "kernel", "cases": cases, "tol": {str(k): v for k, v in HAD_TOL.items()},
          "max_rel_err": {k: v[0] for k, v in worst.items()}, "timed": timed,
          "library_call": "torch.matmul(x, H.T) against the dense Hadamard matrix in x's "
                          "type; copy_ms: x.clone(), the read and write alone",
          **out})
    return out


def _prefill_inputs(b, nh, nkv, cq, s, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return rnd(b, nh, cq, HD), rnd(b, nkv, s, HD), rnd(b, nkv, s, HD)


# (q heads, kv heads, window, keys, chunk offsets of the two lanes): the
# Llama-7B widths (MHA, GQA over 8, a window), and Qwen2-7B's 28 q-heads
# over 4 kv-heads at serve_qwen2's 7000-token prompt: 7168 keys read, its
# first chunk and its last (offset 6656)
PREFILL_CASES = ((NH, NH, None, 4096, (0, 3584)), (NH, 8, None, 4096, (0, 3584)),
                 (NH, NH, 1024, 4096, (0, 3584)), (QNH, QNKV, None, 7168, (0, 6656)))


def check_prefill(gen) -> dict:
    cq, worst_rel, worst_abs, rel_by_case = 512, 0.0, 0.0, {}
    for nh, nkv, window, s, offs in PREFILL_CASES:
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kvl = off + cq
        q, k, v = _prefill_inputs(2, nh, nkv, cq, s, gen)
        got = prefill_flash(q, k, v, off, kvl, sliding_window=window)
        want = prefill_flash_ref(q.float(), k.float(), v.float(), off, kvl,
                                 sliding_window=window)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (torch.isfinite(got).all() and rel <= PREFILL_TOL):
            raise AssertionError(f"prefill nh {nh} nkv {nkv} window {window}: rel err {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        rel_by_case[f"nh{nh}_nkv{nkv}_window{window}_s{s}"] = rel
        del q, k, v, got, want

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
    del q, k, v
    out = {"name": "prefill_flash", "route": "cuda",
           "source": "palu_tpu_torch/csrc/prefill_flash.cu",
           "replaces": "palu_tpu/ops/pallas/prefill_flash.py:257",
           "max_abs_err": worst_abs, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    emit({"phase": "kernel", "cases": len(PREFILL_CASES), "max_rel_err": worst_rel,
          "rel_err_by_case": rel_by_case, "tol": PREFILL_TOL, "bytes": nbytes, "flops": flops,
          "qwen2_7b": _qwen2_prefill_times(gen, cq), **out})
    return out


def _qwen2_prefill_times(gen, cq: int) -> dict:
    """Device times at serve_qwen2's last chunk of its 7000-token prompt
    (28 q-heads over 4 kv-heads, offset 6656, 7168 keys): the kernel and
    SDPA with the same mask (GQA), beside the bound."""
    q, k, v = _prefill_inputs(1, QNH, QNKV, cq, 7168, gen)
    o1 = torch.tensor([6656], dtype=torch.int32, device="cuda")
    k1 = o1 + cq
    pos = torch.arange(7168, device="cuda")
    mask = pos[None, :] <= (6656 + torch.arange(cq, device="cuda"))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4 * QNH * HD * sum(6656 + i + 1 for i in range(cq))
    bms, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), flops)
    return {"ms": device_ms(lambda: prefill_flash(q, k, v, o1, k1), 20),
            "library_ms": device_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), 20),
            "bound_ms": bms, "bound_by": by, "flops": flops}


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


def kernels_per_call(fn, iters: int = 10, tries: int = 3) -> float:
    """Device kernels the profiler sees per call of fn, which launches the
    same number each call, at least one. The profiler drops a device event
    now and then (one run read 9 for 10 one-kernel calls) and never adds
    one, so a profile with no device event, or with a count that is not a
    whole number per call, is taken again, up to `tries` profiles in all.
    The first whole reading stands, and only if no earlier reading was
    above it; after `tries` uneven ones the last stands as read. Every
    reading of a call that took more than one profile is emitted."""
    readings = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        readings.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
        if readings[-1] and readings[-1] % iters == 0:
            break
    n = readings[-1]
    if len(readings) > 1:
        emit({"phase": "kernels_per_call", "readings": readings, "iters": iters})
    if n == 0:
        raise RuntimeError("torch.profiler recorded no device event")
    if max(readings) > n:
        raise RuntimeError(f"a profile read more device events than the one that stands: "
                           f"{readings} over {iters} calls")
    return n / iters


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


# host time per call of the wrappers before the streaming kernels, as this
# script measured it (host_us_per_call; NVIDIA H100 80GB HBM3, 700 W),
# shown beside this run's
PARENT_HOST_US = {"mlp_gemv_int4": 42.3, "gemv_int8": 30.1,
                  "gemv_int4": 45.8}  # gemv_int4: the split pass and its reduce kernel


def _kernel_line(name, bits, cases, mix, per, per8, worst_abs, worst_rel, host,
                 qwen2_rel) -> dict:
    """Per-launch numbers on the main path at batch 1: each case's time
    weighted by its launches per decode step (`mix`); `per8` each case's
    device and span ms at 8 rows. `qwen2_rel` is the worst rel err of each
    Qwen2-7B-width shape (held only, not timed)."""
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
          "device_ms": line["ms"], "span_ms": avg("span_ms"),
          "main_path_mix": mix, "per_shape_batch1": per, "per_shape_batch8": per8,
          "host_us_per_call": host, "parent_host_us_per_call": PARENT_HOST_US.get(name),
          "qwen2_max_rel_err": qwen2_rel,
          "library_call": "bf16 torch.matmul of x by the dequantized weight(s)", **line})
    return line


# the GEMV shapes of e2e_qwen2_w4 (Qwen2-7B widths: q_proj, the U_v-fused
# o_proj of 28 heads at rank 256, lm_head; VT_k / VT_v of its one group at
# rank 256; the MLP), held against the plain versions but not timed
QWEN2_GEMV = {"qwen2_q_proj": (QHID, QNH * HD), "qwen2_w_fused": (QNH * QRANK, QHID),
              "qwen2_lm_head": (QHID, QVOCAB)}
QWEN2_VT = {"qwen2_vt_k": (QHID, QG * QRANK), "qwen2_vt_v": (QHID, QG * QRANK)}


def _held_rows(fn, ref, label, k, ws, gen, rows_list=(1, 8)) -> tuple:
    """fn against ref at each row count of x (K = k), a second call
    bit-identical: (max abs err, max rel err)."""
    worst_abs = worst_rel = 0.0
    for rows in rows_list:
        x = torch.randn((rows, k), generator=gen, device="cuda").to(torch.bfloat16)
        got = fn(x, *ws)
        err, rel = _held(f"{fn.__name__} {label} rows {rows}", got, ref(x, *ws))
        if not torch.equal(fn(x, *ws), got):
            raise AssertionError(f"{fn.__name__} {label} rows {rows}: two calls differ")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def check_gemv(gen, bits: int) -> dict:
    """gemv_int4 at q_proj, w_fused and lm_head (one kernel per call at 1
    and 8 rows, int4pack timed at both); gemv_int8 at VT_k and VT_v
    (the README path), at q_proj, w_fused and the row-major lm_head (the
    weight_bits=8 path: weight 0 in the README mix) and on the transposed
    tied int8 head (on no served path). Both also at the Qwen2-7B widths
    (QWEN2_GEMV; gemv_int8 at QWEN2_VT too), held only, at 1, 3 and 8 rows
    (3 rows: the streaming int8 kernel whose blocks own several column
    blocks of Qwen2-7B's lm_head)."""
    fn, ref = (gemv_int4, gemv_int4_ref) if bits == 4 else (gemv_int8, gemv_int8_ref)
    dense_shapes = {"q_proj": (HID, NH * HD), "w_fused": (NH * RV, HID), "lm_head": (HID, VOCAB)}
    if bits == 4:
        shapes = dense_shapes
        mix = {"q_proj": LAYERS, "w_fused": LAYERS, "lm_head": 1}
        held_only = QWEN2_GEMV
    else:
        shapes = {"vt_k": (HID, G * RK), "vt_v": (HID, G * RV), **dense_shapes,
                  "tied_head": (HID, VOCAB)}
        mix = {"vt_k": LAYERS, "vt_v": LAYERS}
        held_only = {**QWEN2_VT, **QWEN2_GEMV}
    per, per8, host, worst_abs, worst_rel, qwen2_rel = {}, {}, {}, 0.0, 0.0, {}
    for label, (k, n) in held_only.items():
        w = _qweight(bits, k, n, gen)
        err, qwen2_rel[label] = _held_rows(fn, ref, label, k, (w,), gen, (1, 3, 8))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, qwen2_rel[label])
        del w
    for label, (k, n) in shapes.items():
        if label == "tied_head":
            emb = torch.randn((n, k), generator=gen, device="cuda") * 0.02
            w = wquant.tied_head({"embed": wquant.quantize_embed(emb)})  # a transposed view
        else:
            w = _qweight(bits, k, n, gen)
        err, rel = _held_rows(fn, ref, label, k, (w,), gen)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        x1 = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
        x8 = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
        dense = _dense(w)
        lib, lib_name = _int_library(w)
        per8[label] = device_span_ms(lambda: fn(x8, w), 20)
        per[label] = {**device_span_ms(lambda: fn(x1, w), 20),
                      "plain_ms": device_ms(lambda: ref(x1, w), 5),
                      "library_ms": device_ms(lambda: torch.matmul(x1, dense), 20),
                      "int_library_call": lib_name,
                      "int_library_ms": None if lib is None else device_ms(lambda: lib(x1), 20),
                      "bytes": _nbytes(*w.values()) + 2 * (k + n), "flops": 2 * k * n}
        per[label]["kernels_per_call"] = kernels_per_call(lambda: fn(x1, w))
        per[label]["bound_ms"], per[label]["bound_by"] = bound_ms(per[label]["bytes"],
                                                                  per[label]["flops"])
        bms8, _ = bound_ms(per[label]["bytes"] + 14 * (k + n), 8 * per[label]["flops"])
        check_bound(f"{fn.__name__} {label}", per[label]["ms"], per[label]["bound_ms"])
        check_bound(f"{fn.__name__} {label} 8 rows", per8[label]["ms"], bms8)
        if bits == 4:  # one launch (gemv4_n32 or gemv4_ldg), no reduce kernel
            per8[label]["kernels_per_call"] = kernels_per_call(lambda: fn(x8, w))
            if per[label]["kernels_per_call"] != 1 or per8[label]["kernels_per_call"] != 1:
                raise AssertionError(f"gemv_int4 {label}: {per[label]['kernels_per_call']} / "
                                     f"{per8[label]['kernels_per_call']} kernels per call")
            per[label]["route"] = gemv_int4_mod.gemv4_route(
                torch.cuda.get_device_properties(0).multi_processor_count, k, n, 1)[0]
        if lib is not None and bits == 4:
            per8[label]["int_library_ms"] = device_ms(lambda: lib(x8), 20)
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
    return _kernel_line(fn.__name__, bits, cases, mix, per, per8, worst_abs, worst_rel, host,
                        qwen2_rel)


def check_mlp(gen, bits: int) -> dict:
    """The fused SwiGLU MLP at H 4096, I 11008 (every layer of its path),
    and held only at Qwen2-7B's H 3584, I 18944."""
    fn, ref = (mlp_gemv_int4, mlp_gemv_int4_ref) if bits == 4 else (mlp_gemv_int8,
                                                                      mlp_gemv_int8_ref)

    def weights(h, inter):
        return [_qweight(bits, h, inter, gen), _qweight(bits, h, inter, gen),
                _qweight(bits, inter, h, gen)]

    ws = weights(QHID, QINTER)
    worst_abs, qwen2_rel = _held_rows(fn, ref, "qwen2_mlp", QHID, ws, gen)
    ws = weights(HID, INTER)
    err, rel = _held_rows(fn, ref, "mlp", HID, ws, gen)
    worst_abs, worst_rel = max(worst_abs, err), max(qwen2_rel, rel)
    x1 = torch.randn((1, HID), generator=gen, device="cuda").to(torch.bfloat16)
    dg, du, dd = (_dense(w) for w in ws)

    def dense_mlp():
        return torch.matmul(torch.nn.functional.silu(x1 @ dg) * (x1 @ du), dd)

    x8 = torch.randn((8, HID), generator=gen, device="cuda").to(torch.bfloat16)
    per8 = {"mlp": device_span_ms(lambda: fn(x8, *ws), 20)}
    per = {"mlp": {
        **device_span_ms(lambda: fn(x1, *ws), 20),
        "plain_ms": device_ms(lambda: ref(x1, *ws), 5),
        "library_ms": device_ms(dense_mlp, 20),
        "int_library_call": "none: no single PyTorch call computes the SwiGLU MLP",
        "int_library_ms": None,
        "bytes": sum(_nbytes(*w.values()) for w in ws) + 4 * HID,
        "flops": 6 * HID * INTER}}
    if bits == 8:  # two launches of mlp8_ldg over a bf16 x; an f32 x splits (4)
        per["mlp"]["kernels_per_call"] = kernels_per_call(lambda: fn(x1, *ws))
        per8["mlp"]["kernels_per_call"] = kernels_per_call(lambda: fn(x8, *ws))
        per["mlp"]["plans"] = gemv_int8_mod._device_mlp8_plans(torch.device("cuda"), HID,
                                                               INTER, 1)
        x32 = x1.float()
        f32 = kernels_per_call(lambda: fn(x32, *ws))
        if per["mlp"]["kernels_per_call"] != 2 or per8["mlp"]["kernels_per_call"] != 2 \
                or f32 != 4:
            raise AssertionError(f"mlp_gemv_int8: {per['mlp']['kernels_per_call']} / "
                                 f"{per8['mlp']['kernels_per_call']} kernels a call at 1 / 8 "
                                 f"rows (bf16), {f32} over an f32 x")
        bms8, _ = bound_ms(per["mlp"]["bytes"] + 14 * (HID + INTER), 8 * per["mlp"]["flops"])
        check_bound("mlp_gemv_int8 8 rows", per8["mlp"]["ms"], bms8)
    p = dict(zip(("gate", "up", "down"), ws))
    host = {"shape": "mlp", "wrapper": host_us(lambda: fn(x1, *ws)),
            "mlp_forward": host_us(lambda: llama.mlp_forward(x1, p, set())),
            "bf16_matmul": host_us(dense_mlp)}
    cases = "96" if bits == 4 else "80"
    return _kernel_line(fn.__name__, bits, cases, {"mlp": LAYERS}, per, per8, worst_abs,
                        worst_rel, host, {"qwen2_mlp": qwen2_rel})


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


def _e2e_inputs():
    """The e2e phases' 2-layer model (bf16 weights on the CPU, seed 0), its
    2048-token prompt and 16 teacher-forced tokens."""
    cfg = llama7b(2)
    params = _tree_to(llama.init_params(cfg, torch.Generator().manual_seed(0)), "cpu",
                      torch.bfloat16)
    rng = np.random.default_rng(0)
    return (cfg, params, rng.integers(0, cfg.vocab_size, (1, 2048)),
            rng.integers(0, cfg.vocab_size, 16))


def _qwen2_e2e_inputs():
    """The Qwen2 e2e phases' 2-layer model at Qwen2-7B width (bf16 weights
    with nonzero biases, made from seed 0 on the card and kept on the CPU),
    its 1024-token prompt and 16 teacher-forced tokens (vocab 152064 makes
    the CPU's f32 run about 6 GB: the prompt is half the Llama one's)."""
    cfg = qwen2_7b(2)
    params = _tree_to(qwen2_params(cfg), "cpu", torch.bfloat16)
    rng = np.random.default_rng(10)
    return (cfg, params, rng.integers(0, QVOCAB, (1, 1024)), rng.integers(0, QVOCAB, 16))


# teacher-forced steps of the quantized-weight e2e phases (e2e_w4, e2e_w8,
# e2e_qwen2_w4): on the CPU the plain GEMVs dequantize each weight group
# by group on every step (Qwen2-7B's 152064-column int4 head is ~2 GB of
# f32 codes a step), which took 40 / 26 / 69 s of the CPU reference at 16
# steps; the bf16 phases keep 16
E2E_WEIGHT_STEPS = 4


def phase_e2e(tag: str = "e2e", wkw=None, inputs=None) -> None:
    """2 layers at full width, card (bf16, kernels) against CPU (f32, plain
    versions) on the same bf16-rounded weights: `inputs` is (cfg, params,
    prompt, forced tokens), the Llama-2-7B-width model by default. With
    biases, every decode launch of the card carries the K bias, and under
    quantized weights the v bias's o_bias_corr (from the dequantized o_proj
    codes) equals the CPU's to f32 rounding."""
    wkw = wkw or {}
    cfg, params, ids, forced = inputs or _e2e_inputs()
    if wkw:  # the CPU's plain int4 / int8 GEMVs dequantize every step
        forced = forced[:E2E_WEIGHT_STEPS]
    params_gpu = _tree_to(params, "cuda", torch.bfloat16)
    params_cpu = _tree_to(params, "cpu", torch.float32)
    ecfg = EngineConfig(s_max=4096, batch=1, qcfg=FLAGSHIP, decode_chunk=512, **wkw)
    gpu = Engine(params_gpu, cfg, ecfg)
    del params_gpu
    reset_counts()
    t0 = time.perf_counter()
    got, gcache = _stepwise(gpu, ids, forced)
    gpu_s = time.perf_counter() - t0
    launches = read_counts()
    cpu = Engine(params_cpu, cfg, dataclasses.replace(ecfg, dtype=torch.float32, device="cpu"))
    del params_cpu
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
    bias = {}
    if cfg.attention_bias:
        # o_bias_corr in f32 from each engine's own (quantized) params, and
        # as each engine keeps it (bf16 on the card, f32 on the CPU)
        f32_rel = max(
            ((engine_mod._o_bias_corr(gl["attn"], cfg, ecfg.weight_bits).cpu()
              - engine_mod._o_bias_corr(cl["attn"], cfg, ecfg.weight_bits)).abs().max()
             / engine_mod._o_bias_corr(cl["attn"], cfg, ecfg.weight_bits).abs().max()).item()
            for gl, cl in zip(gpu.params["layers"], cpu.params["layers"]))
        kept_rel = max(((gd["o_bias_corr"].float().cpu() - cd["o_bias_corr"]).abs().max()
                        / cd["o_bias_corr"].abs().max()).item()
                       for gd, cd in zip(gpu.derived, cpu.derived))
        bias = {"o_bias_corr_f32_max_rel_err": f32_rel, "o_bias_corr_kept_max_rel_err": kept_rel,
                "decode_launches": launches["palu_decode"],
                "decode_launches_with_k_bias": launches["palu_decode_k_bias"]}
    emit({"phase": tag, "model": _model_name(cfg), "layers": 2, "prompt": int(ids.shape[1]),
          "steps": len(forced), **wkw, **bias,
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
    if cfg.attention_bias:
        if not 0 < launches["palu_decode_k_bias"] == launches["palu_decode"]:
            raise AssertionError(f"{tag}: {bias}: not every decode launch carried the K bias")
        # one bf16 rounding of the kept correction apart
        if bias["o_bias_corr_f32_max_rel_err"] > 1e-5 or bias["o_bias_corr_kept_max_rel_err"] \
                > 2.0**-8:
            raise AssertionError(f"{tag}: card and CPU o_bias_corr differ: {bias}")


def _model_name(cfg: ModelConfig) -> str:
    base = ("Qwen2-7B widths" if cfg.model_family == "qwen2" else "Llama-2-7B widths")
    return f"{base}, {cfg.num_hidden_layers} layers, bf16, random (seed 0)"


def phase_e2e_chunked(inputs) -> None:
    """The per-chunk cache end to end: the 2-layer Qwen2-7B-width model over
    the asym 3-bit cache with one scale and zero per 32 ranks (CHUNKED),
    a 1024-token prompt and 16 teacher-forced steps on the card. Every
    palu_decode launch is held at DECODE_TOL against palu_decode_ref on the
    same inputs (the engine's own cache), and the per-step logits within
    E2E_CHUNKED_TOL of an engine on the card that runs palu_decode_ref in
    its place (3-bit codes on either side of a rounding edge between the
    card's bf16 and the CPU's f32 would make a CPU comparison loose)."""
    cfg, params, ids, forced = inputs
    params_gpu = _tree_to(params, "cuda", torch.bfloat16)
    ecfg = EngineConfig(s_max=4096, batch=1, qcfg=CHUNKED, decode_chunk=512)
    held, runs = [], {}
    for tag, decode in (("kernel", _held_engine_decode(held, "e2e_chunked: palu_decode")),
                        ("plain_decode", palu_decode_ref)):
        reset_counts()
        with _engine_decode(decode):
            eng = Engine(params_gpu, cfg, ecfg)
            t0 = time.perf_counter()
            logits, cache = _stepwise(eng, ids, forced)
            runs[tag] = (logits, sorted(eng._decode_paths), read_counts(),
                         time.perf_counter() - t0, cache)
        del eng
    del params_gpu
    got, want = runs["kernel"][0], runs["plain_decode"][0]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    launches = runs["kernel"][2]
    # where the two engines part: cache bytes (codes, and the per-chunk scale
    # and zero rows) of the tokens each wrote, and the logits in bf16 ulps of
    # max|logits| (the card's logits are bf16: one ulp flip in the top binade
    # reads between 2^-8 and 2^-7 of max|logits|)
    parted = {"codes_t": 0, "scale_t": 0, "zero_t": 0}
    for gl, wl in zip(runs["kernel"][4]["layers"], runs["plain_decode"][4]["layers"]):
        for side in ("k", "v"):
            for key in parted:
                parted[key] += int((gl[side][key] != wl[side][key]).sum())
    code_bytes = sum(l[s]["codes_t"].numel() for l in runs["kernel"][4]["layers"]
                     for s in ("k", "v"))
    top = want.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    diff = (got - want).abs()
    emit({"phase": "e2e_chunked", "model": _model_name(cfg), "layers": 2,
          "prompt": int(ids.shape[1]), "steps": len(forced), "qcfg": dataclasses.asdict(CHUNKED),
          "decode_calls_held": len(held), "decode_tol": DECODE_TOL,
          "decode_max_rel_err": max(h[3] for h in held),
          "decode_max_abs_err": max(h[2] for h in held),
          "vs_plain_decode_engine_max_rel_err": rel, "tol": E2E_CHUNKED_TOL,
          "max_abs_logit": top, "max_abs_err": diff.max().item(),
          "max_abs_err_in_bf16_ulps_of_max": diff.max().item() / ulp,
          "logits_differing_by_step": (diff > 0).sum(dim=(0, 2)).tolist(),
          "cache_bytes_differing": parted, "cache_code_bytes": code_bytes,
          "top1_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
          "launches": {k: launches[k] for k in ("palu_decode", "palu_decode_chunked",
                                                "palu_decode_k_bias",
                                                "append_kv_quantized")},
          "gpu_decode_paths": {k: v[1] for k, v in runs.items()},
          "gpu_s": {k: v[3] for k, v in runs.items()}})
    if len(held) != 2 * len(forced):
        raise AssertionError(f"e2e_chunked: {len(held)} palu_decode calls held")
    if not (torch.isfinite(got).all() and rel <= E2E_CHUNKED_TOL):
        raise AssertionError(f"e2e_chunked: vs the plain-decode engine rel err {rel}")
    if runs["kernel"][1] != ["palu_decode-kernel"] or not (
            launches["palu_decode_chunked"] == launches["palu_decode_k_bias"]
            == launches["palu_decode"] == len(held)) or launches["append_kv_quantized"]:
        raise AssertionError(f"e2e_chunked: paths {runs['kernel'][1]}, launches {launches}")


def _decode_path(ecfg) -> str:
    """The decode attention wrapper an engine with ecfg runs."""
    if ecfg.qcfg is not None:
        return palu_decode.__name__
    return (palu_decode_fp_t if ecfg.rank_major_fp else palu_decode_fp).__name__


def _path_tag(ecfg) -> str:
    """The engine's record of its decode path: the wrapper, then
    [layer_idx] for the stacked decode or [seq] for a sequence shard."""
    tag = "[layer_idx]" if ecfg.stacked_decode else "[seq]" if ecfg.seq_axis else ""
    return f"{_decode_path(ecfg)}{tag}-kernel"


def phase_e2e_fp() -> None:
    """e2e over the unquantized bf16 latent caches (qcfg None): seq-major
    (e2e_fp, palu_decode_fp) and rank-major (e2e_fp_t, palu_decode_fp_t)
    on the card against one CPU f32 run, since the plain versions read
    both layouts with the same arithmetic. No quantization boundary: the
    error is bf16 against f32 alone."""
    cfg, params, ids, forced = _e2e_inputs()
    ecfg = EngineConfig(s_max=4096, batch=1, qcfg=None, decode_chunk=512)
    cpu = Engine(_tree_to(params, "cpu", torch.float32), cfg,
                 dataclasses.replace(ecfg, dtype=torch.float32, device="cpu"))
    t0 = time.perf_counter()
    want, ccache = _stepwise(cpu, ids, forced)
    cpu_s = time.perf_counter() - t0
    n = 2048 + len(forced)

    def latents(cache):
        return [decode_latents(e[side], None, 0, torch.float32)[..., :n, :].cpu()
                for e in cache["layers"] for side in ("k", "v")]

    want_lat = latents(ccache)
    del cpu, ccache
    for tag, rank_major in (("e2e_fp", False), ("e2e_fp_t", True)):
        gpu = Engine(_tree_to(params, "cuda", torch.bfloat16), cfg,
                     dataclasses.replace(ecfg, rank_major_fp=rank_major))
        t0 = time.perf_counter()
        got, gcache = _stepwise(gpu, ids, forced)
        gpu_s = time.perf_counter() - t0
        rel = ((got - want).abs().max() / want.abs().max()).item()
        lat_rel = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(latents(gcache), want_lat))
        top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        path = _decode_path(gpu.ecfg)
        emit({"phase": tag, "layers": 2, "prompt": 2048, "steps": 16, "qcfg": None,
              "rank_major_fp": rank_major, "max_rel_err": rel, "tol": E2E_TOL,
              "top1_agreement": top1, "cache_latent_max_rel_err": lat_rel,
              "gpu_decode_paths": sorted(gpu._decode_paths), "gpu_s": gpu_s, "cpu_s": cpu_s})
        if not (torch.isfinite(got).all() and rel <= E2E_TOL):
            raise AssertionError(f"{tag}: end-to-end logits rel err {rel} > {E2E_TOL}")
        if gpu._decode_paths != {f"{path}-kernel"}:
            raise AssertionError(f"{tag}: GPU engine took {gpu._decode_paths}")
        del gpu, gcache


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


def expected_launches(layers: int, ecfg: EngineConfig, steps: int, bias: bool = False) -> dict:
    """Exact launches of every kernel but prefill_flash in `steps` decode
    steps at batch <= 8 (prefill runs the matmul paths, never the GEMVs):
    the cache's append (per-row quantized caches) and decode attention
    kernels (with the K bias for a model with biases, and per-chunk
    scales for a per-chunk cache), and the GEMVs of the weights' width."""
    bits = ecfg.weight_bits
    vt8 = ecfg.vt_bits == 8
    per_step = {fn.__name__: 0 for fn in COUNTERS if fn is not prefill_flash}
    per_step.update(palu_decode_k_bias=0, palu_decode_chunked=0)
    per_step.update({f"{fn.__name__}_{f}": 0 for fn in FEATURED for f in FEATURE_NAMES.values()})
    path = _decode_path(ecfg)
    per_step[path] = layers
    if ecfg.seq_axis is not None:  # each shard's decode: offset and statistics
        per_step[f"{path}_stats"] = per_step[f"{path}_pos_offset"] = layers
    if ecfg.stacked_decode:  # the kernel reads the stacked cache's layer
        per_step[f"{path}_layer_idx"] = layers
    if bias:
        per_step["palu_decode_k_bias"] = layers if path == "palu_decode" else 0
    if ecfg.qcfg is not None and ecfg.qcfg.group_size > 0:
        per_step["palu_decode_chunked"] = layers
    if append_supported(ecfg.qcfg):  # one launch a layer, both sides
        per_step["append_kv_quantized"] = layers
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
    reset_counts()
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
    launches = read_counts()
    steps = new_tokens * len(prompts)
    finite = bool(torch.stack(eng.finite).all().item())
    ecfg = eng.ecfg
    wkw = {k: getattr(ecfg, k) for k in ("weight_bits", "vt_bits", "embed_bits")}
    path = _decode_path(ecfg)
    emit({"phase": tag, "model": _model_name(cfg),
          "qcfg": ecfg.qcfg and dataclasses.asdict(ecfg.qcfg),
          "rank_major_fp": ecfg.rank_major_fp, **wkw,
          "requests": requests, "decode_steps": steps, "launches": launches,
          "logits_finite": finite, "decode_paths": sorted(eng._decode_paths),
          "gemv_paths": sorted(eng._gemv_paths), "weight_bytes": _weight_bytes(eng.params),
          "max_memory_allocated": torch.cuda.max_memory_allocated(), **(extra or {})})
    if not finite:
        raise AssertionError(f"{tag}: non-finite logits")
    if eng._decode_paths != {_path_tag(ecfg)}:
        raise AssertionError(f"{tag}: took {eng._decode_paths}")
    if not all(p.endswith("-kernel") or p == "dense-matmul" for p in eng._gemv_paths):
        raise AssertionError(f"{tag}: decode took {eng._gemv_paths}")
    for name, n in expected_launches(cfg.num_hidden_layers, ecfg, steps,
                                     cfg.attention_bias).items():
        if launches[name] != n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, expected {n}")
    if launches["prefill_flash"] <= 0:
        raise AssertionError(f"{tag}: prefill_flash never launched")
    return launches


def _engine(cfg, wkw, batch=1, params=None, s_max=8192, qcfg=FLAGSHIP, rank_major_fp=False,
            **ekw):
    """A checked engine on seeded random bf16 weights (or `params`); returns
    it and the seconds the weights took to make. ekw: more EngineConfig
    fields (stacked_decode, mesh, seq_axis)."""
    t0 = time.perf_counter()
    if params is None:
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   dtype=torch.bfloat16)
    eng = _CheckedEngine(params, cfg, EngineConfig(s_max=s_max, batch=batch, decode_chunk=512,
                                                   qcfg=qcfg, rank_major_fp=rank_major_fp,
                                                   **wkw, **ekw))
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _prompts(seed: int, lens, lanes: int = 1, vocab: int = VOCAB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lanes, n)) for n in lens]


def phase_serve() -> tuple:
    """bf16 weights at full depth over the 3-bit cache (serve), then the
    first REPEAT_LAYERS layers of the same weights and the same traffic
    over the unquantized rank-major cache (serve_fp: qcfg None,
    rank_major_fp, the v4 fp kernel), each with its decode and prefill
    breakdowns. Returns both runs' launches and the weights, which
    `serving` reuses."""
    cfg = llama7b(LAYERS)
    eng, init_s = _engine(cfg, {})
    prompts = _prompts(1, (1000, 3000, 7000))
    launches = serve("serve", eng, prompts, 32, {"init_s": init_s})
    decode_breakdown(eng, "serve")
    prefill_breakdown(eng, prompts[-1], "serve")
    params = eng.params
    del eng
    fp, _ = _engine(llama7b(REPEAT_LAYERS), {},
                    params=dict(params, layers=params["layers"][:REPEAT_LAYERS]), qcfg=None,
                    rank_major_fp=True)
    launches_fp = serve("serve_fp", fp, prompts, 32,
                        {"reduced": f"{REPEAT_LAYERS} of 32 layers"})
    decode_breakdown(fp, "serve_fp")
    prefill_breakdown(fp, prompts[-1], "serve_fp")
    return launches, launches_fp, params


SERVING_SAMPLING = SamplingParams(temperature=1.0, top_k=32, top_p=0.9)


def _forced_margin(eng, prompt, served) -> dict:
    """Feed a served greedy request's own tokens through batch-1 `eng`: the
    share of steps where the served token is also batch 1's argmax, and
    the largest gap (max logit - served token's logit) / max|logits|. A
    small gap says the two runs parted at a near-tie, not at a fault."""
    logits, cache = eng.prefill_auto(prompt)
    rows = [logits[0, -1]]
    for t in served[:-1]:
        logits, cache = eng.decode(np.full((1, 1), t, np.int64), cache)
        rows.append(logits[0, -1])
    lg = torch.stack(rows).float()
    tok = torch.as_tensor(served, device=lg.device)
    gap = (lg.amax(-1) - lg.gather(-1, tok[:, None])[:, 0]) / lg.abs().amax(-1)
    return {"top1_share": (gap == 0).float().mean().item(), "max_gap": gap.max().item(),
            "median_gap": gap.median().item()}


def phase_serving(params) -> dict:
    """The serving entry point at serve_bench's default configuration and
    7B width: ServingEngine over `params` (32 layers, bf16), unquantized
    seq-major latents (palu_decode_fp), 8 lanes, s_max 4096, two prefill
    chunks per decode step, the native scheduler. 24 requests, prompt
    lengths drawn from 256-2048 (numpy seed 4), 64 new tokens each, every
    fourth sampled (temperature 1.0, top-k 32, top-p 0.9)."""
    cfg = llama7b(LAYERS)
    ecfg = EngineConfig(s_max=4096, batch=8, decode_chunk=512, qcfg=None)
    return _serving("serving", params, cfg, ecfg, 24, 64, 4, VOCAB)


def _serving(tag: str, params, cfg: ModelConfig, ecfg: EngineConfig, n_requests: int,
             new_tokens: int, seed: int, vocab: int) -> dict:
    """ServingEngine over `params` on the native scheduler, two prefill
    chunks per decode step: `n_requests` requests with prompt lengths drawn
    from 256-2048 (numpy `seed`), `new_tokens` each, every fourth sampled
    (temperature 1.0, top-k 32, top-p 0.9). Counters are set to 0 just
    before the run and read just after; every request must finish and the
    decode launches be exact. Then two greedy requests again through
    batch-1 Engine.generate on the same weights: the share of equal tokens
    is reported, not asserted (at batch 8 the decode split count and the
    GEMMs' row count differ, so bf16 ties may break differently; the CPU
    tests hold exact equality)."""
    srv = ServingEngine(params, cfg, ecfg, prefer_native=True, prefill_chunks_per_step=2)
    if not isinstance(srv.sched, NativeScheduler):
        raise AssertionError(f"{tag} runs {type(srv.sched).__name__}")
    rng = np.random.default_rng(seed)
    lens = rng.integers(256, 2049, n_requests)
    prompts = {rid: rng.integers(0, vocab, (1, int(n))) for rid, n in enumerate(lens)}
    sampled = {rid for rid in prompts if rid % 4 == 3}
    for rid, p in prompts.items():
        if not srv.submit(rid, p, new_tokens,
                          sampling=SERVING_SAMPLING if rid in sampled else None):
            raise AssertionError(f"{tag}: request {rid} refused")
    decode_steps = [0]
    decode = srv.engine.decode

    def counted(*a, **kw):
        decode_steps[0] += 1
        return decode(*a, **kw)

    srv.engine.decode = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s = []
    t0 = time.perf_counter()
    while (srv.sched.num_queued() > 0 or any(a != -1 for a in srv.sched.active())) \
            and len(step_s) < 10000:
        ts = time.perf_counter()
        srv.step()
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    stats = srv.sched.stats()
    out = srv.outputs
    n_tokens = sum(len(out[r]) for r in prompts)
    in_vocab = all(0 <= t < vocab for r in prompts for t in out[r])
    greedy = [r for r in prompts if r not in sampled][:2]
    match, forced = {}, {}
    for r in greedy:
        ref = srv.prefill_engine.generate(prompts[r], max_new_tokens=new_tokens)[0]
        match[r] = float(np.mean(ref == np.asarray(out[r])))
        forced[r] = _forced_margin(srv.prefill_engine, prompts[r], out[r])
    path = _decode_path(ecfg)
    emit({"phase": tag, "model": _model_name(cfg),
          "qcfg": ecfg.qcfg and dataclasses.asdict(ecfg.qcfg), "lanes": ecfg.batch,
          "s_max": ecfg.s_max, "prefill_chunks_per_step": 2,
          "scheduler": type(srv.sched).__name__, "requests": len(prompts),
          "prompt_lens": [int(n) for n in lens], "sampled": sorted(sampled),
          "new_tokens": new_tokens, "finished": stats["finished"], "tokens": n_tokens,
          "sched_stats": stats, "elapsed_s": elapsed, "tokens_per_s": n_tokens / elapsed,
          "steps": len(step_s), "decode_steps": decode_steps[0],
          "median_step_ms": float(np.median(step_s)) * 1e3,
          "p90_step_ms": float(np.percentile(step_s, 90)) * 1e3,
          "launches": launches, "decode_paths": sorted(srv.engine._decode_paths),
          "weight_bytes": _weight_bytes(srv.engine.params),
          "cache_nbytes": cache_nbytes(srv.cache),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "greedy_equal_to_batch1_generate": match,
          "greedy_teacher_forced_batch1": forced})
    if stats != {"admitted": n_requests, "finished": n_requests,
                 "tokens": n_requests * new_tokens} or \
            n_tokens != stats["tokens"] or any(len(out[r]) != new_tokens for r in prompts):
        raise AssertionError(f"{tag}: {stats}, {n_tokens} tokens")
    if not in_vocab:
        raise AssertionError(f"{tag}: a token outside the vocabulary")
    if srv.engine._decode_paths != {f"{path}-kernel"}:
        raise AssertionError(f"{tag} took {srv.engine._decode_paths}")
    want = expected_launches(cfg.num_hidden_layers, ecfg, decode_steps[0], cfg.attention_bias)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, "
                                 f"expected {n}")
    srv.engine.decode = decode
    decode_breakdown(srv.engine, tag, cache=srv.cache)  # all lanes, after the counts
    return launches


def phase_serve_qwen2() -> tuple:
    """Qwen2-7B at full width and depth (28 layers, bf16 random weights with
    nonzero q/k/v biases) through Engine.generate over the per-row 3-bit
    cache: serve's traffic (1000 / 3000 / 7000-token prompts, 32 new tokens,
    s_max 8192), every decode launch with the K bias and the exact launches
    per step asserted, then its decode and prefill breakdowns. Returns the
    launches and the weights, which serving_qwen2 reuses."""
    cfg = qwen2_7b(QWEN2_7B["num_hidden_layers"])
    t0 = time.perf_counter()
    params = qwen2_params(cfg)
    eng, init_s = _engine(cfg, {}, params=params)
    prompts = _prompts(11, (1000, 3000, 7000), vocab=QVOCAB)
    launches = serve("serve_qwen2", eng, prompts, 32,
                     {"init_s": time.perf_counter() - t0, "config": QWEN2_SOURCE,
                      "group_ranks": QRANK, "heads_per_group": QHPG,
                      "reduced": "random weights (no checkpoint in the repository)"})
    decode_breakdown(eng, "serve_qwen2")
    prefill_breakdown(eng, prompts[-1], "serve_qwen2")
    del eng
    return launches, params


def phase_serving_qwen2(params) -> dict:
    """The same Qwen2-7B weights through the ServingEngine on the native
    scheduler over the per-chunk cache (3-bit asym, one scale and zero per
    32 ranks, CHUNKED): 8 lanes, s_max 4096, 16 requests of 256-2048
    tokens (numpy seed 12), 32 new tokens each, 4 of them sampled."""
    cfg = qwen2_7b(QWEN2_7B["num_hidden_layers"])
    ecfg = EngineConfig(s_max=4096, batch=8, decode_chunk=512, qcfg=CHUNKED)
    return _serving("serving_qwen2", params, cfg, ecfg, 16, 32, 12, QVOCAB)


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
    decode_breakdown(lanes, "lanes_w4")
    return launches


def phase_serve_w8() -> dict:
    """int8 weights, VT and embedding at full width, 4 layers, one request."""
    eng, init_s = _engine(llama7b(4), W8)
    return serve("serve_w8", eng, _prompts(3, (1000,)), 32,
                 {"init_s": init_s, "reduced": "4 of 32 layers"})


# ---------------------------------------------------------------------------
# 6. the latency entry points (palu_tpu_torch/cli)
# ---------------------------------------------------------------------------


def _only(counts: dict, want: dict, tag: str) -> None:
    """Raise unless the launch counts are exactly `want` (others 0)."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")


def phase_latency_kernel() -> dict:
    """run_latency_kernel at 4K / 16K / 64K with the 7B ranks (rank_k 1024,
    rank_v 3072, groups of 4), providers WX and ours (xla at 4K and 16K,
    in a second run of the CLI), over bf16
    latents (ours: palu_decode_fp) and the exact 3-bit seq-major cache
    (ours: palu_decode_seq_quantized). Counts are set to 0 just before
    each run and read just after: `ours` is 10 warm-up and 50 timed
    launches per length, and nothing else launches a kernel. Returns the
    3-bit run's counts."""
    # (lengths, providers): the plain PyTorch provider (xla) is not run at
    # 64K, where it took ~10 s a run (0.13-0.17 s a call)
    runs = (((4096, 16384), ("WX", "xla", "ours")), ((65536,), ("WX", "ours")))
    out = {}
    for lt, fn in (("16", palu_decode_fp), ("3", palu_decode_seq_quantized)):
        argvs = [["--target_seq_lens", *map(str, lens), "--total_rank_v", "3072",
                  "--lt_bits", lt, "--providers", *providers, "--json"]
                 for lens, providers in runs]
        reset_counts()
        t0 = time.perf_counter()
        rows = []
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own records
            for argv in argvs:
                rows += run_latency_kernel.main(argv)
        torch.cuda.synchronize()
        counts = read_counts()
        _only(counts, {fn.__name__: 60 * len(rows)}, f"latency_kernel lt_bits {lt}")
        emit({"phase": "latency_kernel", "argv": argvs, "rows_us": rows,
              "providers": {"ours": fn.__name__, "xla": "ops/attention.flash_decode_latent "
                            "(plain PyTorch)", "WX": "ops/attention.dense_decode_sdpa over "
                            "dense bf16 K/V (one scaled_dot_product_attention call)"},
              "launches": counts, "seconds": time.perf_counter() - t0})
        out[lt] = counts
    return out["3"]


ATTN_3BIT = ["--palu", "--lt_bits", "3", "--lt_sym", "--lt_container", "4"]


def phase_latency_attention() -> dict:
    """run_latency_attention at --prompt_len 65536 (batch 1, rank_k 1024,
    rank_v 3072, groups of 4; random weights and a seeded cache): the
    flagship 3-bit cache as is, with --int8_rot and with --int8_dots, and
    the dense-KV baseline, each at the CLI's default of 1 layer; then the
    3-bit cache at 32 layers and Llama-2-7B's MLP width (BASELINE.md's
    point at full depth), as is and with --int8_rot. Each run: counts 0 just before and read just
    after; the decode path and the launches per step (10 warm-up + 100
    timed) asserted; then a decode breakdown at the 64K context. Returns
    {run: counts}."""
    steps = 110
    runs = [  # (tag, extra flags, layers, decode path, counter of its decode kernel)
        ("palu_3bit", ATTN_3BIT, 1, "palu_decode-kernel", "palu_decode"),
        ("palu_3bit_int8_rot", [*ATTN_3BIT, "--int8_rot"], 1, "palu_decode_int8_rot-kernel",
         "palu_decode_int8_rot"),
        ("palu_3bit_int8_dots", [*ATTN_3BIT, "--int8_dots"], 1,
         "palu_decode_int8_dots-kernel", "palu_decode_int8_dots"),
        ("dense", [], 1, "dense_sdpa-kernel", None),
        ("palu_3bit_32_layers", [*ATTN_3BIT, "--num_layers", "32", "--intermediate_size",
                                 "11008"], 32, "palu_decode-kernel", "palu_decode"),
        ("palu_3bit_int8_rot_32_layers", [*ATTN_3BIT, "--int8_rot", "--num_layers", "32",
                                          "--intermediate_size", "11008"], 32,
         "palu_decode_int8_rot-kernel", "palu_decode_int8_rot"),
    ]
    counts_by_run, tpot = {}, {}
    for tag, extra, layers, path, counter in runs:
        argv = ["--prompt_len", "65536", *extra, "--json"]
        args = run_latency_attention.parser().parse_args(argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        stats, eng = run_latency_attention.run(args)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {}
        if counter is not None:
            want = {counter: layers * steps, "palu_decode": layers * steps,
                    "append_kv_quantized": layers * steps}
        emit({"phase": "latency_attention", "run": tag, "argv": argv, "layers": layers,
              **stats, "decode_paths": sorted(eng._decode_paths),
              "gemv_paths": sorted(eng._gemv_paths), "launches": counts,
              "launches_per_step": {k: v / steps for k, v in counts.items() if v},
              "weight_bytes": _weight_bytes(eng.params),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "seconds": time.perf_counter() - t0})
        if eng._decode_paths != {path}:
            raise AssertionError(f"latency_attention {tag}: took {eng._decode_paths}")
        _only(counts, want, f"latency_attention {tag}")
        if not all(p == "dense-matmul" for p in eng._gemv_paths):
            raise AssertionError(f"latency_attention {tag}: weights took {eng._gemv_paths}")
        # where one step's time goes, from a freshly seeded cache (after
        # the counts were read)
        eng.last_cache = profiler.seed_cache_random(eng, 65536)
        decode_breakdown(eng, f"latency_attention {tag}")
        counts_by_run[tag] = counts
        tpot[tag] = stats["tpot_ms"]
        del eng
    emit({"phase": "latency_attention_summary", "prompt_len": 65536, "tpot_ms": tpot,
          "dense_over_palu_3bit_1_layer": tpot["dense"] / tpot["palu_3bit"]})
    return counts_by_run


def phase_serve_bench_int8_rot() -> dict:
    """serve_bench --int8_rot at 7B attention width and depth (32 heads, 32
    layers, rank 128 per group for K and V, 3-bit sym latents in nibble
    containers, rotation blocks of 2048): 8 lanes, s_max 4096, 16 requests
    with prompts of 1024-2048 tokens, 32 new tokens each, on the native
    scheduler. Counts 0 just before and read just after; every decode step
    launches the int8_rot decode and one two-side append per layer."""
    argv = ["--int8_rot", "--lt_bits", "3", "--lt_sym", "--lt_container", "4",
            "--num_heads", "32", "--num_layers", "32", "--lanes", "8", "--s_max", "4096",
            "--prompt_len", "2048", "--pallas_block", "2048", "--json"]
    args = serve_bench.parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out, srv = serve_bench.run(args)
    torch.cuda.synchronize()
    counts = read_counts()
    n_dec = counts["palu_decode"]
    emit({"phase": "serve_bench_int8_rot", "argv": argv, **out,
          "sched_stats": srv.sched.stats(), "decode_paths": sorted(srv.engine._decode_paths),
          "pallas_block": srv.engine._pallas_block, "launches": counts,
          "decode_steps": n_dec / args.num_layers,
          "cache_nbytes": cache_nbytes(srv.cache),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0})
    n_tok = args.num_requests * args.max_new_tokens
    if not isinstance(srv.sched, NativeScheduler) or out["requests"] != args.num_requests \
            or out["total_tokens"] != n_tok \
            or any(len(t) != args.max_new_tokens for t in srv.outputs.values()):
        raise AssertionError(f"serve_bench_int8_rot: {out}")
    if not all(0 <= t < args.vocab_size for toks in srv.outputs.values() for t in toks):
        raise AssertionError("serve_bench_int8_rot: a token outside the vocabulary")
    if srv.engine._decode_paths != {"palu_decode_int8_rot-kernel"} or \
            srv.engine._pallas_block != 2048:
        raise AssertionError(f"serve_bench_int8_rot took {srv.engine._decode_paths}")
    _only(counts, {"palu_decode": n_dec, "palu_decode_int8_rot": n_dec,
                   "append_kv_quantized": n_dec,
                   "prefill_flash": counts["prefill_flash"]}, "serve_bench_int8_rot")
    if n_dec <= 0 or n_dec % args.num_layers or counts["prefill_flash"] <= 0:
        raise AssertionError(f"serve_bench_int8_rot: launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# 7. the compression path (palu_tpu_torch/compression, cli/compress)
# ---------------------------------------------------------------------------

COMPRESS_RATIO = 0.5  # fisher_uniform at 0.5: about half of group_dim (512) per group


def dense7b(layers: int) -> ModelConfig:
    """Llama-2-7B widths, dense k/v projections (no Palu ranks yet)."""
    return dataclasses.replace(llama7b(layers), head_wise_ranks=None)


@contextlib.contextmanager
def _palu_cache_dir():
    """PALU_CACHE_DIR in a temporary directory, so the Fisher and whiten
    caches are neither read from nor written into the repository's own."""
    old = os.environ.get("PALU_CACHE_DIR")
    d = tempfile.mkdtemp(prefix="palu_cache_")
    os.environ["PALU_CACHE_DIR"] = d
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)
        if old is None:
            del os.environ["PALU_CACHE_DIR"]
        else:
            os.environ["PALU_CACHE_DIR"] = old


def _compress_on_card(layers: int, hadamard=(True,)):
    """A dense Llama-2-7B-width model (bf16, random from seed 0) on the
    card, rank search (fisher_uniform at COMPRESS_RATIO, groups of 4) and
    whitened G-LRD on synthetic calibration (4 batches of 512 tokens), once
    per entry of `hadamard`. Returns ({hadamard: (params, cfg)}, the dense
    params, seconds per step, the launch counts of each compression and
    the rank search's print)."""
    cfg = dense7b(layers)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    calib = synthetic_batches(cfg.vocab_size, 4, 512)
    secs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        sel = search_ranks(params, cfg, COMPRESS_RATIO, "fisher_uniform", 4,
                           calib_batches=calib)
    torch.cuda.synchronize()
    secs["fisher_and_search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scales = whiten_scale_matrices(params, cfg, calib)
    torch.cuda.synchronize()
    secs["whiten"] = time.perf_counter() - t0
    out, launches = {}, {}
    for had in hadamard:
        reset_counts()
        t0 = time.perf_counter()
        out[had] = compress_params(params, cfg, sel, "whiten", 4, whiten_scales=scales,
                                   hadamard=had, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        secs[f"decompose{'_hadamard' if had else ''}"] = time.perf_counter() - t0
        launches[had] = read_counts()
    return out, params, secs, launches, printed.getvalue().strip()


@contextlib.contextmanager
def _engine_decode(fn):
    """Engines run `fn` in place of ops/palu_decode.palu_decode inside."""
    real = engine_mod.palu_decode
    engine_mod.palu_decode = fn
    try:
        yield
    finally:
        engine_mod.palu_decode = real


def _held_engine_decode(held: list, what: str):
    """palu_decode that also runs palu_decode_ref on the same inputs (the
    engine's own cache) and holds the kernel at DECODE_TOL, appending (rk,
    rv, abs err, rel err) to `held`."""
    def decode(*args, **kw):
        got = palu_decode(*args, **kw)
        held.append((kw["rk"], kw["rv"], *_held_decode(what, got, palu_decode_ref(*args, **kw))))
        return got
    return decode


def phase_compress(layers: int = LAYERS) -> dict:
    """The compression path end to end on the card at Llama-2-7B width:
    dense model -> Fisher rank search (fisher_uniform) -> whitened G-LRD ->
    Hadamard fusion (the FWHT kernel, 2 launches per group: 2 * 8 groups *
    2 sides * layers, counts set to 0 just before and read just after the
    decomposition) -> fused o_proj, then the compressed model served by
    Engine over the 3-bit cache: a 1000-token prompt, 32 greedy tokens,
    through palu_decode's kernel at group ranks above 128. One more decode
    step over the served cache then holds each layer's palu_decode launch
    at DECODE_TOL against palu_decode_ref on the same inputs: the model's
    own ranks, 192-512, several ending in a partial rank chunk. Returns the
    decomposition's counts."""
    t_all = time.perf_counter()
    with _palu_cache_dir():
        comp, dense, secs, launches, printed = _compress_on_card(layers)
    del dense
    params, cfg = comp[True]
    del comp
    ranks = sorted({r for rs in cfg.head_wise_ranks.values() for r in rs})
    want = {"hadamard_transform": 2 * G * 2 * layers}
    _only(launches[True], want, "compress: decomposition")
    if max(ranks) <= 128:
        raise AssertionError(f"compress: ranks {ranks} hold none above 128")
    torch.cuda.empty_cache()
    eng, _ = _engine(cfg, {}, params=params)
    t0 = time.perf_counter()
    serve("compress", eng, _prompts(5, (1000,)), 32,
          {"search": "fisher_uniform", "ratio": COMPRESS_RATIO, "decompose": "whiten",
           "hadamard": True, "calibration": "synthetic_batches(32000, 4, 512)",
           "rank_search_print": printed, "group_ranks": ranks,
           "k_ranks_per_layer": [cfg.head_wise_ranks[f"model.layers.{i}.self_attn.k_proj"][0]
                                 for i in range(layers)],
           "v_ranks_per_layer": [cfg.head_wise_ranks[f"model.layers.{i}.self_attn.v_proj"][0]
                                 for i in range(layers)],
           "decomposition_launches": launches[True]})
    secs["serve"] = time.perf_counter() - t0
    held = []
    with _engine_decode(_held_engine_decode(held, "compress: the served model's palu_decode")):
        eng.decode(np.zeros((1, 1), np.int64), eng.last_cache)
    pairs = sorted({h[:2] for h in held})
    emit({"phase": "compress_decode_held", "layers": layers, "calls": len(held),
          "context": int(eng.last_cache["length"][0]), "rk_rv": pairs, "tol": DECODE_TOL,
          "max_rel_err": max(h[3] for h in held), "max_abs_err": max(h[2] for h in held)})
    if len(held) != layers or not any(rk % 128 for rk, _ in pairs):
        raise AssertionError(f"compress: held {len(held)} decode calls at {pairs}")
    emit({"phase": "compress_time", "layers": layers, "seconds": secs,
          "phase_s": time.perf_counter() - t_all})
    del eng, params
    torch.cuda.empty_cache()
    return launches[True]


def phase_compress_check() -> None:
    """The numbers at 2 layers of the same width, a 1024-token prompt and 15
    teacher-forced steps: compress_params with and without Hadamard fusion
    give forward logits on the card within E2E_TOL of each other (the
    rotation cancels in U VT^T: JAX's
    test_compress_with_hadamard_preserves_logits); the card's engine over
    the fused params and unquantized latents (palu_decode_fp, group ranks
    up to 512) gives per-step logits within E2E_TOL of the port's f32 CPU
    forward of the same params. Over the 3-bit cache, every palu_decode
    launch of the card's engine is held at DECODE_TOL against palu_decode_ref
    on the same inputs (the card's own cache, at the model's ranks), and
    its per-step logits within E2E_TOL of an engine on the card that runs
    palu_decode_ref in its place. The 3-bit engines against the CPU's f32
    engine and forward are reported, not held: at these random whitened
    factors the 3-bit cache's own error is most of max|logits| (the JAX
    engine's too, tests/test_torch_compression.py)."""
    with _palu_cache_dir():
        comp, dense, secs, launches, _ = _compress_on_card(2, hadamard=(True, False))
    del dense
    (had, cfg), (plain, _) = comp[True], comp[False]
    ids = np.random.default_rng(6).integers(0, VOCAB, (1, 1024))
    forced = np.random.default_rng(7).integers(0, VOCAB, 15)
    full = torch.as_tensor(np.concatenate([ids, forced[None, :]], 1), device="cuda")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    had_cpu = _tree_to(had, "cpu", torch.float32)
    with torch.no_grad():
        had_rel = rel(llama.forward(had, full, cfg).float(),
                      llama.forward(plain, full, cfg).float())
        fwd = llama.forward(had_cpu, full.cpu(), cfg)[:, 1023:]
    held = []
    decode_held = _held_engine_decode(held, "compress_check: the 3-bit engine's palu_decode")
    ecfg = EngineConfig(s_max=2048, batch=1, qcfg=None, decode_chunk=512)
    runs = {}
    for tag, qcfg, decode in (("fp", None, palu_decode), ("3bit", FLAGSHIP, decode_held),
                              ("3bit_plain_decode", FLAGSHIP, palu_decode_ref)):
        with _engine_decode(decode):
            gpu = Engine(had, cfg, dataclasses.replace(ecfg, qcfg=qcfg))
            runs[tag] = (_stepwise(gpu, ids, forced)[0], sorted(gpu._decode_paths))
        del gpu
    cpu = Engine(had_cpu, cfg,
                 dataclasses.replace(ecfg, qcfg=FLAGSHIP, dtype=torch.float32, device="cpu"))
    cpu3 = _stepwise(cpu, ids, forced)[0]
    fp_rel, plain3_rel = rel(runs["fp"][0], fwd), rel(runs["3bit"][0], runs["3bit_plain_decode"][0])
    emit({"phase": "compress_check", "layers": 2, "prompt": 1024, "steps": 15,
          "hadamard_vs_plain_forward_max_rel_err": had_rel, "tol": E2E_TOL,
          "engine_fp_card_vs_cpu_f32_forward_max_rel_err": fp_rel,
          "engine_3bit_decode_calls_held": len(held), "decode_tol": DECODE_TOL,
          "engine_3bit_decode_vs_plain_max_rel_err": max(h[3] for h in held),
          "engine_3bit_decode_vs_plain_max_abs_err": max(h[2] for h in held),
          "engine_3bit_vs_plain_decode_engine_max_rel_err": plain3_rel,
          "reported_engine_3bit_card_vs_cpu_f32_engine_max_rel_err": rel(runs["3bit"][0], cpu3),
          "reported_engine_3bit_cpu_f32_vs_forward_max_rel_err": rel(cpu3, fwd),
          "top1_agreement_3bit_vs_cpu": (runs["3bit"][0].argmax(-1) == cpu3.argmax(-1)).float()
          .mean().item(),
          "gpu_decode_paths": {k: v[1] for k, v in runs.items()},
          "group_ranks": sorted({r for rs in cfg.head_wise_ranks.values() for r in rs}),
          "seconds": secs, "decomposition_launches": launches})
    if not (math.isfinite(had_rel) and had_rel <= E2E_TOL):
        raise AssertionError(f"compress_check: Hadamard vs plain logits rel err {had_rel}")
    if not (torch.isfinite(runs["fp"][0]).all() and fp_rel <= E2E_TOL):
        raise AssertionError(f"compress_check: card engine vs CPU forward rel err {fp_rel}")
    if len(held) != 2 * 15:  # 2 layers x 15 decode steps
        raise AssertionError(f"compress_check: {len(held)} palu_decode calls held, not 30")
    if not (torch.isfinite(runs["3bit"][0]).all() and plain3_rel <= E2E_TOL):
        raise AssertionError(f"compress_check: 3-bit engine vs the plain-decode engine rel "
                             f"err {plain3_rel}")
    if runs["fp"][1] != ["palu_decode_fp-kernel"] or runs["3bit"][1] != ["palu_decode-kernel"]:
        raise AssertionError(f"compress_check: GPU engines took {runs}")


def phase_compress_cli() -> None:
    """cli.compress as a user runs it: hf_io.save_checkpoint writes a
    2-layer 7B-width dense checkpoint (f16, the port's own safetensors
    writer), `python -m palu_tpu_torch.cli.compress --search_method uniform
    --decompose_method svd --hadamard --param_ratio_target 0.5` compresses
    it in a subprocess (default output directory), hf_io.load_params reads
    the result back (rank 256 in every group) and the engine serves it."""
    root = Path(__file__).resolve().parent
    with _palu_cache_dir() as d:
        src = os.path.join(d, "llama-2-7b-width-2-layers")
        cfg = dense7b(2)
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   dtype=torch.bfloat16)
        t0 = time.perf_counter()
        hf_io.save_checkpoint(params, cfg, src)
        save_s = time.perf_counter() - t0
        del params
        argv = ["--model_name_or_path", src, "--search_method", "uniform",
                "--decompose_method", "svd", "--hadamard", "--param_ratio_target", "0.5"]
        env = dict(os.environ, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "palu_tpu_torch.cli.compress", *argv],
                              cwd=d, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        out_dir = os.path.join(d, "llama-2-7b-width-2-layers_ratio-0.5_gs-4-uniform")
        if proc.returncode != 0:
            raise AssertionError(f"cli.compress exited {proc.returncode}: {proc.stderr[-3000:]}")
        params, ccfg = hf_io.load_params(out_dir)
        ranks = {r for rs in ccfg.head_wise_ranks.values() for r in rs}
        eng, _ = _engine(ccfg, {}, params=params, s_max=2048)
        serve("compress_cli", eng, _prompts(8, (512,)), 8,
              {"argv": argv, "returncode": proc.returncode, "stdout": proc.stdout.strip(),
               "group_ranks": sorted(ranks), "checkpoint_bytes": os.path.getsize(
                   os.path.join(src, "model.safetensors")),
               "save_s": save_s, "cli_s": cli_s})
        if ranks != {256}:
            raise AssertionError(f"compress_cli: ranks {ranks}, expected 256 in every group")
        del eng, params
        torch.cuda.empty_cache()
        phase_evals(out_dir)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 7b. the accuracy track (palu_tpu_torch/evals, cli/common.load_for_eval)
# ---------------------------------------------------------------------------

# A window's NLL, bf16 on the card against the port's f32 forward on the CPU
# (same bf16-rounded weights), as a share of the f32 NLL, unquantized. The
# same comparison between the port's plain paths in bf16 and in f32 on the
# CPU (hidden 1024, 2 layers, vocab 32000, 512-token windows) reads 3-5e-5;
# the H100 at 7B widths read 5.3e-5 and 1.1e-4 on the two 1024-token
# windows: each token's NLL moves by a few bf16 roundings of its logits and
# the mean over the window cancels most of them. 4e-4 is 3.5x the larger
# reading; a broken mask, norm or attention moves the mean token NLL by far
# more than 4e-4 of its ~11 nats.
# With the 3-bit hook the gap is reported, not held: the bf16 latents on the
# card take the neighbouring code wherever the f32 latent sits near a
# rounding edge, and those flips moved the NLL by 3.7e-4 and 7.4e-4 on the
# card, while the whole hook moved it by only 1.6e-3 and 4.0e-3, so no
# limit separates a sound run from one without the hook. Held instead: in
# every window the hook moves the card's NLL by more than the card's
# unquantized gap to the CPU (a dropped hook moves it by nothing).
NLL_TOL = 4e-4
# the bucketed score against the same request scored alone and unpadded, in
# f32 on the card (TF32 off): tests/test_evals.py:226's bound
BUCKET_TOL = 1e-3


class ByteTokenizer:
    """A byte-level tokenizer with the HF surface the evals use: ids are
    [bos] + (3 + byte); decode writes a byte id as its byte and any other
    id as <id>, so a random model's tokens stay visible in the text."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, text, return_tensors=None, add_special_tokens=True):
        ids = ([self.bos_token_id] if add_special_tokens else []) + [
            3 + b for b in text.encode("utf-8")]
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        out = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if 3 <= i < 259:
                out.append(chr(i - 3))
            elif not (skip_special_tokens and i in (1, 2)):
                out.append(f"<{i}>")
        return "".join(out)


def zero_shot_docs(task):
    """Two documents of each of the six default tasks, in lm-eval's fields
    (the CPU tests' fixture too)."""
    abcd = ["A", "B", "C", "D"]
    return {
        "openbookqa": [
            {"question_stem": "The sun is a", "choices": {
                "text": ["star", "planet", "moon", "rock"], "label": abcd}, "answerKey": "A"},
            {"question_stem": "Water freezes when it is", "choices": {
                "text": ["heated", "cooled", "stirred", "poured"], "label": abcd},
             "answerKey": "B"}],
        "hellaswag": [
            {"ctx": "A man opens the front door and", "endings": [
                "walks into the house.", "sings to the moon.", "flies away.",
                "melts slowly."], "label": "0"},
            {"ctx": "She picks up the pen and", "endings": [
                "eats it whole.", "writes a letter.", "runs a race.", "sleeps."],
             "label": "1"}],
        "piqa": [
            {"goal": "open a jar", "sol1": "twist the lid", "sol2": "shout at it",
             "label": 0},
            {"goal": "dry wet hands", "sol1": "wet them more", "sol2": "use a towel",
             "label": 1}],
        "arc_easy": [
            {"question": "What do plants need to grow?", "choices": {
                "text": ["light", "noise", "salt"], "label": abcd[:3]}, "answerKey": "A"},
            {"question": "Ice is", "choices": {"text": ["hot", "cold", "loud", "green"],
                                               "label": ["1", "2", "3", "4"]},
             "answerKey": "2"}],
        "arc_challenge": [
            {"question": "Which animal is a mammal?", "choices": {
                "text": ["shark", "whale", "trout", "eel"], "label": abcd}, "answerKey": "B"},
            {"question": "Iron rusts when it meets", "choices": {
                "text": ["oxygen", "helium"], "label": abcd[:2]}, "answerKey": "A"}],
        "winogrande": [
            {"sentence": "The cup fell off the table because _ was tilted.",
             "option1": "the cup", "option2": "the table", "answer": "2"},
            {"sentence": "Anna lent Maria a book since _ had finished it.",
             "option1": "Anna", "option2": "Maria", "answer": "1"}],
    }[task]


LONGBENCH_WORDS = ("the model reads a long context and answers a short question about "
                   "its rows columns ranks caches latents and tokens").split()


def _longbench_docs(name):
    """Two samples of qasper or trec with ~1500-byte (so ~1500-token)
    contexts from a seeded word stream."""
    rng = np.random.default_rng(len(name))
    docs = []
    for i in range(2):
        context = " ".join(rng.choice(LONGBENCH_WORDS, 260).tolist())[:1500]
        docs.append({"context": context, "input": f"What is row {i}?",
                     "answers": ["the model", "rows"],
                     "all_classes": ["Location", "Person", "Number", "Description"]})
    return docs


def _counting_decode(eng):
    """Count the engine's decode calls (steps) in eng.steps."""
    eng.steps = 0
    real = eng.decode

    def decode(*a, **kw):
        eng.steps += 1
        return real(*a, **kw)

    eng.decode = decode


def _evals_load(ckpt: str) -> tuple:
    """load_for_eval --lt_hadamard on the card: exact FWHT launches (2 per
    group and side: 2 * 8 groups * 2 sides * 2 layers) and the forward's
    logits within E2E_TOL of the unfused load's (the rotation cancels)."""
    ns = lambda had: argparse.Namespace(model_name_or_path=ckpt, lt_hadamard=had,
                                        use_cpu=False)
    plain, _ = cli_common.load_for_eval(ns(False))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    params, cfg = cli_common.load_for_eval(ns(True))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches = read_counts()
    layers = cfg.num_hidden_layers
    _only(launches, {"hadamard_transform": 2 * G * 2 * layers}, "evals: load_for_eval")
    ids = torch.as_tensor(np.random.default_rng(11).integers(0, VOCAB, (1, 512)),
                          device="cuda")
    with torch.no_grad():
        a = llama.forward(params, ids, cfg).float()
        b = llama.forward(plain, ids, cfg).float()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    if not (torch.isfinite(a).all() and rel <= E2E_TOL):
        raise AssertionError(f"evals: fused vs unfused logits rel err {rel}")
    return params, cfg, {"load_s": load_s, "hadamard_launches": launches["hadamard_transform"],
                         "fused_vs_unfused_logits_max_rel_err": rel}


def _evals_ppl(params, cfg) -> dict:
    """eval_ppl_on_tokens on seeded synthetic tokens: 2 windows at 1024 on
    the card (bf16) with and without the 3-bit sym hook against the port's
    f32 CPU run of the same params and tokens, each unquantized window's
    NLL held at NLL_TOL, the hooked ones' gap reported and the hook's move
    held (see NLL_TOL); then 4 windows at the reference's 2048, timed."""
    tokens = np.random.default_rng(12).integers(0, VOCAB, (1, 4 * 2048 + 5))
    cpu = _tree_to(params, "cpu", torch.float32)
    hooks = {"bf16": None, "3bit_sym": QuantConfig(bits=3, sym=True)}
    out = {}
    for tag, qcfg in hooks.items():
        hook = evals_ppl.latent_hook(qcfg)
        wins = torch.as_tensor(tokens[0, :2 * 1024].reshape(2, 1024))
        got = [evals_ppl.window_nlls(params, cfg, w[None].cuda(), 1024, hook).item()
               for w in wins]
        want = [evals_ppl.window_nlls(cpu, cfg, w[None], 1024, hook).item() for w in wins]
        rel = [abs(g - w) / w for g, w in zip(got, want)]
        ppl_card = evals_ppl.eval_ppl_on_tokens(params, cfg, tokens[:, :2 * 1024], 1024, qcfg,
                                                progress=False)
        ppl_cpu = float(np.exp(np.sum(want) / (2 * 1024)))
        evals_ppl.eval_ppl_on_tokens(params, cfg, tokens[:, :2048], 2048, qcfg,
                                     progress=False)  # warm the 2048 shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl_2048 = evals_ppl.eval_ppl_on_tokens(params, cfg, tokens, 2048, qcfg, progress=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 4 * 1e3
        out[tag] = {"window_nll_card": got, "window_nll_cpu_f32": want,
                    "window_nll_max_rel_err": max(rel), "ppl_1024_card": ppl_card,
                    "ppl_1024_cpu_f32": ppl_cpu, "ppl_2048_card": ppl_2048,
                    "ms_per_window_2048": ms}
        if not all(math.isfinite(g) for g in got) or (qcfg is None and max(rel) > NLL_TOL):
            raise AssertionError(f"evals: {tag} window NLL card vs CPU f32 rel err {rel}")
    fp, q3 = out["bf16"], out["3bit_sym"]
    gap = [abs(g - w) for g, w in zip(fp["window_nll_card"], fp["window_nll_cpu_f32"])]
    moved = [abs(a - b) for a, b in zip(q3["window_nll_card"], fp["window_nll_card"])]
    q3["hook_moved_card_nll"] = moved
    if not all(m > g for m, g in zip(moved, gap)):
        raise AssertionError(f"evals: the 3-bit hook moved the card's NLLs by {moved}, "
                             f"within the unquantized card-vs-CPU gap {gap}")
    del cpu
    return {"tol": NLL_TOL, "windows_held": 2, "seqlen_held": 1024, "windows_timed": 4,
            "seqlen_timed": 2048, **out}


def _evals_zero_shot(params, cfg, tok) -> dict:
    """run_zero_shot on the six tasks' fixtures (bf16, the 3-bit sym hook);
    then every request's loglikelihood_batch score (bucketed, batch 8) held
    at BUCKET_TOL against the request scored alone and unpadded, in f32 on
    the card, greedy flags equal (the bf16 gap reported)."""
    qcfg = QuantConfig(bits=3, sym=True)
    shapes0 = set(evals_zero_shot._LL_SHAPES)
    t0 = time.perf_counter()
    acc = evals_zero_shot.run_zero_shot(params, cfg, tok, qcfg=qcfg,
                                        data_loader=zero_shot_docs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    reqs = []
    for task in evals_zero_shot.DEFAULT_TASKS:
        for doc in zero_shot_docs(task):
            ctx, choices, _, varies = evals_zero_shot.make_mc_requests(task, doc, tok)
            ids = lambda t: tok(t, return_tensors="np")["input_ids"][0].tolist()
            ctxs = ctx if varies else [ctx] * len(choices)
            reqs += [(ids(c), ids(ch)[1:]) for c, ch in zip(ctxs, choices)]
    gaps = {}
    for tag, p in (("f32", _tree_to(params, "cuda", torch.float32)), ("bf16", params)):
        batched = evals_zero_shot.loglikelihood_batch(p, cfg, reqs, batch_size=8)
        ll = evals_zero_shot._ll_fn(cfg, None)
        errs, flags = [], []
        for (ctx, cont), (s, e) in zip(reqs, batched):
            ids = torch.as_tensor([ctx + cont], device="cuda")
            mask = torch.zeros(ids.shape, device="cuda")
            mask[0, len(ctx):] = 1.0
            s1, e1 = ll(p, ids, mask)
            errs.append(abs(s - s1.item()))
            flags.append(e == bool(e1.item()))
        gaps[tag] = {"max_abs_err": max(errs), "flags_equal": all(flags)}
        del p
    if not (gaps["f32"]["max_abs_err"] <= BUCKET_TOL and gaps["f32"]["flags_equal"]):
        raise AssertionError(f"evals: bucketed vs unpadded scores {gaps['f32']}")
    shapes = sorted(evals_zero_shot._LL_SHAPES - shapes0)
    return {"acc": acc, "run_s": run_s, "requests": len(reqs), "bucket_shapes": shapes,
            "bucketed_vs_unpadded": gaps, "tol": BUCKET_TOL}


def _evals_longbench(params, cfg, tok) -> tuple:
    """run_longbench (qasper, trec; two ~1500-token samples each) through an
    Engine over the flagship 3-bit cache at s_max 4096, every palu_decode
    launch held at DECODE_TOL against palu_decode_ref, the prefill_flash,
    cache append and palu_decode launches exact per step; then
    TorchLM.generate_until with a stop string on the same engine."""
    eng = Engine(params, cfg, EngineConfig(s_max=4096, qcfg=FLAGSHIP, dtype=torch.bfloat16))
    _counting_decode(eng)
    layers = cfg.num_hidden_layers
    prompts = [evals_longbench.build_prompt(name, d, tok, 3500).shape[1]
               for name in ("qasper", "trec") for d in _longbench_docs(name)]
    held = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with _engine_decode(_held_engine_decode(held, "evals: LongBench's palu_decode")):
        scores = evals_longbench.run_longbench(eng, tok, datasets=["qasper", "trec"],
                                               data_loader=_longbench_docs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    chunks = sum(-(-n // eng._chunk) for n in prompts)
    want = {k: v for k, v in expected_launches(layers, eng.ecfg, eng.steps).items() if v}
    want["prefill_flash"] = layers * chunks
    _only(launches, want, "evals: run_longbench")
    if len(held) != layers * eng.steps:
        raise AssertionError(f"evals: held {len(held)} palu_decode calls of "
                             f"{layers * eng.steps}")
    if not all(0.0 <= v <= 100.0 for v in scores.values()):
        raise AssertionError(f"evals: LongBench scores {scores}")
    longbench = {"scores": scores, "prompts": prompts, "decode_steps": eng.steps,
                 "launches": {k: v for k, v in launches.items() if v}, "run_s": run_s,
                 "decode_held": len(held), "decode_tol": DECODE_TOL,
                 "decode_max_rel_err": max(h[3] for h in held),
                 "decode_max_abs_err": max(h[2] for h in held)}

    lm = evals_lm_eval.TorchLM(params, cfg, tok, qcfg=FLAGSHIP, max_length=4096)
    lm._engine = eng
    req = types.SimpleNamespace(args=(_longbench_docs("trec")[0]["context"],
                                      {"until": [], "max_gen_toks": 16}))
    full = lm.generate_until([req])[0]
    pieces = re.findall(r"<\d+>|.", full, re.S)
    stop = pieces[len(pieces) // 2] if pieces else "\n"
    req.args[1]["until"] = [stop]
    eng.steps = 0
    reset_counts()
    cut = lm.generate_until([req])[0]
    launches = read_counts()
    want = {k: v for k, v in expected_launches(layers, eng.ecfg, eng.steps).items() if v}
    n_ctx = len(tok(req.args[0])["input_ids"])
    want["prefill_flash"] = layers * -(-n_ctx // eng._chunk)
    _only(launches, want, "evals: generate_until")
    if cut != (full[:full.find(stop)] if stop in full else full) or stop in cut:
        raise AssertionError(f"evals: generate_until gave {cut!r} of {full!r} at {stop!r}")
    gen = {"text": full, "stop": stop, "cut": cut, "decode_steps": eng.steps,
           "launches": {k: v for k, v in launches.items() if v}}
    del eng, lm
    return longbench, gen


def phase_evals(ckpt: str) -> None:
    """The accuracy track on the card at Llama-2-7B widths, on compress_cli's
    2-layer checkpoint (rank 256 in every group, Hadamard already fused):
    load_for_eval with --lt_hadamard (exact FWHT launches; logits against
    the unfused load), perplexity on seeded synthetic tokens (window NLLs
    held against the port's f32 CPU run; ms per 2048-token window),
    zero-shot on in-code fixtures of the six tasks (bucketed scores held
    against unpadded ones), LongBench on qasper / trec fixtures over the
    3-bit cache (every palu_decode launch held against palu_decode_ref,
    launches per step exact) and TorchLM.generate_until with a stop string
    on the same engine. Counts are set to 0 just before each step and read
    just after."""
    t0 = time.perf_counter()
    tok = ByteTokenizer()
    params, cfg, load = _evals_load(ckpt)
    torch.cuda.empty_cache()
    ppl = _evals_ppl(params, cfg)
    zero_shot = _evals_zero_shot(params, cfg, tok)
    torch.cuda.empty_cache()
    longbench, gen = _evals_longbench(params, cfg, tok)
    emit({"phase": "evals", "model": _model_name(cfg), "load": load, "ppl": ppl,
          "zero_shot": zero_shot, "longbench": longbench, "generate_until": gen,
          "phase_s": time.perf_counter() - t0})
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8. the probes (palu_tpu_torch/tools)
# ---------------------------------------------------------------------------

# (entry point, argv: the JAX tools' default sizes with every variant, the
# kernel entry, the TPU kernel it replaces, the headline variant of the
# kernels line); gemv_probe's two kernels share its run, and so do ab_v2's
# three (EXTRA_LINES); ab_v2_kvl runs three of them again at kv_len < S
# (held and counted, no kernels line)
PROBES = (
    ("dissect", dissect, [], "palu_decode_fp_dissect",
     "palu_tpu_torch/csrc/palu_decode_fp_wg.cu", "tools/tpu_dissect.py:127", "full"),
    ("stream_probe", stream_probe, [], "stream_probe", "palu_tpu_torch/csrc/stream_probe.cu",
     "tools/tpu_stream_probe.py:60", "bs1024"),
    ("unpack_probe", unpack_probe, [], "unpack_probe", "palu_tpu_torch/csrc/unpack_probe.cu",
     "tools/tpu_unpack_probe.py:57", "ext4cc"),
    ("gemv_probe", gemv_probe, gemv_probe.ALL_PROBES, "gemv_bf16",
     "palu_tpu_torch/csrc/gemv_bf16.cu", "tools/tpu_gemv_probe.py:54", "pallas"),
    ("ab_v2", ab_v2, ab_v2.ALL_VARIANTS, "palu_decode2",
     "palu_tpu_torch/csrc/palu_decode_fp_wg.cu", "palu_tpu/ops/pallas/archive/palu_decode2.py:287",
     "v2"),
    ("ab_v2_kvl", ab_v2, ["--kvl", "40000", "v2", "v2q3", "v3q3"], None, None, None, None),
    ("mlp_a8_probe", mlp_a8_probe, [], "mlp_a8", "palu_tpu_torch/csrc/mlp_a8.cu",
     "tools/tpu_mlp_a8_probe.py:86", "a8"),
)
# more kernels of one probe run: (name, source, replaces, headline variant)
EXTRA_LINES = {
    "gemv_probe": [("gemv_bf16_t", "palu_tpu_torch/csrc/gemv_bf16.cu",
                    "tools/tpu_gemv_probe.py:73", "pallasT")],
    "ab_v2": [("palu_decode2_quantized", "palu_tpu_torch/csrc/palu_decode_exact.cu",
               "palu_tpu/ops/pallas/archive/palu_decode2.py:337", "v2q3"),
              ("palu_decode3_quantized", "palu_tpu_torch/csrc/palu_decode_exact.cu",
               "palu_tpu/ops/pallas/archive/palu_decode3.py:242", "v3q3")],
}
# the decode kernels that ab_v2 runs beside the new ones (its v1 / v1q / v4*
# variants), counted in its records by wrapper name
AB_V2_COUNTERS = ("palu_decode2", "palu_decode2_quantized", "palu_decode3_quantized",
                  "palu_decode_fp", "palu_decode_fp_t", "palu_decode_seq_quantized",
                  "palu_decode")
# the unpack probe's products (bf16 operands, f32 accumulation) against the
# plain version's f64 sums: the bf16 class
UNPACK_MM_TOL = 2e-3


def _probe_held(tag: str, rec: dict) -> None:
    """Raise unless a probe record was held at this script's tolerances:
    checksums and integer totals exact, the dissect's outputs and
    statistics within DECODE_TOL and `full` (palu_decode_fp's kernel)
    bit-identical to palu_decode_fp and within DECODE_TOL of
    palu_decode_fp_ref, the products within the bf16 class, the GEMVs
    within GEMV_TOL."""
    h, v = rec.get("held"), rec["variant"]
    if h is None:
        return
    if tag.startswith("ab_v2"):
        ok = h["max_rel_err"] <= DECODE_TOL
    elif tag == "mlp_a8_probe":
        ok = h["max_rel_err"] <= GEMV_TOL and h["xq"]["tol"] == "exact" and \
            h["xq"]["ok"] and h["hq"]["max_code_diff"] <= 1
    elif tag == "dissect" and v == "novalue":
        ok = all(h[k]["max_rel_err"] <= DECODE_TOL for k in ("m", "l"))
    elif tag == "dissect" and v in ("full", "nologits"):
        ok = h["max_rel_err"] <= DECODE_TOL
        if v == "full":
            ok = ok and rec["vs_palu_decode_fp_ref"]["max_rel_err"] <= DECODE_TOL and \
                rec["vs_palu_decode_fp"]["tol"] == "exact" and rec["vs_palu_decode_fp"]["ok"]
    elif tag == "unpack_probe" and v in ("ext4mm", "ext4ccmm"):
        ok = h["max_rel_err"] <= UNPACK_MM_TOL
    elif tag == "gemv_probe":
        ok = h["max_rel_err"] <= GEMV_TOL
    else:  # checksums, counts and integer totals
        parts = [x for x in (h, *h.values()) if isinstance(x, dict) and "tol" in x]
        ok = bool(parts) and all(x["tol"] == "exact" for x in parts)
    if not (ok and h["ok"]):
        raise AssertionError(f"probes {tag} {v}: not held: {rec}")


def _kernel_recs(name: str, recs: list) -> list:
    """The records of a probe run that launched kernel `name`."""
    if name in ("gemv_bf16", "gemv_bf16_t"):
        return [r for r in recs if r["variant"] == ("pallas" if name == "gemv_bf16"
                                                    else "pallasT")]
    if any("kernel" in r for r in recs):  # ab_v2 / mlp_a8_probe name each record's kernel
        return [r for r in recs if r.get("kernel") == name]
    return [r for r in recs if "launches" in r]


def _probe_line(name: str, source: str, replaces: str, head: str, recs: list,
                counts: dict) -> dict:
    """The kernels line of one probe kernel: its headline variant's error,
    device time, plain time, bound and yardstick, every variant's time, and
    its launches in the probe run."""
    mine = _kernel_recs(name, recs)
    main = next(r for r in mine if r["variant"] == head)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": main["held"]["max_abs_err"],
            "ms": main["us"] / 1e3,
            "plain_ms": main["plain_us"] / 1e3, "bound_ms": main["bound_us"] / 1e3,
            "bound_by": main["bound_by"],
            "library_ms": None if main.get("library_us") is None else main["library_us"] / 1e3,
            "library": main.get("library"), "variant": head,
            "variants_ms": {r["variant"]: r["us"] / 1e3 for r in mine}}


def _gemv_bf16_rows8() -> dict:
    """gemv_bf16 (W (K, N)) at the probe's 4096 x 4096 and 8 rows of x
    (the tool times 1 row): held against its plain version, its device
    time beside torch.matmul's and the bound (launches here are not the
    probe run's)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    k = n = gemv_probe.K
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    x8 = (torch.randn((8, k), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    got, want = gemv_probe.gemv_bf16(x8, w).float(), gemv_probe.gemv_bf16_ref(x8, w).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not (torch.isfinite(got).all() and rel <= GEMV_TOL):
        raise AssertionError(f"gemv_bf16 8 rows: rel err {rel} > {GEMV_TOL}")
    bms, _ = bound_ms(_nbytes(w, x8) + 8 * n * 2, 2 * 8 * k * n)
    ms = device_ms(lambda: gemv_probe.gemv_bf16(x8, w), 20)
    check_bound("gemv_bf16 8 rows", ms, bms)
    return {"ms_8rows": ms, "library_ms_8rows": device_ms(lambda: torch.matmul(x8, w), 20),
            "bound_ms_8rows": bms, "max_rel_err_8rows": rel,
            "kernels_per_call_8rows": kernels_per_call(lambda: gemv_probe.gemv_bf16(x8, w))}


def phase_probes() -> list:
    """The six tool entry points (python -m palu_tpu_torch.tools.<name>)
    on the card at the JAX tools' default sizes with every variant: counts
    set to 0 just before each and read just after; every kernel variant
    held against its plain version (_probe_held) and its launches asserted
    against the run's own count. Returns the kernels lines of the nine
    tool kernels."""
    lines = []
    for tag, mod, argv, name, source, replaces, head in PROBES:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the tool's own lines
            recs = mod.main([*argv, "--json"])
        torch.cuda.synchronize()
        counts = read_counts()
        for rec in recs:
            _probe_held(tag, rec)
        extra = EXTRA_LINES.get(tag, [])
        if tag.startswith("ab_v2"):
            names = AB_V2_COUNTERS
            want = {n: sum(r["launches"] for r in _kernel_recs(n, recs)) for n in names}
            want["palu_decode_chunked"] = sum(r["launches"] for r in recs
                                              if r["variant"].startswith("v4g"))
            news = ("palu_decode2", "palu_decode2_quantized", "palu_decode3_quantized")
        else:
            news = names = (name, *(e[0] for e in extra))
            want = {n: sum(r["launches"] for r in _kernel_recs(n, recs)) for n in names}
        if tag == "dissect":  # the production call it is held and timed against
            want["palu_decode_fp"] = counts["palu_decode_fp"]
        if tag == "gemv_probe":  # kgemv / kmlp: the ported int8 kernels
            want.update({k: counts[k] for k in ("gemv_int8", "mlp_gemv_int8")})
        if tag == "mlp_a8_probe":  # w8a16 and the yardstick: the production kernel
            want["mlp_gemv_int8"] = counts["mlp_gemv_int8"]
        _only(counts, want, f"probes {tag}")
        for n in news:
            if counts[n] <= 0:
                raise AssertionError(f"probes {tag}: {n} never launched")
        emit({"phase": "probes", "tool": f"palu_tpu_torch.tools.{mod.__name__.split('.')[-1]}",
              "argv": argv, "records": recs, "launches": {k: v for k, v in counts.items() if v},
              "seconds": time.perf_counter() - t0})
        if name is None:
            continue
        lines.append(_probe_line(name, source, replaces, head, recs, counts))
        if name == "gemv_bf16":
            lines[-1].update(_gemv_bf16_rows8())
        for e_name, e_source, e_replaces, e_head in extra:
            lines.append(_probe_line(e_name, e_source, e_replaces, e_head, recs, counts))
    return lines


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


def decode_breakdown(eng, tag: str, steps: int = 4, cache=None) -> None:
    """Where one decode step's time goes at the last request's context (or
    on `cache`, every lane decoding): wall time per step, device busy time
    (kernels, torch.profiler), the device's idle share, and the kernels that
    take the most device time."""
    cache = eng.last_cache if cache is None else cache
    tok = np.zeros((eng.batch, 1), np.int64)
    eng.decode(tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode(tok, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    emit({"phase": "decode_breakdown", "of": tag, "lanes": eng.batch,
          "context": int(cache["length"].max()), "per": "step",
          **_breakdown(prof, wall_ms, steps)})


# ---------------------------------------------------------------------------
# 9. the v4 decode's features: sequence shards, raw statistics, stacked layers
# ---------------------------------------------------------------------------

S64, N_SHARDS = 65536, 4  # BASELINE.md's point, cut into four sequence shards


def _shard(bufs: dict, r: int, s_local: int) -> dict:
    """Columns [r * s_local, (r + 1) * s_local) of every leaf (last axis)."""
    return {k: v[..., r * s_local:(r + 1) * s_local].contiguous() for k, v in bufs.items()}


def _combine(parts) -> torch.Tensor:
    """The flash-decoding combine of shards' (acc, m, l), in f32."""
    m_g = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m_g) for p in parts]
    l_g = sum(wi * p[2] for wi, p in zip(w, parts))
    return sum(wi[..., None] * p[0] for wi, p in zip(w, parts)) / l_g[..., None]


def _held_stats(what: str, got, want) -> float:
    """A kernel's (acc, m, l) against its plain version's: acc and l within
    DECODE_TOL of their max|plain|, m within DECODE_TOL of max|m| on the
    rows with a valid column and exactly -1e30 (l = 0, acc = 0) on the
    others; returns acc's max abs error."""
    torch.cuda.synchronize()
    (acc, m, l), (wacc, wm, wl) = got, want
    empty = wl == 0
    if not torch.equal(l == 0, empty):
        raise AssertionError(f"{what}: rows without a valid column differ")
    if not (torch.isfinite(acc).all() and torch.isfinite(l).all()):
        raise AssertionError(f"{what}: non-finite statistics")
    if not (bool((m[empty] == -1e30).all()) and bool((acc[empty] == 0).all())):
        raise AssertionError(f"{what}: an empty row is not (m -1e30, l 0, acc 0)")
    err = (acc - wacc).abs().max().item()
    for name, x, y in (("acc", acc, wacc), ("l", l, wl), ("m", m[~empty], wm[~empty])):
        if x.numel() and (x - y).abs().max().item() > DECODE_TOL * y.abs().max().item():
            raise AssertionError(f"{what}: {name} off by {(x - y).abs().max().item()}")
    return err


def _stacked(make, n_layers: int) -> dict:
    """An (L, ...) stack of n_layers caches from make() (a dict of leaves)."""
    layers = [make() for _ in range(n_layers)]
    return {k: torch.stack([c[k] for c in layers]).contiguous() for k in layers[0]}


def check_decode_stats(gen) -> list:
    """The three features at BASELINE.md's point (64K, G 8 x 4 heads, rk
    128, rv 384): the cache cut into four 16384-column shards, each through
    palu_decode (exact, int8_dots, int8_rot over 512-token rotation blocks;
    per-chunk scales and the K bias at Qwen2-7B's shape) and
    palu_decode_fp_t with pos_offset and return_stats, held against its
    plain version; the shards combined against the one-call kernel; an
    L = 4 stack through layer_idx, each layer bit-identical to the
    per-layer call. Times of the one-call kernel, each shard, the
    statistics variant and the layer_idx call, with their bounds and SDPA
    over the same columns. Returns the four kernel lines."""
    t_phase = time.perf_counter()
    s_loc = S64 // N_SHARDS
    lanes2 = torch.tensor([S64, 20000], dtype=torch.int32, device="cuda")  # lane 2: 2 shards empty
    kv1 = torch.tensor([S64], dtype=torch.int32, device="cuda")
    worst, cases, report = {}, 0, {}

    def held_shards(name, call, ref, bufs, kv_len):
        """Each shard against its plain version, then the combine against
        the one-call kernel; returns the shards' (acc, m, l)."""
        nonlocal cases
        parts = []
        for r in range(N_SHARDS):
            sh = _shard(bufs, r, s_loc)
            got = call(sh, kv_len, r * s_loc)
            err = _held_stats(f"{name} shard {r}", got, ref(sh, kv_len, r * s_loc))
            worst[name] = max(worst.get(name, 0.0), err)
            parts.append(got)
            cases += 1
        _held_decode(f"{name} shards combined", _combine(parts), call(bufs, kv_len, None))
        cases += 1

    # ---- palu_decode: exact / int8 modes at the Llama shape, per-chunk and
    # the K bias at Qwen2-7B's
    specs = [("exact", FLAGSHIP, LLAMA_SHAPE, {}, False),
             ("int8_dots", FLAGSHIP, LLAMA_SHAPE, {"int8_dots": True}, False),
             ("int8_rot", FLAGSHIP, LLAMA_SHAPE, {"int8_rot": True}, False),
             ("chunked", CHUNKED, QWEN2_SHAPE, {}, False),
             ("k_bias", FLAGSHIP, QWEN2_SHAPE, {}, True)]
    for label, qcfg, (g, hpg, rk, rv), knob, bias in specs:
        q, b_k, bufs = _decode_inputs(qcfg, 2, g, hpg, S64, gen, rv, rk)
        kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=512,
                  k_bias=_k_bias(g, hpg, gen).float() if bias else None, **knob)

        def call(bf, kv_len, off, kw=kw, q=q, b_k=b_k):
            return palu_decode(q, b_k, kv_len=kv_len, **bf, **kw, pos_offset=off,
                               return_stats=off is not None)

        def ref(bf, kv_len, off, kw=kw, q=q, b_k=b_k):
            return palu_decode_ref(q, b_k, kv_len=kv_len, **bf, **kw, pos_offset=off,
                                   return_stats=True)
        held_shards(f"palu_decode {label}", call, ref, bufs, lanes2)
        del q, b_k, bufs

    # ---- palu_decode_fp_t at the Llama shape
    g, hpg, rk, rv = LLAMA_SHAPE
    q, b_k, _, lat = _fp_inputs(2, g, hpg, S64, gen)
    fbufs = {"xk_t": lat[0], "xv_t": lat[1]}
    del lat

    def fcall(bf, kv_len, off):
        return palu_decode_fp_t(q, b_k, bf["xk_t"], bf["xv_t"], kv_len, pos_offset=off,
                                return_stats=off is not None)

    def fref(bf, kv_len, off):
        return palu_decode_fp_t_ref(q, b_k, bf["xk_t"], bf["xv_t"], kv_len, pos_offset=off,
                                    return_stats=True)
    held_shards("palu_decode_fp_t", fcall, fref, fbufs, lanes2)
    del q, b_k, fbufs

    # ---- layer_idx on L = 4 stacks: each layer the per-layer call's bits
    nh = G * HPG
    q, b_k, _ = _decode_inputs(FLAGSHIP, 1, G, HPG, 16, gen)
    stack = _stacked(lambda: _decode_inputs(FLAGSHIP, 1, G, HPG, S64, gen)[2], 4)
    kw = dict(qcfg=FLAGSHIP, rk=RK, rv=RV)
    for li in range(4):
        got = palu_decode(q, b_k, kv_len=kv1, **stack, **kw, layer_idx=li)
        one = palu_decode(q, b_k, kv_len=kv1, **{k: v[li].contiguous() for k, v in stack.items()},
                          **kw)
        if not torch.equal(got, one):
            raise AssertionError(f"palu_decode layer_idx {li}: differs from the per-layer call")
        cases += 1
    layer_err, _ = _held_decode("palu_decode layer_idx 3", got,
                                palu_decode_ref(q, b_k, kv_len=kv1, **stack, **kw, layer_idx=3))
    q_fp, bk_fp, _, _ = _fp_inputs(1, G, HPG, 16, gen)
    fstack = _stacked(lambda: dict(zip(("xk_t", "xv_t"), _fp_inputs(1, G, HPG, S64, gen)[3])), 4)
    for li in range(4):
        got = palu_decode_fp_t(q_fp, bk_fp, fstack["xk_t"], fstack["xv_t"], kv1, layer_idx=li)
        one = palu_decode_fp_t(q_fp, bk_fp, fstack["xk_t"][li].contiguous(),
                               fstack["xv_t"][li].contiguous(), kv1)
        if not torch.equal(got, one):
            raise AssertionError(f"palu_decode_fp_t layer_idx {li}: differs from the per-layer "
                                 "call")
        cases += 1
    fp_layer_err, _ = _held_decode(
        "palu_decode_fp_t layer_idx 3", got,
        palu_decode_fp_t_ref(q_fp, bk_fp, fstack["xk_t"], fstack["xv_t"], kv1, layer_idx=3))

    # ---- times at batch 1, every column valid: the one-call kernel, each
    # shard with pos_offset and return_stats, the statistics variant over
    # all 64K, and the layer_idx call on the stack
    one = {k: v[0] for k, v in stack.items()}  # layer 0 (contiguous: the stack's first plane)
    fone = {k: v[0] for k, v in fstack.items()}
    sdpa64 = device_ms(_dense_kv_sdpa(1, S64, gen), 20)
    sdpa16 = device_ms(_dense_kv_sdpa(1, s_loc, gen), 20)
    lines = []
    for name, call, ref, bufs, st in (
            ("palu_decode", lambda bf, off, stats, li=None: palu_decode(
                q, b_k, kv_len=kv1, **bf, **kw, pos_offset=off, return_stats=stats,
                layer_idx=li),
             lambda bf, off, stats, li=None: palu_decode_ref(
                q, b_k, kv_len=kv1, **bf, **kw, pos_offset=off, return_stats=stats,
                layer_idx=li), one, stack),
            ("palu_decode_fp_t", lambda bf, off, stats, li=None: palu_decode_fp_t(
                q_fp, bk_fp, bf["xk_t"], bf["xv_t"], kv1, pos_offset=off, return_stats=stats,
                layer_idx=li),
             lambda bf, off, stats, li=None: palu_decode_fp_t_ref(
                q_fp, bk_fp, bf["xk_t"], bf["xv_t"], kv1, pos_offset=off, return_stats=stats,
                layer_idx=li), fone, fstack)):
        n64 = _nbytes(*bufs.values())

        def bound(nbytes, n, stats=False):
            bms, by, _, _ = _decode_bound(nbytes, 1, nh, n, RK, RV)
            return bms + (2 * nh * 4 / PEAK_BYTES_PER_S * 1e3 if stats else 0.0), by
        t = {"one_call": {"ms": device_ms(lambda: call(bufs, None, False), 20),
                          "bound": bound(n64, S64), "sdpa_ms": sdpa64},
             "stats_64k": {"ms": device_ms(lambda: call(bufs, None, True), 20),
                           "bound": bound(n64, S64, True)},
             "layer_idx": {"ms": device_ms(lambda: call(st, None, False, 2), 20),
                           "plain_ms": device_ms(lambda: ref(st, None, False, 2), 3),
                           "bound": bound(n64, S64), "sdpa_ms": sdpa64}}
        for r in range(N_SHARDS):
            sh = _shard(bufs, r, s_loc)
            t[f"shard{r}"] = {"ms": device_ms(lambda: call(sh, r * s_loc, True), 20),
                              "bound": bound(_nbytes(*sh.values()), s_loc, True),
                              "sdpa_ms": sdpa16}
            if r == 0:
                t["shard0"]["plain_ms"] = device_ms(lambda: ref(sh, 0, True), 3)
            del sh
        report[name] = t
        stats_err = worst["palu_decode exact" if name == "palu_decode" else name]
        s0, li = t["shard0"], t["layer_idx"]
        lines.append({"name": f"{name}_stats", "route": "cuda",
                      "source": "palu_tpu_torch/csrc/" + ("palu_decode_exact.cu" if name ==
                                                          "palu_decode" else
                                                          "palu_decode_fp_wg.cu"),
                      "replaces": "palu_tpu/ops/pallas/palu_decode4.py:"
                                  + ("922" if name == "palu_decode" else "1015"),
                      "max_abs_err": stats_err, "ms": s0["ms"], "plain_ms": s0["plain_ms"],
                      "bound_ms": s0["bound"][0], "bound_by": s0["bound"][1],
                      "library_ms": sdpa16})
        lines.append({"name": f"{name}_layer_idx", "route": "cuda",
                      "source": lines[-1]["source"],
                      "replaces": "palu_tpu/ops/pallas/palu_decode4.py:"
                                  + ("923" if name == "palu_decode" else "1016"),
                      "max_abs_err": layer_err if name == "palu_decode" else fp_layer_err,
                      "ms": li["ms"], "plain_ms": li["plain_ms"], "bound_ms": li["bound"][0],
                      "bound_by": li["bound"][1], "library_ms": sdpa64})
    emit({"phase": "kernel", "what": "decode_stats: pos_offset, return_stats and layer_idx "
          f"at S {S64} cut into {N_SHARDS} shards of {s_loc}; layer_idx on L = 4 stacks",
          "cases": cases, "tol": DECODE_TOL, "max_abs_err": worst, "times": report,
          "library_call": SDPA_YARDSTICK, "lines": lines,
          "phase_s": time.perf_counter() - t_phase})
    return lines


def _forced_run(eng, prompt, steps: int, forced=None):
    """prefill_auto then `steps` decodes, each fed the token `forced` gives
    (or this engine's argmax): the per-step last-token logits (steps + 1,
    V) f32, the tokens fed, and the cache."""
    logits, cache = eng.prefill_auto(prompt)
    out, fed = [logits[0, -1].float()], []
    for t in range(steps):
        tok = forced[t] if forced is not None else int(out[-1].argmax())
        fed.append(tok)
        logits, cache = eng.decode(np.full((1, 1), tok, np.int64), cache)
        out.append(logits[0, -1].float())
    return torch.stack(out), fed, cache


def _same_cache(a: dict, b: dict) -> dict:
    """Bytes of an unrolled cache (a) that differ from a stacked one (b)."""
    diff, total = 0, 0
    for i, entry in enumerate(a["layers"]):
        for side, bufs in entry.items():
            for k, v in bufs.items():
                w = b["stack"][side][k][i]
                diff += int((v.reshape(w.shape).view(torch.uint8) != w.view(torch.uint8)).sum())
                total += v.numel() * v.element_size()
    return {"bytes": total, "bytes_differing": diff}


# the depth of serve_stacked and serve_seq: each repeats serve's request,
# which serve runs at all 32 layers, on another decode path
REPEAT_LAYERS = 8


def phase_serve_stacked(params) -> tuple:
    """Engine.generate with stacked_decode=True at Llama-2-7B width: serve's
    first REPEAT_LAYERS layers over the 3-bit cache answering the
    7000-token request of `serve` (32 new tokens) with exact launches per
    step, every palu_decode with layer_idx; then the same request teacher-forced
    through the unrolled engine on the same params: logits, tokens and
    cache bytes compared, and both engines' decode breakdowns. Then a
    2-layer rank_major_fp case (palu_decode_fp_t with layer_idx). Returns
    both runs' launches."""
    t_phase = time.perf_counter()
    cfg = llama7b(REPEAT_LAYERS)
    params = dict(params, layers=params["layers"][:REPEAT_LAYERS])
    prompt = _prompts(1, (7000,))
    stacked, init_s = _engine(cfg, {}, params=params, stacked_decode=True)
    launches = serve("serve_stacked", stacked, prompt, 32, {"init_s": init_s})
    unrolled, _ = _engine(cfg, {}, params=params)
    held = {}
    got, fed, scache = _forced_run(stacked, prompt[0], 8)
    want, _, ucache = _forced_run(unrolled, prompt[0], 8, fed)
    held["3bit"] = {"logits_identical": bool(torch.equal(got, want)),
                    "max_abs_diff": (got - want).abs().max().item(),
                    "max_abs_logit": want.abs().max().item(), **_same_cache(ucache, scache)}
    decode_breakdown(stacked, "serve_stacked")
    decode_breakdown(unrolled, "serve_stacked_unrolled")
    del stacked, unrolled, scache, ucache
    cfg2 = llama7b(2)
    p2 = dict(params, layers=params["layers"][:2])
    fp, _ = _engine(cfg2, {}, params=p2, qcfg=None, rank_major_fp=True, stacked_decode=True)
    launches_fp = serve("serve_stacked_fp", fp, prompt, 32)
    fp_un, _ = _engine(cfg2, {}, params=p2, qcfg=None, rank_major_fp=True)
    got, fed, scache = _forced_run(fp, prompt[0], 8)
    want, _, ucache = _forced_run(fp_un, prompt[0], 8, fed)
    held["fp_rank_major"] = {"logits_identical": bool(torch.equal(got, want)),
                             "max_abs_diff": (got - want).abs().max().item(),
                             "max_abs_logit": want.abs().max().item(),
                             **_same_cache(ucache, scache)}
    emit({"phase": "serve_stacked_vs_unrolled", "steps": 8, "held": held,
          "tol": "identical, else 1e-2 of max|logits|",
          "phase_s": time.perf_counter() - t_phase})
    for k, h in held.items():
        if h["max_abs_diff"] > 1e-2 * h["max_abs_logit"] or h["bytes_differing"]:
            raise AssertionError(f"serve_stacked {k}: {h}")
    return launches, launches_fp


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_serve_seq(params) -> tuple:
    """The engine on a ("data", "seq") mesh of 1 x 1 under NCCL at world
    size 1: serve's first REPEAT_LAYERS layers at Llama-2-7B width over
    the 3-bit cache, the 7000-token request with s_max 8192 and 32 new
    tokens through Engine.generate, every decode layer launching the
    statistics variant
    (pos_offset and return_stats); teacher-forced, its logits within 1e-2
    of max|logits| of the unsharded engine's. Then a 2-layer rank_major_fp
    case (palu_decode_fp_t's statistics). Returns both runs' launches."""
    import torch.distributed as dist

    from palu_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, seq=1, device_type="cuda")
        cfg = llama7b(REPEAT_LAYERS)
        params = dict(params, layers=params["layers"][:REPEAT_LAYERS])
        prompt = _prompts(1, (7000,))
        seq, init_s = _engine(cfg, {}, params=params, mesh=mesh, seq_axis="seq")
        launches = serve("serve_seq", seq, prompt, 32, {"init_s": init_s, "mesh": "1x1",
                                                        "backend": dist.get_backend()})
        got, fed, _ = _forced_run(seq, prompt[0], 8)
        decode_breakdown(seq, "serve_seq")
        del seq
        unsharded, _ = _engine(cfg, {}, params=params)
        want, _, _ = _forced_run(unsharded, prompt[0], 8, fed)
        del unsharded
        held = {"3bit": ((got - want).abs().max() / want.abs().max()).item()}
        cfg2 = llama7b(2)
        p2 = dict(params, layers=params["layers"][:2])
        fp, _ = _engine(cfg2, {}, params=p2, qcfg=None, rank_major_fp=True, mesh=mesh,
                        seq_axis="seq")
        launches_fp = serve("serve_seq_fp", fp, prompt, 32)
        got, fed, _ = _forced_run(fp, prompt[0], 8)
        fp_un, _ = _engine(cfg2, {}, params=p2, qcfg=None, rank_major_fp=True)
        want, _, _ = _forced_run(fp_un, prompt[0], 8, fed)
        held["fp_rank_major"] = ((got - want).abs().max() / want.abs().max()).item()
        emit({"phase": "serve_seq_vs_unsharded", "steps": 8, "max_rel_err": held, "tol": 1e-2,
              "phase_s": time.perf_counter() - t_phase})
        if max(held.values()) > 1e-2:
            raise AssertionError(f"serve_seq: logits off the unsharded engine's by {held}")
    finally:
        dist.destroy_process_group()
    return launches, launches_fp


SEQ_RANK_LAYERS = 4
# seq_ranks' per-step logit limit, in bf16 ulps of max|logits| (the logits
# are bf16; one ulp of the top binade is 2^-8 to 2^-7 of max|logits|). Two
# shards merged in f32 reorder the attention's sums against the one call,
# which moves a logit by a few roundings (1-2 ulps read, PERF.md); a shard
# that misses or doubles columns moves whole logits
SEQ_RANK_ULPS = 4
# the written columns' scales against the world-1 engine's: the latents of
# layers past the first come from hidden states a few bf16 roundings apart
# (about 1e-3 relative); a column not written, or written elsewhere, is
# off by its whole scale
SEQ_RANK_SCALE_TOL = 2e-2


def _cpu_cache(cache: dict) -> dict:
    return {"layers": [{side: {k: v.cpu() for k, v in b.items()} for side, b in e.items()}
                       for e in cache["layers"]], "length": cache["length"].cpu()}


def _seq_rank_worker(rank: int, port: int, prompt, steps: int, out_dir: str) -> None:
    """One of seq_ranks' two processes: gloo over the one card, a (1, 2)
    ("data", "seq") mesh, the 4-layer engine at full width (weights from
    the phase's seed), teacher-forced steps, then a profiled window of 4
    more steps (busy, wall and idle share per step). Its logits, launches,
    breakdown and the cache shard before each step and after the last go
    to out_dir."""
    import torch.distributed as dist

    from palu_tpu_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost(f"localhost:{port}", 2, rank, device="cuda", backend="gloo")
    mesh = make_mesh(1, seq=2, device_type="cuda")
    cfg = llama7b(SEQ_RANK_LAYERS)
    eng, _ = _engine(cfg, {}, mesh=mesh, seq_axis="seq")
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill_auto(prompt)
    out, fed, shards = [logits[0, -1].float()], [], []
    for _ in range(steps):
        shards.append(_cpu_cache(cache))
        fed.append(int(out[-1].argmax()))
        logits, cache = eng.decode(np.full((1, 1), fed[-1], np.int64), cache)
        out.append(logits[0, -1].float())
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, read_counts()
    shards.append(_cpu_cache(cache))
    tok, n = np.full((1, 1), fed[-1], np.int64), 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(n):
            eng.decode(tok, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) / n * 1e3
    torch.save({"logits": torch.stack(out).cpu(), "fed": fed, "launches": launches,
                "paths": sorted(eng._decode_paths), "s_local": eng._seq["s_local"],
                "seconds": seconds, "backend": dist.get_backend(), "shards": shards,
                "breakdown": _breakdown(prof, wall_ms, n)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _held_seq_cache(joined: dict, want: dict, n_prompt: int) -> dict:
    """The two ranks' cache, joined, against the world-1 engine's own at the
    same step. Every byte of the prompt's columns and of the columns not
    yet written must be identical, and of layer 0's written columns (its
    latents come from the token's embedding alone); past layer 0 the
    written columns' elements (code bytes, scales) are counted where they
    differ, of all written, and their scales held within
    SEQ_RANK_SCALE_TOL of max|scale|."""
    n = int(want["length"][0])
    if not torch.equal(joined["length"], want["length"]):
        raise AssertionError(f"seq_ranks: lengths {joined['length']} vs {want['length']}")
    differing, written, worst = {}, {}, 0.0
    for i, (jl, wl) in enumerate(zip(joined["layers"], want["layers"])):
        for side in ("k", "v"):
            for key, w in wl[side].items():
                g = jl[side][key]
                bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[w.element_size()]
                same = g.view(bits) == w.view(bits)
                if not (bool(same[..., :n_prompt].all()) and bool(same[..., n:].all())):
                    raise AssertionError(f"seq_ranks: layer {i} {side}/{key} differs outside "
                                         f"the decoded columns")
                new = ~same[..., n_prompt:n]
                if i == 0 and bool(new.any()):
                    raise AssertionError(f"seq_ranks: layer 0 {side}/{key} differs")
                differing[key] = differing.get(key, 0) + int(new.sum())
                written[key] = written.get(key, 0) + new.numel()
                if key != "codes_t" and n > n_prompt:
                    gw, ww = g[..., n_prompt:n], w[..., n_prompt:n]
                    worst = max(worst, ((gw - ww).abs().max() / ww.abs().max()).item())
    if worst > SEQ_RANK_SCALE_TOL:
        raise AssertionError(f"seq_ranks: written scales off by {worst} of max|scale|")
    return {"length": n, "differing": differing, "written": written,
            "scale_max_rel_err": worst}


def phase_seq_ranks() -> dict:
    """Two processes on the one card, seq = 2 under gloo (NCCL refuses two
    ranks on one device; the combine uses only all_reduce, which gloo
    takes on CUDA tensors): 4 layers at Llama-2-7B width over the 3-bit
    cache, the 7000-token prompt and 8 greedy steps, the kernels on the
    card in both. Held against the world-1 engine on the same weights,
    teacher-forced with the ranks' tokens: its cache before each step and
    after the last against the ranks' shards joined (_held_seq_cache),
    and each step's logits, both against that engine's own run and
    against its decode of the same token from the ranks' joined cache,
    within SEQ_RANK_ULPS bf16 ulps of max|logits|. Returns rank 0's
    launches."""
    import torch.multiprocessing as mp

    prompt = _prompts(1, (7000,))[0]
    n_prompt = int(prompt.shape[1])
    steps = 8
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_seq_rank_worker, args=(r, port, prompt, steps, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"seq_ranks: worker exit codes {codes}")
        runs = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]
    wall_s = time.perf_counter() - t0
    eng, _ = _engine(llama7b(SEQ_RANK_LAYERS), {})
    logits, cache = eng.prefill_auto(prompt)
    free, caches = [logits[0, -1].float()], []
    for tok in runs[0]["fed"]:
        caches.append(_cpu_cache(cache))
        logits, cache = eng.decode(np.full((1, 1), tok, np.int64), cache)
        free.append(logits[0, -1].float())
    caches.append(_cpu_cache(cache))
    free = torch.stack(free).cpu()
    joined = [{"layers": [{side: {k: torch.cat([r["shards"][t]["layers"][i][side][k]
                                                for r in runs], dim=-1)
                                  for k in b} for side, b in e.items()}
                          for i, e in enumerate(runs[0]["shards"][t]["layers"])],
               "length": runs[0]["shards"][t]["length"]} for t in range(steps + 1)]
    held_cache = [_held_seq_cache(j, w, n_prompt) for j, w in zip(joined, caches)]
    got = runs[0]["logits"]
    on_joined = [free[0]]  # the prefill: no cache read yet
    for t in range(steps):
        c = {"layers": [{side: {k: v.cuda() for k, v in b.items()} for side, b in e.items()}
                        for e in joined[t]["layers"]], "length": joined[t]["length"].cuda()}
        logits, _ = eng.decode(np.full((1, 1), runs[0]["fed"][t], np.int64), c)
        on_joined.append(logits[0, -1].float().cpu())
    del eng
    on_joined = torch.stack(on_joined)
    top = max(got.abs().max().item(), free.abs().max().item())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    step_ulps = [(got[t] - on_joined[t]).abs().max().item() / ulp for t in range(steps + 1)]
    free_ulps = [(got[t] - free[t]).abs().max().item() / ulp for t in range(steps + 1)]
    emit({"phase": "seq_ranks", "processes": 2, "mesh": "1x2", "layers": SEQ_RANK_LAYERS,
          "prompt": n_prompt, "steps": steps, "wall_s": wall_s,
          "per_rank": [{k: r[k] for k in ("paths", "s_local", "seconds", "backend")}
                       for r in runs],
          "launches": [r["launches"] for r in runs],
          "decode_breakdown": [r["breakdown"] for r in runs],
          "max_abs_logit": top, "ulp": ulp, "tol_ulps": SEQ_RANK_ULPS,
          "max_err_ulps_on_joined_cache": step_ulps,
          "max_err_ulps_free_running": free_ulps,
          "max_rel_err_on_joined_cache": [u * ulp / top for u in step_ulps],
          "max_rel_err_free_running": [u * ulp / top for u in free_ulps],
          "cache_vs_world1": held_cache, "scale_tol": SEQ_RANK_SCALE_TOL,
          "phase_s": time.perf_counter() - t0,
          "ranks_agree": bool(torch.equal(runs[0]["logits"], runs[1]["logits"]))})
    if max(step_ulps + free_ulps) > SEQ_RANK_ULPS or step_ulps[0] or any(
            r["paths"] != ["palu_decode[seq]-kernel"] for r in runs):
        raise AssertionError(f"seq_ranks: ulps on the joined cache {step_ulps}, free "
                             f"running {free_ulps}, paths {[r['paths'] for r in runs]}")
    if not torch.equal(runs[0]["logits"], runs[1]["logits"]):
        raise AssertionError("seq_ranks: the two ranks' logits differ")
    for r in runs:
        n = r["launches"]
        if not (n["palu_decode_stats"] == n["palu_decode"] == SEQ_RANK_LAYERS * steps):
            raise AssertionError(f"seq_ranks: launches {n}")
    return runs[0]["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    kernels = [check_append(gen), check_decode(gen), *check_decode_int8(gen),
               check_decode_seq(gen), *check_decode_fp(gen), check_prefill(gen),
               check_gemv(gen, 4), check_mlp(gen, 4), check_gemv(gen, 8), check_mlp(gen, 8),
               check_hadamard(gen), check_decode_bias(gen), check_decode_chunked(gen),
               *check_decode_stats(gen)]
    for k in kernels:
        check_bound(k["name"], k["ms"], k["bound_ms"])
    check_decode_ranks(gen)
    check_decode_rope(gen)
    check_dense_sdpa(gen)
    probe_lines = phase_probes()
    for k in probe_lines:
        check_bound(k["name"], k["ms"], k["bound_ms"])
    phase_e2e()
    phase_e2e("e2e_w4", W4)
    phase_e2e("e2e_w8", W8)
    phase_e2e_fp()
    qwen2_inputs = _qwen2_e2e_inputs()
    phase_e2e("e2e_qwen2", inputs=qwen2_inputs)
    phase_e2e("e2e_qwen2_w4", W4, inputs=qwen2_inputs)
    phase_e2e_chunked(qwen2_inputs)
    del qwen2_inputs
    launches, launches_fp, params = phase_serve()
    launches_stacked, launches_stacked_fp = phase_serve_stacked(params)
    launches_seq, launches_seq_fp = phase_serve_seq(params)
    launches_serving = phase_serving(params)
    del params
    launches_w4 = phase_serve_w4()
    launches_w8 = phase_serve_w8()
    phase_seq_ranks()
    torch.cuda.empty_cache()  # the Llama weights are gone: room for Qwen2-7B's
    launches_qwen2, params = phase_serve_qwen2()
    launches_serving_qwen2 = phase_serving_qwen2(params)
    del params
    torch.cuda.empty_cache()
    launches_lk = phase_latency_kernel()
    launches_attn = phase_latency_attention()
    phase_serve_bench_int8_rot()
    launches_compress = phase_compress()
    phase_compress_check()
    phase_compress_cli()
    # each kernel's launches on the run of its path: the bf16 serve for the
    # quantized cache's and the prefill kernels, serve_fp for the rank-major
    # fp decode, serving for the seq-major fp decode, serve_w4 for the int4
    # GEMVs and the int8 VT GEMV, serve_w8 for the int8 MLP, the 3-bit
    # run_latency_kernel for the seq-major packed decode, the 1-layer
    # run_latency_attention run for int8_dots and the 32-layer one for
    # int8_rot, and the compress
    # phase's decomposition for the Hadamard transform; serve_qwen2 for the
    # decode with the K bias, serving_qwen2 for the per-chunk-scale decode;
    # serve_seq (and its rank-major fp case) for the statistics variants,
    # serve_stacked (and its fp case) for the layer_idx calls
    source = {"cache_append": ("append_kv_quantized", launches),
              "palu_decode": ("palu_decode", launches),
              "palu_decode_int8_dots": ("palu_decode_int8_dots",
                                        launches_attn["palu_3bit_int8_dots"]),
              "palu_decode_int8_rot": ("palu_decode_int8_rot",
                                       launches_attn["palu_3bit_int8_rot_32_layers"]),
              "palu_decode_seq_quantized": ("palu_decode_seq_quantized", launches_lk),
              "palu_decode_fp": ("palu_decode_fp", launches_serving),
              "palu_decode_fp_t": ("palu_decode_fp_t", launches_fp),
              "prefill_flash": ("prefill_flash", launches),
              "gemv_int4": ("gemv_int4", launches_w4),
              "mlp_gemv_int4": ("mlp_gemv_int4", launches_w4),
              "gemv_int8": ("gemv_int8", launches_w4),
              "mlp_gemv_int8": ("mlp_gemv_int8", launches_w8),
              "hadamard_transform": ("hadamard_transform", launches_compress),
              "palu_decode_k_bias": ("palu_decode_k_bias", launches_qwen2),
              "palu_decode_chunked": ("palu_decode_chunked", launches_serving_qwen2),
              "palu_decode_stats": ("palu_decode_stats", launches_seq),
              "palu_decode_layer_idx": ("palu_decode_layer_idx", launches_stacked),
              "palu_decode_fp_t_stats": ("palu_decode_fp_t_stats", launches_seq_fp),
              "palu_decode_fp_t_layer_idx": ("palu_decode_fp_t_layer_idx",
                                             launches_stacked_fp)}
    for k in kernels:
        counter, run = source[k["name"]]
        k["launches"] = run[counter]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    kernels += probe_lines  # launches: the probe phase's own run
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
