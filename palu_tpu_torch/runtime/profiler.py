"""TPOT (time-per-output-token) profiling (port of
palu_tpu/runtime/profiler.py).

The reference protocol: seed the cache with random content at a prompt
length, then time decode steps. `seed_cache_random` draws every leaf from
one numpy stream in the cache's own order, so equal shapes give the JAX
profiler's cache bit for bit. `profile_tpot` times each step on the host
clock up to a fetch of the logits (the JAX profiler fetches too);
`profile_tpot_chained` issues n_steps steps with no host sync between them,
feeding each step's argmax token on the device, and cancels the fixed
per-call cost as (t_k - t_1) / ((k_calls - 1) * n_steps). `trace_dir`
writes a torch.profiler chrome trace of the timed steps there.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["seed_cache_random", "profile_tpot", "profile_tpot_chained", "device_memory_stats"]


def _random_buf(rng: np.random.Generator, key: str, buf: torch.Tensor) -> np.ndarray:
    """Random content for a cache leaf by its role (any layout)."""
    shape = tuple(buf.shape)
    if key in ("lat", "lat_t"):
        return rng.standard_normal(shape).astype(np.float32)
    if key in ("codes", "codes_t"):
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if key in ("zero_t", "base"):
        return rng.standard_normal(shape).astype(np.float32) * 0.05
    # scales / scale_t: small positive
    return np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.05


def seed_cache_random(engine, prompt_len: int, seed: int = 0) -> dict:
    """A cache of `engine` filled with random content and every lane's
    length set to prompt_len (the reference seeds its cache with randn
    latents)."""
    rng = np.random.default_rng(seed)
    cache = engine.init_cache()
    if "stack" in cache:  # layer-stacked engine: one (L, ...) leaf per buffer
        entries, prompt_len = [cache["stack"]], min(prompt_len, engine.ecfg.s_max)
    else:
        entries = cache["layers"]
    for entry in entries:
        for bufs in entry.values():
            for key, buf in bufs.items():
                buf.copy_(torch.from_numpy(_random_buf(rng, key, buf)))
    cache["length"].fill_(prompt_len)
    return cache


def _trace(trace_dir: Optional[str], device: torch.device):
    if not trace_dir:
        return contextlib.nullcontext(None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _export(prof, trace_dir: Optional[str]) -> None:
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def profile_tpot(engine, prompt_len: int, n_steps: int = 100, warmup: int = 10,
                 trace_dir: Optional[str] = None, seed: int = 0) -> dict:
    """{"tpot_ms": median ms/token, "p20_ms", "p80_ms", "tokens_per_s",
    "n_steps", "prompt_len"}: each step timed on the host clock up to a
    fetch of its logits."""
    b, dev = engine.ecfg.batch, engine.device
    cache = seed_cache_random(engine, prompt_len, seed)
    token = torch.zeros((b, 1), dtype=torch.long, device=dev)
    act = torch.ones((b,), dtype=torch.bool, device=dev)
    for _ in range(warmup):
        logits, cache = engine.decode(token, cache, active=act)
    logits[:, :, :1].cpu()
    times = []
    with _trace(trace_dir, dev) as prof:
        for _ in range(n_steps):
            t0 = time.perf_counter()
            logits, cache = engine.decode(token, cache, active=act)
            logits[:, :, :1].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    _export(prof, trace_dir)
    times = np.asarray(times)
    return {
        "tpot_ms": float(np.median(times)),
        "p20_ms": float(np.percentile(times, 20)),
        "p80_ms": float(np.percentile(times, 80)),
        "tokens_per_s": float(b * 1e3 / np.median(times)),
        "n_steps": n_steps,
        "prompt_len": prompt_len,
    }


def profile_tpot_chained(engine, prompt_len: int, n_steps: int = 64, k_calls: int = 3,
                         reps: int = 3, seed: int = 0, trace_dir: Optional[str] = None) -> dict:
    """TPOT with the per-call fixed cost cancelled: one call runs n_steps
    greedy steps back to back (each step's argmax token feeds the next on
    the device); 1 call and k_calls calls are timed up to a fetch, best of
    `reps` each, and (t_k - t_1) / ((k_calls - 1) * n_steps) reported."""
    b, dev = engine.ecfg.batch, engine.device
    cache = seed_cache_random(engine, prompt_len, seed)
    token = torch.zeros((b, 1), dtype=torch.long, device=dev)
    act = torch.ones((b,), dtype=torch.bool, device=dev)

    def run(cache):
        tok = token
        for _ in range(n_steps):
            logits, cache = engine.decode(tok, cache, active=act)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
        return tok, cache

    t0 = time.perf_counter()
    tok, cache = run(cache)
    tok.cpu()
    first_s = time.perf_counter() - t0

    def timed(ncalls):
        nonlocal cache
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _i in range(ncalls):
                tok, cache = run(cache)
            tok.cpu()
            best = min(best, time.perf_counter() - t0)
        return best

    with _trace(trace_dir, dev) as prof:
        t1 = timed(1)
        tk = timed(k_calls)
    _export(prof, trace_dir)
    tpot_ms = (tk - t1) / ((k_calls - 1) * n_steps) * 1e3
    return {
        "tpot_ms": float(tpot_ms),
        "tokens_per_s": float(b * 1e3 / tpot_ms),
        "n_steps": n_steps,
        "k_calls": k_calls,
        "prompt_len": prompt_len,
        # the JAX profiler's compile time: here the first call, kernels built
        "compile_s": float(first_s),
        "t1_s": float(t1),
        "tk_s": float(tk),
    }


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats() of the current card; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats())
