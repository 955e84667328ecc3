"""Continuous-batching serving (port of palu_tpu/runtime/serving.py, single
process).

A fixed-lane engine (one decode step over B lanes) driven by the native C++
scheduler (native/scheduler.cc, built with `make -C native` into
native/libpalusched.so and bound with ctypes). Requests are admitted into
free lanes, prefilled by a batch-1 engine sharing the serving engine's
weights (whole at admission, or `prefill_chunks_per_step` chunks per
decode step), copied into their lane of the batched cache, and decoded
together; a finished lane is recycled at once, so decode never waits on
stragglers. Sampled requests draw Gumbel noise seeded by (sampling_seed,
request id, step): a request's tokens do not depend on its lane or on the
other requests.

`PyScheduler` mirrors the native scheduler for the tests and for callers
who pass prefer_native=False; with prefer_native=True a library that fails
to build raises. The multi-host parts of the JAX module (host-side lane
writes, token all-gathers, mesh sharding) come with the port's parallelism.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import sampling as sampling_lib
from .engine import Engine, EngineConfig

__all__ = ["NativeScheduler", "PyScheduler", "ServingEngine", "load_scheduler"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"


def _ensure_native_lib() -> str:
    """Path of native/libpalusched.so, built with `make -C native` when it is
    missing or older than scheduler.cc. The build holds a lock on the source
    so that concurrent processes build once. Raises when the build fails."""
    so, src = _NATIVE_DIR / "libpalusched.so", _NATIVE_DIR / "scheduler.cc"
    if not src.exists():
        raise RuntimeError(f"native scheduler source {src} not found")

    def fresh() -> bool:
        return so.exists() and so.stat().st_mtime >= src.stat().st_mtime

    if fresh():
        return str(so)
    with open(src) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh():
            res = subprocess.run(["make", "-C", str(_NATIVE_DIR)], capture_output=True,
                                 text=True, timeout=300)
            if res.returncode != 0 or not fresh():
                raise RuntimeError(f"make -C {_NATIVE_DIR} failed (exit {res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
    return str(so)


class NativeScheduler:
    """ctypes binding over native/scheduler.cc."""

    def __init__(self, num_lanes: int, s_max: int, so_path: Optional[str] = None):
        lib = ctypes.CDLL(so_path or _ensure_native_lib())
        i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        sigs = {
            "palu_sched_create": ([i32, i32], vp),
            "palu_sched_destroy": ([vp], None),
            "palu_sched_add": ([vp, i64, i32, i32], i32),
            "palu_sched_cancel": ([vp, i64], i32),
            "palu_sched_admit": ([vp, ctypes.POINTER(i64), ctypes.POINTER(i32), i32], i32),
            "palu_sched_active": ([vp, ctypes.POINTER(i64)], i32),
            "palu_sched_on_token": ([vp, i32, i32], i32),
            "palu_sched_request_state": ([vp, i64], i32),
            "palu_sched_generated": ([vp, i64], i32),
            "palu_sched_num_queued": ([vp], i32),
            "palu_sched_stats": ([vp, ctypes.POINTER(i64), ctypes.POINTER(i64),
                                  ctypes.POINTER(i64)], None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        self._lib = lib
        self._h = lib.palu_sched_create(num_lanes, s_max)
        self.num_lanes = num_lanes

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.palu_sched_destroy(self._h)
            self._h = None

    def add(self, rid: int, prompt_len: int, max_new_tokens: int) -> bool:
        return self._lib.palu_sched_add(self._h, rid, prompt_len, max_new_tokens) == 0

    def cancel(self, rid: int) -> bool:
        return self._lib.palu_sched_cancel(self._h, rid) == 0

    def admit(self):
        ids = (ctypes.c_int64 * self.num_lanes)()
        lanes = (ctypes.c_int32 * self.num_lanes)()
        n = self._lib.palu_sched_admit(self._h, ids, lanes, self.num_lanes)
        return [(int(ids[i]), int(lanes[i])) for i in range(n)]

    def active(self) -> List[int]:
        ids = (ctypes.c_int64 * self.num_lanes)()
        self._lib.palu_sched_active(self._h, ids)
        return [int(x) for x in ids]

    def on_token(self, lane: int, is_eos: bool) -> int:
        return self._lib.palu_sched_on_token(self._h, lane, 1 if is_eos else 0)

    def state(self, rid: int) -> int:
        return self._lib.palu_sched_request_state(self._h, rid)

    def generated(self, rid: int) -> int:
        return self._lib.palu_sched_generated(self._h, rid)

    def num_queued(self) -> int:
        return self._lib.palu_sched_num_queued(self._h)

    def stats(self):
        a, f, t = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.palu_sched_stats(self._h, ctypes.byref(a), ctypes.byref(f), ctypes.byref(t))
        return {"admitted": a.value, "finished": f.value, "tokens": t.value}


class PyScheduler:
    """Pure-Python mirror of the native scheduler (the tests' oracle)."""

    def __init__(self, num_lanes: int, s_max: int):
        self.num_lanes = num_lanes
        self.s_max = s_max
        self.queue: List[int] = []
        self.lanes = [-1] * num_lanes
        self.requests: Dict[int, dict] = {}
        self._stats = {"admitted": 0, "finished": 0, "tokens": 0}

    def add(self, rid, prompt_len, max_new_tokens):
        if prompt_len >= self.s_max:
            return False
        room = self.s_max - prompt_len
        self.requests[rid] = {
            "prompt_len": prompt_len,
            "max_new": min(max_new_tokens, room),
            "generated": 0, "lane": -1, "state": 0,
        }
        self.queue.append(rid)
        self._stats["admitted"] += 1
        return True

    def cancel(self, rid):
        r = self.requests.get(rid)
        if r is None:
            return False
        if r["state"] == 1 and r["lane"] >= 0:
            self.lanes[r["lane"]] = -1
        r["state"] = 3
        return True

    def admit(self):
        out = []
        for lane in range(self.num_lanes):
            if self.lanes[lane] != -1:
                continue
            while self.queue:
                rid = self.queue.pop(0)
                r = self.requests.get(rid)
                if r is None or r["state"] != 0:
                    continue
                r["state"], r["lane"] = 1, lane
                self.lanes[lane] = rid
                out.append((rid, lane))
                break
        return out

    def active(self):
        return list(self.lanes)

    def on_token(self, lane, is_eos):
        rid = self.lanes[lane]
        if rid == -1:
            return -1
        r = self.requests[rid]
        r["generated"] += 1
        self._stats["tokens"] += 1
        if is_eos or r["generated"] >= r["max_new"]:
            r["state"], r["lane"] = 2, -1
            self.lanes[lane] = -1
            self._stats["finished"] += 1
            return 1
        return 0

    def state(self, rid):
        r = self.requests.get(rid)
        return -1 if r is None else r["state"]

    def generated(self, rid):
        r = self.requests.get(rid)
        return -1 if r is None else r["generated"]

    def num_queued(self):
        return sum(1 for rid in self.queue if self.requests[rid]["state"] == 0)

    def stats(self):
        return dict(self._stats)


def load_scheduler(num_lanes: int, s_max: int, prefer_native: bool = True):
    """The native scheduler (its build failing raises), or with
    prefer_native=False the Python one."""
    if prefer_native:
        return NativeScheduler(num_lanes, s_max)
    return PyScheduler(num_lanes, s_max)


class ServingEngine:
    """Continuous batching over a lane-batched Engine (ecfg.batch lanes)."""

    def __init__(self, params, cfg, ecfg: EngineConfig, prefer_native: bool = True,
                 prefill_chunks_per_step: Optional[int] = None, sampling_seed: int = 0):
        """prefill_chunks_per_step: None prefills a whole prompt at admission
        (lowest latency for that request when the queue is empty); an int K
        advances each admitted prompt by at most K chunks per decode step,
        so a long admission never stalls the running lanes (chunked
        prefill).

        sampling_seed: base seed of per-request sampling (submit's
        `sampling`); a request's noise at step t is seeded by
        (sampling_seed, rid, t)."""
        if ecfg.batch < 1:
            raise ValueError(f"batch must be >= 1, got {ecfg.batch}")
        if ecfg.mesh is not None:
            raise NotImplementedError("serving on a mesh (JAX's _lane_write, "
                                      "_insert_hostside, _sync_tokens) comes with the "
                                      "tensor-parallel slice of the port")
        if ecfg.stacked_decode is None:  # None -> False, as JAX's ServingEngine resolves it
            ecfg = dataclasses.replace(ecfg, stacked_decode=False)
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self._sampling: Dict[int, sampling_lib.SamplingParams] = {}
        self._sampling_seed = sampling_seed
        self._inflight: Dict[int, Dict] = {}  # rid -> partial-prefill state
        self._prompts: Dict[int, np.ndarray] = {}
        self.engine = Engine(params, cfg, ecfg)
        # batch-1 engine for per-request prefill on the serving engine's
        # (possibly quantized) weights: quantize_params passes quantized
        # leaves through, so the weights are not held twice
        self.prefill_engine = Engine(self.engine.params, self.engine.cfg,
                                     dataclasses.replace(ecfg, batch=1))
        self.sched = load_scheduler(ecfg.batch, ecfg.s_max, prefer_native)
        self.cache = self.engine.init_cache()
        self.tokens = np.zeros((ecfg.batch, 1), np.int64)  # next input per lane
        self._lane_temp = np.zeros((ecfg.batch,), np.float32)
        self._lane_topk = np.zeros((ecfg.batch,), np.int64)
        self._lane_topp = np.ones((ecfg.batch,), np.float32)
        self.outputs: Dict[int, List[int]] = {}
        self.eos_token_id: Optional[int] = None

    def _insert(self, single_cache, lane: int) -> None:
        """Copy a batch-1 prefilled cache into lane `lane`, in place: the
        per-layer cache (lane on axis 0 of every leaf) or the layer-stacked
        one (lane on axis 1, behind the layer axis)."""
        if "stack" in self.cache:
            for side, bufs in self.cache["stack"].items():
                for k, buf in bufs.items():
                    buf[:, lane].copy_(single_cache["stack"][side][k][:, 0])
        else:
            for b_entry, s_entry in zip(self.cache["layers"], single_cache["layers"]):
                for side, bufs in b_entry.items():
                    for k, buf in bufs.items():
                        buf[lane].copy_(s_entry[side][k][0])
        self.cache["length"][lane] = single_cache["length"][0]

    def submit(self, rid: int, prompt_ids, max_new_tokens: int,
               sampling: Optional[sampling_lib.SamplingParams] = None) -> bool:
        """Queue a request; sampling None or temperature <= 0 is greedy.
        False when the prompt can never fit the cache."""
        prompt_ids = np.asarray(prompt_ids).reshape(1, -1)
        ok = self.sched.add(rid, prompt_ids.shape[1], max_new_tokens)
        if ok:
            self.outputs[rid] = []
            self._prompts[rid] = prompt_ids
            if sampling is not None and sampling.temperature > 0.0:
                self._sampling[rid] = sampling
        return ok

    def _set_lane_sampling(self, lane: int, rid: int) -> None:
        """Record a lane's sampling params when its request enters the lane."""
        sp = self._sampling.get(rid)
        self._lane_temp[lane] = 0.0 if sp is None else sp.temperature
        self._lane_topk[lane] = 0 if sp is None else sp.top_k
        self._lane_topp[lane] = 1.0 if sp is None else sp.top_p

    def _sample_step(self, logits_last: torch.Tensor, active: List[int]) -> torch.Tensor:
        """Sample every lane from (B, V) logits in one batched call: greedy
        lanes take the argmax, sampled lanes their own parameters and the
        noise of (seed, rid, step), which `sample` on the row alone would
        also get. Noise is drawn only for the decoding sampled lanes."""
        b, v = logits_last.shape
        noise = torch.zeros((b, v), dtype=torch.float32)
        for lane, rid in enumerate(active):
            if rid != -1 and rid not in self._inflight and self._lane_temp[lane] > 0.0:
                noise[lane] = sampling_lib.gumbel_noise(
                    (v,), "cpu", self._sampling_seed, rid, len(self.outputs[rid]))
        dev = logits_last.device
        return sampling_lib.sample_batched(
            logits_last, torch.as_tensor(self._lane_temp, device=dev),
            torch.as_tensor(self._lane_topk, device=dev),
            torch.as_tensor(self._lane_topp, device=dev), noise.to(dev))

    def _pick_token(self, rid: int, logits_row: torch.Tensor) -> int:
        """First token of `rid` from its (V,) prefill logits row."""
        sp = self._sampling.get(rid)
        if sp is None:
            return int(logits_row.argmax())
        noise = sampling_lib.gumbel_noise((1, logits_row.shape[-1]), logits_row.device,
                                          self._sampling_seed, rid, len(self.outputs[rid]))
        return int(sampling_lib.sample(logits_row[None], sp, noise)[0])

    def _first_token(self, rid: int, lane: int, last_logits, single_cache) -> None:
        """Sample a prefilled request's first token and move it into its lane."""
        first = self._pick_token(rid, last_logits)
        self._insert(single_cache, lane)
        self.tokens[lane, 0] = first
        self.outputs[rid].append(first)
        self.sched.on_token(lane, self._is_eos(first))

    @torch.no_grad()
    def step(self) -> int:
        """Admit (and prefill) new requests, advance chunked prefills, then
        run one decode step over all lanes. Returns the number of active
        lanes, or 1 while only prefills are in flight."""
        for rid, lane in self.sched.admit():
            prompt = self._prompts.pop(rid)
            self._set_lane_sampling(lane, rid)
            if self.prefill_chunks_per_step is not None:
                self._inflight[rid] = {"lane": lane, "off": 0, "prompt": prompt,
                                       "logits": None,
                                       "cache": self.prefill_engine.init_cache()}
                continue
            logits, single = self.prefill_engine.prefill_auto(prompt)
            self._first_token(rid, lane, logits[0, -1], single)
        self._advance_prefills()

        active = self.sched.active()
        n_active = sum(1 for a in active if a != -1)
        if n_active == 0:
            return 1 if self._inflight else 0

        # idle lanes decode too (one batch shape) but the active mask
        # freezes their length and makes their cache writes no-ops; lanes
        # still mid-prefill are masked out as well
        mask = torch.tensor([a != -1 and a not in self._inflight for a in active],
                            device=self.engine.device)
        logits, self.cache = self.engine.decode(self.tokens, self.cache, active=mask)
        if self._sampling:
            picked = self._sample_step(logits[:, -1], active)
        else:
            picked = logits[:, -1].argmax(dim=-1)
        next_toks = picked.cpu().numpy()
        for lane, rid in enumerate(active):
            if rid == -1 or rid in self._inflight:
                continue
            tok = int(next_toks[lane])
            self.outputs[rid].append(tok)
            self.tokens[lane, 0] = tok
            self.sched.on_token(lane, self._is_eos(tok))
        return n_active

    def _advance_prefills(self) -> None:
        """Advance each in-flight chunked prefill by up to
        prefill_chunks_per_step chunks; a completed prompt gets its first
        token and enters its lane."""
        chunk = self.prefill_engine._chunk
        for rid in list(self._inflight):
            st = self._inflight[rid]
            total = st["prompt"].shape[1]
            for _ in range(self.prefill_chunks_per_step):
                end = min(st["off"] + chunk, total)
                ids = np.zeros((1, chunk), np.int64)
                ids[:, :end - st["off"]] = st["prompt"][:, st["off"]:end]
                st["logits"], st["cache"] = self.prefill_engine.prefill_chunk(
                    ids, st["cache"], st["off"])
                st["off"] = end
                if end >= total:
                    break
            if st["off"] < total:
                continue
            single = st["cache"]
            single["length"] = torch.full((1,), total, dtype=torch.int32,
                                          device=self.engine.device)
            self._first_token(rid, st["lane"], st["logits"][0, (total - 1) % chunk], single)
            del self._inflight[rid]

    def _is_eos(self, tok: int) -> bool:
        return self.eos_token_id is not None and tok == self.eos_token_id

    def run_until_done(self, max_steps: int = 100000) -> Dict[int, List[int]]:
        steps = 0
        while (self.sched.num_queued() > 0 or any(a != -1 for a in self.sched.active())
               ) and steps < max_steps:
            self.step()
            steps += 1
        return self.outputs
