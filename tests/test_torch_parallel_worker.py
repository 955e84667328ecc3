"""One process of tests/test_torch_parallel.py's gloo runs (torch only: a
spawned child imports this module and never JAX; it holds no tests).

`run` joins a gloo group of `world` CPU processes, builds the (data, seq)
mesh, and for every case of the spec (numpy params and a config made by
the parent from the JAX package's models) drives the port's Engine on its
share: prefill_chunked of the case's prompt, then its decode steps. It
writes what it saw to <out_dir>/rank<rank>.pkl: per case the logits of
every step, the cache shard right after prefill and the decode paths;
then the host-local lanes of an 8-lane batch on the mesh and on a
(data, model) pod mesh, and whether an engine refuses a model axis > 1."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.parallel import (host_local_batch_slice, initialize_multihost, make_mesh,
                                     make_pod_mesh)
from palu_tpu_torch.runtime.engine import Engine, EngineConfig


def engine_config(ecfg: dict, **kw) -> EngineConfig:
    """EngineConfig on the CPU from a spec's plain dict (qcfg as kwargs)."""
    d = dict(ecfg)
    d["qcfg"] = None if d.get("qcfg") is None else QuantConfig(**d["qcfg"])
    return EngineConfig(dtype=torch.float32, device="cpu", **d, **kw)


def drive(eng: Engine, ids, steps) -> dict:
    """prefill_chunked in chunks of 8, then one decode per step's tokens:
    the logits (B, 1 + steps, V) and the cache leaves after prefill."""
    logits, cache = eng.prefill_chunked(ids, chunk_size=8)
    shard = [{side: {k: v.clone().numpy() for k, v in bufs.items()}
              for side, bufs in entry.items()} for entry in cache["layers"]]
    out = [logits[:, -1:].numpy()]
    for tok in steps:
        logits, cache = eng.decode(np.asarray(tok), cache)
        out.append(logits[:, -1:].numpy())
    return {"logits": np.concatenate(out, axis=1), "shard": shard,
            "paths": sorted(eng._decode_paths)}


def run(rank: int, world: int, port: int, data: int, seq: int, spec_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(data, seq=seq, device_type="cpu")
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {"cases": {}}
    for name, case in spec.items():
        eng = Engine(params_from_numpy(case["params"], device="cpu"),
                     config_from_dict(case["cfg"]),
                     engine_config(case["ecfg"], mesh=mesh, seq_axis="seq"))
        out["cases"][name] = drive(eng, case["ids"], case["steps"])
        out["cases"][name]["lanes"] = (eng._lanes.start, eng._lanes.stop)
        out["cases"][name]["s_local"] = eng._seq["s_local"]
        out["cases"][name]["seq_index"] = eng._seq["index"]
    out["host_slice"] = host_local_batch_slice(8, mesh)
    pod = make_pod_mesh(2, device_type="cpu")
    out["pod_shape"] = tuple(pod.shape)
    out["pod_slice"] = host_local_batch_slice(8, pod)
    case = next(iter(spec.values()))
    try:
        Engine(params_from_numpy(case["params"], device="cpu"), config_from_dict(case["cfg"]),
               engine_config(case["ecfg"], mesh=pod))
        out["model_axis"] = "accepted"
    except NotImplementedError as e:
        out["model_axis"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
