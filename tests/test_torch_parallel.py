"""The port's sequence-parallel Engine (EngineConfig.mesh with a ("data",
"seq") mesh, parallel/) in gloo process groups on the CPU, against the
JAX Engine on Mesh(devices, ("data", "seq")) of the 8 virtual CPU devices
(as tests/test_parallel.py:282-343 and :400-480 build it) and against the
port's single-process Engine.

Meshes: seq 4 (data 1), and data 2 x seq 2. Each mesh runs once, in four
processes started by torch.multiprocessing (spawn; one torch thread each;
a free port; a join deadline), which run every case
(tests/test_torch_parallel_worker.py imports torch only, so no child
imports JAX). Cases: the packed cache at 4-bit sym and 3-bit asym, the
per-chunk cache (4-bit, chunk 8), the rank-major and the seq-major bf16
caches, and a Qwen2-style model with biases and linear RoPE scaling.
The JAX engines run their decode kernels at f32 compute (the kernels'
compute_dtype, bf16 by default, patched to f32 for these runs, as the
port's kernel tests call them), so both sides compute in f32. Tolerance
2e-3 (rtol and atol), JAX's own for its seq-sharded engine: the shards'
statistics merge in another order than one pass sums them. The
processes of one data row must agree exactly, and each prefill shard must
equal its columns of the single-process cache bit for bit."""

import dataclasses
import functools
import pickle
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import test_torch_parallel_worker as worker
from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.ops.pallas import palu_decode4 as jpk4
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.parallel import (default_backend, initialize_multihost, make_mesh,
                                     make_pod_mesh, world_size)
from palu_tpu_torch.runtime.engine import Engine

TOL = 2e-3
MESHES = {"seq4": (1, 4), "data2_seq2": (2, 2)}
IDS = np.random.default_rng(6).integers(0, 64, (2, 12))
STEPS = [[[3], [5]], [[7], [1]]]
BASE = dict(s_max=32, batch=2, decode_chunk=8, pallas_block=8)
# name: (model, qcfg kwargs, rank_major_fp)
CASES = {"q4_sym": ("llama", dict(bits=4, group_size=0, sym=True), False),
         "q3_asym": ("llama", dict(bits=3, group_size=0, sym=False), False),
         "chunked": ("llama", dict(bits=4, group_size=8, sym=True), False),
         "fp_rank_major": ("llama", None, True),
         "fp_seq_major": ("llama", None, False),
         "qwen2_scaled_rope": ("qwen2", dict(bits=4, group_size=0, sym=True), False)}


def _model(kind):
    if kind == "qwen2":
        from test_engine import _qwen2_bias_model

        params, cfg = _qwen2_bias_model(seed=51)
        return params, dataclasses.replace(
            cfg, rope_scaling={"rope_type": "linear", "factor": 2.0})
    from test_parallel import _model as parallel_model

    return parallel_model(seed=6)


_SPEC = {}


def _spec():
    """Per case: the JAX params and config, and what the workers need."""
    if not _SPEC:
        models = {kind: _model(kind) for kind in ("llama", "qwen2")}
        for name, (kind, qkw, rm) in CASES.items():
            jparams, jcfg = models[kind]
            _SPEC[name] = {"jparams": jparams, "jcfg": jcfg,
                           "params": jax.tree.map(np.asarray, jparams),
                           "cfg": dataclasses.asdict(jcfg),
                           "ecfg": dict(BASE, qcfg=qkw, rank_major_fp=rm),
                           "ids": IDS, "steps": STEPS}
    return _SPEC


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RUNS = {}


def _mesh_run(mesh_name, tmp_path_factory):
    """Every case on one mesh in four gloo processes; their results by rank."""
    if mesh_name not in _RUNS:
        data, seq = MESHES[mesh_name]
        out = tmp_path_factory.mktemp(mesh_name)
        spec_path = out / "spec.pkl"
        with open(spec_path, "wb") as f:
            pickle.dump({k: {kk: vv for kk, vv in v.items() if not kk.startswith("j")}
                         for k, v in _spec().items()}, f)
        ctx = mp.get_context("spawn")
        world, port = data * seq, _free_port()
        procs = [ctx.Process(target=worker.run,
                             args=(r, world, port, data, seq, str(spec_path), str(out)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        assert not alive and codes == [0] * world, f"workers: exit codes {codes}"
        runs = []
        for r in range(world):
            with open(out / f"rank{r}.pkl", "rb") as f:
                runs.append(pickle.load(f))
        _RUNS[mesh_name] = runs
    return _RUNS[mesh_name]


_JAX = {}


def _jax_logits(case_name, mesh_name=None):
    """The JAX Engine's prefill + decode logits (B, 3, V), on one device or
    on the (data, seq) mesh of the virtual CPU devices, its v4 decode
    kernels at f32 compute."""
    key = (case_name, mesh_name)
    if key not in _JAX:
        with pytest.MonkeyPatch.context() as mpatch:
            for name in ("palu_flash_decode4", "palu_flash_decode4_quantized"):
                mpatch.setattr(jpk4, name, functools.partial(getattr(jpk4, name),
                                                             compute_dtype=jnp.float32))
            _JAX[key] = _jax_run(case_name, mesh_name)
    return _JAX[key]


def _jax_run(case_name, mesh_name):
    c = _spec()[case_name]
    mesh = None
    if mesh_name is not None:
        data, seq = MESHES[mesh_name]
        mesh = Mesh(np.asarray(jax.devices()[:data * seq]).reshape(data, seq), ("data", "seq"))
    qkw = c["ecfg"]["qcfg"]
    e = JEngine(c["jparams"], c["jcfg"], JEngineConfig(
        **BASE, dtype=jnp.float32, qcfg=None if qkw is None else JQuantConfig(**qkw),
        rank_major_fp=c["ecfg"]["rank_major_fp"], use_pallas=True, pallas_interpret=True,
        mesh=mesh, seq_axis=None if mesh is None else "seq"))
    lg, cache = e.prefill(IDS)
    out = [np.asarray(lg)[:, -1:]]
    for tok in STEPS:
        lg, cache = e.decode(np.asarray(tok), cache)
        out.append(np.asarray(lg)[:, -1:])
    return np.concatenate(out, axis=1)


_SINGLE = {}


def _single(case_name):
    """The port's single-process Engine on the same case."""
    if case_name not in _SINGLE:
        c = _spec()[case_name]
        eng = Engine(params_from_numpy(c["params"], device="cpu"), config_from_dict(c["cfg"]),
                     worker.engine_config(c["ecfg"]))
        _SINGLE[case_name] = worker.drive(eng, IDS, STEPS)
    return _SINGLE[case_name]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_seq_engine_matches_jax_seq_engine(mesh_name, case, tmp_path_factory):
    runs = _mesh_run(mesh_name, tmp_path_factory)
    want = _jax_logits(case, mesh_name)
    for r, run in enumerate(runs):
        got = run["cases"][case]
        lo, hi = got["lanes"]
        assert hi - lo == 2 // MESHES[mesh_name][0]
        _close(got["logits"], want[lo:hi])
    # the processes of one data row compute the same logits
    for run in runs:
        peers = [o for o in runs if o["cases"][case]["lanes"] == run["cases"][case]["lanes"]]
        assert len(peers) == MESHES[mesh_name][1]
        for o in peers:
            np.testing.assert_array_equal(o["cases"][case]["logits"], run["cases"][case]["logits"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_seq_engine_matches_single_process(mesh_name, case, tmp_path_factory):
    runs = _mesh_run(mesh_name, tmp_path_factory)
    single = _single(case)
    rm, quant = CASES[case][2], CASES[case][1] is not None
    path = ("palu_decode" if quant else "palu_decode_fp_t" if rm else "flash_decode_latent")
    for run in runs:
        got = run["cases"][case]
        lo, hi = got["lanes"]
        _close(got["logits"], single["logits"][lo:hi])
        assert got["paths"] == [f"{path}[seq]-plain"]
        # the prefill shard: its columns of the single-process cache, exactly
        c0, n = got["seq_index"] * got["s_local"], got["s_local"]
        for shard, whole in zip(got["shard"], single["shard"]):
            for side, bufs in whole.items():
                for k, v in bufs.items():
                    ax = v.ndim - 1 if k.endswith("_t") else v.ndim - 2
                    want = np.take(v[lo:hi], np.arange(c0, c0 + n), axis=ax)
                    np.testing.assert_array_equal(shard[side][k], want, err_msg=f"{side}/{k}")
    _close(single["logits"], _jax_logits(case))  # the port's single engine vs JAX's


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_host_local_batch_slice_and_pod_mesh(mesh_name, tmp_path_factory):
    runs = _mesh_run(mesh_name, tmp_path_factory)
    data, _ = MESHES[mesh_name]
    for rank, run in enumerate(runs):
        per = 8 // data
        i = rank // MESHES[mesh_name][1]  # the data coordinate of a row-major mesh
        assert (run["host_slice"].start, run["host_slice"].stop) == (i * per, (i + 1) * per)
        assert run["pod_shape"] == (2, 2)  # four processes, model parallelism 2
        assert (run["pod_slice"].start, run["pod_slice"].stop) == ((rank // 2) * 4,
                                                                   (rank // 2) * 4 + 4)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_model_axis_is_refused(mesh_name, tmp_path_factory):
    for run in _mesh_run(mesh_name, tmp_path_factory):
        assert "later slice" in run["model_axis"]


def test_mesh_validation():
    """test_parallel.py:77-93 in one process: a mesh larger than the
    processes there are, and a pod mesh whose model axis does not divide
    them, raise."""
    assert world_size() == 1
    with pytest.raises(ValueError):
        make_mesh(data=4, model=4)
    with pytest.raises(ValueError):
        make_mesh(data=1, model=2, seq=2)
    with pytest.raises(ValueError):
        make_pod_mesh(model_parallelism=3)


def test_initialize_multihost_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_multihost()
    initialize_multihost(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert default_backend("cuda") == "nccl" and default_backend("cpu") == "gloo"


def test_seq_axis_needs_a_mesh():
    c = _spec()["q4_sym"]
    with pytest.raises(ValueError, match="mesh"):
        Engine(params_from_numpy(c["params"], device="cpu"), config_from_dict(c["cfg"]),
               worker.engine_config(c["ecfg"], seq_axis="seq"))
