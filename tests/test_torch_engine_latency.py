"""The latency path of the port on the CPU against the JAX package:
seed_cache_random bit for bit, a dense-KV engine's decode, the int8_rot
engine, the formulation knobs' validation, and the profiler's records."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.compression import compress_params
from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import ModelConfig as JModelConfig, llama as jllama
from palu_tpu.runtime import profiler as jprofiler
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime import profiler
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from palu_tpu_torch.runtime.serving import NativeScheduler, ServingEngine

FLAGSHIP = dict(bits=3, group_size=0, sym=True, container=4)


def _cfg(ranks=None, layers=2):
    hwr = None
    if ranks:
        hwr = {}
        for i in range(layers):
            hwr[f"model.layers.{i}.self_attn.k_proj"] = [ranks[0]] * 2
            hwr[f"model.layers.{i}.self_attn.v_proj"] = [ranks[1]] * 2
    return JModelConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=hwr)


def _pair(jcfg, jparams, s_max=96, chunk=32, qkw=None, **knobs):
    """The JAX engine (XLA paths) and the port's on the CPU, f32, same weights."""
    jq = JQuantConfig(**qkw) if qkw else None
    tq = QuantConfig(**qkw) if qkw else None
    jeng = JEngine(jparams, jcfg, JEngineConfig(s_max=s_max, dtype=jnp.float32, qcfg=jq,
                                                decode_chunk=chunk, **knobs))
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                  config_from_dict(dataclasses.asdict(jcfg)),
                  EngineConfig(s_max=s_max, dtype=torch.float32, qcfg=tq, decode_chunk=chunk,
                               device="cpu",
                               **{k: v for k, v in knobs.items() if k.startswith("kernel_")}))
    return jeng, teng


def _leaves(cache):
    for i, entry in enumerate(cache["layers"]):
        for side, bufs in entry.items():
            for key, buf in bufs.items():
                yield f"{i}/{side}/{key}", buf


def _as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["packed_sym", "packed_asym", "lat", "lat_t", "dense"])
def test_seed_cache_random_bit_identical(kind):
    jcfg = _cfg(None if kind == "dense" else (8, 16))
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.2)
    qkw = {"packed_sym": FLAGSHIP, "packed_asym": dict(bits=4, sym=False)}.get(kind)
    knobs = {"rank_major_fp": True} if kind == "lat_t" else {}
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=64, dtype=jnp.bfloat16, qcfg=JQuantConfig(**qkw) if qkw else None, **knobs))
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                  config_from_dict(dataclasses.asdict(jcfg)),
                  EngineConfig(s_max=64, dtype=torch.bfloat16, device="cpu",
                               qcfg=QuantConfig(**qkw) if qkw else None, **knobs))
    want = jprofiler.seed_cache_random(jeng, 40, seed=3)
    got = profiler.seed_cache_random(teng, 40, seed=3)
    jl, tl = dict(_leaves(want)), dict(_leaves(got))
    assert list(jl) == list(tl)  # same leaves in the same order
    for name, jbuf in jl.items():
        tbuf = tl[name]
        assert tuple(tbuf.shape) == jbuf.shape, name
        np.testing.assert_array_equal(_as_np(tbuf), _as_np(jbuf), err_msg=name)
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))


def test_dense_engine_decode_matches_jax():
    """The dense-KV baseline: decode steps from the same seeded cache (the
    port writes roped K/V and runs the plain flash pass on the CPU)."""
    jcfg = _cfg(None)
    jparams = jllama.init_params(jcfg, jax.random.key(1), dtype=jnp.float32, scale=0.2)
    jeng, teng = _pair(jcfg, jparams)
    jcache = jprofiler.seed_cache_random(jeng, 50, seed=5)
    tcache = profiler.seed_cache_random(teng, 50, seed=5)
    for t in np.random.default_rng(6).integers(0, 96, 4):
        want, jcache = jeng.decode(np.full((1, 1), t, np.int32), jcache)
        got, tcache = teng.decode(np.full((1, 1), t, np.int64), tcache)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert teng._decode_paths == {"dense_flash-plain"}
    # the written K/V are h @ W from XLA's and PyTorch's f32 matmuls, which
    # sum in different orders: equal to a few f32 ulps
    for name, jbuf in _leaves(jcache):
        np.testing.assert_allclose(_as_np(dict(_leaves(tcache))[name]), _as_np(jbuf),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    with pytest.raises(NotImplementedError):  # the chunked prefill refuses dense layers, as JAX's
        teng.prefill_chunked(np.zeros((1, 8), np.int64), chunk_size=32)


def _lowrank(seed):
    jcfg = JModelConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                        max_position_embeddings=64)
    jparams = jllama.init_params(jcfg, jax.random.key(seed))
    sel = {}
    for i in range(2):
        sel[f"model.layers.{i}.self_attn.k_proj"] = [16] * 2
        sel[f"model.layers.{i}.self_attn.v_proj"] = [16] * 2
    return compress_params(jparams, jcfg, sel, decompose_method="svd", head_group_size=2)


def _stepwise(eng, ids, to_np):
    p = ids.shape[1] // 2
    logits, cache = eng.prefill_chunked(ids[:, :p], chunk_size=8)
    out = [to_np(logits[:, -1])]
    for t in range(p, ids.shape[1]):
        logits, cache = eng.decode(ids[:, t:t + 1], cache)
        out.append(to_np(logits[:, -1]))
    return np.stack(out, axis=1)


def test_int8_rot_engine_matches_jax_and_keeps_nll():
    """int8_rot through the engine against the JAX engine's Pallas path
    (interpret mode, v_byte_dot auto-on there, exact here) per step, and
    the NLL check of tests/test_engine.py: within 0.02 of the exact
    engine's. Tolerance 2e-3 of max|logits|: operand rounding ties
    (tests/test_torch_decode_int8.py)."""
    jparams, jcfg = _lowrank(77)
    ids = np.random.default_rng(77).integers(0, jcfg.vocab_size, (1, 40))
    knobs = dict(use_pallas=True, pallas_interpret=True, kernel_int8_rot=True)
    jeng, teng = _pair(jcfg, jparams, s_max=64, chunk=8, qkw=FLAGSHIP, **knobs)
    want = _stepwise(jeng, ids, np.asarray)
    got = _stepwise(teng, ids, lambda t: t.numpy())
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    assert teng._decode_paths == {"palu_decode_int8_rot-plain"}
    assert teng._kernel_knobs == {"v_byte_dot": True, "int8_rot": True}
    assert teng._pallas_block == 8

    def nll(logits):
        p = ids.shape[1] // 2
        tgt = torch.as_tensor(ids[0, p:])
        lp = torch.log_softmax(torch.as_tensor(logits[0, :len(tgt)]), -1)
        return float(-lp[torch.arange(len(tgt)), tgt].mean())

    _, exact = _pair(jcfg, jparams, s_max=64, chunk=8, qkw=FLAGSHIP)
    assert abs(nll(got) - nll(_stepwise(exact, ids, lambda t: t.numpy()))) < 0.02


def test_int8_rot_serving_matches_sequential_generate():
    """ServingEngine over the packed rank-major cache in int8_rot mode (lane
    insertion of codes_t / scale_t, native scheduler): every request's
    tokens equal batch-1 Engine.generate's."""
    jparams, jcfg = _lowrank(5)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    ecfg = EngineConfig(s_max=64, batch=2, dtype=torch.float32, qcfg=QuantConfig(**FLAGSHIP),
                        decode_chunk=8, device="cpu", pallas_block=16, kernel_int8_rot=True)
    srv = ServingEngine(params, cfg, ecfg, prefer_native=True)
    rng = np.random.default_rng(5)
    prompts = {rid: rng.integers(1, jcfg.vocab_size, (1, n)) for rid, n in
               {0: 9, 1: 14, 2: 5}.items()}
    for rid, p in prompts.items():
        assert srv.submit(rid, p, 6)
    out = srv.run_until_done(max_steps=200)
    seq = Engine(params, cfg, dataclasses.replace(ecfg, batch=1))
    for rid, p in prompts.items():
        assert out[rid] == seq.generate(p, max_new_tokens=6)[0].tolist(), rid
    assert isinstance(srv.sched, NativeScheduler)
    assert srv.engine._decode_paths == {"palu_decode_int8_rot-plain"}
    assert srv.engine._pallas_block == 16


@pytest.mark.parametrize("qkw,knob", [
    (dict(bits=3, sym=True), "kernel_v_byte_dot"),           # exact 3-bit: no nibbles
    (dict(bits=8, sym=True), "kernel_int8_dots"),            # 8-bit codes
    (dict(bits=8, sym=False), "kernel_int8_rot"),
    (None, "kernel_fuse_uv"),                                # unquantized cache
    (None, "kernel_int8_rot"),
])
def test_knob_validation_matches_jax(qkw, knob):
    jparams, jcfg = _lowrank(1)
    for eng, qc, extra in ((JEngine, JQuantConfig, {"dtype": jnp.float32}),
                           (Engine, QuantConfig, {"dtype": torch.float32, "device": "cpu"})):
        ecfg = (JEngineConfig if eng is JEngine else EngineConfig)(
            s_max=32, qcfg=qc(**qkw) if qkw else None, **{knob: True}, **extra)
        params = jparams if eng is JEngine else params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        cfg = jcfg if eng is JEngine else config_from_dict(dataclasses.asdict(jcfg))
        with pytest.raises(ValueError):
            eng(params, cfg, ecfg)


def test_pallas_block_resolves_as_jax():
    jparams, jcfg = _lowrank(2)
    for pb, chunk, want in ((None, 8, 8), (40, 8, 32), (1000, 8, 96), (None, 40, 32)):
        kw = dict(s_max=96, decode_chunk=chunk, pallas_block=pb)
        jeng = JEngine(jparams, jcfg, JEngineConfig(dtype=jnp.float32, **kw))
        teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                      config_from_dict(dataclasses.asdict(jcfg)),
                      EngineConfig(dtype=torch.float32, device="cpu", **kw))
        assert teng._pallas_block == jeng._pallas_block == want


def test_profilers_report_the_jax_keys():
    jparams, jcfg = _lowrank(3)
    _, teng = _pair(jcfg, jparams, s_max=64, chunk=8, qkw=FLAGSHIP)
    rec = profiler.profile_tpot(teng, 20, n_steps=3, warmup=1)
    assert set(rec) == {"tpot_ms", "p20_ms", "p80_ms", "tokens_per_s", "n_steps", "prompt_len"}
    assert rec["tpot_ms"] > 0 and rec["n_steps"] == 3 and rec["prompt_len"] == 20
    rec = profiler.profile_tpot_chained(teng, 20, n_steps=2, k_calls=2, reps=1)
    assert set(rec) == {"tpot_ms", "tokens_per_s", "n_steps", "k_calls", "prompt_len",
                        "compile_s", "t1_s", "tk_s"}
    assert profiler.device_memory_stats() == {}  # no card here
