"""The port's continuous-batching ServingEngine and schedulers on the CPU:
the native and Python schedulers against JAX's PyScheduler on the event
log of tests/test_serving.py, served tokens against sequential
Engine.generate (exact, f32) on both unquantized layouts and a quantized
cache, chunked-prefill interleaving against prefill at admission, sampled
requests independent of the batch, tokens equal to JAX's ServingEngine
(greedy, and sampled given JAX's Gumbel noise), and no quiet fallback when
the native scheduler cannot be built."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import EngineConfig as JEngineConfig
from palu_tpu.runtime.sampling import SamplingParams as JSamplingParams
from palu_tpu.runtime.serving import PyScheduler as JPyScheduler
from palu_tpu.runtime.serving import ServingEngine as JServingEngine
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime import sampling, serving
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from palu_tpu_torch.runtime.sampling import SamplingParams
from palu_tpu_torch.runtime.serving import NativeScheduler, PyScheduler, ServingEngine
from test_serving import _sched_scenario
from test_torch_sampling import jax_noise

S_MAX, CHUNK, VOCAB = 32, 8, 64


@pytest.fixture(scope="module")
def model():
    """A 2-layer low-rank model in both packages: (jax params, jax cfg,
    torch params, torch cfg)."""
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [8, 8]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [16, 16]
    jcfg = JModelConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=ranks)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, params, config_from_dict(dataclasses.asdict(jcfg))


def _ecfg(batch=2, **kw):
    return EngineConfig(s_max=S_MAX, batch=batch, dtype=torch.float32, decode_chunk=CHUNK,
                        device="cpu", **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(1, VOCAB, (1, n)) for rid, n in lens.items()}


def _serve(model, prompts, n_new, sampled=(), prefer_native=False, chunks=None, **kw):
    _, _, params, cfg = model
    srv = ServingEngine(params, cfg, _ecfg(**kw), prefer_native=prefer_native,
                        prefill_chunks_per_step=chunks, sampling_seed=7)
    for rid, p in prompts.items():
        sp = SamplingParams(temperature=1.0, top_k=8) if rid in sampled else None
        assert srv.submit(rid, p, n_new[rid], sampling=sp)
    return srv, srv.run_until_done(max_steps=300)


def test_schedulers_match_jax_python_scheduler():
    want = _sched_scenario(JPyScheduler(2, 64))
    assert _sched_scenario(PyScheduler(2, 64)) == want
    assert _sched_scenario(NativeScheduler(2, 64)) == want


# prompts 10 and 11 fill both lanes; 12 waits for a free one
PROMPTS = {10: 6, 11: 9, 12: 4}
N_NEW = {10: 5, 11: 3, 12: 6}


@pytest.mark.parametrize("kw,prefer_native", [
    (dict(qcfg=None), True),
    (dict(qcfg=None, rank_major_fp=True), False),
    (dict(qcfg=QuantConfig(bits=3)), False),  # the README's cache: lane insertion of codes
], ids=["fp_seq_major_native", "fp_rank_major", "quantized_3bit"])
def test_serving_matches_sequential_generate(model, kw, prefer_native):
    prompts = _prompts(0, PROMPTS)
    srv, out = _serve(model, prompts, N_NEW, prefer_native=prefer_native, **kw)
    assert isinstance(srv.sched, NativeScheduler if prefer_native else PyScheduler)
    seq = Engine(model[2], model[3], _ecfg(batch=1, **kw))
    for rid, p in prompts.items():
        assert out[rid] == seq.generate(p, max_new_tokens=N_NEW[rid])[0].tolist(), rid
    stats = srv.sched.stats()
    assert stats["finished"] == len(prompts) and stats["tokens"] == sum(N_NEW.values())


@pytest.mark.parametrize("chunks", [1, 2])
def test_chunked_prefill_interleave_matches_default(model, chunks):
    prompts = _prompts(1, {20: 17, 21: 5, 22: 9})  # 20: three chunks of 8
    n_new = {20: 4, 21: 6, 22: 3}
    assert _serve(model, prompts, n_new)[1] == _serve(model, prompts, n_new, chunks=chunks)[1]


def test_sampled_request_independent_of_batch(model):
    prompts = _prompts(3, {20: 6, 21: 5})
    n_new = {20: 6, 21: 6, 22: 3}
    _, a = _serve(model, prompts, n_new, sampled=(20,))
    more = {**prompts, **_prompts(4, {22: 4})}
    _, b = _serve(model, more, n_new, sampled=(20,), chunks=1)
    assert a[20] == b[20] and a[21] == b[21]
    seq = Engine(model[2], model[3], _ecfg(batch=1))
    assert a[21] == seq.generate(prompts[21], max_new_tokens=6)[0].tolist()


@pytest.mark.parametrize("chunks", [None, 1])
def test_serving_matches_jax_serving_engine(model, monkeypatch, chunks):
    """Greedy requests, and a sampled one given JAX's noise, through both
    packages' ServingEngine."""
    jparams, jcfg = model[:2]
    prompts = _prompts(5, {30: 11, 31: 7, 32: 4})
    n_new = {30: 5, 31: 4, 32: 6}
    jsrv = JServingEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, batch=2, dtype=jnp.float32, decode_chunk=CHUNK),
        prefer_native=False, prefill_chunks_per_step=chunks, sampling_seed=7)
    for rid, p in prompts.items():
        sp = JSamplingParams(temperature=1.0, top_k=8) if rid == 31 else None
        assert jsrv.submit(rid, p, n_new[rid], sampling=sp)
    want = jsrv.run_until_done(max_steps=300)
    monkeypatch.setattr(sampling, "gumbel_noise", jax_noise)
    _, got = _serve(model, prompts, n_new, sampled=(31,), chunks=chunks)
    assert got == want


def test_quantized_serving_matches_jax(model):
    jparams, jcfg = model[:2]
    prompts = _prompts(6, {40: 9, 41: 5, 42: 12})
    n_new = {40: 4, 41: 5, 42: 3}
    jsrv = JServingEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, batch=2, dtype=jnp.float32, decode_chunk=CHUNK,
        qcfg=JQuantConfig(bits=3, group_size=0, sym=True, container=4)), prefer_native=False)
    for rid, p in prompts.items():
        assert jsrv.submit(rid, p, n_new[rid])
    want = jsrv.run_until_done(max_steps=300)
    _, got = _serve(model, prompts, n_new,
                    qcfg=QuantConfig(bits=3, group_size=0, sym=True, container=4))
    assert got == want


def test_native_build_failure_raises(model, monkeypatch, tmp_path):
    shutil.copy(serving._NATIVE_DIR / "Makefile", tmp_path / "Makefile")
    (tmp_path / "scheduler.cc").write_text("this is not C++\n")
    monkeypatch.setattr(serving, "_NATIVE_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="make"):
        ServingEngine(model[2], model[3], _ecfg(), prefer_native=True)
    assert isinstance(serving.load_scheduler(2, S_MAX, prefer_native=False), PyScheduler)
