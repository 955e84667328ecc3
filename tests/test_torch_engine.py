"""The port's Engine on the CPU (plain versions of the kernels) against the
JAX Engine(use_pallas=False) in f32 on a 2-layer low-rank model: per-step
logits within 1e-4 of max|logits|, identical greedy tokens, identical cache
codes after prefill + decode, and f32 scales equal up to the last bits the
two frameworks' projections round differently (see test_engine_matches_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime.engine import Engine, EngineConfig

S_MAX, CHUNK, PROMPT, STEPS = 64, 16, 21, 6


def _config(window=None, rk=8, rv=16):
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [rk, rk]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [rv, rv]
    return JModelConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=8,
                        num_key_value_heads=4, head_group_size=2,
                        head_wise_ranks=ranks, sliding_window=window)


def _engines(qkw, window=None, rk=8, rv=16):
    jcfg = _config(window, rk, rv)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.2)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, dtype=jnp.float32, qcfg=JQuantConfig(**qkw), decode_chunk=CHUNK,
        use_pallas=False))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    teng = Engine(params, config_from_dict(dataclasses.asdict(jcfg)), EngineConfig(
        s_max=S_MAX, dtype=torch.float32, qcfg=QuantConfig(**qkw), decode_chunk=CHUNK,
        device="cpu"))
    return jeng, teng


def _stepwise(eng, ids, forced, to_np):
    logits, cache = eng.prefill_chunked(ids, chunk_size=CHUNK)
    out = [to_np(logits)]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int32), cache)
        out.append(to_np(logits))
    return np.concatenate(out, axis=1), cache


QUANTS = [dict(bits=3, group_size=0, sym=True, container=4),  # flagship: kernel append
          dict(bits=3, group_size=0, sym=True),               # exact 3-bit: plain append
          dict(bits=4, group_size=0, sym=False)]              # asymmetric


@pytest.mark.parametrize("qkw,window", [(q, None) for q in QUANTS] + [(QUANTS[0], 12)])
def test_engine_matches_jax(qkw, window):
    jeng, teng = _engines(qkw, window)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 96, (1, PROMPT))
    forced = rng.integers(0, 96, STEPS)
    want, jcache = _stepwise(jeng, ids, forced, np.asarray)
    got, tcache = _stepwise(teng, ids, forced, lambda t: t.numpy())
    assert got.shape == want.shape == (1, STEPS + 1, 96)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert teng._decode_paths == {"palu_decode-plain"}
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    # Codes must be identical. The f32 scales/zeros may differ in their last
    # bits (0 to a few ulps here): the latents are h @ VT from XLA's and
    # PyTorch's f32 matmuls, which sum in different orders. Given the same
    # latents the port's quantize/pack/append is bit-exact (test_torch_quant,
    # test_torch_cache_append).
    for tl, jl in zip(tcache["layers"], jcache["layers"]):
        for side in ("k", "v"):
            for key, jbuf in jl[side].items():
                tbuf, jbuf = tl[side][key].numpy(), np.asarray(jbuf)
                if key == "codes_t":
                    np.testing.assert_array_equal(tbuf, jbuf, err_msg=f"{side}/{key}")
                else:
                    np.testing.assert_allclose(tbuf, jbuf, rtol=1e-5, atol=1e-6,
                                               err_msg=f"{side}/{key}")


def test_generate_tokens_match_jax():
    jeng, teng = _engines(QUANTS[0])
    ids = np.random.default_rng(2).integers(0, 96, (1, PROMPT))
    want = jeng.generate(ids, max_new_tokens=8)
    got = teng.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_chunk_divides_s_max():
    _, teng = _engines(QUANTS[0])
    assert S_MAX % teng._chunk == 0
    with pytest.raises(ValueError):
        teng.prefill_chunked(np.zeros((1, 10), np.int64), chunk_size=24)
    odd = Engine(teng.params, teng.cfg, dataclasses.replace(teng.ecfg, decode_chunk=24))
    assert odd._chunk == 16  # largest divisor of 64 not above 24


@pytest.mark.parametrize("qkw", [QUANTS[0], QUANTS[2]], ids=["flagship", "asym4"])
def test_engine_matches_jax_at_group_ranks_256_384(qkw):
    """Group ranks 256 (K) and 384 (V), beyond the 128 that the decode
    kernels took before they ran ranks in chunks: the engine's shapes at a
    compressed 7B model's ranks against the JAX engine (the plain decode
    has no rank limit; tests/test_torch_kernels_cuda.py holds the kernels
    there)."""
    jeng, teng = _engines(qkw, rk=256, rv=384)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 96, (1, PROMPT))
    forced = rng.integers(0, 96, STEPS)
    want, _ = _stepwise(jeng, ids, forced, np.asarray)
    got, tcache = _stepwise(teng, ids, forced, lambda t: t.numpy())
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # per kv-head over the packed cache (palu_decode's compact form): 2 groups
    # of 2 kv-heads, where JAX keeps (2, 4, 256, 8), one per q-head
    assert teng.derived[0]["b_k"].shape == (2, 2, 256, 8)
    assert teng._decode_paths == {"palu_decode-plain"}
