"""The port's Engine over the unquantized latent caches (qcfg None;
seq-major, and rank-major with rank_major_fp) on the CPU against the JAX
Engine(use_pallas=False) in f32 on a 2-layer low-rank model: per-step
logits within 1e-4 of max|logits|, identical greedy tokens, the cache
buffers equal up to f32 summation order, the serving loop's one-chunk
prefill, and sampled generation equal to JAX's given JAX's Gumbel noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu.runtime.sampling import SamplingParams as JSamplingParams
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.runtime import sampling
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from test_torch_sampling import jax_noise

S_MAX, CHUNK, PROMPT, STEPS, VOCAB = 64, 16, 21, 6, 96


def _config(window=None):
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [8, 8]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [16, 16]
    return JModelConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=8,
                        num_key_value_heads=4, head_group_size=2,
                        head_wise_ranks=ranks, sliding_window=window)


def _engines(rank_major, window=None):
    jcfg = _config(window)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.2)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, dtype=jnp.float32, qcfg=None, decode_chunk=CHUNK, use_pallas=False,
        rank_major_fp=rank_major))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    teng = Engine(params, config_from_dict(dataclasses.asdict(jcfg)), EngineConfig(
        s_max=S_MAX, dtype=torch.float32, qcfg=None, decode_chunk=CHUNK, device="cpu",
        rank_major_fp=rank_major))
    return jeng, teng


def _stepwise(eng, ids, forced, to_np):
    logits, cache = eng.prefill_chunked(ids, chunk_size=CHUNK)
    out = [to_np(logits)]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int32), cache)
        out.append(to_np(logits))
    return np.concatenate(out, axis=1), cache


def _assert_logits_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("rank_major,window", [(False, None), (True, None), (False, 12)],
                         ids=["seq_major", "rank_major", "seq_major_window"])
def test_engine_fp_matches_jax(rank_major, window):
    jeng, teng = _engines(rank_major, window)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, (1, PROMPT))
    forced = rng.integers(0, VOCAB, STEPS)
    want, jcache = _stepwise(jeng, ids, forced, np.asarray)
    got, tcache = _stepwise(teng, ids, forced, lambda t: t.numpy())
    assert got.shape == (1, STEPS + 1, VOCAB)
    _assert_logits_close(got, want)
    name = "palu_decode_fp_t" if rank_major else "palu_decode_fp"
    assert teng._decode_paths == {f"{name}-plain"}
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    key = "lat_t" if rank_major else "lat"
    for tl, jl in zip(tcache["layers"], jcache["layers"]):
        for side in ("k", "v"):
            assert list(tl[side]) == list(jl[side]) == [key]
            # the latents are h @ VT from XLA's and PyTorch's f32 matmuls,
            # which sum in different orders, and from the layer below's
            # output (logits agree to 1e-4 of their max): a latent near 0
            # can differ by ~1e-6 of the buffer's largest, hence the atol
            want_lat = np.asarray(jl[side][key])
            np.testing.assert_allclose(tl[side][key].numpy(), want_lat, rtol=1e-5,
                                       atol=1e-5 * np.abs(want_lat).max(),
                                       err_msg=f"{side}/{key}")


@pytest.mark.parametrize("rank_major", [False, True], ids=["seq_major", "rank_major"])
def test_generate_and_prefill_chunk_match_jax(rank_major):
    jeng, teng = _engines(rank_major)
    ids = np.random.default_rng(2).integers(0, VOCAB, (1, PROMPT))
    np.testing.assert_array_equal(teng.generate(ids, max_new_tokens=8),
                                  np.asarray(jeng.generate(ids, max_new_tokens=8)))
    # the serving loop's chunks: two of them, the second padded
    padded = np.zeros((1, 2 * CHUNK), np.int64)
    padded[:, :PROMPT] = ids
    jcache, tcache = jeng.init_cache(), teng.init_cache()
    for off in (0, CHUNK):
        chunk = padded[:, off:off + CHUNK]
        jlog, jcache = jeng.prefill_chunk(chunk, jcache, off)
        tlog, tcache = teng.prefill_chunk(chunk, tcache, off)
        _assert_logits_close(tlog.numpy(), np.asarray(jlog))
        assert int(tcache["length"][0]) == int(jcache["length"][0]) == off + CHUNK


def test_sampled_generate_matches_jax(monkeypatch):
    jeng, teng = _engines(False)
    monkeypatch.setattr(sampling, "gumbel_noise", jax_noise)
    ids = np.random.default_rng(3).integers(0, VOCAB, (1, PROMPT))
    for kw in (dict(temperature=1.0, top_k=8), dict(temperature=0.7, top_p=0.9)):
        want = jeng.generate(ids, max_new_tokens=8, sampling=JSamplingParams(**kw), seed=5)
        got = teng.generate(ids, max_new_tokens=8, sampling=sampling.SamplingParams(**kw),
                            seed=5)
        np.testing.assert_array_equal(got, np.asarray(want))
