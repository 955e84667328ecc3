"""The port's Engine with int4/int8 weights on the CPU (plain GEMV versions)
against the JAX Engine(use_pallas=False) in f32 on a 2-layer low-rank model
at widths where the GEMV dispatch applies (hidden 256, intermediate 512,
G * rk = 128, nh * rv = 512, vocab 256): per-step logits within 1e-4 of
max|logits|, identical greedy tokens, identical cache codes; and a tree
quantized by the JAX package and carried across gives the same logits as
the port quantizing the float tree itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import wquant as jw
from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime.engine import Engine, EngineConfig

S_MAX, CHUNK, PROMPT, STEPS, VOCAB = 64, 16, 21, 5, 256
QKW = dict(bits=3, group_size=0, sym=True, container=4)
W4 = dict(weight_bits=4, vt_bits=8, embed_bits=8)   # the README's configuration
W8 = dict(weight_bits=8)


def _config():
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [64, 64]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [128, 128]
    return JModelConfig(vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=ranks)


def _engines(wkw):
    jcfg = _config()
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.1)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, dtype=jnp.float32, qcfg=JQuantConfig(**QKW), decode_chunk=CHUNK,
        use_pallas=False, **wkw))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    teng = Engine(params, tcfg, EngineConfig(
        s_max=S_MAX, dtype=torch.float32, qcfg=QuantConfig(**QKW), decode_chunk=CHUNK,
        device="cpu", **wkw))
    return jeng, teng, jparams, tcfg


def _stepwise(eng, ids, forced, to_np):
    logits, cache = eng.prefill_chunked(ids, chunk_size=CHUNK)
    out = [to_np(logits)]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int32), cache)
        out.append(to_np(logits))
    return np.concatenate(out, axis=1), cache


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (1, PROMPT)), rng.integers(0, VOCAB, STEPS)


@pytest.mark.parametrize("wkw", [W4, W8], ids=["w4_vt8_embed8", "w8"])
def test_engine_matches_jax(wkw):
    jeng, teng, _, _ = _engines(wkw)
    ids, forced = _inputs(1)
    want, jcache = _stepwise(jeng, ids, forced, np.asarray)
    got, tcache = _stepwise(teng, ids, forced, lambda t: t.numpy())
    assert got.shape == want.shape == (1, STEPS + 1, VOCAB)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    kind = "int4" if wkw["weight_bits"] == 4 else "int8"
    want_paths = {f"gemv_{kind}-plain", f"mlp_gemv_{kind}-plain"}
    if wkw is W4:
        want_paths.add("gemv_int8-plain")  # the int8 VT projections
    else:
        want_paths.add("dense-matmul")  # VT stays in the engine dtype
    assert teng._gemv_paths == want_paths
    for tl, jl in zip(tcache["layers"], jcache["layers"]):
        for side in ("k", "v"):
            np.testing.assert_array_equal(tl[side]["codes_t"].numpy(),
                                          np.asarray(jl[side]["codes_t"]), err_msg=side)


def test_generate_tokens_match_jax():
    jeng, teng, _, _ = _engines(W4)
    ids, _ = _inputs(2)
    want = jeng.generate(ids, max_new_tokens=8)
    got = teng.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_jax_quantized_tree_carries_across():
    _, teng, jparams, tcfg = _engines(W4)
    jq = jw.quantize_params(jparams, vt=True, embed=True, bits=4)
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    eng = Engine(carried, tcfg, teng.ecfg)
    ids, forced = _inputs(3)
    want, _ = _stepwise(teng, ids, forced, lambda t: t.numpy())
    got, _ = _stepwise(eng, ids, forced, lambda t: t.numpy())
    np.testing.assert_array_equal(got, want)
    assert eng.params["layers"][0]["mlp"]["gate"]["wq4"].dtype == torch.uint8
