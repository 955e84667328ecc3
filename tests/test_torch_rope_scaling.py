"""Scaled RoPE (HF rope_scaling: llama3, linear, yarn) in the port's Engine
on the CPU against JAX's Engine(use_pallas=False) in f32, over the 3-bit
packed cache and the two bf16-latent layouts (lat, lat_t), on a 2-layer
low-rank Llama model whose original context (16 positions) the 64-position
cache outgrows: per-step logits within 1e-4 of max|logits|, identical
greedy tokens and cache codes. The decode kernels get the same inv_freq /
rope_scale as f32 tables (tests/test_torch_kernels_cuda.py holds them on
the card)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from palu_tpu.models import llama as jllama
from test_torch_engine import _config as llama_config
from test_torch_qwen2 import assert_engines_agree, engine_pair

SCALINGS = {
    "llama3": {"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
    "linear": {"rope_type": "linear", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16},
}
CACHES = {
    "3bit": (dict(bits=3, group_size=0, sym=True, container=4), {}),
    "lat": (None, {}),
    "lat_t": (None, {"rank_major_fp": True}),
}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_engine_with_rope_scaling_matches_jax(scaling, cache):
    jcfg = dataclasses.replace(llama_config(), rope_scaling=SCALINGS[scaling])
    jparams = jllama.init_params(jcfg, jax.random.key(2), dtype=jnp.float32, scale=0.2)
    qkw, ekw = CACHES[cache]
    jeng, teng = engine_pair(jcfg, jparams, qkw, **ekw)
    assert teng._inv_freq is not None
    assert (teng._rope_scale != 1.0) == (scaling == "yarn")
    assert_engines_agree(jeng, teng, seed=3)
