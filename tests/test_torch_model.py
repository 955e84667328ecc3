"""palu_tpu_torch.models.llama.forward against palu_tpu.models.llama.forward
in f32 on the same parameters (carried across by params_from_numpy):
logits within 1e-5 of max|logits|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.models import llama as tllama
from palu_tpu_torch.models.config import ModelConfig


def small_config(nh=4, nkv=4, layers=2, rk=8, rv=12, gs=2, **kw):
    g = nkv // gs
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [rk] * g
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [rv] * g
    return JModelConfig(vocab_size=64, hidden_size=nh * 16, intermediate_size=96,
                        num_hidden_layers=layers, num_attention_heads=nh,
                        num_key_value_heads=nkv, head_group_size=gs,
                        head_wise_ranks=ranks, **kw)


def jax_model(cfg, seed=0):
    params = jllama.init_params(cfg, jax.random.key(seed), dtype=jnp.float32, scale=0.1)
    return params, jax.tree.map(np.asarray, params)


def test_config_from_dict_round_trips():
    jcfg = small_config(nh=8, nkv=4, sliding_window=16)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(cfg, ModelConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_kv_groups == jcfg.num_kv_groups and cfg.group_dim == jcfg.group_dim


@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 4)])
@pytest.mark.parametrize("value_mode", ["reconstruct", "fused"])
def test_forward_matches_jax(nh, nkv, value_mode):
    jcfg = small_config(nh=nh, nkv=nkv)
    jparams, np_params = jax_model(jcfg, seed=nh)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jcfg, value_mode=value_mode))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(np_params, device="cpu")
    got = tllama.forward(params, torch.from_numpy(ids), cfg, value_mode=value_mode).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fuse_o_proj_and_init_shapes_match_jax():
    jcfg = small_config(nh=8, nkv=4)
    _, np_params = jax_model(jcfg, seed=1)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    attn = np_params["layers"][0]["attn"]
    want = np.asarray(jllama.fuse_o_proj(attn["o_proj"]["w"], attn["v_proj"]["U"], jcfg))
    got = tllama.fuse_o_proj(torch.from_numpy(attn["o_proj"]["w"]),
                             torch.from_numpy(attn["v_proj"]["U"]), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    tparams = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(tparams) == _shapes(np_params)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)
