"""The port's torch-native checkpoints (models/ckpt.py) on the CPU: params
trees at bf16, int8 and int4 weights round-trip bit for bit (structure,
dtypes, None leaves), an engine over the loaded tree gives the same logits,
a model_config.json written by the JAX package's save_native loads into
the port's ModelConfig and equals the one the port writes, `dtype` casts
floating-point tensors only, and the card is the default device (no quiet
CPU fallback)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.models import ModelConfig as JModelConfig, llama as jllama
from palu_tpu.models.ckpt import save_native as jsave_native
from palu_tpu_torch.convert import config_from_dict
from palu_tpu_torch.core import wquant
from palu_tpu_torch.models import ckpt, llama
from palu_tpu_torch.runtime.engine import Engine, EngineConfig


def _jcfg():
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [8, 8]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [16, 16]
    return JModelConfig(vocab_size=64, hidden_size=128, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=ranks, attention_bias=True,
                        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                      "original_max_position_embeddings": 64})


def _params(bits):
    cfg = config_from_dict(dataclasses.asdict(_jcfg()))
    params = llama.init_params(cfg, torch.Generator().manual_seed(bits), dtype=torch.bfloat16)
    if bits in (8, 4):
        params = wquant.quantize_params(params, vt=True, embed=True, bits=bits)
    return params, cfg


def _same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.device.type == "cpu", path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("bits", [16, 8, 4], ids=["bf16", "int8", "int4"])
def test_round_trip_is_bit_identical(bits, tmp_path):
    params, cfg = _params(bits)
    ckpt.save_native(str(tmp_path), params, cfg)
    assert sorted(os.listdir(tmp_path)) == ["model_config.json", "params.pt"]
    got, got_cfg = ckpt.load_native(str(tmp_path), device="cpu")
    assert got_cfg == cfg
    _same_tree(got, params)
    if bits != 16:  # the codes are in the tree as stored
        key = "wq4" if bits == 4 else "wq8"
        assert key in got["layers"][0]["mlp"]["gate"]
    ids = np.random.default_rng(bits).integers(0, cfg.vocab_size, (1, 12))
    logits = []
    for tree in (params, got):
        eng = Engine(tree, cfg, EngineConfig(s_max=32, decode_chunk=8, device="cpu",
                                             dtype=torch.bfloat16))
        lg, cache = eng.prefill_auto(ids)
        lg2, _ = eng.decode(ids[:, :1], cache)
        logits.append(torch.cat([lg, lg2], dim=1))
    assert torch.equal(*logits)


def test_jax_written_config_loads(tmp_path):
    jcfg = _jcfg()
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    jsave_native(str(tmp_path / "jax"), jparams, jcfg)
    params, cfg = _params(16)
    ckpt.save_native(str(tmp_path / "port"), params, cfg)
    with open(tmp_path / "jax" / "model_config.json") as f:
        jax_text = f.read()
    with open(tmp_path / "port" / "model_config.json") as f:
        assert f.read() == jax_text  # written exactly as JAX writes it
    # the JAX package's config beside the port's params loads as the port's
    (tmp_path / "port" / "model_config.json").write_text(jax_text)
    _, got_cfg = ckpt.load_native(str(tmp_path / "port"), device="cpu")
    assert got_cfg == config_from_dict(json.loads(jax_text)) == cfg
    assert got_cfg.head_wise_ranks == jcfg.head_wise_ranks


def test_dtype_casts_floats_only_and_card_is_default(tmp_path):
    params, cfg = _params(8)
    ckpt.save_native(str(tmp_path), params, cfg)
    got, _ = ckpt.load_native(str(tmp_path), device="cpu", dtype=torch.float32)
    gate = got["layers"][0]["mlp"]["gate"]
    assert gate["wq8"].dtype == torch.int8 and torch.equal(
        gate["wq8"], params["layers"][0]["mlp"]["gate"]["wq8"])
    assert gate["ws"].dtype == torch.float32
    assert got["final_norm"].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.load_native(str(tmp_path))
