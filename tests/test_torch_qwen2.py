"""Qwen2 (attention_bias: q/k/v biases) in the port, on the CPU, against the
JAX package in f32, on a 2-layer model of Qwen2-7B's head layout at small
width: 28 q-heads over 4 kv-heads (GQA, rep 7), Palu head groups of 4, so
one group (G 1) of 28 q-heads, head_dim 32, ranks 32, nonzero biases drawn
as 0.3 N(0, 1) from a numpy seed (init_params makes zero biases, which
would hide a missing fold).

  - the forward's logits within 1e-5 of max|logits|;
  - the Engine against JAX's Engine(use_pallas=False) over the 3-bit cache
    (sym and asym) and the two bf16-latent layouts: per-step logits within
    1e-4 of max|logits|, identical greedy tokens, identical cache codes
    (the f32 scales may differ in their last bits: the latents come from
    XLA's and PyTorch's f32 matmuls, test_torch_engine.py);
  - derived k_bias equal to JAX's and o_bias_corr within 1e-6 of max|corr|
    (f32 matmuls in another order) under weight_bits 16 / 8 / 4;
  - an engine rebuilt from the quantized params equal to the first (what the
    ServingEngine's prefill engine is);
  - ServingEngine on PyScheduler giving Engine.generate's tokens;
  - an hf_io round trip of a `paluqwen2` checkpoint."""

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
from palu_tpu_torch.models import hf_io, llama
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from palu_tpu_torch.runtime.serving import PyScheduler, ServingEngine

S_MAX, CHUNK, PROMPT, STEPS, VOCAB = 64, 16, 21, 6, 96
NH, NKV, HD, RANK = 28, 4, 32, 32


def qwen2_config(rope_scaling=None, rank=RANK, layers=2) -> JModelConfig:
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [rank]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [rank]
    return JModelConfig(vocab_size=VOCAB, hidden_size=NH * HD, intermediate_size=128,
                        num_hidden_layers=layers, num_attention_heads=NH,
                        num_key_value_heads=NKV, head_group_size=4, head_wise_ranks=ranks,
                        rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=True,
                        model_family="qwen2", rope_scaling=rope_scaling)


def qwen2_params(jcfg: JModelConfig, seed: int = 0):
    """JAX f32 params (weights 0.05 N(0, 1): at hidden 896 a larger scale
    grows the activations layer by layer until f32 summation order alone
    moves the logits past 1e-5) with 0.3 N(0, 1) q / k / v biases from a
    numpy seed."""
    params = jllama.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32, scale=0.05)
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for which in ("q_proj", "k_proj", "v_proj"):
            p = layer["attn"][which]
            p["b"] = jnp.asarray(rng.standard_normal(p["b"].shape) * 0.3, jnp.float32)
    return params


def engine_pair(jcfg, jparams, qkw=None, **ekw):
    """JAX's Engine(use_pallas=False) and the port's CPU Engine in f32 on the
    same params; qkw the QuantConfig fields (None: unquantized latents)."""
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, dtype=jnp.float32, qcfg=qkw and JQuantConfig(**qkw),
        decode_chunk=CHUNK, use_pallas=False, **ekw))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    teng = Engine(params, config_from_dict(dataclasses.asdict(jcfg)), EngineConfig(
        s_max=S_MAX, dtype=torch.float32, qcfg=qkw and QuantConfig(**qkw), decode_chunk=CHUNK,
        device="cpu", **ekw))
    return jeng, teng


def stepwise(eng, ids, forced, to_np):
    logits, cache = eng.prefill_chunked(ids, chunk_size=CHUNK)
    out = [to_np(logits)]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int32), cache)
        out.append(to_np(logits))
    return np.concatenate(out, axis=1), cache


def assert_engines_agree(jeng, teng, seed=1):
    """Per-step logits within 1e-4 of max|logits|, equal greedy tokens and
    equal cache codes (scales and latents within 1e-5 of their max: f32
    summation order)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (1, PROMPT))
    forced = rng.integers(0, VOCAB, STEPS)
    want, jcache = stepwise(jeng, ids, forced, np.asarray)
    got, tcache = stepwise(teng, ids, forced, lambda t: t.numpy())
    assert got.shape == want.shape == (1, STEPS + 1, VOCAB)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for tl, jl in zip(tcache["layers"], jcache["layers"]):
        for side in ("k", "v"):
            for key, jbuf in jl[side].items():
                tbuf, jbuf = tl[side][key].numpy(), np.asarray(jbuf)
                if key == "codes_t":
                    np.testing.assert_array_equal(tbuf, jbuf, err_msg=f"{side}/{key}")
                else:  # sums of 896 f32 products in another order
                    assert np.abs(tbuf - jbuf).max() <= 1e-5 * np.abs(jbuf).max(), (side, key)
    np.testing.assert_array_equal(
        teng.generate(ids, max_new_tokens=4), np.asarray(jeng.generate(ids, max_new_tokens=4)))


@pytest.fixture(scope="module")
def model():
    jcfg = qwen2_config()
    return jcfg, qwen2_params(jcfg)


def test_qwen2_forward_matches_jax(model):
    jcfg, jparams = model
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 19))
    want = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    with torch.no_grad():
        got = llama.forward(params, torch.as_tensor(ids), cfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


CACHES = {
    "3bit_sym": (dict(bits=3, group_size=0, sym=True, container=4), {}),
    "3bit_asym": (dict(bits=3, group_size=0, sym=False), {}),
    "lat": (None, {}),
    "lat_t": (None, {"rank_major_fp": True}),
}


@pytest.mark.parametrize("cache", list(CACHES))
def test_qwen2_engine_matches_jax(model, cache):
    qkw, ekw = CACHES[cache]
    jeng, teng = engine_pair(*model, qkw, **ekw)
    assert_engines_agree(jeng, teng)
    # every latent decode takes B and the k bias per kv-head (the compact
    # form: the group's 4 kv-heads), where JAX keeps one per q-head
    assert teng.derived[0]["k_bias"].shape == (1, NKV, HD)
    assert teng.derived[0]["b_k"].shape == (1, NKV, RANK, HD)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_qwen2_derived_matches_jax(model, bits):
    wkw = {} if bits == 16 else dict(weight_bits=bits)
    jeng, teng = engine_pair(*model, dict(bits=3, group_size=0, sym=True, container=4), **wkw)
    for jd, td in zip(jeng.derived, teng.derived):
        # over the packed cache the k bias is kept per kv-head: JAX's rows of
        # the first q-head of each kv-head (JAX repeats each one rep times)
        np.testing.assert_array_equal(td["k_bias"].numpy(),
                                      np.asarray(jd["k_bias"])[:, ::NH // NKV])
        want = np.asarray(jd["o_bias_corr"])
        got = td["o_bias_corr"].numpy()
        assert got.shape == want.shape == (NH * HD,)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if bits != 16:  # from the dequantized o_proj codes, not the float weight
        _, float_o = engine_pair(*model, dict(bits=3, group_size=0, sym=True, container=4))
        assert not torch.equal(teng.derived[0]["o_bias_corr"],
                               float_o.derived[0]["o_bias_corr"])


@pytest.mark.parametrize("bits", [8, 4])
def test_qwen2_rebuilt_engine_equals_first(model, bits):
    jcfg, jparams = model
    _, first = engine_pair(jcfg, jparams, dict(bits=3, group_size=0, sym=True, container=4),
                           weight_bits=bits)
    rebuilt = Engine(first.params, first.cfg, first.ecfg)
    for a, b in zip(first.derived, rebuilt.derived):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    rng = np.random.default_rng(4)
    ids, forced = rng.integers(0, VOCAB, (1, PROMPT)), rng.integers(0, VOCAB, STEPS)
    la = stepwise(first, ids, forced, lambda t: t.numpy())[0]
    lb = stepwise(rebuilt, ids, forced, lambda t: t.numpy())[0]
    np.testing.assert_array_equal(la, lb)


def test_qwen2_serving_matches_generate(model):
    jcfg, jparams = model
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    ecfg = EngineConfig(s_max=S_MAX, batch=2, dtype=torch.float32, decode_chunk=CHUNK,
                        device="cpu", qcfg=QuantConfig(bits=3, group_size=0, sym=True,
                                                       container=4), weight_bits=8)
    srv = ServingEngine(params, cfg, ecfg, prefer_native=False, prefill_chunks_per_step=1)
    assert isinstance(srv.sched, PyScheduler)
    rng = np.random.default_rng(5)
    prompts = {rid: rng.integers(1, VOCAB, (1, n)) for rid, n in enumerate((9, 30, 17))}
    for rid, p in prompts.items():
        assert srv.submit(rid, p, 5)
    out = srv.run_until_done(max_steps=200)
    # the prefill engine rebuilt o_bias_corr from the quantized params
    assert torch.equal(srv.prefill_engine.derived[1]["o_bias_corr"],
                       srv.engine.derived[1]["o_bias_corr"])
    seq = Engine(params, cfg, dataclasses.replace(ecfg, batch=1))
    for rid, p in prompts.items():
        assert out[rid] == seq.generate(p, max_new_tokens=5)[0].tolist(), rid


def test_qwen2_hf_io_round_trip(model, tmp_path):
    jcfg, jparams = model
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    hf_io.save_checkpoint(params, cfg, str(tmp_path), dtype=torch.float32)
    back, bcfg = hf_io.load_params(str(tmp_path), dtype=torch.float32, device="cpu")
    assert bcfg.model_family == "qwen2" and bcfg.attention_bias
    assert bcfg.head_wise_ranks == cfg.head_wise_ranks
    import json
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["model_type"] == "paluqwen2"
    for i, (a, b) in enumerate(zip(params["layers"], back["layers"])):
        for which in ("q_proj", "k_proj", "v_proj"):
            torch.testing.assert_close(b["attn"][which]["b"], a["attn"][which]["b"],
                                       rtol=0, atol=0, msg=f"layer {i} {which}")
    ids = torch.as_tensor(np.random.default_rng(6).integers(0, VOCAB, (1, 11)))
    with torch.no_grad():
        torch.testing.assert_close(llama.forward(back, ids, bcfg), llama.forward(params, ids, cfg),
                                   rtol=1e-5, atol=1e-5)


def test_qwen2_config_from_hf_fields():
    """The published Qwen2-7B config.json fields read by hf_io's config
    reader (the configuration chip_smoke.py builds at full width)."""
    raw = {"model_type": "qwen2", "hidden_size": 3584, "intermediate_size": 18944,
           "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
           "vocab_size": 152064, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
           "tie_word_embeddings": False, "use_sliding_window": False,
           "sliding_window": 131072, "max_position_embeddings": 131072}
    cfg = hf_io.config_from_hf(raw, head_group_size=4)
    assert (cfg.model_family, cfg.attention_bias, cfg.head_dim, cfg.num_kv_groups,
            cfg.group_dim, cfg.sliding_window) == ("qwen2", True, 128, 1, 512, None)
