"""The one-shot and bucketed prefill of the port (dense-KV baseline, mixed
dense / low-rank models, layers with one dense side) on the CPU against the
JAX package's Engine(use_pallas=False), f32:

  - ops/attention.mha_prefill against JAX's with a query offset, a sliding
    window and GQA (1e-5 of max|ref|);
  - the dense engine's and a mixed engine's logits after `prefill` and at
    every decode step (1e-5 of max|logits|), their caches after prefill:
    the low-rank sides' quantized codes byte-identical, the f32 leaves
    (scales, the dense sides' roped K / raw V) within 1e-5 of the leaf's
    max (they are h @ W from XLA's and PyTorch's matmuls, which sum in
    different orders: their bytes cannot match);
  - prefill_bucketed at a right-padded length, and prefill with a
    per-lane real_len, against JAX's;
  - prefill_auto's choice: the chunked stream for all-low-rank engines
    (and the stacked one), the bucketed one-shot prefill otherwise, and
    the chunked prefill refusing dense layers, as JAX's does;
  - generate and the ServingEngine on a dense model against JAX's;
  - a layer with one dense side: JAX's decode fails (its decode attention
    reads both sides' U), the port prefills such a model as JAX does and
    its decode raises a ValueError."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import ModelConfig as JModelConfig, llama as jllama
from palu_tpu.ops.attention import mha_prefill as jmha_prefill
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu.runtime.serving import ServingEngine as JServingEngine
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.attention import mha_prefill
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from palu_tpu_torch.runtime.serving import ServingEngine

FLAGSHIP = dict(bits=3, group_size=0, sym=True, container=4)
TOL = 1e-5  # of max|logits|: f32 against f32, summation order apart
S_MAX, CHUNK, VOCAB = 96, 32, 96


def _cfg(lowrank=(), one_side=None, layers=2):
    """2 layers at hidden 64, 8 q-heads over 4 kv-heads (GQA), groups of 2
    kv-heads: `lowrank` lists the layers whose k and v are low-rank (k rank
    8, v rank 16 a group); `one_side` ("k_proj" / "v_proj") makes only
    that side of those layers low-rank."""
    hwr = {}
    for i in lowrank:
        for which, r in (("k_proj", 8), ("v_proj", 16)):
            if one_side in (None, which):
                hwr[f"model.layers.{i}.self_attn.{which}"] = [r] * 2
    return JModelConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=hwr or None)


def _pair(jcfg, seed, qkw=None, batch=1, **knobs):
    """The JAX engine (XLA paths) and the port's on the CPU, f32, same weights."""
    jparams = jllama.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32, scale=0.2)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=S_MAX, batch=batch, dtype=jnp.float32, decode_chunk=CHUNK,
        qcfg=JQuantConfig(**qkw) if qkw else None))
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                  config_from_dict(dataclasses.asdict(jcfg)),
                  EngineConfig(s_max=S_MAX, batch=batch, dtype=torch.float32,
                               decode_chunk=CHUNK, device="cpu",
                               qcfg=QuantConfig(**qkw) if qkw else None, **knobs))
    return jeng, teng, jparams


def _close(got, want, what=""):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())


def _leaves(cache):
    for i, entry in enumerate(cache["layers"]):
        for side, bufs in entry.items():
            for key, buf in bufs.items():
                yield f"{i}/{side}/{key}", buf


def _caches_agree(tcache, jcache):
    """Codes byte-identical; f32 leaves (scales, zeros, dense roped K / raw
    V) within TOL of the leaf's max|JAX| (f32 rounding of XLA's and
    PyTorch's sums, grown through the layers before)."""
    want = dict(_leaves(jcache))
    got = dict(_leaves(tcache))
    assert list(got) == list(want)
    for name, jbuf in want.items():
        tbuf = got[name]
        assert tuple(tbuf.shape) == jbuf.shape, name
        if tbuf.dtype == torch.uint8:
            np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf), err_msg=name)
        else:
            _close(tbuf, jbuf, name)
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))


@pytest.mark.parametrize("case", [
    dict(nkv=8, window=None, q_offset=0, sk=24),   # MHA, the one-shot prefill's shape
    dict(nkv=2, window=None, q_offset=5, sk=29),   # GQA, queries past offset 0
    dict(nkv=4, window=7, q_offset=3, sk=27),      # GQA and a sliding window
    dict(nkv=1, window=4, q_offset=0, sk=24)], ids=["mha", "gqa_offset", "gqa_window",
                                                   "mqa_window"])
def test_mha_prefill_matches_jax(case):
    b, sq, nh, hd = 2, 24, 8, 16
    rng = np.random.default_rng(case["nkv"] + case["q_offset"])
    q = rng.standard_normal((b, sq, nh, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, case["sk"], case["nkv"], hd)).astype(np.float32)
            for _ in range(2))
    want = jmha_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), case["window"],
                        case["q_offset"])
    got = mha_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      case["window"], case["q_offset"])
    assert got.dtype == torch.float32
    _close(got, want)


def _stepwise(eng, ids, prefill, to_np):
    """prefill (a bound method) on the first half of ids, then decode the
    rest token by token: the logits after each step (B, n, V)."""
    p = ids.shape[1] // 2
    logits, cache = prefill(ids[:, :p])
    out = [to_np(logits[:, -1])]
    for t in range(p, ids.shape[1]):
        logits, cache = eng.decode(ids[:, t:t + 1], cache)
        out.append(to_np(logits[:, -1]))
    return np.stack(out, axis=1)


MODELS = {"dense": dict(lowrank=()), "mixed": dict(lowrank=(1,)),
          "mixed_3bit": dict(lowrank=(0,), qkw=FLAGSHIP)}


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_matches_jax_stepwise(name):
    kw = dict(MODELS[name])
    qkw = kw.pop("qkw", None)
    jeng, teng, _ = _pair(_cfg(**kw), seed=3, qkw=qkw, batch=2)
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 30))
    want = _stepwise(jeng, ids, jeng.prefill, np.asarray)
    got = _stepwise(teng, ids, teng.prefill, lambda x: x.numpy())
    _close(torch.from_numpy(got), want)
    paths = {"dense": {"dense_flash-plain"}, "mixed": {"dense_flash-plain", "palu_decode_fp-plain"},
             "mixed_3bit": {"dense_flash-plain", "palu_decode-plain"}}[name]
    assert teng._decode_paths == paths


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_cache_matches_jax(name):
    kw = dict(MODELS[name])
    qkw = kw.pop("qkw", None)
    jeng, teng, _ = _pair(_cfg(**kw), seed=4, qkw=qkw)
    ids = np.random.default_rng(4).integers(0, VOCAB, (1, 21))
    jl, jc = jeng.prefill(ids)
    tl, tc = teng.prefill(ids)
    _close(tl, jl)
    _caches_agree(tc, jc)
    if qkw:  # the low-rank layer's quantized codes are in the comparison
        assert tc["layers"][0]["k"]["codes_t"].dtype == torch.uint8
        assert tc["layers"][1]["k"]["lat"].shape == (1, 4, S_MAX, 8)


def test_prefill_bucketed_and_real_len_match_jax():
    jeng, teng, _ = _pair(_cfg(lowrank=(1,)), seed=5, qkw=FLAGSHIP, batch=2)
    ids = np.random.default_rng(5).integers(0, VOCAB, (2, 40))  # bucket 64
    jl, jc = jeng.prefill_bucketed(ids)
    tl, tc = teng.prefill_bucketed(ids)
    _close(tl, jl)
    _caches_agree(tc, jc)
    assert tc["length"].tolist() == [40, 40]
    # right-padded lanes of their own lengths
    real = np.array([33, 17])
    jl, jc = jeng.prefill(ids, real_len=real)
    tl, tc = teng.prefill(ids, real_len=real)
    _close(tl, jl)
    _caches_agree(tc, jc)
    assert tc["length"].tolist() == [33, 17]
    with pytest.raises(ValueError):  # longer than s_max: JAX's error
        teng.prefill_bucketed(np.zeros((2, S_MAX + 1), np.int64))
    with pytest.raises(ValueError):
        teng.prefill(np.zeros((1, 8), np.int64))  # not the engine batch


@pytest.mark.parametrize("name,lowrank,stacked,want", [
    ("all_lowrank", (0, 1), None, "chunked"), ("stacked", (0, 1), True, "chunked"),
    ("dense", (), None, "bucketed"), ("mixed", (1,), None, "bucketed")])
def test_prefill_auto_picks_jax_path(name, lowrank, stacked, want, monkeypatch):
    knobs = {"rank_major_fp": True, "stacked_decode": True} if stacked else {}
    jcfg = _cfg(lowrank=lowrank)
    jparams = jllama.init_params(jcfg, jax.random.key(6), dtype=jnp.float32, scale=0.2)
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                  config_from_dict(dataclasses.asdict(jcfg)),
                  EngineConfig(s_max=S_MAX, dtype=torch.float32, decode_chunk=CHUNK,
                               device="cpu", **knobs))
    taken = []
    for path in ("chunked", "bucketed"):
        real = getattr(teng, f"prefill_{path}")
        monkeypatch.setattr(teng, f"prefill_{path}",
                            lambda *a, _p=path, _f=real, **k: taken.append(_p) or _f(*a, **k))
    ids = np.random.default_rng(6).integers(0, VOCAB, (1, 37))
    logits, cache = teng.prefill_auto(ids)
    assert taken == [want] and logits.shape == (1, 1, VOCAB)
    assert cache["length"].tolist() == [37]
    if want == "bucketed":  # the chunked prefill refuses dense layers, as JAX's does
        with pytest.raises(NotImplementedError, match="prefill_bucketed"):
            teng.prefill_chunked(ids, chunk_size=CHUNK)


def test_generate_and_serving_on_dense_model_match_jax():
    jcfg = _cfg()
    jeng, teng, jparams = _pair(jcfg, seed=7)
    prompt = np.random.default_rng(7).integers(0, VOCAB, (1, 13))
    want = np.asarray(jeng.generate(prompt, max_new_tokens=6))
    got = teng.generate(prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(8)
    prompts = {rid: rng.integers(1, VOCAB, (1, n)) for rid, n in ((50, 11), (51, 6), (52, 19))}
    n_new = {50: 4, 51: 6, 52: 3}
    jsrv = JServingEngine(jparams, jcfg, JEngineConfig(s_max=S_MAX, batch=2, dtype=jnp.float32,
                                                       decode_chunk=CHUNK), prefer_native=False)
    srv = ServingEngine(teng.params, teng.cfg, dataclasses.replace(teng.ecfg, batch=2),
                        prefer_native=False)
    for rid, p in prompts.items():
        assert jsrv.submit(rid, p, n_new[rid]) and srv.submit(rid, p, n_new[rid])
    served = srv.run_until_done(max_steps=100)
    assert served == jsrv.run_until_done(max_steps=100)
    # each request as a sequential generate (the lanes' dense (B, nkv, S, hd)
    # buffers were copied in by _insert)
    for rid, p in prompts.items():
        assert served[rid] == teng.generate(p, max_new_tokens=n_new[rid])[0].tolist()


@pytest.mark.parametrize("side", ["k_proj", "v_proj"])
def test_one_dense_side_prefills_as_jax_and_refuses_decode(side):
    jcfg = _cfg(lowrank=(0, 1), one_side=side)
    jeng, teng, _ = _pair(jcfg, seed=9)
    ids = np.random.default_rng(9).integers(0, VOCAB, (1, 18))
    jl, jc = jeng.prefill(ids)
    tl, tc = teng.prefill(ids)
    _close(tl, jl)
    _caches_agree(tc, jc)
    # JAX's decode attention reads both sides' U: it has no decode for such
    # a layer, and the port raises instead of inventing one
    with pytest.raises(KeyError):
        jeng.decode(ids[:, :1], jc)
    with pytest.raises(ValueError, match="no decode"):
        teng.decode(ids[:, :1], tc)
    with pytest.raises(NotImplementedError):  # the chunked prefill, as JAX's
        teng.prefill_chunked(ids, chunk_size=CHUNK)


@pytest.mark.parametrize("qkw", [None, FLAGSHIP], ids=["lat_t", "3bit"])
def test_stacked_one_shot_prefill_matches_unrolled(qkw):
    """prefill on a layer-stacked engine (JAX's _prefill_impl_stacked)
    writes through the stacked cache's layer views: logits and every
    layer's buffers equal the unrolled engine's."""
    jcfg = _cfg(lowrank=(0, 1))
    knobs = {} if qkw else {"rank_major_fp": True}
    _, flat, _ = _pair(jcfg, seed=10, qkw=qkw, **knobs)
    _, stacked, _ = _pair(jcfg, seed=10, qkw=qkw, stacked_decode=True, **knobs)
    assert stacked._stacked
    ids = np.random.default_rng(10).integers(0, VOCAB, (1, 23))
    fl, fc = flat.prefill(ids)
    sl, sc = stacked.prefill(ids)
    assert torch.equal(fl, sl)
    for i in range(2):
        got = stacked._layer_entry(sc, i)
        for side, bufs in fc["layers"][i].items():
            for key, buf in bufs.items():
                assert torch.equal(got[side][key], buf), (i, side, key)
    nl, _ = stacked.decode(ids[:, :1], sc)
    fl2, _ = flat.decode(ids[:, :1], fc)
    assert torch.equal(nl, fl2)


@pytest.mark.parametrize("bits", [8, 4])
def test_mixed_engine_with_quantized_weights_matches_jax(bits):
    """A mixed model under weight_bits 8 / 4 (the dense k / v projections
    quantized too; hidden 128 for the GEMVs' 128-column blocks): prefill
    and a decode step against the JAX engine's."""
    hwr = {f"model.layers.1.self_attn.{w}": [r] * 2 for w, r in (("k_proj", 16), ("v_proj", 32))}
    jcfg = JModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                        head_group_size=2, head_wise_ranks=hwr)
    jparams = jllama.init_params(jcfg, jax.random.key(2), dtype=jnp.float32, scale=0.1)
    jeng = JEngine(jparams, jcfg, JEngineConfig(s_max=S_MAX, dtype=jnp.float32,
                                                decode_chunk=CHUNK, weight_bits=bits))
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                  config_from_dict(dataclasses.asdict(jcfg)),
                  EngineConfig(s_max=S_MAX, dtype=torch.float32, decode_chunk=CHUNK,
                               device="cpu", weight_bits=bits))
    ids = np.random.default_rng(bits).integers(0, 128, (1, 20))
    jl, jc = jeng.prefill(ids)
    tl, tc = teng.prefill(ids)
    _close(tl, jl)
    jl, _ = jeng.decode(ids[:, :1], jc)
    tl, _ = teng.decode(ids[:, :1], tc)
    _close(tl, jl)
    assert f"gemv_int{bits}-plain" in teng._gemv_paths
