"""The compression path of the port on the CPU against the JAX package, in
f32 on a 2-layer model (hidden 256, vocab 512): synthetic_batches bit for
bit, rank_search's dicts equal for all three methods given the same Fisher
means, whiten scales and Fisher matrices within 1e-4 of max|JAX|,
search_ranks + compress_params (fisher_uniform + whiten + Hadamard, and
fisher's ragged ranks + svd) giving forward logits within 1e-4 of
max|JAX| (ragged forwards included), and the port's Engine over a
compressed and over a padded ragged model step for step against the JAX
Engine (use_pallas=False), within 1e-4 of max|logits|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu import compression as jc
from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.models import llama as jl
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch import compression as tc
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core import wquant
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.models import llama as tl
from palu_tpu_torch.runtime.engine import Engine, EngineConfig

TOL = 1e-4
VOCAB = 512


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PALU_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture(scope="module")
def model():
    """A 2-layer dense model (4 heads of 64; head groups of 2, so group_dim
    128) in both packages, the same f32 weights, and 4 calibration batches
    of 160 tokens (~370 distinct embeddings: the hidden-256 Gram of every
    layer is positive definite and the Cholesky well conditioned)."""
    jcfg = JModelConfig(vocab_size=VOCAB, hidden_size=256, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    jp = jl.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    calib = jc.synthetic_batches(VOCAB, 4, 160)
    return jcfg, jp, config_from_dict(dataclasses.asdict(jcfg)), tp, calib


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("args", [(256, 4, 48, 0, 1), (32000, 2, 512, 7, 2), (10, 1, 3, 3, 1)])
def test_synthetic_batches_bit_identical(args):
    got, want = tc.synthetic_batches(*args), jc.synthetic_batches(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_get_calib_batches_matches_jax(tmp_path):
    """Text slices of a local corpus, tokenized, with the JAX package's
    random.Random(seed) windows; and the .npz cache under PALU_CACHE_DIR."""
    text = tmp_path / "corpus.txt"
    text.write_text(" ".join(f"word{i % 97}" for i in range(4000)))

    def tokenizer(s, return_tensors):
        assert return_tensors == "np"
        return {"input_ids": np.array([[ord(c) % 50 for c in s]])}

    kw = dict(nsamples=3, seqlen=40, seed=5, local_text_path=str(text))
    want = jc.get_calib_batches("wikitext2", tokenizer, "org/m", use_cache=False, **kw)
    got = tc.get_calib_batches("wikitext2", tokenizer, "org/m", **kw)
    assert len(got) == 3 and (tmp_path / "cache" / "wikitext2_org_m_3_40_5.npz").exists()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    again = tc.get_calib_batches("wikitext2", None, "org/m", **kw)  # from the cache
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


def test_rounding_and_split_match_jax():
    cfg = {"a": [33.0, 48.1, 1.0, 300.7], "b": [128.0]}
    assert tc.rounding_search_result(cfg) == jc.rounding_search_result(cfg)
    assert tc.split_values(cfg, 2) == jc.split_values(cfg, 2)


@pytest.mark.parametrize("method", ["uniform", "fisher", "fisher_uniform"])
@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.7])
def test_rank_search_matches_jax(method, ratio):
    """7B widths (32 layers, group_dim 512): the dicts the two packages
    allocate from the same (random) Fisher means."""
    jcfg = JModelConfig()
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    names = tc.kv_module_names(tcfg)
    assert names == jc.kv_module_names(jcfg)
    rng = np.random.default_rng(int(ratio * 10))
    groups = {"fisher": 8, "fisher_uniform": 1, "uniform": 1}[method]
    means = {n: [float(v) for v in rng.lognormal(size=groups)] for n in names}
    fm = None if method == "uniform" else means
    got = tc.rank_search(tcfg, names, ratio, method, 4, fm)
    want = jc.rank_search(jcfg, names, ratio, method, 4, fm)
    assert got == want


def test_whiten_scales_match_jax(model):
    jcfg, jp, tcfg, tp, calib = model
    want = jc.whiten_scale_matrices(jp, jcfg, calib)
    got = tc.whiten_scale_matrices(tp, tcfg, calib)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _rel(g, w) <= TOL
        assert torch.equal(g, torch.tril(g))


def test_whiten_cache_is_shared_with_jax(model):
    """A cache the port writes is the file the JAX package reads."""
    jcfg, jp, tcfg, tp, calib = model
    got = tc.whiten_scale_matrices(tp, tcfg, calib, model_id="org/tiny")
    jax_read = jc.whiten_scale_matrices(jp, jcfg, calib[:1], model_id="org/tiny")
    for g, w in zip(got, jax_read):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fisher_matches_jax(model):
    jcfg, jp, tcfg, tp, calib = model
    want = jc.calib_fisher_info(jp, jcfg, calib[:2])
    got = tc.calib_fisher_info(tp, tcfg, calib[:2])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32 and _rel(got[name], want[name]) <= TOL
    for k in tp["layers"][0]["attn"]["k_proj"].values():
        assert not k.requires_grad  # the caller's weights are untouched
    gm, wm = tc.fisher_group_means(got, 2), jc.fisher_group_means(want, 2)
    for name in wm:
        np.testing.assert_allclose(gm[name], wm[name], rtol=TOL)


def test_fisher_refuses_quantized_weights(model):
    _, _, tcfg, tp, calib = model
    layers = [dict(l, mlp={**l["mlp"], "up": wquant.quantize_weight(l["mlp"]["up"])})
              for l in tp["layers"]]
    with pytest.raises(ValueError, match="dense weights"):
        tc.calib_fisher_info({**tp, "layers": layers}, tcfg, calib[:1])


_COMPRESSED = {}


def _compressed(model, method, decompose, hadamard, ratio=0.5):
    """Both packages' search_ranks + compress_params on the model (once per
    case in this module: no test changes the trees)."""
    key = (method, decompose, hadamard, ratio)
    if key not in _COMPRESSED:
        _COMPRESSED[key] = _compress_both(model, *key)
    return _COMPRESSED[key]


def _compress_both(model, method, decompose, hadamard, ratio):
    jcfg, jp, tcfg, tp, calib = model
    sel_j = jc.search_ranks(jp, jcfg, ratio, method, 2, calib_batches=calib[:2])
    sel_t = tc.search_ranks(tp, tcfg, ratio, method, 2, calib_batches=calib[:2])
    assert sel_t == sel_j
    jcp, jcc = jc.compress_params(jp, jcfg, sel_j, decompose, 2, calib_batches=calib,
                                  hadamard=hadamard)
    tcp, tcc = tc.compress_params(tp, tcfg, sel_t, decompose, 2, calib_batches=calib,
                                  hadamard=hadamard)
    assert dataclasses.asdict(tcc) == dataclasses.asdict(jcc)
    return jcp, jcc, tcp, tcc


# group_dim 128: fisher at 0.19 puts layer 0's two K groups (Fisher means
# 5 % apart) on either side of 48, so the rounding to multiples of 32 gives
# them 64 and 32 (ragged); uniform at 0.75 gives 96 = 12 * 8 (K = 12)
CASES = {"fisher_uniform-whiten-hadamard": ("fisher_uniform", "whiten", True, 0.5),
         "fisher-svd-ragged": ("fisher", "svd", False, 0.19),
         "uniform-svd-hadamard": ("uniform", "svd", True, 0.75)}


@pytest.mark.parametrize("case", list(CASES))
def test_compressed_forward_matches_jax(model, case):
    method, decompose, hadamard, ratio = CASES[case]
    jcp, jcc, tcp, tcc = _compressed(model, method, decompose, hadamard, ratio)
    ragged = any(tl.is_ragged(l["attn"][w]) for l in tcp["layers"] for w in ("k_proj", "v_proj"))
    assert ragged == (method == "fisher")
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 24))
    for mode in ("reconstruct", "fused"):
        want = jl.forward(jcp, jnp.asarray(ids), jcc, value_mode=mode)
        got = tl.forward(tcp, torch.as_tensor(ids), tcc, value_mode=mode)
        assert _rel(got, want) <= TOL


def _stepwise(eng, ids, forced, to_np):
    logits, cache = eng.prefill_chunked(ids, chunk_size=16)
    out = [to_np(logits)]
    for t in forced:
        logits, cache = eng.decode(np.full((1, 1), t, np.int32), cache)
        out.append(to_np(logits))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("cache", ["bf16-latents", "3bit"])
@pytest.mark.parametrize("case", ["fisher_uniform-whiten-hadamard", "fisher-svd-ragged"])
def test_engine_over_compressed_model_matches_jax(model, case, cache):
    """The port's Engine (plain kernels, f32) against the JAX Engine; the
    ragged model is padded at build by both (JAX's
    test_ragged_engine_pads_and_matches_forward). Over unquantized latents
    each engine serves its own package's compressed params. Over the 3-bit
    cache both serve JAX's params, carried across: the two packages'
    factors differ in their last bits, and a latent that lands across a
    3-bit boundary takes the neighbouring code, which moves this random
    model's logits by a large share of max|logits| (either engine is as
    far from the unquantized forward)."""
    method, decompose, hadamard, ratio = CASES[case]
    jcp, jcc, tcp, tcc = _compressed(model, method, decompose, hadamard, ratio)
    qkw = dict(bits=3, group_size=0, sym=True, container=4) if cache == "3bit" else None
    if qkw:
        tcp = params_from_numpy(jax.tree.map(np.asarray, jcp), device="cpu")
    jeng = JEngine(jcp, jcc, JEngineConfig(s_max=64, dtype=jnp.float32, decode_chunk=16,
                                           qcfg=qkw and JQuantConfig(**qkw), use_pallas=False))
    teng = Engine(tcp, tcc, EngineConfig(s_max=64, dtype=torch.float32, decode_chunk=16,
                                         qcfg=qkw and QuantConfig(**qkw), device="cpu"))
    assert not tl.is_ragged(teng.params["layers"][0]["attn"]["k_proj"])
    assert teng.cfg.head_wise_ranks == jeng.cfg.head_wise_ranks
    rng = np.random.default_rng(4)
    ids, forced = rng.integers(0, VOCAB, (1, 21)), rng.integers(0, VOCAB, 6)
    want = _stepwise(jeng, ids, forced, np.asarray)
    got = _stepwise(teng, ids, forced, lambda t: t.numpy())
    assert _rel(got, want) <= TOL
    assert teng._decode_paths == {"palu_decode-plain" if qkw else "palu_decode_fp-plain"}


def test_padded_ragged_engine_matches_forward(model):
    """JAX's test_ragged_engine_pads_and_matches_forward on the port: the
    padded engine over an unquantized cache against the ragged forward."""
    _, _, tcp, tcc = _compressed(model, *CASES["fisher-svd-ragged"])
    with pytest.raises(ValueError, match="pad_ragged_params"):
        tcc.uniform_rank_for(0, "k_proj")  # the runtime needs uniform ranks
    padded, pcfg = tl.pad_ragged_params(tcp, tcc)
    assert pcfg.uniform_rank_for(0, "k_proj") == 64
    assert not tl.is_ragged(padded["layers"][1]["attn"]["v_proj"])
    assert all(len(set(r)) == 1 for r in pcfg.head_wise_ranks.values())
    ids = np.arange(12)[None, :] % VOCAB
    ref = tl.forward(tcp, torch.as_tensor(ids), tcc).numpy()
    eng = Engine(tcp, tcc, EngineConfig(s_max=32, dtype=torch.float32, decode_chunk=8,
                                        qcfg=None, device="cpu"))
    logits, cache = eng.prefill_chunked(ids[:, :6], chunk_size=8)
    np.testing.assert_allclose(logits[0, -1].numpy(), ref[0, 5], rtol=2e-3, atol=2e-3)
    for t in range(6, 12):
        logits, cache = eng.decode(ids[:, t:t + 1], cache)
        np.testing.assert_allclose(logits[0, -1].numpy(), ref[0, t], rtol=2e-3, atol=2e-3)


def test_search_ranks_fisher_cache_is_shared_with_jax(model, tmp_path):
    jcfg, jp, tcfg, tp, calib = model
    sel = tc.search_ranks(tp, tcfg, 0.5, "fisher_uniform", 2, calib_batches=calib[:2],
                          model_id="org/tiny")
    assert (tmp_path / "cache" / "org_tiny_calib_fisher_info.npz").exists()
    # the JAX package reads the port's file (no calibration data given)
    assert jc.search_ranks(jp, jcfg, 0.5, "fisher_uniform", 2, model_id="org/tiny") == sel
