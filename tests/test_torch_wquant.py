"""The port's core/wquant against palu_tpu/core/wquant on the CPU: codes and
scales bit-exact, unpack equal, wdot on 16/8/4-bit weights within 1e-5 in
f32 (bf16: within one bf16 rounding of the output, 2^-8 of max|y|), the
quantized params tree equal leaf for leaf, and the engine's validation."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import wquant as jw
from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core import wquant as tw
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime.engine import Engine, EngineConfig


def _rand(shape, seed, s=0.05):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * s


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_tree(got, want, path="params"):
    """Same containers and keys; every leaf equal, dtype included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("shape,seed", [((256, 128), 0), ((1024, 384), 1), ((96, 48), 2),
                                        ((4096, 256), 3)])
def test_quantize_weight_bit_exact(shape, seed):
    w = _rand(shape, seed)
    w[0, 0] = 0.0
    w[:, 1] = 0.0  # an all-zero column takes the 1e-30 floor
    _assert_same_tree(tw.quantize_weight(torch.from_numpy(w)), _np(jw.quantize_weight(w)))


@pytest.mark.parametrize("shape,seed", [((256, 128), 4), ((512, 384), 5), ((32, 48), 6),
                                        ((192, 64), 7), ((11008 // 8, 256), 8)])
def test_quantize_weight4_bit_exact(shape, seed):
    w = _rand(shape, seed)
    w[:128, 2] = 0.0  # an all-zero group
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _np(jw.quantize_weight4(w))
    got = tw.quantize_weight4(torch.from_numpy(w))
    _assert_same_tree(got, want)
    assert tw.w4_group(got) == jw.w4_group(want)
    np.testing.assert_array_equal(tw.unpack_weight4(got).numpy(),
                                  np.asarray(jw.unpack_weight4(want)))


def test_quantize_weight4_group_shrinks_with_warning():
    w = torch.from_numpy(_rand((1152, 128), 9))  # 1152 = 4.5 x 256
    with pytest.warns(UserWarning, match="scale group shrinks to 64"):
        q = tw.quantize_weight4(w)
    assert tw.w4_group(q) == 64
    small = tw.quantize_weight4(torch.from_numpy(_rand((32, 48), 10)))
    assert tw.w4_group(small) == 16  # below 1024 rows: shrinks silently
    with pytest.raises(ValueError):
        tw.quantize_weight4(torch.zeros(3, 8))


@pytest.mark.parametrize("shape,seed", [((96, 64), 11), ((512, 256), 12)])
def test_quantize_embed_bit_exact(shape, seed):
    e = _rand(shape, seed)
    e[3] = 0.0
    _assert_same_tree(tw.quantize_embed(torch.from_numpy(e)), _np(jw.quantize_embed(e)))
    ids = np.array([[0, 3, 5], [7, 1, 3]])
    got = tw.embed_rows(tw.quantize_embed(torch.from_numpy(e)), torch.from_numpy(ids),
                        torch.float32)
    want = jw.embed_rows(jw.quantize_embed(e), jnp.asarray(ids), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tw.embed_dim(tw.quantize_embed(torch.from_numpy(e))) == shape[1]


def _weights(kind, k, n, seed):
    w = _rand((k, n), seed)
    if kind == 16:
        return w, torch.from_numpy(w)
    jq = jw.quantize_weight4(w) if kind == 4 else jw.quantize_weight(w)
    return jq, params_from_numpy(_np(jq), device="cpu")


@pytest.mark.parametrize("kind", [16, 8, 4])
@pytest.mark.parametrize("lead", [(1,), (2, 3), (16,)])  # <= 8 rows: GEMV plain; 16: matmul
def test_wdot_f32_matches_jax(kind, lead):
    jwt, twt = _weights(kind, 512, 256, 13)
    x = _rand(lead + (512,), 14, 1.0)
    want = np.asarray(jw.wdot(jnp.asarray(x), jwt))
    paths = set()
    got = tw.wdot(torch.from_numpy(x), twt, paths).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    rows = int(np.prod(lead))
    expect = {16: "dense-matmul", 8: "gemv_int8-plain" if rows <= 8 else "int8-matmul",
              4: "gemv_int4-plain" if rows <= 8 else "int4-dequant-matmul"}[kind]
    assert paths == {expect}


@pytest.mark.parametrize("kind", [8, 4])
@pytest.mark.parametrize("rows", [3, 16])
def test_wdot_bf16_matches_jax(kind, rows):
    jwt, twt = _weights(kind, 512, 256, 15)
    x = _rand((rows, 512), 16, 1.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jw.wdot(xb, jwt).astype(jnp.float32))
    got = tw.wdot(torch.from_numpy(x).to(torch.bfloat16), twt)
    assert got.dtype == torch.bfloat16
    # both round the f32 result to bf16 once; sums in another order may land
    # on the neighbouring bf16 value: 2^-8 of max|y|
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-8 * np.abs(want).max())


def test_dense_operand_gives_the_same_product():
    for kind in (8, 4):
        _, twt = _weights(kind, 256, 128, 17)
        x = torch.from_numpy(_rand((2, 9, 256), 18, 1.0))
        dense = tw.dense_operand(twt, torch.float32)
        torch.testing.assert_close(tw.wdot(x, dense), tw.wdot(x, twt), rtol=0, atol=0)


def _jax_params(tied):
    ranks = {}
    for i in range(2):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [8, 8]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [16, 16]
    cfg = JModelConfig(vocab_size=128, hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                       head_group_size=2, head_wise_ranks=ranks, tie_word_embeddings=tied)
    return jllama.init_params(cfg, jax.random.key(0), dtype=jnp.float32), cfg


@pytest.mark.parametrize("bits,vt,embed,tied", [(8, False, False, False), (4, True, True, False),
                                                (4, False, True, True), (8, True, True, True)])
def test_quantize_params_matches_jax(bits, vt, embed, tied):
    jparams, _ = _jax_params(tied)
    want = _np(jw.quantize_params(jparams, vt=vt, embed=embed, bits=bits))
    tparams = params_from_numpy(_np(jparams), device="cpu")
    got = tw.quantize_params(tparams, vt=vt, embed=embed, bits=bits)
    _assert_same_tree(got, want)
    # fresh containers; the caller's tree is untouched; idempotent
    assert got["layers"][0]["attn"] is not tparams["layers"][0]["attn"]
    assert not tw.is_quantized_weight(tparams["layers"][0]["mlp"]["gate"])
    again = tw.quantize_params(got, vt=vt, embed=embed, bits=bits)
    _assert_same_tree(again, want)
    assert again["layers"][0]["mlp"]["gate"] is got["layers"][0]["mlp"]["gate"]
    l0 = got["layers"][0]
    assert tw.is_quantized_weight(l0["attn"]["k_proj"]["VT"]) == vt  # int8 even at bits=4
    if vt:
        assert "wq8" in l0["attn"]["k_proj"]["VT"]
    assert ("wq4" if bits == 4 else "wq8") in l0["attn"]["o_proj"]["w_fused"]


@pytest.mark.parametrize("rows", [1, 12])
def test_tied_int8_head(rows):
    jparams, _ = _jax_params(True)
    jq = jw.quantize_params(jparams, embed=True, bits=8)
    tq = params_from_numpy(_np(jq), device="cpu")
    head = tw.tied_head(tq)
    assert head["wq8"].shape == (256, 128) and head["wq8"].stride(0) == 1  # a view
    assert head["wq8"].data_ptr() == tq["embed"]["eq8"].data_ptr()
    x = _rand((rows, 256), 19, 1.0)
    want = np.asarray(jw.wdot(jnp.asarray(x), jw.tied_head(jq)))
    got = tw.wdot(torch.from_numpy(x), head).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = params_from_numpy(_np(jparams), device="cpu")
    assert tw.tied_head(plain).shape == (256, 128)


def test_params_from_numpy_keeps_scales_f32():
    jparams, _ = _jax_params(False)
    jq = _np(jw.quantize_params(jparams, vt=True, embed=True, bits=4))
    t = params_from_numpy(jq, device="cpu", dtype=torch.bfloat16)
    l0 = t["layers"][0]
    assert l0["mlp"]["gate"]["wq4"].dtype == torch.uint8
    assert l0["mlp"]["gate"]["ws"].dtype == torch.float32
    assert l0["attn"]["k_proj"]["VT"]["wq8"].dtype == torch.int8
    assert l0["attn"]["k_proj"]["VT"]["ws"].dtype == torch.float32
    assert t["embed"]["es"].dtype == torch.float32
    assert l0["attn"]["k_proj"]["U"].dtype == torch.bfloat16


@pytest.mark.parametrize("kw,match", [(dict(weight_bits=5), "weight_bits"),
                                      (dict(vt_bits=4, weight_bits=8), "vt_bits"),
                                      (dict(vt_bits=8), "vt_bits=8 requires"),
                                      (dict(embed_bits=4, weight_bits=4), "embed_bits"),
                                      (dict(embed_bits=8), "embed_bits=8 requires")])
def test_engine_validation(kw, match):
    jparams, jcfg = _jax_params(False)
    params = params_from_numpy(_np(jparams), device="cpu")
    ecfg = EngineConfig(s_max=32, dtype=torch.float32, device="cpu",
                        qcfg=QuantConfig(bits=3, sym=True, container=4), **kw)
    with pytest.raises(ValueError, match=match):
        Engine(params, config_from_dict(dataclasses.asdict(jcfg)), ecfg)
    with pytest.raises(ValueError, match="weight bits"):
        tw.quantize_params(params, bits=3)
