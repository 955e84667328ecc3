"""Per-chunk latent caches (QuantConfig.group_size > 0, the reference's
--lt_group_size) in the port, on the CPU, against the JAX package:

  - the rank-major per-chunk layout (codes_t, and scale_t / zero_t row
    stacks of shape (B, G, rank // group_size, S)) written from the same
    latents is bit-identical to JAX's cache encode, and decode_latents reads
    back what JAX's does;
  - palu_decode_ref over per-chunk scales, with and without the K bias,
    against JAX's palu_flash_decode4_quantized(group_chunk) in interpret
    mode at f32 compute: 1e-5 of max|ref| (both dequantize in f32 before
    the dots; summation order apart);
  - the Engine against JAX's Engine(use_pallas=False) after prefill and
    decode: per-step logits within 1e-4 of max|logits|, identical greedy
    tokens and cache codes (scales to f32 summation order of the latents);
  - the int8 K-path modes refusing per-chunk scales, and chunks JAX keeps
    in its seq-major layout taking that layout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import quant as jquant
from palu_tpu.models import llama as jllama
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4_quantized
from palu_tpu.runtime import cache as jcache_lib
from palu_tpu_torch.convert import config_from_dict
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.models import llama
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.runtime import cache as cache_lib
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from test_torch_qwen2 import assert_engines_agree, engine_pair, qwen2_config, qwen2_params
from test_torch_engine import _config as llama_config

QUANTS = {
    "3bit_sym_gs8": dict(bits=3, group_size=8, sym=True, container=4),
    "3bit_asym_gs16": dict(bits=3, group_size=16, sym=False, container=4),
    "4bit_asym_gs32": dict(bits=4, group_size=32, sym=False),
    "2bit_sym_gs16": dict(bits=2, group_size=16, sym=True),
}


@pytest.mark.parametrize("q", list(QUANTS))
def test_chunked_encode_is_bit_identical_to_jax(q):
    qkw = QUANTS[q]
    x = np.random.default_rng(0).standard_normal((2, 3, 40, 64)).astype(np.float32)
    want = jcache_lib._encode(jnp.asarray(x), jquant.QuantConfig(**qkw), jnp.float32)
    got = cache_lib._encode(torch.from_numpy(x), QuantConfig(**qkw))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["scale_t"].shape == (2, 3, 64 // qkw["group_size"], 40)
    buf = cache_lib._layer_buffers(2, 3, 40, 64, QuantConfig(**qkw), "cpu")
    assert {k: tuple(v.shape) for k, v in buf.items()} == {k: tuple(v.shape)
                                                           for k, v in got.items()}
    lat = cache_lib.decode_latents(got, QuantConfig(**qkw), 64, torch.float32).numpy()
    jlat = np.asarray(jcache_lib.decode_latents(want, jquant.QuantConfig(**qkw), 64,
                                                jnp.float32))
    np.testing.assert_array_equal(lat, jlat)


@pytest.mark.parametrize("q", list(QUANTS))
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "k_bias"])
def test_chunked_decode_matches_jax_kernel(q, bias):
    qkw = QUANTS[q]
    b, g, hpg, rk, rv, hd, s_max = 2, 2, 4, 32, 64, 64, 256
    rng = np.random.default_rng(len(q) + bias)
    qv = rng.standard_normal((b, g * hpg, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, hpg, rk, hd)) * 0.1).astype(np.float32)
    k_bias = (rng.standard_normal((g, hpg, hd)) * 0.3).astype(np.float32) if bias else None
    jq = jquant.QuantConfig(**qkw)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = rng.standard_normal((b, g, s_max, r)).astype(np.float32)
        codes, scales, zeros = jquant.quantize_affine(jnp.asarray(x), jq)
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes_t(codes, jq.pack_bits))
        bufs[f"x{side}_scale"] = np.ascontiguousarray(np.swapaxes(np.array(scales), -1, -2))
        if not jq.sym:
            bufs[f"x{side}_zero"] = np.ascontiguousarray(np.swapaxes(np.array(zeros), -1, -2))
    kv_len = np.asarray((200, 256), np.int32)
    order = ("xk_codes", "xk_scale", "xv_codes", "xv_scale")
    want = np.asarray(palu_flash_decode4_quantized(
        jnp.asarray(qv), jnp.asarray(b_k), *(bufs[k] for k in order), jnp.asarray(kv_len),
        qcfg=jq, rk=rk, rv=rv, block_s=64, interpret=True, compute_dtype=jnp.float32,
        k_bias=None if k_bias is None else jnp.asarray(k_bias),
        **{k: v for k, v in bufs.items() if k.endswith("zero")}))
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    n = palu_decode.launches
    got = palu_decode(torch.from_numpy(qv), torch.from_numpy(b_k),
                      kv_len=torch.from_numpy(kv_len), **tb, qcfg=QuantConfig(**qkw), rk=rk,
                      rv=rv, k_bias=None if k_bias is None else torch.from_numpy(k_bias))
    assert palu_decode.launches == n  # CPU: plain version
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


CHUNKED_ENGINES = {
    "llama_3bit_sym_gs8": ("llama", dict(bits=3, group_size=8, sym=True, container=4)),
    "llama_4bit_asym_gs16": ("llama", dict(bits=4, group_size=16, sym=False)),
    "qwen2_3bit_asym_gs32": ("qwen2", dict(bits=3, group_size=32, sym=False, container=4)),
}


@pytest.mark.parametrize("case", list(CHUNKED_ENGINES))
def test_chunked_engine_matches_jax(case):
    family, qkw = CHUNKED_ENGINES[case]
    if family == "qwen2":
        jcfg = qwen2_config()
        jparams = qwen2_params(jcfg)
    else:
        jcfg = llama_config(rk=16, rv=32)
        jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32, scale=0.2)
    jeng, teng = engine_pair(jcfg, jparams, qkw)
    assert_engines_agree(jeng, teng)
    assert teng._decode_paths == {"palu_decode-plain"}
    rk = teng.params["layers"][0]["attn"]["k_proj"]["U"].shape[1]
    assert teng.init_cache()["layers"][0]["k"]["scale_t"].shape[2] == rk // qkw["group_size"]


def test_chunked_refusals():
    rng = np.random.default_rng(0)
    qcfg = QuantConfig(bits=3, group_size=16, sym=True, container=4)
    lat = [torch.from_numpy(rng.standard_normal((1, 1, 64, r)).astype(np.float32))
           for r in (32, 64)]
    enc = [cache_lib._encode(x, qcfg) for x in lat]
    args = (torch.randn(1, 4, 64), torch.randn(1, 4, 32, 64), enc[0]["codes_t"],
            enc[0]["scale_t"], enc[1]["codes_t"], enc[1]["scale_t"], torch.tensor([50]))
    palu_decode_ref(*args, qcfg=qcfg, rk=32, rv=64)
    for mode in ("int8_dots", "int8_rot"):  # JAX's asserts: per-row scales only
        with pytest.raises(ValueError):
            palu_decode_ref(*args, qcfg=qcfg, rk=32, rv=64, block_s=64, **{mode: True})
    cfg = config_from_dict(dataclasses.asdict(llama_config(rk=16, rv=32)))
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    ecfg = EngineConfig(s_max=64, dtype=torch.float32, decode_chunk=16, device="cpu",
                        qcfg=QuantConfig(bits=3, group_size=16, sym=True, container=4))
    Engine(params, cfg, ecfg)
    for knob in ("kernel_int8_dots", "kernel_int8_rot", "kernel_fuse_uv",
                 "kernel_v_byte_dot"):
        with pytest.raises(ValueError):
            Engine(params, cfg, dataclasses.replace(ecfg, **{knob: True}))
    # chunks that are not a multiple of 8, or do not divide the rank: JAX's
    # seq-major per-chunk layout (tests/test_torch_cache_seq_chunked.py); a
    # chunk that does not divide a rank raises JAX's ValueError at encode
    for gs in (4, 12, 32):
        eng = Engine(params, cfg, dataclasses.replace(
            ecfg, qcfg=QuantConfig(bits=3, group_size=gs, sym=True)))
        assert list(eng.init_cache()["layers"][0]["k"]) == ["codes", "scales", "base"]
        if gs != 4:
            with pytest.raises(ValueError, match="divisible by group_size"):
                eng.prefill(np.zeros((1, 8), np.int64))
