"""JAX's seq-major per-chunk cache layout (QuantConfig.group_size > 0 whose
chunk is not a multiple of 8 dividing the rank: codes / scales / base,
sequence on the axis before the last) in the port, on the CPU, against the
JAX package:

  - the cache encode bit-identical to JAX's at group sizes 4 and 12, sym
    and asym, 3 and 4 bits, and decode_latents reading back what JAX's does;
  - the engine at QuantConfig(bits=4, group_size=4) against JAX's stepwise
    logits (tests/test_engine.py's test_engine_pallas_group_quant_falls_back
    _to_xla case: JAX's XLA path, since no kernel reads this layout): the
    one-shot prefill and the layer-major chunked prefill, then decode over
    flash_decode_latent, recorded as the plain path on the CPU and on a
    CUDA-looking tensor alike; cache codes byte-identical;
  - a chunk that does not divide the rank raising JAX's ValueError."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import quant as jquant
from palu_tpu.runtime import cache as jcache_lib
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.runtime import cache as cache_lib
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from test_engine import _lowrank_model

QUANTS = {
    "4bit_asym_gs4": dict(bits=4, group_size=4, sym=False),
    "4bit_sym_gs12": dict(bits=4, group_size=12, sym=True),
    "3bit_sym_gs4": dict(bits=3, group_size=4, sym=True, container=4),
    "3bit_asym_gs12": dict(bits=3, group_size=12, sym=False),
}
TOL = 1e-5  # of max|logits|, f32


@pytest.mark.parametrize("q", list(QUANTS))
def test_seq_major_encode_is_bit_identical_to_jax(q):
    qkw = QUANTS[q]
    rank = 48  # divides 4 and 12; 3-bit planes need a multiple of 8
    x = np.random.default_rng(len(q)).standard_normal((2, 3, 40, rank)).astype(np.float32)
    want = jcache_lib._encode(jnp.asarray(x), jquant.QuantConfig(**qkw), jnp.float32)
    got = cache_lib._encode(torch.from_numpy(x), QuantConfig(**qkw))
    assert list(got) == list(want) == ["codes", "scales", "base"]
    for k in want:
        assert got[k].dtype == (torch.uint8 if k == "codes" else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["scales"].shape == (2, 3, 40, rank // qkw["group_size"])
    buf = cache_lib._layer_buffers(2, 3, 40, rank, QuantConfig(**qkw), "cpu")
    jbuf = jcache_lib._layer_buffers(2, 3, 40, rank, jnp.float32, jquant.QuantConfig(**qkw))
    assert {k: tuple(v.shape) for k, v in buf.items()} == {k: v.shape for k, v in jbuf.items()}
    lat = cache_lib.decode_latents(got, QuantConfig(**qkw), rank, torch.float32).numpy()
    jlat = np.asarray(jcache_lib.decode_latents(want, jquant.QuantConfig(**qkw), rank,
                                                jnp.float32))
    np.testing.assert_array_equal(lat, jlat)
    # a write at per-lane offsets lands where seq_slice reads it back
    cache_lib.write_at_lanes(buf, got, torch.tensor([0, 0]))
    back = cache_lib.seq_slice(buf, 10, 5)
    for k in got:
        np.testing.assert_array_equal(back[k].numpy(), got[k][:, :, 10:15].numpy(), err_msg=k)


def _stepwise(eng, ids, prefill, to_np):
    p = ids.shape[1] // 2
    logits, cache = prefill(ids[:, :p])
    out = [to_np(logits[:, -1])]
    for t in range(p, ids.shape[1]):
        logits, cache = eng.decode(ids[:, t:t + 1], cache)
        out.append(to_np(logits[:, -1]))
    return np.stack(out, axis=1), cache


def _engines(qkw):
    """JAX's test_engine_pallas_group_quant_falls_back_to_xla model in both
    packages (rank 16 in groups of 2 heads, s_max 16, decode_chunk 8)."""
    params, cfg = _lowrank_model(seed=24, rank=16, gs=2)
    jeng = JEngine(params, cfg, JEngineConfig(s_max=16, dtype=jnp.float32,
                                              qcfg=jquant.QuantConfig(**qkw), decode_chunk=8))
    teng = Engine(params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                  config_from_dict(dataclasses.asdict(cfg)),
                  EngineConfig(s_max=16, dtype=torch.float32, qcfg=QuantConfig(**qkw),
                               decode_chunk=8, device="cpu"))
    return jeng, teng


@pytest.mark.parametrize("prefill", ["prefill", "prefill_chunked"])
@pytest.mark.parametrize("q", ["4bit_asym_gs4", "3bit_sym_gs4"])
def test_seq_major_engine_matches_jax(q, prefill):
    qkw = QUANTS[q]
    jeng, teng = _engines(qkw)
    ids = np.random.default_rng(24).integers(0, 64, (1, 12))
    want, jc = _stepwise(jeng, ids, jeng.prefill, np.asarray)
    fn = teng.prefill if prefill == "prefill" else (
        lambda x: teng.prefill_chunked(x, chunk_size=8))
    got, tc = _stepwise(teng, ids, fn, lambda x: x.numpy())
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert teng._decode_paths == {"flash_decode_latent-plain"}
    for i, (tl, jl) in enumerate(zip(tc["layers"], jc["layers"])):
        for side in ("k", "v"):
            assert list(tl[side]) == ["codes", "scales", "base"]
            np.testing.assert_array_equal(tl[side]["codes"].numpy(),
                                          np.asarray(jl[side]["codes"]), err_msg=f"{i}{side}")
            for k in ("scales", "base"):
                w = np.asarray(jl[side][k])
                assert np.abs(tl[side][k].numpy() - w).max() <= TOL * np.abs(w).max()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers is_cuda: the engine's path choice as on
    the card (the seq-major decode has no kernel to launch there)."""

    @property
    def is_cuda(self):
        return True


def test_seq_major_decode_path_is_plain_on_either_device():
    jeng, teng = _engines(QUANTS["4bit_asym_gs4"])
    ids = np.random.default_rng(3).integers(0, 64, (1, 6))
    _, cache = teng.prefill(ids)
    entry = cache["layers"][0]
    q = torch.randn(1, 4, 8).as_subclass(_CudaLooking)
    teng._decode_attention(q, entry, teng._layers[0]["attn"], teng.derived[0],
                           torch.tensor([6]))
    assert teng._decode_paths == {"flash_decode_latent-plain"}


def test_seq_major_chunk_must_divide_the_rank():
    qkw = dict(bits=4, group_size=12, sym=True)  # rank 16
    jeng, teng = _engines(qkw)
    assert "codes" in teng.init_cache()["layers"][0]["k"]
    ids = np.zeros((1, 6), np.int64)
    with pytest.raises(ValueError, match="divisible by group_size"):
        jeng.prefill(ids)
    with pytest.raises(ValueError, match="divisible by group_size"):
        teng.prefill(ids)
