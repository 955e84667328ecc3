"""The port's layer-stacked Engine (EngineConfig.stacked_decode) on the CPU
against the JAX stacked Engine (its scanned decode with the v4 kernel's
layer_idx, interpret mode, the kernels at f32 compute) and against the
port's unrolled Engine, mirroring tests/test_engine_stacked.py.

The port's stacked and unrolled engines run the same f32 operations on the
same values (a stacked weight's view is the weight), so their logits and
cache bytes must be identical. Against JAX: logits within 1e-4 of
max|logits| (tests/test_torch_engine.py's bound against the JAX engine),
cache codes identical and the f32 scale / zero rows and raw latents within
rtol 1e-5 (the latents are h @ VT from XLA's and PyTorch's f32 matmuls,
which sum in different orders)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.ops.pallas import palu_decode4 as jpk4
from palu_tpu.runtime import cache as jcache_lib
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import palu_decode
from palu_tpu_torch.runtime import cache as cache_lib
from palu_tpu_torch.runtime import profiler
from palu_tpu_torch.runtime.engine import Engine, EngineConfig
from test_engine import _lowrank_model, _qwen2_bias_model

TOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_f32_kernels(monkeypatch):
    """The JAX v4 decode kernels at f32 compute (bf16 by default)."""
    for name in ("palu_flash_decode4", "palu_flash_decode4_quantized"):
        monkeypatch.setattr(jpk4, name, functools.partial(getattr(jpk4, name),
                                                          compute_dtype=jnp.float32))


def _engines(jparams, jcfg, qkw=None, rank_major_fp=False, batch=1, s_max=32,
             weight_bits=16):
    """JAX stacked, port stacked and port unrolled engines on one model."""
    base = dict(s_max=s_max, batch=batch, decode_chunk=8, rank_major_fp=rank_major_fp,
                weight_bits=weight_bits)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        **base, dtype=jnp.float32, qcfg=None if qkw is None else JQuantConfig(**qkw),
        use_pallas=True, pallas_interpret=True, stacked_decode=True))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    ecfg = EngineConfig(**base, dtype=torch.float32, device="cpu",
                        qcfg=None if qkw is None else QuantConfig(**qkw))
    stacked = Engine(params, cfg, dataclasses.replace(ecfg, stacked_decode=True))
    unrolled = Engine(params, cfg, ecfg)
    assert jeng._stacked and stacked._stacked and not unrolled._stacked
    return jeng, stacked, unrolled


def _run(eng, ids, n_decode=5, active=None):
    """prefill_chunked + forced decode; per-step logits (B, 1 + n, V), cache."""
    logits, cache = eng.prefill_chunked(ids, chunk_size=8)
    steps = [np.asarray(logits[:, -1])]
    rng = np.random.default_rng(7)
    for _ in range(n_decode):
        tok = rng.integers(0, 16, (ids.shape[0], 1))
        if isinstance(eng, JEngine):
            kw = {} if active is None else {"active": jnp.asarray(active)}
            logits, cache = eng.decode(jnp.asarray(tok, jnp.int32), cache, **kw)
        else:
            kw = {} if active is None else {"active": torch.as_tensor(active)}
            logits, cache = eng.decode(tok, cache, **kw)
        steps.append(np.asarray(logits[:, -1]))
    return np.stack(steps, axis=1), cache


def _assert_caches(jcache, tcache, ucache):
    """Port stacked == port unrolled byte for byte; against JAX codes equal
    and floats within rtol 1e-5."""
    np.testing.assert_array_equal(np.asarray(jcache["length"]), tcache["length"].numpy())
    np.testing.assert_array_equal(ucache["length"].numpy(), tcache["length"].numpy())
    for side in ("k", "v"):
        for key, jbuf in jcache["stack"][side].items():
            tbuf = tcache["stack"][side][key]
            assert tuple(tbuf.shape) == jbuf.shape, (side, key)
            for i, entry in enumerate(ucache["layers"]):
                assert torch.equal(entry[side][key].reshape(tbuf[i].shape), tbuf[i]), (side, key)
            if key == "codes_t":
                np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf), err_msg=key)
            else:
                np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{side}/{key}")


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


QCFGS = {"3b-sym": (dict(bits=3, group_size=0, sym=True), False),
         "3b-in-4": (dict(bits=3, group_size=0, sym=True, container=4), False),
         "4b-asym": (dict(bits=4, group_size=0, sym=False), False),
         "4b-chunked": (dict(bits=4, group_size=8, sym=True), False),
         "3b-chunked-asym": (dict(bits=3, group_size=8, sym=False), False),
         "fp-rank-major": (None, True)}


@pytest.mark.parametrize("name", list(QCFGS))
def test_stacked_decode_matches_jax_and_unrolled(name):
    qkw, rm = QCFGS[name]
    jeng, stacked, unrolled = _engines(*_lowrank_model(rank=16, gs=2), qkw, rm)
    ids = np.random.default_rng(0).integers(0, 64, (1, 12))
    want, jcache = _run(jeng, ids)
    n = palu_decode.launches
    got, tcache = _run(stacked, ids)
    assert palu_decode.launches == n  # CPU tensors: the plain versions
    ref, ucache = _run(unrolled, ids)
    np.testing.assert_array_equal(got, ref)
    _close(got, want)
    _assert_caches(jcache, tcache, ucache)
    path = "palu_decode" if qkw is not None else "palu_decode_fp_t"
    assert stacked._decode_paths == {f"{path}[layer_idx]-plain"}


def test_stacked_decode_batched_lanes_and_masking():
    jeng, stacked, unrolled = _engines(*_lowrank_model(rank=16, gs=2),
                                       dict(bits=4, group_size=0, sym=True), batch=2)
    ids = np.random.default_rng(1).integers(0, 64, (2, 8))
    active = np.asarray([True, False])
    want, jcache = _run(jeng, ids, 3, active)
    got, tcache = _run(stacked, ids, 3, active)
    ref, ucache = _run(unrolled, ids, 3, active)
    assert tcache["length"].tolist() == [11, 8]
    np.testing.assert_array_equal(got, ref)
    _close(got, want)
    _assert_caches(jcache, tcache, ucache)


def test_stacked_generate_matches_jax():
    jeng, stacked, unrolled = _engines(*_lowrank_model(rank=16, gs=2),
                                       dict(bits=3, group_size=0, sym=True))
    ids = np.random.default_rng(2).integers(0, 64, (1, 9))
    want = np.asarray(jeng.generate(ids, max_new_tokens=6))
    np.testing.assert_array_equal(stacked.generate(ids, max_new_tokens=6), want)
    np.testing.assert_array_equal(unrolled.generate(ids, max_new_tokens=6), want)


def test_stacked_weight_bits8_matches_jax():
    jeng, stacked, unrolled = _engines(*_lowrank_model(rank=16, gs=2),
                                       dict(bits=4, group_size=0, sym=True), weight_bits=8)
    assert "wq8" in stacked.params["layers_stacked"]["mlp"]["gate"]
    ids = np.random.default_rng(3).integers(0, 64, (1, 10))
    want, jcache = _run(jeng, ids, 3)
    got, tcache = _run(stacked, ids, 3)
    ref, ucache = _run(unrolled, ids, 3)
    np.testing.assert_array_equal(got, ref)
    _close(got, want)
    _assert_caches(jcache, tcache, ucache)


def test_stacked_eligibility_and_default():
    jparams, jcfg = _lowrank_model(rank=16, gs=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    base = dict(s_max=32, dtype=torch.float32, decode_chunk=8, device="cpu")
    rm = QuantConfig(bits=3, group_size=0, sym=True)
    # None resolves to the unrolled decode (as in JAX), the config eligible
    eng = Engine(params, cfg, EngineConfig(**base, qcfg=rm))
    assert not eng._stacked and eng._stacked_ineligible_reason() is None
    assert "layers" in eng.params and "stack" not in eng.init_cache()
    eng = Engine(params, cfg, EngineConfig(**base, qcfg=rm, stacked_decode=True))
    assert eng._stacked and "stack" in eng.init_cache()
    # ineligible: the seq-major fp cache; forcing it raises with the reason
    eng = Engine(params, cfg, EngineConfig(**base))
    assert eng._stacked_ineligible_reason() is not None
    with pytest.raises(ValueError, match="rank_major_fp"):
        Engine(params, cfg, EngineConfig(**base, stacked_decode=True))
    # and the JAX engine agrees on both
    jeng = JEngine(jparams, jcfg, JEngineConfig(s_max=32, dtype=jnp.float32, decode_chunk=8,
                                                use_pallas=True, pallas_interpret=True,
                                                qcfg=JQuantConfig(bits=3, group_size=0,
                                                                  sym=True)))
    assert not jeng._stacked and jeng._stacked_ineligible_reason() is None


def test_stacked_from_prestacked_params():
    """An engine built from a stacked engine's params is stacked and gives
    identical logits; stacked_decode=False is refused for them."""
    _, stacked, _ = _engines(*_lowrank_model(rank=16, gs=2), dict(bits=4, group_size=0,
                                                                  sym=True))
    again = Engine(stacked.params, stacked.cfg, dataclasses.replace(stacked.ecfg,
                                                                    stacked_decode=None))
    assert again._stacked
    ids = np.random.default_rng(4).integers(0, 64, (1, 10))
    np.testing.assert_array_equal(_run(stacked, ids, 3)[0], _run(again, ids, 3)[0])
    with pytest.raises(ValueError, match="layer-stacked"):
        Engine(stacked.params, stacked.cfg, dataclasses.replace(stacked.ecfg,
                                                                stacked_decode=False))


@pytest.mark.parametrize("sym", [True, False])
def test_stacked_qwen2_bias_matches_jax(sym):
    """Qwen2 k/v biases: the stacked k_bias enters the kernel, the stacked
    o_bias_corr adds after the fused o_proj; an engine rebuilt from the
    stacked params re-derives both."""
    jeng, stacked, unrolled = _engines(*_qwen2_bias_model(seed=41),
                                       dict(bits=4, group_size=0, sym=sym))
    assert all("k_bias" in d and "o_bias_corr" in d for d in stacked.derived)
    ids = np.random.default_rng(41).integers(0, 64, (1, 12))
    want, jcache = _run(jeng, ids)
    got, tcache = _run(stacked, ids)
    ref, ucache = _run(unrolled, ids)
    np.testing.assert_array_equal(got, ref)
    _close(got, want)
    _assert_caches(jcache, tcache, ucache)
    again = Engine(stacked.params, stacked.cfg, stacked.ecfg)
    np.testing.assert_array_equal(_run(again, ids, 3)[0], got[:, :4])


def test_stacked_scaled_rope_matches_jax():
    jparams, jcfg = _lowrank_model(seed=45, rank=16, gs=2)
    jcfg = dataclasses.replace(jcfg, rope_scaling={"rope_type": "linear", "factor": 2.0})
    jeng, stacked, unrolled = _engines(jparams, jcfg, dict(bits=3, group_size=0, sym=True))
    assert stacked._inv_freq is not None
    ids = np.random.default_rng(45).integers(0, 64, (1, 12))
    want, jcache = _run(jeng, ids)
    got, tcache = _run(stacked, ids)
    ref, ucache = _run(unrolled, ids)
    np.testing.assert_array_equal(got, ref)
    _close(got, want)
    _assert_caches(jcache, tcache, ucache)


def test_stacked_profiler_seeds_the_stack():
    """seed_cache_random fills a stacked engine's (L, ...) leaves (the
    latency CLIs' path) from the same stream as the unrolled engine's
    per-layer leaves, and profile_tpot drives it."""
    from palu_tpu.runtime import profiler as jprofiler

    jeng, stacked, unrolled = _engines(*_lowrank_model(rank=16, gs=2),
                                       dict(bits=3, group_size=0, sym=True, container=4))
    cs = profiler.seed_cache_random(stacked, 20)
    assert cs["length"].tolist() == [20]
    jc = jprofiler.seed_cache_random(jeng, 20)
    for side, bufs in jc["stack"].items():
        for k, v in bufs.items():
            np.testing.assert_array_equal(cs["stack"][side][k].numpy(), np.asarray(v))
    res = profiler.profile_tpot(stacked, 20, n_steps=2, warmup=1)
    assert np.isfinite(res["tpot_ms"]) and res["tpot_ms"] > 0
    assert stacked._decode_paths == {"palu_decode[layer_idx]-plain"}


def test_stacked_serving_matches_unrolled_serving():
    """ServingEngine on a stacked engine: batch-1 prefills insert into the
    stacked cache's lanes (axis 1) and the served tokens equal the
    unrolled engine's; stacked_decode None resolves to False there."""
    from palu_tpu_torch.runtime.serving import ServingEngine

    jparams, jcfg = _lowrank_model(rank=16, gs=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, (n,)) for n in (5, 9, 4)]
    outs = []
    for stacked in (True, None):
        srv = ServingEngine(params, cfg, EngineConfig(
            s_max=32, batch=2, dtype=torch.float32, decode_chunk=8, device="cpu",
            qcfg=QuantConfig(bits=4, group_size=0, sym=False), stacked_decode=stacked),
            prefer_native=False)
        assert srv.engine._stacked == bool(stacked) == srv.prefill_engine._stacked
        for rid, p in enumerate(prompts):
            srv.submit(rid, p, max_new_tokens=5)
        outs.append(srv.run_until_done(max_steps=60))
    assert outs[0] == outs[1] and len(outs[0]) == 3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_chunk", [False, True])
def test_write_at_lanes_stacked_matches_jax(per_chunk, masked):
    """write_at_lanes_stacked into layer 1 of an L = 3 stack (codes,
    per-row squeezed or per-chunk scale / zero rows, one token per lane at
    its own position) equals JAX's bit for bit, and equals the masked
    write through the layer's per-layer views that the engine's append
    makes (layer_view + stacked_unsqueeze)."""
    rng = np.random.default_rng(40 + 2 * per_chunk + masked)
    n_l, b, g, nr, s = 3, 3, 2, 5, 16
    sc = (g, 2) if per_chunk else (g,)
    buf = {"codes_t": rng.integers(0, 256, (n_l, b, g, nr, s)).astype(np.uint8),
           "scale_t": rng.standard_normal((n_l, b) + sc + (s,)).astype(np.float32),
           "zero_t": rng.standard_normal((n_l, b) + sc + (s,)).astype(np.float32)}
    upd = {"codes_t": rng.integers(0, 256, (b, g, nr, 1)).astype(np.uint8),
           "scale_t": rng.standard_normal((b,) + sc + (1,)).astype(np.float32),
           "zero_t": rng.standard_normal((b,) + sc + (1,)).astype(np.float32)}
    pos = np.array([0, 7, 15], np.int32)
    mask = np.array([True, False, True]) if masked else None
    want = jcache_lib.write_at_lanes_stacked(
        {k: jnp.asarray(v) for k, v in buf.items()}, {k: jnp.asarray(v) for k, v in upd.items()},
        jnp.asarray(pos), 1, None if mask is None else jnp.asarray(mask))
    tbuf = {k: torch.from_numpy(v.copy()) for k, v in buf.items()}
    tupd = {k: torch.from_numpy(v) for k, v in upd.items()}
    tmask = None if mask is None else torch.from_numpy(mask)
    got = cache_lib.write_at_lanes_stacked(tbuf, tupd, torch.from_numpy(pos), 1, tmask)
    for k in buf:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    qcfg = QuantConfig(bits=3, group_size=8 if per_chunk else 0, sym=False)
    views = {k: torch.from_numpy(v.copy()) for k, v in buf.items()}
    entry = cache_lib.stacked_unsqueeze(cache_lib.layer_view({"k": views}, 1)["k"], qcfg)
    cache_lib.write_at_lanes_masked(
        entry, cache_lib.stacked_unsqueeze(tupd, qcfg), torch.from_numpy(pos),
        torch.ones(b, dtype=torch.bool) if tmask is None else tmask)
    for k in buf:
        assert torch.equal(views[k], got[k]), k
