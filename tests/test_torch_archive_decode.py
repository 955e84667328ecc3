"""The archived v2 / v3 decodes of palu_tpu_torch.ops.archive (their plain
versions on the CPU) against the JAX kernels palu_flash_decode2,
palu_flash_decode2_quantized and palu_flash_decode3_quantized, in interpret
mode at f32 compute, on the same numpy-seeded inputs (the JAX side
quantizes and packs; its codes, scales and zeros are carried across).
Tolerance 1e-5 of max|JAX|: both sides compute in f32 and differ in
summation order and in the last bits of cos / sin. sz_pack is held bit
for bit. The plain versions run on one intra-op thread (a fixture), so
their summation order is fixed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.core import quant as jquant
from palu_tpu.core.quant import QuantConfig as JaxQuantConfig
from palu_tpu.models import rope as jrope
from palu_tpu.models.config import ModelConfig as JaxModelConfig
from palu_tpu.ops.pallas.archive.palu_decode2 import (palu_flash_decode2,
                                                      palu_flash_decode2_quantized)
from palu_tpu.ops.pallas.archive.palu_decode3 import palu_flash_decode3_quantized
from palu_tpu.ops.pallas.archive.palu_decode3 import sz_pack as jax_sz_pack
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.archive.palu_decode2 import (palu_decode2, palu_decode2_quantized,
                                                     palu_decode2_quantized_ref)
from palu_tpu_torch.ops.archive.palu_decode3 import (palu_decode3_quantized,
                                                     palu_decode3_quantized_ref, sz_pack)

TOL = 1e-5
G, HPG, RK, RV, HD, S, BS = 2, 4, 32, 64, 128, 256, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(b=1, kv_len=200, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, G * HPG, HD)).astype(np.float32)
    b_k = (rng.standard_normal((G, HPG, RK, HD)) * 0.1).astype(np.float32)
    x_k = rng.standard_normal((b, G, S, RK)).astype(np.float32)
    x_v = rng.standard_normal((b, G, S, RV)).astype(np.float32)
    return q, b_k, x_k, x_v, np.full((b,), kv_len, np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _rope(scaling):
    """(inv_freq tuple, rope_scale) of a rope_scaling dict, from the JAX
    package's models/rope (None: the plain theta schedule)."""
    if scaling is None:
        return None, 1.0
    cfg = JaxModelConfig(rope_scaling=scaling, num_attention_heads=8, num_key_value_heads=8,
                         hidden_size=1024)
    inv, scale = jrope.inv_freq_and_scale(cfg)
    return tuple(float(f) for f in np.asarray(inv)), float(scale)


ROPE = {"theta": None, "linear": {"rope_type": "linear", "factor": 2.0},
        "yarn": {"rope_type": "yarn", "factor": 4.0,
                 "original_max_position_embeddings": 64}}


@pytest.mark.parametrize("b,kv_len,window,rope", [
    (1, 200, None, "theta"), (1, 256, None, "theta"), (1, 1, None, "theta"),
    (2, 100, 50, "theta"), (1, 200, None, "linear"), (1, 200, None, "yarn")])
def test_decode2_bf16_layout_matches_jax(b, kv_len, window, rope):
    q, b_k, x_k, x_v, kvl = _case(b, kv_len)
    x_v_t = np.ascontiguousarray(x_v.swapaxes(2, 3))
    inv, scale = _rope(ROPE[rope])
    want = palu_flash_decode2(jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(x_k),
                              jnp.asarray(x_v_t), jnp.asarray(kvl), block_s=BS,
                              sliding_window=window, interpret=True,
                              compute_dtype=jnp.float32, inv_freq_static=inv, rope_scale=scale)
    got = palu_decode2(_t(q), _t(b_k), _t(x_k), _t(x_v_t), _t(kvl), block_s=BS,
                       sliding_window=window, inv_freq=inv, rope_scale=scale)
    _assert_close(got, want)


def _affine(x, bits, sym):
    """JAX's quantize_affine + pack_codes_t: (packed, scale (B, G, S),
    zero (B, G, S)) as numpy."""
    c, s, z = jquant.quantize_affine(jnp.asarray(x), JaxQuantConfig(bits=bits, group_size=0,
                                                                     sym=sym))
    return (np.asarray(jquant.pack_codes_t(c, bits)), np.asarray(s[..., 0]),
            np.asarray(z[..., 0]))


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_decode2_quantized_matches_jax(bits, sym):
    q, b_k, x_k, x_v, kvl = _case()
    kc, ks, kz = _affine(x_k, bits, sym)
    vc, vs, vz = _affine(x_v, bits, sym)
    want = palu_flash_decode2_quantized(
        jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(kz),
        jnp.asarray(vc), jnp.asarray(vs), jnp.asarray(vz), jnp.asarray(kvl),
        qcfg=JaxQuantConfig(bits=bits, group_size=0, sym=sym), rk=RK, rv=RV, block_s=BS,
        interpret=True, compute_dtype=jnp.float32)
    args = [_t(a) for a in (q, b_k, kc, ks, kz, vc, vs, vz, kvl)]
    kw = dict(qcfg=QuantConfig(bits=bits, sym=sym), rk=RK, rv=RV, block_s=BS)
    got = palu_decode2_quantized(*args, **kw)
    _assert_close(got, want)
    assert torch.equal(got, palu_decode2_quantized_ref(*args, **kw))


@pytest.mark.parametrize("kv_len", [200, 256])
@pytest.mark.parametrize("bits", [3, 4])
def test_decode3_quantized_matches_jax(bits, kv_len):
    q, b_k, x_k, x_v, kvl = _case(kv_len=kv_len)
    kc, ks, kz = _affine(x_k, bits, False)
    vc, vs, vz = _affine(x_v, bits, False)
    ksz = np.asarray(jax_sz_pack(jnp.asarray(ks), jnp.asarray(kz)))
    vsz = np.asarray(jax_sz_pack(jnp.asarray(vs), jnp.asarray(vz)))
    want = palu_flash_decode3_quantized(
        jnp.asarray(q), jnp.asarray(b_k), jnp.asarray(kc), jnp.asarray(ksz), jnp.asarray(vc),
        jnp.asarray(vsz), jnp.asarray(kvl), qcfg=JaxQuantConfig(bits=bits, group_size=0),
        rk=RK, rv=RV, block_s=BS, interpret=True, compute_dtype=jnp.float32)
    args = [_t(a) for a in (q, b_k, kc, ksz, vc, vsz, kvl)]
    kw = dict(qcfg=QuantConfig(bits=bits), rk=RK, rv=RV, block_s=BS)
    got = palu_decode3_quantized(*args, **kw)
    _assert_close(got, want)
    assert torch.equal(got, palu_decode3_quantized_ref(*args, **kw))


def test_sz_pack_bit_exact():
    rng = np.random.default_rng(3)
    scale = rng.standard_normal((2, G, S)).astype(np.float32)
    zero = rng.standard_normal((2, G, S)).astype(np.float32)
    want = np.asarray(jax_sz_pack(jnp.asarray(scale), jnp.asarray(zero)))
    got = sz_pack(_t(scale), _t(zero))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


def test_v2_and_v3_agree():
    """The two generations compute one function on one cache (v3's sz is
    v2's scale and zero packed)."""
    q, b_k, x_k, x_v, kvl = _case()
    kc, ks, kz = _affine(x_k, 3, False)
    vc, vs, vz = _affine(x_v, 3, False)
    kw = dict(qcfg=QuantConfig(bits=3), rk=RK, rv=RV, block_s=BS)
    v2 = palu_decode2_quantized(*[_t(a) for a in (q, b_k, kc, ks, kz, vc, vs, vz, kvl)], **kw)
    v3 = palu_decode3_quantized(_t(q), _t(b_k), _t(kc), sz_pack(_t(ks), _t(kz)), _t(vc),
                                sz_pack(_t(vs), _t(vz)), _t(kvl), **kw)
    err = (v2 - v3).abs().max().item()
    assert err <= TOL * v2.abs().max().item(), err


def test_wrappers_validate_shapes():
    q, b_k, x_k, x_v, kvl = _case()
    x_v_t = np.ascontiguousarray(x_v.swapaxes(2, 3))
    with pytest.raises(ValueError):
        palu_decode2(_t(q), _t(b_k), _t(x_k), _t(x_v_t), _t(kvl), block_s=100)
    with pytest.raises(ValueError):
        palu_decode2(_t(q), _t(b_k), _t(x_k), _t(x_v), _t(kvl), block_s=BS)
    kc, ks, kz = _affine(x_k, 3, False)
    with pytest.raises(ValueError):  # per-chunk scales are not a v2 / v3 cache
        palu_decode3_quantized(_t(q), _t(b_k), _t(kc), sz_pack(_t(ks), _t(kz)), _t(kc),
                               sz_pack(_t(ks), _t(kz)), _t(kvl),
                               qcfg=QuantConfig(bits=3, group_size=8), rk=RK, rv=RK)


def _tool_variant_kinds():
    """The names tools/tpu_ab_v2.py::make_fn knows: `variant == "..."` and
    `variant.startswith("...")` (a width follows)."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "tools" / "tpu_ab_v2.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_fn")
    exact, prefixes = set(), set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Compare) and isinstance(n.left, ast.Name) and \
                n.left.id == "variant" and isinstance(n.comparators[0], ast.Constant):
            exact.add(n.comparators[0].value)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and \
                n.func.attr == "startswith" and isinstance(n.args[0], ast.Constant):
            prefixes.add(n.args[0].value)
    return exact, prefixes


def test_ab_v2_entry_point_runs_on_cpu(capsys, monkeypatch):
    from palu_tpu_torch.tools import ab_v2

    exact, prefixes = _tool_variant_kinds()
    assert exact == {"v1", "v2", "v4", "xla"}
    assert prefixes == {"v1q", "v2q", "v3q", "v4a", "v4s", "v4g", "v4q"}
    names = {ab_v2._split(v)[0] for v in ab_v2.ALL_VARIANTS}
    assert names == exact | prefixes
    assert ab_v2.DEFAULT_VARIANTS == ["v1", "v2", "v2q3", "v2q4"]
    monkeypatch.setenv("SEQ", "4096")
    monkeypatch.setenv("CHAIN", "5")
    a = ab_v2.parser().parse_args([])
    assert (a.seq, a.bs, a.nch, a.gsz) == (4096, 1024, 5, 128)
    monkeypatch.setenv("KVL", "300")
    recs = ab_v2.main(["--use_cpu", "--json", "--seq", "512", "--bs", "128",
                       *ab_v2.ALL_VARIANTS])
    assert [r["variant"] for r in recs] == ab_v2.ALL_VARIANTS
    assert all(r["kvl"] == 300 and "cpu_ms" in r and "us" not in r for r in recs)
    assert all(r["held"]["ok"] for r in recs if "held" in r)
    assert {r["variant"]: r.get("same_as") for r in recs if r.get("same_as")} == \
        {"v4s3": "v4q3", "v4q3r": "v4q3"}
    assert len(capsys.readouterr().out.strip().splitlines()) == len(recs)
    with pytest.raises(SystemExit):
        ab_v2.main(["--use_cpu", "--seq", "512", "v5"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ab_v2.main([])
