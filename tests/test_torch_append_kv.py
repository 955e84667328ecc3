"""The one-launch append of a layer's K and V sides (ops/cache_append:
append_kv_quantized, KVAppend; csrc/cache_append.cu) on the CPU:

  - its plain version against JAX's append_token_quantized (Pallas,
    interpret=True) called once per side: codes, scales and zeros
    bit-identical, at sym / asym, clip, pack widths 2 / 4 / 8, the ranks of
    Llama-2-7B's groups (K 128, V 384) and Qwen2-7B's (256 / 256), 1-8
    lanes with masked lanes, positions 0 and S - 1;
  - a numpy emulation of the kernel (one warp per (side, lane, group) row,
    lane t owning the packed byte rows t, t + 32, ...; the extrema by
    shuffles; the same f32 operations, its division by the row's scale
    shown equal to the IEEE quotient in exact rational arithmetic) against
    JAX's _quantize_pack_rows:
    every byte row written by one lane, every latent read once a pass by
    coalesced loads, packed bytes, scales and zeros bit-identical;
  - the engine: one two-side append a layer and step, its KVAppend built
    once per cache and rebuilt for another cache."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from palu_tpu.core.quant import QuantConfig as JQuantConfig
from palu_tpu.ops.pallas.cache_append import (_quantize_pack_rows,
                                              append_token_quantized as j_append)
from palu_tpu.runtime import cache as jcache
from palu_tpu_torch.core.quant import QuantConfig, packed_nrows
from palu_tpu_torch.ops import cache_append as ca
from palu_tpu_torch.runtime import cache as tcache


def _t(a):
    return torch.from_numpy(np.array(a))


# (quant kwargs, (G, rank_k, rank_v), lanes): every pack width, sym and
# asym, clips; Llama-2-7B's group ranks at G 2 (cut from 8) and Qwen2-7B's
# one group at 256 / 256
CASES = [(dict(bits=3, sym=True, container=4), (2, 128, 384), 1),
         (dict(bits=3, sym=False, container=4), (2, 128, 384), 8),
         (dict(bits=2, sym=True), (1, 256, 256), 3),
         (dict(bits=4, sym=False, clip_ratio=0.9), (1, 256, 256), 8),
         (dict(bits=8, sym=True), (2, 128, 384), 2),
         (dict(bits=8, sym=False, clip_ratio=0.9), (1, 256, 256), 1),
         (dict(bits=4, sym=True, clip_ratio=0.9), (2, 128, 384), 5),
         (dict(bits=2, sym=False), (2, 128, 384), 4)]


def _case_id(case):
    kw, (g, rk, rv), lanes = case
    clip = f"_clip{kw['clip_ratio']}" if "clip_ratio" in kw else ""
    return (f"b{kw['bits']}c{kw.get('container', 0)}{'sym' if kw['sym'] else 'asym'}{clip}"
            f"_g{g}_{rk}x{rv}_l{lanes}")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_plain_kv_append_matches_jax_per_side(case):
    kw, (g, rk, rv), lanes = case
    jq, tq = JQuantConfig(group_size=0, **kw), QuantConfig(group_size=0, **kw)
    s_max = 256
    rng = np.random.default_rng(lanes + 10 * rk + kw["bits"])
    pos = np.array([0, s_max - 1, 100, 7, 200, 31, 64, 128][:lanes], np.int32)
    wr = np.array([i % 3 != 1 for i in range(lanes)])  # lanes 1, 4, 7 masked
    jbufs, tbufs, lats = [], [], []
    for r in (rk, rv):
        lat0 = rng.standard_normal((lanes, g, s_max, r)).astype(np.float32)
        jb = jcache._encode(jnp.asarray(lat0), jq, jnp.float32)
        jbufs.append(jb)
        tbufs.append({k: _t(v) for k, v in jb.items()})
        lats.append(rng.standard_normal((lanes, g, r)).astype(np.float32))
    before = [b["codes_t"].clone() for b in tbufs]
    n = ca.append_kv_quantized.launches
    ca.append_kv_quantized(_t(lats[0]), _t(lats[1]), *tbufs, _t(pos), _t(wr), qcfg=tq,
                           rank_k=rk, rank_v=rv)
    assert ca.append_kv_quantized.launches == n  # CPU: the plain version
    for lat, jb, tb, r, b0 in zip(lats, jbufs, tbufs, (rk, rv), before):
        want = j_append(jnp.asarray(lat), jb["codes_t"], jb["scale_t"], jnp.asarray(pos),
                        jnp.asarray(wr), qcfg=jq, rank=r,
                        zero=None if tq.sym else jb["zero_t"], interpret=True)
        names = ["codes_t", "scale_t"] + ([] if tq.sym else ["zero_t"])
        for name, w in zip(names, want):
            w = np.asarray(w)
            got = tb[name].numpy().reshape(w.shape)
            if w.dtype == np.float32:
                got, w = got.view(np.uint32), w.view(np.uint32)
            np.testing.assert_array_equal(got, w, err_msg=name)
        for lane in range(lanes):
            if not wr[lane]:
                assert torch.equal(tb["codes_t"][lane], b0[lane])


def test_kv_append_refuses_on_the_cpu():
    """A latent that is not contiguous raises (the kernel path does not copy
    it; the plain path checks the same), as do a wrong latent shape and
    buffers that do not match."""
    q = QuantConfig(bits=3, sym=True, container=4)
    bufs = [tcache._layer_buffers(2, 2, 16, r, q, "cpu") for r in (32, 64)]
    layer = ca.KVAppend(bufs, (32, 64), qcfg=q)
    pos, wr = torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool)
    lk = torch.zeros(2, 2, 32)
    with pytest.raises(ValueError):
        layer((lk, torch.zeros(2, 64, 2).transpose(1, 2)), pos, wr)
    with pytest.raises(ValueError):
        layer((lk, lk), pos, wr)
    with pytest.raises(ValueError):
        layer((lk,), pos, wr)
    with pytest.raises(ValueError):  # a rank the buffers were not made for
        ca.KVAppend(bufs, (32, 32), qcfg=q)
    with pytest.raises(ValueError):  # exact 3-bit packing keeps the plain write
        ca.KVAppend(bufs, (32, 64), qcfg=QuantConfig(bits=3, sym=True))
    other = tcache._layer_buffers(3, 2, 16, 64, q, "cpu")
    with pytest.raises(ValueError):  # sides of other lanes
        ca.KVAppend((bufs[0], other), (32, 64), qcfg=q)


# ---------------------------------------------------------------------------
# numpy emulation of the kernel
# ---------------------------------------------------------------------------

def _lane_rows(nrows: int):
    """Lane t of a row's warp -> the byte rows it owns: t, t + 32, ...
    (cache_append.cu)."""
    return {t: list(range(t, nrows, 32)) for t in range(32)}


def _emulate_row(lat: np.ndarray, qcfg: QuantConfig):
    """append_kernel's work for one (side, lane, group) row of f32 latents
    (rank,): (packed bytes (nrows,), scale, zero, reads, writes)."""
    f32 = np.float32
    rank, pb = lat.shape[0], qcfg.pack_bits
    fields = 8 // pb
    nrows = rank // fields
    owners = _lane_rows(nrows)
    reads = np.zeros(rank, np.int64)
    hi = np.full(32, -np.finfo(f32).max, f32)
    lo = np.full(32, np.finfo(f32).max, f32)
    for t, rows in owners.items():  # each lane's extrema over its byte rows
        for j in rows:
            for k in range(fields):
                v = lat[k * nrows + j]
                reads[k * nrows + j] += 1
                hi[t] = max(hi[t], abs(v)) if qcfg.sym else max(hi[t], v)
                lo[t] = min(lo[t], v)
    for o in (16, 8, 4, 2, 1):  # __shfl_xor_sync butterflies
        idx = np.arange(32) ^ o
        hi, lo = np.maximum(hi, hi[idx]), np.minimum(lo, lo[idx])
    assert (hi == hi[0]).all() and (lo == lo[0]).all()
    hi, lo = hi[0], lo[0]
    clip = f32(qcfg.clip_ratio)
    if qcfg.sym:
        q_max, q_min = f32(2 ** (qcfg.bits - 1) - 1), f32(-(2 ** (qcfg.bits - 1)))
        inv = f32(1) / q_max
        sc = f32(max(hi, f32(1e-5)) * (f32(clip * inv) if qcfg.clip_ratio < 1 else inv))
        base = f32(0)
    else:
        q_max, q_min = f32(2 ** qcfg.bits - 1), f32(0)
        w_min = lo
        if qcfg.clip_ratio < 1:
            w_min = f32(lo * clip)
            diff = f32(np.float64(hi) * np.float64(clip) - np.float64(w_min))  # fma
        else:
            diff = f32(hi - lo)
        sc = f32(max(diff, f32(1e-5)) * (f32(1) / q_max))
        base = f32(min(max(np.rint(f32(-w_min) / sc), q_min), q_max))
    packed = np.zeros(nrows, np.int64)
    writes = np.zeros(nrows, np.int64)
    for rows in owners.values():  # each lane quantizes and packs its byte rows
        for j in rows:
            v = 0
            for k in range(fields):
                x = lat[k * nrows + j]
                q = min(max(f32(np.rint(f32(x / sc)) + base), q_min), q_max)
                v |= int(q - q_min) << (pb * k)
            packed[j] = v
            writes[j] += 1
    return packed, sc, f32((q_min - base) * sc), reads, writes


@pytest.mark.parametrize("kw", [dict(bits=3, sym=True, container=4),
                                dict(bits=3, sym=False, container=4),
                                dict(bits=2, sym=True, clip_ratio=0.9),
                                dict(bits=8, sym=False, clip_ratio=0.9),
                                dict(bits=4, sym=False), dict(bits=8, sym=True)])
@pytest.mark.parametrize("rank", [32, 128, 256, 384, 1024])
def test_kernel_emulation_matches_jax_pack_rows(kw, rank):
    """Lane t owns byte rows t, t + 32, ...: each written once, each latent
    read once for the extrema, and the packed bytes, scale and zero those of
    JAX's _quantize_pack_rows, bit for bit, for four groups of latents (the
    quotients x / scale as IEEE divisions: div_rn gives them, below)."""
    qcfg, jq = QuantConfig(**kw), JQuantConfig(**kw)
    lat = np.random.default_rng(rank + kw["bits"]).standard_normal((4, rank)).astype(np.float32)
    lat[1] *= 1e-7  # below the scale's 1e-5 floor
    rows = jax.jit(_quantize_pack_rows, static_argnames=("qcfg", "rank"))
    want = [np.asarray(a) for a in rows(jnp.asarray(lat), qcfg=jq, rank=rank)]
    nrows = packed_nrows(rank, qcfg.pack_bits)
    for gi in range(4):
        packed, sc, zero, reads, writes = _emulate_row(lat[gi], qcfg)
        assert (reads == 1).all() and (writes == 1).all() and len(writes) == nrows
        np.testing.assert_array_equal(packed, want[0][gi])
        assert np.float32(sc).view(np.uint32) == want[1][gi, 0].view(np.uint32)
        if not qcfg.sym:
            assert np.float32(zero).view(np.uint32) == want[2][gi, 0].view(np.uint32)


@pytest.mark.parametrize("rank,pbits", [(128, 4), (384, 4), (256, 2), (128, 8), (1024, 8)])
def test_lane_loads_are_coalesced(rank, pbits):
    """Each load of the warp reads the consecutive latents k * nrows + 32 i
    + t over its lanes t (one 64-byte bf16 segment), and the lanes own every
    byte row once."""
    nrows = rank * pbits // 8
    owners = _lane_rows(nrows)
    for i in range(-(-nrows // 32)):
        rows = [owners[t][i] for t in range(32) if i < len(owners[t])]
        assert rows == list(range(32 * i, 32 * i + len(rows)))
    assert sorted(j for r in owners.values() for j in r) == list(range(nrows))


def _rn32(v: Fraction) -> np.float32:
    """A rational rounded to the nearest float32 (ties to even), normal range."""
    if v == 0:
        return np.float32(0.0)
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    while v >= Fraction(2) ** (e + 1):
        e += 1
    while v < Fraction(2) ** e:
        e -= 1
    m = v / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n = m.numerator // m.denominator
    rest = m - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(sign * n * 2.0 ** (e - 23))


def _div_rn(x: np.float32, sc: np.float32) -> np.float32:
    """cache_append.cu's div_rn in exact arithmetic with one rounding a step
    (an fma rounds once): y = RN(1 / sc), q = RN(x y), r = RN(x - q sc),
    RN(q + r y)."""
    fx, fs = Fraction(float(x)), Fraction(float(sc))
    y = Fraction(float(_rn32(1 / fs)))
    q = Fraction(float(_rn32(fx * y)))
    r = Fraction(float(_rn32(fx - q * fs)))
    return _rn32(q + r * y)


def test_div_rn_is_the_ieee_quotient():
    """The append's quotient x / scale by one reciprocal a row and three
    roundings equals the IEEE division, bit for bit: latents against their
    row's scales at every bit width (scale = max|x| / q_max, the 1e-5 floor,
    clips), and random float32 pairs over 60 binades."""
    rng = np.random.default_rng(17)
    pairs = []
    for bits in (2, 3, 4, 8):
        for _ in range(150):
            x = rng.standard_normal(16).astype(np.float32) * np.float32(10.0 ** rng.uniform(-3, 3))
            for q_max in (2 ** (bits - 1) - 1, 2 ** bits - 1):
                sc = np.float32(np.abs(x).max() * np.float32(rng.choice([1.0, 0.9])) / q_max)
                pairs += [(v, sc) for v in x] + [(x[0], np.float32(1e-5) / np.float32(q_max))]
    e = rng.uniform(-30, 30, (6000, 2))
    pairs += [(np.float32(rng.choice([-1, 1]) * rng.uniform(1, 2) * 2.0 ** a),
               np.float32(rng.uniform(1, 2) * 2.0 ** b)) for a, b in e]
    for x, sc in pairs:
        want = np.float32(x) / np.float32(sc)
        assert _div_rn(x, sc).view(np.uint32) == want.view(np.uint32), (x, sc)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _tiny_engine(stacked: bool):
    from palu_tpu_torch.models import llama
    from palu_tpu_torch.models.config import ModelConfig
    from palu_tpu_torch.runtime.engine import Engine, EngineConfig

    layers, g, hpg = 2, 2, 2
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [32] * g
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [64] * g
    cfg = ModelConfig(vocab_size=64, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=layers, num_attention_heads=g * hpg,
                      num_key_value_heads=g * hpg, head_group_size=hpg,
                      head_wise_ranks=ranks)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    ecfg = EngineConfig(s_max=64, batch=2, decode_chunk=32, device="cpu",
                        qcfg=QuantConfig(bits=3, sym=True, container=4),
                        stacked_decode=stacked, dtype=torch.float32)
    return Engine(params, cfg, ecfg)


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "stacked"])
def test_engine_appends_both_sides_once_a_layer(monkeypatch, stacked):
    """Each decode step calls one two-side KVAppend a layer; the appends are
    built once per cache (not per step) and again for a new cache."""
    eng = _tiny_engine(stacked)
    built, calls = [], []
    real_init, real_call = ca.KVAppend.__init__, ca.KVAppend.__call__

    def init(self, bufs, ranks, **kw):
        built.append(tuple(ranks))
        real_init(self, bufs, ranks, **kw)

    def call(self, lats, pos, writeable):
        calls.append(len(lats))
        real_call(self, lats, pos, writeable)

    monkeypatch.setattr(ca.KVAppend, "__init__", init)
    monkeypatch.setattr(ca.KVAppend, "__call__", call)
    ids = np.random.default_rng(0).integers(0, 64, (2, 8))
    for _ in range(2):  # a new cache each time
        _, cache = eng.prefill_chunked(ids, chunk_size=32)
        for _ in range(3):
            eng.decode(np.zeros((2, 1), np.int64), cache)
    assert built == [(32, 64)] * 4  # 2 layers, 2 caches
    assert calls == [2] * 12  # 2 layers x 3 steps x 2 caches, both sides each
