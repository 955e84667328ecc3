"""The compact GQA form of the latent decodes' reconstruction weights, b_k
(G, hpg / rep, rk, hd) with one B per kv-head and k_bias (G, hpg / rep,
hd), on the CPU, against the JAX package:

  - palu_decode's plain path on the compact form against JAX's
    palu_flash_decode4_quantized on the repeated form (Pallas, interpret
    mode, f32 compute) and against palu_decode on the repeated form, at rep
    7 (Qwen2-7B's 28 q-heads over 4 kv-heads) and rep 2, sym and asym,
    per-row and per-chunk scales: 1e-5 of max|ref| (both dequantize in f32
    before the dots; summation order apart);
  - the same for the bf16 latent decodes: palu_decode_fp_t against JAX's
    palu_flash_decode4 with the K bias, palu_decode_fp against JAX's
    palu_flash_decode (the v1 kernel has no bias) and, with the bias,
    against JAX's XLA flash_decode_latent (what JAX's engine runs for that
    cache): 1e-5 of max|ref|;
  - 2-layer narrow Qwen2-shaped Engines, which keep the compact form for
    every cache (3-bit, seq-major and rank-major bf16 latents), against the
    JAX engine: logits at every step;
  - _splits and _item_tiles, the decode kernels' sequence split, as pure
    functions: never more blocks than SMs x blocks per SM; every tile of
    every (lane, group) covered exactly once; in the one-wave kernels every
    valid tile (kv_len below S, windows, sequence shards, lanes of unequal
    length) exactly once and no other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import quant as jquant
from palu_tpu.ops import attention as jattn
from palu_tpu.ops.pallas.palu_decode import palu_flash_decode
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4, palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import _item_tiles, _splits, palu_decode
from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_t
from test_torch_qwen2 import NH, NKV, assert_engines_agree, engine_pair, qwen2_config, qwen2_params

TOL = 1e-5  # of max|ref|: f32 on both sides, summation order apart
QUANTS = {"3bit_sym": dict(bits=3, group_size=0, sym=True, container=4),
          "3bit_asym": dict(bits=3, group_size=0, sym=False),
          "3bit_sym_gs16": dict(bits=3, group_size=16, sym=True, container=4),
          "3bit_asym_gs32": dict(bits=3, group_size=32, sym=False, container=4)}
# rep -> (G, kv-heads per group): 28 q-heads over 4 kv-heads in one group
# (Qwen2-7B), and 2 groups of 4 kv-heads read by 2 q-heads each
REPS = {7: (1, 4), 2: (2, 4)}


def _case(rep, qkw, seed):
    g, nkv = REPS[rep]
    b, rk, rv, hd, s_max = 2, 32, 64, 64, 256
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g * nkv * rep, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, nkv, rk, hd)) * 0.1).astype(np.float32)
    k_bias = (rng.standard_normal((g, nkv, hd)) * 0.3).astype(np.float32)
    jq = jquant.QuantConfig(**qkw)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = rng.standard_normal((b, g, s_max, r)).astype(np.float32)
        codes, scales, zeros = jquant.quantize_affine(jnp.asarray(x), jq)
        rows = ((lambda t: np.ascontiguousarray(np.swapaxes(np.array(t), -1, -2)))
                if jq.group_size else (lambda t: np.array(t)[..., 0]))
        bufs[f"x{side}_codes"] = np.array(jquant.pack_codes_t(codes, jq.pack_bits))
        bufs[f"x{side}_scale"] = rows(scales)
        if not jq.sym:
            bufs[f"x{side}_zero"] = rows(zeros)
    return q, b_k, k_bias, bufs, np.asarray((200, 256), np.int32), dict(rk=rk, rv=rv)


def _diagnostics(request, call, got: np.ndarray, want: np.ndarray) -> str:
    """What a failure of the parity below needs to be traced: the port's
    output recomputed in this process (with this process's settings and on
    one intra-op thread), torch's settings, and the test files that ran
    earlier in this worker process (its terminal reporter's records)."""
    again = call().numpy()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = call().numpy()
    finally:
        torch.set_num_threads(threads)
    tr = request.config.pluginmanager.get_plugin("terminalreporter")
    earlier = sorted({r.nodeid.split("::")[0] for reps in (tr.stats.values() if tr else ())
                      for r in reps if getattr(r, "nodeid", "")})
    lim = TOL * np.abs(want).max()
    return (f"max err {np.abs(got - want).max()} > {lim}; got[0, 0, :3] {got[0, 0, :3].tolist()}, "
            f"want {want[0, 0, :3].tolist()}; recomputed here: max |again - got| "
            f"{np.abs(again - got).max()} (err {np.abs(again - want).max()}), on one thread "
            f"max |one - got| {np.abs(one - got).max()} (err {np.abs(one - want).max()}); "
            f"torch {torch.__version__} threads {threads} interop "
            f"{torch.get_num_interop_threads()} default dtype {torch.get_default_dtype()} "
            f"cpu capability {torch.backends.cpu.get_cpu_capability()} f32 matmul "
            f"{torch.get_float32_matmul_precision()} worker "
            f"{os.environ.get('PYTEST_XDIST_WORKER')}; files run earlier in "
            f"this process: {earlier}")


@pytest.mark.parametrize("q", list(QUANTS))
@pytest.mark.parametrize("rep", list(REPS))
def test_compact_form_matches_jax_repeated_form(rep, q, request):
    qkw = QUANTS[q]
    qv, b_k, k_bias, bufs, kv_len, ranks = _case(rep, qkw, rep + len(q))
    # JAX's form: each kv-head's rows repeated for its rep q-heads
    jb_k, jk_bias = np.repeat(b_k, rep, axis=1), np.repeat(k_bias, rep, axis=1)
    order = ("xk_codes", "xk_scale", "xv_codes", "xv_scale")
    want = np.asarray(palu_flash_decode4_quantized(
        jnp.asarray(qv), jnp.asarray(jb_k), *(bufs[k] for k in order), jnp.asarray(kv_len),
        qcfg=jquant.QuantConfig(**qkw), **ranks, block_s=64, interpret=True,
        compute_dtype=jnp.float32, k_bias=jnp.asarray(jk_bias),
        **{k: v for k, v in bufs.items() if k.endswith("zero")}))
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    kw = dict(kv_len=torch.from_numpy(kv_len), **tb, qcfg=QuantConfig(**qkw), **ranks)
    n = palu_decode.launches

    def call():
        return palu_decode(torch.from_numpy(qv), torch.from_numpy(b_k), **kw,
                           k_bias=torch.from_numpy(k_bias))

    got = call()
    assert palu_decode.launches == n  # CPU: the plain version
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), _diagnostics(request, call, got.numpy(), want)
    repeated = palu_decode(torch.from_numpy(qv), torch.from_numpy(jb_k), **kw,
                           k_bias=torch.from_numpy(jk_bias))
    assert torch.equal(got, repeated)


@pytest.mark.parametrize("layout", ["seq_major", "rank_major"])
@pytest.mark.parametrize("rep", list(REPS))
def test_fp_compact_form_matches_jax_repeated_form(rep, layout):
    """palu_decode_fp / palu_decode_fp_t (plain versions) on the compact b_k
    and k_bias against JAX on the repeated form, and against themselves on
    it (the plain versions expand the compact form: identical)."""
    g, nkv = REPS[rep]
    b, rk, rv, hd, s_max, window = 2, 32, 64, 64, 256, None
    rng = np.random.default_rng(40 + rep + len(layout))
    q = rng.standard_normal((b, g * nkv * rep, hd)).astype(np.float32)
    b_k = (rng.standard_normal((g, nkv, rk, hd)) * 0.1).astype(np.float32)
    k_bias = (rng.standard_normal((g, nkv, hd)) * 0.3).astype(np.float32)
    x_k = rng.standard_normal((b, g, s_max, rk)).astype(np.float32)
    x_v = rng.standard_normal((b, g, s_max, rv)).astype(np.float32)
    kv_len = np.asarray((200, 256), np.int32)
    jb_k, jk_bias = np.repeat(b_k, rep, axis=1), np.repeat(k_bias, rep, axis=1)
    t = torch.from_numpy
    if layout == "rank_major":
        x_k, x_v = (np.ascontiguousarray(x.swapaxes(2, 3)) for x in (x_k, x_v))
        fn = palu_decode_fp_t
        cases = [(k_bias, jk_bias, np.asarray(palu_flash_decode4(
            jnp.asarray(q), jnp.asarray(jb_k), jnp.asarray(x_k), jnp.asarray(x_v),
            jnp.asarray(kv_len), rk=rk, rv=rv, block_s=64, interpret=True,
            compute_dtype=jnp.float32, k_bias=jnp.asarray(jk_bias))))]
    else:
        fn, chunk = palu_decode_fp, 64

        def jread(x):
            return lambda i: jax.lax.dynamic_slice_in_dim(jnp.asarray(x), i * chunk, chunk, 2)

        cases = [(None, None, np.asarray(palu_flash_decode(
            jnp.asarray(q), jnp.asarray(jb_k), jnp.asarray(x_k), jnp.asarray(x_v),
            jnp.asarray(kv_len), block_s=64, interpret=True, compute_dtype=jnp.float32))),
            (k_bias, jk_bias, np.asarray(jattn.flash_decode_latent(
                jnp.asarray(q), jread(x_k), jread(x_v), jnp.asarray(jb_k), s_max // chunk,
                chunk, jnp.asarray(kv_len), hd, 10000.0, rv, window,
                k_bias=jnp.asarray(jk_bias))))]
    for kb, jkb, want in cases:
        n = fn.launches
        got = fn(t(q), t(b_k), t(x_k), t(x_v), t(kv_len),
                 k_bias=None if kb is None else t(kb))
        assert fn.launches == n  # CPU: the plain version
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
        repeated = fn(t(q), t(jb_k), t(x_k), t(x_v), t(kv_len),
                      k_bias=None if jkb is None else t(jkb))
        assert torch.equal(got, repeated)


def test_compact_form_refusals():
    qv, b_k, k_bias, bufs, kv_len, ranks = _case(7, QUANTS["3bit_sym"], 0)
    kw = dict(kv_len=torch.from_numpy(kv_len), **{k: torch.from_numpy(v) for k, v in bufs.items()},
              qcfg=QuantConfig(**QUANTS["3bit_sym"]), **ranks)
    q = torch.from_numpy(qv)
    with pytest.raises(ValueError, match="divide"):  # 3 does not divide 28 q-heads
        palu_decode(q, torch.from_numpy(b_k[:, :3]), **kw)
    with pytest.raises(ValueError, match="k_bias"):  # the bias in the other form
        palu_decode(q, torch.from_numpy(b_k), **kw,
                    k_bias=torch.from_numpy(np.repeat(k_bias, 7, axis=1)))


def test_qwen2_engine_on_compact_form_matches_jax():
    """2 layers of Qwen2's head layout (28 q-heads over 4 kv-heads, hd 32)
    over the 3-bit cache: the engine keeps b_k and k_bias per kv-head and
    agrees with JAX's engine (per-q-head weights) at every step."""
    jcfg = qwen2_config()
    jeng, teng = engine_pair(jcfg, qwen2_params(jcfg, seed=3),
                             dict(bits=3, group_size=0, sym=False, container=4))
    for der in teng.derived:
        assert der["b_k"].shape[1] == der["k_bias"].shape[1] == NKV
    assert_engines_agree(jeng, teng, seed=2)
    assert teng._decode_paths == {"palu_decode-plain"}
    assert NH // NKV == 7


@pytest.mark.parametrize("cache", ["lat", "lat_t"])
def test_qwen2_engine_on_compact_form_bf16_latents(cache):
    """The same 2 layers over the unquantized latent caches, seq-major
    (palu_decode_fp) and rank-major (palu_decode_fp_t): the engine keeps b_k
    and k_bias per kv-head there too (K rebuilt once per kv-head) and agrees
    with JAX's engine (per-q-head weights) at every step."""
    jcfg = qwen2_config()
    ekw = {"rank_major_fp": True} if cache == "lat_t" else {}
    jeng, teng = engine_pair(jcfg, qwen2_params(jcfg, seed=4), None, **ekw)
    for der in teng.derived:
        assert der["b_k"].shape[1] == der["k_bias"].shape[1] == NKV
    assert_engines_agree(jeng, teng, seed=5)
    want = "palu_decode_fp_t" if cache == "lat_t" else "palu_decode_fp"
    assert teng._decode_paths == {f"{want}-plain"}


@pytest.mark.parametrize("s_max", [64, 8192, 66048])
@pytest.mark.parametrize("n_bg", [1, 8, 28, 64, 256])
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (114, 1)])
def test_splits_one_wave_every_tile_once(n_bg, s_max, sms, per_sm):
    splits, grid = _splits(sms, per_sm, n_bg, s_max)
    assert 1 <= grid <= sms * per_sm
    assert splits >= 1
    items = n_bg * splits
    assert grid == min(items, sms * per_sm)
    if n_bg <= sms * per_sm:  # at least a split each: one item per block
        assert items <= sms * per_sm
    tiles = -(-s_max // 64)
    per = -(-tiles // splits)  # a whole-S lane's tiles per split (_item_tiles)
    covered = np.zeros((n_bg, tiles), np.int64)
    for block in range(grid):  # the kernel's item loop
        for item in range(block, items, grid):
            bg, split = divmod(item, splits)
            covered[bg, split * per:min((split + 1) * per, tiles)] += 1
    assert (covered == 1).all()
    assert splits * per - tiles < per  # no split is empty
    # the one-wave kernels: each lane's valid tiles cut into the splits
    # (_item_tiles, as decode_common.cuh::tile_range): kv_len at and below
    # S, lanes of unequal length, a window, and sequence shards of S
    # columns at offset S (kv_len past the shard, inside it, before it)
    lanes = {"full": lambda bg: (s_max, None, 0),
             "half": lambda bg: (max(1, s_max // 2), None, 0),
             "unequal": lambda bg: (1 + (bg * 997) % s_max, None, 0),
             "window": lambda bg: (s_max - bg % 3, 1000, 0),
             "shard_past": lambda bg: (3 * s_max, None, s_max),
             "shard_inside": lambda bg: (s_max + 1 + (bg * 131) % s_max, 700, s_max),
             "shard_before": lambda bg: (1 + bg % s_max, None, s_max)}
    for name, lane in lanes.items():
        covered[:] = 0
        longest = np.zeros(n_bg, np.int64)  # the most tiles one split of the lane walks
        for block in range(grid):
            for item in range(block, items, grid):
                bg, split = divmod(item, splits)
                kv, window, off = lane(bg)
                t0, t1 = _item_tiles(kv, off, window, s_max, splits, split)
                covered[bg, t0:max(t0, t1)] += 1
                longest[bg] = max(longest[bg], t1 - t0)
        # the splits share the valid tiles evenly, not S's
        assert (longest == -(-covered.sum(1) // splits)).all(), name
        for bg in range(n_bg):
            kv, window, off = lane(bg)
            cols = np.arange(s_max)  # column t is position off + t
            valid = (off + cols < kv) & ((off + cols >= kv - window) if window else True)
            want = np.zeros(tiles, np.int64)
            want[np.unique(cols[valid] // 64)] = 1
            assert (covered[bg] == want).all(), (name, bg)
