"""The compact GQA form of palu_decode's reconstruction weights, b_k (G,
hpg / rep, rk, hd) with one B per kv-head and k_bias (G, hpg / rep, hd), on
the CPU, against the JAX package:

  - palu_decode's plain path on the compact form against JAX's
    palu_flash_decode4_quantized on the repeated form (Pallas, interpret
    mode, f32 compute) and against palu_decode on the repeated form, at rep
    7 (Qwen2-7B's 28 q-heads over 4 kv-heads) and rep 2, sym and asym,
    per-row and per-chunk scales: 1e-5 of max|ref| (both dequantize in f32
    before the dots; summation order apart);
  - a 2-layer narrow Qwen2-shaped Engine, which keeps the compact form for
    its packed cache, against the JAX engine: logits at every step;
  - _splits, the decode kernels' sequence split, as a pure function: never
    more blocks than SMs x blocks per SM, every tile of every (lane, group)
    covered exactly once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import quant as jquant
from palu_tpu.ops.pallas.palu_decode4 import palu_flash_decode4_quantized
from palu_tpu_torch.core.quant import QuantConfig
from palu_tpu_torch.ops.palu_decode import _splits, palu_decode
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


@pytest.mark.parametrize("q", list(QUANTS))
@pytest.mark.parametrize("rep", list(REPS))
def test_compact_form_matches_jax_repeated_form(rep, q):
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
    got = palu_decode(torch.from_numpy(qv), torch.from_numpy(b_k), **kw,
                      k_bias=torch.from_numpy(k_bias))
    assert palu_decode.launches == n  # CPU: the plain version
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    repeated = palu_decode(torch.from_numpy(qv), torch.from_numpy(jb_k), **kw,
                           k_bias=torch.from_numpy(jk_bias))
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


@pytest.mark.parametrize("s_max", [64, 8192, 66048])
@pytest.mark.parametrize("n_bg", [1, 8, 28, 64, 256])
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (114, 1)])
def test_splits_one_wave_every_tile_once(n_bg, s_max, sms, per_sm):
    splits, per, grid = _splits(sms, per_sm, n_bg, s_max)
    assert 1 <= grid <= sms * per_sm
    assert splits >= 1 and per >= 1
    items = n_bg * splits
    assert grid == min(items, sms * per_sm)
    if n_bg <= sms * per_sm:  # at least a split each: one item per block
        assert items <= sms * per_sm
    tiles = -(-s_max // 64)
    covered = np.zeros((n_bg, tiles), np.int64)
    for block in range(grid):  # the kernel's item loop
        for item in range(block, items, grid):
            bg, split = divmod(item, splits)
            covered[bg, split * per:min((split + 1) * per, tiles)] += 1
    assert (covered == 1).all()
    assert splits * per - tiles < per  # no split is empty
