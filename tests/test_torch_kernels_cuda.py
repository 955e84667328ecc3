"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Needs an NVIDIA GPU and nvcc; skips elsewhere. Run on the
card with: python -m pytest tests/test_torch_kernels_cuda.py -q"""

import pytest
import torch

from palu_tpu_torch.core.quant import QuantConfig, pack_codes_t, packed_nrows, quantize_affine
from palu_tpu_torch.ops.cache_append import append_token_quantized, append_token_quantized_ref
from palu_tpu_torch.ops.palu_decode import palu_decode, palu_decode_ref
from palu_tpu_torch.ops.prefill_flash import prefill_flash, prefill_flash_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("kw", [dict(bits=3, sym=True, container=4), dict(bits=4, sym=False),
                                dict(bits=2, sym=True), dict(bits=8, sym=False, clip_ratio=0.9)])
def test_append_kernel_bit_exact(gen, kw):
    qcfg, b, g, rank, s_max = QuantConfig(**kw), 3, 2, 64, 256
    codes = torch.randint(0, 256, (b, g, packed_nrows(rank, qcfg.pack_bits), s_max),
                          generator=gen, device="cuda", dtype=torch.uint8)
    scale = torch.rand((b, g, 1, s_max), generator=gen, device="cuda")
    zero = None if qcfg.sym else torch.rand((b, g, 1, s_max), generator=gen, device="cuda")
    lat = torch.randn((b, g, rank), generator=gen, device="cuda")
    pos = torch.tensor([0, 100, 255], dtype=torch.int32, device="cuda")
    wr = torch.tensor([True, True, False], device="cuda")
    ref = [t.clone() if t is not None else None for t in (codes, scale, zero)]
    n = append_token_quantized.launches
    append_token_quantized(lat, codes, scale, pos, wr, qcfg=qcfg, rank=rank, zero=zero)
    assert append_token_quantized.launches == n + 1
    append_token_quantized_ref(lat, *ref[:2], pos, wr, qcfg=qcfg, rank=rank, zero=ref[2])
    for got, want in zip((codes, scale, zero), ref):
        assert got is None or torch.equal(got, want)


@pytest.mark.parametrize("kw,window", [(dict(bits=3, sym=True, container=4), None),
                                       (dict(bits=3, sym=False), None),
                                       (dict(bits=4, sym=True), 100)])
def test_decode_kernel_matches_plain(gen, kw, window):
    qcfg, b, g, hpg, rk, rv, hd, s_max = QuantConfig(**kw), 2, 2, 4, 32, 64, 128, 512
    q = torch.randn((b, g * hpg, hd), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, hd), generator=gen, device="cuda") * 0.2).bfloat16()
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        c, s, z = quantize_affine(torch.randn((b, g, s_max, r), generator=gen, device="cuda"),
                                  qcfg)
        bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = s[..., 0].contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = z[..., 0].contiguous()
    kv_len = torch.tensor([1, 300], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, sliding_window=window)
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()


@pytest.mark.parametrize("nh,nkv,window", [(4, 4, None), (4, 2, None), (4, 4, 40),
                                            (28, 4, None)])
def test_prefill_kernel_matches_plain(gen, nh, nkv, window):
    """MHA, GQA, a window, and Qwen2-7B's 28 q-heads over 4 kv-heads."""
    b, cq, s, hd = 2, 96, 256, 128
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((b, nh, cq, hd), (b, nkv, s, hd), (b, nkv, s, hd)))
    off = torch.tensor([0, 150], dtype=torch.int32, device="cuda")
    got = prefill_flash(q, k, v, off, off + cq, sliding_window=window).float()
    want = prefill_flash_ref(q.float(), k.float(), v.float(), off, off + cq,
                             sliding_window=window)
    assert (got - want).abs().max() <= (2e-3 + 2.0**-9) * want.abs().max()


def _wq(gen, bits, k, n):
    from palu_tpu_torch.core import wquant

    w = torch.randn((k, n), generator=gen, device="cuda") * 0.05
    return wquant.quantize_weight4(w) if bits == 4 else wquant.quantize_weight(w)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemv_kernels_match_plain(gen, bits, rows, dtype):
    from palu_tpu_torch.ops import gemv_int4, gemv_int8

    mod = gemv_int4 if bits == 4 else gemv_int8
    gemv, gemv_ref = getattr(mod, f"gemv_int{bits}"), getattr(mod, f"gemv_int{bits}_ref")
    mlp, mlp_ref = getattr(mod, f"mlp_gemv_int{bits}"), getattr(mod, f"mlp_gemv_int{bits}_ref")
    h, inter, n = 1024, 768, 384
    x = torch.randn((rows, h), generator=gen, device="cuda").to(dtype)
    w = _wq(gen, bits, h, n)
    n0 = gemv.launches
    got, want = gemv(x, w), gemv_ref(x, w)
    assert gemv.launches == n0 + 1 and got.dtype == dtype
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    wg, wu, wd = _wq(gen, bits, h, inter), _wq(gen, bits, h, inter), _wq(gen, bits, inter, h)
    got, want = mlp(x, wg, wu, wd), mlp_ref(x, wg, wu, wd)
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    assert torch.equal(mlp(x, wg, wu, wd), got)  # fixed-order split sums repeat


# Qwen2-7B's GEMV widths (K, N): q_proj, the U_v-fused o_proj of 28 heads at
# rank 256, lm_head, VT_k / VT_v of its one group at rank 256
QWEN2_GEMV = [(3584, 3584), (7168, 3584), (3584, 152064), (3584, 256)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kn", QWEN2_GEMV, ids=["q_proj", "w_fused", "lm_head", "vt"])
def test_gemv_kernels_at_qwen2_widths(gen, bits, kn):
    from palu_tpu_torch.ops import gemv_int4, gemv_int8

    mod = gemv_int4 if bits == 4 else gemv_int8
    gemv, gemv_ref = getattr(mod, f"gemv_int{bits}"), getattr(mod, f"gemv_int{bits}_ref")
    k, n = kn
    w = _wq(gen, bits, k, n)
    for rows in (1, 8):
        x = torch.randn((rows, k), generator=gen, device="cuda").bfloat16()
        got, want = gemv(x, w).float(), gemv_ref(x, w).float()
        assert (got - want).abs().max() <= 2.0**-7 * want.abs().max()


@pytest.mark.parametrize("bits", [4, 8])
def test_mlp_kernels_at_qwen2_widths(gen, bits):
    """The fused SwiGLU MLP at Qwen2-7B's H 3584, I 18944."""
    from palu_tpu_torch.ops import gemv_int4, gemv_int8

    mod = gemv_int4 if bits == 4 else gemv_int8
    mlp, mlp_ref = getattr(mod, f"mlp_gemv_int{bits}"), getattr(mod, f"mlp_gemv_int{bits}_ref")
    h, inter = 3584, 18944
    ws = (_wq(gen, bits, h, inter), _wq(gen, bits, h, inter), _wq(gen, bits, inter, h))
    for rows in (1, 8):
        x = torch.randn((rows, h), generator=gen, device="cuda").bfloat16()
        got, want = mlp(x, *ws).float(), mlp_ref(x, *ws).float()
        assert (got - want).abs().max() <= 2.0**-7 * want.abs().max()


@pytest.mark.parametrize("rows", [1, 8])
def test_gemv_int8_transposed_head_matches_plain(gen, rows):
    from palu_tpu_torch.core import wquant
    from palu_tpu_torch.ops.gemv_int8 import gemv_int8, gemv_int8_ref

    emb = wquant.quantize_embed(torch.randn((1024, 512), generator=gen, device="cuda"))
    head = wquant.tied_head({"embed": emb})
    assert head["wq8"].stride(0) == 1  # read in place, not copied
    x = torch.randn((rows, 512), generator=gen, device="cuda").bfloat16()
    got, want = gemv_int8(x, head), gemv_int8_ref(x, head)
    assert (got.float() - want.float()).abs().max() <= 2.0**-7 * want.float().abs().max()


# (lanes, kv_len per lane, window, heads per group): chip_smoke's fp cases
FP_CASES = [(1, (8000,), None, 4), (2, (777, 8192), 1024, 4),
            (8, (1, 63, 64, 65, 1000, 4097, 8000, 8192), None, 4), (2, (777, 8192), None, 16)]


@pytest.mark.parametrize("rank_major", [False, True], ids=["seq_major", "rank_major"])
@pytest.mark.parametrize("case", range(len(FP_CASES)))
def test_decode_fp_kernels_match_plain(gen, case, rank_major):
    """Both unquantized-cache decode kernels at the 7B shapes (G 8 x hpg 4
    or G 2 x hpg 16, rk 128, rv 384, hd 128) over an 8192-token cache."""
    from palu_tpu_torch.ops import palu_decode_fp as mod

    lanes, kvl, window, hpg = FP_CASES[case]
    g, s_max = 32 // hpg, 8192
    q = torch.randn((lanes, g * hpg, 128), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, 128, 128), generator=gen, device="cuda") / 11.3).bfloat16()
    lat = [torch.randn((lanes, g, s_max, r), generator=gen, device="cuda").bfloat16()
           for r in (128, 384)]
    fn, ref = mod.palu_decode_fp, mod.palu_decode_fp_ref
    if rank_major:
        fn, ref = mod.palu_decode_fp_t, mod.palu_decode_fp_t_ref
        lat = [x.transpose(-1, -2).contiguous() for x in lat]
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n = fn.launches
    got = fn(q, b_k, *lat, kv_len, sliding_window=window)
    assert fn.launches == n + 1
    want = ref(q, b_k, *lat, kv_len, sliding_window=window)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()


@pytest.mark.parametrize("rank_major", [False, True], ids=["seq_major", "rank_major"])
def test_serving_engine_on_card(gen, rank_major):
    """ServingEngine over an unquantized cache on the card: every request
    finishes with its tokens, decode runs the fp kernel once per layer and
    step, and a sampled request stays in the vocabulary."""
    from palu_tpu_torch.models import llama
    from palu_tpu_torch.models.config import ModelConfig
    from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_t
    from palu_tpu_torch.runtime.engine import EngineConfig
    from palu_tpu_torch.runtime.sampling import SamplingParams
    from palu_tpu_torch.runtime.serving import ServingEngine

    layers = 2
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [32] * 4
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [64] * 4
    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=8,
                      head_group_size=2, head_wise_ranks=ranks)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16)
    srv = ServingEngine(params, cfg, EngineConfig(s_max=256, batch=2, decode_chunk=64, qcfg=None,
                                                  rank_major_fp=rank_major),
                        prefill_chunks_per_step=1)
    rng = torch.Generator().manual_seed(1)
    n_new = {1: 5, 2: 9, 3: 4}
    for rid, n in n_new.items():
        prompt = torch.randint(0, 512, (1, 40 * rid), generator=rng).numpy()
        sp = SamplingParams(temperature=1.0, top_k=16) if rid == 2 else None
        assert srv.submit(rid, prompt, n, sampling=sp)
    fn = palu_decode_fp_t if rank_major else palu_decode_fp
    steps = [0]
    decode = srv.engine.decode

    def counted(*a, **kw):
        steps[0] += 1
        return decode(*a, **kw)

    srv.engine.decode = counted
    n0 = fn.launches
    out = srv.run_until_done(max_steps=200)
    assert {r: len(t) for r, t in out.items()} == n_new
    assert all(0 <= t < 512 for toks in out.values() for t in toks)
    assert srv.sched.stats() == {"admitted": 3, "finished": 3, "tokens": sum(n_new.values())}
    assert srv.engine._decode_paths == {f"{fn.__name__}-kernel"}
    assert fn.launches - n0 == layers * steps[0] > 0


def _packed_case(gen, layout, qcfg, b, g, hpg, rk, rv, hd, s_max):
    """q, b_k and one packed cache: seq-major (quantize + pack_codes, for
    palu_decode_seq_quantized) or rank-major (quantize_affine + pack_codes_t)."""
    from palu_tpu_torch.core.quant import pack_codes, quantize

    q = torch.randn((b, g * hpg, hd), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, hd), generator=gen, device="cuda") / rk**0.5).bfloat16()
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = torch.randn((b, g, s_max, r), generator=gen, device="cuda")
        if layout == "seq":
            c, s, z = quantize(x, qcfg)
            bufs.update({f"x{side}_codes": pack_codes(c, qcfg.pack_bits).contiguous(),
                         f"x{side}_scales": s.contiguous(), f"x{side}_base": z.contiguous()})
        else:
            c, s, z = quantize_affine(x, qcfg)
            bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
            bufs[f"x{side}_scale"] = s[..., 0].contiguous()
            if not qcfg.sym:
                bufs[f"x{side}_zero"] = z[..., 0].contiguous()
    return q, b_k, bufs


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("window", [None, 300])
def test_decode_seq_kernel_matches_plain(gen, bits, sym, window):
    """The seq-major packed decode at the 7B group shapes (hpg 4, rk 128,
    rv 384, hd 128) over 2 lanes of a 1024-token cache."""
    from palu_tpu_torch.ops.palu_decode_seq import (palu_decode_seq_quantized,
                                                    palu_decode_seq_quantized_ref)

    qcfg = QuantConfig(bits=bits, sym=sym)
    q, b_k, bufs = _packed_case(gen, "seq", qcfg, 2, 2, 4, 128, 384, 128, 1024)
    kv_len = torch.tensor([77, 1024], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=128, rv=384, sliding_window=window)
    n = palu_decode_seq_quantized.launches
    got = palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert palu_decode_seq_quantized.launches == n + 1
    want = palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()


@pytest.mark.parametrize("mode", ["int8_dots", "int8_rot"])
@pytest.mark.parametrize("block_s", [64, 512])
@pytest.mark.parametrize("sym", [True, False])
def test_decode_int8_modes_match_plain(gen, mode, block_s, sym):
    """Both int8 K-path modes on 2 lanes at the 7B group shapes: within
    2e-3 of the plain version (an operand value on a rounding tie may take
    the neighbouring int8 code) and within the JAX tests' class of the
    exact kernel."""
    qcfg = QuantConfig(bits=3, sym=sym, container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 2, 2, 4, 128, 384, 128, 1024)
    kv_len = torch.tensor([300, 1024], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=128, rv=384, sliding_window=None if sym else 700,
              block_s=block_s)
    n = palu_decode.mode_launches[mode]
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, **{mode: True})
    assert palu_decode.mode_launches[mode] == n + 1
    want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, **{mode: True})
    exact = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()
    atol, rtol = (4e-2, 2e-2) if mode == "int8_dots" else (8e-2, 4e-2)
    assert torch.allclose(got, exact, atol=atol, rtol=rtol)
    with pytest.raises(ValueError):  # a 64-token tile would straddle two blocks
        palu_decode(q, b_k, kv_len=kv_len, **bufs, **dict(kw, block_s=32), **{mode: True})


# group ranks of a compressed 7B model: 512 is group_dim at group size 4 and
# hd 128, and ranks that are not a multiple of 128 end the K rebuild in a
# partial rank chunk (192 = 128 + 64, 288, 352, 416); (rk, rv, G, heads per
# group)
BIG_RANKS = [(256, 384, 2, 4), (512, 512, 2, 4), (512, 512, 2, 16), (256, 256, 1, 16),
             (192, 192, 2, 4), (288, 320, 2, 4), (352, 384, 2, 4), (416, 448, 2, 4)]


@pytest.mark.parametrize("rk,rv,g,hpg", BIG_RANKS)
def test_decode_kernels_at_large_ranks(gen, rk, rv, g, hpg):
    """Every decode kernel at group ranks above 128 (the rank chunks of
    their K rebuild) against its plain version over 2 lanes of a 1024-token
    cache: palu_decode exact and int8_dots, int8_rot below rk 280 (from 280
    the int32 overflow check raises, as in JAX), the two fp kernels and the
    seq-major packed one."""
    from palu_tpu_torch.ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref,
                                                   palu_decode_fp_t, palu_decode_fp_t_ref)
    from palu_tpu_torch.ops.palu_decode_seq import (palu_decode_seq_quantized,
                                                    palu_decode_seq_quantized_ref)

    kv_len = torch.tensor([300, 1024], dtype=torch.int32, device="cuda")

    def close(got, want):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-3 * want.abs().max()

    qcfg = QuantConfig(bits=3, sym=True, container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 2, g, hpg, rk, rv, 128, 1024)
    kw = dict(qcfg=qcfg, rk=rk, rv=rv)
    close(palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
          palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))
    for mode in ("int8_dots", "int8_rot"):
        mk = dict(kw, block_s=512, **{mode: True})
        if mode == "int8_rot" and rk >= 280:  # 63 * 127 * 15 * rk * 64 >= 2^31
            with pytest.raises(ValueError, match="overflow"):
                palu_decode(q, b_k, kv_len=kv_len, **bufs, **mk)
            continue
        close(palu_decode(q, b_k, kv_len=kv_len, **bufs, **mk),
              palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **mk))
    lat = [torch.randn((2, g, 1024, r), generator=gen, device="cuda").bfloat16()
           for r in (rk, rv)]
    close(palu_decode_fp(q, b_k, *lat, kv_len), palu_decode_fp_ref(q, b_k, *lat, kv_len))
    lat_t = [x.transpose(-1, -2).contiguous() for x in lat]
    close(palu_decode_fp_t(q, b_k, *lat_t, kv_len), palu_decode_fp_t_ref(q, b_k, *lat_t, kv_len))
    sq = QuantConfig(bits=3, sym=False)
    q, b_k, bufs = _packed_case(gen, "seq", sq, 2, g, hpg, rk, rv, 128, 1024)
    kw = dict(qcfg=sq, rk=rk, rv=rv)
    close(palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
          palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw))


def test_decode_kernels_refuse_ranks_above_512(gen):
    qcfg = QuantConfig(bits=3, sym=True, container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 1, 1, 4, 528, 64, 128, 128)
    kv_len = torch.tensor([128], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="512"):
        palu_decode(q, b_k, kv_len=kv_len, **bufs, qcfg=qcfg, rk=528, rv=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 256), (512, 352), (512, 480), (4096, 512), (37, 96),
                                   (3, 5, 128), (64, 4096), (8, 3904)])
def test_hadamard_kernel_matches_plain(gen, shape, dtype):
    """The FWHT kernel at fuse_hadamard's shapes (VT_g^T (4096, r), U_g
    (512, r)), at JAX's test sizes and at n 4096 and 3904 (K 244), both
    orientations of H_K, TF32 off, against the plain version in f32 on the
    same input: within 1e-5 of max|plain| in f32, and one bf16 rounding more
    (2e-3 + 2^-9) in bf16."""
    from palu_tpu_torch.ops.hadamard import hadamard_transform, hadamard_transform_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 1e-5 if dtype == torch.float32 else 2e-3 + 2.0**-9
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    for transpose in (False, True):
        n = hadamard_transform.launches
        got = hadamard_transform(x, transpose=transpose)
        assert hadamard_transform.launches == n + 1
        want = hadamard_transform_ref(x.float(), transpose=transpose)
        assert got.dtype == dtype and got.shape == x.shape
        assert (got.float() - want).abs().max() <= tol * want.abs().max()
    with pytest.raises(ValueError, match="4096"):
        hadamard_transform(torch.zeros((2, 8192), device="cuda"))


def test_fuse_hadamard_on_card_matches_cpu(gen):
    """core/lowrank.fuse_hadamard on CUDA factors (two kernel launches per
    group) against the CPU's formulation of the same factors."""
    from palu_tpu_torch.core import lowrank
    from palu_tpu_torch.ops.hadamard import hadamard_transform

    w = torch.randn((1024, 4096), generator=gen, device="cuda") * 0.02
    lr = lowrank.decompose_svd(w, [256, 160])
    n = hadamard_transform.launches
    fused = lowrank.fuse_hadamard(lr)
    assert hadamard_transform.launches == n + 4
    cpu = lowrank.fuse_hadamard(lowrank.LowRankWeights(
        VT=lr.VT.cpu(), U=[u.cpu() for u in lr.U], ranks=lr.ranks))
    assert (fused.VT.cpu() - cpu.VT).abs().max() <= 1e-5 * cpu.VT.abs().max()
    assert (fused.reconstruct_dense() - lr.reconstruct_dense()).abs().max() <= \
        1e-4 * lr.reconstruct_dense().abs().max()


def _k_bias(gen, g, hpg, hd=128):
    """A pre-RoPE K bias of Qwen2's size class: 0.3 N(0, 1), as JAX's kernel
    tests draw it, in the engine's bf16."""
    return (torch.randn((g, hpg, hd), generator=gen, device="cuda") * 0.3).bfloat16()


# (G, heads per group, rk, rv): the Llama shape (G 8 x hpg 4 cut to 2
# groups) and Qwen2-7B's one group of 28 q-heads at ranks 256
BIAS_SHAPES = {"llama_g2_hpg4": (2, 4, 128, 384), "qwen2_g1_hpg28": (1, 28, 256, 256)}


@pytest.mark.parametrize("shape", list(BIAS_SHAPES))
@pytest.mark.parametrize("mode", ["exact", "int8_dots", "int8_rot"])
def test_decode_k_bias_matches_plain(gen, shape, mode):
    """palu_decode with Qwen2's K bias in each K-path mode, and (with the
    exact mode) both fp kernels, against their plain versions over 2 lanes of
    a 1024-token cache; 28 heads per group runs past the old 16-head limit."""
    from palu_tpu_torch.ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref,
                                                   palu_decode_fp_t, palu_decode_fp_t_ref)

    g, hpg, rk, rv = BIAS_SHAPES[shape]
    qcfg = QuantConfig(bits=3, sym=mode != "int8_rot", container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 2, g, hpg, rk, rv, 128, 1024)
    kb = _k_bias(gen, g, hpg)
    kv_len = torch.tensor([300, 1024], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=512, k_bias=kb,
              **({} if mode == "exact" else {mode: True}))
    n, nb = palu_decode.launches, palu_decode.k_bias_launches
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert (palu_decode.launches, palu_decode.k_bias_launches) == (n + 1, nb + 1)
    want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()
    unbiased = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **dict(kw, k_bias=None))
    assert (got - unbiased).abs().max() > 1e-2 * want.abs().max()
    if mode != "exact":
        return
    lat = [torch.randn((2, g, 1024, r), generator=gen, device="cuda").bfloat16()
           for r in (rk, rv)]
    lat_t = [x.transpose(-1, -2).contiguous() for x in lat]
    for fn, ref, x in ((palu_decode_fp, palu_decode_fp_ref, lat),
                       (palu_decode_fp_t, palu_decode_fp_t_ref, lat_t)):
        got, want = fn(q, b_k, *x, kv_len, k_bias=kb), ref(q, b_k, *x, kv_len, k_bias=kb)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-3 * want.abs().max(), fn.__name__


def _chunked_case(gen, qcfg, b, g, hpg, rk, rv, s_max):
    """q, b_k and a rank-major per-chunk cache: scale / zero row stacks
    (B, G, rank // group_size, S)."""
    q = torch.randn((b, g * hpg, 128), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, 128), generator=gen, device="cuda") / rk**0.5).bfloat16()
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        c, s, z = quantize_affine(torch.randn((b, g, s_max, r), generator=gen, device="cuda"),
                                  qcfg)
        bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = s.transpose(-1, -2).contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = z.transpose(-1, -2).contiguous()
    return q, b_k, bufs


@pytest.mark.parametrize("gs", [8, 16, 32])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "k_bias"])
def test_decode_chunked_matches_plain(gen, gs, sym, bias):
    """palu_decode over per-chunk scales (the exact K path with a fold per
    scale chunk; chunks of 8 split a k-step) against its plain version:
    the Llama shape at chunks 8 / 16 (rk 128, rv 384) and Qwen2-7B's one
    group of 28 heads at chunk 32 (rk = rv = 256)."""
    g, hpg, rk, rv = (1, 28, 256, 256) if gs == 32 else (2, 4, 128, 384)
    qcfg = QuantConfig(bits=3, group_size=gs, sym=sym, container=4)
    q, b_k, bufs = _chunked_case(gen, qcfg, 2, g, hpg, rk, rv, 1024)
    kv_len = torch.tensor([500, 1024], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, k_bias=_k_bias(gen, g, hpg) if bias else None)
    n = palu_decode.mode_launches["chunked"]
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert palu_decode.mode_launches["chunked"] == n + 1
    want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()
    for mode in ("int8_dots", "int8_rot"):  # JAX's asserts: per-row scales only
        with pytest.raises(ValueError):
            palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, block_s=512, **{mode: True})


ROPE_SCALING = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 4096},
}


def _rope_kw(scaling):
    import numpy as np

    from palu_tpu_torch.models import rope as rope_mod
    from palu_tpu_torch.models.config import ModelConfig

    inv_freq, scale = rope_mod.inv_freq_and_scale(ModelConfig(
        hidden_size=4096, num_attention_heads=32, num_key_value_heads=32,
        rope_scaling=ROPE_SCALING[scaling]))
    return dict(inv_freq=np.asarray(inv_freq, np.float32), rope_scale=float(scale))


@pytest.mark.parametrize("scaling", list(ROPE_SCALING))
def test_decode_kernels_scaled_rope_match_plain(gen, scaling):
    """Every decode kernel with scaled-RoPE tables (llama3; yarn, whose
    attention scale is not 1) against its plain version on the same tables:
    palu_decode in its three modes, palu_decode_fp, palu_decode_fp_t and
    palu_decode_seq_quantized, at the 7B group shapes over 2 lanes."""
    from palu_tpu_torch.ops.palu_decode_fp import (palu_decode_fp, palu_decode_fp_ref,
                                                   palu_decode_fp_t, palu_decode_fp_t_ref)
    from palu_tpu_torch.ops.palu_decode_seq import (palu_decode_seq_quantized,
                                                    palu_decode_seq_quantized_ref)

    rope = _rope_kw(scaling)
    assert (rope["rope_scale"] != 1.0) == (scaling == "yarn")
    kv_len = torch.tensor([300, 1024], dtype=torch.int32, device="cuda")

    def close(got, want, what):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-3 * want.abs().max(), what

    qcfg = QuantConfig(bits=3, sym=True, container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 2, 2, 4, 128, 384, 128, 1024)
    for mode in ("exact", "int8_dots", "int8_rot"):
        kw = dict(qcfg=qcfg, rk=128, rv=384, block_s=512, **rope,
                  **({} if mode == "exact" else {mode: True}))
        close(palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
              palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw), mode)
    lat = [torch.randn((2, 2, 1024, r), generator=gen, device="cuda").bfloat16()
           for r in (128, 384)]
    close(palu_decode_fp(q, b_k, *lat, kv_len, **rope),
          palu_decode_fp_ref(q, b_k, *lat, kv_len, **rope), "fp")
    lat_t = [x.transpose(-1, -2).contiguous() for x in lat]
    close(palu_decode_fp_t(q, b_k, *lat_t, kv_len, **rope),
          palu_decode_fp_t_ref(q, b_k, *lat_t, kv_len, **rope), "fp_t")
    sq = QuantConfig(bits=3, sym=False)
    q, b_k, bufs = _packed_case(gen, "seq", sq, 2, 2, 4, 128, 384, 128, 1024)
    kw = dict(qcfg=sq, rk=128, rv=384, **rope)
    close(palu_decode_seq_quantized(q, b_k, kv_len=kv_len, **bufs, **kw),
          palu_decode_seq_quantized_ref(q, b_k, kv_len=kv_len, **bufs, **kw), "seq")


# ---- the probes (palu_tpu_torch/tools): each kernel against its plain
# version, at a small size and at the JAX tools' own

@pytest.mark.parametrize("size", ["small", "tool"])
@pytest.mark.parametrize("mode", ["full", "novalue", "nologits", "dmaonly", "noop"])
def test_dissect_modes_match_plain(gen, size, mode):
    """Each dissection mode against its plain version; full bit-identical
    to palu_decode_fp on the same inputs."""
    from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp
    from palu_tpu_torch.tools import dissect

    if size == "small":
        b, g, hpg, rk, rv, hd, s = 2, 2, 4, 32, 64, 64, 512
        q = torch.randn((b, g * hpg, hd), generator=gen, device="cuda").bfloat16()
        b_k = (torch.randn((g, hpg, rk, hd), generator=gen, device="cuda") * 0.1).bfloat16()
        x_k, x_v = (torch.randn((b, g, s, r), generator=gen, device="cuda").bfloat16()
                    for r in (rk, rv))
        kv_len = torch.tensor([300, 512], dtype=torch.int32, device="cuda")
        ops = (q, b_k, x_k, x_v, kv_len)
    else:
        x = dissect.make_inputs(65536, torch.device("cuda"), gen)
        ops = (x["q"], x["b_k"], x["x_k"], x["x_v"], x["kv_len"])
    n0 = dissect.palu_decode_fp_dissect.launches
    got = dissect.palu_decode_fp_dissect(mode, *ops)
    assert dissect.palu_decode_fp_dissect.launches == n0 + 1
    ref = dissect.dissect_ref(mode, *ops)
    if mode in ("dmaonly", "noop"):
        assert torch.equal(got.cpu(), ref["checksum"].cpu())
    elif mode == "novalue":
        for i in (0, 1):
            want = ref["stats"][..., i]
            assert (got[..., i] - want).abs().max() <= 2e-3 * want.abs().max()
    else:
        assert (got - ref["out"]).abs().max() <= 2e-3 * ref["out"].abs().max()
    if mode == "full":
        assert torch.equal(got, palu_decode_fp(*ops))


@pytest.mark.parametrize("probe", ["bs1024", "bs4096", "merged1024", "konly1024", "bs64"])
@pytest.mark.parametrize("seq", [4096, 65536])
def test_stream_probe_matches_plain(gen, probe, seq):
    from palu_tpu_torch.tools import stream_probe as sp

    x = sp.make_inputs(seq, torch.device("cuda"), gen)
    arrays, rows, tile = sp._kernel_probe(probe, x)
    c = torch.rand((8, 128), generator=gen, device="cuda")
    out, ck = sp.stream_probe(c, arrays, rows, tile)
    want_out, want_ck = sp.stream_probe_ref(c, arrays, rows)
    assert torch.equal(out, want_out) and torch.equal(ck, want_ck)


@pytest.mark.parametrize("variant", ["base", "ext4nc", "ext4cc", "ext4mm", "ext4ccmm", "ext3nc",
                                     "ext3cc", "conv8"])
@pytest.mark.parametrize("size", ["small", "tool"])
def test_unpack_probe_matches_plain(gen, variant, size):
    from palu_tpu_torch.tools import unpack_probe as up

    if size == "small":
        seq, bs, kw = 1024, 256, dict(rk=32, rv=64, bs=256)
        g = 2
        codes = {"ext3nc": (3 * 32 // 8, 3 * 64 // 8), "ext3cc": (12, 24), "conv8": (32, 64)}
        rows = codes.get(variant, (16, 32))
        dt = torch.int8 if variant == "conv8" else torch.uint8
        lo = -127 if variant == "conv8" else 0
        kc, vc = (torch.randint(lo, 127 if lo else 255, (g, r, seq), generator=gen,
                                device="cuda").to(dt) for r in rows)
        b1 = (torch.randn((g, 32, 16), generator=gen, device="cuda") * 0.1).bfloat16()
        p = (torch.randn((g, bs, 8), generator=gen, device="cuda") * 0.1).bfloat16()
        ops = (kc, vc, b1, p) if variant in ("ext4mm", "ext4ccmm") else (kc, vc)
    else:
        kw = dict(rk=up.RK, rv=up.RV, bs=1024)
        ops = [t for t in up._operands(variant, up.make_inputs(65536, 1024,
                                                               torch.device("cuda"), gen))
               if t is not None]
    got = up.unpack_probe(variant, *ops, **kw)
    want = up.unpack_probe_ref(variant, *ops, **kw)
    if variant in ("ext4mm", "ext4ccmm"):
        assert (got - want).abs().max() <= up.MM_TOL * want.abs().max()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("kn,bn", [((512, 1024), 64), ((4096, 4096), 512), ((4096, 4096), 128),
                                   ((4096, 11008), 256)])
def test_gemv_bf16_kernels_match_plain(gen, rows, kn, bn):
    """The blocked bf16 GEMV and its W^T twin; the split sums repeat."""
    from palu_tpu_torch.tools import gemv_probe as gp

    k, n = kn
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
    wt = w.t().contiguous()
    x = (torch.randn((rows, k), generator=gen, device="cuda") * 0.1).bfloat16()
    want = gp.gemv_bf16_ref(x, w).float()
    for got in (gp.gemv_bf16(x, w, bn), gp.gemv_bf16_t(x, wt, bn)):
        assert (got.float() - want).abs().max() <= gp.GEMV_TOL * want.abs().max()
    assert torch.equal(gp.gemv_bf16(x, w, bn), gp.gemv_bf16(x, w, bn))
