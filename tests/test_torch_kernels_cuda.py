"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Needs an NVIDIA GPU and nvcc; skips elsewhere. Run on the
card with: python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
(the prefill and GEMV kernels alone: -k "prefill or gemv")."""

import itertools

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


# (nh, nkv, hd, cq, keys, lane offsets, kv_len below offset + cq by, window):
# hd 64; chunks of 1, 63, 65 and 200 rows at offsets that put the causal
# diagonal inside a 128-key tile; kv_len short of the chunk's end (padded
# tail rows); a window smaller than one key tile; 7 q-heads per kv-head
PREFILL_EDGES = {
    "hd64": (4, 2, 64, 96, 256, (0, 150), 0, None),
    "cq1": (4, 4, 128, 1, 512, (0, 300), 0, None),
    "cq63": (4, 2, 128, 63, 512, (37, 301), 0, None),
    "cq65": (4, 4, 128, 65, 512, (5, 190), 0, None),
    "cq200": (4, 1, 128, 200, 640, (0, 411), 0, None),
    "kv_short": (4, 2, 128, 200, 512, (20, 250), 57, None),
    "window40": (4, 4, 128, 200, 512, (0, 277), 0, 40),
    "window40_hd64": (4, 2, 64, 65, 512, (100, 333), 0, 40),
    "gqa7": (28, 4, 128, 65, 512, (0, 200), 0, None),
    "gqa7_short": (28, 4, 128, 130, 512, (70, 250), 33, 100),
}


@pytest.mark.parametrize("case", list(PREFILL_EDGES))
def test_prefill_kernel_edges_match_plain(gen, case):
    """The wgmma kernel's tile edges against the plain version. K and V hold
    NaN at and past kv_len (a cache may hold anything there): those keys
    must contribute nothing, and the padded tail rows stay finite."""
    nh, nkv, hd, cq, s, offs, short, window = PREFILL_EDGES[case]
    b = len(offs)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((b, nh, cq, hd), (b, nkv, s, hd), (b, nkv, s, hd)))
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl = off + cq - short
    past = torch.arange(s, device="cuda")[None, None, :, None] >= kvl[:, None, None, None].long()
    want = prefill_flash_ref(q.float(), k.float(), v.float(), off, kvl, sliding_window=window)
    n0 = prefill_flash.launches
    got = prefill_flash(q, k.masked_fill(past, float("nan")), v.masked_fill(past, float("nan")),
                        off, kvl, sliding_window=window).float()
    assert prefill_flash.launches == n0 + 1
    assert torch.isfinite(got).all()
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
    assert torch.equal(gemv(x, w), got)  # fixed-order sums repeat
    wg, wu, wd = _wq(gen, bits, h, inter), _wq(gen, bits, h, inter), _wq(gen, bits, inter, h)
    got, want = mlp(x, wg, wu, wd), mlp_ref(x, wg, wu, wd)
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    assert torch.equal(mlp(x, wg, wu, wd), got)  # fixed-order split sums repeat


@pytest.mark.parametrize("kn", [(128, 128), (128, 512), (1152, 256), (1152, 128), (4096, 384)],
                         ids=["k128_n128", "k128", "k1152", "k1152_n128", "k4096"])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemv_int4_edge_shapes(gen, kn, rows, dtype):
    """One group (K 128), an odd group count (K 1152: 9 groups, which no
    split of the contraction divides evenly), one column block (N 128);
    every row count in both dtypes; two calls bit-identical (the splits are
    added in a fixed order)."""
    from palu_tpu_torch.ops.gemv_int4 import gemv_int4, gemv_int4_ref

    k, n = kn
    # quantize_weight4 would shrink the group below 128 rows at these K
    # (it wants K % 256 == 0): codes and scales of 128-row groups directly
    w = {"wq4": torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.uint8),
         "ws": torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-3}
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    got, want = gemv_int4(x, w), gemv_int4_ref(x, w)
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == dtype and got.shape == (rows, n)
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    assert torch.equal(gemv_int4(x, w), got)


def _w4_groups(gen, k, n):
    """int4 codes and scales of 128-row groups built directly (quantize_weight4
    shrinks the group below 128 rows unless K % 256 == 0)."""
    return {"wq4": torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                                 dtype=torch.uint8),
            "ws": torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-3}


def _held_twice(fn, args, want, dtype):
    """fn(*args) within the class of its plain version (2^-7 of max|plain| in
    bf16, 1e-5 in f32), in x's type, and bit-identical on a second call."""
    got = fn(*args)
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == dtype and got.shape == want.shape and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    assert torch.equal(fn(*args), got)


# (H, I) of the MLP: 1, 9 and 86 groups on either side
MLP4_EDGES = {"h1_i1": (128, 128), "h9_i1": (1152, 128), "h1_i86": (128, 86 * 128),
              "h86_i1": (86 * 128, 128), "h9_i9": (1152, 1152), "h9_i86": (1152, 86 * 128)}


@pytest.mark.parametrize("shape", list(MLP4_EDGES))
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("route", ["stream_bf16", "split_bf16", "split_f32"])
def test_mlp_gemv_int4_edge_shapes(gen, monkeypatch, shape, rows, route):
    """The streaming MLP and the split pass (each bf16 shape on both routes,
    whichever use_stream_mlp picks; f32 always splits) at H and I of 1, 9
    and 86 groups, every row count; two calls bit-identical (the cluster's
    K splits are added in rank order)."""
    from palu_tpu_torch.ops import gemv_int4 as g4
    from palu_tpu_torch.ops.gemv_int4 import mlp_gemv_int4, mlp_gemv_int4_ref

    dtype = torch.float32 if route == "split_f32" else torch.bfloat16
    monkeypatch.setattr(g4, "use_stream_mlp", lambda h, i, rows: route == "stream_bf16")
    h, inter = MLP4_EDGES[shape]
    ws = (_w4_groups(gen, h, inter), _w4_groups(gen, h, inter), _w4_groups(gen, inter, h))
    x = torch.randn((rows, h), generator=gen, device="cuda").to(dtype)
    n0 = mlp_gemv_int4.launches
    _held_twice(mlp_gemv_int4, (x, *ws), mlp_gemv_int4_ref(x, *ws), dtype)
    assert mlp_gemv_int4.launches == n0 + 2


# (K, N) of gemv_int8: K of 128, 1000 (not a multiple of 128), 1152 and 4096
INT8_EDGES = {"k128_n128": (128, 128), "k1000_n1024": (1000, 1024), "k1152_n3072": (1152, 3072),
              "k4096_n128": (4096, 128), "k4096_n1024": (4096, 1024),
              "k4096_n3072": (4096, 3072)}


@pytest.mark.parametrize("shape", list(INT8_EDGES))
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("route", ["stream_bf16", "split_bf16", "split_f32"])
def test_gemv_int8_edge_shapes(gen, monkeypatch, shape, rows, route):
    """The streaming GEMV and the split pass (each bf16 shape on both routes,
    whichever use_stream picks; f32 always splits) at K 128, 1000, 1152 and
    4096 and N 128, 1024 and 3072, every row count; two calls bit-identical."""
    from palu_tpu_torch.ops import gemv_int8 as g8
    from palu_tpu_torch.ops.gemv_int8 import gemv_int8, gemv_int8_ref

    dtype = torch.float32 if route == "split_f32" else torch.bfloat16
    monkeypatch.setattr(g8, "use_stream", lambda k, n, rows: route == "stream_bf16")
    k, n = INT8_EDGES[shape]
    w = _wq(gen, 8, k, n)
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    n0 = gemv_int8.launches
    _held_twice(gemv_int8, (x, w), gemv_int8_ref(x, w), dtype)
    assert gemv_int8.launches == n0 + 2


@pytest.mark.parametrize("kn", [(4096, 1024), (4096, 3072), (4096, 4096), (12288, 4096),
                                (4096, 32000), (3584, 3584), (7168, 3584), (3584, 256),
                                (3584, 152064)],
                         ids=["vt_k", "vt_v", "q_proj", "w_fused", "lm_head", "qwen2_q_proj",
                              "qwen2_w_fused", "qwen2_vt", "qwen2_lm_head"])
def test_gemv_int8_stream_at_model_widths(gen, monkeypatch, kn):
    """The streaming GEMV at Llama-2-7B's and Qwen2-7B's int8 shapes, rows 1-8
    (whatever use_stream would pick), bit-identical on a second call."""
    from palu_tpu_torch.ops import gemv_int8 as g8

    monkeypatch.setattr(g8, "use_stream", lambda k, n, rows: True)
    w = _wq(gen, 8, *kn)
    for rows in range(1, 9):
        x = torch.randn((rows, kn[0]), generator=gen, device="cuda").bfloat16()
        _held_twice(g8.gemv_int8, (x, w), g8.gemv_int8_ref(x, w), torch.bfloat16)


# Streaming int8 plans whose blocks own several column blocks in turn (N over
# two blocks per SM x 128 columns: Qwen2-7B's untied lm_head from 2 rows), a
# K range of tiles that is not a multiple of the consumer warps (K 4160), and
# VT_v's clusters at 8 rows: (K, N, rows)
INT8_REPEATS = {"qwen2_lm_head": (3584, 152064, (2, 3, 4, 5)),
                "k1024_n76800": (1024, 600 * 128, (1, 4, 8)),
                "k4160_n76800": (4160, 600 * 128, (1, 4)),
                "k4096_n3072": (4096, 3072, (8,))}


@pytest.mark.parametrize("case", list(INT8_REPEATS))
def test_gemv_int8_stream_repeats(gen, monkeypatch, case):
    """The streaming GEMV held against its plain version and bit-identical
    over 24 calls on the same inputs."""
    from palu_tpu_torch.ops import gemv_int8 as g8

    monkeypatch.setattr(g8, "use_stream", lambda k, n, rows: True)
    k, n, rows_list = INT8_REPEATS[case]
    w = _wq(gen, 8, k, n)
    for rows in rows_list:
        assert g8.gemv8_plan(132, k, n, rows) is not None
        x = torch.randn((rows, k), generator=gen, device="cuda").bfloat16()
        _held_twice(g8.gemv_int8, (x, w), g8.gemv_int8_ref(x, w), torch.bfloat16)
        got = g8.gemv_int8(x, w)
        for _ in range(22):
            assert torch.equal(g8.gemv_int8(x, w), got)


@pytest.mark.parametrize("hi", [(4096, 11008), (3584, 18944)], ids=["llama", "qwen2"])
def test_mlp_gemv_int4_stream_repeats(gen, monkeypatch, hi):
    """The streaming MLP at Llama-2-7B's and Qwen2-7B's widths, rows 1, 2, 5
    and 8 (where it has a plan), bit-identical over 24 calls."""
    from palu_tpu_torch.ops import gemv_int4 as g4

    monkeypatch.setattr(g4, "use_stream_mlp", lambda h, i, rows: True)
    h, inter = hi
    ws = (_w4_groups(gen, h, inter), _w4_groups(gen, h, inter), _w4_groups(gen, inter, h))
    for rows in (1, 2, 5, 8):
        x = torch.randn((rows, h), generator=gen, device="cuda").bfloat16()
        _held_twice(g4.mlp_gemv_int4, (x, *ws), g4.mlp_gemv_int4_ref(x, *ws), torch.bfloat16)
        got = g4.mlp_gemv_int4(x, *ws)
        for _ in range(22):
            assert torch.equal(g4.mlp_gemv_int4(x, *ws), got)


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_stream_smem_matches_kernel_layout(gen, kind):
    """ops/gemv_int8.stream_smem mirrors ring::Layout."""
    from palu_tpu_torch.ops import build
    from palu_tpu_torch.ops.gemv_int8 import stream_smem

    fn = build.launcher("gemv_int8", "palu_gemv_stream_smem", "iii")
    for rows in (1, 3, 8):
        for units in (1, 7, 64):
            assert fn(kind, rows, units) == stream_smem(kind, rows, units)


def test_stream_plans_fit_the_card(gen):
    """The card's cluster capacity is at most the model's, and the plans at
    Llama-2-7B's shapes keep one cluster per column block within it."""
    from palu_tpu_torch.ops import gemv_int4 as g4
    from palu_tpu_torch.ops import gemv_int8 as g8

    dev = torch.device("cuda")
    sms = g8.device_sms(dev)
    caps = {k: g8.device_capacity(dev, k) for k in (0, 1, 2)}
    for k, cap in caps.items():
        assert all(0 < c <= m for c, m in zip(cap, g8.model_capacity(sms)))
    for kn in ((4096, 1024), (4096, 3072), (4096, 4096), (12288, 4096), (4096, 32000)):
        c, grid = g8.gemv8_plan(sms, *kn, 1, caps[2])
        assert grid // c <= caps[2][g8.CLUSTERS.index(c)]
    plans = g4.mlp_plan(sms, 4096, 11008, 1, (caps[0], caps[1]))
    for kind, (c, grid) in zip((0, 1), plans):
        assert grid // c <= caps[kind][g8.CLUSTERS.index(c)]


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


# every K that get_hadK gives at the compress path's ranks and past them
# (1, 12, 28, 36, 40, 44, 52, 60; n 4096 for K 1), at row counts that are
# not a multiple of the kernels' rows per block
HAD_K_NS = [256, 4096, 96, 384, 448, 288, 320, 352, 416, 480, 1920, 24, 80, 160]


@pytest.mark.parametrize("rows", [1, 3, 37, 4097])
@pytest.mark.parametrize("n", HAD_K_NS)
def test_hadamard_every_k_matches_plain(gen, n, rows):
    """Each kernel of hadamard_plan (fwht for K 1, mix for the K the sign
    masks cover) at every K, both orientations, f32 and bf16, against the
    plain version in f32 on the same input (1e-5 of max|plain| in f32, one
    bf16 rounding more in bf16); the plan's kind is the one the CPU tests
    emulate."""
    from palu_tpu_torch.core.hadamard import get_hadK
    from palu_tpu_torch.ops.hadamard import (MIX_KS, hadamard_plan, hadamard_transform,
                                             hadamard_transform_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    _, k = get_hadK(n)
    assert hadamard_plan(n)["kind"] == ("fwht" if k == 1 else "mix") and (k == 1 or k in MIX_KS)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3 + 2.0**-9)):
        x = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
        for transpose in (False, True):
            got = hadamard_transform(x, transpose=transpose)
            want = hadamard_transform_ref(x.float(), transpose=transpose)
            assert got.dtype == dtype and torch.isfinite(got).all()
            assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("n", [352, 480, 256, 4096])
def test_hadamard_repeats(gen, n):
    """24 calls on one input give bit-identical outputs."""
    from palu_tpu_torch.ops.hadamard import hadamard_transform

    x = torch.randn((37, n), generator=gen, device="cuda")
    first = hadamard_transform(x)
    assert all(torch.equal(hadamard_transform(x), first) for _ in range(24))


def test_hadamard_unaligned_rows(gen):
    """A view that starts off a 16-byte boundary is copied before the
    kernels' 16-byte reads."""
    from palu_tpu_torch.ops.hadamard import hadamard_transform, hadamard_transform_ref

    base = torch.randn((9, 352), generator=gen, device="cuda")
    x = base.view(-1)[1:1 + 8 * 352].view(8, 352)
    assert x.data_ptr() % 16
    want = hadamard_transform_ref(x)
    assert (hadamard_transform(x) - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("kn,bn", [((4096, 4096), 512), ((4096, 1024), 512), ((512, 1024), 64),
                                   ((4096, 11008), 256), ((12288, 4096), 512), ((520, 1000), 16),
                                   ((24, 40), 16), ((4096, 4096), 16)])
def test_gemv_bf16_t_stream_matches_plain(gen, rows, kn, bn):
    """The one-launch W^T GEMV at 1-8 rows: the tool's shape, the bf16
    kernels test's, the int8 path's VT_k / w_fused shapes (VT_k: blocks of
    16 warps), the MLP's 11008 (two column blocks a block), a contraction
    that ends inside a 32-value unit (520), column blocks past N (1000,
    40), bn 16."""
    from palu_tpu_torch.tools import gemv_probe as gp

    k, n = kn
    wt = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
    x = (torch.randn((rows, k), generator=gen, device="cuda") * 0.1).bfloat16()
    want = gp.gemv_bf16_t_ref(x, wt).float()
    c0 = gp.gemv_bf16_t.launches
    got = gp.gemv_bf16_t(x, wt, bn)
    assert gp.gemv_bf16_t.launches == c0 + 1
    assert got.shape == (rows, n) and torch.isfinite(got).all()
    assert (got.float() - want).abs().max() <= gp.GEMV_TOL * want.abs().max()


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 1024), (4096, 32000)])
@pytest.mark.parametrize("rows", [1, 8])
def test_gemv_bf16_t_stream_repeats(gen, kn, rows):
    """24 calls give bit-identical outputs: each column block's ranges are
    added in a fixed order; 4096 x 32000 makes a block own four column
    blocks, 4096 x 1024 splits the contraction over 16 warps."""
    from palu_tpu_torch.tools import gemv_probe as gp

    k, n = kn
    wt = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
    x = (torch.randn((rows, k), generator=gen, device="cuda") * 0.1).bfloat16()
    first = gp.gemv_bf16_t(x, wt)
    assert all(torch.equal(gp.gemv_bf16_t(x, wt), first) for _ in range(24))


def test_gemv_bf16_t_refuses(gen):
    """Shapes and knobs the kernel does not take raise before a launch."""
    from palu_tpu_torch.tools import gemv_probe as gp

    x = torch.zeros((9, 64), dtype=torch.bfloat16, device="cuda")
    wt = torch.zeros((32, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        gp.gemv_bf16_t(x, wt)  # 9 rows
    with pytest.raises(ValueError):
        gp.gemv_bf16_t(x[:1], wt, bn=24)  # bn not a multiple of 16
    with pytest.raises(ValueError):
        gp.gemv_bf16_t(x[:1, :60].contiguous(), wt[:, :60].contiguous())  # K % 8


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
    """Each dissection mode against its plain version; full (the split
    kernel that served palu_decode_fp before csrc/palu_decode_fp_wg.cu)
    also within 2e-3 of palu_decode_fp's plain version."""
    from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp_ref
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
    if mode == "full":  # the pre-redesign split kernel, against palu_decode_fp's plain version
        want = palu_decode_fp_ref(*ops)
        assert (got - want).abs().max() <= 2e-3 * want.abs().max()


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


# ---- the archived v2 / v3 decodes and the W8A8 MLP (palu_tpu_torch.tools
# ab_v2 / mlp_a8_probe): each kernel against its plain version, at a small
# size and at the tools' own

ARCHIVE_SIZES = {"small": (2, 2, 4, 32, 64, 1024), "tool": (1, 8, 4, 128, 384, 65536)}


def _archive_case(gen, size, kvl, bits, rope, sym=False):
    """q, b_k, bf16 latents and the v2 / v3 packed caches of one size
    (b, g, hpg, rk, rv, S), with kv_len kvl and the rope keywords."""
    from palu_tpu_torch.ops.archive.palu_decode3 import sz_pack

    b, g, hpg, rk, rv, s = ARCHIVE_SIZES[size]
    q = torch.randn((b, g * hpg, 128), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, 128), generator=gen, device="cuda") * 0.1).bfloat16()
    x_k, x_v = (torch.randn((b, g, s, r), generator=gen, device="cuda").bfloat16()
                for r in (rk, rv))
    qcfg = QuantConfig(bits=bits, sym=sym)
    packed = {}
    for side, x in (("k", x_k), ("v", x_v)):
        c, sc, z = quantize_affine(x, qcfg)
        packed[side] = (pack_codes_t(c, bits).contiguous(), sc[..., 0].contiguous(),
                        z[..., 0].contiguous())
    kv_len = torch.tensor(kvl[:b], dtype=torch.int32, device="cuda")
    return {"q": q, "b_k": b_k, "x_k": x_k, "x_v_t": x_v.transpose(2, 3).contiguous(),
            "v2q": (*packed["k"], *packed["v"]),
            "v3q": (packed["k"][0], sz_pack(*packed["k"][1:]), packed["v"][0],
                    sz_pack(*packed["v"][1:])),
            "kv_len": kv_len, "qcfg": qcfg, "rk": rk, "rv": rv, "rope": rope}


def _held_decode(got, want):
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()


@pytest.mark.parametrize("size,kvl", [("small", (300, 1024)), ("tool", (65536,)),
                                      ("tool", (40000,))])
@pytest.mark.parametrize("rope", ["theta", "llama3"])
def test_decode2_bf16_kernel_matches_plain(gen, size, kvl, rope):
    from palu_tpu_torch.ops.archive.palu_decode2 import palu_decode2, palu_decode2_ref

    x = _archive_case(gen, size, kvl, 3, {} if rope == "theta" else _rope_kw(rope))
    ops = (x["q"], x["b_k"], x["x_k"], x["x_v_t"], x["kv_len"])
    n0 = palu_decode2.launches
    got = palu_decode2(*ops, **x["rope"])
    assert palu_decode2.launches == n0 + 1
    _held_decode(got, palu_decode2_ref(*ops, **x["rope"]))


@pytest.mark.parametrize("size,kvl", [("small", (300, 1024)), ("tool", (65536,)),
                                      ("tool", (40000,))])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("gen_", ["v2q", "v3q"])
def test_decode2_decode3_quantized_kernels_match_plain(gen, size, kvl, bits, gen_):
    from palu_tpu_torch.ops.archive import palu_decode2 as d2, palu_decode3 as d3

    x = _archive_case(gen, size, kvl, bits, {}, sym=bits == 4)
    fn, ref = ((d2.palu_decode2_quantized, d2.palu_decode2_quantized_ref) if gen_ == "v2q"
               else (d3.palu_decode3_quantized, d3.palu_decode3_quantized_ref))
    kw = dict(qcfg=x["qcfg"], rk=x["rk"], rv=x["rv"], block_s=1024)
    ops = (x["q"], x["b_k"], *x[gen_], x["kv_len"])
    n0 = fn.launches
    got = fn(*ops, **kw)
    assert fn.launches == n0 + 1
    _held_decode(got, ref(*ops, **kw))


@pytest.mark.parametrize("rope", ["llama3", "yarn"])
@pytest.mark.parametrize("gen_", ["v2q", "v3q"])
def test_decode2_decode3_scaled_rope_and_window(gen, rope, gen_):
    """Scaled RoPE (llama3; yarn, whose attention scale is not 1), a
    sliding window and a rotation block of 256 on the small shape."""
    from palu_tpu_torch.ops.archive import palu_decode2 as d2, palu_decode3 as d3

    x = _archive_case(gen, "small", (300, 1024), 3, _rope_kw(rope))
    fn, ref = ((d2.palu_decode2_quantized, d2.palu_decode2_quantized_ref) if gen_ == "v2q"
               else (d3.palu_decode3_quantized, d3.palu_decode3_quantized_ref))
    kw = dict(qcfg=x["qcfg"], rk=x["rk"], rv=x["rv"], block_s=256, sliding_window=200,
              **x["rope"])
    ops = (x["q"], x["b_k"], *x[gen_], x["kv_len"])
    _held_decode(fn(*ops, **kw), ref(*ops, **kw))


@pytest.mark.parametrize("rows,hi,bn", [(1, (256, 512), 128), (4, (512, 1024), 64),
                                        (8, (256, 384), 128), (1, (4096, 11008), 256)])
def test_mlp_a8_kernel_matches_plain(gen, rows, hi, bn):
    from palu_tpu_torch.tools import mlp_a8_probe as p

    dev = torch.device("cuda")
    h, inter = hi
    x = (torch.randn((rows, h), generator=gen, device=dev) * 0.1).bfloat16()
    w = [p.qw(gen, shape, dev) for shape in ((h, inter), (h, inter), (inter, h))]
    n0 = p.mlp_a8.launches
    got = p.mlp_a8(x, *w, bn=bn, codes=True)
    assert p.mlp_a8.launches == n0 + 1
    held = p.held_codes(got, p.mlp_a8_ref(x, *w, bn=bn, codes=True))
    assert held["ok"], held
    assert torch.equal(p.mlp_a8(x, *w, bn=bn), got[0])


def _stacked_packed(gen, qcfg, n_layers, b, g, rk, rv, s_max):
    """An (L, B, G, ...) stack of rank-major packed caches: per-row scales
    squeezed to (L, B, G, S), per-chunk row stacks (L, B, G, n_sc, S)."""
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        x = torch.randn((n_layers, b, g, s_max, r), generator=gen, device="cuda")
        c, s, z = quantize_affine(x, qcfg)
        rows = (lambda t: t.transpose(-1, -2)) if qcfg.group_size else (lambda t: t[..., 0])
        bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = rows(s).contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = rows(z).contiguous()
    return bufs


def _held_stats(got, want, tol=2e-3):
    """(acc, m, l) of a kernel against its plain version: acc and l within
    tol of their max, m within tol of max|m| on the rows with a valid
    column and exactly -1e30 (l = 0, acc = 0) on the others."""
    (acc, m, l), (wacc, wm, wl) = got, want
    empty = wl == 0
    assert torch.equal(l == 0, empty)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    assert (acc - wacc).abs().max() <= tol * wacc.abs().max()
    assert (l - wl).abs().max() <= tol * wl.abs().max()
    assert bool((m[empty] == -1e30).all()) and bool((acc[empty] == 0).all())
    assert (m[~empty] - wm[~empty]).abs().max() <= tol * wm[~empty].abs().max()


# the packed decode's modes: (QuantConfig, int8 knob)
FEATURE_MODES = {"exact": (QuantConfig(bits=3, sym=True, container=4), None),
                 "exact_asym": (QuantConfig(bits=4, sym=False), None),
                 "int8_dots": (QuantConfig(bits=3, sym=True, container=4), "int8_dots"),
                 "int8_rot": (QuantConfig(bits=3, sym=False, container=4), "int8_rot"),
                 "chunked": (QuantConfig(bits=3, group_size=32, sym=False, container=4), None)}


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "k_bias"])
@pytest.mark.parametrize("mode", list(FEATURE_MODES))
def test_decode_features_match_plain(gen, mode, bias):
    """pos_offset, return_stats and layer_idx in every mode of the packed
    decode, with and without the K bias, at the 7B group shapes: an L = 2
    stack of 1024-column shards at offset 1024 with kv_len (1700, 900) (the
    second lane's shard holds no valid column), against the plain version;
    each layer bit-identical to the per-layer call; the features counted."""
    from palu_tpu_torch.ops.palu_decode import FEATURES

    qcfg, knob = FEATURE_MODES[mode]
    b, g, hpg, rk, rv, s_loc, off = 2, 2, 4, 128, 384, 1024, 1024
    q = torch.randn((b, g * hpg, 128), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, 128), generator=gen, device="cuda") / rk**0.5).bfloat16()
    k_bias = (torch.randn((g, hpg, 128), generator=gen, device="cuda") * 0.3
              ).bfloat16().float() if bias else None
    bufs = _stacked_packed(gen, qcfg, 2, b, g, rk, rv, s_loc)
    kv_len = torch.tensor([1700, 900], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=512, k_bias=k_bias, **({knob: True} if knob
                                                                       else {}))
    before = dict(palu_decode.feature_launches)
    for li in range(2):
        got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, pos_offset=off,
                          return_stats=True, layer_idx=li)
        want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, pos_offset=off,
                               return_stats=True, layer_idx=li)
        _held_stats(got, want)
        one = {k: v[li].contiguous() for k, v in bufs.items()}
        alone = palu_decode(q, b_k, kv_len=kv_len, **one, **kw, pos_offset=off,
                            return_stats=True)
        for x, y in zip(got, alone):
            assert torch.equal(x, y)
        norm = palu_decode(q, b_k, kv_len=kv_len, **one, **kw, pos_offset=off)
        plain = palu_decode_ref(q, b_k, kv_len=kv_len, **one, **kw, pos_offset=off)
        assert (norm[0] - plain[0]).abs().max() <= 2e-3 * plain[0].abs().max()
    after = palu_decode.feature_launches
    assert {f: after[f] - before[f] for f in FEATURES} == {
        "pos_offset": 6, "return_stats": 4, "layer_idx": 2}


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "k_bias"])
def test_decode_fp_t_features_match_plain(gen, bias):
    from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp_t, palu_decode_fp_t_ref

    b, g, hpg, rk, rv, s_loc, off = 2, 8, 4, 128, 384, 1024, 1024
    q = torch.randn((b, g * hpg, 128), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, hpg, rk, 128), generator=gen, device="cuda") / 11.3).bfloat16()
    k_bias = (torch.randn((g, hpg, 128), generator=gen, device="cuda") * 0.3
              ).bfloat16().float() if bias else None
    lat = [torch.randn((2, b, g, r, s_loc), generator=gen, device="cuda").bfloat16()
           for r in (rk, rv)]
    kv_len = torch.tensor([1700, 900], dtype=torch.int32, device="cuda")
    for li in range(2):
        got = palu_decode_fp_t(q, b_k, *lat, kv_len, k_bias=k_bias, pos_offset=off,
                               return_stats=True, layer_idx=li)
        want = palu_decode_fp_t_ref(q, b_k, *lat, kv_len, k_bias=k_bias, pos_offset=off,
                                    return_stats=True, layer_idx=li)
        _held_stats(got, want)
        alone = palu_decode_fp_t(q, b_k, *(x[li].contiguous() for x in lat), kv_len,
                                 k_bias=k_bias, pos_offset=off, return_stats=True)
        for x, y in zip(got, alone):
            assert torch.equal(x, y)


def test_decode_shards_combine_to_one_call(gen):
    """Four 2048-column shards through the kernel with pos_offset and
    return_stats, merged with the flash-decoding combine, against the
    one-call kernel over the 8192-column cache."""
    qcfg = QuantConfig(bits=3, sym=True, container=4)
    q, b_k, bufs = _packed_case(gen, "rank", qcfg, 1, 8, 4, 128, 384, 128, 8192)
    kv_len = torch.tensor([7000], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=128, rv=384)
    whole = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    parts = [palu_decode(q, b_k, kv_len=kv_len, pos_offset=r * 2048, return_stats=True,
                         **{k: v[..., r * 2048:(r + 1) * 2048].contiguous()
                            for k, v in bufs.items()}, **kw) for r in range(4)]
    m_g = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m_g) for p in parts]
    l_g = sum(wi * p[2] for wi, p in zip(w, parts))
    acc_g = sum(wi[..., None] * p[0] for wi, p in zip(w, parts))
    got = acc_g / l_g[..., None]
    assert (got - whole).abs().max() <= 2e-3 * whole.abs().max()


# ---------------------------------------------------------------------------
# The exact decode kernel (csrc/palu_decode_exact.cu): its edges, the compact
# GQA form, layer stacks, head dims, pack widths, scale chunks and ranks.
# ---------------------------------------------------------------------------


def _exact_case(gen, qcfg, b, g, hpg, nkv, rk, rv, s_max, hd=128, n_layers=None):
    """q, a compact b_k (G, nkv, rk, hd) with a K bias of the same form, and a
    rank-major packed cache (per-row or per-chunk rows; an (L, ...) stack
    when n_layers is given)."""
    q = torch.randn((b, g * hpg, hd), generator=gen, device="cuda").bfloat16()
    b_k = (torch.randn((g, nkv, rk, hd), generator=gen, device="cuda") / rk**0.5).bfloat16()
    k_bias = (torch.randn((g, nkv, hd), generator=gen, device="cuda") * 0.3).bfloat16().float()
    lead = () if n_layers is None else (n_layers,)
    bufs = {}
    for side, r in (("k", rk), ("v", rv)):
        c, s, z = quantize_affine(torch.randn(lead + (b, g, s_max, r), generator=gen,
                                              device="cuda"), qcfg)
        rows = (lambda t: t.transpose(-1, -2)) if qcfg.group_size else (lambda t: t[..., 0])
        bufs[f"x{side}_codes"] = pack_codes_t(c, qcfg.pack_bits).contiguous()
        bufs[f"x{side}_scale"] = rows(s).contiguous()
        if not qcfg.sym:
            bufs[f"x{side}_zero"] = rows(z).contiguous()
    return q, b_k, k_bias, bufs


def _close(got, want, tol=2e-3):
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= tol * want.abs().max()


FLAG = QuantConfig(bits=3, sym=True, container=4)
# (kv_len per lane, S, window, pos_offset): the tile edges, an S that is not a
# multiple of the 64-token tile, a window, and a shard at offset 1024 whose
# second lane's kv_len lies before it (no valid column: m -1e30, l 0)
EXACT_EDGES = {"tile_edges": ((1, 63, 64, 65, 1024), 1024, None, None),
               "s_1008": ((1008, 1000, 17), 1008, None, None),
               "window": ((1008, 700, 64), 1008, 100, None),
               "shard": ((3000, 900), 1024, None, 1024)}


@pytest.mark.parametrize("case", list(EXACT_EDGES))
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "k_bias"])
def test_exact_decode_edges_match_plain(gen, case, bias):
    kvl, s_max, window, off = EXACT_EDGES[case]
    q, b_k, kb, bufs = _exact_case(gen, FLAG, len(kvl), 2, 4, 4, 128, 384, s_max)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    kw = dict(qcfg=FLAG, rk=128, rv=384, sliding_window=window, k_bias=kb if bias else None,
              pos_offset=off, return_stats=off is not None)
    n = palu_decode.mode_launches["exact"]
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert palu_decode.mode_launches["exact"] == n + 1
    want = palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw)
    if off is None:
        _close(got, want)
    else:
        _held_stats(got, want)


@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("qkw", [dict(bits=3, sym=True, container=4),
                                 dict(bits=3, group_size=32, sym=False, container=4)],
                         ids=["per_row", "chunk32_asym"])
def test_exact_decode_compact_gqa(gen, rep, qkw):
    """The compact b_k / k_bias (4 kv-heads per group, rep q-heads each)
    against the plain version (which expands it) and against the kernel on
    JAX's repeated form; rep 7 is Qwen2-7B's group (28 q-heads, ranks 256)."""
    qcfg = QuantConfig(**qkw)
    rk = rv = 256 if rep == 7 else 128
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, 1, 4 * rep, 4, rk, rv, 1024)
    kv_len = torch.tensor([1024, 333], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv)
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, k_bias=kb)
    _close(got, palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, k_bias=kb))
    rep_b, rep_kb = b_k.repeat_interleave(rep, 1), kb.repeat_interleave(rep, 1)
    _close(got, palu_decode(q, rep_b, kv_len=kv_len, **bufs, **kw, k_bias=rep_kb))


@pytest.mark.parametrize("qkw", [dict(bits=3, sym=True, container=4),
                                 dict(bits=4, group_size=16, sym=False)], ids=["row", "chunk16"])
def test_exact_decode_layer_idx(gen, qkw):
    """layer_idx on an L = 4 stack: each layer bit-identical to the
    per-layer call and within 2e-3 of the plain version."""
    qcfg = QuantConfig(**qkw)
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, 2, 8, 4, 128, 384, 1024, n_layers=4)
    kv_len = torch.tensor([1024, 500], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=128, rv=384, k_bias=kb)
    for li in range(4):
        got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, layer_idx=li)
        one = {k: v[li].contiguous() for k, v in bufs.items()}
        assert torch.equal(got, palu_decode(q, b_k, kv_len=kv_len, **one, **kw))
        _close(got, palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, layer_idx=li))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("qkw", [dict(bits=2, sym=True), dict(bits=3, sym=False),
                                 dict(bits=3, sym=True, container=4), dict(bits=4, sym=True),
                                 dict(bits=8, sym=False)],
                         ids=["pack2", "pack3", "pack4_3bit", "pack4", "pack8"])
def test_exact_decode_head_dims_and_packs(gen, hd, qkw):
    qcfg = QuantConfig(**qkw)
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, 2, 4, 4, 64, 128, 1024, hd=hd)
    kv_len = torch.tensor([1024, 700], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=64, rv=128, k_bias=kb, sliding_window=300)
    _close(palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
           palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))


@pytest.mark.parametrize("gs", [8, 16, 32])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
def test_exact_decode_scale_chunks(gen, gs, sym):
    """Per-chunk scales: chunks of 8 end inside a k-step; rk 192 puts a
    scale chunk across the 128-rank chunks of B."""
    qcfg = QuantConfig(bits=3, group_size=gs, sym=sym, container=4)
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, 2, 8, 4, 192, 128, 1024)
    kv_len = torch.tensor([1024, 411], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=192, rv=128, k_bias=kb)
    n = palu_decode.mode_launches["chunked"]
    got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw)
    assert palu_decode.mode_launches["chunked"] == n + 1
    _close(got, palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))


@pytest.mark.parametrize("rk,rv", [(16, 16), (48, 80), (112, 512), (144, 384), (240, 256),
                                   (512, 512)])
def test_exact_decode_ranks(gen, rk, rv):
    """rk from 16 to 512 (B resident or streamed in rank chunks) and rv up
    to 512, asym per-row scales, 4 kv-heads of 2 q-heads."""
    qcfg = QuantConfig(bits=3, sym=False, container=4)
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, 2, 8, 4, rk, rv, 1024)
    kv_len = torch.tensor([1024, 641], dtype=torch.int32, device="cuda")
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, k_bias=kb)
    _close(palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw),
           palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw))


def test_exact_decode_refuses_what_does_not_fit(gen):
    """Chunks of 8 at rk = rv = 512, asym: 128 scale rows per token and
    side, a tile ring past a block's shared memory: raises, no fallback."""
    qcfg = QuantConfig(bits=3, group_size=8, sym=False, container=4)
    q, b_k, _, bufs = _exact_case(gen, qcfg, 1, 1, 4, 4, 512, 512, 256)
    kv_len = torch.tensor([256], dtype=torch.int32, device="cuda")
    n = palu_decode.launches
    with pytest.raises(ValueError, match="shared memory"):
        palu_decode(q, b_k, kv_len=kv_len, **bufs, qcfg=qcfg, rk=512, rv=512)
    assert palu_decode.launches == n


# ---------------------------------------------------------------------------
# The int8 K-path modes' kernel (csrc/palu_decode_i8.cu): its plan against
# the Python mirror, head dims, ranks, pack widths, heads per group, the
# compact b_k / K bias, and lanes whose valid tiles start inside a rotation
# block (windows; the one-wave splits cut every lane into items of a few
# tiles). Features (shards, return_stats, layer_idx) and the 7B shapes: the
# tests above that take every mode.
# ---------------------------------------------------------------------------


def test_i8_plan_matches_python_mirror(gen):
    """The kernel's shared-memory plan (palu_decode_i8_plan) is the Python
    mirror's (_i8_plan): bytes, stages, operand slots, staging buffers of B,
    heads per chunk."""
    import ctypes

    from palu_tpu_torch.ops import build
    from palu_tpu_torch.ops.palu_decode import _i8_plan

    fn = build.launcher("palu_decode_i8", "palu_decode_i8_plan", "i" * 9 + "p")
    for hd, rk, rv, hpg in [(128, 128, 384, 4), (128, 128, 384, 16), (128, 256, 256, 28),
                            (128, 512, 512, 16), (64, 32, 64, 4), (128, 96, 320, 8),
                            (128, 128, 128, 4)]:
        for mode, asym, bias in itertools.product((1, 2), (0, 1), (0, 1)):
            nrk, nrv = packed_nrows(rk, 4), packed_nrows(rv, 4)
            out = (ctypes.c_int * 5)()
            fn(hd, rk, rv, hpg, nrk, nrv, asym, mode, bias, ctypes.addressof(out))
            want = _i8_plan(hd, rk, rv, hpg, nrk, nrv, bool(asym), mode, bool(bias))
            if want is None:  # no plan fits: the kernel refuses too
                assert out[0] == -1, (hd, rk, rv, hpg, mode, asym, bias)
                continue
            assert list(out) == [want[k] for k in ("smem", "ns", "nob", "nst", "chunk")], \
                (hd, rk, rv, hpg, mode, asym, bias)


# (hd, rk, rv, G, q-heads per group, kv-heads per group, QuantConfig kwargs, K bias)
I8_CASES = {
    "hd64": (64, 64, 128, 2, 4, 4, dict(bits=3, sym=True, container=4), False),
    "rk32": (128, 32, 64, 2, 4, 4, dict(bits=4, sym=False), True),
    "rk96": (128, 96, 320, 2, 4, 4, dict(bits=3, sym=True, container=4), False),
    "rk256": (128, 256, 384, 2, 4, 4, dict(bits=3, sym=True, container=4), True),
    "pack2": (128, 128, 256, 2, 4, 4, dict(bits=2, sym=True), False),
    "pack3": (128, 128, 256, 2, 4, 4, dict(bits=3, sym=False), False),
    "heads16": (128, 128, 384, 2, 16, 16, dict(bits=3, sym=True, container=4), False),
    "heads28_compact": (128, 256, 256, 1, 28, 4, dict(bits=3, sym=True, container=4), True),
    "heads16_compact_asym": (128, 128, 384, 2, 16, 8, dict(bits=3, sym=False, container=4),
                             True),
}


@pytest.mark.parametrize("case", list(I8_CASES))
@pytest.mark.parametrize("mode", ["int8_dots", "int8_rot"])
def test_i8_decode_matches_plain(gen, case, mode):
    """Each case over 2 lanes of a 1024-token cache in rotation blocks of
    128: one lane full, one windowed so that its valid tiles start inside a
    block (kv_len 1000, window 300: column 700), against the plain version
    within 2e-3 of max|plain|; the launch counted in its mode."""
    hd, rk, rv, g, hpg, nkv, qkw, bias = I8_CASES[case]
    qcfg = QuantConfig(**qkw)
    q, b_k, kb, bufs = _exact_case(gen, qcfg, 2, g, hpg, nkv, rk, rv, 1024, hd=hd)
    kw = dict(qcfg=qcfg, rk=rk, rv=rv, block_s=128, k_bias=kb if bias else None,
              **{mode: True})
    for kvl, window in (((1024, 1000), 300), ((1024, 517), None)):
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        n = palu_decode.mode_launches[mode]
        got = palu_decode(q, b_k, kv_len=kv_len, **bufs, **kw, sliding_window=window)
        assert palu_decode.mode_launches[mode] == n + 1
        _close(got, palu_decode_ref(q, b_k, kv_len=kv_len, **bufs, **kw, sliding_window=window))


# ---------------------------------------------------------------------------
# The bf16 latent decode kernel (csrc/palu_decode_fp_wg.cu) behind
# palu_decode_fp (seq-major) and palu_decode_fp_t (rank-major): its edges,
# the compact GQA form, head dims, ranks, q-heads per group and q dtypes.
# ---------------------------------------------------------------------------

LAYOUTS = ["seq_major", "rank_major"]


def _fp_case(gen, b, g, hpg, nkv, rk, rv, s_max, hd=128, layout="seq_major", q_dtype=None,
             n_layers=None):
    """q, a b_k (G, nkv, rk, hd) with a K bias of the same form, and bf16
    latents in the layout (an (L, ...) stack when n_layers is given); the
    wrapper and the plain version of that layout."""
    from palu_tpu_torch.ops import palu_decode_fp as mod

    q = torch.randn((b, g * hpg, hd), generator=gen, device="cuda").to(q_dtype or torch.bfloat16)
    b_k = (torch.randn((g, nkv, rk, hd), generator=gen, device="cuda") / rk**0.5).bfloat16()
    k_bias = (torch.randn((g, nkv, hd), generator=gen, device="cuda") * 0.3).bfloat16().float()
    lead = () if n_layers is None else (n_layers,)
    lat = [torch.randn(lead + (b, g, s_max, r), generator=gen, device="cuda").bfloat16()
           for r in (rk, rv)]
    if layout == "rank_major":
        lat = [x.transpose(-1, -2).contiguous() for x in lat]
        return q, b_k, k_bias, lat, mod.palu_decode_fp_t, mod.palu_decode_fp_t_ref
    return q, b_k, k_bias, lat, mod.palu_decode_fp, mod.palu_decode_fp_ref


# (kv_len per lane, S, window): the tile edges at 8 lanes with kv_len well
# under S (the splits cut the valid tiles, not S's), an S that is not a
# multiple of the 64-token tile, and a window
FP_EDGES = {"lanes8_short": ((1, 63, 64, 65, 130, 700, 1000, 2048), 4096, None),
            "s_1000": ((1000, 999, 17), 1000, None),
            "window": ((1000, 640, 64), 1024, 100)}


@pytest.mark.parametrize("case", list(FP_EDGES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fp_wg_edges_match_plain(gen, layout, case):
    kvl, s_max, window = FP_EDGES[case]
    q, b_k, kb, lat, fn, ref = _fp_case(gen, len(kvl), 2, 4, 4, 128, 384, s_max, layout=layout)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n = fn.launches
    got = fn(q, b_k, *lat, kv_len, sliding_window=window, k_bias=kb)
    assert fn.launches == n + 1
    _close(got, ref(q, b_k, *lat, kv_len, sliding_window=window, k_bias=kb))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fp_wg_compact_gqa(gen, layout, rep, q_dtype):
    """The compact b_k / k_bias (4 kv-heads per group, rep q-heads each)
    against the plain version (which expands it) and against the kernel on
    JAX's repeated form; rep 7 is Qwen2-7B's group (28 q-heads, ranks 256)."""
    rk = rv = 256 if rep == 7 else 128
    q, b_k, kb, lat, fn, ref = _fp_case(gen, 2, 1, 4 * rep, 4, rk, rv, 1024, layout=layout,
                                        q_dtype=q_dtype)
    kv_len = torch.tensor([1024, 333], dtype=torch.int32, device="cuda")
    got = fn(q, b_k, *lat, kv_len, k_bias=kb)
    _close(got, ref(q, b_k, *lat, kv_len, k_bias=kb))
    _close(got, fn(q, b_k.repeat_interleave(rep, 1), *lat, kv_len,
                   k_bias=kb.repeat_interleave(rep, 1)))


@pytest.mark.parametrize("rk,rv", [(16, 16), (48, 80), (112, 512), (144, 384), (240, 256),
                                   (512, 512)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fp_wg_head_dims_and_ranks(gen, layout, hd, rk, rv):
    """rk 16 to 512 (B resident or streamed; a partial last rank chunk), rv
    up to 512, hd 64 and 128, 4 kv-heads of 2 q-heads, with the K bias."""
    q, b_k, kb, lat, fn, ref = _fp_case(gen, 2, 2, 8, 4, rk, rv, 1024, hd=hd, layout=layout)
    kv_len = torch.tensor([1024, 641], dtype=torch.int32, device="cuda")
    _close(fn(q, b_k, *lat, kv_len, k_bias=kb), ref(q, b_k, *lat, kv_len, k_bias=kb))


@pytest.mark.parametrize("hpg,nkv", [(1, 1), (3, 3), (12, 3), (32, 1), (32, 32), (28, 4)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fp_wg_heads_per_group(gen, layout, hpg, nkv):
    """1 to 32 q-heads per group over 1 to 32 kv-heads: the consumers split
    the q-heads by kv-heads, or inside one kv-head when a half would pass 16
    (32 q-heads over 1)."""
    q, b_k, kb, lat, fn, ref = _fp_case(gen, 2, 2, hpg, nkv, 128, 256, 512, layout=layout)
    kv_len = torch.tensor([512, 200], dtype=torch.int32, device="cuda")
    _close(fn(q, b_k, *lat, kv_len, k_bias=kb), ref(q, b_k, *lat, kv_len, k_bias=kb))


def test_fp_wg_shard_and_layer_idx(gen):
    """palu_decode_fp_t's pos_offset with return_stats over an L = 3 stack,
    compact b_k and the K bias: one lane's shard holds no valid column (m
    -1e30, l 0, acc 0); each layer bit-identical to the per-layer call."""
    q, b_k, kb, lat, fn, ref = _fp_case(gen, 2, 2, 8, 4, 128, 384, 1024, layout="rank_major",
                                        n_layers=3)
    kv_len = torch.tensor([1700, 900], dtype=torch.int32, device="cuda")
    for li in range(3):
        got = fn(q, b_k, *lat, kv_len, k_bias=kb, pos_offset=1024, return_stats=True,
                 layer_idx=li)
        _held_stats(got, ref(q, b_k, *lat, kv_len, k_bias=kb, pos_offset=1024,
                             return_stats=True, layer_idx=li))
        assert (got[1][1] == -1e30).all() and (got[2][1] == 0).all() and (got[0][1] == 0).all()
        alone = fn(q, b_k, *(x[li].contiguous() for x in lat), kv_len, k_bias=kb,
                   pos_offset=1024, return_stats=True)
        for x, y in zip(got, alone):
            assert torch.equal(x, y)


def test_fp_wg_refuses_ranks_above_512(gen):
    q, b_k, _, lat, fn, _ = _fp_case(gen, 1, 1, 4, 4, 528, 64, 128)
    n = fn.launches
    with pytest.raises(ValueError, match="512"):
        fn(q, b_k, *lat, torch.tensor([128], dtype=torch.int32, device="cuda"))
    assert fn.launches == n
