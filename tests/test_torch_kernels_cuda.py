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


@pytest.mark.parametrize("nkv,window", [(4, None), (2, None), (4, 40)])
def test_prefill_kernel_matches_plain(gen, nkv, window):
    b, nh, cq, s, hd = 2, 4, 96, 256, 128
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
