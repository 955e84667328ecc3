"""The int8 SwiGLU MLP over a bf16 x (csrc/gemv_int8.cu, mlp8_ldg: gate and
up, then down) as pure functions on the CPU:

  - its plans (ops/gemv_int8.mlp8_plan / mlp8_plans): every (column block,
    64-row tile) taken by exactly one warp of the grid (the kernel's own
    assignment: cluster cid = block // cluster owns column blocks cid, cid
    + ncl, ...; warp w of rank r is split warps * r + w of warps *
    cluster), one wave within the card's cluster capacity, Llama-2-7B's and
    Qwen2-7B's plans on an H100's capacities, ValueError on what the kernel
    does not take, and shared memory within the card;
  - the int8 code -> bf16 pair of ring::nibbles<0x45084300> for all 256 byte
    values: 128 + low nibble and 16 (128 + high nibble ^ 8), together the
    code + 2304;
  - the kernel's fragments and order of sums, emulated with numpy at the
    bit level (the lanes' 16-byte rows, __byte_perm of x's word into both
    halves, mma.sync m16n8k16's fragment layout, the (1, 0) mma for sum(x),
    the fold p - 2304 sum(x) per tile, warps then ranks added in order, the
    gate / up scales before silu, h in bf16, the down scale after its sum)
    against JAX's mlp_gemv_int8 (Pallas, interpret=True) within 2^-7 of
    max|JAX| (GEMV_TOL: one bf16 rounding of the output and of h), at rows
    1, 3 and 8, at narrow Llama-like (H 256, I 768) and Qwen2-like (H 256,
    I 1408) widths, on the card's plans and on 1- and 2-SM plans whose
    clusters own several column blocks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.ops.pallas.gemv_int8 import mlp_gemv_int8 as jax_mlp_gemv_int8
from palu_tpu_torch.core import wquant
from palu_tpu_torch.ops import gemv_int8 as g8
from test_torch_gemv4_plan import _bf16_words, _byte_perm, _halves, _mma, _warps, _words
from test_torch_probes import to_jax

SMS = 132
GEMV_TOL = 2.0**-7
# the two launches' cluster capacities (warps, clusters of sizes 1..8) as
# an H100 80GB HBM3 (700 W) reports them (ops/gemv_int8._device_mlp8_capacity;
# the card test test_mlp8_plans_fit_the_card holds the plans within them)
H100_CAPS = (((16, (132, 66, 39, 30, 22, 17, 15, 15)), (8, (264, 132, 79, 62, 47, 39, 32, 30))),
             ((8, (264, 132, 79, 62, 47, 39, 32, 30)),))
# (H, I): Llama-2-7B's, Qwen2-7B's, the card tests' edges, a 70B-like width
MLP8_SHAPES = {"llama": (4096, 11008), "qwen2": (3584, 18944), "h128_i128": (128, 128),
               "h1152_i384": (1152, 384), "h384_i10880": (384, 10880),
               "h1024_i768": (1024, 768), "h8192_i28672": (8192, 28672)}


def _scarce(caps):
    """A card whose GPCs place 7/8 of the model's clusters above 2."""
    return tuple((w, tuple(n * 7 // 8 if c > 2 else n for c, n in zip(range(1, 9), cap)))
                 for w, cap in caps)


def _check_plan(plan, col_blocks: int, units: int, caps) -> None:
    warps, cluster, grid = plan
    assert warps in g8.MLP8_WARPS and cluster in g8.MLP8_CLUSTERS and grid % cluster == 0
    ncl = grid // cluster
    assert 1 <= ncl <= col_blocks  # no cluster without a column block
    assert grid <= 512 // (32 * warps) * SMS
    if caps is not None:
        assert ncl <= dict(caps)[warps][cluster - 1]
    count = np.zeros((col_blocks, units), np.int64)
    for _, _, _, cb, u0, u1 in _warps((cluster, grid), col_blocks, units, warps):
        count[cb, u0:u1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("cap", ["model", "h100", "scarce"])
@pytest.mark.parametrize("shape", list(MLP8_SHAPES))
def test_mlp8_plans_cover_once(shape, cap):
    h, inter = MLP8_SHAPES[shape]
    caps = {"model": (None, None), "h100": H100_CAPS,
            "scarce": tuple(_scarce(c) for c in H100_CAPS)}[cap]
    plans = g8.mlp8_plans(SMS, h, inter, 1, caps)
    assert all(g8.mlp8_plans(SMS, h, inter, r, caps) == plans for r in (3, 8))
    assert plans[1][0] == 8  # down: 8-warp blocks
    _check_plan(plans[0], inter // 128, h // 64, caps[0])
    _check_plan(plans[1], h // 128, inter // 64, caps[1])


def test_mlp8_plans_main_path():
    """On an H100's capacities: Llama-2-7B's gate / up in one 16-warp block
    per column block (86, no cluster), its down product in clusters of 7
    (32 clusters of 8 do not fit); Qwen2-7B's 148 gate / up column blocks
    in 8-warp blocks, its down in clusters of 8."""
    assert g8.mlp8_plans(SMS, 4096, 11008, 1, H100_CAPS) == ((16, 1, 86), (8, 7, 224))
    assert g8.mlp8_plans(SMS, 3584, 18944, 1, H100_CAPS) == ((8, 1, 148), (8, 8, 224))


@pytest.mark.parametrize("h,inter,rows", [(4000, 11008, 1), (4096, 11000, 1), (0, 128, 1),
                                          (4096, 11008, 0), (4096, 11008, 9)])
def test_mlp8_plans_refuse(h, inter, rows):
    with pytest.raises(ValueError):
        g8.mlp8_plans(SMS, h, inter, rows)


@pytest.mark.parametrize("sms,col_blocks,sets", [(0, 8, 2), (SMS, 0, 1), (SMS, 8, 3)])
def test_mlp8_plan_refuses(sms, col_blocks, sets):
    with pytest.raises(ValueError):
        g8.mlp8_plan(sms, col_blocks, sets)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_mlp8_smem_fits(rows):
    """A 16-warp block (one an SM) and two 8-warp blocks fit an SM's 228 KB,
    at every cluster size, and one block the 227 KB a block may take."""
    for c in g8.MLP8_CLUSTERS:
        assert g8.mlp8_smem(2, 16, rows, c) <= 227 * 1024
        assert 2 * g8.mlp8_smem(2, 8, rows, c) <= 228 * 1024
        assert 2 * g8.mlp8_smem(1, 8, rows, c) <= 228 * 1024
    assert g8.mlp8_smem(1, 8, rows, 2) - g8.mlp8_smem(1, 8, rows, 1) == 2 * 4 * 2 * rows * 64


# ---------------------------------------------------------------------------
# the int8 -> bf16 pair and a bit-level emulation of the kernel
# ---------------------------------------------------------------------------

def _nibbles8(w, i: int):
    """ring::nibbles<0x45084300>: byte i of w as bf16x2 (128 + low nibble,
    16 (128 + high nibble ^ 8)), by a byte permute and lop3 0x6A."""
    w = np.asarray(w, np.uint32)
    t = _byte_perm(w, w >> np.uint32(4), i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12))
    return (t & np.uint32(0x000F000F)) ^ np.uint32(0x45084300)


def test_int8_pairs_are_code_plus_2304():
    """All 256 byte values at each of the word's four byte positions."""
    for i in range(4):
        for byte in range(256):
            w = np.array([0xA5C3E1F0 & ~(0xFF << (8 * i)) | (byte << (8 * i))], np.uint32)
            lo, hi = _halves(_nibbles8(w, i))
            code = byte - 256 if byte >= 128 else byte
            assert lo[0] == 128 + (byte & 15)
            assert hi[0] == 16 * (128 + ((byte >> 4) ^ 8))
            assert lo[0] + hi[0] == code + 2304


ONES_LO = np.uint32(0x00003F80)  # bf16x2 (1, 0)


def _emulate_launch(x: torch.Tensor, wqs, plan) -> list:
    """mlp8_ldg's sums for x (rows, K) bf16 against each int8 weight in wqs
    ((K, N): one, or gate and up), in its fragments and order, before the
    scales: per set an f32 (rows, N) array."""
    rows, k = x.shape
    n = wqs[0].shape[1]
    warps, cluster, grid = plan
    col_blocks, units = n // 128, k // 64
    xw = np.zeros((8, k // 2), np.uint32)  # x's rows as words, zeros past `rows`
    xw[:rows] = _bf16_words(x)
    gi, ti = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    ones = [np.full((8, 4), ONES_LO, np.uint32)] * 4
    sums = {}
    for _, rank, w, cb, u0, u1 in _warps((cluster, grid), col_blocks, units, warps):
        acc = [np.zeros((rows, 128), np.float32) for _ in wqs]
        for u in range(u0, u1):
            for si, wq in enumerate(wqs):
                tile = wq[64 * u:64 * u + 64, 128 * cb:128 * cb + 128].view(np.uint8)
                # lane (g, t): 16 bytes at byte 16 g of rows 16 t .. 16 t + 15
                q = _words(tile.reshape(4, 16, 8, 16).transpose(2, 0, 1, 3))  # (g, t, r, word)
                q = q.reshape(8, 4, 16, 4)
                p = np.zeros((8, 16, 8), np.float32)  # (mma tile, M row, x row)
                o = np.zeros((16, 8), np.float32)
                for s in range(8):
                    xv = xw[gi, (64 * u + 16 * ti) // 2 + s]  # x[g][16 t + 2 s], + 1
                    b = [_byte_perm(xv, 0, 0x1010), _byte_perm(xv, 0, 0x3232)]
                    _mma(o, ones, b)
                    r0, r1 = q[:, :, 2 * s], q[:, :, 2 * s + 1]
                    for h in range(2):
                        for e in range(4):
                            _mma(p[4 * h + e], [_nibbles8(r0[..., h], e),
                                                _nibbles8(r0[..., 2 + h], e),
                                                _nibbles8(r1[..., h], e),
                                                _nibbles8(r1[..., 2 + h], e)], b)
                # M row m < 8 of tile j is column 16 m + j, row m + 8 16 m + 8 + j
                cols = np.zeros((8, 128), np.float32)
                for j in range(8):
                    cols[:, 16 * np.arange(8) + j] = p[j][:8].T
                    cols[:, 16 * np.arange(8) + 8 + j] = p[j][8:].T
                off = np.float32(2304) * o[0][:, None]  # sum(x) of each x row
                acc[si] = acc[si] + (cols - off)[:rows]
        sums[(cb, rank, w)] = acc
    out = [np.zeros((rows, n), np.float32) for _ in wqs]
    for cb in range(col_blocks):
        for si in range(len(wqs)):
            total = None
            for rank in range(cluster):
                block = sums[(cb, rank, 0)][si].copy()
                for w in range(1, warps):
                    block += sums[(cb, rank, w)][si]
                total = block if total is None else total + block
            out[si][:, 128 * cb:128 * cb + 128] = total
    return out


def _emulate_mlp(x: torch.Tensor, ws, plans) -> np.ndarray:
    """The two launches: h = bf16(silu(g * sg) * (u * su)), then bf16(h @ Wd
    * sd) (f32 epilogues, as the kernel's)."""
    wg, wu, wd = ws
    g, u = _emulate_launch(x, [wg["wq8"], wu["wq8"]], plans[0])
    g = g * wg["ws"].reshape(1, -1)
    u = u * wu["ws"].reshape(1, -1)
    h = torch.from_numpy((g * (np.float32(1) / (np.float32(1) + np.exp(-g))) * u)
                         .astype(np.float32)).bfloat16()
    (y,) = _emulate_launch(h, [wd["wq8"]], plans[1])
    return torch.from_numpy(y * wd["ws"].reshape(1, -1)).bfloat16().float().numpy()


def _weights(h: int, inter: int, seed: int):
    rng = np.random.default_rng(seed)

    def q(k, n):
        w = wquant.quantize_weight(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32) * 0.05))
        return {"wq8": w["wq8"].numpy(), "ws": w["ws"].numpy().astype(np.float32)}
    return q(h, inter), q(h, inter), q(inter, h)


# (H, I, SMs, rows): Llama-like (I / H about 3) and Qwen2-like (about 5.3)
# widths on the card's plans at rows 1, 3 and 8, and on 1- and 2-SM plans
EMULATED = [((256, 768), SMS, r) for r in (1, 3, 8)] + \
           [((256, 1408), SMS, r) for r in (1, 3, 8)] + [((256, 768), 1, 3), ((256, 1408), 2, 8)]


@pytest.mark.parametrize("shape,sms,rows", EMULATED,
                         ids=[f"h{h}_i{i}_{s}sms_r{r}" for (h, i), s, r in EMULATED])
def test_mlp8_emulation_matches_jax(shape, sms, rows):
    h, inter = shape
    ws = _weights(h, inter, h + inter + rows)
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, h))
                         .astype(np.float32)).bfloat16()
    plans = g8.mlp8_plans(sms, h, inter, rows)
    if sms < SMS:  # clusters own several column blocks
        assert plans[0][2] // plans[0][1] < inter // 128
    jw = [{"wq8": jnp.asarray(w["wq8"]), "ws": jnp.asarray(w["ws"])} for w in ws]
    want = np.asarray(jax_mlp_gemv_int8(to_jax(x), *jw, interpret=True).astype(jnp.float32))
    got = _emulate_mlp(x, ws, plans)
    assert np.abs(got - want).max() <= GEMV_TOL * np.abs(want).max()
    tw = [{k: torch.from_numpy(v) for k, v in w.items()} for w in ws]
    plain = g8.mlp_gemv_int8(x, *tw).float().numpy()  # CPU: the plain version
    assert np.abs(plain - want).max() <= GEMV_TOL * np.abs(want).max()
