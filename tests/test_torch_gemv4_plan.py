"""The register-streamed one-launch GEMVs as pure functions on the CPU:
gemv_int4 over a bf16 x (csrc/gemv_int4.cu, gemv4_ldg) and the probe's
gemv_bf16 over W (K, N) (csrc/gemv_bf16.cu, gemv_kn).

  - their plans (ops/gemv_int4.gemv4_plan, tools/gemv_probe.gemv_plan on
    ops/gemv_int8.ldg_plan): every (column block, contraction unit) taken
    by exactly one warp of the grid (the kernels' own assignment: cluster
    cid = block // cluster owns column blocks cid, cid + ncl, ...; warp w
    of rank r is split 8 r + w of 8 * cluster), one wave within the card's
    cluster capacity, ValueError on what the kernels do not take;
  - the lanes' loads: each weight byte (int4) or value (bf16) of a tile
    read by exactly one lane, each warp-wide load four whole 128-byte rows;
  - the kernels' fragments and order of sums, emulated with numpy at the
    bit level (ring::nibbles, __byte_perm, mma.sync m16n8k16's fragment
    layout, the ones-mma for sum(x), the group fold, warps then ranks
    added in order), against JAX's gemv_int4 (Pallas, interpret=True) and
    the JAX probe's gemv_pallas (interpret) within GEMV_TOL, at rows 1, 3
    and 8, on the card's plan and on a 1- or 3-SM plan whose clusters own
    several column blocks and whose warps take different numbers of
    groups."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palu_tpu.ops.pallas.gemv_int4 import gemv_int4 as jax_gemv_int4
from palu_tpu_torch.ops import gemv_int4 as g4
from palu_tpu_torch.ops import gemv_int8 as g8
from palu_tpu_torch.tools import gemv_probe as gp
from test_torch_probes import load_tool, to_jax

SMS = 132
GEMV_TOL = gp.GEMV_TOL


def _caps(per_sm: int, sms: int = SMS) -> dict:
    """The model's capacity and a card whose GPCs place 7/8 of the
    model's clusters of 4 or 8."""
    model = tuple(per_sm * sms // c for c in g8.LDG_CLUSTERS)
    return {"model": model,
            "scarce": tuple(m * 7 // 8 if c > 2 else m for c, m in zip(g8.LDG_CLUSTERS, model))}


# (K, N): Llama-2-7B's int4 shapes, Qwen2-7B's, and the card tests' edges
INT4_SHAPES = {"q_proj": (4096, 4096), "w_fused": (12288, 4096), "lm_head": (4096, 32000),
               "qwen2_q_proj": (3584, 3584), "qwen2_w_fused": (7168, 3584),
               "qwen2_lm_head": (3584, 152064), "k128_n128": (128, 128),
               "k1152_n256": (1152, 256), "k4096_n384": (4096, 384), "k12288_n128": (12288, 128)}
# (K, N) of gemv_bf16: the tool's, the A/B's, the card tests' edges
BF16_SHAPES = {"tool": (4096, 4096), "vt": (4096, 1024), "w_fused": (12288, 4096),
               "mlp": (4096, 11008), "k512_n1024": (512, 1024), "k520_n1000": (520, 1000),
               "k24_n40": (24, 40), "k8_n8": (8, 8)}


def _warps(plan, col_blocks: int, units: int, warps: int = g8.LDG_WARPS):
    """(block, rank, warp, column block, first unit, end unit) of every
    warp's share of every column block its cluster owns (blocks of
    `warps` warps)."""
    cluster, grid = plan
    ncl, nw = grid // cluster, warps * cluster
    for blk in range(grid):
        rank, cid = blk % cluster, blk // cluster
        for w in range(warps):
            wi = rank * warps + w
            for cb in range(cid, col_blocks, ncl):
                yield blk, rank, w, cb, wi * units // nw, (wi + 1) * units // nw


def _check_plan(plan, col_blocks: int, units: int, per_sm: int, caps) -> None:
    cluster, grid = plan
    assert cluster in g8.LDG_CLUSTERS and grid % cluster == 0
    ncl = grid // cluster
    assert 1 <= ncl <= col_blocks  # no cluster without a column block
    assert grid <= per_sm * SMS and ncl <= caps[g8.LDG_CLUSTERS.index(cluster)]
    count = np.zeros((col_blocks, units), np.int64)
    for _, _, _, cb, u0, u1 in _warps(plan, col_blocks, units):
        count[cb, u0:u1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("cap", ["model", "scarce"])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_gemv4_plan_covers_once(shape, cap):
    k, n = INT4_SHAPES[shape]
    caps = _caps(g4.LDG_BLOCKS_PER_SM)[cap]
    plan = g4.gemv4_plan(SMS, k, n, 1, caps)
    assert all(g4.gemv4_plan(SMS, k, n, r, caps) == plan for r in (2, 5, 8))
    _check_plan(plan, n // 128, k // 128, g4.LDG_BLOCKS_PER_SM, caps)


def test_gemv4_plan_main_path():
    """q_proj and w_fused split their 32 column blocks over clusters of 4
    (one wave of 128 blocks) on a card that runs 30 clusters of 8 (an
    H100 80GB HBM3 at two blocks per SM); lm_head's 250 column blocks need
    no split."""
    caps = (264, 132, 62, 30)
    assert g4.gemv4_plan(SMS, 4096, 4096, 1, caps) == (4, 128)
    assert g4.gemv4_plan(SMS, 12288, 4096, 1, caps) == (4, 128)
    assert g4.gemv4_plan(SMS, 4096, 32000, 1, caps) == (1, 250)


@pytest.mark.parametrize("k,n,rows,sms", [(4000, 4096, 1, SMS), (4096, 4000, 1, SMS),
                                          (0, 4096, 1, SMS), (4096, 4096, 0, SMS),
                                          (4096, 4096, 9, SMS), (4096, 4096, 1, 0)])
def test_gemv4_plan_refuses(k, n, rows, sms):
    with pytest.raises(ValueError):
        g4.gemv4_plan(sms, k, n, rows)


@pytest.mark.parametrize("cap", ["model", "scarce"])
@pytest.mark.parametrize("shape", list(BF16_SHAPES))
def test_gemv_bf16_plan_covers_once(shape, cap):
    k, n = BF16_SHAPES[shape]
    caps = _caps(gp.KN_BLOCKS_PER_SM)[cap]
    plan = gp.gemv_plan(SMS, k, n, 1, caps)
    assert gp.gemv_plan(SMS, k, n, 8, caps) == plan
    _check_plan(plan, -(-n // gp.KN_COLS), -(-k // gp.KN_UNIT), gp.KN_BLOCKS_PER_SM, caps)


@pytest.mark.parametrize("k,n,rows", [(60, 64, 1), (64, 60, 1), (0, 64, 1), (64, 64, 9)])
def test_gemv_bf16_plan_refuses(k, n, rows):
    with pytest.raises(ValueError):
        gp.gemv_plan(SMS, k, n, rows)


def test_ldg_plan_refuses_a_card_without_room():
    with pytest.raises(ValueError):
        g8.ldg_plan(SMS, 1, 32, 32, (0, 0, 0, 0))


@pytest.mark.parametrize("cols", [64, 128])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_ldg_smem_fits(cols, rows):
    """The block's sums and receive buffers stay under the 48 KB a launch
    takes without a shared-memory attribute (the kernels set none)."""
    for c in g8.LDG_CLUSTERS:
        assert g8.ldg_smem(cols, rows, c) <= 48 * 1024
    assert g8.ldg_smem(cols, rows, 2) - g8.ldg_smem(cols, rows, 1) == 8 * rows * cols


# ---------------------------------------------------------------------------
# the lanes' loads
# ---------------------------------------------------------------------------

def test_int4_lanes_read_each_byte_once():
    """Lane (g, t) reads packed rows 16 t .. 16 t + 15 at bytes 16 g ..
    16 g + 15 of the column block: a group's 64 x 128 bytes once each; the
    load of (step s, half) covers rows 16 t + 2 s + half, t = 0..3, each a
    whole 128-byte row."""
    seen = np.zeros((64, 128), np.int64)
    for s in range(8):
        for half in range(2):
            rows = set()
            for g in range(8):
                for t in range(4):
                    seen[16 * t + 2 * s + half, 16 * g:16 * g + 16] += 1
                    rows.add(16 * t + 2 * s + half)
            assert len(rows) == 4
    assert (seen == 1).all()


def test_bf16_lanes_read_each_value_once():
    """Lane (g, t) reads rows 8 t .. 8 t + 7 of a 32-row unit at columns
    8 g .. 8 g + 7 of the 64-column block (16 bytes of each row)."""
    seen = np.zeros((32, 64), np.int64)
    for r in range(8):
        for g in range(8):
            for t in range(4):
                seen[8 * t + r, 8 * g:8 * g + 8] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# bit-level emulation of the kernels
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel) on uint32 arrays."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for k in range(4):
        src = (sel >> (4 * k)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def _nibbles(w, i: int):
    """ring::nibbles<0x43004300>: byte i of w as bf16x2 (128 + low nibble,
    128 + high nibble), by a byte permute and lop3 0x6A."""
    w = np.asarray(w, np.uint32)
    t = _byte_perm(w, w >> np.uint32(4), i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12))
    return (t & np.uint32(0x000F000F)) ^ np.uint32(0x43004300)


def _halves(u32):
    """A bf16x2 register as two f32 arrays (low half, high half)."""
    u32 = np.asarray(u32, np.uint32)
    return ((u32 & np.uint32(0xFFFF)) << np.uint32(16)).view(np.float32), \
        (u32 & np.uint32(0xFFFF0000)).view(np.float32)


def _mma(d, a, b):
    """d (16, 8) f32 += mma.sync m16n8k16 of the lanes' fragments: a[r] and
    b[r] are (8 g, 4 t) uint32 arrays of bf16x2 registers (a0..a3, b0,
    b1), laid out as PTX gives them: a0 (row g, k 2t, 2t + 1), a1 (row g +
    8), a2 (k + 8), a3 (both); b0 (k 2t, 2t + 1, column g), b1 (k + 8)."""
    A = np.zeros((16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for r in range(4):
        lo, hi = _halves(a[r])
        row, col = g + 8 * (r & 1), 2 * t + 8 * (r >> 1)
        A[row, col], A[row, col + 1] = lo, hi
    for r in range(2):
        lo, hi = _halves(b[r])
        B[2 * t + 8 * r, g], B[2 * t + 8 * r + 1, g] = lo, hi
    d += A @ B


def _words(a: np.ndarray) -> np.ndarray:
    """Little-endian uint32 words of the last axis' bytes."""
    return np.ascontiguousarray(a).view(np.uint32)


def _bf16_words(x: torch.Tensor) -> np.ndarray:
    """x (rows, K) bf16 as uint32 words (pairs of values)."""
    return x.contiguous().view(torch.int16).numpy().view(np.uint16).copy().view(np.uint32)


def _finish(sums: dict, plan, col_blocks: int, cols: int, rows: int,
            warps: int = g8.LDG_WARPS) -> np.ndarray:
    """The launch's order of sums: per column block each rank adds its warps
    in warp order, the ranks are added in rank order; f32 throughout."""
    cluster, _ = plan
    y = np.zeros((rows, col_blocks * cols), np.float32)
    for cb in range(col_blocks):
        total = None
        for rank in range(cluster):
            block = sums[(cb, rank, 0)].copy()
            for w in range(1, warps):
                block += sums[(cb, rank, w)]
            total = block if total is None else total + block
        y[:, cb * cols:(cb + 1) * cols] = total
    return y


def _emulate_int4(x: torch.Tensor, wq4: np.ndarray, ws: np.ndarray, plan, lane_bytes: int = 16,
                  warps: int = g8.LDG_WARPS) -> np.ndarray:
    """gemv4_ldg's result for x (rows, K) bf16, in its fragments and order
    (lane_bytes 16, blocks of 8 warps); with lane_bytes 4 and 16 warps
    gemv4_n32's (plan (1, N / 32)): lane (g, t) reads lane_bytes bytes at
    byte lane_bytes * g of its rows; mma tile j (< lane_bytes / 2) takes
    byte j as M row g and byte lane_bytes / 2 + j as M row g + 8."""
    rows, k = x.shape
    n = wq4.shape[1]
    lb, half = lane_bytes, lane_bytes // 2
    cols = 8 * lb
    col_blocks, groups = n // cols, k // 128
    xw = np.zeros((8, k // 2), np.uint32)  # x's rows as words, zeros past `rows`
    xw[:rows] = _bf16_words(x)
    gi, ti = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    ones = [np.full((8, 4), 0x3F803F80, np.uint32)] * 4
    sums = {}
    for _, rank, w, cb, u0, u1 in _warps(plan, col_blocks, groups, warps):
        acc = np.zeros((half, 16, 8), np.float32)  # (mma tile, M row, x row)
        for grp in range(u0, u1):
            # lane (g, t): lb bytes of packed rows 16 t + r at columns lb g ..
            tile = wq4[64 * grp:64 * grp + 64, cols * cb:cols * cb + cols]
            lane_rows = tile.reshape(4, 16, 8, lb).transpose(2, 0, 1, 3)  # (g, t, r, byte)
            q = _words(lane_rows).reshape(8, 4, 16, lb // 4)  # (g, t, r, word)
            xa = xw[gi, (128 * grp + 16 * ti) // 2 + np.arange(8)[:, None, None]]  # (8, g, t)
            xb = xw[gi, (128 * grp + 64 + 16 * ti) // 2 + np.arange(8)[:, None, None]]
            p = np.zeros((half, 16, 8), np.float32)
            o = np.zeros((16, 8), np.float32)
            for s in range(8):
                b = [_byte_perm(xa[s], xb[s], 0x5410), _byte_perm(xa[s], xb[s], 0x7632)]
                _mma(o, ones, b)
                r0, r1 = q[:, :, 2 * s], q[:, :, 2 * s + 1]
                for j in range(half):  # byte j: word j // 4, byte j % 4 of it
                    lo, hi = (j // 4, j % 4), ((half + j) // 4, (half + j) % 4)
                    _mma(p[j], [_nibbles(r0[..., lo[0]], lo[1]), _nibbles(r0[..., hi[0]], hi[1]),
                                _nibbles(r1[..., lo[0]], lo[1]), _nibbles(r1[..., hi[0]], hi[1])],
                         b)
            # M row m < 8 of tile j is column lb m + j, row m + 8 column lb m + half + j
            sc = ws[grp, cols * cb:cols * cb + cols].reshape(8, 2, half)  # (g, half, j)
            for j in range(half):
                scale = np.concatenate([sc[:, 0, j], sc[:, 1, j]])[:, None]
                acc[j] += (p[j] - np.float32(136.0) * o) * scale
        out = np.zeros((8, cols), np.float32)  # (x row, column)
        for j in range(half):
            out[:, lb * np.arange(8) + j] = acc[j][:8].T
            out[:, lb * np.arange(8) + half + j] = acc[j][8:].T
        sums[(cb, rank, w)] = out[:rows]
    return _finish(sums, plan, col_blocks, cols, rows, warps)


def _w4_by_hand(k: int, n: int, seed: int) -> dict:
    """Codes and scales of 128-row groups (quantize_weight4 shrinks the
    group below 128 rows unless K % 256 == 0)."""
    rng = np.random.default_rng(seed)
    return {"wq4": rng.integers(0, 256, (k // 2, n), dtype=np.uint8),
            "ws": (rng.random((k // 128, n), dtype=np.float32) * 0.01 + 1e-3)}


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("k,n,sms", [(1152, 512, SMS), (1152, 512, 1), (512, 256, SMS)],
                         ids=["k1152_card", "k1152_1sm", "k512_card"])
def test_int4_emulation_matches_jax(rows, k, n, sms):
    w = _w4_by_hand(k, n, k + n + rows)
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, k))
                         .astype(np.float32)).bfloat16()
    plan = g4.gemv4_plan(sms, k, n, rows)
    if sms == 1:  # clusters own several column blocks; warps' group counts differ
        assert plan[1] // plan[0] < n // 128
    want = np.asarray(jax_gemv_int4(to_jax(x), {"wq4": jnp.asarray(w["wq4"]),
                                                "ws": jnp.asarray(w["ws"])}, interpret=True)
                      .astype(jnp.float32))
    got = torch.from_numpy(_emulate_int4(x, w["wq4"], w["ws"], plan)).bfloat16().float().numpy()
    assert np.abs(got - want).max() <= GEMV_TOL * np.abs(want).max()
    plain = g4.gemv_int4(x, {"wq4": torch.from_numpy(w["wq4"]), "ws": torch.from_numpy(w["ws"])})
    assert np.abs(plain.float().numpy() - want).max() <= GEMV_TOL * np.abs(want).max()


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(1152, 256), (4096, 128), (256, 512)],
                         ids=["k1152", "k4096", "k256"])
def test_int4_n32_emulation_matches_jax(rows, k, n):
    """gemv4_n32: 4-byte lane loads, 32-column blocks of 16 warps (9 groups
    over 16 warps at K 1152: most warps take none or one; 32 groups: two
    each), against JAX's gemv_int4 in interpret mode."""
    w = _w4_by_hand(k, n, k + n + rows + 1)
    x = torch.from_numpy(np.random.default_rng(rows + 7).standard_normal((rows, k))
                         .astype(np.float32)).bfloat16()
    assert g4.gemv4_route(SMS, k, n, rows)[0] == "n32"
    want = np.asarray(jax_gemv_int4(to_jax(x), {"wq4": jnp.asarray(w["wq4"]),
                                                "ws": jnp.asarray(w["ws"])}, interpret=True)
                      .astype(jnp.float32))
    got = _emulate_int4(x, w["wq4"], w["ws"], (1, n // g4.N32_COLS), lane_bytes=4, warps=16)
    got = torch.from_numpy(got).bfloat16().float().numpy()
    assert np.abs(got - want).max() <= GEMV_TOL * np.abs(want).max()


@pytest.mark.parametrize("k,n,want", [(4096, 4096, "n32"), (12288, 4096, "n32"),
                                      (3584, 3584, "n32"), (4096, 32000, "ldg"),
                                      (4096, 4352, "ldg"), (3584, 152064, "ldg")])
def test_gemv4_route(k, n, want):
    """Narrow blocks where N / 32 of them fit one wave (a block per SM),
    else the clustered 128-column kernel on its plan."""
    kind, plan = g4.gemv4_route(SMS, k, n, 1)
    assert kind == want
    if kind == "n32":
        assert plan == n // 32 <= SMS
    else:
        assert plan == g4.gemv4_plan(SMS, k, n, 1)


def test_int4_n32_lanes_read_each_byte_once():
    """Lane (g, t) of gemv4_n32 reads 4 bytes at byte 4 g of packed rows
    16 t .. 16 t + 15: a group's 64 x 32 bytes once each."""
    seen = np.zeros((64, 32), np.int64)
    for r in range(16):
        for g in range(8):
            for t in range(4):
                seen[16 * t + r, 4 * g:4 * g + 4] += 1
    assert (seen == 1).all()


def _emulate_bf16(x: torch.Tensor, w: torch.Tensor, plan) -> np.ndarray:
    """gemv_kn's result for x (rows, K) @ w (K, N), in its fragments and
    order (rows past K and columns past N as zeros)."""
    rows, k = x.shape
    n = w.shape[1]
    col_blocks, units = -(-n // gp.KN_COLS), -(-k // gp.KN_UNIT)
    wpad = torch.zeros((units * gp.KN_UNIT, col_blocks * gp.KN_COLS), dtype=torch.bfloat16)
    wpad[:k, :n] = w
    xpad = torch.zeros((8, units * gp.KN_UNIT), dtype=torch.bfloat16)
    xpad[:rows, :k] = x
    ww = _bf16_words(wpad).reshape(units * gp.KN_UNIT, col_blocks, 8, 4)  # (row, cb, g, word)
    xw = _bf16_words(xpad).reshape(8, units, 4, 4)  # (x row g, unit, t, word)
    gi, ti = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    sums = {}
    for _, rank, wid, cb, u0, u1 in _warps(plan, col_blocks, units):
        acc = np.zeros((4, 16, 8), np.float32)
        for u in range(u0, u1):
            lane = ww[u * 32 + 8 * ti[..., None] + np.arange(8), cb, gi[..., None]]  # (g,t,r,wd)
            xv = xw[gi, u, ti]  # (g, t, word)
            for s in range(2):
                b = [xv[..., 2 * s], xv[..., 2 * s + 1]]
                for j in range(4):
                    r = [lane[:, :, 4 * s + m, j] for m in range(4)]
                    _mma(acc[j], [_byte_perm(r[0], r[1], 0x5410), _byte_perm(r[0], r[1], 0x7632),
                                  _byte_perm(r[2], r[3], 0x5410), _byte_perm(r[2], r[3], 0x7632)],
                         b)
        out = np.zeros((8, gp.KN_COLS), np.float32)
        for j in range(4):  # M row m < 8: column 8 m + 2 j, row m + 8: 8 m + 2 j + 1
            out[:, 8 * np.arange(8) + 2 * j] = acc[j][:8].T
            out[:, 8 * np.arange(8) + 2 * j + 1] = acc[j][8:].T
        sums[(cb, rank, wid)] = out[:rows]
    return _finish(sums, plan, col_blocks, gp.KN_COLS, rows)[:, :n]


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("k,n,sms", [(1024, 256, SMS), (520, 456, 3), (96, 512, SMS)],
                         ids=["k1024_card", "k520_3sms", "k96_card"])
def test_bf16_emulation_matches_jax(rows, k, n, sms):
    rng = np.random.default_rng(k + n + rows)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32) * 0.1).bfloat16()
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02).bfloat16()
    plan = gp.gemv_plan(sms, k, n, rows)
    if sms == 3:
        assert plan[1] // plan[0] < -(-n // gp.KN_COLS)
    bn = 8  # the JAX tool's N tile: it must divide N
    ns = load_tool("tpu_gemv_probe", K=k, N=n, BN=bn)
    want = np.asarray(ns["gemv_pallas"](to_jax(x), to_jax(w), bn), np.float32)
    got = torch.from_numpy(_emulate_bf16(x, w, plan)).bfloat16().float().numpy()
    assert np.abs(got - want).max() <= GEMV_TOL * np.abs(want).max()
    plain = gp.gemv_bf16(x, w).float().numpy()  # CPU: the plain version
    assert np.abs(plain - want).max() <= GEMV_TOL * np.abs(want).max()


@pytest.mark.parametrize("code", range(16))
def test_nibbles_are_128_plus_code(code):
    """The two integer instructions of ring::nibbles give the bf16 values
    128 + low nibble and 128 + high nibble of byte i, for every byte."""
    for i in range(4):
        for other in (0, 15, 7):
            byte = code | (other << 4)
            w = np.array([0xA5C3E1F0 & ~(0xFF << (8 * i)) | (byte << (8 * i))], np.uint32)
            lo, hi = _halves(_nibbles(w, i))
            assert lo[0] == 128 + code and hi[0] == 128 + other
