"""The unpack probe's kernel (csrc/unpack_probe.cu) as the pure Python that
mirrors it (palu_tpu_torch/tools/unpack_probe.py: unpack_plan, the
shared-memory plan; unpack_items, the walk of (group, block) items) and
numpy emulations of its index arithmetic: the TMA stage in the 128-byte
swizzle (code_at), the bf16 boxes the cc variants assemble (box4 / box3),
the ext4mm fragments (k_frag / v_frag) in the wgmma A layout, p^T's K
positions, and B's rows in the boxes' rank order. Each emulation is held
against the codes JAX's tool unpacks (tools/tpu_unpack_probe.py's
unpack4_parts / unpack3_parts through test_torch_probes.load_tool). The
archived v2 bf16 decode's plan is palu_decode_fp's. The card's test
(test_torch_kernels_cuda.py) holds the kernel's own plan against
unpack_plan."""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp

from palu_tpu_torch.ops.archive import palu_decode2 as d2
from palu_tpu_torch.ops.palu_decode_fp import _fp_plan
from palu_tpu_torch.tools import unpack_probe as up
from test_torch_probes import load_tool

SMEM_MAX = 232448  # the most shared memory one block may use
SIZES = {"small": (2, 32, 64, 1024, 256), "tool": (8, 128, 384, 65536, 1024),
         "tool_bs128": (8, 128, 384, 65536, 128), "tool_bs4096": (8, 128, 384, 65536, 4096)}
# the ring depth the kernel's header states for each variant at the tool's ranks
TOOL_STAGES = {"base": 7, "ext4nc": 7, "ext4cc": 6, "ext4mm": 6, "ext4ccmm": 4, "ext3nc": 8,
               "ext3cc": 8, "conv8": 3}


@pytest.mark.parametrize("variant", up.VARIANTS)
@pytest.mark.parametrize("size", list(SIZES))
def test_unpack_plan_fits_and_is_laid_out(variant, size):
    """Every region in order and inside 227 KB, each stage, B, p^T and box
    buffer 1024-aligned (the 128-byte swizzle's atom), each side's TMA boxes
    covering its rows (at most 256 rows a box, a multiple of 8 when there
    are several, so that rows stay 128 bytes apart), the cc boxes covering
    the ranks; the ring as deep as the header says at the tool's ranks."""
    g, rk, rv, s, bs = SIZES[size]
    p = up.unpack_plan(variant, rk, rv)
    assert p is not None and p["smem"] <= SMEM_MAX
    assert 2 <= p["ns"] <= up.MAX_STAGES
    if size != "small":
        assert p["ns"] == TOOL_STAGES[variant]
    assert up.unpack_plan(variant, rk, rv) == p  # a pure function
    for side, r in (("k", rk), ("v", rv)):
        rows, br, nbox = p[f"rows_{side}"], p[f"br_{side}"], p[f"nbox_{side}"]
        assert rows == up._code_rows(variant, r) and br * nbox >= rows and br <= 256
        assert nbox == 1 or br % 8 == 0
    assert p["side_v"] % 1024 == 0 and p["side_p"] % 1024 == 0 and p["stage"] % 1024 == 0
    assert p["side_v"] >= p["br_k"] * p["nbox_k"] * 128
    assert p["side_p"] - p["side_v"] >= p["br_v"] * p["nbox_v"] * 128
    p_rows = 128 * 8 * 2 if variant in ("ext4mm", "ext4ccmm") else 0  # the tile's rows of p
    assert p["stage"] == p["side_p"] + p_rows
    assert p["load_bytes"] == 128 * (p["br_k"] * p["nbox_k"] + p["br_v"] * p["nbox_v"]) + p_rows
    assert p["b"] == p["ns"] * p["stage"] and p["pt"] % 1024 == 0 and p["asm"] % 1024 == 0
    assert p["b"] + 128 * p["b_rows"] <= p["pt"] <= p["asm"] <= p["red"] <= p["bars"]
    assert p["bars"] + 16 * p["ns"] + 1024 == p["smem"]
    if variant in ("ext4cc", "ext4ccmm"):
        assert 64 * p["ccb_k"] >= rk and 64 * p["ccb_v"] >= rv
    if variant == "ext3cc":
        assert 64 * p["ccb_k"] >= rk and 64 * p["ccb_v"] >= rv
    assert p["b_rows"] == {"ext4mm": -(-rk // 128) * 128,
                           "ext4ccmm": 64 * p["ccb_k"]}.get(variant, 0)
    # one more stage does not fit (the deepest ring is taken)
    if p["ns"] < up.MAX_STAGES:
        assert p["smem"] + p["stage"] + 16 > SMEM_MAX


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("sms", [132, 114, 7, 1])
def test_unpack_items_cover_every_block_once(size, sms):
    """One wave: min(items, SMs) blocks, block b walking a contiguous run of
    items, the runs' lengths within one of each other, every (group, block)
    item exactly once (so each mm sum has one writer)."""
    g, rk, rv, s, bs = SIZES[size]
    n = g * (s // bs)
    grid = min(n, sms)
    runs = up.unpack_items(n, grid)
    assert len(runs) == grid
    seen = np.zeros((g, s // bs), np.int64)
    for r in runs:
        assert len(r) >= 1
        for item in r:
            seen[item // (s // bs), item % (s // bs)] += 1
    assert (seen == 1).all()
    assert max(map(len, runs)) - min(map(len, runs)) <= 1


# ---- numpy emulations of the kernel's index arithmetic


def swizzled(codes: np.ndarray) -> np.ndarray:
    """A side's (rows, 128) bytes as TMA writes them with the 128-byte
    swizzle into a 1024-aligned region: 16-byte chunk c of row r lands at
    chunk c ^ (r % 8)."""
    out = np.empty_like(codes)
    for r in range(codes.shape[0]):
        for c in range(8):
            cc = c ^ (r % 8)
            out[r, 16 * cc:16 * cc + 16] = codes[r, 16 * c:16 * c + 16]
    return out


def code_at(side: np.ndarray, row: int, col: int, n: int) -> np.ndarray:
    """n bytes at byte `col` of row `row` (the kernel's code_at)."""
    off = (((col >> 4) ^ row) & 7) * 16 + (col & 15)
    return side[row, off:off + n]


def unswizzle_box(box: np.ndarray) -> np.ndarray:
    """A (64, 64) bf16-valued box as stored (rows of 128 bytes, 16-byte
    units of 8 tokens swizzled by row) back in token order."""
    out = np.empty_like(box)
    for r in range(64):
        for u in range(8):
            uu = (u ^ r) & 7
            out[r, 8 * u:8 * u + 8] = box[r, 8 * uu:8 * uu + 8]
    return out


def box4(side: np.ndarray, half: int, b: int, h: int) -> np.ndarray:
    """The values box4 writes (64 rows x 64 tokens, as stored): every
    thread's two (row, 8-token) units of both nibbles."""
    box = np.full((64, 64), -1, np.int64)
    for wt in range(128):
        for n in range(2):
            c = wt + 128 * n
            j = c & 7
            i = ((c >> 3) & 1) * 4 + ((c >> 4) & 3) + ((c >> 6) << 3)
            row = 32 * b + i
            w = code_at(side, row, 64 * h + 8 * j, 8).astype(np.int64) if row < half else \
                np.zeros(8, np.int64)
            u = (j ^ i) & 7
            for rho, vals in ((i, w & 15), (32 + i, (w >> 4) & 15)):
                assert (box[rho, 8 * u:8 * u + 8] == -1).all()  # written once
                box[rho, 8 * u:8 * u + 8] = vals
    return box


def box3(side: np.ndarray, w1: int, b: int, h: int) -> np.ndarray:
    """The values box3 writes (as stored): thread wt, plane row i, tokens 4
    q .. 4 q + 3 of all eight parts, 8-byte halves of the units."""
    box = np.full((64, 64), -1, np.int64)
    for wt in range(128):
        q, i = wt & 15, (wt >> 5) + 4 * ((wt >> 4) & 1)
        row, col = 8 * b + i, 64 * h + 4 * q
        ok = row < w1
        ws = [code_at(side, row + x * w1, col, 4).astype(np.int64) if ok
              else np.zeros(4, np.int64) for x in range(3)]
        for k in range(8):
            vals = ((ws[0] >> k) & 1) | (((ws[1] >> k) & 1) << 1) | (((ws[2] >> k) & 1) << 2)
            rho = 8 * i + k
            pos = (((q >> 1) ^ k) & 7) * 8 + (q & 1) * 4
            assert (box[rho, pos:pos + 4] == -1).all()
            box[rho, pos:pos + 4] = vals
    return box


def test_cc_read_back_takes_each_unit_once():
    """The cc variants' read-back (box4_back / box3_back): thread wt reads
    what thread wt ^ 1 of its own warp wrote, so every unit of a box (box4:
    16-byte units, box3: their 8-byte halves) is read exactly once and only
    by the warp that wrote it."""
    for unit, nthr in ((16, 4), (8, 8)):
        seen = np.zeros(64 * 128 // unit, np.int64)
        writer = np.full(seen.shape, -1)
        for wt in range(128):
            for o, mark in ((wt, "write"), (wt ^ 1, "read")):
                offs = []
                if unit == 16:
                    for n in range(2):
                        c = o + 128 * n
                        j, i = c & 7, ((c >> 3) & 1) * 4 + ((c >> 4) & 3) + ((c >> 6) << 3)
                        off = ((j ^ i) & 7) * 16
                        offs += [i * 128 + off, (32 + i) * 128 + off]
                else:
                    q, i = o & 15, (o >> 5) + 4 * ((o >> 4) & 1)
                    offs = [(8 * i + k) * 128 + (((q >> 1) ^ k) & 7) * 16 + (q & 1) * 8
                            for k in range(8)]
                assert len(offs) == nthr
                for off in offs:
                    if mark == "write":
                        assert writer[off // unit] == -1
                        writer[off // unit] = wt
                    else:
                        seen[off // unit] += 1
                        assert writer[off // unit] // 32 == wt // 32 or writer[off // unit] == -1
        assert (seen == 1).all() and (writer >= 0).all()


def _jax_parts(variant: str, codes: np.ndarray, rank: int) -> np.ndarray:
    """(rank, S) values of one group's codes (rows, S), by the JAX tool's
    unpack functions."""
    ns = load_tool("tpu_unpack_probe", seq=codes.shape[1], BS=128, NCH=1)
    ref = jnp.asarray(codes)[None]
    if variant.startswith("ext3"):
        parts = ns["unpack3_parts"](ref, 0, rank)
    else:
        parts = ns["unpack4_parts"](ref, 0)
    return np.concatenate([np.asarray(p) for p in parts], 0).astype(np.int64)


@pytest.mark.parametrize("variant,rk,rv", [("ext4cc", 32, 64), ("ext4cc", 128, 384),
                                           ("ext4cc", 96, 160), ("ext3cc", 32, 64),
                                           ("ext3cc", 128, 384)])
def test_cc_boxes_hold_each_rank_token_once(variant, rk, rv):
    """The assembled boxes of one 128-token tile, both warpgroups, from the
    swizzled stage: every (rank, token) of each side lands in exactly one
    box row and token column with the value JAX's unpack gives it, every
    other row is zeros (ranks past the side), and each box row holds one
    rank (box4: byte row 32 b + i's low nibble at row i, its high one at 32
    + i; box3: part k of plane row 8 b + i at row 8 i + k)."""
    rng = np.random.default_rng(0)
    for r in (rk, rv):
        rows = up._code_rows(variant, r)
        codes = rng.integers(0, 256, (rows, 128), dtype=np.uint8)
        want = _jax_parts(variant, codes, r)  # (r, 128)
        side = swizzled(codes)
        nbox = up.unpack_plan(variant, rk, rv)["ccb_k" if r == rk else "ccb_v"]
        seen = np.zeros((r, 128), np.int64)
        for h in range(2):
            for b in range(nbox):
                box = unswizzle_box(box4(side, r // 2, b, h) if variant == "ext4cc"
                                    else box3(side, r // 8, b, h))
                assert (box >= 0).all()
                for rho in range(64):
                    if variant == "ext4cc":
                        byte_row = 32 * b + (rho & 31)
                        rank = None if byte_row >= r // 2 else \
                            byte_row if rho < 32 else r // 2 + byte_row
                    else:
                        i, k = divmod(rho, 8)
                        rank = None if 8 * b + i >= r // 8 else k * (r // 8) + 8 * b + i
                    if rank is None:
                        assert (box[rho] == 0).all()
                        continue
                    assert (box[rho] == want[rank, 64 * h:64 * h + 64]).all(), (b, rho)
                    seen[rank, 64 * h:64 * h + 64] += 1
        assert (seen == 1).all()


def _frag_rows_cols(warp: int, lane: int) -> list:
    """The wgmma A (m64 k16) fragment of one thread: [(row, col), ...] of its
    registers' low and high halves (a[0] .. a[3])."""
    gq, qd = lane // 4, lane % 4
    r0 = 16 * warp + gq
    return [((r0, 2 * qd), (r0, 2 * qd + 1)), ((r0 + 8, 2 * qd), (r0 + 8, 2 * qd + 1)),
            ((r0, 2 * qd + 8), (r0, 2 * qd + 9)), ((r0 + 8, 2 * qd + 8), (r0 + 8, 2 * qd + 9))]


@pytest.mark.parametrize("rk", [32, 128])
def test_k_fragments_are_x_transposed(rk):
    """ext4mm's K fragments (k_frag) of every thread and 16-rank step, put
    where the wgmma A layout says, form x^T: A[m, k] is rank 16 kk + k of
    token ta(m), with each warp's rows m = 16 w + gq (+ 8) being tokens 16 w
    + 2 gq (+ 1) of the warpgroup's 64, every token once."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, (rk // 2, 128), dtype=np.uint8)
    x = _jax_parts("ext4", codes, rk)  # (rk, 128)
    side, half = swizzled(codes), rk // 2
    for h in range(2):
        for kk in range(rk // 16):
            a = np.full((64, 16), -1, np.int64)
            tok = np.full(64, -1, np.int64)
            for warp in range(4):
                for lane in range(32):
                    gq, qd = lane // 4, lane % 4
                    col = 64 * h + 16 * warp + 2 * gq
                    regs = []
                    for p in range(2):
                        r = 16 * kk + 2 * qd + 8 * p
                        hi = r >= half
                        row = r - half if hi else r
                        w0 = code_at(side, row, col, 2).astype(np.int64)
                        w1 = code_at(side, row + 1, col, 2).astype(np.int64)
                        for t in range(2):  # (rank r, rank r + 1) at token col + t
                            regs.append(((w0[t] >> (4 * hi)) & 15, (w1[t] >> (4 * hi)) & 15))
                    # regs[2 p + t] is af[2 p + t]
                    for (lo, hi_), ((m0, k0), (m1, k1)) in zip(regs, _frag_rows_cols(warp, lane)):
                        a[m0, k0], a[m1, k1] = lo, hi_
                    tok[16 * warp + gq], tok[16 * warp + gq + 8] = col, col + 1
            assert sorted(tok) == list(range(64 * h, 64 * h + 64))
            want = x[16 * kk:16 * kk + 16][:, tok].T  # (64 tokens, 16 ranks)
            assert (a == want).all()


@pytest.mark.parametrize("rv", [64, 384])
def test_v_fragments_pair_with_pt_columns(rv):
    """ext4mm's V fragments (v_frag) per 64-rank block and 16-token step,
    put where the wgmma A layout says, hold rank 64 m + row's code at the
    token write_pt stores at that K column of p^T (nc order), zeros past
    rv: the product A . p^T^T pairs every code with its own token's p."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (rv // 2, 128), dtype=np.uint8)
    x = _jax_parts("ext4", codes, rv)
    side, half = swizzled(codes), rv // 2
    # write_pt (nc): token t of the warpgroup's 64 at K position k(t)
    kpos = {}
    for t in range(64):
        u = t & 15
        qd, rem = u >> 2, u & 3
        kpos[(t & ~15) + 2 * qd + (rem >> 1) + 8 * (rem & 1)] = t
    assert sorted(kpos) == list(range(64))
    for h in range(2):
        for m in range(-(-rv // 64)):
            for j in range(4):
                a = np.full((64, 16), -1, np.int64)
                for warp in range(4):
                    for lane in range(32):
                        gq, qd = lane // 4, lane % 4
                        regs = [None] * 4
                        for rr in range(2):
                            r = 64 * m + 16 * warp + gq + 8 * rr
                            w = np.zeros(4, np.int64)
                            if r < rv:
                                row = r if r < half else r - half
                                w = (code_at(side, row, 64 * h + 16 * j + 4 * qd, 4)
                                     .astype(np.int64) >> (0 if r < half else 4)) & 15
                            regs[rr] = (w[0], w[2])
                            regs[2 + rr] = (w[1], w[3])
                        for (lo, hi), ((m0, k0), (m1, k1)) in zip(regs,
                                                                  _frag_rows_cols(warp, lane)):
                            a[m0, k0], a[m1, k1] = lo, hi
                for mm in range(64):
                    r = 64 * m + mm
                    for k in range(16):
                        t = kpos[16 * j + k]
                        assert a[mm, k] == (x[r, 64 * h + t] if r < rv else 0), (mm, k)


@pytest.mark.parametrize("rk", [32, 96, 128])
def test_b_rows_follow_the_k_boxes(rk):
    """ext4ccmm's B rows (load_b): row 64 b + rho holds the rank of K box
    b's row rho (box4's order), zeros where the box row has none; every
    rank once. ext4mm's rows are the ranks in order, in whole 128-rank
    chunks (its K product is one group of 8 16-rank steps a chunk)."""
    half = rk // 2
    p = up.unpack_plan("ext4ccmm", rk, 384)
    ranks = []
    for k in range(p["b_rows"]):
        b, rho = divmod(k, 64)
        byte_row = 32 * b + (rho & 31)
        ranks.append(-1 if byte_row >= half else byte_row if rho < 32 else half + byte_row)
    assert sorted(r for r in ranks if r >= 0) == list(range(rk))
    assert up.unpack_plan("ext4mm", rk, 384)["b_rows"] == 128


def test_v2_plan_is_palu_decode_fp_plan():
    """palu_decode2's kernel takes palu_decode_fp's plan (one B per q-head):
    _v2_plan is _fp_plan wherever v2 is instantiated (hd 128, one 8-head
    tile a consumer: at most 16 heads a group) and None elsewhere."""
    for hd, rk, rv, hpg in itertools.product((64, 128), (16, 32, 128, 256, 512),
                                             (8, 64, 384, 512), (1, 4, 8, 16, 20, 32)):
        got = d2._v2_plan(hd, rk, rv, hpg)
        want = _fp_plan(hd, rk, rv, hpg, hpg)
        if hd == 128 and hpg <= 16:
            assert got == want and (want is None or want["nt"] == 1), (hd, rk, rv, hpg)
        else:
            assert got is None
