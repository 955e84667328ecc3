"""The Hadamard kernels' plan and index maps (csrc/hadamard.cu,
ops/hadamard.hadamard_plan) on the CPU, against the JAX package:

  - the sign masks the mix kernel compiles in (HadK<K>::row, parsed from
    the source) bit for bit against core/hadamard.get_hadK, the port's and
    JAX's, for every K the kernel holds;
  - the plan for every n the kernels take: kind, threads, rows per block,
    shared memory within the card's 227 KB; ValueError past MAX_N or for
    an n with no known H_K;
  - the fwht and mix kernels emulated in plain torch with their own thread
    maps (set, lane -> row, column), butterfly partners (lane ^ h, the
    shuffle and shared-memory exchanges alike) and sign arithmetic
    (fmaf(sign, v, partner); the mix four values at a time: the 8 signed
    sums v0 +- v1 +- v2 +- v3, each output adding or subtracting the one
    its row of H_K picks, the blocks in order): every (row, column) written
    exactly once, and the result within 1e-5 of max|JAX| of JAX's
    hadamard_transform (Pallas, interpret mode) or apply_hadamard (H_K^T)."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import hadamard as jh
from palu_tpu.ops.pallas import fwht as jfwht
from palu_tpu_torch.core import hadamard as th
from palu_tpu_torch.ops import build
from palu_tpu_torch.ops.hadamard import MAX_N, MIX_KS, hadamard_plan

TOL = 1e-5  # of max|JAX|: f32 sums in another order than the dense product's
SMEM_LIMIT = 232448  # a block's shared memory on the card (227 KB)


def _source_masks() -> dict:
    src = (build.CSRC / "hadamard.cu").read_text()
    out = {}
    for k, body in re.findall(r"struct HadK<(\d+)> \{\s*static constexpr uint64_t row\[\d+\] = "
                              r"\{([^}]*)\}", src):
        out[int(k)] = [int(w.strip().rstrip("ul"), 16) for w in body.split(",")]
    return out


MASKS = _source_masks()


def _valid_ns():
    for n in range(1, MAX_N + 1):
        try:
            _, k = th.get_hadK(n)
        except ValueError:
            continue
        yield n, k


@pytest.mark.parametrize("k", MIX_KS)
def test_sign_masks_match_get_hadk(k):
    assert sorted(MASKS) == list(MIX_KS)
    rows = MASKS[k]
    assert len(rows) == k and all(r < (1 << k) for r in rows)
    bits = np.array([[(r >> c) & 1 for c in range(k)] for r in rows])
    n = k * 8
    for get in (th.get_hadK, jh.get_hadK):
        had, kk = get(n)
        assert kk == k
        np.testing.assert_array_equal(np.where(bits == 1, 1.0, -1.0), np.asarray(had))


@pytest.mark.parametrize("esize", [4, 2])
def test_plan_for_every_n(esize):
    kinds = set()
    for n, k in _valid_ns():
        p = hadamard_plan(n, esize=esize)
        kinds.add(p["kind"])
        m = n // k
        assert p["smem"] <= SMEM_LIMIT and p["threads"] % 32 == 0 and p["threads"] <= 512
        if p["kind"] == "fwht":
            assert k == 1 and m >= 8
            t = m // 8
            if t > 32:
                assert (p["threads"], p["rows_per_block"], p["smem"]) == (t, 1, 4 * m)
            else:
                assert p["smem"] == 0 and p["rows_per_block"] * t == p["threads"] == 256
        elif p["kind"] == "mix":
            assert k in MIX_KS and k % 4 == 0 and 2 <= m <= 32 and p["threads"] == 256
            assert p["rows_per_block"] == 8 * (32 // m)
            # bf16: one warp tile of its 32 / m rows each, one bulk copy
            # apiece (16-byte multiples: n % 8 == 0 since m >= 2)
            assert p["smem"] == (p["rows_per_block"] * n * 2 if esize == 2 else 0)
            assert (n * esize) % 16 == 0 and p["smem"] <= 48 * 1024
        else:
            assert (k == 1 and m < 8) or k not in MIX_KS or m > 32 or m == 1
            assert p["rows_per_block"] == 1 and p["smem"] == 4 * n + k * k
    assert kinds == {"fwht", "mix", "general"}
    # the compress path's ranks (multiples of 32 up to 512) never take the general kernel
    assert all(hadamard_plan(r)["kind"] != "general" for r in range(32, 513, 32))


@pytest.mark.parametrize("n", [0, 4097, 8192, 100, 200])
def test_plan_refuses(n):
    with pytest.raises(ValueError):
        hadamard_plan(n)


def _signed_sums(v: torch.Tensor, b: int) -> list:
    """t[p] of signed_sums for block b of v (threads, K): v0 + s1 v1 + s2 v2
    + s3 v3, s_e = -1 where bit e - 1 of p is set, in the kernel's order."""
    v0, v1, v2, v3 = (v[:, 4 * b + e] for e in range(4))
    a, bb, c, d = v0 + v1, v0 - v1, v2 + v3, v2 - v3
    return [a + c, bb + c, a - d, bb - d, a + d, bb + d, a - c, bb - c]


def _emulate_mix(x: torch.Tensor, transpose: bool) -> tuple:
    """mix_kernel's arithmetic over its own thread map: -> (out, writes)."""
    rows, n = x.shape
    _, k = th.get_hadK(n)
    m = n // k
    log_m = m.bit_length() - 1
    rpw = 32 >> log_m
    plan = hadamard_plan(n, k)
    blocks = -(-rows // plan["rows_per_block"])
    tid = torch.arange(blocks * plan["threads"])  # warp w of the grid: set w
    lane = tid % 32
    row = (tid // 32) * rpw + (lane >> log_m)
    i = lane & (m - 1)
    live = row < rows
    xr = x[row.clamp(max=rows - 1)]
    v = torch.stack([torch.where(live, xr[torch.arange(len(tid)), kk * m + i], 0.0)
                     for kk in range(k)], 1)  # (threads, K)
    h = 1
    while h < m:  # __shfl_xor_sync(v, h): the lane lane ^ h of the same warp
        partner = (tid // 32) * 32 + (lane ^ h)
        sgn = torch.where((i & h) != 0, -1.0, 1.0)[:, None]
        v = sgn * v + v[partner]
        h <<= 1
    bits = np.array([[(r >> c) & 1 for c in range(k)] for r in MASKS[k]], bool)
    if transpose:
        bits = bits.T
    acc = [None] * k
    for b in range(k // 4):
        t = _signed_sums(v, b)
        for j in range(k):
            h0 = bits[j, 4 * b]
            p = sum(1 << (e - 1) for e in (1, 2, 3) if bits[j, 4 * b + e] != h0)
            if b == 0:
                acc[j] = t[p] if h0 else -t[p]
            else:
                acc[j] = acc[j] + t[p] if h0 else acc[j] - t[p]
    out = torch.zeros((rows, n))
    writes = torch.zeros((rows, n), dtype=torch.int64)
    scale = torch.tensor(1.0 / math.sqrt(n), dtype=torch.float32)
    for j in range(k):
        out[row[live], j * m + i[live]] = acc[j][live] * scale
        writes[row[live], j * m + i[live]] += 1
    return out, writes


def _emulate_fwht(x: torch.Tensor) -> tuple:
    """fwht_kernel's arithmetic over its own thread map: -> (out, writes)."""
    rows, n = x.shape
    t_row = n // 8
    plan = hadamard_plan(n, 1)
    rpb = plan["rows_per_block"]
    tid = torch.arange(-(-rows // rpb) * plan["threads"])  # (block, thread)
    local = tid % plan["threads"]
    t, row = local % t_row, (tid // plan["threads"]) * rpb + local // t_row
    live = row < rows
    cols = t[:, None] * 8 + torch.arange(8)[None, :]
    v = torch.where(live[:, None], x[row.clamp(max=rows - 1)[:, None], cols], 0.0)
    for h in (1, 2, 4):  # in registers
        e = [c for c in range(8) if not c & h]
        a, b = v[:, e].clone(), v[:, [c + h for c in e]].clone()
        v[:, e], v[:, [c + h for c in e]] = a + b, a - b
    hb = 1
    while hb < t_row:  # shuffles below 32, shared memory past: partner t ^ hb
        partner = tid ^ hb
        sgn = torch.where((t & hb) != 0, -1.0, 1.0)[:, None]
        v = sgn * v + v[partner]
        hb <<= 1
    out = torch.zeros((rows, n))
    writes = torch.zeros((rows, n), dtype=torch.int64)
    scale = torch.tensor(1.0 / math.sqrt(n), dtype=torch.float32)
    r, c = row[live][:, None].expand(-1, 8), cols[live]
    out[r, c] = v[live] * scale
    writes[r, c] += 1
    return out, writes


@pytest.mark.parametrize("rows", [1, 3, 37])
@pytest.mark.parametrize("n", [24, 80, 96, 160, 224, 288, 320, 352, 384, 416, 448, 480, 704, 896,
                               1920])
def test_mix_emulation_matches_jax(n, rows):
    assert hadamard_plan(n)["kind"] == "mix"
    x = np.random.default_rng(n + rows).standard_normal((rows, n)).astype(np.float32)
    for transpose in (False, True):
        got, writes = _emulate_mix(torch.from_numpy(x), transpose)
        assert torch.equal(writes, torch.ones_like(writes))
        want = np.asarray(jh.apply_hadamard(jnp.asarray(x), transpose=True)) if transpose else \
            np.asarray(jfwht.hadamard_transform(jnp.asarray(x), block_rows=8, interpret=True))
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("rows", [1, 3, 37])
@pytest.mark.parametrize("n", [8, 32, 128, 256, 512, 1024, 4096])
def test_fwht_emulation_matches_jax(n, rows):
    assert hadamard_plan(n)["kind"] == "fwht"
    x = np.random.default_rng(n + rows).standard_normal((rows, n)).astype(np.float32)
    got, writes = _emulate_fwht(torch.from_numpy(x))
    assert torch.equal(writes, torch.ones_like(writes))
    want = np.asarray(jfwht.hadamard_transform(jnp.asarray(x), block_rows=8, interpret=True))
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
