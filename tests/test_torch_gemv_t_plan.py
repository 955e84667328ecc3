"""gemv_bf16_t's kernel (csrc/gemv_bf16.cu, namespace tldg) as pure
functions on the CPU:

  - gemv_t_plan: every (column block, 32-value unit of the contraction)
    taken by exactly one warp (the kernel's own assignment: block b owns
    column blocks b * cpb .. b * cpb + cpb - 1, warp w column block w // S
    and units [r * units // S, (r + 1) * units // S) with r = w % S, S =
    warps // cpb), at most bn columns a block, 8 or 16 warps, ValueError on
    the bn and K the kernel refuses;
  - a warp's lanes: lane (g, t) reads values 8t .. 8t + 7 of each unit
    (zeros past K): every k of the contraction multiplied exactly once;
  - the kernel's order of sums (per warp two accumulators, one per mma step
    of a unit, added; the ranges of a column block added in order),
    emulated in f32, against the JAX probe's gemv_pallas_t in interpret
    mode within GEMV_TOL."""

import numpy as np
import pytest
import torch

from palu_tpu_torch.tools import gemv_probe as gp
from test_torch_probes import load_tool, to_jax

SMS = 132
SHAPES = [(4096, 4096), (4096, 1024), (4096, 3072), (12288, 4096), (4096, 32000),
          (4096, 11008), (512, 1024), (520, 1000), (24, 40), (8, 8), (3584, 18944)]


def _warps(k: int, n: int, warps: int, cpb: int):
    """(block, warp, column block, first unit, end unit) of every warp."""
    cbs, units = -(-n // gp.T_ROWS), -(-k // 32)
    s = warps // cpb
    for b in range(-(-cbs // cpb)):
        for w in range(warps):
            cb, r = b * cpb + w // s, w % s
            yield b, w, cb, r * units // s, (r + 1) * units // s


@pytest.mark.parametrize("bn", [16, 64, 256, 512])
@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_covers_once(k, n, bn):
    warps, cpb = gp.gemv_t_plan(SMS, k, n, bn)
    cbs, units = -(-n // gp.T_ROWS), -(-k // 32)
    assert warps in (8, 16) and warps % cpb == 0 and cpb * gp.T_ROWS <= bn
    assert warps == (8 if cbs >= SMS else 16)
    if cpb > 1:
        assert -(-cbs // cpb) >= 2 * SMS  # two blocks per SM stay busy
    count = np.zeros((cbs + cpb, units), np.int64)
    for _, _, cb, u0, u1 in _warps(k, n, warps, cpb):
        count[cb, u0:u1] += 1
    assert (count[:cbs] == 1).all() and (count[cbs:] == 0).all()


def test_plan_prefers_one_column_block():
    assert gp.gemv_t_plan(SMS, 4096, 4096, 512) == (8, 1)
    assert gp.gemv_t_plan(SMS, 4096, 1024, 512) == (16, 1)
    assert gp.gemv_t_plan(SMS, 4096, 32000, 512) == (8, 4)
    assert gp.gemv_t_plan(SMS, 4096, 32000, 16) == (8, 1)  # bn 16: one column block a block


@pytest.mark.parametrize("bn,k,n", [(0, 64, 64), (24, 64, 64), (520, 64, 64), (16, 60, 64),
                                    (16, 0, 64), (16, 64, 0)])
def test_plan_refuses(bn, k, n):
    with pytest.raises(ValueError):
        gp.gemv_t_plan(SMS, k, n, bn)


@pytest.mark.parametrize("k", [8, 24, 32, 520, 1000, 4096, 12288])
def test_lanes_cover_the_contraction_once(k):
    units = -(-k // 32)
    seen = np.zeros(units * 32, np.int64)
    for u in range(units):
        for t in range(4):
            k0 = u * 32 + 8 * t
            if k0 < k:  # the lane loads 8 values, or zeros past K
                seen[k0:k0 + 8] += 1
    assert (seen[:k] == 1).all() and (seen[k:] == 0).all()


def _emulate(x: torch.Tensor, wt: torch.Tensor, bn: int) -> torch.Tensor:
    """The kernel's sums in its order, in f32, rounded once to bf16."""
    m, k = x.shape
    n = wt.shape[0]
    warps, cpb = gp.gemv_t_plan(SMS, k, n, bn)
    s = warps // cpb
    xf = torch.cat([x.float(), torch.zeros((m, 32))], 1)  # zeros past K
    wf = torch.cat([wt.float(), torch.zeros((n, 32))], 1)
    sums = {}
    for _, w, cb, u0, u1 in _warps(k, n, warps, cpb):
        if cb * gp.T_ROWS >= n:
            continue
        cols = slice(cb * gp.T_ROWS, min(n, (cb + 1) * gp.T_ROWS))
        acc = [torch.zeros((m, cols.stop - cols.start)) for _ in range(2)]
        for u in range(u0, u1):
            for step in range(2):  # values 0-3, then 4-7, of each lane's 8
                ks = [u * 32 + 8 * t + 4 * step + e for t in range(4) for e in range(4)]
                acc[step] += xf[:, ks] @ wf[cols, ks].t()
        sums[(cb, w % s)] = acc[0] + acc[1]
    y = torch.zeros((m, n))
    for cb in range(-(-n // gp.T_ROWS)):
        cols = slice(cb * gp.T_ROWS, min(n, (cb + 1) * gp.T_ROWS))
        total = sums[(cb, 0)]
        for r in range(1, s):
            total = total + sums[(cb, r)]
        y[:, cols] = total
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(1024, 256), (520, 40), (4096, 64), (96, 4096)])
def test_emulated_order_matches_jax(rows, k, n):
    rng = np.random.default_rng(k + n + rows)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32) * 0.1).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.02).bfloat16()
    got = _emulate(x, wt, 16)
    ns = load_tool("tpu_gemv_probe", K=k, N=n, BN=8)
    want = np.asarray(ns["gemv_pallas_t"](to_jax(x), to_jax(wt), 8), np.float32)
    assert np.abs(got.float().numpy() - want).max() <= gp.GEMV_TOL * np.abs(want).max()
    plain = gp.gemv_bf16_t(x, wt).float().numpy()  # CPU: the plain version
    assert np.abs(plain - want).max() <= gp.GEMV_TOL * np.abs(want).max()
