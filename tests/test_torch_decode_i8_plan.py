"""The work plan of the int8 K-path modes' kernel (csrc/palu_decode_i8.cu),
as the pure Python functions that mirror it (ops/palu_decode.py): the
shared-memory plan (_i8_plan: stages, operand slots, heads per chunk), the
launch checks (_i8_launch_plan) and the visits of each work item
(_item_visits: which head chunk and tile, and where a new query-folded
operand is built). The card's test (test_torch_kernels_cuda.py) holds the
kernel's own plan against _i8_plan."""

import itertools

import numpy as np
import pytest

from palu_tpu_torch.core.quant import packed_nrows
from palu_tpu_torch.ops.palu_decode import (_SMEM_BUDGET, _TILE, _i8_launch_plan, _i8_plan,
                                            _item_tiles, _item_visits, _splits)

SMEM_MAX = 232448  # the most shared memory one block may use

# (hd, rk, rv, heads per group): the Llama-2-7B group, its GQA-repeated 16
# heads, Qwen2-7B's 28 q-heads at rank 256, the ranks of a compressed 7B
# model's groups and hd 64 at the smallest ranks
SHAPES = [(128, 128, 384, 4), (128, 128, 384, 16), (128, 256, 256, 28), (128, 512, 512, 4),
          (128, 512, 512, 16), (128, 96, 320, 4), (128, 32, 64, 8), (64, 32, 64, 4),
          (64, 256, 256, 28), (128, 416, 448, 4)]


# (shape, mode, asym, bias): int8_rot only below the ranks where it raises
# (its int32 sums would overflow: 63 * 127 * 15 * rk * hd / 2 >= 2^31)
PLAN_CASES = [(shape, mode, asym, bias) for shape in SHAPES
              for mode, asym, bias in ((1, False, False), (2, False, False), (1, True, True),
                                       (2, True, False))
              if mode == 1 or 63 * 127 * 15 * shape[1] * (shape[0] // 2) < 2**31]


@pytest.mark.parametrize("shape,mode,asym,bias", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_plan_fits_and_prefers_whole_groups(shape, mode, asym, bias):
    """Every supported shape has a plan within a block's shared memory, with
    its heads in chunks that cover them; the Llama-2-7B group keeps all four
    in one chunk. (A head's operand rows take 128-byte blocks, so small
    ranks pad: 8 heads at rk 32 go in chunks.)"""
    hd, rk, rv, hpg = shape
    nrk, nrv = packed_nrows(rk, 4), packed_nrows(rv, 4)
    plan = _i8_plan(hd, rk, rv, hpg, nrk, nrv, asym, mode, bias)
    assert plan is not None
    assert plan["smem"] <= SMEM_MAX and plan["smem"] - 1024 <= _SMEM_BUDGET
    assert plan["nob"] in (1, 2) and plan["ns"] in (2, 3) and plan["nst"] in (1, 2)
    assert 1 <= plan["chunk"] <= hpg and plan["nch"] == -(-hpg // plan["chunk"])
    if (hd, rk, hpg) == (128, 128, 4):  # the Llama-2-7B group: all heads in one chunk
        assert plan["chunk"] == hpg


def test_plan_at_the_main_shapes():
    """The Llama-2-7B group (4 heads at rk 128, rv 384, 3-bit in nibbles)
    keeps all heads in one chunk and one operand slot beside 3 tile stages
    in both modes (both read the f32 rotation rows, 34 KB; int8_rot also its
    int8 rows); at serve_bench_int8_rot's rv 128 there is room for two
    staging buffers of B. Qwen2-7B's 28 heads at rk 256 go in chunks."""
    llama = (128, 128, 384, 4, 64, 192, False)
    for mode in (1, 2):
        plan = _i8_plan(*llama, mode, False)
        assert (plan["nob"], plan["ns"], plan["nst"], plan["bch"], plan["nch"]) == \
            (1, 3, 1, 128, 1)
    assert _i8_plan(128, 128, 128, 4, 64, 64, False, 2, False)["nst"] == 2
    qwen = _i8_plan(128, 256, 256, 28, 128, 128, False, 1, True)
    assert qwen["nch"] > 1


@pytest.mark.parametrize("kw,match", [
    (dict(hd=96), "hd 64 or 128"), (dict(rk=48), "multiple of 32"), (dict(rk=544), "up to 512"),
    (dict(rv=528), "rv <= 512"), (dict(hpg=33), "32 heads"), (dict(block_s=32), "multiple of 64"),
    (dict(block_s=0), "multiple of 64"), (dict(s_max=8192 + 64), "dividing S")])
def test_launch_checks_raise_where_the_kernel_cannot_run(kw, match):
    args = dict(hd=128, rk=128, rv=384, hpg=4, nrk=64, nrv=192, asym=False, mode=1, bias=False,
                block_s=512, s_max=8192)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        _i8_launch_plan(**args)
    good = dict(args, hd=128, rk=128, rv=384, hpg=4, block_s=512, s_max=8192)
    assert _i8_launch_plan(**good)["nch"] == 1


def test_launch_check_raises_where_no_plan_fits():
    """hd 128 at rk 512 with 8-bit-wide stages of 32 heads: one head's
    operand (64 KB) beside a ring of 3 stages of 128 KB each cannot fit."""
    with pytest.raises(ValueError, match="do not fit"):
        _i8_launch_plan(128, 512, 512, 32, 2048, 2048, True, 1, True, 512, 8192)


def _cases():
    rng = np.random.default_rng(3)
    for _ in range(150):
        s_max = int(rng.choice([512, 1024, 4096, 8192]))
        block_s = int(rng.choice([b for b in (64, 128, 512, 2048) if s_max % b == 0]))
        kv = int(rng.integers(-100, s_max + 300))
        off = int(rng.choice([0, 0, s_max // 4, s_max]))
        window = None if rng.random() < 0.5 else int(rng.integers(1, s_max))
        splits = int(rng.integers(1, 40))
        nch = int(rng.choice([1, 1, 2, 7]))
        yield kv + off, off, window, s_max, splits, nch, block_s


@pytest.mark.parametrize("case", list(itertools.islice(_cases(), 150)))
def test_item_visits_cover_valid_tiles_and_start_operands(case):
    """Over the splits of one (lane, group), the visits cover every valid
    tile exactly once per head chunk (and no other); a new operand starts
    at every item's first tile of each chunk and at every rotation block
    boundary, and nowhere else, so each visit's tile lies in the block of
    the operand last built."""
    kv_len, off, window, s_max, splits, nch, block_s = case
    kvl = kv_len - off
    lo = max(0, kvl - window) if window else 0
    hi = max(0, min(kvl, s_max))
    valid = set(range(lo // _TILE, -(-hi // _TILE))) if hi > lo else set()
    seen = {c: [] for c in range(nch)}
    for split in range(splits):
        visits = _item_visits(kv_len, off, window, s_max, splits, split, nch, block_s)
        t0, t1 = _item_tiles(kv_len, off, window, s_max, splits, split)
        assert len(visits) == nch * max(0, t1 - t0)
        block = None
        for c, t, new in visits:
            seen[c].append(t)
            assert new == (t == t0 or t * _TILE % block_s == 0)
            if new:
                block = (c, t * _TILE // block_s)
            assert block == (c, t * _TILE // block_s)  # the operand in use is this tile's
    for c in range(nch):
        assert sorted(seen[c]) == sorted(valid)  # each valid tile once per chunk


def test_item_visits_at_the_64k_point():
    """latency_attention's shape (S 66048, kv_len 65600, blocks of 512) on
    the card's 132 SMs over 8 groups: 16 splits per group, each starting
    one operand per rotation block it enters (and at its first tile, which
    may lie inside a block)."""
    splits, grid = _splits(132, 1, 8, 66048)
    assert (splits, grid) == (16, 128)
    starts = 0
    for split in range(splits):
        visits = _item_visits(65600, 0, None, 66048, splits, split, 1, 512)
        blocks = {t * _TILE // 512 for _, t, _ in visits}
        assert sum(new for _, _, new in visits) == len(blocks)
        starts += len(blocks)
    assert starts >= -(-65600 // 512)  # every block of the cache at least once
