"""The streaming GEMVs' work plans (ops/gemv_int8.stream_plan, gemv8_plan,
ops/gemv_int4.mlp_plan) as pure functions, without a card: every (column
block, K unit) is covered exactly once by the blocks the kernel runs, the
cluster sizes stay within their limits and the card's cluster capacity, the
grid is one wave at 132 SMs, and each block's shared memory fits.

Shapes: Llama-2-7B's (VT_k, VT_v, q_proj, w_fused, lm_head; the MLP at
H 4096, I 11008), Qwen2-7B's (q_proj, w_fused, lm_head, VT at rank 256;
the MLP at H 3584, I 18944) and the edge shapes of the kernels' card tests."""

import pytest

from palu_tpu_torch.ops import gemv_int4 as g4
from palu_tpu_torch.ops import gemv_int8 as g8

SMS = 132
# clusters of 1 .. 16 blocks at once: the model (two blocks per SM) and a
# card whose GPCs place 7/8 of the model's clusters of 3 or more (an H100
# 80GB HBM3 ran 30 clusters of 8 and 14 of 16 at 112 KB a block)
CAPACITIES = {"model": g8.model_capacity(SMS),
              "scarce": tuple(2 * SMS // c * (7 if c > 2 else 8) // 8 for c in g8.CLUSTERS)}

# (K, N) of gemv_int8
INT8_SHAPES = {
    "vt_k": (4096, 1024), "vt_v": (4096, 3072), "q_proj": (4096, 4096),
    "w_fused": (12288, 4096), "lm_head": (4096, 32000),
    "qwen2_q_proj": (3584, 3584), "qwen2_w_fused": (7168, 3584),
    "qwen2_lm_head": (3584, 152064), "qwen2_vt": (3584, 256),
    "k128_n128": (128, 128), "k1000_n1024": (1000, 1024), "k1152_n3072": (1152, 3072),
    "k4096_n128": (4096, 128),
}
# (H, I) of mlp_gemv_int4; 1, 9 and 86 groups
MLP_SHAPES = {
    "llama": (4096, 11008), "qwen2": (3584, 18944), "h1_i1": (128, 128),
    "h9_i9": (1152, 1152), "h86_i1": (86 * 128, 128), "h1_i86": (128, 86 * 128),
    "h9_i86": (1152, 86 * 128),
}
ROWS = (1, 2, 5, 8)


def _covered(plan, col_blocks: int, units: int) -> dict:
    """(column block, unit) -> times covered by the kernel's blocks: block
    b is rank b % cluster of cluster b // cluster, which owns column blocks
    b // cluster + j * (grid // cluster) and units [rank * units //
    cluster, (rank + 1) * units // cluster)."""
    cluster, grid = plan
    ncl = grid // cluster
    seen = {}
    for blk in range(grid):
        rank, first = blk % cluster, blk // cluster
        u0, u1 = rank * units // cluster, (rank + 1) * units // cluster
        for cb in range(first, col_blocks, ncl):
            for u in range(u0, u1):
                seen[(cb, u)] = seen.get((cb, u), 0) + 1
    return seen


def _no_room(kind: int, col_blocks: int, units: int, rows: int, caps) -> bool:
    """No cluster size that runs in one wave leaves room for the ring next
    to x's slice (a plan of None: the wrapper runs the split pass)."""
    for c, cap in zip(g8.CLUSTERS, caps):
        one_wave = c == 1 or (c * col_blocks <= g8.RING_SLOTS_PER_SM * SMS and col_blocks <= cap)
        if c <= units and one_wave and g8.stream_smem(kind, rows, -(-units // c)) <= g8.RING_SMEM:
            return False
    return True


def _check(plan, kind: int, col_blocks: int, units: int, rows: int, caps) -> None:
    if plan is None:  # the slice of x leaves no room at any size (8 rows at lm_head)
        assert rows >= 6 and _no_room(kind, col_blocks, units, rows, caps)
        return
    cluster, grid = plan
    assert cluster in g8.CLUSTERS and cluster <= units
    # one wave: within the blocks two per SM hold, and within the clusters
    # of this size the card runs at once
    assert grid <= g8.RING_SLOTS_PER_SM * SMS
    assert grid // cluster <= caps[g8.CLUSTERS.index(cluster)]
    if cluster > 1:  # a cluster owns one column block
        assert grid == cluster * col_blocks
    assert grid % cluster == 0 and grid // cluster <= col_blocks
    per = -(-units // cluster)
    assert g8.stream_smem(kind, rows, per) <= g8.RING_SMEM
    seen = _covered(plan, col_blocks, units)
    assert len(seen) == col_blocks * units and set(seen.values()) == {1}


@pytest.mark.parametrize("caps", list(CAPACITIES))
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_gemv8_plan_covers_once_in_one_wave(shape, rows, caps):
    k, n = INT8_SHAPES[shape]
    plan = g8.gemv8_plan(SMS, k, n, rows, CAPACITIES[caps])
    _check(plan, g8.KIND_INT8, n // 128, -(-k // 64), rows, CAPACITIES[caps])


@pytest.mark.parametrize("caps", list(CAPACITIES))
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", list(MLP_SHAPES))
def test_mlp_plan_covers_once_in_one_wave(shape, rows, caps):
    h, inter = MLP_SHAPES[shape]
    c = CAPACITIES[caps]
    first = g8.stream_plan(SMS, g8.KIND_GATE_UP, inter // 128, h // 128, rows, c)
    second = g8.stream_plan(SMS, g8.KIND_DOWN, h // 128, inter // 128, rows, c)
    _check(first, g8.KIND_GATE_UP, inter // 128, h // 128, rows, c)
    _check(second, g8.KIND_DOWN, h // 128, inter // 128, rows, c)
    both = None if first is None or second is None else (first, second)
    assert g4.mlp_plan(SMS, h, inter, rows, (c, c)) == both


def test_plans_at_the_main_path_shapes():
    """The plans at Llama-2-7B's widths under the model capacity: VT_k in
    16-block clusters (a 32 KB slice per block, all in flight at entry), VT_v
    in 11s (264 blocks, 6 tiles each), the MLP's gate / up in 3s (258 blocks,
    22 tiles each) and its down product in 8s, lm_head one column block per
    block."""
    caps = CAPACITIES["model"]
    assert g8.gemv8_plan(SMS, 4096, 1024, 1, caps) == (16, 128)
    assert g8.gemv8_plan(SMS, 4096, 3072, 1, caps) == (11, 264)
    assert g8.gemv8_plan(SMS, 4096, 32000, 1, caps) == (1, 250)
    assert g4.mlp_plan(SMS, 4096, 11008, 1, (caps, caps)) == ((3, 258), (8, 256))


def test_scarce_clusters_shrink_the_cluster():
    """Where the card places fewer large clusters than the model, the plan
    takes the size with the fewest tiles per block that still runs every
    column block in one wave (the down product: 7 ranks, not 8)."""
    caps = CAPACITIES["scarce"]
    assert g4.mlp_plan(SMS, 4096, 11008, 1, (caps, caps)) == ((2, 172), (7, 224))
    assert g8.gemv8_plan(SMS, 4096, 4096, 1, caps)[0] == 7  # q_proj: 32 column blocks
    assert g8.gemv8_plan(SMS, 4096, 3072, 1, caps)[0] == 8  # VT_v: 24


def test_large_n_blocks_own_several_column_blocks():
    plan = g8.gemv8_plan(SMS, 3584, 152064, 1, CAPACITIES["model"])
    assert plan[0] == 1 and plan[1] == 2 * SMS < 152064 // 128


@pytest.mark.parametrize("kind", [g8.KIND_GATE_UP, g8.KIND_DOWN, g8.KIND_INT8])
def test_stream_smem_grows_with_every_part(kind):
    """The mirror of ring::Layout: each row and unit add their bytes (a
    cluster's pushed rows go over the ring and add none)."""
    base = g8.stream_smem(kind, 1, 4)
    unit = 128 if kind == g8.KIND_INT8 else 256 + 32
    row = 4 * (128 if kind == g8.KIND_INT8 else 256) + 2 * 128 * 4 + \
        (2 * 128 if kind == g8.KIND_GATE_UP else 0)
    assert g8.stream_smem(kind, 1, 5) - base == unit
    assert g8.stream_smem(kind, 2, 4) - base == row


def test_plan_without_room_is_none():
    """An x slice too large for the ring: no plan (the wrapper runs the split
    pass): lm_head's 4096 rows of x at 8 rows in one block, and a slice no
    cluster can cut small enough."""
    caps = CAPACITIES["model"]
    assert g8.gemv8_plan(SMS, 4096, 32000, 8, caps) is None
    assert g8.gemv8_plan(SMS, 4096, 32000, 5, caps) is not None
    assert g8.stream_plan(SMS, g8.KIND_INT8, 4, 4096, 8, caps) is None


@pytest.mark.parametrize("rows", range(1, 9))
def test_routes_follow_the_measured_crossovers(rows):
    """gemv_int8 streams where (rows - 1) x K x N >= 56 Mi (lm_head from 2
    rows, w_fused 3, q_proj 5, VT_v 6, VT_k never); the int4 MLP from 2 rows,
    and at 1 row only at Qwen2-7B's width."""
    first = {(4096, 32000): 2, (12288, 4096): 3, (4096, 4096): 5, (4096, 3072): 6,
             (4096, 1024): 9}
    for (k, n), r0 in first.items():
        assert g8.use_stream(k, n, rows) == (rows >= r0)
    assert g4.use_stream_mlp(4096, 11008, rows) == (rows >= 2)
    assert g4.use_stream_mlp(3584, 18944, rows)

