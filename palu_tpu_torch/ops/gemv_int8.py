"""Int8 weight-only GEMVs for decode-sized inputs (port of
palu_tpu/ops/pallas/gemv_int8.py::gemv_int8 and mlp_gemv_int8; the kernels
are csrc/gemv_int8.cu).

Weights are core/wquant.quantize_weight storage: {"wq8": (K, N) int8,
"ws": (1, N) f32}, per-output-channel scales applied after the sum. x has
1 to 8 rows; results are in x.dtype. CUDA tensors launch the kernels, CPU
tensors run the plain versions (`*_ref`, f32 products of the codes). The
weight may be a transposed view with K contiguous (the tied int8 lm_head,
embedding codes (V, H) read as (H, V)); the kernel reads it in place.

gemv_int8 over a bf16 x and 16-byte aligned rows runs the streaming
tensor-core kernel (csrc/gemv_common.cuh, namespace ring) on the plan of
`gemv8_plan` where it is the faster of the two (`use_stream`); otherwise,
for an f32 x and other row strides, the CUDA-core split pass (`split_k`)
and its reduce kernel run.

mlp_gemv_int8 over a bf16 x runs two launches of the register-streamed
kernel mlp8_ldg (csrc/gemv_int8.cu): gate and up with the SwiGLU epilogue
writing h, then down over h, each on its plan of `mlp8_plan`. Over an f32
x (bf16 tensor cores would round it) it runs the split pass: gate and up,
a SwiGLU reduce kernel, then down and its reduce.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import build

__all__ = ["gemv_int8", "gemv_int8_ref", "mlp_gemv_int8", "mlp_gemv_int8_ref",
           "MAX_ROWS", "split_k", "check_rows", "check_cuda", "stream_smem", "stream_plan",
           "model_capacity", "gemv8_plan", "use_stream", "device_sms", "device_capacity",
           "LDG_CLUSTERS", "ldg_smem", "ldg_plan", "MLP8_CLUSTERS", "MLP8_WARPS", "mlp8_smem",
           "mlp8_plan", "mlp8_plans"]

MAX_ROWS = 8       # rows a kernel takes (PALU_SWITCH_B)
_BLOCK_N = 128     # output columns per block (kBlockN)
_UNIT = 128        # contraction rows per split unit (kUnit)
_BLOCKS_PER_SM = 4

# The streaming kernels (csrc/gemv_common.cuh, namespace ring)
RING_TILE_ROWS = 64          # byte rows of a weight tile (kTileRows)
RING_TILE_COLS = 128         # output columns of a tile and of a column block
# ring stages (kStages): a multiple of the 4 consumer warps; a slice that
# leaves no room for 8 has no plan and runs the split pass
RING_STAGES = 8
RING_SMEM = 112 * 1024       # dynamic shared memory of a block (kSmemBudget)
RING_SLOTS_PER_SM = 2        # blocks that fit one SM at that size
CLUSTERS = tuple(range(1, 17))  # cluster sizes a plan may take (over 8: non-portable)
KIND_GATE_UP, KIND_DOWN, KIND_INT8 = 0, 1, 2


def stream_smem(kind: int, rows: int, units: int) -> int:
    """Shared memory bytes of a streaming block (mirror of ring::Layout):
    the ring (8 KB tiles, int4 also 512-byte scale rows), x's fragments
    (int4 256 bytes per row and group, int8 128 per row and 64-row tile),
    the sums of x, the block's f32 sums in two sets, the int8 column
    scales, h (gate / up), the mbarriers, and 1 KB of alignment slack (the
    rows the ranks of a cluster push go over the ring)."""
    o = RING_STAGES * RING_TILE_ROWS * RING_TILE_COLS
    if kind != KIND_INT8:
        o += RING_STAGES * RING_TILE_COLS * 4
    o += (128 if kind == KIND_INT8 else 256) * rows * units
    o += (1 if kind == KIND_INT8 else units) * 32
    o += 2 * rows * RING_TILE_COLS * 4
    if kind == KIND_INT8:
        o += RING_TILE_COLS * 4
    if kind == KIND_GATE_UP:
        o += rows * RING_TILE_COLS * 2
    o += (2 * RING_STAGES + 1) * 8
    return o + 1024


def model_capacity(sms: int) -> tuple:
    """Clusters of each size in CLUSTERS that RING_SLOTS_PER_SM blocks per SM
    hold, with no loss to the placement of clusters on the card."""
    return tuple(RING_SLOTS_PER_SM * sms // c for c in CLUSTERS)


@functools.lru_cache(maxsize=1024)
def stream_plan(sms: int, kind: int, col_blocks: int, units: int, rows: int, capacity=None):
    """Work plan of a streaming launch: (cluster, grid), or None when x's
    slice leaves no room for the ring.

    A column block of 128 outputs is split along K into `cluster` ranges of
    whole units (int4 groups, int8 64-row tiles; rank r takes units
    [r * units // cluster, (r + 1) * units // cluster)), one cluster per
    column block, all in one wave: cluster * col_blocks blocks within
    RING_SLOTS_PER_SM per SM and col_blocks within capacity[cluster - 1]
    (the clusters of that size the card runs at once; model_capacity(sms)
    by default). A cluster of one may own column blocks cb, cb + grid, ...
    The size taken gives each block the fewest tiles (its four consumer
    warps take them in turn, so a block's tiles are its critical path), then
    the fewest blocks, among those whose shared memory fits RING_SMEM."""
    caps = capacity or model_capacity(sms)
    slots = RING_SLOTS_PER_SM * sms
    per_unit = 2 if kind == KIND_GATE_UP else 1  # tiles per unit
    best = None
    for c, cap in zip(CLUSTERS, caps):
        if c > units:
            break
        if c == 1:
            grid = min(col_blocks, cap, slots)
            tiles = -(-col_blocks // grid) * units * per_unit
        else:
            grid = c * col_blocks
            if grid > slots or col_blocks > cap:
                continue
            tiles = -(-units // c) * per_unit
        if stream_smem(kind, rows, -(-units // c)) > RING_SMEM:
            continue
        key = (tiles, grid)
        if best is None or key < best[0]:
            best = (key, (c, grid))
    return None if best is None else best[1]


# The register-streamed one-launch GEMVs (csrc/gemv_common.cuh, namespace
# ldg): gemv_int4 over a bf16 x and the probe's gemv_bf16 over W (K, N)
LDG_WARPS = 8                # warps of a block
LDG_CLUSTERS = (1, 2, 4, 8)  # cluster sizes a plan may take (portable)
LDG_PAD = 4                  # floats added to a row of the warps' sums (kPad)


def ldg_smem(cols: int, rows: int, cluster: int, scales: bool = False) -> int:
    """Shared memory bytes of a register-streamed block (mirror of
    ldg::smem_bytes, and with `scales` of gemv_int4.cu's smem4_bytes): the
    warps' sums of `cols` columns for x's rows (gemv4_ldg's accumulators),
    in a cluster two receive buffers of the block's share of them, and
    gemv4_ldg's staged tile scales (a row of `cols` floats per warp)."""
    sums = LDG_WARPS * rows * (cols + LDG_PAD) + (2 * rows * cols if cluster > 1 else 0)
    return 4 * (sums + (LDG_WARPS * cols if scales else 0))


@functools.lru_cache(maxsize=1024)
def ldg_plan(sms: int, per_sm: int, col_blocks: int, units: int, capacity=None,
             costs=(1, 1)) -> tuple:
    """Work plan of a register-streamed launch: (cluster, grid).

    Each column block's `units` (contraction tiles: int4 groups, bf16
    32-row units) are split over the LDG_WARPS * cluster warps of one
    cluster (warp w of rank r: split wi = LDG_WARPS * r + w of W, units
    [wi * units // W, (wi + 1) * units // W)); cluster c of the grid's ncl
    owns column blocks c, c + ncl, ... The grid is one wave: at most
    per_sm blocks per SM (what the kernel's registers leave room for) and,
    for each size, at most capacity[i] clusters of LDG_CLUSTERS[i] (the
    clusters the card runs at once; per_sm * sms // size by default).

    The size taken has the least cost, in tiles of the busiest warp: its
    column blocks times (its units there + `costs[0]`, the sums of a column
    block), plus `costs[1]` for a cluster of more than one block (a cluster
    launch costs more); ties go to the smaller cluster."""
    if sms < 1 or per_sm < 1 or col_blocks < 1 or units < 1:
        raise ValueError(f"a register-streamed GEMV needs sms, per_sm, column blocks and "
                         f"units >= 1: {sms}, {per_sm}, {col_blocks}, {units}")
    caps = capacity or tuple(per_sm * sms // c for c in LDG_CLUSTERS)
    best = None
    for c, cap in zip(LDG_CLUSTERS, caps):
        ncl = min(col_blocks, cap, per_sm * sms // c)
        if ncl < 1:
            continue
        cost = -(-col_blocks // ncl) * (-(-units // (LDG_WARPS * c)) + costs[0]) + \
            (costs[1] if c > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, (c, c * ncl))
    if best is None:
        raise ValueError(f"no cluster size runs on this card: capacity {caps}")
    return best[1]


# The int8 SwiGLU MLP over a bf16 x (csrc/gemv_int8.cu, mlp8_ldg): blocks of
# 16 warps (one an SM) or 8 (two; down always), 128 registers a thread,
# 128-column blocks of 64-row tiles, clusters of any size up to 8
MLP8_WARPS = (16, 8)
# palu_mlp_gemv_int8_ldg: x, B, H, I, six weight tensors, h, the two plans,
# out, stream
MLP8_SIG = "piii" + "p" * 7 + "iiiiipp"
MLP8_COLS = 128
MLP8_CLUSTERS = tuple(range(1, 9))


def mlp8_smem(sets: int, warps: int, rows: int, cluster: int) -> int:
    """Shared memory bytes of an mlp8_ldg block (mirror of mlp8_smem_bytes):
    the warps' sums of each set (gate and up: 2; down: 1) for x's rows, and
    in a cluster two receive buffers of each rank's ceil(128 / cluster)
    columns per source rank."""
    red = sets * warps * rows * (MLP8_COLS + LDG_PAD)
    recv = 2 * sets * cluster * rows * -(-MLP8_COLS // cluster) if cluster > 1 else 0
    return 4 * (red + recv)


@functools.lru_cache(maxsize=1024)
def mlp8_plan(sms: int, col_blocks: int, sets: int, capacity=None) -> tuple:
    """Work plan of one mlp8_ldg launch: (warps, cluster, grid).

    Each column block's 64-row tiles (each read once per set: gate and up,
    or down) are split over the warps * cluster warps of one cluster (warp w
    of rank r: split wi = warps * r + w of W, tiles [wi * units // W, (wi +
    1) * units // W)); cluster c of the grid's ncl owns column blocks c, c +
    ncl, ... Blocks are 16 warps (one an SM; gate and up only) or 8 (two an
    SM). `capacity` holds (warps, clusters of each size in MLP8_CLUSTERS)
    pairs: what the card runs at once (cudaOccupancyMaxActiveClusters); by
    default what the SMs hold.

    The plan takes, 16-warp blocks first, the largest cluster with which
    every column block has its own cluster in one wave; where none has, 8-
    warp blocks without a cluster, each owning several column blocks. On an
    H100 80GB HBM3 (700 W; tools/gemv_ab.py --only=mlp8plans, PERF.md) these
    were the fastest plans at Llama-2-7B's shapes: a launch takes about what
    its busiest SM's bytes take at the rate 16 warps with 4 KB each in
    flight stream, and every round of column blocks after a cluster's
    first, or a contraction that the cluster's warps split unevenly, added a
    barrier's wait for the slowest rank (clusters of 3, 5, 6 or 7 owning two
    column blocks ran 7-30 % slower). At Qwen2-7B's gate / up (148 column
    blocks) clusters of 4 ran 6 % faster than the plan's."""
    if sms < 1 or col_blocks < 1 or sets not in (1, 2):
        raise ValueError(f"mlp8_ldg needs sms and column blocks >= 1 and 1 or 2 sets: "
                         f"{sms}, {col_blocks}, {sets}")
    caps = dict(capacity or ())
    for warps in MLP8_WARPS if sets == 2 else (8,):
        slots = 512 // (32 * warps) * sms
        cap = caps.get(warps) or tuple(slots // c for c in MLP8_CLUSTERS)
        fits = [c for c, n in zip(MLP8_CLUSTERS, cap) if col_blocks <= n and
                c * col_blocks <= slots]
        if fits:
            return warps, max(fits), max(fits) * col_blocks
    cap = caps.get(8) or (2 * sms,)
    return 8, 1, min(col_blocks, 2 * sms, cap[0])


def mlp8_plans(sms: int, hdim: int, inter: int, rows: int, capacity=(None, None)) -> tuple:
    """mlp_gemv_int8's two launches over a bf16 x at H = hdim, I = inter,
    each (warps, cluster, grid) of mlp8_plan: gate and up (I / 128 column
    blocks of H / 64 tiles, two sets), then down (H / 128 column blocks of
    I / 64 tiles); `capacity` each launch's (warps, clusters of each size in
    MLP8_CLUSTERS) pairs. The kernels' time does not vary with x's rows (mma.sync
    takes 8), so neither do the plans; `rows` is checked (1 to 8)."""
    if (hdim <= 0 or hdim % MLP8_COLS or inter <= 0 or inter % MLP8_COLS
            or not 1 <= rows <= MAX_ROWS):
        raise ValueError(f"mlp8_ldg takes H and I positive multiples of {MLP8_COLS} and 1 to "
                         f"{MAX_ROWS} rows: H={hdim}, I={inter}, rows={rows}")
    return (mlp8_plan(sms, inter // MLP8_COLS, 2, capacity[0]),
            mlp8_plan(sms, hdim // MLP8_COLS, 1, capacity[1]))


@functools.lru_cache(maxsize=64)
def _device_mlp8_capacity(dev: torch.device, sets: int) -> tuple:
    """(warps, clusters of each size in MLP8_CLUSTERS) pairs: what the card
    of `dev` runs of mlp8_ldg's blocks (`sets` 2: gate and up, 16 or 8
    warps; 1: down, 8 warps) at once."""
    with torch.cuda.device(dev):
        fn = build.launcher("gemv_int8", "palu_mlp8_max_clusters", "iii")
        caps = tuple((w, tuple(fn(sets, w, c) for c in MLP8_CLUSTERS))
                     for w in (MLP8_WARPS if sets == 2 else (8,)))
    if min(min(c) for _, c in caps) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {caps}")
    return caps


@functools.lru_cache(maxsize=256)
def _device_mlp8_plans(dev: torch.device, hdim: int, inter: int, rows: int) -> tuple:
    """mlp8_plans on the card of `dev`, cached (the decode step is
    host-bound: a call makes one lookup)."""
    return mlp8_plans(device_sms(dev), hdim, inter, rows,
                      (_device_mlp8_capacity(dev, 2), _device_mlp8_capacity(dev, 1)))


# The streaming kernel costs the same at 1 to 8 rows (mma.sync takes 8); the
# split pass adds multiply-adds per row but starts sooner. On an H100 80GB
# HBM3 (700 W; tools/gemv_ab.py, rows 1-8 at VT_k, VT_v, q_proj, w_fused and
# lm_head) the streaming kernel was the faster where (rows - 1) * K * N
# reached about 56 Mi: lm_head from 2 rows, w_fused from 3, q_proj from 5,
# VT_v from 6, VT_k never. The threshold rests on these five shapes of one
# model; other widths take the route it gives them unmeasured.
STREAM_MIN_WORK = 56 << 20


def use_stream(k: int, n: int, rows: int) -> bool:
    """Whether gemv_int8 takes the streaming kernel (STREAM_MIN_WORK)."""
    return (rows - 1) * k * n >= STREAM_MIN_WORK


def gemv8_plan(sms: int, k: int, n: int, rows: int, capacity=None):
    """stream_plan of gemv_int8 at K x N (N % 128 == 0) for `rows` rows."""
    return stream_plan(sms, KIND_INT8, n // RING_TILE_COLS, -(-k // RING_TILE_ROWS), rows,
                       capacity)


@functools.lru_cache(maxsize=64)
def device_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=64)
def device_capacity(dev: torch.device, kind: int) -> tuple:
    """Clusters of each size in CLUSTERS that the card runs at once, blocks
    of RING_SMEM bytes (cudaOccupancyMaxActiveClusters): the placement of
    clusters on the card's GPCs can hold fewer than model_capacity."""
    with torch.cuda.device(dev):
        if kind == KIND_INT8:
            fn = build.launcher("gemv_int8", "palu_gemv8_max_clusters", "ii")
            caps = tuple(fn(c, RING_SMEM) for c in CLUSTERS)
        else:
            fn = build.launcher("gemv_int4", "palu_mlp4_max_clusters", "iii")
            caps = tuple(fn(kind, c, RING_SMEM) for c in CLUSTERS)
    if min(caps) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {caps}")
    return caps


@functools.lru_cache(maxsize=256)
def split_k(dev: torch.device, col_blocks: int, units: int, rows: int):
    """Split `units` 128-row units of the contraction over blocks so that
    about four blocks run per SM, with x's slice (rows x units x 128 f32)
    kept within 32 KB of shared memory: (splits, units per split)."""
    sms = device_sms(dev)
    want = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    per = min(max(1, -(-units // want)), max(1, 64 // rows))
    return -(-units // per), per


def check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x must be (B, K) with 1 <= B <= {MAX_ROWS}, got {tuple(x.shape)}")


def _check_weight(w, k: int) -> None:
    wq, ws = w["wq8"], w["ws"]
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"wq8 must be int8 (K={k}, N), got {wq.dtype} {tuple(wq.shape)}")
    if wq.shape[1] % _BLOCK_N:
        raise ValueError(f"N={wq.shape[1]} must be a multiple of {_BLOCK_N}")
    if ws.dtype != torch.float32 or ws.numel() != wq.shape[1]:
        raise ValueError(f"ws must be f32 (1, {wq.shape[1]}), got {ws.dtype} {tuple(ws.shape)}")


def _check(x, w) -> None:
    check_rows(x)
    _check_weight(w, x.shape[1])


def _dot(x, w) -> torch.Tensor:
    """(x @ codes) * ws in f32."""
    return (x.float() @ w["wq8"].float()) * w["ws"].reshape(1, -1)


def gemv_int8_ref(x, w) -> torch.Tensor:
    """Plain version of gemv_int8."""
    _check(x, w)
    return _dot(x, w).to(x.dtype)


def _check_mlp(x, wg, wu, wd) -> None:
    check_rows(x)
    hdim = x.shape[1]
    for w in (wg, wu):
        _check_weight(w, hdim)
    if tuple(wu["wq8"].shape) != tuple(wg["wq8"].shape):
        raise ValueError("gate and up weights differ in shape")
    _check_weight(wd, wg["wq8"].shape[1])
    if wd["wq8"].shape[1] != hdim:
        raise ValueError(f"down weight must be (I, {hdim}), got {tuple(wd['wq8'].shape)}")


def mlp_gemv_int8_ref(x, wg, wu, wd) -> torch.Tensor:
    """Plain version of mlp_gemv_int8: gate/up scales before silu, h in
    x.dtype, the down scale after its sum."""
    _check_mlp(x, wg, wu, wd)
    h = (F.silu(_dot(x, wg)) * _dot(x, wu)).to(x.dtype)
    return _dot(h, wd).to(x.dtype)


def check_cuda(x, tensors, aligned=()) -> None:
    """What the kernels take: x bf16 or f32, all tensors on one device, and
    the `aligned` ones contiguous from a 16-byte boundary."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    dev = x.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("all tensors must be on one device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in aligned):
        raise ValueError("weights and scales must be contiguous and 16-byte aligned")


def _scales(ws: torch.Tensor) -> torch.Tensor:
    if not ws.is_contiguous():
        raise ValueError("ws must be contiguous")
    return ws


def _layout(wq: torch.Tensor):
    """(ldw, k_major) of a (K, N) int8 weight, N contiguous or K contiguous;
    each row or column must start on a 4-byte (K-major) or 8-byte boundary."""
    if wq.stride(1) == 1:
        ldw, k_major, align = wq.stride(0), 0, 8
    elif wq.stride(0) == 1:
        ldw, k_major, align = wq.stride(1), 1, 4
        if wq.shape[0] % 4:
            raise ValueError(f"K-major weight needs K % 4 == 0, got K={wq.shape[0]}")
    else:
        raise ValueError(f"wq8 must have N or K contiguous, strides {wq.stride()}")
    if ldw % align or wq.data_ptr() % 16:
        raise ValueError(f"wq8 rows must be {align}-byte aligned (ldw={ldw})")
    return ldw, k_major


def gemv_int8(x, w) -> torch.Tensor:
    """y = x @ dequant(w) for x (B <= 8, K): (x @ codes) * ws in f32, cast to
    x.dtype. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return gemv_int8_ref(x, w)
    _check(x, w)
    wq = w["wq8"]
    ws = _scales(w["ws"])
    check_cuda(x, (x, wq, ws))
    ldw, k_major = _layout(wq)
    b, k = x.shape
    n = wq.shape[1]
    dev = x.device
    xc = x.contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    plan = None
    if not k_major and x.dtype == torch.bfloat16 and ldw % 16 == 0 and use_stream(k, n, b):
        plan = gemv8_plan(device_sms(dev), k, n, b, device_capacity(dev, KIND_INT8))
    if plan is not None:
        x_vec = int(k % 8 == 0 and xc.data_ptr() % 16 == 0)
        err = build.launcher("gemv_int8", "palu_gemv_int8_stream", "piiipipiiippp")(
            xc.data_ptr(), b, k, n, wq.data_ptr(), ldw, ws.data_ptr(), *plan, x_vec,
            out.data_ptr(), None, build.stream_ptr(dev))
    else:
        if k_major:
            splits, ups, part = 0, 0, None
        else:
            splits, ups = split_k(dev, n // _BLOCK_N, -(-k // _UNIT), b)
            part = torch.empty(splits * b * n, dtype=torch.float32, device=dev)
        err = build.launcher("gemv_int8", "palu_gemv_int8", "piiiipiippiipp")(
            xc.data_ptr(), int(x.dtype == torch.bfloat16), b, k, n, wq.data_ptr(), ldw,
            k_major, ws.data_ptr(), None if part is None else part.data_ptr(), splits, ups,
            out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "gemv_int8")
    gemv_int8.launches += 1
    return out


gemv_int8.launches = 0


def mlp_gemv_int8(x, wg, wu, wd) -> torch.Tensor:
    """SwiGLU MLP over int8 weights for x (B <= 8, H): silu(x Wg) * (x Wu)
    rounded to x.dtype, then @ Wd. Weights row-major (N contiguous). CUDA
    tensors launch the kernels (bf16 x: two launches of mlp8_ldg; f32 x:
    the split pass); CPU tensors run the plain version."""
    if not x.is_cuda:
        return mlp_gemv_int8_ref(x, wg, wu, wd)
    _check_mlp(x, wg, wu, wd)
    b, hdim = x.shape
    inter = wg["wq8"].shape[1]
    weights = [wg["wq8"], wu["wq8"], wd["wq8"]]
    scales = [_scales(w["ws"]) for w in (wg, wu, wd)]
    check_cuda(x, [x] + weights + scales, weights)
    dev = x.device
    h = torch.empty((b, inter), dtype=x.dtype, device=dev)
    out = torch.empty((b, hdim), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    ws = [t.data_ptr() for pair in zip(weights, scales) for t in pair]
    if x.dtype == torch.bfloat16:
        if xc.data_ptr() % 4:  # x is read 4 bytes at a time
            xc = xc.clone()
        (w1, c1, g1), (_, c2, g2) = _device_mlp8_plans(dev, hdim, inter, b)
        err = build.launcher("gemv_int8", "palu_mlp_gemv_int8_ldg", MLP8_SIG)(
            xc.data_ptr(), b, hdim, inter, *ws, h.data_ptr(), w1, c1, g1, c2, g2,
            out.data_ptr(), build.stream_ptr(dev))
    else:
        s1, u1 = split_k(dev, 2 * inter // _BLOCK_N, -(-hdim // _UNIT), b)
        s2, u2 = split_k(dev, hdim // _BLOCK_N, -(-inter // _UNIT), b)
        part = torch.empty(s1 * b * 2 * inter + s2 * b * hdim, dtype=torch.float32,
                           device=dev)
        err = build.launcher("gemv_int8", "palu_mlp_gemv_int8", "piiiipppppppiippiipp")(
            xc.data_ptr(), 0, b, hdim, inter, *ws, part.data_ptr(), s1, u1, h.data_ptr(),
            part[s1 * b * 2 * inter:].data_ptr(), s2, u2, out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "mlp_gemv_int8")
    mlp_gemv_int8.launches += 1
    return out


mlp_gemv_int8.launches = 0
