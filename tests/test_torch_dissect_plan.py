"""The dissection's modes on palu_decode_fp's kernel
(csrc/palu_decode_fp_wg.cu, palu_tpu_torch/tools/dissect.py), on the CPU.

The consumers' checksums are mirrored on the chunk images the producer's TMA
ring holds (64 tokens x 64 ranks a box, two boxes a 128-rank chunk, 16-byte
units XOR-swizzled by the token's row within 128 bytes, ranks past r and
tokens past S zero, a V chunk's second box loaded only when rv reaches past
its first 64 ranks, consumer c folding box c) and equal dissect_ref's
dmaonly / noop checksums (the JAX tool's plain version is held in
test_torch_probes.py) exactly. The modes with no K work plan no B; full's
plan and launch are palu_decode_fp's."""

import numpy as np
import pytest
import torch

from palu_tpu_torch.ops.palu_decode_fp import _fp_plan
from palu_tpu_torch.tools import dissect

TILE, CHUNK = 64, 128


def _box_image(x: torch.Tensor, b: int, g: int, s0: int, r0: int) -> np.ndarray:
    """The 8 KB image of the box of ranks [r0, r0 + 64) and tokens [s0, s0 +
    64) of a seq-major (B, G, S, r) bf16 cache in the 128-byte swizzle: row t
    holds token s0 + t, its unit u (ranks r0 + 8u .. r0 + 8u + 7) at unit
    u ^ (t % 8); ranks past r and tokens past S are zeros."""
    tile = torch.zeros((TILE, 64), dtype=torch.bfloat16)
    part = x[b, g, s0:s0 + TILE, r0:r0 + 64]
    tile[:part.shape[0], :part.shape[1]] = part
    units = tile.view(torch.int16).numpy().reshape(TILE, 8, 8)
    img = np.empty_like(units)
    for t in range(TILE):
        img[t, np.arange(8) ^ (t % 8)] = units[t]
    return img.view(np.uint32).reshape(-1, 4)


def _fold(img: np.ndarray, mode: str) -> int:
    """A consumer's fold of one box image (512 units of four words)."""
    w = img.astype(np.uint64)
    if mode == "noop":
        return int((w[:, 0] ^ w[:, 1] ^ w[:, 2] ^ w[:, 3]).sum())
    return int(((w & 0xFFFF) + (w >> 16)).sum())


def consumers_checksum(mode: str, x_k, x_v, kv_len, rng) -> int:
    """The two consumers' checksum over every chunk of the walked tiles: the
    K chunks' two boxes always (ranks past rk zero), a V chunk's second box
    only when loaded (an unloaded one holds stale bytes, which no consumer
    reads)."""
    b_n, g_n, s_max = x_k.shape[:3]
    total = 0
    for b in range(b_n):
        tiles = -(-min(int(kv_len[b]), s_max) // TILE)
        for g in range(g_n):
            for tile in range(tiles):
                for x, r in ((x_k, x_k.shape[3]), (x_v, x_v.shape[3])):
                    for c in range(-(-r // CHUNK)):
                        loaded = [True, x is x_k or r - c * CHUNK > 64]
                        for box in range(2):
                            img = (_box_image(x, b, g, tile * TILE, c * CHUNK + 64 * box)
                                   if loaded[box] else
                                   rng.integers(0, 2**32, (512, 4), dtype=np.uint32))
                            if loaded[box]:  # consumer `box` folds it
                                total += _fold(img, mode)
    return total


@pytest.mark.parametrize("mode", ["dmaonly", "noop"])
@pytest.mark.parametrize("rk,rv,s_max,kv_len", [(80, 200, 200, (200, 130)),
                                                 (128, 136, 256, (256, 65)),
                                                 (256, 384, 192, (100, 192))])
def test_consumer_checksums_match_the_plain_version(mode, rk, rv, s_max, kv_len):
    gen = torch.Generator().manual_seed(rk + rv)
    b, g = len(kv_len), 2
    x_k, x_v = (torch.randn((b, g, s_max, r), generator=gen).bfloat16() for r in (rk, rv))
    q = torch.randn((b, g * 4, 64), generator=gen).bfloat16()
    b_k = torch.randn((g, 4, rk, 64), generator=gen).bfloat16()
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    want = dissect.dissect_ref(mode, q, b_k, x_k, x_v, kvl)["checksum"]
    got = consumers_checksum(mode, x_k, x_v, kvl, np.random.default_rng(0))
    assert got == int(want[0])


SHAPES = [(128, 128, 384, 4), (128, 32, 64, 4), (128, 256, 384, 16), (128, 512, 512, 8),
          (128, 160, 200, 1)]


@pytest.mark.parametrize("hd,rk,rv,hpg", SHAPES)
def test_cut_modes_plan_no_b(hd, rk, rv, hpg):
    """full and novalue take palu_decode_fp's plan (B staged); nologits,
    dmaonly and noop its ring depth with no B slot, hence less shared
    memory."""
    prod = _fp_plan(hd, rk, rv, hpg, hpg)
    assert dissect.dissect_plan("full", hd, rk, rv, hpg) == prod
    assert dissect.dissect_plan("novalue", hd, rk, rv, hpg) == prod
    assert prod["nb"] > 0
    for mode in ("nologits", "dmaonly", "noop"):
        plan = dissect.dissect_plan(mode, hd, rk, rv, hpg)
        assert plan["nb"] == 0 and plan["resident"] == 0 and plan["ns"] == prod["ns"]
        assert plan["smem"] < prod["smem"]


def test_cut_modes_take_the_tools_head_dim_and_one_head_tile_a_consumer():
    """The cut modes are instantiated at the tool's head dim, 128, and one
    8-head tile a consumer: over 16 heads a group, or at hd 64, only full
    (palu_decode_fp's kernel) runs."""
    assert dissect.dissect_plan("full", 128, 128, 384, 28) == _fp_plan(128, 128, 384, 28, 28)
    assert dissect.dissect_plan("full", 64, 32, 64, 4) == _fp_plan(64, 32, 64, 4, 4)
    for mode in ("novalue", "nologits", "dmaonly", "noop"):
        with pytest.raises(ValueError, match="16 heads"):
            dissect.dissect_plan(mode, 128, 128, 384, 28)
        with pytest.raises(ValueError, match="hd 128"):
            dissect.dissect_plan(mode, 64, 32, 64, 4)


class _OnCard(torch.Tensor):
    """A CPU tensor that answers is_cuda, to follow a wrapper's launch path."""

    @property
    def is_cuda(self):
        return True


def _ops(gen, hd=128, rk=32, rv=64):
    q = torch.randn((1, 8, hd), generator=gen).bfloat16()
    b_k = torch.randn((2, 4, rk, hd), generator=gen).bfloat16()
    x_k, x_v = (torch.randn((1, 2, 256, r), generator=gen).bfloat16() for r in (rk, rv))
    return [torch.Tensor._make_subclass(_OnCard, t) for t in (q, b_k, x_k, x_v)] + \
        [torch.tensor([256], dtype=torch.int32)]


def test_full_launches_palu_decode_fps_kernel(monkeypatch):
    """full is palu_decode_fp's own launch (its launcher, plan and splits:
    seq-major, no window, no bias); the other modes launch the dissection's
    entry point of the same source with the mode's index."""
    calls = []
    monkeypatch.setattr(dissect, "_launch", lambda *a: calls.append(("launch", a[5:])) or "out")
    ops = _ops(torch.Generator().manual_seed(0))
    assert dissect.palu_decode_fp_dissect("full", *ops) == "out"
    assert calls == [("launch", (False, dissect.THETA, None, None, 1.0, None))]
    assert dissect.dissect_route("full") == ("palu_decode_fp_wg", "palu_decode_fp_wg")

    launched = []
    monkeypatch.setattr(dissect, "_device_splits", lambda dev, n_bg, s: (4, n_bg * 4))
    monkeypatch.setattr(dissect.build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(dissect.build, "check", lambda err, what: None)

    def launcher(source, name, sig):
        def fn(*args):
            assert len(args) == len(sig)
            launched.append((source, name, args[0]))
            return 0
        return fn

    monkeypatch.setattr(dissect.build, "launcher", launcher)
    for i, mode in enumerate(dissect.MODES[1:], start=1):
        dissect.palu_decode_fp_dissect(mode, *ops)
        assert launched[-1] == (*dissect.dissect_route(mode), i)
